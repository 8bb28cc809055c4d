"""The port stands alone: no module of ``twtml_tpu_torch`` imports ``jax``,
anything of the JAX package ``twtml_tpu``, or ``aiohttp`` (the JAX
package's web server; the port's runs on the standard library), and
importing the port's app, web server, live source and tracer leaves them
out of ``sys.modules``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(
    p for p in (REPO / "twtml_tpu_torch").rglob("*.py") if "__pycache__" not in p.parts
) + [REPO / "chip_smoke.py"]


FORBIDDEN = ("jax", "jaxlib", "twtml_tpu", "aiohttp")


def forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            names = [a.value for a in node.args[:1] if isinstance(a, ast.Constant)]
        else:
            continue
        bad = [n for n in names if forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"
    # no dotted "twtml_tpu." name anywhere (importlib strings, resources):
    # the port names its counterparts by file path only
    text = path.read_text(encoding="utf-8").replace("twtml_tpu_torch", "")
    assert "twtml_tpu." not in text, f"{path.name} names a twtml_tpu.* module"


def test_port_files_are_found():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    assert "twtml_tpu_torch/ops/fused_sgd.py" in names
    assert "twtml_tpu_torch/apps/linear_regression.py" in names
    assert {"twtml_tpu_torch/web/server.py", "twtml_tpu_torch/web/websocket.py",
            "twtml_tpu_torch/streaming/twitter.py", "twtml_tpu_torch/utils/tracing.py"} <= names
    assert {"twtml_tpu_torch/apps/logistic_regression.py", "twtml_tpu_torch/apps/kmeans.py",
            "twtml_tpu_torch/models/logistic.py", "twtml_tpu_torch/models/kmeans.py",
            "twtml_tpu_torch/features/sentiment.py", "twtml_tpu_torch/ops/scaler.py"} <= names
    assert {"twtml_tpu_torch/ops/gram.py", "twtml_tpu_torch/ops/fused_gram.py",
            "twtml_tpu_torch/ops/sparse.py"} <= names
    assert {"twtml_tpu_torch/serving/snapshot.py", "twtml_tpu_torch/serving/engine.py",
            "twtml_tpu_torch/serving/plane.py", "twtml_tpu_torch/serving/client.py",
            "twtml_tpu_torch/serving/fleet.py", "twtml_tpu_torch/apps/serve.py",
            "twtml_tpu_torch/apps/router.py"} <= names
    assert {"twtml_tpu_torch/parallel/__init__.py", "twtml_tpu_torch/parallel/tenants.py",
            "twtml_tpu_torch/serving/abtest.py",
            "twtml_tpu_torch/telemetry/tenants.py"} <= names
    assert {"twtml_tpu_torch/features/wirecodec.py", "twtml_tpu_torch/features/blocks.py"} <= names
    assert {"twtml_tpu_torch/parallel/distributed.py", "twtml_tpu_torch/parallel/mesh.py",
            "twtml_tpu_torch/parallel/sharding.py",
            "twtml_tpu_torch/telemetry/straggler.py"} <= names
    assert {"twtml_tpu_torch/parallel/elastic.py", "twtml_tpu_torch/parallel/service_host.py",
            "twtml_tpu_torch/streaming/membership.py"} <= names


def test_importing_the_app_leaves_jax_unloaded():
    code = (
        "import sys\n"
        "assert 'jax' not in sys.modules, 'jax pre-imported by the interpreter'\n"
        "import twtml_tpu_torch.apps.linear_regression\n"
        "import twtml_tpu_torch.convert\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'twtml_tpu'))\n"
        "print(bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


@pytest.mark.parametrize("module", [
    "twtml_tpu_torch.web.main", "twtml_tpu_torch.streaming.twitter",
    "twtml_tpu_torch.utils.tracing", "twtml_tpu_torch.apps.logistic_regression",
    "twtml_tpu_torch.apps.kmeans", "twtml_tpu_torch.apps.serve",
    "twtml_tpu_torch.apps.router", "twtml_tpu_torch.serving.plane",
    "twtml_tpu_torch.parallel.tenants", "twtml_tpu_torch.serving.abtest",
    "twtml_tpu_torch.telemetry.tenants", "twtml_tpu_torch.parallel.distributed",
    "twtml_tpu_torch.parallel.sharding", "twtml_tpu_torch.parallel.mesh",
    "twtml_tpu_torch.telemetry.straggler", "twtml_tpu_torch.telemetry.sideband",
    "twtml_tpu_torch.parallel.elastic", "twtml_tpu_torch.parallel.service_host",
    "twtml_tpu_torch.streaming.membership",
])
def test_importing_the_host_modules_leaves_jax_and_aiohttp_unloaded(module):
    code = (
        "import sys\n"
        f"import {module}\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_the_router_runs_without_torch():
    """The fleet router holds no model: importing it, and a run that routes
    a request and publishes its views, leave torch (and the model layer)
    unloaded, as the JAX router leaves jax."""
    code = (
        "import sys, json, threading, urllib.request, urllib.error\n"
        "from twtml_tpu_torch.apps import router\n"
        "from twtml_tpu_torch.config import ConfArguments\n"
        "import twtml_tpu_torch.serving\n"
        "assert 'torch' not in sys.modules\n"
        "stop = threading.Event()\n"
        "def started(server, rt):\n"
        "    req = urllib.request.Request(f'http://127.0.0.1:{server.port}/api/predict',\n"
        "                                 data=b'{\"rows\": [\"x\"]}', method='POST')\n"
        "    try:\n"
        "        urllib.request.urlopen(req, timeout=30)\n"
        "    except urllib.error.HTTPError as exc:\n"
        "        print(exc.code)\n"
        "conf = ConfArguments().parse(['--replicas', 'http://127.0.0.1:9', '--routerPort', '0',\n"
        "                              '--twtweb', 'http://127.0.0.1:9'])\n"
        "router.run(conf, started=started, max_seconds=2.5)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'twtml_tpu'))\n"
        "bad += sorted(m for m in sys.modules if m.startswith('twtml_tpu_torch.models'))\n"
        "print(bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["503", "[]"]


def test_the_elastic_store_process_loads_no_model_and_no_card():
    """An elastic epoch's store process (parallel/service_host.py) imports
    torch's store and none of the port's models, and never initializes
    CUDA: it owns no device. Run as its members spawn it, it hosts a store
    a client reaches, and it exits once the beacon it watches has been gone
    for the linger window."""
    import socket
    import time

    code = (
        "import sys\n"
        "import twtml_tpu_torch.parallel.service_host\n"
        "import torch\n"
        "bad = sorted(m for m in sys.modules if m.startswith('twtml_tpu_torch.models')\n"
        "             or m.split('.')[0] in ('jax', 'twtml_tpu'))\n"
        "print(bad, torch.cuda.is_initialized())\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["[]", "False"]
    from twtml_tpu_torch.parallel.elastic import probe_port

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    # the beacon it watches (port 9) is never up: it lives 4 s past its start
    host = subprocess.Popen([sys.executable, "-m", "twtml_tpu_torch.parallel.service_host",
                             str(port), "1", "127.0.0.1", "9", "4"], cwd=REPO, env=env,
                            stderr=subprocess.PIPE, text=True)
    try:
        import datetime

        from torch.distributed import TCPStore

        t0 = time.monotonic()
        while not probe_port("127.0.0.1", port) and time.monotonic() - t0 < 60:
            assert host.poll() is None, host.stderr.read()
            time.sleep(0.05)
        store = TCPStore("127.0.0.1", port, 1, is_master=False,
                         timeout=datetime.timedelta(seconds=60))
        store.set("k", "v")
        assert store.get("k") == b"v"
        assert host.wait(timeout=60) == 0, host.stderr.read()
    finally:
        host.kill()
        host.wait()
