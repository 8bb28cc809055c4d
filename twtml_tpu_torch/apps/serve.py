"""Serving entry point: the read path (counterpart of
``twtml_tpu/apps/serve.py``).

Boots the port's dashboard web server in-process with a ``ServingPlane``
attached (``POST /api/predict``, ``GET /api/serving``), promotes the newest
servable snapshot of ``--checkpointDir`` (verified, quality stamp ok or
warn), keeps promoting as the trainer writes checkpoints (installed between
dispatches, never tearing a batch in flight), and publishes the ``Serving``
view every 2 s. On the card every served batch of the dense learner is one
launch of the fused SGD kernel in its predict-only mode; the kernel is
built and launched once before traffic (``ServingPlane.warmup``).

The trainer writes verified checkpoints and this process reads them off
disk: the handoff is the filesystem, so serving adds no fetch to the train
path. Run both against one directory:

    python -m twtml_tpu_torch.apps.linear_regression --checkpointDir ck \\
        --checkpointEvery 64 ...
    python -m twtml_tpu_torch.apps.serve --checkpointDir ck --servePort 8888

    curl -s localhost:8888/api/predict -d '{"rows": [{"text": "hello"}]}'

``--backend cpu`` serves on the CPU (the kernel's plain twin). A multi-host
run is refused (scale reads with replicas behind apps/router.py), and so is
``--abtest on`` with a tenant-stack snapshot (ROADMAP A9).
"""

from __future__ import annotations

import sys
import threading
import time

from ..config import ConfArguments
from ..utils import get_logger
from .common import install_blackbox, install_chaos, install_trace, select_backend

log = get_logger("apps.serve")

PUBLISH_EVERY_S = 2.0


def _multi_host(conf) -> bool:
    return bool(conf.coordinator or conf.numProcesses > 0 or conf.processId >= 0
                or conf.master.startswith("twtml://"))


def run(conf: ConfArguments, started=None, stop_event=None, max_seconds: float = 0.0) -> dict:
    """Snapshot, plane, promoter, web server; serve until ``stop_event``,
    SIGINT or ``max_seconds``. ``started(server, plane, promoter)`` fires
    once the front door is live. Returns the final ``Serving`` view."""
    if _multi_host(conf):
        raise SystemExit("the serve entry point is single-host: scale reads by running "
                         "N serve processes against replicas of the checkpoint directory")
    if not conf.checkpointDir:
        raise SystemExit("--checkpointDir is required: serving promotes verified "
                         "checkpoint snapshots (train with --checkpointDir/"
                         "--checkpointEvery to produce them)")
    select_backend(conf)
    install_trace(conf)
    install_chaos(conf)
    install_blackbox(conf)

    from ..features import assemble, featurize_native
    from ..serving import SnapshotPromoter, load_servable
    from ..serving.plane import ServingPlane
    from ..telemetry import trace as pipeline_trace
    from ..telemetry.web_client import WebClient
    from ..web.server import Server

    featurize_native.configure(conf.featurizeNative)
    assemble.configure(conf.wireAssemble)
    snapshot, reason = load_servable(conf.checkpointDir)
    if snapshot is None:
        raise SystemExit(f"no servable snapshot: {reason}")
    log.info("initial snapshot: step %d, %d tenant(s) — %s",
             snapshot.step, snapshot.num_tenants, reason)
    plane = ServingPlane.from_conf(conf, snapshot)
    log.info("building and warming the predict step...")
    plane.warmup()
    plane.start()
    promoter = SnapshotPromoter(conf.checkpointDir, plane,
                                poll_s=float(conf.servePromoteEvery or 5.0)).start()
    server = Server(port=conf.servePort).attach_serving(plane)
    try:
        server.start_background()
    except OSError:
        promoter.stop()
        plane.stop()
        raise
    web = WebClient(f"http://127.0.0.1:{server.port}", timeout=float(conf.webTimeout))
    log.info("serving front door live: POST /api/predict on port %d", server.port)
    if started is not None:
        started(server, plane, promoter)

    t0 = time.monotonic()
    stop_event = stop_event or threading.Event()
    try:
        while not stop_event.is_set() and not plane.failed:
            if max_seconds and time.monotonic() - t0 >= max_seconds:
                break
            stop_event.wait(PUBLISH_EVERY_S)
            try:
                # the Serving view on the dashboard's jsonClass wire
                web.serving(plane.stats())
            except Exception:
                log.debug("serving publish failed", exc_info=True)
    except KeyboardInterrupt:
        pass
    finally:
        promoter.stop()
        plane.stop()
        stats = plane.stats()
        server.stop()
        pipeline_trace.uninstall()
    if plane.failed:
        raise RuntimeError("serving plane aborted by the fetch watchdog (wedged transport); "
                           "in-flight requests were rejected, not hung — see critical log")
    log.info("serve session done: %s requests, %s rows, qps %s",
             stats["requests"], stats["rows"], stats["qps"])
    return stats


def main(argv=None) -> None:
    conf = (ConfArguments().setAppName("twitter-stream-ml-serve")
            .parse(list(sys.argv[1:] if argv is None else argv)))
    run(conf)


if __name__ == "__main__":
    main()
