"""Helpers of the port's multi-process tests: a replay file, a group of port
app processes over gloo on the CPU, and the JAX app's single-process run
of the same file. Not a test module."""

from __future__ import annotations

import json
import os
import re
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_WORKER = os.path.join(REPO, "tests", "app_worker.py")
TORCH_WORKER = os.path.join(REPO, "tests", "torch_lockstep_worker.py")
CLOSED = "http://127.0.0.1:9"  # a closed port: the publishers' Try paths, no DNS


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_replay(path, total: int, seed: int) -> str:
    """``total`` synthetic tweets (``seed``) as a replay file."""
    from tools.bench_suite import _status_json
    from twtml_tpu.streaming.sources import SyntheticSource

    with open(path, "w") as fh:
        for s in SyntheticSource(total=total, seed=seed, base_ms=1785320000000).produce():
            fh.write(json.dumps(_status_json(s)) + "\n")
    return str(path)


def common_args(path: str, *extra: str) -> list:
    return ["--source", "replay", "--replayFile", str(path), "--seconds", "0",
            "--backend", "cpu", "--tokenBucket", "64", "--lightning", CLOSED,
            "--twtweb", CLOSED, *extra]


def _env(extra: "dict | None") -> dict:
    return dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", **(extra or {}))


def run_torch_group(args: list, nprocs: int = 2, timeout: float = 240.0,
                    env: "dict | None" = None, app: str = "linear_regression") -> list:
    """The port's ``app`` in ``nprocs`` processes of one group (``--master
    twtml://``); [(returncode, stdout, stderr)] by rank. Every process is
    gone when this returns."""
    port = free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", f"twtml_tpu_torch.apps.{app}", *args,
             "--master", f"twtml://127.0.0.1:{port}", "--numProcesses", str(nprocs),
             "--processId", str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env(env),
            cwd=REPO)
        for i in range(nprocs)
    ]
    return _collect(procs, timeout)


def run_worker_group(mode: str, args: list, nprocs: int = 2, timeout: float = 240.0,
                     env: "dict | None" = None, port: int = 0) -> list:
    """``tests/torch_lockstep_worker.py <mode>`` in ``nprocs`` processes (the
    group's ``port``, a free one by default); [(returncode, stdout, stderr)]
    by rank."""
    port = port or free_port()
    procs = [spawn_worker(mode, i, nprocs, port, args, env) for i in range(nprocs)]
    return _collect(procs, timeout)


def spawn_worker(mode: str, rank: int, nprocs: int, port: int, args: list,
                 env: "dict | None" = None) -> subprocess.Popen:
    """One ``tests/torch_lockstep_worker.py <mode>`` process of a group."""
    return subprocess.Popen([sys.executable, TORCH_WORKER, mode, str(rank), str(nprocs),
                             str(port), *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=_env(env), cwd=REPO)


def _collect(procs, timeout: float) -> list:
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=timeout)
            out.append((p.returncode, stdout, stderr))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return out


def run_torch_single(args: list, timeout: float = 240.0, env: "dict | None" = None) -> str:
    """The port's linear app in one process; its stdout."""
    proc = subprocess.run([sys.executable, "-m", "twtml_tpu_torch.apps.linear_regression",
                           *args], capture_output=True, text=True, env=_env(env),
                          timeout=timeout, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def run_jax_single(args: list, devices: int = 4, timeout: float = 240.0,
                   env: "dict | None" = None) -> str:
    """The JAX linear app's single-process run (``devices`` virtual CPU
    devices); its stdout."""
    proc = subprocess.run([sys.executable, JAX_WORKER, "0", "1", "0", str(devices), "linear",
                           *args], capture_output=True, text=True, env=_env(env),
                          timeout=timeout, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def stat_lines(out: str) -> list:
    return [ln for ln in out.splitlines() if ln.startswith("count:")]


def assert_lines_match(got: list, want: list, slack: int = 2) -> None:
    """The JAX multi-host test's rule: the same number of lines, the
    cumulative count and batch size exact, the rounded stats within
    ``slack``."""
    assert len(got) == len(want), (got, want)
    for g_line, w_line in zip(got, want):
        g = [int(x) for x in re.findall(r"-?\d+", g_line)]
        w = [int(x) for x in re.findall(r"-?\d+", w_line)]
        assert g[:2] == w[:2], (g_line, w_line)
        assert len(g) == len(w)
        for a, b in zip(g[2:], w[2:]):
            assert abs(a - b) <= slack, (g_line, w_line)


def last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])
