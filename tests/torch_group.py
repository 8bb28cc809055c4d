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
MESH_WORKER = os.path.join(REPO, "tests", "torch_mesh_worker.py")
# a port process's CPU math runs on one thread: MKL's sgemv (X·w, Xᵀr) and
# torch's reductions split their sums by the thread count, which MKL's
# dynamic threading may lower on a loaded machine, so two runs of one
# process could end a few ulps apart
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "MKL_DYNAMIC": "FALSE"}
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


def _env(extra: "dict | None", port: bool = True) -> dict:
    """A test process's environment: the repo on the path, JAX on the CPU,
    and a port process (``port``) on one CPU thread (``ONE_THREAD``)."""
    return dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                **(ONE_THREAD if port else {}), **(extra or {}))


def run_torch_group(args: list, nprocs: int = 2, timeout: float = 240.0,
                    env: "dict | None" = None, app: str = "linear_regression",
                    join: str = "master") -> list:
    """The port's ``app`` in ``nprocs`` processes of one group (``--master
    twtml://``, or ``--coordinator`` with ``join="coordinator"``);
    [(returncode, stdout, stderr)] by rank. Every process is gone when this
    returns."""
    port = free_port()
    where = (["--master", f"twtml://127.0.0.1:{port}"] if join == "master"
             else ["--coordinator", f"127.0.0.1:{port}"])
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", f"twtml_tpu_torch.apps.{app}", *args, *where,
             "--numProcesses", str(nprocs), "--processId", str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env(env),
            cwd=REPO)
        for i in range(nprocs)
    ]
    return _collect(procs, timeout)


def run_mesh_group(mode: str, spec: dict, nprocs: int, timeout: float = 240.0) -> tuple:
    """One ``mode`` run of ``tests/torch_mesh_worker.py`` in ``nprocs``
    processes of one group on the CPU, with ``spec`` (written to its ``out``
    directory): (each rank's record of the run, with the rank's place on the
    mesh, each rank's arrays)."""
    return run_mesh_runs(spec, [{"mode": mode, "name": mode}], nprocs, timeout)[mode]


def run_mesh_runs(spec: dict, runs: list, nprocs: int, timeout: float = 240.0) -> dict:
    """The ``runs`` (each a dict with its ``mode``, ``name`` and the keys it
    sets over ``spec``'s) of ``tests/torch_mesh_worker.py`` in ``nprocs``
    processes of ONE group on the CPU: {name: (each rank's record of the
    run, with the rank's place on the mesh, each rank's arrays)}."""
    import numpy as np

    spec = dict(spec, device="cpu", runs=runs)
    path = os.path.join(spec["out"], f"{runs[0]['name']}-spec.json")
    with open(path, "w") as fh:
        json.dump(spec, fh)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, MESH_WORKER, str(i), str(nprocs), str(port),
                               path], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=_env(None), cwd=REPO)
             for i in range(nprocs)]
    out_runs = {run["name"]: ([], []) for run in runs}
    for rank, (rc, out, err) in enumerate(_collect(procs, timeout)):
        assert rc == 0, f"rank {rank}:\n{err[-3000:]}"
        rec = last_json(out)
        for name, (recs, arrays) in out_runs.items():
            recs.append(dict(rec["runs"][name], data_index=rec["data_index"],
                             model_index=rec["model_index"]))
            with np.load(os.path.join(spec["out"], f"{name}-rank{rank}.npz")) as data:
                arrays.append({k: data[k] for k in data.files})
    return out_runs


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


def run_torch_single(args: list, timeout: float = 240.0, env: "dict | None" = None,
                     app: str = "linear_regression") -> str:
    """The port's ``app`` in one process; its stdout."""
    proc = subprocess.run([sys.executable, "-m", f"twtml_tpu_torch.apps.{app}", *args],
                          capture_output=True, text=True, env=_env(env), timeout=timeout,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def run_jax_single(args: list, devices: int = 4, timeout: float = 240.0,
                   env: "dict | None" = None, app: str = "linear") -> str:
    """The JAX ``app``'s single-process run (``devices`` virtual CPU
    devices); its stdout."""
    proc = subprocess.run([sys.executable, JAX_WORKER, "0", "1", "0", str(devices), app,
                           *args], capture_output=True, text=True,
                          env=_env(env, port=False), timeout=timeout, cwd=REPO)
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
