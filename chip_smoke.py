#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``twtml_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
  1. device  — the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build   — compile every kernel of the port from ``twtml_tpu_torch/csrc``,
               and the host library of the wire path from ``native/*.cpp``;
  3. kernel  — the fused dense-SGD kernel (one cooperative launch a call)
               against its plain PyTorch twin on the card, case by case, at
               rtol 1e-4 / atol 1e-5 (only the summation order differs), each
               rerun bitwise equal: 7 cases of mixed sizes, then B = 1 and
               B = 16 (smaller than one CTA's rows), B = 16381 (a ragged last
               CTA, rows spilled), B = 4096 x F = 8196 (the tiled wide-F and
               spill path) with NaN/Inf in masked rows bitwise ignored, and
               the operating point (spill path);
  4. main    — the flagship app (``apps/linear_regression.run``, its
               streaming context and fetch pipeline, ``--seconds 0
               --batchBucket 16384``) on cuda for 4 full-width synthetic
               batches (16384 tweets, 1000 + 4 dims, 50 iterations,
               --modelWatch on) on its back-to-back wire: one native fill and
               one native pack a batch into ONE page-locked buffer, one H2D
               copy, decoded on the card. The kernel's launch counter (the 4
               batches and the pre-stream warm-up) and the native counters
               show the path went through them; the stats are held against
               the same app on the CPU;
  5. padded  — the same 4 batches on cuda through ``--wire padded``: weights,
               predictions, stats and quality bitwise equal to phase 4's;
  6. replay  — the replay fixture on cuda on both wires, lines equal to the
               CPU runs';
  7. stream  — 8 full-width batches of pinned synthetic tweets from a
               pre-filled queue source, publishing to a loopback recorder
               (this script's ``http.server``): 1 config post, 8 stats posts
               equal to the 8 printed lines, 8 series posts of at most
               SERIES_MAX_POINTS points, a Lightning session and 8 appends;
               every dispatch under ``torch.cuda.set_sync_debug_mode
               ("error")``; the run at fetch depth 8 bitwise equal to a run
               at depth 1 with synchronous copies (weights, predictions,
               stats, quality); per-batch dispatch, fetch wait, depth and
               publish times; tweets/s over batches 2-8; the device's idle
               share and the H2D copies against the kernels from a profiled
               run; the live synthetic source's own rate;
  8. clock   — ``--seconds 1`` on the default wire (padded), the synthetic
               source paced at 20000 tweets/s, 5 intervals: every interval's
               batch trains, the warm-up ends before the stream starts, the
               stats posts arrive; each tick's lateness and rows;
  9. times   — at the operating point: the launch plan (grid, rows resident
               and spilled, shared memory, registers from ptxas), kernel,
               prologue and per-iteration times, the twin, the bound; each
               wire's featurize by sub-stage, bytes and H2D copy; and where
               a step's time goes on each wire.
No app run publishes anywhere but the loopback recorder. The line before
the last is the kernels' JSON record; the last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import os
import statistics
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

HERE = os.path.dirname(os.path.abspath(__file__))
OP_ROWS = 16384  # bench.py's operating point: tweets per batch
OP_ITERS = 50
RTOL, ATOL = 1e-4, 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
NOW_MS = 1_700_000_000_000


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


class Recorder:
    """A loopback HTTP server (127.0.0.1, a free port) standing in for the
    twtml web dashboard and a Lightning server: it records every POST (path,
    JSON body) and answers Lightning's session and visualization requests
    with ids ``s1`` and ``v1``."""

    def __init__(self):
        self.posts: list = []
        self._lock = threading.Lock()
        recorder = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("content-length", 0)))
                with recorder._lock:
                    recorder.posts.append((self.path, body))
                reply = {"/sessions/": {"id": "s1"},
                         "/sessions/s1/visualizations/": {"id": "v1"}}.get(self.path, {})
                data = json.dumps(reply).encode()
                self.send_response(200)
                self.send_header("content-type", "application/json")
                self.send_header("content-length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def take(self) -> list:
        """The posts recorded since the last call, their bodies parsed (here,
        not while the server takes them: a run's timed window should not
        carry the recorder's JSON parse)."""
        with self._lock:
            posts, self.posts = self.posts, []
        return [(path, json.loads(body or b"{}")) for path, body in posts]

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


RECORDER: Recorder | None = None


def device_phase():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs on a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase("device", f"{torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} CUDA {torch.version.cuda} | "
          f"python {sys.version.split()[0]}")
    return smi


def build_phase():
    sys.path.insert(0, HERE)
    from twtml_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build()
    phase("build", f"{len(paths)} kernel librar{'y' if len(paths) == 1 else 'ies'} "
          f"in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        log = path.with_name(path.name + ".log")
        report = log.read_text().strip() if log.exists() else "(built earlier)"
        phase("build", f"{name}: {path.name}\n{report}")
    from twtml_tpu_torch.features import native

    t0 = time.perf_counter()
    lib = native.NativeLibrary(native.build())
    if lib.featurize_wire is None or lib.wire_assemble is None:
        raise AssertionError(f"{lib.path.name} lacks a native entry of the wire path")
    phase("build", f"native host library {lib.path.name} (g++, "
          f"{' '.join(native.FLAGS)}) in {time.perf_counter() - t0:.1f} s")


# ---- phase 3: kernel against twin ------------------------------------------

def design(rng, rows, features, n_valid, terms=40):
    """A tweet-like design: ``terms`` bigram counts of 1 or 2 per row in the
    text columns, 4 small numeric columns, a random mask."""
    import numpy as np

    x = np.zeros((rows, features), dtype="float32")
    cols = rng.integers(0, features - 4, size=(rows, terms))
    np.add.at(x, (np.arange(rows)[:, None], cols), rng.integers(1, 3, size=(rows, terms)))
    x[:, -4:] = rng.normal(size=(rows, 4)) * 1e-3
    y = rng.uniform(50, 900, size=(rows,)).astype("float32")
    mask = (rng.permutation(rows) < n_valid).astype("float32")
    return x, y, mask


def compare(name, got, want):
    import torch

    err = (got - want).abs()
    rel = (err / want.abs().clamp(min=1e-30)).max().item()
    bad = err > ATOL + RTOL * want.abs()
    if bad.any() or not torch.isfinite(got).all():
        i = int(err.argmax())
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside rtol {RTOL} atol {ATOL}; "
            f"max abs err {err.max().item():.3e} at [{i}]: kernel "
            f"{got.flatten()[i].item():.8e} twin {want.flatten()[i].item():.8e}; "
            f"max |twin| {want.abs().max().item():.3e}"
        )
    return err.max().item(), rel


def op_point_batch():
    """The operating point's host batch: 16384 SyntheticSource(seed=3)
    tweets on the padded units wire."""
    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.streaming.sources import SyntheticSource

    tweets = list(SyntheticSource(total=OP_ROWS, seed=3, base_ms=NOW_MS).produce())
    return Featurizer(now_ms=NOW_MS).featurize_batch_units(tweets, row_bucket=OP_ROWS)


def op_point_inputs(device):
    """The operating point's kernel inputs, densified on the card by the
    port's ops (1000 text + 4 numeric dims), and a small random w0."""
    import numpy as np
    import torch

    from twtml_tpu_torch.models.sgd import batch_to_device
    from twtml_tpu_torch.ops.sparse import densify_text
    from twtml_tpu_torch.ops.text_hash import hash_bigrams_device

    batch = batch_to_device(op_point_batch(), device)
    idx, val = hash_bigrams_device(batch.units, batch.length, 1000)
    x = torch.cat([densify_text(idx, val, 1000), batch.numeric], dim=1)
    w0 = torch.from_numpy(
        np.random.default_rng(3).normal(size=(1004,)).astype("float32") * 1e-3
    ).to(device)
    return x, batch.label, batch.mask, w0


def kernel_phase():
    import numpy as np
    import torch

    from twtml_tpu_torch.ops import fused_sgd

    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    cases = []

    def case(name, x, y, mask, w0, dirty=False, **kw):
        """Kernel vs twin at rtol/atol, a bitwise rerun, and with ``dirty``
        NaN/Inf garbage in the masked rows, bitwise the same result."""
        kw.setdefault("num_iterations", OP_ITERS)
        kw.setdefault("step_size", 0.005)
        w, p = fused_sgd.fused_dense_sgd(x, y, mask, w0, **kw)
        w_ref, p_ref = fused_sgd.fused_dense_sgd_reference(x, y, mask, w0, **kw)
        w_again, p_again = fused_sgd.fused_dense_sgd(x, y, mask, w0, **kw)
        torch.cuda.synchronize()
        ew, rw = compare(f"{name} weights", w, w_ref)
        ep, rp = compare(f"{name} preds", p, p_ref)
        if not (torch.equal(w, w_again) and torch.equal(p, p_again)):
            raise AssertionError(f"{name}: reruns are not bitwise equal")
        note = "rerun bitwise equal"
        if dirty:
            keep = mask > 0
            x_d = torch.where(keep[:, None], x, float("nan"))
            y_d = torch.where(keep, y, float("inf"))
            w_d, p_d = fused_sgd.fused_dense_sgd(x_d, y_d, mask, w0, **kw)
            if not (torch.equal(w, w_d) and torch.equal(p, p_d)):
                raise AssertionError(f"{name}: NaN/Inf in masked rows reached the result")
            note += f"; NaN/Inf in {int((~keep).sum())} masked rows: bitwise equal"
        plan = fused_sgd.launch_plan(x.shape[0], x.shape[1], **sm_limits())
        phase("kernel", f"{name}: B={x.shape[0]} F={x.shape[1]} grid {plan.grid}, "
              f"{plan.resident_rows} rows resident, {plan.spill_rows} spilled; "
              f"max abs err w {ew:.3e} preds {ep:.3e}; max rel w {rw:.3e} "
              f"preds {rp:.3e}; {note}")
        cases.append((name, max(ew, ep)))
        return w, p

    x, y, m = design(rng, 16, 64, 14, terms=6)
    case("small", to(x), to(y), to(m), to(np.zeros(64, "float32")),
         num_iterations=30)
    x, y, m = design(rng, 1001, 1004, 1001)
    case("ragged", to(x), to(y), to(m), to(rng.normal(size=1004).astype("float32") * 1e-3))

    x, y, m = design(rng, 64, 1004, 0)
    w0 = to(rng.normal(size=1004).astype("float32"))
    w, p = case("count=0", to(x), to(y), to(m), w0, l2_reg=0.5)
    if not torch.equal(w, w0) or not torch.equal(p, torch.zeros_like(p)):
        raise AssertionError("count=0: weights must be unchanged, preds 0")

    x, y, m = design(rng, 256, 1004, 200)
    x_dirty, y_dirty = x.copy(), y.copy()
    x_dirty[m == 0] = np.nan
    y_dirty[m == 0] = np.inf
    w_clean, p_clean = case("masked clean", to(x * m[:, None]), to(y * m), to(m),
                            to(np.zeros(1004, "float32")))
    w_dirty, p_dirty = case("masked NaN/Inf", to(x_dirty), to(y_dirty), to(m),
                            to(np.zeros(1004, "float32")))
    if not (torch.equal(w_clean, w_dirty) and torch.equal(p_clean, p_dirty)):
        raise AssertionError("NaN/Inf garbage in masked rows reached the result")

    x, y, m = design(rng, 512, 1004, 500)
    case("converge tol 0.5", to(x), to(y), to(m), to(np.zeros(1004, "float32")),
         convergence_tol=0.5)
    case("l2Reg 0.1", to(x), to(y), to(m), to(np.zeros(1004, "float32")), l2_reg=0.1)

    # smaller than one CTA's rows, a ragged last CTA, the wide-F tiled path
    small_w0 = lambda f: to(rng.normal(size=f).astype("float32") * 1e-3)  # noqa: E731
    x, y, m = design(rng, 1, 1004, 1)
    case("B=1", to(x), to(y), to(m), small_w0(1004))
    x, y, m = design(rng, 16, 1004, 12)
    case("B=16", to(x), to(y), to(m), small_w0(1004), dirty=True)
    x, y, m = design(rng, 16381, 1004, 16000)
    case("ragged last CTA (spill path)", to(x), to(y), to(m), small_w0(1004), dirty=True)
    x, y, m = design(rng, 4096, 8196, 4000)
    case("wide F (tiled + spill path)", to(x), to(y), to(m), small_w0(8196), dirty=True)
    del x, y, m

    x, y, m, w0 = op_point_inputs(dev)
    case("operating point (spill path)", x, y, m, w0)
    torch.cuda.synchronize()
    return max(e for _, e in cases)


def sm_limits():
    """The launch plan's card arguments for device 0."""
    from twtml_tpu_torch.ops import fused_sgd

    sm_count, shared_limit = fused_sgd.device_limits(0)
    return {"sm_count": sm_count, "shared_limit": shared_limit}


# ---- phase 4/5/6: the main path on each wire --------------------------------

def app_run(argv, max_batches=0, **kw):
    """One run of the app with ``argv``, publishing to the loopback
    recorder only; returns its totals and printed lines."""
    from twtml_tpu_torch.apps.linear_regression import run
    from twtml_tpu_torch.config import ConfArguments

    out = io.StringIO()
    conf = ConfArguments().parse(
        ["--lightning", RECORDER.url, "--twtweb", RECORDER.url, *argv])
    with contextlib.redirect_stdout(out):
        totals = run(conf, max_batches=max_batches, **kw)
    return totals, out.getvalue().splitlines()


class ErrorLog(logging.Handler):
    """The port's ERROR records of a run: a batch whose dispatch raised (a
    sync under the sync-debug mode, a kernel that did not launch) is logged
    and skipped by the streaming context, never silently."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.records: list = []

    def emit(self, record):
        self.records.append(record)


def recorded_app_run(argv, max_batches, source=None, blocking_copies=False, **kw):
    """One app run with the kernel's launch counter and the native counters
    set to 0 just before it and read just after, recording what the run's
    model returned: the warm-up's output, each batch's StepOutput (device
    tensors), the iterations each fused call ran (device scalars, no sync)
    and the final weights. ``source`` replaces the configured source;
    ``blocking_copies`` makes every H2D copy synchronous. A run that logged
    an error fails."""
    import torch

    from twtml_tpu_torch.apps import common
    from twtml_tpu_torch.apps import linear_regression as app
    from twtml_tpu_torch.features import native
    from twtml_tpu_torch.models import sgd as sgd_module
    from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
    from twtml_tpu_torch.ops import fused_sgd

    rec = {"outputs": [], "iterations": []}
    base_build, base_source = app.build_model, app.build_source

    class Recorded(StreamingLinearRegressionWithSGD):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.non_blocking = not blocking_copies

        def step(self, batch):
            out = super().step(batch)
            rec["outputs"].append(out)
            rec["model"] = self
            return out

    def fused(*args, **kw):
        out = fused_sgd.fused_dense_sgd(*args, **kw)
        rec["iterations"].append(fused_sgd.fused_dense_sgd.last_iterations)
        return out

    app.build_model = lambda conf: common.build_model(conf, model_cls=Recorded)
    sgd_module.fused_dense_sgd = fused
    if source is not None:
        app.build_source = lambda conf: source
    errors = ErrorLog()
    logging.getLogger("twtml_tpu_torch").addHandler(errors)
    try:
        fused_sgd.fused_dense_sgd.launches = 0
        native.reset_counters()
        t0 = time.perf_counter()
        totals, lines = app_run(argv, max_batches=max_batches, **kw)
        torch.cuda.synchronize()
        rec["wall_s"] = time.perf_counter() - t0
        rec["launches"] = fused_sgd.fused_dense_sgd.launches
        rec["native"] = dict(native.COUNTERS)
    finally:
        logging.getLogger("twtml_tpu_torch").removeHandler(errors)
        app.build_model, app.build_source = base_build, base_source
        sgd_module.fused_dense_sgd = fused_sgd.fused_dense_sgd
    if errors.records:
        raise AssertionError("the run logged errors: " + "; ".join(
            f"{r.getMessage()} {r.exc_text or ''}" for r in errors.records))
    # the first step is the pre-stream warm-up's all-padding batch
    rec["warmup"], rec["outputs"] = rec["outputs"][0], rec["outputs"][1:]
    rec["iterations"] = rec["iterations"][1:]
    rec["weights"] = rec["model"].latest_weights
    if float(rec["warmup"].count) != 0:
        raise AssertionError("the warm-up step trained rows")
    return totals, lines, rec


def check_counters(name, rec, batches, wire):
    """The kernel launched once a batch and once for the warm-up; on the
    ragged wire the native fill and pack built every batch (the fill also
    the batch featurized when a cap stopped the stream), never degraded."""
    if rec["launches"] != batches + 1:
        raise AssertionError(f"{name}: fused_dense_sgd launched {rec['launches']} times "
                             f"for {batches} batches and the warm-up")
    nat = rec["native"]
    if wire == "ragged":
        ok = (nat["packs_native"] == batches + 1 and nat["fills_native"] - batches - 1 in (0, 1)
              and nat["fills_degraded"] == nat["packs_degraded"] == 0)
    else:
        ok = not any(nat.values())
    if not ok:
        raise AssertionError(f"{name}: native counters {nat} for {batches} batches on {wire}")


MAIN_ARGV = ["--source", "synthetic", "--seconds", "0", "--batchBucket", str(OP_ROWS)]


def main_path_phase():
    import math

    from twtml_tpu_torch.ops import fused_sgd

    totals, lines, rec = recorded_app_run(["--backend", "cuda", *MAIN_ARGV], 4)
    launches = rec["launches"]
    for line, step in zip(lines, totals["steps"]):
        subs = ", ".join(f"{k} {v:.1f}" for k, v in step["featurize_substages_ms"].items())
        phase("main", f"{line} | {step['wire']} wire {step['wire_bytes']} B "
              f"(native fill {step['native_fill']}, pack {step['native_pack']}) | "
              f"featurize {step['featurize_ms']:.1f} ms ({subs}), "
              f"step {step['step_ms']:.2f} ms (CUDA events)")
    if totals["batches"] != 4 or totals["count"] != 4 * OP_ROWS:
        raise AssertionError(f"main path ran {totals['batches']} batches, "
                             f"{totals['count']} rows")
    check_counters("main", rec, 4, "ragged")
    if not all(st["wire"] == "ragged" and st["native_fill"] and st["native_pack"]
               for st in totals["steps"]):
        raise AssertionError("a main-path batch did not take the ragged native wire")
    phase("main", f"native counters: {rec['native']} (4 batches, the warm-up's "
          "all-padding batch, and a batch featurized as the cap stopped the stream)")
    steady = totals["steps"][1:]  # batch 1 pays first-use set-up
    host_ms = sum(st["featurize_ms"] for st in steady)
    dev_ms = sum(st["step_ms"] for st in steady)
    phase("main", f"app wall {rec['wall_s']:.3f} s for {totals['count']} tweets = "
          f"{totals['count'] / rec['wall_s']:.0f} tweets/s (synthetic source "
          f"generation, session set-up, the warm-up and the stats fetches included)")
    phase("main", f"batches 2-4: featurize {host_ms:.1f} ms + step {dev_ms:.2f} ms"
          f" for {len(steady) * OP_ROWS} tweets = "
          f"{len(steady) * OP_ROWS / (host_ms + dev_ms) * 1e3:.0f} tweets/s "
          f"featurized and trained (bench.py's window: source excluded)")
    per_call = fused_sgd.launches_per_call(OP_ITERS)
    phase("main", f"fused_dense_sgd launches: {launches} calls (4 batches and the "
          f"warm-up) = {launches * per_call} device kernel launches ({per_call} per call)")
    phase("main", "iterations run before the converged freeze, batches 1-4: "
          f"{[int(t.item()) for t in rec['iterations']]} of {OP_ITERS}")
    for i, step in enumerate(totals["steps"]):
        values = [step[k] for k in ("count", "mse", "real_stdev", "pred_stdev")]
        values += step["quality"]
        if len(step["quality"]) != 19 or not all(map(math.isfinite, values)):
            raise AssertionError(f"batch {i + 1}: non-finite stats or quality")

    # the same app on the CPU (the twin's path) over the same 4 batches:
    # batch 1 starts from zero weights, so its reported stats must be equal;
    # every unrounded stat agrees within the kernel's 1e-4
    from twtml_tpu_torch.utils.rounding import round_half_up

    cpu_totals, cpu_lines = app_run(["--backend", "cpu", *MAIN_ARGV], max_batches=4)
    if lines[0] != cpu_lines[0]:
        raise AssertionError(f"batch 1: cuda {lines[0]!r} != cpu {cpu_lines[0]!r}")
    for i, (g, c) in enumerate(zip(totals["steps"], cpu_totals["steps"])):
        for k in ("count", "mse", "real_stdev", "pred_stdev"):
            if abs(g[k] - c[k]) > RTOL * abs(c[k]) + ATOL:
                raise AssertionError(f"batch {i + 1} {k}: cuda {g[k]} cpu {c[k]}")
        if i == 0 and any(round_half_up(g[k]) != round_half_up(c[k])
                          for k in ("mse", "real_stdev", "pred_stdev")):
            raise AssertionError("batch 1 reported stats differ from the CPU run")
    phase("main", "stats of 4 batches equal the CPU twin's within rtol 1e-4; "
          "batch 1's reported line is identical")
    return launches, rec


def padded_phase(ragged_rec):
    """The same 4 batches on the card through ``--wire padded``: the design
    matrix is the same, so everything must be bitwise equal."""
    import numpy as np
    import torch

    totals, lines, rec = recorded_app_run(
        ["--backend", "cuda", "--wire", "padded", *MAIN_ARGV], 4)
    for line, step in zip(lines, totals["steps"]):
        subs = ", ".join(f"{k} {v:.1f}" for k, v in step["featurize_substages_ms"].items())
        phase("padded", f"{line} | {step['wire']} wire {step['wire_bytes']} B | "
              f"featurize {step['featurize_ms']:.1f} ms ({subs}), "
              f"step {step['step_ms']:.2f} ms (CUDA events)")
    steady = totals["steps"][1:]
    host_ms = sum(st["featurize_ms"] for st in steady)
    dev_ms = sum(st["step_ms"] for st in steady)
    phase("padded", f"batches 2-4: featurize {host_ms:.1f} ms + step {dev_ms:.2f} ms"
          f" for {len(steady) * OP_ROWS} tweets = "
          f"{len(steady) * OP_ROWS / (host_ms + dev_ms) * 1e3:.0f} tweets/s "
          f"featurized and trained (bench.py's window: source excluded)")
    if totals["batches"] != 4 or len(rec["outputs"]) != len(ragged_rec["outputs"]):
        raise AssertionError(f"padded: ran {totals['batches']} batches")
    check_counters("padded", rec, 4, "padded")
    for i, (a, b) in enumerate(zip(ragged_rec["outputs"], rec["outputs"])):
        for k in ("predictions", "quality", "count", "mse", "real_stdev", "pred_stdev"):
            if not torch.equal(getattr(a, k), getattr(b, k)):
                raise AssertionError(f"batch {i + 1}: {k} differs between the wires")
    if not np.array_equal(ragged_rec["weights"], rec["weights"]):
        raise AssertionError("final weights differ between the ragged and padded wires")
    phase("padded", "4 batches: weights, predictions, stats and quality bitwise "
          "equal to the ragged packed run; kernel launches 4 + the warm-up's, "
          "native counters 0")


def replay_phase():
    argv = ["--source", "replay", "--replayFile",
            os.path.join(HERE, "tests", "data", "tweets.jsonl"), "--seconds", "0",
            "--batchBucket", "4"]
    runs = {
        (backend, wire): app_run(["--backend", backend, "--wire", wire, *argv])[1]
        for backend in ("cuda", "cpu") for wire in ("ragged", "padded")
    }
    for line in runs["cuda", "ragged"]:
        phase("replay", line)
    if len(runs["cuda", "ragged"]) != 3 or any(
            lines != runs["cuda", "ragged"] for lines in runs.values()):
        raise AssertionError(f"replay lines differ: {runs}")
    phase("replay", "3 batches, lines identical on cuda and cpu, ragged and padded")


# ---- phase 7: the streaming runtime at full width --------------------------

STREAM_BATCHES = 8
STREAM_ARGV = ["--backend", "cuda", "--source", "synthetic", "--seconds", "0",
               "--batchBucket", str(OP_ROWS), "--maxQueueRows", "-1"]


def prefilled_source(statuses):
    """A queue source holding ``statuses``, closed: the stream ends when
    they are batched, and no tweet is generated inside the timed window."""
    from twtml_tpu_torch.streaming.sources import QueueSource

    src = QueueSource()
    for st in statuses:
        src.push(st)
    src.close()
    return src


def check_posts(name, posts, lines):
    """The dashboard and Lightning posts of one run against its printed
    lines: 1 config, a stats post per line equal to it, a series post per
    line of at most SERIES_MAX_POINTS points, a Lightning session, its
    visualization and an append per line."""
    from twtml_tpu_torch.telemetry.session_stats import SERIES_MAX_POINTS

    api = [b for p, b in posts if p == "/api"]
    kinds = [b["jsonClass"] for b in api]
    stats = [b for b in api if b["jsonClass"] == "Stats"]
    series = [b for b in api if b["jsonClass"] == "Series"]
    lgn = [p for p, _ in posts if p != "/api"]
    printed = [
        f"count: {b['count']}  batch: {b['batch']}  mse: {float(b['mse'])}  "
        f"stdev (real, pred): ({b['realStddev']}, {b['predStddev']})" for b in stats
    ]
    if kinds.count("Config") != 1 or printed != lines:
        raise AssertionError(f"{name}: posts {kinds} / stats {printed} against lines {lines}")
    if len(series) != len(lines) or any(
            not 0 < len(b["real"]) == len(b["pred"]) <= SERIES_MAX_POINTS for b in series):
        raise AssertionError(f"{name}: {len(series)} series posts for {len(lines)} batches")
    want = ["/sessions/", "/sessions/s1/visualizations/"] + ["/visualizations/v1/data/"] * len(lines)
    if lgn != want:
        raise AssertionError(f"{name}: Lightning posts {lgn}")
    phase(name, f"posts: {kinds.count('Config')} config, {len(stats)} stats equal to the "
          f"printed lines, {len(series)} series of <= {SERIES_MAX_POINTS} points, "
          f"{kinds.count('Metrics')} metrics; Lightning: session, visualization, "
          f"{len(lgn) - 2} appends")


def device_timeline(prof):
    """(start us, end us, name) of every device event of a profile."""
    out = []
    for ev in prof.events():
        if getattr(ev, "device_type", None) is not None and ev.device_type.name == "CUDA":
            out.append((ev.time_range.start, ev.time_range.end, ev.name))
    return sorted(out)


def timeline_report(events):
    """Idle share of the device over batches 2-8 (from batch 2's H2D copy
    to the last event), the H2D copies in that window, from which memory,
    and how many overlap a kernel."""
    kernels = [e for e in events if KERNEL in e[2]]
    if len(kernels) != STREAM_BATCHES + 1:
        phase("stream", f"profiler: {len(kernels)} fused kernels recorded, want "
              f"{STREAM_BATCHES + 1}; timeline not measured")
        return None
    h2d_all = [e for e in events if "HtoD" in e[2]]
    h2d = [e for e in h2d_all if e[0] >= kernels[1][1]]  # after batch 1's kernel
    if not h2d:
        phase("stream", "profiler: no H2D copy recorded; timeline not measured")
        return None
    lo, hi = h2d[0][0], max(e[1] for e in events)
    busy, cursor = 0.0, lo
    for start, end, _ in events:
        start, end = max(start, cursor), min(end, hi)
        if end > start:
            busy += end - start
            cursor = end
    copies = [e for e in events if "Memcpy" in e[2] or "memcpy" in e[2].lower()]
    compute = [e for e in events if e not in copies]
    overlap = sum(any(c[0] < k[1] and k[0] < c[1] for k in compute) for c in h2d)
    pinned = sum("Pinned" in c[2] for c in h2d)
    idle = 1 - busy / (hi - lo)
    phase("stream", f"device over batches 2-8 (profiler): {(hi - lo) / 1e3:.3f} ms window, "
          f"{busy / 1e3:.3f} ms busy, {100 * idle:.1f}% idle; {len(h2d)} H2D copies "
          f"({pinned} from pinned memory: {sorted({c[2] for c in h2d})}), {overlap} "
          "overlapping a kernel (one stream: copies and kernels run in order)")
    return {"idle": idle, "h2d": len(h2d), "overlap": overlap}


def stream_phase():
    """The streaming runtime at full width: a pre-filled source, the fetch
    pipeline at depth 8 with every dispatch under the sync-debug mode, its
    posts, the same run at depth 1 with synchronous copies (bitwise), a
    profiled run, and the live synthetic source's own rate."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from twtml_tpu_torch.apps.common import SYNC_DEBUG_ENV
    from twtml_tpu_torch.streaming.sources import SyntheticSource

    t0 = time.perf_counter()
    statuses = list(SyntheticSource(total=STREAM_BATCHES * OP_ROWS, seed=5,
                                    base_ms=NOW_MS).produce())
    phase("stream", f"{len(statuses)} tweets generated in {time.perf_counter() - t0:.2f} s "
          "(before the runs, not timed in them)")
    RECORDER.take()
    os.environ[SYNC_DEBUG_ENV] = "error"
    try:
        totals, lines, rec = recorded_app_run(STREAM_ARGV, 0, source=prefilled_source(statuses))
    finally:
        del os.environ[SYNC_DEBUG_ENV]
    posts = RECORDER.take()
    steps = totals["steps"]
    if (totals["batches"], totals["count"], len(steps), len(lines)) != (
            STREAM_BATCHES, STREAM_BATCHES * OP_ROWS, STREAM_BATCHES, STREAM_BATCHES):
        raise AssertionError(f"stream: {totals['batches']} batches, {totals['count']} rows, "
                             f"{len(steps)} records for {STREAM_BATCHES} batches fed")
    check_counters("stream", rec, STREAM_BATCHES, "ragged")
    phase("stream", f"{STREAM_BATCHES} batches of {OP_ROWS} trained, every dispatch under "
          "torch.cuda.set_sync_debug_mode('error'): no sync raised, no error logged; "
          f"kernel launches {rec['launches']} (batches + warm-up), native {rec['native']}")
    for i, (line, st) in enumerate(zip(lines, steps)):
        phase("stream", f"batch {i + 1}: {line} | featurize {st['featurize_ms']:.2f} ms, "
              f"dispatch {st['dispatch_ms']:.3f} ms, depth in flight at dispatch "
              f"{st['depth']}, fetch wait {st['fetch_wait_ms']:.3f} ms, step "
              f"{st['step_ms']:.3f} ms (CUDA events), publish {st['publish_ms']:.3f} ms")
    check_posts("stream", posts, lines)
    span = steps[-1]["delivered_s"] - steps[0]["delivered_s"]
    rate = (STREAM_BATCHES - 1) * OP_ROWS / span
    later = steps[1:]
    means = {k: statistics.mean(st[k] for st in later)
             for k in ("featurize_ms", "dispatch_ms", "fetch_wait_ms", "publish_ms")}
    phase("stream", f"batches 2-{STREAM_BATCHES}: {(STREAM_BATCHES - 1) * OP_ROWS} tweets "
          f"delivered in {span:.4f} s = {rate:.0f} tweets/s; whole stream "
          f"{totals['count']} tweets in stream_seconds {totals['stream_seconds']:.4f} s = "
          f"{totals['count'] / totals['stream_seconds']:.0f} tweets/s; means a batch: "
          + ", ".join(f"{k} {v:.3f}" for k, v in means.items()))

    totals1, lines1, rec1 = recorded_app_run(
        STREAM_ARGV, 0, source=prefilled_source(statuses), fetch_depth=1,
        blocking_copies=True)
    RECORDER.take()
    if lines1 != lines or max(st["depth"] for st in totals1["steps"]) != 0:
        raise AssertionError("stream: the depth-1 run's lines differ")
    for i, (a, b) in enumerate(zip(rec["outputs"], rec1["outputs"], strict=True)):
        for k in ("predictions", "quality", "count", "mse", "real_stdev", "pred_stdev"):
            if not torch.equal(getattr(a, k), getattr(b, k)):
                raise AssertionError(f"stream batch {i + 1}: {k} differs between depth 8 and 1")
    if not np.array_equal(rec["weights"], rec1["weights"]):
        raise AssertionError("stream: final weights differ between depth 8 and depth 1")
    phase("stream", f"depth 8 (non-blocking copies from pinned memory) bitwise equal to "
          f"depth 1 (synchronous copies) over {STREAM_BATCHES} batches: weights, "
          f"predictions, stats, quality; depth-1 stream {totals1['stream_seconds']:.4f} s")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        totals_p, _, rec_p = recorded_app_run(STREAM_ARGV, 0, source=prefilled_source(statuses))
        torch.cuda.synchronize()
    RECORDER.take()
    timeline = timeline_report(device_timeline(prof))
    phase("stream", f"profiled run: stream_seconds {totals_p['stream_seconds']:.4f} s "
          f"(profiler on), kernel launches {rec_p['launches']}")

    src = SyntheticSource(seed=6, base_ms=NOW_MS, total=OP_ROWS)
    got = []
    t0 = time.perf_counter()
    src.start(got.append)
    while not src.exhausted and time.perf_counter() - t0 < 60:
        time.sleep(0.005)
    live_s = time.perf_counter() - t0
    src.stop()
    if len(got) != OP_ROWS:
        raise AssertionError(f"live synthetic source gave {len(got)} tweets")
    phase("stream", f"live SyntheticSource alone: {OP_ROWS} tweets in {live_s:.3f} s = "
          f"{OP_ROWS / live_s:.0f} tweets/s (its producer thread, nothing else running)")
    return {"launches": rec["launches"], "rate": rate, "timeline": timeline}


WALL_BATCHES = 5
WALL_ARGV = ["--backend", "cuda", "--source", "synthetic", "--seconds", "1",
             "--replaySpeed", "20000"]


def clock_phase():
    """``--seconds 1`` on the default wire: each interval's tweets, one
    synchronous fetch a batch, the warm-up before the first tick."""
    from twtml_tpu_torch.apps import linear_regression as app
    from twtml_tpu_torch.config import ConfArguments
    from twtml_tpu_torch.streaming.context import StreamingContext

    if ConfArguments().parse(WALL_ARGV).effective_wire() != "padded":
        raise AssertionError("--seconds 1 must resolve the default wire to padded")
    marks = {}
    base_warm, base_start = app.warmup_compile, StreamingContext.start

    def warm(*a, **k):
        base_warm(*a, **k)
        marks["warm_end"] = time.perf_counter()

    def start(self):
        marks["start"] = time.perf_counter()
        base_start(self)

    app.warmup_compile, StreamingContext.start = warm, start
    try:
        RECORDER.take()
        os.environ["TWTML_SYNC_DEBUG"] = "error"
        totals, lines, rec = recorded_app_run(WALL_ARGV, WALL_BATCHES)
    finally:
        os.environ.pop("TWTML_SYNC_DEBUG", None)
        app.warmup_compile, StreamingContext.start = base_warm, base_start
    posts = RECORDER.take()
    steps = totals["steps"]
    if (totals["batches"], len(steps)) != (WALL_BATCHES, WALL_BATCHES) or any(
            st["count"] <= 0 or st["wire"] != "padded" for st in steps):
        raise AssertionError(f"clock: {totals['batches']} batches: {steps}")
    if totals["count"] != sum(st["count"] for st in steps):
        raise AssertionError("clock: the count does not add up")
    check_counters("clock", rec, WALL_BATCHES, "padded")
    if not marks["warm_end"] <= totals["stream_started_s"] <= marks["start"]:
        raise AssertionError(f"clock: the warm-up did not end before the stream: {marks}")
    check_posts("clock", posts, lines)
    for i, (line, st) in enumerate(zip(lines, steps)):
        late = st["featurize_started_s"] - (totals["stream_started_s"] + (i + 1) * 1.0)
        phase("clock", f"tick {i + 1}: {line} | {int(st['count'])} rows, lateness "
              f"{late * 1e3:.2f} ms, featurize {st['featurize_ms']:.2f} ms, dispatch "
              f"{st['dispatch_ms']:.3f} ms, fetch wait {st['fetch_wait_ms']:.3f} ms, "
              f"publish {st['publish_ms']:.3f} ms")
    phase("clock", f"{WALL_BATCHES} intervals trained on the padded wire, warm-up "
          f"ended {(marks['start'] - marks['warm_end']) * 1e3:.1f} ms before the stream "
          f"started; kernel launches {rec['launches']} (intervals + warm-up)")
    return rec["launches"]


# ---- phase 9: times ---------------------------------------------------------

# ~0.1 ms of device work queued ahead of a timed call, so that its start
# event fires only after the host has enqueued the call's launch
QUEUE_AHEAD_CYCLES = 200_000


def timed(fn, runs, queue_ahead=False):
    """Median and all of ``runs`` CUDA-event times of ``fn``. With
    ``queue_ahead`` the device is kept busy while the host enqueues, so the
    time is the device's alone; without it the host's enqueue gap counts."""
    import torch

    times = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        if queue_ahead:
            torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


KERNEL = "fused_sgd_kernel"


def profile_kernel(kernel_only, runs=5):
    """Device time of the kernel's launches, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            kernel_only()
        torch.cuda.synchronize()
    rows = [ev for ev in prof.key_averages() if ev.device_time_total and KERNEL in ev.key]
    if not rows:
        phase("times", "profiler: no device time recorded; breakdown not measured")
        return
    us = sum(ev.device_time_total for ev in rows) / runs
    n = sum(ev.count for ev in rows) / runs
    phase("times", f"profile {KERNEL}: {us / 1e3:.4f} ms per call in {n:g} launch(es)")


def wire_batches():
    """The operating point's 4 batches (SyntheticSource(seed=3)) on each
    wire, featurized chunk by chunk in turns (ragged packed, then padded),
    with each call's featurize ms and its sub-stages."""
    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.streaming.sources import SyntheticSource

    tweets = list(SyntheticSource(total=4 * OP_ROWS, seed=3, base_ms=NOW_MS).produce())
    featurizer = Featurizer(now_ms=NOW_MS)
    wires = {"ragged": ([], []), "padded": ([], [])}
    for i in range(0, 4 * OP_ROWS, OP_ROWS):
        chunk = tweets[i:i + OP_ROWS]
        for wire, (batches, times) in wires.items():
            t0 = time.perf_counter()
            if wire == "ragged":
                batch = featurizer.featurize_batch_ragged(chunk, row_bucket=OP_ROWS, pack=True)
            else:
                batch = featurizer.featurize_batch_units(chunk, row_bucket=OP_ROWS)
            times.append(((time.perf_counter() - t0) * 1e3, {
                name: seconds * 1e3 for name, _, seconds in featurizer.last_substages}))
            batches.append(batch)
    return wires


def h2d_ms(batch, runs=20):
    """Host wall of ``batch_to_device`` on the card, synchronised: median
    and min of ``runs``."""
    import torch

    from twtml_tpu_torch.models.sgd import batch_to_device

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch_to_device(batch, "cuda")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), min(times)


def model_after_batch_1(batches):
    """A fresh model on the card that has stepped ``batches[0]`` (which also
    pays first-use set-up)."""
    from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD

    model = StreamingLinearRegressionWithSGD(device="cuda", quality=True)
    float(model.step(batches[0]).mse)
    return model


def step_walls(wires, rounds=5):
    """Host wall a step on each wire: batches 2-4 of the operating point's
    stream (fresh batches, so each step's loop runs as the app's does),
    the H2D copy, launches and the stats fetch that ends each step
    included, no profiler. The wires take turns, ``rounds`` times."""
    walls = {wire: [] for wire in wires}
    for _ in range(rounds):
        for wire, (batches, _) in wires.items():
            model = model_after_batch_1(batches)
            t0 = time.perf_counter()
            for batch in batches[1:]:
                float(model.step(batch).mse)
            walls[wire].append((time.perf_counter() - t0) * 1e3 / 3)
    for wire, times in walls.items():
        phase("times", f"{wire}: host wall a step, batches 2-4, {rounds} rounds in "
              f"turns: median {statistics.median(times):.3f} ms (all "
              f"{', '.join(f'{t:.3f}' for t in times)})")
    return {wire: statistics.median(times) for wire, times in walls.items()}


def profile_step(wire, batches, wall_ms):
    """Where a step's time goes on ``wire``, batches 2-4: device time by
    CUDA kernel from torch.profiler on one model, the host's launches on a
    second, against the host wall ``wall_ms`` from ``step_walls``. The
    per-step figures divide by the steps whose kernels the profiler
    recorded, counted by the fused kernel's launches (one a step)."""
    from torch.profiler import ProfilerActivity, profile

    model = model_after_batch_1(batches)
    # device activity only: with CPU activity on, the aten ops' events
    # repeat their kernels' device time and the sum counts it twice
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for batch in batches[1:]:
            float(model.step(batch).mse)
    kernels = [ev for ev in prof.key_averages() if ev.device_time_total]
    steps = sum(ev.count for ev in kernels if KERNEL in ev.key)
    if not steps:
        phase("times", f"{wire} step: profiler recorded no kernel of the step, "
              "breakdown not measured")
        return
    rows = [(ev.device_time_total / steps / 1e3, ev.count / steps, ev.key) for ev in kernels]
    busy = sum(ms for ms, _, _ in rows)
    copies = sum(n for _, n, key in rows if "HtoD" in key)
    phase("times", f"{wire} steps of batches 2-4: {busy:.3f} ms device busy a step "
          f"(profiler, {steps} of 3 steps recorded) against {wall_ms:.3f} ms host "
          f"wall: {100 * (1 - busy / wall_ms):.1f}% device idle; {copies:g} H2D "
          "copies a step")
    for ms, n, key in sorted(rows, reverse=True)[:10]:
        phase("times", f"  {wire} step device {ms:.4f} ms ({100 * ms / busy:.1f}%) "
              f"x{n:g} {key[:80]}")

    model = model_after_batch_1(batches)  # the host side of the same steps
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for batch in batches[1:]:
            float(model.step(batch).mse)
    host = sorted(
        ((ev.self_cpu_time_total / 3 / 1e3, ev.count / 3, ev.key)
         for ev in prof.key_averages() if ev.self_cpu_time_total),
        reverse=True,
    )
    total = sum(ms for ms, _, _ in host)
    launches = {key: (n, ms) for ms, n, key in host if key.startswith("cudaLaunch")}
    phase("times", f"{wire} host self time a step (profiler on, so inflated): "
          f"{total:.3f} ms over {sum(n for _, n, _ in host):g} recorded ops; "
          f"launches a step: {sum(n for n, _ in launches.values()):g} ("
          + ", ".join(f"{k} {n:g} in {ms:.4f} ms" for k, (n, ms) in sorted(launches.items()))
          + ")")
    for ms, n, key in host[:8]:
        phase("times", f"  {wire} step host {ms:.4f} ms in {n:g} calls "
              f"({100 * ms / total:.1f}%) {key[:60]}")


def wire_times():
    """Each wire at the operating point: featurize by sub-stage, bytes, the
    H2D copy, the host wall a step, and where its step's time goes. The
    arena serves page-locked buffers, as it does a cuda model's stream, so
    the ragged wire's packed buffer is pinned; the padded wire's arrays are
    pageable."""
    from twtml_tpu_torch.features.arena import get_arena
    from twtml_tpu_torch.features.batch import wire_nbytes

    get_arena().use_device("cuda")
    wires = wire_batches()
    for wire, (batches, times) in wires.items():
        steady = times[1:]  # batch 1 pays first-use set-up
        subs = {k: statistics.median(s[k] for _, s in steady) for k in steady[0][1]}
        phase("times", f"{wire}: featurize batches 2-4 median "
              f"{statistics.median(ms for ms, _ in steady):.2f} ms (all "
              f"{', '.join(f'{ms:.2f}' for ms, _ in times)}); by sub-stage, medians: "
              + ", ".join(f"{k} {v:.2f}" for k, v in subs.items()))
        med, low = h2d_ms(batches[1])
        memory = "pinned" if wire == "ragged" else "pageable"
        phase("times", f"{wire}: wire {wire_nbytes(batches[1])} B a batch ({memory}); "
              f"H2D (batch_to_device, non-blocking, then synchronised) median "
              f"{med:.3f} ms, min {low:.3f} ms over 20 runs")
    walls = step_walls(wires)
    for wire, (batches, _) in wires.items():
        profile_step(wire, batches, walls[wire])


def ptxas_report():
    """Registers, spills and barriers of the kernel, from the ptxas report
    that the build leaves beside the library."""
    import re

    from twtml_tpu_torch.ops import _build

    path = _build.library_path("fused_sgd")
    log = path.with_name(path.name + ".log")
    text = log.read_text() if log.exists() else ""
    block = text[text.find(KERNEL):] if KERNEL in text else ""
    regs = re.search(r"Used (\d+) registers", block)
    spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
    return (
        int(regs.group(1)) if regs else None,
        (int(spills.group(1)), int(spills.group(2))) if spills else None,
    )


def times_phase(smi, max_err, launches):
    import torch

    from twtml_tpu_torch.ops import fused_sgd

    dev = torch.device("cuda")
    x, y, m, w0 = op_point_inputs(dev)
    b, f = x.shape
    kw = dict(num_iterations=OP_ITERS, step_size=0.005)

    # iterations this data runs before the converged freeze, as the kernel
    # counts them, checked by bisection: reruns are bitwise equal, so
    # w(k) == w(N) exactly from the freeze on
    w_full, _ = fused_sgd.fused_dense_sgd(x, y, m, w0, **kw)
    iters = int(fused_sgd.fused_dense_sgd.last_iterations.item())
    lo, hi = 1, OP_ITERS
    while lo < hi:
        mid = (lo + hi) // 2
        w_mid, _ = fused_sgd.fused_dense_sgd(x, y, m, w0, **dict(kw, num_iterations=mid))
        lo, hi = (lo, mid) if torch.equal(w_mid, w_full) else (mid + 1, hi)
    if lo != iters:
        raise AssertionError(f"kernel counts {iters} iterations, bisection {lo}")

    # the kernel alone: the C entry on buffers allocated once, as the
    # wrapper calls it (it writes only its outputs: no reset between runs)
    plan = fused_sgd.launch_plan(b, f, **sm_limits())
    w = torch.empty(f, device=dev)
    preds = torch.empty(b, device=dev)
    spill = torch.empty(plan.spill_elements, dtype=torch.bfloat16, device=dev)
    scratch = torch.empty(plan.scratch_floats, device=dev)

    def args(iterations=OP_ITERS):
        return fused_sgd.kernel_args(plan, x, y, m, w0, w, preds, spill, scratch,
                                     num_iterations=iterations, step_size=0.005,
                                     l2_reg=0.0, convergence_tol=0.001)

    def kernel_only(iterations=OP_ITERS):
        fused_sgd.call_kernel(plan, args(iterations))

    def kernel_times(iterations, runs=25):
        for _ in range(3):  # warm-up
            kernel_only(iterations)
        return timed(lambda: kernel_only(iterations), runs, queue_ahead=True)

    kernel_ms, times = kernel_times(OP_ITERS)
    prologue_ms, _ = kernel_times(0)
    # the same call with the host's set-up and enqueue inside the events
    with_host_ms, _ = timed(kernel_only, 25)
    enqueue, prepare = [], []
    for _ in range(50):  # host time to enqueue one call, and to prepare its arguments
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call = args()
        t1 = time.perf_counter()
        fused_sgd.call_kernel(plan, call)
        enqueue.append((time.perf_counter() - t0) * 1e3)
        prepare.append((t1 - t0) * 1e3)
        torch.cuda.synchronize()
    # the wrapper with its host work counted: allocations, plan, launch
    wrapper_ms, _ = timed(lambda: fused_sgd.fused_dense_sgd(x, y, m, w0, **kw), 25)
    profile_kernel(kernel_only)
    wire_times()
    twin_ms, _ = timed(lambda: fused_sgd.fused_dense_sgd_reference(x, y, m, w0, **kw), 10)

    # each input read once, each output written once: f32 X, y, mask,
    # w0 / preds, w; X·w0 is the first iteration's product too
    io_bytes = b * f * 4 + 4 * b * 2 + 4 * b + 4 * f * 2
    flops = iters * (4 * b * f + 6 * f) if iters else 2 * b * f
    bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    regs, spills = ptxas_report()
    phase("times", f"card: {smi}")
    phase("times", f"operating point B={b} F={f}, {OP_ITERS} iterations "
          f"({iters} run before the converged freeze, kernel count = bisection)")
    phase("times", f"launch plan: grid {plan.grid} CTAs x {fused_sgd.THREADS} threads, "
          f"{plan.rows_cap} rows a CTA at most, {plan.resident} resident / "
          f"{plan.spill_per_cta} spilled a CTA ({plan.resident_rows} / "
          f"{plan.spill_rows} rows), {plan.shared_bytes} B shared memory a CTA, "
          f"{regs} registers a thread, spill stores/loads {spills} B (ptxas)")
    phase("times", f"kernel alone (device time: CUDA events with work queued "
          f"ahead, host enqueue excluded): median {kernel_ms:.4f} ms over 25 "
          f"runs (min {min(times):.4f}, max {max(times):.4f}); prologue alone "
          f"(num_iterations=0: X staged, preds, count, one grid barrier): "
          f"{prologue_ms:.4f} ms; per iteration "
          f"{(kernel_ms - prologue_ms) / max(iters, 1) * 1e3:.2f} us "
          f"((t{OP_ITERS} - t0) / {iters} iterations run)")
    phase("times", "earlier kernel (PR 1, three launches an iteration), quoted "
          "from PERF.md, not measured in this run: 1.929 ms")
    phase("times", f"host enqueue of the kernel's {fused_sgd.launches_per_call(OP_ITERS)} "
          f"launch: median {statistics.median(enqueue):.4f} ms over 50 calls (min "
          f"{min(enqueue):.4f}), of which the Python arguments median "
          f"{statistics.median(prepare):.4f} ms; the "
          f"kernel alone with that enqueue inside the events: median "
          f"{with_host_ms:.4f} ms over 25 runs")
    phase("times", f"wrapper call (host work counted: plan, allocations, launch): "
          f"median {wrapper_ms:.4f} ms over 25 runs")
    phase("times", f"plain twin on the card: median {twin_ms:.4f} ms over 10 runs")
    phase("times", f"bound: bytes {io_bytes} B / 3.35e12 B/s = {bytes_ms:.5f} ms; "
          f"operations {flops} f32 flops / 67e12 flop/s = {ops_ms:.5f} ms; "
          f"bound_ms = {bound_ms:.5f} ({bound_by}); kernel at "
          f"{kernel_ms / bound_ms:.1f}x its bound")
    phase("times", "library_ms: none; no single PyTorch call computes the "
          "50-iteration SGD loop")
    return {
        "name": "fused_dense_sgd",
        "route": "cuda",
        "source": "twtml_tpu_torch/csrc/fused_sgd.cu",
        "replaces": "twtml_tpu/ops/pallas_sgd.py:55",
        "tpu_function": "_sgd_kernel",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "prologue_ms": prologue_ms,
        "wrapper_ms": wrapper_ms,
        "plain_ms": twin_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "iterations_run": iters,
        "grid": plan.grid,
        "shared_bytes": plan.shared_bytes,
        "registers": regs,
    }


def main() -> None:
    global RECORDER
    t_start = time.perf_counter()
    smi = device_phase()
    build_phase()
    max_err = kernel_phase()
    # pins the featurizer's clock and the synthetic tweets' creation times:
    # the wires and backends compared below featurize identical tweets
    os.environ["TWTML_NOW_MS"] = str(NOW_MS)
    RECORDER = Recorder()
    try:
        launches, ragged_rec = main_path_phase()
        padded_phase(ragged_rec)
        replay_phase()
        stream = stream_phase()
        clock_launches = clock_phase()
    finally:
        RECORDER.close()
    record = times_phase(smi, max_err, launches)
    record.update(launches_stream=stream["launches"], launches_clock=clock_launches,
                  stream_tweets_per_s=stream["rate"],
                  stream_device_idle=(stream["timeline"] or {}).get("idle"))
    import torch

    phase("done", f"chip_smoke wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
