#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``twtml_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
  1. device  — the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build   — compile every kernel of the port from ``twtml_tpu_torch/csrc``;
  3. kernel  — the fused dense-SGD kernel against its plain PyTorch twin on
               the card, case by case, at rtol 1e-4 / atol 1e-5 (only the
               summation order differs);
  4. main    — the flagship app (``apps/linear_regression.run``) on cuda for 4
               full-width synthetic batches (16384 tweets, 1000 + 4 dims, 50
               iterations, --modelWatch on), with the kernel's launch counter
               showing the loop went through it and the stats held against
               the same app's model on the CPU;
  5. replay  — the replay fixture on cuda, lines equal to the CPU run's;
  6. times   — kernel, twin and bound at the operating point.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OP_ROWS = 16384  # bench.py's operating point: tweets per batch
OP_ITERS = 50
RTOL, ATOL = 1e-4, 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
NOW_MS = 1_700_000_000_000


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


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

    tweets = list(SyntheticSource(total=OP_ROWS, seed=3, base_ms=NOW_MS))
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

    def case(name, x, y, mask, w0, **kw):
        kw.setdefault("num_iterations", OP_ITERS)
        kw.setdefault("step_size", 0.005)
        w, p = fused_sgd.fused_dense_sgd(x, y, mask, w0, **kw)
        w_ref, p_ref = fused_sgd.fused_dense_sgd_reference(x, y, mask, w0, **kw)
        torch.cuda.synchronize()
        ew, rw = compare(f"{name} weights", w, w_ref)
        ep, rp = compare(f"{name} preds", p, p_ref)
        phase("kernel", f"{name}: B={x.shape[0]} F={x.shape[1]} "
              f"max abs err w {ew:.3e} preds {ep:.3e}; max rel w {rw:.3e} "
              f"preds {rp:.3e}")
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

    x, y, m, w0 = op_point_inputs(dev)
    w_op, p_op = case("operating point", x, y, m, w0)
    w_again, p_again = fused_sgd.fused_dense_sgd(
        x, y, m, w0, num_iterations=OP_ITERS, step_size=0.005
    )
    if not (torch.equal(w_op, w_again) and torch.equal(p_op, p_again)):
        raise AssertionError("operating point: reruns are not bitwise equal")
    phase("kernel", "operating point: rerun bitwise equal")
    torch.cuda.synchronize()
    return max(e for _, e in cases)


# ---- phase 4/5: the main path ----------------------------------------------

def app_run(argv, max_batches=0):
    from twtml_tpu_torch.apps.linear_regression import run
    from twtml_tpu_torch.config import ConfArguments

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        totals = run(ConfArguments().parse(argv), max_batches=max_batches)
    return totals, out.getvalue().splitlines()


def main_path_phase():
    import math

    import torch

    from twtml_tpu_torch.ops import fused_sgd

    argv = ["--source", "synthetic", "--batchBucket", str(OP_ROWS)]
    fused_sgd.fused_dense_sgd.launches = 0
    t0 = time.perf_counter()
    totals, lines = app_run(["--backend", "cuda", *argv], max_batches=4)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = fused_sgd.fused_dense_sgd.launches
    for line, step in zip(lines, totals["steps"]):
        phase("main", f"{line} | featurize {step['featurize_ms']:.1f} ms, "
              f"step {step['step_ms']:.2f} ms (CUDA events)")
    if totals["batches"] != 4 or totals["count"] != 4 * OP_ROWS:
        raise AssertionError(f"main path ran {totals['batches']} batches, "
                             f"{totals['count']} rows")
    if launches != 4:
        raise AssertionError(f"fused_dense_sgd launched {launches} times in 4 batches")
    steady = totals["steps"][1:]  # batch 1 pays first-use set-up
    host_ms = sum(st["featurize_ms"] for st in steady)
    dev_ms = sum(st["step_ms"] for st in steady)
    phase("main", f"app wall {wall_s:.3f} s for {totals['count']} tweets = "
          f"{totals['count'] / wall_s:.0f} tweets/s (synthetic source "
          f"generation, first-use set-up and the stats fetches included)")
    phase("main", f"batches 2-4: featurize {host_ms:.1f} ms + step {dev_ms:.2f} ms"
          f" for {len(steady) * OP_ROWS} tweets = "
          f"{len(steady) * OP_ROWS / (host_ms + dev_ms) * 1e3:.0f} tweets/s "
          f"featurized and trained (bench.py's window: source excluded)")
    per_call = fused_sgd.launches_per_call(OP_ITERS)
    phase("main", f"fused_dense_sgd launches: {launches} calls = "
          f"{launches * per_call} device kernel launches ({per_call} per call)")
    for i, step in enumerate(totals["steps"]):
        values = [step[k] for k in ("count", "mse", "real_stdev", "pred_stdev")]
        values += step["quality"]
        if len(step["quality"]) != 19 or not all(map(math.isfinite, values)):
            raise AssertionError(f"batch {i + 1}: non-finite stats or quality")

    # the same app on the CPU (the twin's path) over the same 4 batches:
    # batch 1 starts from zero weights, so its reported stats must be equal;
    # every unrounded stat agrees within the kernel's 1e-4
    from twtml_tpu_torch.utils.rounding import round_half_up

    cpu_totals, cpu_lines = app_run(["--backend", "cpu", *argv], max_batches=4)
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
    return launches


def replay_phase():
    os.environ["TWTML_NOW_MS"] = str(NOW_MS)
    argv = ["--source", "replay", "--replayFile",
            os.path.join(HERE, "tests", "data", "tweets.jsonl"), "--batchBucket", "4"]
    _, gpu = app_run(["--backend", "cuda", *argv])
    _, cpu = app_run(["--backend", "cpu", *argv])
    for line in gpu:
        phase("replay", line)
    if gpu != cpu or len(gpu) != 3:
        raise AssertionError(f"replay lines differ: cuda {gpu} cpu {cpu}")
    phase("replay", "3 batches, lines identical to the CPU run")


# ---- phase 6: times ---------------------------------------------------------

def timed(fn, runs):
    import torch

    times = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


def profile_kernel(kernel_only, reset, runs=5):
    """Device time per CUDA kernel of the loop, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            reset()
            kernel_only()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        us = ev.device_time_total
        if us and any(k in ev.key for k in ("matvec", "xtr_partial", "update_kernel")):
            rows.append((us / runs, ev.count // runs, ev.key))
    if not rows:
        phase("times", "profiler: no device time recorded; breakdown not measured")
        return
    total = sum(r[0] for r in rows)
    for us, n, key in sorted(rows, reverse=True):
        name = next(k for k in ("matvec", "xtr_partial", "update") if k in key)
        phase("times", f"profile {name}: {us / 1e3:.4f} ms per call in {n} "
              f"launches ({us / n:.2f} us each, {100 * us / total:.1f}% of kernel time)")


def profile_step():
    """Where a main-path step's time goes: batches 2-4 of the app's stream at
    the operating point (SyntheticSource(seed=3), fresh batches, so each
    step's loop runs as the app's does). The host wall of those steps (H2D,
    launches, the stats fetch that ends each) is timed without the profiler;
    a second model on the same batches gives the device time by CUDA kernel
    from torch.profiler. The per-step figures divide by the steps whose
    kernels the profiler recorded, counted by the matvec launches (1 + N a
    step, early-frozen iterations included)."""
    from torch.profiler import ProfilerActivity, profile

    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
    from twtml_tpu_torch.streaming.sources import SyntheticSource

    tweets = list(SyntheticSource(total=4 * OP_ROWS, seed=3, base_ms=NOW_MS))
    featurizer = Featurizer(now_ms=NOW_MS)
    batches = [
        featurizer.featurize_batch_units(tweets[i:i + OP_ROWS], row_bucket=OP_ROWS)
        for i in range(0, 4 * OP_ROWS, OP_ROWS)
    ]

    def model_after_batch_1():
        model = StreamingLinearRegressionWithSGD(device="cuda", quality=True)
        float(model.step(batches[0]).mse)  # also pays first-use set-up
        return model

    model = model_after_batch_1()
    t0 = time.perf_counter()
    for batch in batches[1:]:
        float(model.step(batch).mse)
    wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    model = model_after_batch_1()
    # device activity only: with CPU activity on, the aten ops' events
    # repeat their kernels' device time and the sum counts it twice
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for batch in batches[1:]:
            float(model.step(batch).mse)
    kernels = [ev for ev in prof.key_averages() if ev.device_time_total]
    matvecs = sum(ev.count for ev in kernels if "matvec_kernel" in ev.key)
    steps = matvecs / (1 + OP_ITERS)
    if not steps:
        phase("times", f"step: {wall_ms:.3f} ms host wall; profiler recorded "
              "no kernel of the step, breakdown not measured")
        return
    rows = [(ev.device_time_total / steps / 1e3, ev.key) for ev in kernels]
    busy = sum(ms for ms, _ in rows)
    phase("times", f"steps of batches 2-4: {wall_ms:.3f} ms host wall a step "
          f"(no profiler), {busy:.3f} ms device busy a step (profiler, "
          f"{steps:.2f} of 3 steps recorded): {100 * (1 - busy / wall_ms):.1f}% "
          "device idle")
    for ms, key in sorted(rows, reverse=True)[:10]:
        phase("times", f"  step device {ms:.4f} ms ({100 * ms / busy:.1f}%) {key[:90]}")

    model = model_after_batch_1()  # the host side of the same steps
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for batch in batches[1:]:
            float(model.step(batch).mse)
    host = sorted(
        ((ev.self_cpu_time_total / 3 / 1e3, ev.count // 3, ev.key)
         for ev in prof.key_averages() if ev.self_cpu_time_total),
        reverse=True,
    )
    total = sum(ms for ms, _, _ in host)
    phase("times", f"host self time a step (profiler on, so inflated): "
          f"{total:.3f} ms over {sum(n for _, n, _ in host)} recorded ops")
    for ms, n, key in host[:8]:
        phase("times", f"  step host {ms:.4f} ms in {n} calls ({100 * ms / total:.1f}%) {key[:60]}")


def times_phase(smi, max_err, launches):
    import torch

    from twtml_tpu_torch.ops import fused_sgd

    dev = torch.device("cuda")
    x, y, m, w0 = op_point_inputs(dev)
    b, f = x.shape
    kw = dict(num_iterations=OP_ITERS, step_size=0.005)

    # iterations this data runs before the converged freeze: reruns are
    # bitwise equal, so w(k) == w(N) exactly from the freeze on
    w_full, _ = fused_sgd.fused_dense_sgd(x, y, m, w0, **kw)
    lo, hi = 1, OP_ITERS
    while lo < hi:
        mid = (lo + hi) // 2
        w_mid, _ = fused_sgd.fused_dense_sgd(x, y, m, w0, **dict(kw, num_iterations=mid))
        lo, hi = (lo, mid) if torch.equal(w_mid, w_full) else (mid + 1, hi)
    iters = lo

    # the kernel alone: the C entry on prepared buffers, as the wrapper
    # calls it (setup outside the timed region)
    fpad = fused_sgd.padded_columns(f)
    xb = torch.zeros((b, fpad), dtype=torch.bfloat16, device=dev)
    xb[:, :f] = torch.where(m[:, None] > 0, x, 0.0)
    yb = torch.where(m > 0, y, 0.0)
    count = m.sum().reshape(1)
    w = torch.zeros(fpad, device=dev)
    preds = torch.empty(b, device=dev)
    resid = torch.empty(b, device=dev)
    parts = torch.empty((-(-b // fused_sgd.ROWS_PER_CHUNK), fpad), device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    fn = fused_sgd._library()

    def kernel_only():
        err = fn(xb.data_ptr(), yb.data_ptr(), count.data_ptr(), w.data_ptr(),
                 preds.data_ptr(), resid.data_ptr(), parts.data_ptr(),
                 flag.data_ptr(), b, f, fpad, fused_sgd.ROWS_PER_CHUNK, OP_ITERS,
                 0.005, 0.0, 0.001, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")

    def reset():
        w.zero_()
        w[:f] = w0
        flag.zero_()

    kernel_times = []
    for _ in range(3):  # warm-up
        reset()
        kernel_only()
    for _ in range(25):
        reset()
        kernel_times.append(timed(kernel_only, 1)[0])
    kernel_ms = statistics.median(kernel_times)
    enqueue = []
    for _ in range(10):  # host time to enqueue one call's launches
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kernel_only()
        enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    wrapper_ms, _ = timed(lambda: fused_sgd.fused_dense_sgd(x, y, m, w0, **kw), 25)
    profile_kernel(kernel_only, reset)
    profile_step()
    twin_ms, _ = timed(lambda: fused_sgd.fused_dense_sgd_reference(x, y, m, w0, **kw), 10)

    x_bytes = b * f * 2  # bf16 X, read once
    io_bytes = x_bytes + 4 * b * 2 + 4 * f * 2  # + y, mask / preds, w0 / w
    flops = 2 * b * f + iters * (4 * b * f + 6 * f)
    bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    restream_ms = (1 + 2 * iters) * x_bytes / HBM_BYTES_PER_S * 1e3
    phase("times", f"card: {smi}")
    phase("times", f"operating point B={b} F={f}, {OP_ITERS} iterations "
          f"({iters} run before the converged freeze)")
    phase("times", f"kernel alone: median {kernel_ms:.4f} ms over 25 runs "
          f"(min {min(kernel_times):.4f}, max {max(kernel_times):.4f})")
    phase("times", f"host enqueue of the kernel's {fused_sgd.launches_per_call(OP_ITERS)} "
          f"launches: median {statistics.median(enqueue):.4f} ms over 10 calls")
    phase("times", f"wrapper call (mask, bf16 pad, then the kernel): median "
          f"{wrapper_ms:.4f} ms over 25 runs")
    phase("times", f"plain twin on the card: median {twin_ms:.4f} ms over 10 runs")
    phase("times", f"bound: bytes {io_bytes} B / 3.35e12 B/s = {bytes_ms:.5f} ms; "
          f"operations {flops} f32 flops / 67e12 flop/s = {ops_ms:.5f} ms; "
          f"bound_ms = {bound_ms:.5f} ({bound_by})")
    phase("times", f"design floor if X streamed from device memory for each of "
          f"its {1 + 2 * iters} passes: {(1 + 2 * iters)} x {x_bytes} B / 3.35e12 "
          f"= {restream_ms:.4f} ms; the kernel is held to bound_ms")
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
        "wrapper_ms": wrapper_ms,
        "plain_ms": twin_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "iterations_run": iters,
    }


def main() -> None:
    smi = device_phase()
    build_phase()
    max_err = kernel_phase()
    launches = main_path_phase()
    replay_phase()
    record = times_phase(smi, max_err, launches)
    import torch

    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
