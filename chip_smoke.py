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
               the operating point (spill path); and a valid row holding a
               NaN label, then an Inf feature: the twin's non-finite
               pattern in w and preds, every iteration run; then the
               kernel's logistic residual mode (r = σ(x·w) − y, 0/1 labels)
               at the same shapes: the narrow pass, count 0, a ragged last
               CTA with rows spilled, the tiled wide pass (NaN/Inf in masked
               rows bitwise ignored) and the operating point;
 3b. kernel  — the sparse regime's Gram route (``ops/fused_gram.py``) at
               F = 2^18 against its plain twins on the card: B4's counts and
               the G product bitwise at a row mass of 127 (int8 counts,
               ``torch._int_mm``), 128 and 255 (f32 counts), fractional
               values within rtol 1e-6; B7 (the dual loop, one cooperative
               launch) at B = 1, 16, 2048, 3072 and 4096 (G spilled to L2),
               count 0, the logistic mode, ``-b 0.5`` masks, tolerance 0 and
               0.001 with the twin's iterations run, NaN/Inf in masked rows
               bitwise ignored, within rtol 1e-4 / atol 1e-5; B8 (the
               write-back) within rtol 2e-4 of its twin and of the
               per-occurrence scatter; each rerun bitwise equal;
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
  8. guards  — the runtime guards at the stream's width and depth, from a
               pre-filled source, every dispatch under the sync-debug mode
               "error": a poisoned batch (``--chaos source.nan@5``) with a
               checkpoint every batch rolls back once, replays its rows from
               the journal, loses none, fetches once a dispatch, and ends
               bitwise equal to the clean run; the same at batch 7 with a
               checkpoint every 4 and batch 7 held in flight on the card
               (``torch.cuda._sleep``), so later batches drain as tainted
               skips; without a checkpoint the weights go back to zeros;
               4 + 4 resumed batches equal 8; a rollback storm aborts and
               leaves a flight-recorder bundle naming the last checkpoint;
               ``--recycleAfterMb 1`` in a subprocess re-execs and resumes
               exactly; the guards on against off: the same device work a
               step (profiler), both rates, and the save, journal append,
               rollback and dump times. Every checkpointed run has the
               telemetry historian on (``--history auto``, the JAX
               defaults): a ``--history off`` arm prints the same lines and
               ends with bitwise-equal weights, the profiled history-on run
               makes the same D2H copies and launches a step as the off run;
               the ms a ``sample()`` takes and the segment bytes a batch;
  9. sampled — ``-b 0.5``: the [50, 16384] Bernoulli masks made on the card
               bitwise equal to the CPU's (float32 and float64 draws); 4
               full-width batches on the torch loop under the sync-debug
               mode "error", against the ``--backend cpu`` twin (weights
               and stats within 1e-4), the fused kernel launched 0 times;
               the mask draw's and a step's device ms and launches;
 10. dtype   — ``--dtype bfloat16``: 4 full-width batches on the card, MSE
               falling, finite, within 2**-5 of the CPU twin, a step's
               device ms and launches; ``--dtype float64 --backend cuda``
               exits (CPU only, as in the JAX package) before building;
 11. clock   — ``--seconds 1`` on the default wire (padded), the synthetic
               source paced at 20000 tweets/s, 5 intervals: every interval's
               batch trains, the warm-up ends before the stream starts, the
               stats posts arrive; each tick's lateness and rows;
 12. web     — the port's dashboard server as a process of its own
               (``python -m twtml_tpu_torch.web.main -nocache``, a loopback
               PORT, a temporary TMPDIR): a websocket client (web/websocket.py)
               gets the Config push; 8 full-width batches of the stream
               phase's tweets on the card publish to it (Lightning stays at
               the recorder): each batch's Stats frame equals its printed
               line, GET /api/stats equals the last, GET / serves the port's
               index.html; publish ms a batch against the stream phase's,
               the POST latency (p50, p99) and the largest frame; SIGTERM
               stops it;
 13. live    — ``--source twitter`` with the OAuth credentials from an
               ``application.conf`` named by TWTML_CONFIG and
               ``twitter4j.streamBaseURL`` at a loopback chunked stream that
               checks every request's signature and serves the main phase's
               synthetic tweets: 4 full-width batches back to back, each line
               equal to the same tweets' from a pre-filled source on the
               card; the app's and the source's own tweets/s;
 14. hosthash — ``--hashOn host --wire padded --profileDir``: the main
               phase's 4 batches hashed on the host (native/fasthash.cpp),
               weights, predictions, stats and quality bitwise equal to the
               padded phase's, the fused kernel launched as there; the
               Chrome trace names the kernel and the app's annotated
               regions; host-hash featurize against the device-hash wire's,
               the profiled run's wall against an unprofiled run's;
 15. logistic — ``apps/logistic_regression.py`` on the card: 4 full-width
               batches of two-class tweets (a lexicon word drawn onto each
               original) from a pre-filled source under the sync-debug
               mode, B1 in its logistic mode 4 + 1 times, against the
               ``--backend cpu`` twin: weights and stats within 1e-4,
               predictions equal except rows whose margin is within 1e-4 of
               0 (counted); the labels' positive share;
 16. superbatch — ``--superBatch 8`` on the group wire (one packed buffer
               a group) and the stacked wire, and ``--superBatch 1``, every
               dispatch under the sync-debug mode, all three bitwise equal
               (weights, predictions, stats, quality, lines): over the
               stream phase's 8 batches (their ragged units buckets decide
               which group), then over 8 batches of one bucket fed twice, so
               the second group replays the CUDA graph the first captured;
               each arm's launches and H2D/D2H copies a dispatch (a
               ``--profileDir`` trace), host wall a batch, tweets/s;
 17. kmeans  — ``apps/kmeans.py`` on the card: the (3, 2) random centers
               bitwise the CPU's draw; 4 batches of 16384 retweets from a
               pre-filled source against the ``--backend cpu`` twin:
               assignments and sizes equal, centers and weights within
               1e-5;
 18. sparse  — BASELINE config #4 through the app: ``--numTextFeatures
               262144 --l2Reg 0.1 --batchBucket 2048``, 4 back-to-back
               batches on the ragged packed wire at depth 8 under the
               sync-debug mode, B4, B7 and B8 launched 4 + 1 times each and B1
               never, weights, stats and predictions (but HALF_UP flips) held
               against the card's scatter route and the ``--backend cpu``
               twin; one batch at B = 16384 (over the gate: the scatter loop)
               against its CPU twin; whether the card's scatter loop reruns
               bitwise; where a Gram step's time goes (gather predict, B4, the
               G product, B7, B8, quality; device busy, idle, launches);
 19. times   — at the operating point: the launch plan (grid, rows resident
               and spilled, shared memory, registers from ptxas), kernel,
               prologue and per-iteration times, the twin, the bound; each
               wire's featurize by sub-stage, bytes and H2D copy; and where
               a step's time goes on each wire; the logistic mode's kernel
               time (50 iterations), twin and bound; B4, the G product, B7
               and B8 at config #4's operating point (B = 2048, F = 2^18),
               with ``torch.bincount`` as B4's library call; B4's f32 build
               on tweet-length rows (L = 511): (a) on their tokens, (b)
               with every index out of range, (c) ``torch.bincount``, the
               counts bitwise the CPU twin's and a rerun's;
 20. serve   — the serving plane: a verified checkpoint (stamped ok) of the
               main phase's weights served by ``apps/serve.run`` on the card
               (the dashboard server on a loopback port); 2,000 requests of
               1-16 of the stream phase's tweets from 16 ``ServingClient``
               threads, every dispatch under the sync-debug mode "error":
               every answer bitwise equal to the card's train-step
               pre-update predictions of its rows (computed 256 rows at a
               time in another composition) under the snapshot step it
               names, across a second checkpoint written mid-load (the
               promoter's hot swap: both steps served, none torn); against
               the ``--backend cpu`` predict engine rounded predictions
               equal but HALF_UP flips of a raw margin within 2e-3 of a half
               (counted) and raw margins within 2e-3; B1 launched once a
               served batch plus the warm-up, each its predict kernel
               (N = 0: 0 iterations, the served weights bitwise the
               snapshot's); 0 client errors. Two ``python -m
               twtml_tpu_torch.apps.serve`` processes on the card behind
               ``apps/router.run``, under ``p99`` and under ``hash``, one
               of them killed halfway through the second load: 0 client
               errors, every answer bitwise the train step's, the kill
               counted as an ejection. A 262,148-weight snapshot (config
               #4) served on the gather predict, against the CPU twin, B1
               launched 0 times. Latency p50/p99, QPS and batch fill; one
               serve step's device ms, launches and host wall; B1's
               predict kernel at B = 256 and 16384 bitwise the N = 1
               launch's first-pass predictions, and at F = 2000 and 8196
               (the wide order), NaN/Inf in masked rows bitwise ignored,
               an all-padding batch predicting zeros; its device time
               against its twin, ``torch.mv`` and its bound.
No app run publishes anywhere but the loopback recorder and, in the web
and serve phases, the port's own servers on loopback ports. The line before
the last is the kernels' JSON record (B1's least-squares and logistic
modes, its predict kernel, B4 with its f32 build on tweet-length rows, B7
and B8); the last line is ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --times-only [--package-root DIR]`` runs phases 1
and 2 and then only the kernels' device times (B1's logistic mode, its
predict kernel, B4 in both planes, the G product, B7, B8), importing the port from
DIR (another checkout unpacked there), so that two versions can be timed
in turns in one call; its last line is that JSON.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import math
import os
import statistics
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGE_ROOT = HERE  # where twtml_tpu_torch is imported from (``--package-root``)
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
    sys.path.insert(0, PACKAGE_ROOT)
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
        mode = fused_sgd.residual_mode(kw.get("residual_fn"))
        phase("kernel", f"{name}: B={x.shape[0]} F={x.shape[1]} grid {plan.grid}, "
              f"{plan.resident_rows} rows resident, {plan.spill_rows} spilled; "
              f"residual mode {mode}, {int(fused_sgd.fused_dense_sgd.last_iterations.item())} "
              f"iterations run; max abs err w {ew:.3e} preds {ep:.3e}; max rel w {rw:.3e} "
              f"preds {rp:.3e}; {note}")
        cases.append((name, max(ew, ep), mode))
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

    # non-finite data in a VALID row must propagate as in the twin (the
    # divergence sentinel sees it in the stats): a NaN label, and an Inf
    # numeric feature; the converged freeze must not hold on NaN
    x, y, m = design(rng, 256, 1004, 200)
    valid = np.flatnonzero(m > 0)
    w0 = small_w0(1004)
    y_nan = y.copy()
    y_nan[valid[3]] = np.nan
    nonfinite_case("NaN label in a valid row", to(x), to(y_nan), to(m), w0)
    x_inf = x.copy()
    x_inf[valid[5], -2] = np.inf
    nonfinite_case("Inf feature in a valid row", to(x_inf), to(y), to(m), w0)

    x, y, m, w0 = op_point_inputs(dev)
    case("operating point (spill path)", x, y, m, w0)

    # the logistic residual mode, r = σ(x·w) − y, at the same shapes, with
    # 0/1 labels: the narrow pass, count 0, rows spilled to L2 and the
    # tiled wide pass, each with NaN/Inf in its masked rows (σ(0) − 0 = 0.5
    # times a zeroed row adds nothing), and the operating point
    logistic = dict(residual_fn=fused_sgd.logistic_residual, step_size=0.1)
    binary = lambda n: to((rng.random(n) < 0.5).astype("float32"))  # noqa: E731
    x_, _, m_ = design(rng, 1001, 1004, 1001)
    case("logistic ragged (narrow pass)", to(x_), binary(1001), to(m_), small_w0(1004),
         **logistic)
    x_, _, m_ = design(rng, 64, 1004, 0)
    w0_ = to(rng.normal(size=1004).astype("float32"))
    w_, p_ = case("logistic count=0", to(x_), binary(64), to(m_), w0_, **logistic)
    if not torch.equal(w_, w0_) or not torch.equal(p_, torch.zeros_like(p_)):
        raise AssertionError("logistic count=0: weights must be unchanged, preds 0")
    x_, _, m_ = design(rng, 16381, 1004, 16000)
    case("logistic ragged last CTA (spill path)", to(x_), binary(16381), to(m_),
         small_w0(1004), dirty=True, **logistic)
    x_, _, m_ = design(rng, 4096, 8196, 4000)
    case("logistic wide F (tiled + spill path)", to(x_), binary(4096), to(m_),
         small_w0(8196), dirty=True, **logistic)
    del x_, m_
    case("logistic operating point (spill path)", x, op_point_labels(dev), m, w0,
         dirty=True, **logistic)
    torch.cuda.synchronize()
    return ({mode: max(e for _, e, md in cases if md == mode) for mode in (0, 1)},
            [name for name, _, _ in cases] + NONFINITE_CASES)


def op_point_labels(device):
    """0/1 labels of the operating point for the logistic mode, drawn from
    a fixed seed (the synthetic tweets' sentiment is all 1)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(8)
    return torch.from_numpy((rng.random(OP_ROWS) < 0.6).astype("float32")).to(device)


NONFINITE_CASES: list = []


def nonfinite_case(name, x, y, mask, w0, **kw):
    """A valid row holding NaN or Inf: the kernel's w and preds have the
    twin's non-finite pattern (NaN, +Inf and -Inf at the same elements),
    agree with it on the finite ones, rerun bitwise equal, and run every
    iteration (no freeze on NaN)."""
    import torch

    from twtml_tpu_torch.ops import fused_sgd

    kw.setdefault("num_iterations", OP_ITERS)
    kw.setdefault("step_size", 0.005)
    w, p = fused_sgd.fused_dense_sgd(x, y, mask, w0, **kw)
    iters = int(fused_sgd.fused_dense_sgd.last_iterations.item())
    w_ref, p_ref = fused_sgd.fused_dense_sgd_reference(x, y, mask, w0, **kw)
    w_again, p_again = fused_sgd.fused_dense_sgd(x, y, mask, w0, **kw)
    torch.cuda.synchronize()
    for what, got, want in (("weights", w, w_ref), ("preds", p, p_ref)):
        for test in (torch.isnan, torch.isposinf, torch.isneginf):
            if not torch.equal(test(got), test(want)):
                raise AssertionError(f"{name} {what}: {test.__name__} pattern differs: "
                                     f"kernel {int(test(got).sum())}, twin "
                                     f"{int(test(want).sum())}")
        fin = torch.isfinite(want)
        if fin.any():
            compare(f"{name} {what} (finite)", got[fin], want[fin])
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    if not (torch.equal(bits(w), bits(w_again)) and torch.equal(bits(p), bits(p_again))):
        raise AssertionError(f"{name}: reruns are not bitwise equal")
    if iters != kw["num_iterations"]:
        raise AssertionError(f"{name}: the kernel froze after {iters} iterations")
    phase("kernel", f"{name}: weights {int(torch.isnan(w).sum())}/{w.numel()} NaN, preds "
          f"{int((~torch.isfinite(p)).sum())}/{p.numel()} non-finite, as the twin's; "
          f"finite elements within rtol {RTOL} atol {ATOL}; rerun bitwise equal; "
          f"{iters} iterations run (no freeze on NaN)")
    NONFINITE_CASES.append(name)


def sm_limits():
    """The launch plan's card arguments for device 0."""
    from twtml_tpu_torch.ops import fused_sgd

    sm_count, shared_limit = fused_sgd.device_limits(0)
    return {"sm_count": sm_count, "shared_limit": shared_limit}


# ---- phase 3b: the Gram route's kernels against their twins --------------

GRAM_F = 2**18  # BASELINE config #4's HashingTF width
GRAM_ROWS = 2048  # its operating point (tools/bench_suite.py)
# weights against the scatter route and the CPU twin: the JAX package's own
# Gram-vs-scatter tolerance (tests/test_gram_sgd.py), scaled by max(1, max|w|)
WEIGHT_RTOL = 2e-4
GRAM_EXACT_RTOL = 1e-6  # the exact plane's G (f32 products in another order)


def gram_tokens(rng, rows, peak, fractional=False, terms=40, tokens=48):
    """[rows, tokens] (idx int32, val f32) pairs at F = 2^18: ``terms``
    tweet-like tokens of value 1 or 2 a row, the rest padding (idx 0, val
    0); row 0's first two tokens are feature 7 with values summing to
    ``peak`` (its absolute mass is ``peak`` plus its other terms' unless
    ``peak`` rules it), and row 1 holds feature 7 once (G[0, 1] witnesses a
    count that wrapped). ``fractional`` scales every value by 0.37."""
    import numpy as np

    idx = np.zeros((rows, tokens), np.int32)
    val = np.zeros((rows, tokens), np.float32)
    idx[:, :terms] = rng.integers(0, GRAM_F, size=(rows, terms))
    val[:, :terms] = rng.integers(1, 3, size=(rows, terms))
    if peak:
        idx[0, :] = 0
        val[0, :] = 0.0
        idx[0, :2] = 7
        val[0, :2] = (peak - peak // 2, peak // 2)
        idx[1, 0], val[1, 0] = 7, 1.0
    if fractional:
        val *= 0.37
    return idx, val


def gram_kernel_phase():
    """B4 and the G product, B7 and B8 on the card against their plain
    twins, each rerun bitwise equal. B4 + G: bitwise at a row mass of 127
    (the int8 plane: s8 counts, ``torch._int_mm``), 128 and 255 (f32 counts,
    an f32 matmul), fractional values within GRAM_EXACT_RTOL. B7: B = 1, 16,
    2048, 3072 and 4096 (G spilled to L2), count 0, the logistic mode, ``-b
    0.5`` masks, tolerance 0 and 0.001 with the same iterations run, NaN/Inf
    in masked rows bitwise ignored; within RTOL/ATOL. B8: within WEIGHT_RTOL
    of the scatter write-back and of its twin."""
    import numpy as np
    import torch

    from twtml_tpu_torch.models.sgd import sampling_masks
    from twtml_tpu_torch.ops import fused_gram, gram
    from twtml_tpu_torch.ops.fused_sgd import logistic_residual

    dev = torch.device("cuda")
    rng = np.random.default_rng(2026)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    errs = {"count_build": 0.0, "dual_sgd": 0.0, "dual_writeback_counts": 0.0}
    cases = []
    counts_int8 = None
    for name, peak, fractional in (("row mass 127", 127, False), ("row mass 128", 128, False),
                                   ("row mass 255", 255, False), ("fractional", 0, True)):
        idx, val = gram_tokens(rng, GRAM_ROWS, peak, fractional)
        idx_t, val_t = to(idx), to(val)
        plane = gram.data_plane(val_t)
        int8 = plane == gram.PLANE_INT8
        c = fused_gram.count_build(idx_t, val_t, GRAM_F, int8=int8)
        again = fused_gram.count_build(idx_t, val_t, GRAM_F, int8=int8)
        ref = fused_gram.count_build_reference(idx_t, val_t, GRAM_F, int8=int8,
                                               rows_out=c.shape[0], cols_out=c.shape[1])
        g = fused_gram.gram_from_counts(c)[:GRAM_ROWS, :GRAM_ROWS]
        g_ref = gram.text_gram(idx_t, val_t, GRAM_F, plane=plane)
        torch.cuda.synchronize()
        if not torch.equal(c, again):
            raise AssertionError(f"count_build {name}: reruns are not bitwise equal")
        counts_bitwise = torch.equal(c, ref)
        if plane == gram.PLANE_EXACT:
            err = (c.float() - ref.float()).abs().max().item()
            if err > GRAM_EXACT_RTOL * ref.float().abs().max().item():
                raise AssertionError(f"count_build {name}: counts differ by {err:.3e}")
            g_err = ((g - g_ref).abs() / g_ref.abs().clamp(min=1e-30)).max().item()
            if not g_err <= GRAM_EXACT_RTOL:
                raise AssertionError(f"G {name}: relative error {g_err:.3e} > "
                                     f"{GRAM_EXACT_RTOL}")
            errs["count_build"] = max(errs["count_build"], err)
        else:
            if not counts_bitwise:
                raise AssertionError(f"count_build {name}: counts differ from the twin")
            if not torch.equal(g, g_ref):
                raise AssertionError(f"G {name} ({gram.PLANE_NAMES[plane]} plane): differs "
                                     f"from the exact product by "
                                     f"{(g - g_ref).abs().max().item():.3e}")
            g_err = 0.0
        if peak and float(g[0, 1]) != float(peak):
            raise AssertionError(f"G {name}: G[0, 1] = {float(g[0, 1])}, want {peak}")
        if int8 and counts_int8 is None:
            counts_int8 = (idx_t, val_t, c)
        phase("kernel", f"count_build + G {name}: B={GRAM_ROWS} F={GRAM_F} L={idx.shape[1]}, "
              f"{gram.PLANE_NAMES[plane]} plane ({c.dtype} counts {tuple(c.shape)}); counts "
              f"{'bitwise equal to' if counts_bitwise else 'within rtol 1e-6 of'} the twin, G "
              f"{'bitwise equal to' if g_err == 0 else f'within {g_err:.2e} of'} the exact "
              f"product; rerun bitwise equal")
        cases.append(f"count_build + G {name}")
        del c, again, ref, g, g_ref

    # ---- B7: the dual loop
    def dual_inputs(rows, n_valid, terms=40, cols=4096):
        z = np.zeros((rows, cols), np.float32)
        np.add.at(z, (np.arange(rows)[:, None], rng.integers(0, cols, size=(rows, terms))),
                  1.0)
        num = (rng.normal(size=(rows, 4)) * 0.1).astype(np.float32)
        zt, nt = to(z), to(num)
        g = zt @ zt.T + nt @ nt.T
        u = to((rng.normal(size=rows) * 10).astype(np.float32))
        y = to(rng.uniform(50, 900, size=rows).astype(np.float32))
        mask = to((rng.permutation(rows) < n_valid).astype(np.float32))
        return g, u, y, mask

    def dual_case(name, g, u, y, mask, dirty=False, **kw):
        kw = dict(dict(num_iterations=OP_ITERS, step_size=0.005, l2_reg=0.1,
                       convergence_tol=0.001, p_prev=torch.tensor(3.0, device=dev)), **kw)
        c, a, its = fused_gram.dual_sgd(g, u, y, mask, **kw)
        c2, a2, its2 = fused_gram.dual_sgd(g, u, y, mask, **kw)
        c_r, a_r, its_r = fused_gram.dual_sgd_reference(g, u, y, mask, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(a, a2) and torch.equal(c, c2) and int(its) == int(its2)):
            raise AssertionError(f"dual_sgd {name}: reruns are not bitwise equal")
        if int(its) != int(its_r):
            raise AssertionError(f"dual_sgd {name}: {int(its)} iterations run, the twin "
                                 f"{int(its_r)}")
        ea, ra = compare(f"dual_sgd {name} alpha", a, a_r)
        ec, _ = compare(f"dual_sgd {name} c", c.reshape(1), c_r.reshape(1))
        note = "rerun bitwise equal"
        if dirty:
            keep = mask > 0
            both = keep[:, None] & keep[None, :]
            b = mask.shape[0]
            g_d = g.clone()
            g_d[:b, :b] = torch.where(both, g[:b, :b], float("nan"))
            u_d = torch.where(keep, u, float("nan"))
            y_d = torch.where(keep, y, float("inf"))
            c_d, a_d, its_d = fused_gram.dual_sgd(g_d, u_d, y_d, mask, **kw)
            if not (torch.equal(a, a_d) and torch.equal(c, c_d) and int(its) == int(its_d)):
                raise AssertionError(f"dual_sgd {name}: NaN/Inf in masked rows reached "
                                     "the result")
            note += f"; NaN/Inf in {int((~keep).sum())} masked rows: bitwise equal"
        plan = fused_gram.dual_plan(mask.shape[0], **sm_limits())
        phase("kernel", f"dual_sgd {name}: B={mask.shape[0]} grid {plan.grid}, "
              f"{plan.resident_rows} rows of G resident, {plan.spill_rows} spilled; "
              f"{int(its)} iterations run (twin {int(its_r)}); max abs err alpha {ea:.3e} "
              f"(rel {ra:.3e}) c {ec:.3e}; {note}")
        errs["dual_sgd"] = max(errs["dual_sgd"], ea, ec)
        cases.append(f"dual_sgd {name}")
        return c, a, its

    dual_case("B=1", *dual_inputs(1, 1))
    dual_case("B=16", *dual_inputs(16, 12), dirty=True)
    g, u, y, m = dual_inputs(GRAM_ROWS, GRAM_ROWS - 100)
    dual_case("B=2048 tol 0.001", g, u, y, m, dirty=True)
    # labels near the margins: the loop freezes early at tolerance 0.001
    near = u + to((rng.normal(size=GRAM_ROWS) * 10).astype(np.float32))
    _, _, its = dual_case("B=2048 tol 0.001 (freezes)", g, u, near, m, dirty=True)
    if not 1 < int(its) < OP_ITERS:
        raise AssertionError(f"dual_sgd freeze case: {int(its)} iterations run")
    _, _, its = dual_case("B=2048 tol 0", g, u, y, m, convergence_tol=0.0)
    if int(its) != OP_ITERS:
        raise AssertionError(f"dual_sgd tol 0: {int(its)} iterations run")
    masks = sampling_masks(GRAM_ROWS, OP_ITERS, 0.5, torch.float32, dev)
    dual_case("B=2048 -b 0.5 masks", g, u, y, m, masks=masks, dirty=True)
    dual_case("B=2048 logistic", g, u, (y > 475).float(), m, step_size=0.1,
              residual_fn=logistic_residual, dirty=True)
    c0, a0, _ = dual_case("count=0", g, u, y, torch.zeros_like(m))
    if float(c0) != 1.0 or a0.any():
        raise AssertionError("dual_sgd count=0: c must stay 1 and alpha 0")
    del g
    dual_case("B=3072 (G spilled)", *dual_inputs(3072, 3000), dirty=True)
    dual_case("B=4096 (G spilled)", *dual_inputs(4096, 4000), dirty=True)

    # ---- B8: the write-back, from the int8 case's counts and f32 counts
    from twtml_tpu_torch.ops.gram import dual_writeback

    idx_t, val_t, c8 = counts_int8
    for name, counts, vals in (("int8 counts", c8, val_t),
                               ("f32 counts", None, val_t * 0.37)):
        if counts is None:
            counts = fused_gram.count_build(idx_t, vals, GRAM_F, int8=False)
        w = to((rng.normal(size=GRAM_F + 4) * 1e-2).astype(np.float32))
        alpha = to((rng.normal(size=GRAM_ROWS) * 1e-3).astype(np.float32))
        num = to((rng.normal(size=(GRAM_ROWS, 4)) * 0.1).astype(np.float32))
        c = torch.tensor(0.97, device=dev)
        got = fused_gram.dual_writeback_counts(w, c, alpha, counts, num, GRAM_F)
        again = fused_gram.dual_writeback_counts(w, c, alpha, counts, num, GRAM_F)
        twin = fused_gram.dual_writeback_reference(w, c, alpha, counts, num, GRAM_F)
        text, numw = dual_writeback(w[:GRAM_F], w[GRAM_F:], c, alpha, idx_t, vals, num)
        scatter = torch.cat([text, numw])
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"dual_writeback_counts {name}: reruns are not bitwise equal")
        worst = 0.0
        for what, want in (("twin", twin), ("scatter write-back", scatter)):
            err = (got - want).abs()
            atol = WEIGHT_RTOL * max(1.0, want.abs().max().item())
            if (err > atol + WEIGHT_RTOL * want.abs()).any() or not torch.isfinite(got).all():
                raise AssertionError(f"dual_writeback_counts {name}: {what} differs by "
                                     f"{err.max().item():.3e}")
            worst = max(worst, err.max().item())
        errs["dual_writeback_counts"] = max(errs["dual_writeback_counts"], worst)
        phase("kernel", f"dual_writeback_counts {name}: B={GRAM_ROWS} F={GRAM_F}; max abs "
              f"err {worst:.3e} against its twin and the per-occurrence scatter "
              f"(tolerance rtol {WEIGHT_RTOL}, atol {WEIGHT_RTOL}*max(1, max|w|)); rerun "
              "bitwise equal")
        cases.append(f"dual_writeback_counts {name}")
    torch.cuda.synchronize()
    return errs, cases


# ---- phase 4/5/6: the main path on each wire --------------------------------

def app_run(argv, max_batches=0, app_module=None, **kw):
    """One run of an app (``app_module``, the flagship linear app when None)
    with ``argv``, publishing to the loopback recorder only; returns its
    totals and printed lines."""
    from twtml_tpu_torch.apps import linear_regression
    from twtml_tpu_torch.config import ConfArguments

    out = io.StringIO()
    conf = ConfArguments().parse(
        ["--lightning", RECORDER.url, "--twtweb", RECORDER.url, *argv])
    with contextlib.redirect_stdout(out):
        totals = (app_module or linear_regression).run(conf, max_batches=max_batches, **kw)
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


def recorded_app_run(argv, max_batches, source=None, blocking_copies=False,
                     sleep_before=None, expected_errors=(), expect_abort=False,
                     app_module=None, learner=None, **kw):
    """One app run with the kernels' launch counters (B1's, and B4's, B7's
    and B8's in ``rec["gram_launches"]``) and the native counters set to 0
    just before it and read just after, recording what the run's
    model returned: the warm-up's output, each batch's StepOutput (device
    tensors), the iterations each fused call ran (device scalars, no sync),
    the host fetches started (``fetch_output`` calls, the warm-up's
    excluded), the weights each ``set_initial_weights`` installed and the
    final weights. ``source`` replaces the configured source;
    ``blocking_copies`` makes every H2D copy synchronous; ``rec["planes"]``
    holds each ``step``'s Gram plane (``model.planes``); ``sleep_before``
    {step: cycles} queues ``torch.cuda._sleep`` on the model's stream ahead
    of that step (step 1 is the first batch after the warm-up), so that
    later batches dispatch while it is still in flight. A run that logged an
    error fails, unless the message starts with one of ``expected_errors``
    (a guard's own report of what it caught). With ``expect_abort`` the
    run must raise its guard abort: totals and lines are then None and []
    and ``rec["aborted"]`` holds the message. ``app_module`` and ``learner``
    (the flagship app and its linear learner when None) pick another SGD
    app; ``rec["raw"]`` holds each fused call's raw margins (device
    tensors); ``rec["groups"]`` the step_many calls; ``rec["captured"]``
    the CUDA graphs the model captured."""
    import torch

    from twtml_tpu_torch.apps import common
    from twtml_tpu_torch.apps import linear_regression as app
    from twtml_tpu_torch.features import native
    from twtml_tpu_torch.models import sgd as sgd_module
    from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
    from twtml_tpu_torch.ops import fused_gram, fused_sgd

    rec = {"outputs": [], "iterations": [], "fetches": 0, "restored": [], "raw": [],
           "groups": 0, "planes": []}
    base_build, base_source = app.build_model, app.build_source
    base_cls = learner or StreamingLinearRegressionWithSGD

    class Recorded(base_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.non_blocking = not blocking_copies

        def step(self, batch):
            cycles = (sleep_before or {}).get(len(rec["outputs"]))
            if cycles:
                torch.cuda._sleep(cycles)
            out = super().step(batch)
            rec["outputs"].append(out)
            rec["planes"].append(self.planes(batch))
            rec["model"] = self
            return out

        def step_many(self, stacked):
            out = super().step_many(stacked)
            rec["groups"] += 1
            rec["outputs"].extend(
                type(out)(*(None if f is None else f[i] for f in out))
                for i in range(out.count.shape[0]))
            rec["model"] = self
            return out

        def fetch_output(self, out):
            rec["fetches"] += 1
            return StreamingLinearRegressionWithSGD.fetch_output(out)

        def set_initial_weights(self, weights):
            super().set_initial_weights(weights)
            rec["restored"].append(self._weights)
            return self

    def fused(*args, **kw):
        out = fused_sgd.fused_dense_sgd(*args, **kw)
        rec["iterations"].append(fused_sgd.fused_dense_sgd.last_iterations)
        rec["raw"].append(out[1])
        return out

    app.build_model = lambda conf, *_: common.build_model(conf, model_cls=Recorded)
    sgd_module.fused_dense_sgd = fused
    if source is not None:
        app.build_source = lambda conf: source
    errors = ErrorLog()
    logging.getLogger("twtml_tpu_torch").addHandler(errors)
    try:
        fused_sgd.fused_dense_sgd.launches = 0
        for fn in fused_gram.KERNELS:
            fn.launches = 0
        native.reset_counters()
        t0 = time.perf_counter()
        try:
            totals, lines = app_run(argv, max_batches=max_batches, app_module=app_module,
                                    **kw)
        except RuntimeError as exc:
            if not expect_abort or "runtime guard" not in str(exc):
                raise
            totals, lines, rec["aborted"] = None, [], str(exc)
        else:
            if expect_abort:
                raise AssertionError("the run did not abort")
        torch.cuda.synchronize()
        rec["wall_s"] = time.perf_counter() - t0
        rec["launches"] = fused_sgd.fused_dense_sgd.launches
        rec["gram_launches"] = {fn.__name__: fn.launches for fn in fused_gram.KERNELS}
        rec["native"] = dict(native.COUNTERS)
    finally:
        logging.getLogger("twtml_tpu_torch").removeHandler(errors)
        app.build_model, app.build_source = base_build, base_source
        sgd_module.fused_dense_sgd = fused_sgd.fused_dense_sgd
    unexpected = [r for r in errors.records
                  if not r.getMessage().startswith(tuple(expected_errors) or ("\0",))]
    if unexpected:
        raise AssertionError("the run logged errors: " + "; ".join(
            f"{r.getMessage()} {r.exc_text or ''}" for r in unexpected))
    # the first step is the pre-stream warm-up's all-padding batch
    rec["warmup"], rec["outputs"] = rec["outputs"][0], rec["outputs"][1:]
    rec["planes"] = rec["planes"][1:]  # each step's Gram plane (() off the Gram route)
    rec["iterations"] = rec["iterations"][1:]
    rec["raw"] = rec["raw"][1:]
    rec["fetches"] -= 1  # the warm-up's
    rec["weights"] = rec["model"].latest_weights
    rec["captured"] = len(rec["model"]._graphs)
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
    rec["totals"] = totals
    return rec


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
    return {"launches": rec["launches"], "rate": rate, "timeline": timeline,
            "statuses": statuses, "publish_ms": means["publish_ms"]}


# ---- phase 8: the runtime guards at full width -----------------------------

GUARD_BATCHES = 8
GUARD_ARGV = ["--backend", "cuda", "--source", "synthetic", "--seconds", "0",
              "--batchBucket", str(OP_ROWS), "--maxQueueRows", "-1"]
GUARD_COUNTERS = ("model.rollbacks", "model.nonfinite_batches", "model.rows_lost",
                  "model.sentinel_aborts", "journal.replayed_rows", "fetch.aborts",
                  "checkpoint.quarantined")
# what a guard reports at ERROR or above about the fault it caught
GUARD_ERRORS = ("divergence sentinel", "run aborting", "post-mortem bundle written")
# ~0.3 s of device work queued ahead of a step, so the next batch dispatches
# while it is still in flight
INFLIGHT_SLEEP_CYCLES = 500_000_000
# the card's nvidia-smi name and power limit, on every [guards] line
GUARD_CARD = ""


def guard_line(msg: str) -> None:
    phase("guards", f"{msg} | card: {GUARD_CARD}")


class Timings:
    """Wall ms of each call of the named methods while the context is
    open (``{label: (owner, attribute)}``), for the guards' costs."""

    def __init__(self, targets):
        self.targets = targets
        self.ms = {label: [] for label in targets}

    def __enter__(self):
        self._saved = {}
        for label, (owner, attr) in self.targets.items():
            base = getattr(owner, attr)
            self._saved[label] = base

            def timed_call(*a, _base=base, _label=label, **k):
                t0 = time.perf_counter()
                try:
                    return _base(*a, **k)
                finally:
                    self.ms[_label].append((time.perf_counter() - t0) * 1e3)

            setattr(owner, attr, timed_call)
        return self

    def __exit__(self, *exc):
        for label, (owner, attr) in self.targets.items():
            setattr(owner, attr, self._saved[label])
        return False

    def mean(self, label):
        v = self.ms[label]
        return f"{statistics.mean(v):.3f} ms (n={len(v)}, max {max(v):.3f})" if v else "no call"


def guard_run(name, statuses, extra, max_batches=0, **kw):
    """One app run of the guards phase from a pre-filled source of
    ``statuses``: the registry's guard counters as deltas over the run,
    every dispatch under the sync-debug mode "error"."""
    from twtml_tpu_torch.apps.common import SYNC_DEBUG_ENV
    from twtml_tpu_torch.telemetry import metrics

    reg = metrics.get_registry()
    before = {k: reg.counter(k).snapshot() for k in GUARD_COUNTERS}
    os.environ[SYNC_DEBUG_ENV] = "error"
    try:
        totals, lines, rec = recorded_app_run(
            GUARD_ARGV + extra, max_batches, source=prefilled_source(statuses),
            expected_errors=GUARD_ERRORS, **kw)
    finally:
        del os.environ[SYNC_DEBUG_ENV]
    rec["counters"] = {k: int(reg.counter(k).snapshot() - before[k]) for k in GUARD_COUNTERS}
    guard_line(f"{name}: " + ("aborted: " + rec["aborted"] if totals is None else
                                    f"{totals['batches']} batches, {totals['count']} rows")
          + f"; kernel launches {rec['launches']}, fetches {rec['fetches']}, counters "
          + json.dumps(rec["counters"]))
    return totals, lines, rec


def expect(name, got: dict, want: dict):
    bad = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
    if bad:
        raise AssertionError(f"guards {name}: (got, want) {bad}")


def archive(directory):
    """(weights, meta) of the directory's newest verified archive."""
    from twtml_tpu_torch.checkpoint import Checkpointer

    restored = Checkpointer(directory).restore()
    if restored is None:
        raise AssertionError(f"no verified archive in {directory}")
    return restored


def write_replay(path, statuses):
    """The tweets as the JSON lines ``ReplayFileSource`` reads back into
    the same Status objects."""
    def obj(s):
        d = {"text": s.text, "retweet_count": s.retweet_count,
             "user": {"followers_count": s.followers_count,
                      "favourites_count": s.favourites_count,
                      "friends_count": s.friends_count},
             "timestamp_ms": str(s.created_at_ms), "lang": s.lang, "id": s.id}
        if s.retweeted_status is not None:
            d["retweeted_status"] = obj(s.retweeted_status)
        return d

    with open(path, "w") as fh:
        for s in statuses:
            fh.write(json.dumps(obj(s)) + "\n")


def recycle_run(replay, ckdir, recycle: bool):
    """The app as a user starts it, in a subprocess on the card; returns
    its stderr and printed lines."""
    env = dict(os.environ, TWTML_RECYCLE_MAX="1", TWTML_RECYCLE_SAMPLE_EVERY="1")
    env.pop("TWTML_RECYCLES", None)
    argv = [sys.executable, "-m", "twtml_tpu_torch.apps.linear_regression",
            "--backend", "cuda", "--source", "replay", "--replayFile", replay,
            "--seconds", "0", "--batchBucket", str(OP_ROWS), "--checkpointDir", ckdir,
            "--checkpointEvery", "2",
            "--lightning", RECORDER.url, "--twtweb", RECORDER.url]
    if recycle:
        argv += ["--recycleAfterMb", "1"]
    proc = subprocess.run(argv, cwd=HERE, env=env, capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"recycle run (recycle={recycle}) exited "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    return proc.stderr, [ln for ln in proc.stdout.splitlines() if ln.startswith("count:")]


def step_work(events):
    """Device work between the end of batch 1's fused kernel and the end of
    the last batch's (the warm-up's and batch 1's work, where the profiler
    may drop a session's first events, and the reads after the run fall
    outside): batches 2-8's H2D copies and the step ops before their fused
    kernel, batches 1-7's ops after it and their D2H fetch, so 7 steps'
    worth of every kind."""
    fused = [e for e in events if KERNEL in e[2]]
    if len(fused) != GUARD_BATCHES + 1:
        raise AssertionError(f"guards cost: profiler recorded {len(fused)} fused kernels, "
                             f"want {GUARD_BATCHES + 1}")
    lo, hi = fused[1][1], fused[-1][1]
    inside = [e for e in events if lo <= e[0] and e[1] <= hi]
    return {
        "kernels": sum("Memcpy" not in e[2] and "Memset" not in e[2] for e in inside),
        "fused": sum(KERNEL in e[2] for e in inside),
        "h2d": sum("HtoD (Pinned -> Device)" in e[2] for e in inside),
        "d2h": sum("DtoH (Device -> Pinned)" in e[2] for e in inside),
        "other_copies": sum(("Memcpy" in e[2] and "Pinned" not in e[2]) for e in inside),
    }


def guards_phase(smi):
    """The runtime guards at full width (B = 16384, 1004 dims, 50
    iterations, ragged, depth 8), from a pre-filled source: a poisoned run
    against a clean one at --checkpointEvery 1 and 4 (with batches in
    flight at the rollback), no checkpoint, resume, a rollback storm, a
    recycle in a subprocess, and the guards' cost."""
    global GUARD_CARD
    import re
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from twtml_tpu_torch.apps.common import AppCheckpoint
    from twtml_tpu_torch.checkpoint import Checkpointer
    from twtml_tpu_torch.streaming.journal import IntakeJournal
    from twtml_tpu_torch.streaming.sources import SyntheticSource
    from twtml_tpu_torch.telemetry import historian
    from twtml_tpu_torch.telemetry.blackbox import FlightRecorder

    GUARD_CARD = smi
    statuses = list(SyntheticSource(total=GUARD_BATCHES * OP_ROWS, seed=7,
                                    base_ms=NOW_MS).produce())
    tmp = tempfile.mkdtemp(prefix="twtml-guards-")
    full = {"batches": GUARD_BATCHES, "count": GUARD_BATCHES * OP_ROWS}
    timings = Timings({"save": (AppCheckpoint, "_save"),
                       "npz": (Checkpointer, "save"),
                       "append": (IntakeJournal, "append"),
                       "rollback": (AppCheckpoint, "rollback_to_verified"),
                       "dump": (FlightRecorder, "dump"),
                       "sample": (historian.Historian, "sample")})
    RECORDER.take()
    with timings:
        # -- poison at batch 5, a checkpoint every batch: crash equals clean
        clean1, clean1_lines, clean1_rec = guard_run(
            "clean, --checkpointEvery 1", statuses,
            ["--checkpointDir", f"{tmp}/clean1", "--checkpointEvery", "1"])
        saves_clean = list(timings.ms["save"])
        # the historian (on at the JAX defaults with --checkpointDir) against
        # --history off: the same lines and bitwise-equal weights
        samples_clean = list(timings.ms["sample"])
        _, off_lines, off_rec = guard_run(
            "clean, --checkpointEvery 1, --history off", statuses,
            ["--checkpointDir", f"{tmp}/clean1off", "--checkpointEvery", "1",
             "--history", "off"])
        hist = f"{tmp}/clean1/history"
        records = historian.read_series(hist)
        seg_bytes = sum(os.path.getsize(os.path.join(hist, n)) for n in os.listdir(hist)
                        if n.endswith(".twh"))
        n_samples = sum(r["k"] == "s" for r in records)
        if not (off_lines == clean1_lines and np.array_equal(off_rec["weights"],
                                                             clean1_rec["weights"])
                and n_samples >= 1 and samples_clean
                and not os.path.exists(f"{tmp}/clean1off/history")):
            raise AssertionError(f"guards history: on/off differ, or {n_samples} samples "
                                 f"in {hist}")
        guard_line(f"historian (--history auto, on with --checkpointDir): {n_samples} "
                   f"samples and {len(records) - n_samples} other records in "
                   f"{seg_bytes} segment bytes over {GUARD_BATCHES} batches = "
                   f"{seg_bytes / GUARD_BATCHES:.1f} B a batch; sample() "
                   f"{statistics.mean(samples_clean):.3f} ms (n={len(samples_clean)}, "
                   f"max {max(samples_clean):.3f}); --history off: the same lines, final "
                   "weights bitwise equal, no history directory")
        got, lines, rec = guard_run(
            "poison source.nan@5, --checkpointEvery 1", statuses,
            ["--checkpointDir", f"{tmp}/poison1", "--checkpointEvery", "1",
             "--chaos", "source.nan@5"])
        expect("poison@5", {**rec["counters"], "batches": got["batches"],
                            "count": got["count"], "fetches": rec["fetches"]},
               {"model.rollbacks": 1, "model.nonfinite_batches": 1, "model.rows_lost": 0,
                "journal.replayed_rows": OP_ROWS, "fetch.aborts": 0,
                "checkpoint.quarantined": 0, "fetches": GUARD_BATCHES + 1, **full})
        if lines != clean1_lines:
            raise AssertionError("guards poison@5: printed lines differ from the clean run's")
        w_p, meta_p = archive(f"{tmp}/poison1")
        w_c, meta_c = archive(f"{tmp}/clean1")
        if not (np.array_equal(w_p, w_c) and meta_p["count"] == meta_c["count"]):
            raise AssertionError("guards poison@5: final archive differs from the clean run's")
        guard_line(f"poison@5: 1 rollback, 1 non-finite batch, 0 rows lost, "
              f"{OP_ROWS} rows replayed, {rec['fetches']} fetches for "
              f"{len(rec['outputs'])} dispatches; lines equal the clean run's; the final "
              f"archive (step {meta_p['step']}) bitwise equal to the clean run's")
        drain_ms = statistics.mean(st["fetch_wait_ms"] for st in clean1["steps"][1:])
        guard_line(f"checkpoint every batch, clean run: save (.cpu() + npz + "
              f"rename) {statistics.mean(saves_clean):.3f} ms a batch (n={len(saves_clean)}), "
              f"of which npz + rename {timings.mean('npz')}; the drain before it "
              f"(fetch wait a batch) {drain_ms:.3f} ms; journal append of "
              f"{OP_ROWS} rows {timings.mean('append')}; rollback (restore + H2D) "
              f"{timings.mean('rollback')}")

        # -- poison at batch 7 with batches in flight, a checkpoint every 4
        sleep = {7: INFLIGHT_SLEEP_CYCLES}
        clean4, clean4_lines, _ = guard_run(
            "clean, --checkpointEvery 4", statuses,
            ["--checkpointDir", f"{tmp}/clean4", "--checkpointEvery", "4"],
            sleep_before=sleep)
        got, lines, rec = guard_run(
            "poison source.nan@7, --checkpointEvery 4, batch 7 delayed", statuses,
            ["--checkpointDir", f"{tmp}/poison4", "--checkpointEvery", "4",
             "--chaos", "source.nan@7"], sleep_before=sleep)
        tainted = rec["counters"]["model.nonfinite_batches"] - 1
        if tainted < 1:
            raise AssertionError("guards poison@7: no batch was in flight at the rollback")
        # dispatched: batches 1-7, the tainted ones after 7, the 4 replayed
        expect("poison@7", {**rec["counters"], "batches": got["batches"],
                            "count": got["count"], "fetches": rec["fetches"],
                            "dispatches": len(rec["outputs"])},
               {"model.rollbacks": 1, "model.rows_lost": 0,
                "journal.replayed_rows": 4 * OP_ROWS, "fetch.aborts": 0,
                "fetches": 7 + tainted + 4, "dispatches": 7 + tainted + 4, **full})
        w_p, _ = archive(f"{tmp}/poison4")
        w_c, _ = archive(f"{tmp}/clean4")
        # batches 5 and 6 trained and printed before the rollback to step 4,
        # and print again (the same counts) as the replay retrains them
        if lines != clean4_lines[:6] + clean4_lines[4:] or not np.array_equal(w_p, w_c):
            raise AssertionError("guards poison@7: lines or final archive differ from the "
                                 "clean run's")
        guard_line(f"poison@7: {tainted} batch(es) in flight at the rollback drained "
              f"as tainted skips; 1 rollback, 0 rows lost, {4 * OP_ROWS} rows of batches "
              f"5-8 replayed, {rec['fetches']} fetches for {len(rec['outputs'])} "
              "dispatches; no sync raised under set_sync_debug_mode('error'); the "
              "lines of batches 1-6 then, replayed, 5-8 equal the clean run's, and the "
              "final archive is bitwise equal to it")

        # -- poison without a checkpoint: back to zeros, rows counted lost
        got, lines, rec = guard_run("poison source.nan@5, no checkpoint", statuses,
                                    ["--chaos", "source.nan@5"])
        lost = rec["counters"]["model.rows_lost"]
        last = got["steps"][-1]
        if not (rec["counters"]["model.rollbacks"] == 1 and lost >= OP_ROWS
                and lost % OP_ROWS == 0 and got["count"] == full["count"] - lost
                and len(rec["restored"]) == 1 and not rec["restored"][0].any()
                and all(math.isfinite(last[k]) for k in ("mse", "real_stdev", "pred_stdev"))):
            raise AssertionError(f"guards no-checkpoint: {rec['counters']}, {got['count']} rows")
        guard_line(f"no checkpoint: weights reset to zeros, {lost} rows lost "
              f"({lost // OP_ROWS} batch(es): the poisoned one"
              f"{' and tainted in-flight ones' if lost > OP_ROWS else ''}), "
              f"{got['batches']} batches trained after it, last stats finite")

        # -- resume: 4 batches, then a new run from the same directory
        _, lines_a, _ = guard_run("resume, first run", statuses,
                                  ["--checkpointDir", f"{tmp}/resume",
                                   "--checkpointEvery", "1"], max_batches=4)
        w_saved, _ = archive(f"{tmp}/resume")
        got, lines_b, rec = guard_run("resume, second run", statuses,
                                      ["--checkpointDir", f"{tmp}/resume",
                                       "--checkpointEvery", "1"], max_batches=8)
        restored = rec["restored"][0].cpu().numpy()
        w_final, _ = archive(f"{tmp}/resume")
        if not (np.array_equal(restored, w_saved) and lines_a + lines_b == clean1_lines
                and np.array_equal(w_final, archive(f"{tmp}/clean1")[0])):
            raise AssertionError("guards resume: not equal to one 8-batch run")
        guard_line("resume: restored weights bitwise equal to the archive; 4 + 4 "
              "batches' lines and final weights equal one 8-batch run's")

        # -- a rollback storm aborts the run, leaving a bundle
        got, _, rec = guard_run(
            "storm source.nan@2, --sentinelRollbacks 2", statuses,
            ["--checkpointDir", f"{tmp}/storm/ck", "--checkpointEvery", "1",
             "--chaos", "source.nan@2", "--sentinelRollbacks", "2",
             "--sentinelWindow", "100"], expect_abort=True)
        expect("storm", rec["counters"], {"model.rollbacks": 2, "model.sentinel_aborts": 1})
        w_s, meta_s = archive(f"{tmp}/storm/ck")
        bundle_path = os.path.join(f"{tmp}/storm", f"postmortem.p0.{os.getpid()}.json")
        with open(bundle_path) as fh:
            bundle = json.load(fh)
        note = bundle["notes"].get("last_checkpoint", {})
        if not (np.isfinite(w_s).all() and note.get("step") == meta_s["step"]
                and any(e["kind"] == "sentinel_abort" for e in bundle["events"])):
            raise AssertionError(f"guards storm: archive step {meta_s['step']}, bundle "
                                 f"notes {bundle['notes']}")
        guard_line(f"storm: aborted through request_abort after 2 rollbacks; the "
              f"newest archive (step {meta_s['step']}) is finite; bundle "
              f"{os.path.basename(bundle_path)} names it ({len(bundle['events'])} events); "
              f"dump {timings.mean('dump')}")
    RECORDER.take()

    # -- recycle: a subprocess re-execs itself after a checkpoint
    replay = f"{tmp}/recycle.jsonl"
    write_replay(replay, statuses[: 4 * OP_ROWS])
    err_r, lines_r = recycle_run(replay, f"{tmp}/recycled", True)
    _, lines_u = recycle_run(replay, f"{tmp}/unrecycled", False)
    saved = re.findall(r"state crc ([0-9a-f]+)\) and re-exec'ing", err_r)
    resumed = re.findall(r"resumed from checkpoint step \d+ \(count=\d+, state crc "
                         r"([0-9a-f]+)\)", err_r)
    w_r, meta_r = archive(f"{tmp}/recycled")
    w_u, meta_u = archive(f"{tmp}/unrecycled")
    if not (len(saved) == 1 and resumed == saved and meta_r["count"] == meta_u["count"]
            == 4 * OP_ROWS and np.array_equal(w_r, w_u)
            and lines_r[-1] == lines_u[-1]):
        raise AssertionError(f"guards recycle: crc {saved} / {resumed}, counts "
                             f"{meta_r['count']} / {meta_u['count']}")
    guard_line(f"recycle (subprocess on the card, --recycleAfterMb 1): state crc "
          f"{saved[0]} at the re-exec and at the restore; {meta_r['count']} rows, final "
          "weights bitwise equal to an unrecycled run's")
    RECORDER.take()

    # -- the guards' cost on the healthy path
    off = ["--sentinel", "off", "--modelWatch", "off", "--freshness", "off",
           "--blackbox", "off"]
    rates = {}
    for label, extra in (("guards on", []), ("guards off", off),
                         ("guards on (again)", []), ("guards off (again)", off)):
        got, _, _ = guard_run(label, statuses, extra)
        span = got["steps"][-1]["delivered_s"] - got["steps"][0]["delivered_s"]
        rates.setdefault(label.split(" (")[0], []).append(
            (GUARD_BATCHES - 1) * OP_ROWS / span)
        posts = RECORDER.take()
        kinds = [b.get("jsonClass") for p, b in posts if p == "/api"]
        if label.startswith("guards on") and not (kinds.count("ModelHealth") >= 1
                                                  and kinds.count("Freshness") >= 1):
            raise AssertionError(f"guards cost: posts {sorted(set(kinds))}")
        # (the model watcher's view outlives a run in its process, as in the
        # JAX package; the freshness plane is rebuilt or turned off each run)
        if label.startswith("guards off") and "Freshness" in kinds:
            raise AssertionError("guards cost: the guards-off run posted a freshness view")
    # device work, profiled: the host guards off keep the step as it is;
    # --modelWatch off also drops the in-step quality vector (its launches)
    host_off = ["--sentinel", "off", "--freshness", "off", "--blackbox", "off"]
    copies = {}
    for label, extra in (("guards on", []), ("host guards off", host_off),
                         ("all off", off),
                         ("history on", ["--checkpointDir", f"{tmp}/prof_on"]),
                         ("history off", ["--checkpointDir", f"{tmp}/prof_off",
                                          "--history", "off"])):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            guard_run(f"{label}, profiled", statuses, extra)
            torch.cuda.synchronize()
        RECORDER.take()
        copies[label] = step_work(device_timeline(prof))
    on = copies["guards on"]
    if not (on == copies["host guards off"] and on["h2d"] == on["d2h"] == GUARD_BATCHES - 1
            and on["fused"] == GUARD_BATCHES - 1
            and all(copies["all off"][k] == on[k] for k in ("fused", "h2d", "d2h"))):
        raise AssertionError(f"guards cost: device work {copies}")
    if copies["history on"] != copies["history off"]:
        raise AssertionError(f"guards history: device work on {copies['history on']} "
                             f"against off {copies['history off']}")
    per = lambda c: c["kernels"] / (GUARD_BATCHES - 1)  # noqa: E731
    guard_line(f"device work over {GUARD_BATCHES - 1} steps (profiler, from batch 1's fused "
               f"kernel to batch {GUARD_BATCHES}'s): guards on {on}, sentinel/freshness/"
               f"blackbox off {copies['host guards off']}, all off {copies['all off']}: 1 H2D "
               f"(pinned) and 1 D2H (to pinned) copy a step either way, {per(on):g} launches "
               f"a step with the guards on as with the host guards off; --modelWatch off "
               f"drops the step's quality vector: {per(copies['all off']):g} launches a step")
    guard_line(f"historian on (--checkpointDir, --history auto) against --history off, "
               f"profiled: {copies['history on']} / {copies['history off']}: the same D2H "
               f"copies ({copies['history on']['d2h'] / (GUARD_BATCHES - 1):g}) and launches "
               f"({per(copies['history on']):g}) a step")
    guard_line("tweets/s over batches 2-8, guards on: "
          + ", ".join(f"{r:.0f}" for r in rates["guards on"]) + "; off: "
          + ", ".join(f"{r:.0f}" for r in rates["guards off"]))
    return {"rates": rates, "copies": copies}


# ---- phases 9 and 10: Bernoulli mini-batches and --dtype at full width ---------

SAMPLED_ARGV = ["--source", "synthetic", "--seconds", "0", "--batchBucket", str(OP_ROWS)]
SAMPLED_BATCHES = 4
# the CPU tests' tolerances (tests/test_torch_sampling.py): float32 weights
# within 1e-4 of the largest, stats within 1e-4; bfloat16 here within 2**-5
# (4 units of its 8-bit mantissa: each of the 200 updates rounds, and the
# card's and the CPU's matrix products sum in other orders)
SAMPLED_RTOL = 1e-4
BF16_CARD_RTOL = 2.0**-5


# ~50 ms of device sleep: long enough for the host to enqueue a whole step
# of the torch loop (~1,500 launches) before the device starts it
STEP_AHEAD_CYCLES = 100_000_000


def device_costs(fn, runs):
    """What the card spends on ``fn`` a run: (CUDA-event ms with the whole
    run queued ahead, so the device's time and not the host's enqueue; the
    profiler's summed device time of its kernels and copies; kernel
    launches from the profiler's host-side cudaLaunch* calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # first use outside the windows
    torch.cuda.synchronize()
    event_ms, _ = timed(fn, runs, queue_ahead=True, ahead_cycles=STEP_AHEAD_CYCLES)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    busy = sum(ev.device_time_total for ev in prof.key_averages()
               if ev.device_time_total) / runs / 1e3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    n = sum(ev.count for ev in prof.key_averages() if ev.key.startswith("cudaLaunch")) / runs
    return event_ms, busy, n


def route_run(name, extra, statuses):
    """``SAMPLED_BATCHES`` full-width batches of ``statuses`` (a pre-filled
    source, so no producer thread competes with the dispatch for the
    interpreter lock) on the card with ``extra`` under the sync-debug mode
    "error", and the same on ``--backend cpu``: (totals, lines, record) of
    each."""
    from twtml_tpu_torch.apps.common import SYNC_DEBUG_ENV

    os.environ[SYNC_DEBUG_ENV] = "error"
    try:
        totals, lines, rec = recorded_app_run(
            ["--backend", "cuda", *SAMPLED_ARGV, *extra], SAMPLED_BATCHES,
            source=prefilled_source(statuses))
    finally:
        del os.environ[SYNC_DEBUG_ENV]
    if totals["batches"] != SAMPLED_BATCHES or rec["launches"] != 0:
        raise AssertionError(f"{name}: {totals['batches']} batches, fused_dense_sgd "
                             f"launched {rec['launches']} times (the torch loop's route "
                             "must not launch it)")
    if rec["model"].route != "torch_loop":
        raise AssertionError(f"{name}: route {rec['model'].route}")
    twin = recorded_app_run(["--backend", "cpu", *SAMPLED_ARGV, *extra], SAMPLED_BATCHES,
                            source=prefilled_source(statuses))
    return (totals, lines, rec), twin


def compare_twin(name, card, twin, rtol):
    """Weights within ``rtol`` of the CPU twin's largest weight, each
    batch's 4 stats within ``rtol``: the largest differences seen."""
    (totals, _, rec), (ctotals, _, crec) = card, twin
    w, cw = rec["weights"].astype("float64"), crec["weights"].astype("float64")
    w_err = float(abs(w - cw).max() / abs(cw).max())
    s_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                for a, b in zip(totals["steps"], ctotals["steps"])
                for k in ("count", "mse", "real_stdev", "pred_stdev"))
    if not (w_err <= rtol and s_err <= rtol):
        raise AssertionError(f"{name}: card against the CPU twin: weights {w_err:.3g}, "
                             f"stats {s_err:.3g} (tolerance {rtol:g})")
    return w_err, s_err


def sampled_phase(smi):
    """``-b 0.5`` at full width: the [N, B] masks made on the card bitwise
    equal to the same function on the CPU (in each float type the draw
    takes), 4 batches on the card against the CPU twin, no launch of the
    fused kernel, no host sync; the mask build's and the step's device ms
    and launches."""
    import torch

    from twtml_tpu_torch.models import sgd

    for dtype in (torch.float32, torch.float64):
        gpu = sgd.sampling_masks(OP_ROWS, OP_ITERS, 0.5, dtype, "cuda")
        cpu = sgd.sampling_masks(OP_ROWS, OP_ITERS, 0.5, dtype, "cpu")
        if not torch.equal(gpu.cpu(), cpu):
            raise AssertionError(f"sampled: {dtype} masks on the card differ from the CPU's")
    mask_ms, mask_busy, mask_n = device_costs(
        lambda: sgd.sampling_masks(OP_ROWS, OP_ITERS, 0.5, torch.float32, "cuda"), 10)
    phase("sampled", f"masks [{OP_ITERS}, {OP_ROWS}] on the card bitwise equal to the "
          f"CPU's (float32 and float64 draws), {int(cpu.sum())} of {cpu.numel()} rows "
          f"selected; the batched draw (made once a row count): {mask_ms:.4f} ms "
          f"(CUDA events, queued ahead), {mask_busy:.4f} ms device busy (profiler), "
          f"{mask_n:g} launches | card: {smi}")
    from twtml_tpu_torch.streaming.sources import SyntheticSource

    statuses = list(SyntheticSource(total=SAMPLED_BATCHES * OP_ROWS, seed=7,
                                    base_ms=NOW_MS).produce())
    card, twin = route_run("sampled", ["-b", "0.5"], statuses)
    totals, lines, rec = card
    w_err, s_err = compare_twin("sampled", card, twin, SAMPLED_RTOL)
    for line, st in zip(lines, totals["steps"]):
        phase("sampled", f"{line} | step {st['step_ms']:.3f} ms (CUDA events), "
              f"dispatch {st['dispatch_ms']:.3f} ms, fetch wait {st['fetch_wait_ms']:.3f} ms")
    phase("sampled", f"{SAMPLED_BATCHES} batches of {OP_ROWS} on the torch loop (route "
          f"named: {rec['model'].route}), fused_dense_sgd launched {rec['launches']} times, "
          f"every dispatch under set_sync_debug_mode('error'); against the --backend cpu "
          f"twin: weights {w_err:.3g} of the largest, stats {s_err:.3g} "
          f"(tolerance {SAMPLED_RTOL:g})")
    dev_ms, busy, n = step_costs(["-b", "0.5"])
    fused_ms, fused_busy, fused_n = step_costs([])
    phase("sampled", f"one step of batch 2 (padded wire, on the card), median of 5: "
          f"{dev_ms:.3f} ms (CUDA events, queued ahead), {busy:.3f} ms device busy "
          f"(profiler), {n:g} kernel launches; the default route (fused kernel) by the "
          f"same measures: {fused_ms:.3f} ms, {fused_busy:.3f} ms, {fused_n:g} launches "
          f"| card: {smi}")
    return {"step_ms": dev_ms, "step_busy_ms": busy, "launches": n, "mask_ms": mask_ms,
            "mask_busy_ms": mask_busy, "weights_err": w_err, "stats_err": s_err,
            "fused_step_ms": fused_ms, "fused_step_busy_ms": fused_busy,
            "fused_launches": fused_n}


def step_costs(extra):
    """``device_costs`` of one step of a fresh cuda model configured by
    ``extra``, on batch 2 of the operating point's stream (padded wire)
    copied to the card, from the weights batch 1 left."""
    from twtml_tpu_torch.apps.common import build_model
    from twtml_tpu_torch.config import ConfArguments
    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.models.sgd import batch_to_device
    from twtml_tpu_torch.streaming.sources import SyntheticSource

    tweets = list(SyntheticSource(total=2 * OP_ROWS, seed=3, base_ms=NOW_MS).produce())
    featurizer = Featurizer(now_ms=NOW_MS)
    batches = [featurizer.featurize_batch_units(tweets[i:i + OP_ROWS], row_bucket=OP_ROWS)
               for i in (0, OP_ROWS)]
    model = build_model(ConfArguments().parse(["--backend", "cuda", *extra]))
    float(model.step(batches[0]).mse)
    w, dev = model._weights, batch_to_device(batches[1], "cuda", non_blocking=False)
    return device_costs(lambda: model._train_step(w, dev), 5)


def dtype_phase(smi):
    """``--dtype bfloat16``: 4 full-width batches on the card, the MSE falls,
    everything finite, within BF16_CARD_RTOL of the CPU twin; ``--dtype
    float64 --backend cuda`` exits before anything is built, as the JAX
    package's does."""
    import numpy as np

    from twtml_tpu_torch.streaming.sources import SyntheticSource

    statuses = list(SyntheticSource(total=SAMPLED_BATCHES * OP_ROWS, seed=7,
                                    base_ms=NOW_MS).produce())
    card, twin = route_run("dtype bfloat16", ["--dtype", "bfloat16"], statuses)
    totals, lines, rec = card
    mses = [st["mse"] for st in totals["steps"]]
    finite = all(np.isfinite(st[k]) for st in totals["steps"]
                 for k in ("mse", "real_stdev", "pred_stdev")) and np.isfinite(rec["weights"]).all()
    if not (finite and mses[-1] < mses[0]):
        raise AssertionError(f"dtype bfloat16: MSE {mses}, finite {finite}")
    w_err, s_err = compare_twin("dtype bfloat16", card, twin, BF16_CARD_RTOL)
    for line, st in zip(lines, totals["steps"]):
        phase("dtype", f"bfloat16: {line} | step {st['step_ms']:.3f} ms (CUDA events)")
    phase("dtype", f"bfloat16: MSE falls {mses[0]:.1f} -> {mses[-1]:.1f}, all finite, "
          f"route {rec['model'].route}, fused_dense_sgd launched {rec['launches']} times, "
          f"no host sync; against the --backend cpu twin: weights {w_err:.3g} of the "
          f"largest, stats {s_err:.3g} (tolerance {BF16_CARD_RTOL:g})")
    dev_ms, busy, n = step_costs(["--dtype", "bfloat16"])
    phase("dtype", f"bfloat16: one step of batch 2 (padded wire, on the card), median of "
          f"5: {dev_ms:.3f} ms (CUDA events, queued ahead), {busy:.3f} ms device busy "
          f"(profiler), {n:g} kernel launches | card: {smi}")
    built = []
    from twtml_tpu_torch.apps import linear_regression as app

    base = app.build_model
    app.build_model = lambda conf: built.append(conf) or base(conf)
    try:
        app_run(["--backend", "cuda", "--dtype", "float64", *SAMPLED_ARGV], 1)
        raise AssertionError("dtype float64: --backend cuda was not refused")
    except SystemExit as exc:
        if "add --backend cpu" not in str(exc) or built:
            raise AssertionError(f"dtype float64: refused with {exc!r} after building "
                                 f"{len(built)} model(s)")
        phase("dtype", f"float64 --backend cuda: exits before building a model: {exc}")
    finally:
        app.build_model = base
    return {"step_ms": dev_ms, "step_busy_ms": busy, "launches": n,
            "weights_err": w_err, "stats_err": s_err}


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


# ---- phases 12-14: the dashboard server, the live source, host hashing -----

WEB_BATCHES = 8
LIVE_BATCHES = 4
POST_SAMPLES = 200


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def stats_line(b) -> str:
    """The app's printed line of a Stats message."""
    return (f"count: {b['count']}  batch: {b['batch']}  mse: {float(b['mse'])}  "
            f"stdev (real, pred): ({b['realStddev']}, {b['predStddev']})")


def http_get(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.read()


def web_phase(statuses, stream_publish_ms):
    """The port's dashboard server as its own process (``python -m
    twtml_tpu_torch.web.main -nocache``) on a loopback port: a websocket
    client gets the Config push, the app trains 8 full-width batches on the
    card publishing to it (Lightning stays at the recorder), each batch's
    Stats frame equals its printed line, the views and the dashboard are
    served; then the server's POST latency and the largest frame."""
    import tempfile
    import urllib.request

    from twtml_tpu_torch.web.websocket import WebSocketClient

    t_phase = time.perf_counter()
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    tmp = tempfile.mkdtemp(prefix="twtml-web-")
    env = dict(os.environ, PORT=str(port), TMPDIR=tmp, PYTHONPATH=HERE)
    proc = subprocess.Popen([sys.executable, "-m", "twtml_tpu_torch.web.main", "-nocache"],
                            cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    frames, reader = [], None
    try:
        t0 = time.perf_counter()
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"web: the server exited {proc.returncode}: "
                                     f"{proc.stdout.read().decode()[-2000:]}")
            try:
                client = WebSocketClient(url.replace("http", "ws") + "/api", timeout=10)
                break
            except OSError:
                if time.perf_counter() - t0 > 60:
                    raise
                time.sleep(0.1)
        up_s = time.perf_counter() - t0
        push = json.loads(client.recv_text())
        if push != {"jsonClass": "Config", "id": "", "host": "", "viz": []}:
            raise AssertionError(f"web: connect push {push}")
        client.sock.settimeout(None)

        def read():
            try:
                while (text := client.recv_text()) is not None:
                    frames.append(text)
            except OSError:
                pass

        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        RECORDER.take()
        totals, lines, rec = recorded_app_run(
            [*STREAM_ARGV, "--twtweb", url], 0, source=prefilled_source(statuses))
        check_counters("web", rec, WEB_BATCHES, "ragged")
        t0 = time.perf_counter()
        while sum('"Stats"' in f for f in frames) < WEB_BATCHES and time.perf_counter() - t0 < 20:
            time.sleep(0.01)
        seen = list(frames)
        stats = [json.loads(f) for f in seen if json.loads(f)["jsonClass"] == "Stats"]
        if [stats_line(b) for b in stats] != lines or len(lines) != WEB_BATCHES:
            raise AssertionError(f"web: Stats frames {stats} against lines {lines}")
        kinds = [json.loads(f)["jsonClass"] for f in seen]
        _, body = http_get(url + "/api/stats")
        if json.loads(body) != stats[-1]:
            raise AssertionError(f"web: GET /api/stats {body!r} != the last frame")
        _, index = http_get(url + "/")
        with open(os.path.join(HERE, "twtml_tpu_torch", "web", "assets", "index.html"), "rb") as fh:
            if index != fh.read():
                raise AssertionError("web: GET / is not the port's index.html")
        views = {v: json.loads(http_get(url + "/api/" + v)[1])["jsonClass"] if v != "series"
                 else len(json.loads(http_get(url + "/api/series")[1]))
                 for v in ("config", "series", "metrics", "model", "freshness")}
        largest = max(len(f.encode()) for f in seen)
        publish = [st["publish_ms"] for st in totals["steps"]]
        phase("web", f"server up in {up_s:.2f} s (a process of its own); connect push "
              f"{push}; {len(seen)} frames during the run: "
              + ", ".join(f"{k} {kinds.count(k)}" for k in sorted(set(kinds))))
        phase("web", f"{WEB_BATCHES} batches of {OP_ROWS} on the card: every Stats frame equals "
              "its printed line, GET /api/stats equals the last, GET / serves the port's "
              f"index.html ({len(index)} B); views {views}; kernel launches {rec['launches']}")
        for i, (line, st) in enumerate(zip(lines, totals["steps"])):
            phase("web", f"batch {i + 1}: {line} | publish {st['publish_ms']:.3f} ms")
        phase("web", f"publish a batch, batches 2-{WEB_BATCHES}: mean "
              f"{statistics.mean(publish[1:]):.3f} ms to the port's server against "
              f"{stream_publish_ms:.3f} ms to the stream phase's recorder (Lightning at the "
              f"recorder in both)")
        body = json.dumps(stats[-1]).encode()
        lat = []
        for _ in range(POST_SAMPLES):
            req = urllib.request.Request(url + "/api", data=body, method="POST",
                                         headers={"content-type": "application/json"})
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=10) as resp:
                resp.read()
            lat.append((time.perf_counter() - t0) * 1e3)
        lat.sort()
        p50, p99 = lat[len(lat) // 2], lat[int(len(lat) * 0.99) - 1]
        phase("web", f"POST /api latency, {POST_SAMPLES} posts of a Stats body ({len(body)} B) "
              f"as the app posts them (urllib, a connection each, one websocket live): "
              f"p50 {p50:.3f} ms, p99 {p99:.3f} ms, max {lat[-1]:.3f} ms")
        phase("web", f"largest websocket frame of the run: {largest} B")
    finally:
        proc.terminate()
        try:
            code = proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            code = proc.wait()
        if reader is not None:
            reader.join(timeout=10)
    if code != 0 or (reader is not None and reader.is_alive()):
        raise AssertionError(f"web: the server exited {code} on SIGTERM")
    phase("web", f"server stopped by SIGTERM (exit 0), websocket closed by it; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"publish_ms": statistics.mean(publish[1:]), "post_p50_ms": p50,
            "post_p99_ms": p99, "largest_frame": largest}


def tweet_json(s) -> dict:
    """A Status as the v1.1 stream's JSON (what ``Status.from_json`` reads)."""
    obj = {"text": s.text, "retweet_count": s.retweet_count, "id": s.id,
           "user": {"followers_count": s.followers_count,
                    "favourites_count": s.favourites_count,
                    "friends_count": s.friends_count}}
    if s.created_at_ms:
        obj["timestamp_ms"] = str(s.created_at_ms)
    if s.lang:
        obj["lang"] = s.lang
    if s.retweeted_status is not None:
        obj["retweeted_status"] = tweet_json(s.retweeted_status)
    return obj


class FakeStream:
    """A loopback v1.1 streaming endpoint: every request's OAuth signature
    is checked against the credentials; the first request of a round gets
    ``body`` as a chunked stream of JSON lines with keep-alive lines among
    them, later ones an empty stream (the source reconnects)."""

    CREDS = {"consumerKey": "ck-smoke", "consumerSecret": "cs-smoke",
             "accessToken": "at-smoke", "accessTokenSecret": "ts-smoke"}

    def __init__(self, body: bytes):
        from twtml_tpu_torch.streaming import oauth1

        self.body = body
        self.requests = self.bad = 0
        self.served = False
        fake = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_GET(self):
                from urllib.parse import unquote

                fake.requests += 1
                auth = self.headers.get("Authorization", "")
                params = dict((k, unquote(v.strip('"'))) for k, _, v in (
                    p.strip().partition("=") for p in auth[len("OAuth "):].split(",")))
                want = oauth1.sign(
                    "GET", fake.url, [(k, v) for k, v in params.items() if k != "oauth_signature"],
                    fake.CREDS["consumerSecret"], fake.CREDS["accessTokenSecret"])
                if (params.get("oauth_signature") != want
                        or params.get("oauth_consumer_key") != fake.CREDS["consumerKey"]
                        or params.get("oauth_token") != fake.CREDS["accessToken"]):
                    fake.bad += 1
                    self.send_response(401, "Unauthorized")
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Transfer-Encoding", "chunked")
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                body, fake.served = (b"" if fake.served else fake.body), True
                for i in range(0, len(body), 1 << 16):  # chunks cut lines anywhere
                    piece = body[i:i + (1 << 16)]
                    self.wfile.write(f"{len(piece):x}\r\n".encode() + piece + b"\r\n")
                self.wfile.write(b"0\r\n\r\n")
                self.close_connection = True

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/1.1/statuses/sample.json"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


def live_phase():
    """``--source twitter`` at full width: credentials from an
    ``application.conf`` named by ``TWTML_CONFIG``, ``twitter4j.streamBaseURL``
    at a loopback stream that checks each request's OAuth signature and
    serves the main phase's synthetic tweets; 4 batches back to back, each
    line equal to the same tweets' from a pre-filled source on the card;
    the source's own rate."""
    import tempfile

    from twtml_tpu_torch import config
    from twtml_tpu_torch.features.featurizer import Status
    from twtml_tpu_torch.streaming.sources import SyntheticSource
    from twtml_tpu_torch.streaming.twitter import TwitterSource

    t_phase = time.perf_counter()
    # one batch more than the run trains: a live stream never ends, and the
    # depth-8 pipeline delivers a batch's stats when the next batch fills
    n = (LIVE_BATCHES + 1) * OP_ROWS
    statuses = list(SyntheticSource(total=n, base_ms=NOW_MS).produce())
    objs = [tweet_json(s) for s in statuses]
    if [Status.from_json(o) for o in objs] != statuses:
        raise AssertionError("live: a tweet does not survive its JSON round trip")
    # a blank keep-alive line after every 4096 tweets, as the stream sends them
    body = "".join(json.dumps(o) + ("\r\n\r\n" if i % 4096 == 4095 else "\r\n")
                   for i, o in enumerate(objs)).encode()
    fake = FakeStream(body)
    conf_dir = tempfile.mkdtemp(prefix="twtml-conf-")
    conf_path = os.path.join(conf_dir, "application.conf")
    with open(conf_path, "w") as fh:
        fh.write("".join(f'{k}="{v}"\n' for k, v in FakeStream.CREDS.items()))
    argv = ["--backend", "cuda", "--seconds", "0", "--batchBucket", str(OP_ROWS)]
    try:
        os.environ["TWTML_CONFIG"] = conf_path
        config.set_property("twitter4j.streamBaseURL", fake.url)
        t0 = time.perf_counter()
        # the stream's end is a disconnect: the source logs it and reconnects
        totals, lines, rec = recorded_app_run([*argv, "--source", "twitter"], LIVE_BATCHES,
                                              expected_errors=("source twitter crashed",))
        wall = time.perf_counter() - t0
        requests, bad = fake.requests, fake.bad
        # the source alone, a fresh round of the same stream
        fake.served, got = False, []
        src = TwitterSource.from_properties()
        t0 = time.perf_counter()
        src.start(got.append)
        while len(got) < n and time.perf_counter() - t0 < 120:
            time.sleep(0.005)
        alone_s = time.perf_counter() - t0
        src.stop()
    finally:
        os.environ.pop("TWTML_CONFIG", None)
        config.set_property("twitter4j.streamBaseURL", "")
        fake.close()
    RECORDER.take()
    check_counters("live", rec, LIVE_BATCHES, "ragged")
    if bad or not requests:
        raise AssertionError(f"live: {bad} of {requests} requests failed the OAuth check")
    if len(got) != n or got != statuses:
        raise AssertionError(f"live: the source alone gave {len(got)} tweets, not the stream's")
    _, want, _ = recorded_app_run([*argv, "--source", "synthetic"], LIVE_BATCHES,
                                  source=prefilled_source(statuses[:LIVE_BATCHES * OP_ROWS]))
    RECORDER.take()
    if lines != want or len(lines) != LIVE_BATCHES or totals["count"] != LIVE_BATCHES * OP_ROWS:
        raise AssertionError(f"live: lines {lines} against the pre-filled source's {want}")
    for line in lines:
        phase("live", line)
    rate = totals["count"] / totals["stream_seconds"]
    phase("live", f"{LIVE_BATCHES} batches of {OP_ROWS} from --source twitter (OAuth from "
          f"TWTML_CONFIG's application.conf, {requests} signed request(s), all verified by the "
          "stream) equal the pre-filled source's lines on the card")
    phase("live", f"the app: {totals['count']} tweets in stream_seconds "
          f"{totals['stream_seconds']:.3f} s = {rate:.0f} tweets/s (app wall {wall:.2f} s); "
          f"the source alone: {n} tweets in {alone_s:.3f} s = {n / alone_s:.0f} tweets/s "
          f"(socket, chunked decode, json.loads, Status); {len(body)} B of stream; phase "
          f"wall {time.perf_counter() - t_phase:.1f} s")
    return {"app_tweets_per_s": rate, "source_tweets_per_s": n / alone_s}


def hosthash_phase(padded_rec):
    """``--hashOn host --wire padded --profileDir``: the main phase's 4
    batches hashed on the host (native/fasthash.cpp) and trained by the
    same fused kernel, bitwise equal to the padded phase; the Chrome trace
    names the kernel and the app's annotated regions. Then the same batches
    unprofiled, with host and with device hashing, from one pre-filled
    source each (no source thread in the timed runs): featurize and wall."""
    import glob
    import tempfile

    import numpy as np
    import torch

    from twtml_tpu_torch.features import native
    from twtml_tpu_torch.streaming.sources import SyntheticSource

    t_phase = time.perf_counter()
    prof_dir = tempfile.mkdtemp(prefix="twtml-prof-")
    statuses = list(SyntheticSource(total=4 * OP_ROWS, base_ms=NOW_MS).produce())
    argv = ["--backend", "cuda", "--wire", "padded", *MAIN_ARGV]
    host = [*argv, "--hashOn", "host"]
    totals, lines, rec = recorded_app_run([*host, "--profileDir", prof_dir], 4,
                                          source=prefilled_source(statuses))
    hashes = dict(native.HASH_COUNTERS)
    totals_u, lines_u, rec_u = recorded_app_run(host, 4, source=prefilled_source(statuses))
    totals_d, lines_d, rec_d = recorded_app_run([*argv, "--hashOn", "device"], 4,
                                                source=prefilled_source(statuses))
    RECORDER.take()
    check_counters("hosthash", rec, 4, "padded")
    if hashes != {"hashes_native": 5, "hashes_degraded": 0}:
        raise AssertionError(f"hosthash: host hashing counters {hashes}")
    for name, r in (("profiled", rec), ("unprofiled", rec_u), ("device-hash", rec_d)):
        for i, (a, b) in enumerate(zip(padded_rec["outputs"], r["outputs"], strict=True)):
            for k in ("predictions", "quality", "count", "mse", "real_stdev", "pred_stdev"):
                if not torch.equal(getattr(a, k), getattr(b, k)):
                    raise AssertionError(f"hosthash {name} batch {i + 1}: {k} differs "
                                         "from the padded phase")
        if not np.array_equal(padded_rec["weights"], r["weights"]):
            raise AssertionError(f"hosthash {name}: weights differ from the padded phase")
    if not lines_u == lines == lines_d:
        raise AssertionError("hosthash: the runs' lines differ")
    traces = glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))
    if len(traces) != 1 or traces[0] != totals["profile"]:
        raise AssertionError(f"hosthash: traces {traces}, the app wrote {totals['profile']}")
    with open(traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name", "") for e in events}
    kernels = [e for e in events if KERNEL in e.get("name", "") and e.get("cat") == "kernel"]
    regions = {r: sum(e.get("name") == r for e in events)
               for r in ("twtml.featurize", "twtml.dispatch", "twtml.publish")}
    if len(kernels) != 4 or not all(regions.values()):
        raise AssertionError(f"hosthash: trace holds {len(kernels)} {KERNEL} kernels, "
                             f"regions {regions}; {len(names)} names")
    for line, st, st_d in zip(lines, totals_u["steps"], totals_d["steps"]):
        subs = ", ".join(f"{k} {v:.1f}" for k, v in st["featurize_substages_ms"].items())
        phase("hosthash", f"{line} | {st['wire']} wire {st['wire_bytes']} B (device hash "
              f"{st_d['wire_bytes']} B) | featurize {st['featurize_ms']:.1f} ms ({subs}; "
              f"device hash {st_d['featurize_ms']:.1f}), step {st['step_ms']:.2f} ms (device "
              f"hash {st_d['step_ms']:.2f}; CUDA events)")
    host_ms = statistics.median(st["featurize_ms"] for st in totals_u["steps"][1:])
    dev_ms = statistics.median(st["featurize_ms"] for st in totals_d["steps"][1:])
    host_step = statistics.median(st["step_ms"] for st in totals_u["steps"][1:])
    dev_step = statistics.median(st["step_ms"] for st in totals_d["steps"][1:])
    phase("hosthash", "4 batches, host hashing profiled and unprofiled and device hashing: "
          "weights, predictions, stats and quality bitwise equal to the padded phase; "
          f"kernel launches {rec['launches']} (batches + warm-up), host hashing {hashes}")
    phase("hosthash", f"batches 2-4 median, pre-filled source: featurize {host_ms:.2f} ms "
          f"with host hashing against {dev_ms:.2f} ms on the device-hash padded wire (whose "
          f"hash runs in the step); step {host_step:.3f} against {dev_step:.3f} ms")
    phase("hosthash", f"--profileDir: {os.path.basename(traces[0])} "
          f"({os.path.getsize(traces[0])} B, {len(events)} events), {len(kernels)} "
          f"{KERNEL} kernels, regions {regions} (a CUDA region is also a GPU annotation); "
          f"profiled app wall {rec['wall_s']:.3f} s (stream {totals['stream_seconds']:.3f} s) "
          f"against unprofiled {rec_u['wall_s']:.3f} s (stream "
          f"{totals_u['stream_seconds']:.3f} s); phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"host_featurize_ms": host_ms, "device_featurize_ms": dev_ms,
            "launches": rec["launches"]}

# ---- phase 10: times --------------------------------------------------------

# ~0.1 ms of device work queued ahead of a timed call, so that its start
# event fires only after the host has enqueued the call's launch
QUEUE_AHEAD_CYCLES = 200_000


# ---- the logistic learner, the superbatch, streaming k-means ----------------

LOGISTIC_BATCHES = 4
LOGISTIC_ARGV = ["--source", "synthetic", "--seconds", "0", "--batchBucket", str(OP_ROWS)]
# a prediction may differ from the CPU twin's only where the twin's margin
# lies this close to 0 (the card sums X·w in another order)
MARGIN_ATOL = 1e-4


def two_class_statuses(n, seed):
    """``n`` synthetic tweets whose originals end in a lexicon word with a
    seeded draw (" great" 40 %, " bad" 40 %, none 20 %), so the sentiment
    labels hold both classes (the synthetic vocabulary alone is all 1)."""
    import numpy as np

    from twtml_tpu_torch.streaming.sources import SyntheticSource

    statuses = list(SyntheticSource(total=n, seed=seed, base_ms=NOW_MS).produce())
    words = np.random.default_rng(seed).choice(["", " great", " bad"], size=n,
                                                p=[0.2, 0.4, 0.4])
    for st, word in zip(statuses, words):
        st.retweeted_status.text += str(word)
    return statuses


def logistic_phase(smi):
    """``apps/logistic_regression.py`` on the card: 4 full-width batches of
    two-class tweets from a pre-filled source under the sync-debug mode,
    held against the ``--backend cpu`` twin (weights and stats within
    SAMPLED_RTOL, predictions equal except where the twin's margin is
    within MARGIN_ATOL of 0), B1 launched in its logistic mode once a batch
    and once for the warm-up."""
    import numpy as np

    from twtml_tpu_torch.apps import logistic_regression
    from twtml_tpu_torch.apps.common import SYNC_DEBUG_ENV
    from twtml_tpu_torch.features.sentiment import sentiment_labels
    from twtml_tpu_torch.models.logistic import StreamingLogisticRegressionWithSGD

    t_phase = time.perf_counter()
    statuses = two_class_statuses(LOGISTIC_BATCHES * OP_ROWS, 11)
    share = float(sentiment_labels(statuses).mean())
    run = dict(app_module=logistic_regression, learner=StreamingLogisticRegressionWithSGD)
    os.environ[SYNC_DEBUG_ENV] = "error"
    try:
        totals, lines, rec = recorded_app_run(
            ["--backend", "cuda", *LOGISTIC_ARGV], LOGISTIC_BATCHES,
            source=prefilled_source(statuses), **run)
    finally:
        del os.environ[SYNC_DEBUG_ENV]
    twin = recorded_app_run(["--backend", "cpu", *LOGISTIC_ARGV], LOGISTIC_BATCHES,
                            source=prefilled_source(statuses), **run)
    RECORDER.take()
    if (totals["batches"], rec["launches"], rec["model"].route) != (
            LOGISTIC_BATCHES, LOGISTIC_BATCHES + 1, "fused_dense_sgd"):
        raise AssertionError(f"logistic: {totals['batches']} batches, {rec['launches']} "
                             f"fused launches, route {rec['model'].route}")
    if twin[1] != lines[:1] + twin[1][1:] or len(twin[1]) != len(lines):
        raise AssertionError("logistic: the CPU twin printed another number of lines")
    w_err, s_err = compare_twin("logistic", (totals, lines, rec), twin, SAMPLED_RTOL)
    near, flips = [], 0
    for i, (out, cout, raw) in enumerate(zip(rec["outputs"], twin[2]["outputs"],
                                             twin[2]["raw"], strict=True)):
        valid = cout.count.item()
        close = (raw.abs() <= MARGIN_ATOL)[: int(valid)]
        differ = (out.predictions.cpu() != cout.predictions)[: int(valid)]
        near.append(int(close.sum()))
        flips += int(differ.sum())
        if (differ & ~close).any():
            raise AssertionError(f"logistic batch {i + 1}: {int((differ & ~close).sum())} "
                                 "predictions differ from the twin's at margins clear of 0")
    for line, st in zip(lines, totals["steps"]):
        phase("logistic", f"{line} | step {st['step_ms']:.3f} ms (CUDA events), "
              f"featurize {st['featurize_ms']:.2f} ms, publish {st['publish_ms']:.3f} ms")
    iters = [None if t is None else int(t.item()) for t in rec["iterations"]]
    phase("logistic", f"{LOGISTIC_BATCHES} batches of {OP_ROWS} two-class tweets (positive "
          f"label share {share:.4f}), every dispatch under set_sync_debug_mode('error'); "
          f"fused_dense_sgd (logistic mode) launched {rec['launches']} times (batches + "
          f"warm-up), iterations run {iters}; against the --backend cpu twin: weights "
          f"{w_err:.3g} of the largest, stats {s_err:.3g} (tolerance {SAMPLED_RTOL:g}); "
          f"predictions equal except {flips} row(s); rows with |margin| <= "
          f"{MARGIN_ATOL:g} a batch {near} (batch 1: zero weights, every margin 0); "
          f"whole stream {totals['count']} tweets in {totals['stream_seconds']:.4f} s = "
          f"{totals['count'] / totals['stream_seconds']:.0f} tweets/s; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s | card: {smi}")
    if not 0 < share < 1 or not np.isfinite(rec["weights"]).all():
        raise AssertionError(f"logistic: label share {share}, weights finite "
                             f"{np.isfinite(rec['weights']).all()}")
    return {"launches": rec["launches"], "positive_share": share, "near_zero_rows": near[1:],
            "prediction_flips": flips, "weights_err": w_err, "stats_err": s_err,
            "tweets_per_s": totals["count"] / totals["stream_seconds"]}


SB_K = 8
# --superBatch needs pinned buckets: the row length bucket the synthetic
# tweets take unpinned
SB_ARGV = [*STREAM_ARGV, "--tokenBucket", "64"]
SB_ARMS = (("group", ["--superBatch", str(SB_K), "--wirePack", "group"]),
           ("stacked", ["--superBatch", str(SB_K), "--wirePack", "stacked"]),
           ("K=1", ["--superBatch", "1"]))


def units_buckets(statuses):
    """The ragged units bucket of each full batch of ``statuses``."""
    from twtml_tpu_torch.features.featurizer import Featurizer

    featurizer = Featurizer(now_ms=NOW_MS)
    return [int(featurizer.featurize_batch_ragged(statuses[i:i + OP_ROWS],
                                                  row_bucket=OP_ROWS).units.shape[0])
            for i in range(0, len(statuses), OP_ROWS)]


def dispatch_costs(trace_path):
    """Host launches (kernels, cooperative kernels, graphs) and device
    copies by direction within each ``twtml.dispatch`` region of a
    ``--profileDir`` Chrome trace, in dispatch order."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    # the host's region (the trace repeats it on the device timeline as a
    # gpu_user_annotation)
    regions = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                     if e.get("name") == "twtml.dispatch" and e.get("ph") == "X"
                     and e.get("cat") == "user_annotation")
    copies = {e.get("args", {}).get("correlation"): e["name"] for e in events
              if e.get("cat") == "gpu_memcpy"}
    out = []
    for lo, hi in regions:
        calls = [e for e in events if e.get("cat") == "cuda_runtime"
                 and lo <= e.get("ts", -1) <= hi]
        launches = sum(e["name"].startswith(("cudaLaunch", "cudaGraphLaunch")) for e in calls)
        kinds = [copies.get(e.get("args", {}).get("correlation"), "") for e in calls]
        out.append({"launches": launches, "graph_launches": sum(
            e["name"] == "cudaGraphLaunch" for e in calls),
            "h2d": sum("HtoD" in k for k in kinds), "d2h": sum("DtoH" in k for k in kinds)})
    return out


def graph_memory(rec):
    """(allocated, reserved) bytes the run's model's CUDA graphs held: the
    card's figures with the graphs alive, less those once they (and the
    record's capture-time tensors) are released and the cache emptied."""
    import gc

    import torch

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    rec["model"]._graphs.clear()
    rec["raw"], rec["iterations"] = [], []
    gc.collect()
    torch.cuda.empty_cache()
    return held[0] - torch.cuda.memory_allocated(), held[1] - torch.cuda.memory_reserved()


def superbatch_arms(name, statuses, profile_dir=None):
    """The three arms over ``statuses`` under the sync-debug mode, held
    bitwise to the K = 1 arm (weights, each batch's predictions, stats and
    quality, the lines), then, given a ``profile_dir``, each arm again with
    ``--profileDir``: its launches and copies a dispatch. Returns the
    per-arm summaries."""
    import glob

    import numpy as np
    import torch

    from twtml_tpu_torch.apps.common import SYNC_DEBUG_ENV

    batches = len(statuses) // OP_ROWS
    runs = {}
    for arm, extra in SB_ARMS:
        os.environ[SYNC_DEBUG_ENV] = "error"
        try:
            totals, lines, rec = recorded_app_run([*SB_ARGV, *extra], 0,
                                                  source=prefilled_source(statuses))
        finally:
            del os.environ[SYNC_DEBUG_ENV]
        if arm != "K=1":
            rec["graph_memory"] = graph_memory(rec)
        warm = SB_K if arm != "K=1" else 0  # the warm-up's all-padding group
        if any(float(o.count) for o in rec["outputs"][:warm]):
            raise AssertionError(f"{name} {arm}: the warm-up group trained rows")
        rec["outputs"] = rec["outputs"][warm:]
        if (totals["batches"], len(rec["outputs"])) != (batches, batches):
            raise AssertionError(f"{name} {arm}: {totals['batches']} batches delivered, "
                                 f"{len(rec['outputs'])} outputs for {batches} fed")
        runs[arm] = (totals, lines, rec)
    _, ref_lines, ref = runs["K=1"]
    for arm, (totals, lines, rec) in runs.items():
        if lines != ref_lines or not np.array_equal(rec["weights"], ref["weights"]):
            raise AssertionError(f"{name} {arm}: lines or weights differ from K=1's")
        for i, (a, b) in enumerate(zip(rec["outputs"], ref["outputs"], strict=True)):
            for k in ("predictions", "quality", "count", "mse", "real_stdev", "pred_stdev"):
                if not torch.equal(getattr(a, k), getattr(b, k)):
                    raise AssertionError(f"{name} {arm} batch {i + 1}: {k} differs from K=1's")
    summary = {}
    for arm, extra in SB_ARMS:
        totals, _, rec = runs[arm]
        costs, profiled = [], ""
        if profile_dir is not None:
            out_dir = os.path.join(profile_dir, f"{name}-{arm}")
            ptotals, _, _ = recorded_app_run([*SB_ARGV, *extra, "--profileDir", out_dir], 0,
                                             source=prefilled_source(statuses))
            costs = dispatch_costs(glob.glob(os.path.join(out_dir, "*.pt.trace.json"))[0])
            profiled = f"; profiled run ({ptotals['stream_seconds']:.4f} s), "
        groups = [st.get("group", 1) for st in totals["steps"]]
        # host wall (dispatch + fetch wait) of each 8 consecutive batches:
        # a group's, or 8 plain steps'
        walls = [sum(st["dispatch_ms"] + st["fetch_wait_ms"]
                     for st in totals["steps"][i:i + SB_K])
                 for i in range(0, batches, SB_K)]
        rate = totals["count"] / totals["stream_seconds"]
        grouped = rec["groups"] - (1 if arm != "K=1" else 0)
        per = (costs if len(costs) <= batches // SB_K else
               [{k: sum(c[k] for c in costs[i:i + SB_K]) for k in costs[0]}
                for i in range(0, len(costs), SB_K)])
        if per:
            profiled += (("per dispatch" if per is costs else f"per {SB_K} dispatches") + ": "
                         + "; ".join(f"{c['launches']} launches ({c['graph_launches']} graph), "
                                     f"{c['h2d']} H2D, {c['d2h']} D2H" for c in per))
        phase("superbatch", f"{name} {arm}: {batches} batches, {grouped} group(s) of "
              f"{SB_K} dispatched ({sum(g > 1 for g in groups)} batches grouped), CUDA graphs "
              f"captured {rec['captured']} (the warm-up's included); host wall (dispatch + "
              f"fetch wait) each {SB_K} batches: "
              + ", ".join(f"{w:.3f} ms" for w in walls)
              + f" ({walls[-1] / SB_K:.3f} ms a batch in the last)"
              + ("" if arm == "K=1" else
                 "; the graphs held {:.1f} MB allocated, {:.1f} MB reserved".format(
                     *(b / 2**20 for b in rec["graph_memory"])))
              + "; whole stream "
              f"{totals['count']} tweets in {totals['stream_seconds']:.4f} s = {rate:.0f} "
              f"tweets/s" + profiled)
        host_ms = walls[-1] / SB_K
        summary[arm] = {"groups": grouped, "captured": rec["captured"],
                        "graph_memory_bytes": rec.get("graph_memory"),
                        "host_ms_a_batch_last": host_ms, "host_ms_each_8": walls,
                        "tweets_per_s": rate, "dispatch_costs": per}
    phase("superbatch", f"{name}: the three arms bitwise equal over {batches} batches "
          "(weights, predictions, stats, quality, lines), every dispatch under "
          "set_sync_debug_mode('error')")
    return summary


def superbatch_phase(stream_statuses, smi):
    """``--superBatch 8`` on the group wire, the stacked wire and K = 1,
    three arms held bitwise equal: first over the stream phase's 8 batches,
    whose ragged units buckets decide which of them may group; then over 8
    batches of one units bucket (SyntheticSource seed 3, batches 2-9, each
    bucket checked) fed twice, so the first group captures its CUDA graph
    and the second replays it."""
    import tempfile

    from twtml_tpu_torch.streaming.sources import SyntheticSource

    t_phase = time.perf_counter()
    phase("superbatch", f"stream phase's batches: units buckets {units_buckets(stream_statuses)} "
          f"(groups form only of consecutive batches of one bucket) | card: {smi}")
    pool = list(SyntheticSource(total=9 * OP_ROWS, seed=3, base_ms=NOW_MS).produce())[OP_ROWS:]
    buckets = units_buckets(pool)
    if len(set(buckets)) != 1:
        raise AssertionError(f"superbatch: the replay batches' units buckets differ: {buckets}")
    first = superbatch_arms("stream", stream_statuses)
    with tempfile.TemporaryDirectory() as tmp:
        replay = superbatch_arms("one-bucket x2", pool + pool, tmp)
    if replay["group"]["captured"] < 2 or replay["group"]["groups"] != 2:
        raise AssertionError(f"superbatch: the one-bucket stream ran {replay['group']}")
    phase("superbatch", f"phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"stream": first, "one_bucket": replay}


KMEANS_BATCHES = 4
KMEANS_ARGV = ["--source", "synthetic", "--seconds", "0", "--batchBucket", str(OP_ROWS)]
KMEANS_RTOL = 1e-5


def kmeans_run(backend, statuses):
    """``apps/kmeans.py`` on ``backend`` over a pre-filled source: (totals,
    lines, the model, each batch's assignments on the host)."""
    from twtml_tpu_torch.apps import kmeans
    from twtml_tpu_torch.config import ConfArguments
    from twtml_tpu_torch.models.kmeans import StreamingKMeans

    rec = {"assign": []}
    base_update, base_source = StreamingKMeans.update_device, kmeans.build_source

    def update_device(self, points, mask=None):
        assign = base_update(self, points, mask)
        rec["assign"].append(assign.cpu().numpy())
        rec["model"] = self
        return assign

    StreamingKMeans.update_device = update_device
    kmeans.build_source = lambda conf: prefilled_source(statuses)
    out = io.StringIO()
    try:
        conf = ConfArguments().parse(["--backend", backend, *KMEANS_ARGV, "--lightning",
                                      RECORDER.url, "--twtweb", RECORDER.url])
        with contextlib.redirect_stdout(out):
            totals = kmeans.run(conf, max_batches=KMEANS_BATCHES)
    finally:
        StreamingKMeans.update_device, kmeans.build_source = base_update, base_source
    return totals, out.getvalue().splitlines(), rec


def kmeans_phase(smi):
    """``apps/kmeans.py`` on the card: 4 batches of 16384 retweets from a
    pre-filled source against the ``--backend cpu`` twin: the initial
    centers bitwise the CPU's draw, centers and weights within KMEANS_RTOL,
    assignments and sizes (the lines' ``sizes``) equal."""
    import numpy as np

    from twtml_tpu_torch.models.kmeans import StreamingKMeans
    from twtml_tpu_torch.streaming.sources import SyntheticSource

    t_phase = time.perf_counter()
    card0 = StreamingKMeans(device="cuda").set_k(3).set_random_centers(2, 0.0).latest_centers
    cpu0 = StreamingKMeans(device="cpu").set_k(3).set_random_centers(2, 0.0).latest_centers
    if not np.array_equal(card0.view(np.int32), cpu0.view(np.int32)):
        raise AssertionError(f"kmeans: initial centers on the card {card0} differ from the "
                             f"CPU's {cpu0}")
    phase("kmeans", f"initial centers (normal(PRNGKey(0), (3, 2)) on the card) "
          f"{card0.tolist()}: bitwise equal to the CPU draw")
    statuses = list(SyntheticSource(total=KMEANS_BATCHES * OP_ROWS, seed=13,
                                    base_ms=NOW_MS).produce())
    t0 = time.perf_counter()
    totals, lines, rec = kmeans_run("cuda", statuses)
    wall = time.perf_counter() - t0
    ctotals, clines, crec = kmeans_run("cpu", statuses)
    RECORDER.take()
    model, cmodel = rec["model"], crec["model"]
    if model.device.type != "cuda" or totals["batches"] != KMEANS_BATCHES:
        raise AssertionError(f"kmeans: {totals['batches']} batches on {model.device}")
    sizes = [ln.split("sizes: ")[1] for ln in lines]
    csizes = [ln.split("sizes: ")[1] for ln in clines]
    for i, (a, b) in enumerate(zip(rec["assign"], crec["assign"], strict=True)):
        if not np.array_equal(a, b):
            raise AssertionError(f"kmeans batch {i + 1}: {int((a != b).sum())} assignments "
                                 "differ from the CPU twin's")
    c_err = float(np.max(np.abs(model.latest_centers - cmodel.latest_centers)
                         / np.maximum(np.abs(cmodel.latest_centers), 1e-30)))
    w_err = float(np.max(np.abs(model.latest_weights - cmodel.latest_weights)
                         / np.maximum(np.abs(cmodel.latest_weights), 1e-30)))
    if sizes != csizes or c_err > KMEANS_RTOL or w_err > KMEANS_RTOL:
        raise AssertionError(f"kmeans: sizes {sizes} / {csizes}, centers {c_err:.3g}, "
                             f"weights {w_err:.3g} against the CPU twin")
    for line in lines:
        phase("kmeans", line)
    phase("kmeans", f"{KMEANS_BATCHES} batches of {OP_ROWS} retweets on the card ("
          f"{totals['count']} points, {wall:.3f} s for the run); against the --backend "
          f"cpu twin: assignments and sizes equal, centers {c_err:.3g}, weights "
          f"{w_err:.3g} relative (tolerance {KMEANS_RTOL:g}); final weights "
          f"{model.latest_weights.tolist()}; phase wall {time.perf_counter() - t_phase:.1f} s "
          f"| card: {smi}")
    return {"centers_err": c_err, "weights_err": w_err, "seconds": wall}


# ---- the 2^18 sparse regime (BASELINE config #4) ----------------------------

SPARSE_BATCHES = 4
SPARSE_ARGV = ["--source", "synthetic", "--seconds", "0", "--batchBucket", str(GRAM_ROWS),
               "--numTextFeatures", str(GRAM_F), "--l2Reg", "0.1", "--maxQueueRows", "-1"]
GATE_MISS_ROWS = 16384  # 16384 x 2^18 x 4 B = 16 GiB of f32 counts: over the gate
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak


# tweet-length rows for the f32-count planes: each batch's (shortest,
# longest) row in code units. A row of n units holds n - 1 bigrams, so the
# longest row picks the plane: 256 units (mass 255) bf16, 280 exact, 128
# (mass 127) int8
LONG_SPANS = ((140, 256), (140, 280), (100, 128), (140, 280))
LONG_PLANES = ("bf16", "exact", "int8", "exact")


def long_statuses(spans, rows, seed):
    """``rows`` retweets for each (shortest, longest) span of code units in
    ``spans``: ASCII text cut from a seeded stream of words of 2-9 letters
    and digits, each row's length uniform in its span and each batch's first
    row at the longest (which fixes the batch's plane); the retweet count
    linear in followers and text length, as SyntheticSource makes it."""
    import numpy as np

    from twtml_tpu_torch.features.featurizer import Status

    rng = np.random.default_rng(seed)
    chars = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789"))
    vocab = ["".join(rng.choice(chars, size=int(n))) for n in rng.integers(2, 10, 4096)]
    corpus = " ".join(vocab[i] for i in rng.integers(0, len(vocab), 40_000).tolist())
    out = []
    for lo, hi in spans:
        lengths = rng.integers(lo, hi + 1, rows)
        lengths[0] = hi
        starts = rng.integers(0, len(corpus) - hi, rows)
        followers = rng.integers(100, 2_000_000, rows)
        noise = rng.normal(0, 20, rows)
        ages = rng.integers(0, 86_400_000, rows)
        for n, at, fo, e, age in zip(lengths, starts, followers, noise, ages):
            text = corpus[at:at + n]
            label = int(np.clip(100 + fo * 4e-4 + n * 2 + e, 100, 1000))
            original = Status(text=text, retweet_count=label, followers_count=int(fo),
                              favourites_count=int(fo % 50_000),
                              friends_count=int(fo % 10_000),
                              created_at_ms=NOW_MS - int(age))
            out.append(Status(text="RT " + text, retweeted_status=original))
    return out


def scatter_learner():
    """The linear learner forced onto the scatter loop (``use_gram=False``):
    the JAX package's own differential baseline for the Gram route."""
    from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD

    class Scatter(StreamingLinearRegressionWithSGD):
        def __init__(self, *a, **k):
            super().__init__(*a, use_gram=False, **k)

    return Scatter


def sparse_run(name, backend, statuses, batches, extra=(), learner=None):
    """``batches`` batches of ``statuses`` through the flagship app at 2^18
    (a pre-filled source; on cuda every dispatch under the sync-debug mode
    "error"): (totals, lines, record)."""
    from twtml_tpu_torch.apps.common import SYNC_DEBUG_ENV

    if backend == "cuda":
        os.environ[SYNC_DEBUG_ENV] = "error"
    try:
        totals, lines, rec = recorded_app_run(
            ["--backend", backend, *SPARSE_ARGV, *extra], batches,
            source=prefilled_source(statuses), learner=learner)
    finally:
        os.environ.pop(SYNC_DEBUG_ENV, None)
    if totals["batches"] != batches or rec["launches"] != 0:
        raise AssertionError(f"sparse {name}: {totals['batches']} batches, fused_dense_sgd "
                             f"launched {rec['launches']} times")
    return totals, lines, rec


def hold_run(name, run, ref):
    """Weights within WEIGHT_RTOL (atol scaled by max(1, max|w|)), each
    batch's count equal and other stats within RTOL, predictions equal but
    for HALF_UP flips (|difference| 1, where the two margins straddle a
    .5). Returns (weights max abs err, stats max rel err, flips)."""
    import numpy as np

    (totals, _, rec), (rtotals, _, rref) = run, ref
    w, rw = rec["weights"], rref["weights"]
    atol = WEIGHT_RTOL * max(1.0, float(np.abs(rw).max()))
    w_err = float(np.abs(w - rw).max())
    if not (np.abs(w - rw) <= atol + WEIGHT_RTOL * np.abs(rw)).all():
        raise AssertionError(f"sparse {name}: weights differ by {w_err:.3e}")
    s_err = 0.0
    for i, (a, b) in enumerate(zip(totals["steps"], rtotals["steps"], strict=True)):
        if a["count"] != b["count"]:
            raise AssertionError(f"sparse {name} batch {i + 1}: count {a['count']} vs "
                                 f"{b['count']}")
        for k in ("mse", "real_stdev", "pred_stdev"):
            err = abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
            if err > RTOL:
                raise AssertionError(f"sparse {name} batch {i + 1} {k}: {a[k]} vs {b[k]}")
            s_err = max(s_err, err)
    flips = 0
    for i, (a, b) in enumerate(zip(rec["outputs"], rref["outputs"], strict=True)):
        d = np.abs(a.predictions.cpu().numpy() - b.predictions.cpu().numpy())
        if (d > 1.0).any() or ((d > 0) & (d < 1.0)).any():
            raise AssertionError(f"sparse {name} batch {i + 1}: predictions differ by up "
                                 f"to {d.max()}")
        flips += int((d > 0).sum())
    if flips > 8:  # 8 of 8,192 rows
        raise AssertionError(f"sparse {name}: {flips} predictions differ (HALF_UP flips)")
    return w_err, s_err, flips


def sparse_phase(smi):
    """Config #4 through the app at F = 2^18, B = 2048, 50 iterations, L2
    0.1, the ragged packed wire at depth 8, model watch on: 4 back-to-back
    batches on the Gram route (B4, B7 and B8 once a batch and once for the
    warm-up, B1 never, no dispatch syncing the host), held against the same
    batches on the card's scatter route and on the CPU twin; one batch at
    B = 16384 (a gate miss: the scatter loop) against its CPU twin; whether
    the card's scatter loop reruns bitwise; ``--superBatch 4`` (a CUDA graph
    of the Gram route, replayed) bitwise equal to K = 1; where a step's time
    goes, on the short synthetic tweets (the int8 plane) and on tweet-length
    rows (the f32-count planes: 4 batches through the app against the CPU
    twin, each batch's plane asserted)."""
    import numpy as np

    from twtml_tpu_torch.ops.gram import PLANE_NAMES
    from twtml_tpu_torch.streaming.sources import SyntheticSource

    t_phase = time.perf_counter()
    statuses = list(SyntheticSource(total=SPARSE_BATCHES * GRAM_ROWS, seed=11,
                                    base_ms=NOW_MS).produce())
    gram_run = sparse_run("gram", "cuda", statuses, SPARSE_BATCHES)
    totals, lines, rec = gram_run
    want = {"count_build": SPARSE_BATCHES + 1, "dual_sgd": SPARSE_BATCHES + 1,
            "dual_writeback_counts": SPARSE_BATCHES + 1}
    if rec["gram_launches"] != want or rec["model"].route != "gram":
        raise AssertionError(f"sparse: route {rec['model'].route}, launches "
                             f"{rec['gram_launches']}, want {want} (4 batches + the warm-up)")
    for line, st in zip(lines, totals["steps"]):
        phase("sparse", f"{line} | step {st['step_ms']:.3f} ms (CUDA events), dispatch "
              f"{st['dispatch_ms']:.3f} ms, featurize {st['featurize_ms']:.2f} ms, fetch "
              f"wait {st['fetch_wait_ms']:.3f} ms")
    scatter = sparse_run("scatter", "cuda", statuses, SPARSE_BATCHES,
                         learner=scatter_learner())
    if any(scatter[2]["gram_launches"].values()) or scatter[2]["model"].route != "scatter":
        raise AssertionError(f"sparse scatter: {scatter[2]['gram_launches']}")
    phase("sparse", "scatter route (use_gram=False) on the card, step ms (CUDA events): "
          + ", ".join(f"{st['step_ms']:.3f}" for st in scatter[0]["steps"]))
    cpu = sparse_run("cpu twin", "cpu", statuses, SPARSE_BATCHES)
    held = {what: hold_run(what, gram_run, ref)
            for what, ref in (("card scatter route", scatter), ("cpu twin", cpu))}
    RECORDER.take()
    for what, (w_err, s_err, flips) in held.items():
        phase("sparse", f"Gram route against the {what}: weights max abs err {w_err:.3e} "
              f"(tolerance rtol {WEIGHT_RTOL}, atol {WEIGHT_RTOL}*max(1, max|w|)), stats "
              f"{s_err:.3e} (rtol {RTOL}), {flips} HALF_UP prediction flips of "
              f"{SPARSE_BATCHES * GRAM_ROWS}")
    phase("sparse", f"{SPARSE_BATCHES} batches of {GRAM_ROWS} at F = {GRAM_F} on the Gram "
          f"route (each batch's plane from host metadata), every "
          f"dispatch under set_sync_debug_mode('error'); launches {rec['gram_launches']} "
          f"(4 batches + the warm-up), fused_dense_sgd {rec['launches']}; app wall "
          f"{rec['wall_s']:.3f} s, scatter route {scatter[2]['wall_s']:.3f} s")

    # tweet-length rows: past 128 code units a batch leaves the int8 plane
    # for f32 counts (B4 writes f32 C, the G product is an f32 matmul, B8
    # reads f32 C); the same app and kernels, held against the CPU twin
    long = long_statuses(LONG_SPANS, GRAM_ROWS, seed=14)
    long_run = sparse_run("long tweets", "cuda", long, SPARSE_BATCHES)
    long_planes = tuple(PLANE_NAMES[p] for (p,) in long_run[2]["planes"])
    if long_planes != LONG_PLANES or long_run[2]["gram_launches"] != want:
        raise AssertionError(f"sparse long tweets: planes {long_planes} (want {LONG_PLANES}), "
                             f"launches {long_run[2]['gram_launches']} (want {want})")
    long_cpu = sparse_run("long tweets cpu twin", "cpu", long, SPARSE_BATCHES)
    RECORDER.take()
    l_w, l_s, l_flips = hold_run("long tweets", long_run, long_cpu)
    for line, st, pl, (lo, hi) in zip(long_run[1], long_run[0]["steps"], long_planes,
                                      LONG_SPANS):
        phase("sparse", f"long tweets ({lo}-{hi} code units, {pl} plane): {line} | step "
              f"{st['step_ms']:.3f} ms (CUDA events), dispatch {st['dispatch_ms']:.3f} ms")
    phase("sparse", f"long tweets: {SPARSE_BATCHES} batches of {GRAM_ROWS} through the app on "
          f"the Gram route, planes {long_planes} from host metadata, launches "
          f"{long_run[2]['gram_launches']}; against the CPU twin: weights {l_w:.3e}, stats "
          f"{l_s:.3e}, {l_flips} flips; app wall {long_run[2]['wall_s']:.3f} s")

    # --superBatch 4 on the padded wire with one row length (8 batches, 2
    # groups of one signature): a group replays a CUDA graph holding B4, the
    # G product, B7 and B8; bitwise equal to K = 1
    more = statuses + list(SyntheticSource(total=SPARSE_BATCHES * GRAM_ROWS, seed=13,
                                           base_ms=NOW_MS).produce())
    padded = ["--wire", "padded", "--tokenBucket", "64"]
    one = sparse_run("superbatch K=1", "cuda", more, 2 * SPARSE_BATCHES, padded)
    sb = sparse_run("superbatch", "cuda", more, 2 * SPARSE_BATCHES,
                    [*padded, "--superBatch", str(SPARSE_BATCHES)])
    # the warm-up's step, then its group of 4 (eager, then captured) and the
    # two groups of real batches (replays of one signature, or an eager run
    # and a replay): 1 + 4 + 4 + 4 launches of each kernel
    want_sb = {k: 1 + 3 * SPARSE_BATCHES for k in want}
    warm = sb[2]["outputs"][:SPARSE_BATCHES]  # the warm-up's all-padding group
    sb[2]["outputs"] = sb[2]["outputs"][SPARSE_BATCHES:]
    if any(float(o.count) for o in warm):
        raise AssertionError("sparse superbatch: the warm-up group trained rows")
    if sb[2]["gram_launches"] != want_sb or sb[2]["groups"] != 3 or sb[2]["captured"] < 1:
        raise AssertionError(f"sparse superbatch: launches {sb[2]['gram_launches']} (want "
                             f"{want_sb}), {sb[2]['groups']} groups (want the warm-up's + 2), "
                             f"{sb[2]['captured']} graphs")
    if not np.array_equal(sb[2]["weights"], one[2]["weights"]) or any(
            not np.array_equal(a.predictions.cpu().numpy(), b.predictions.cpu().numpy())
            for a, b in zip(sb[2]["outputs"], one[2]["outputs"], strict=True)):
        raise AssertionError("sparse superbatch: differs from K = 1")
    RECORDER.take()
    phase("sparse", f"--superBatch {SPARSE_BATCHES} --wire padded --tokenBucket 64, 8 "
          f"batches: 2 groups, "
          f"{sb[2]['captured']} CUDA graph(s) captured (the second group replays), launches "
          f"{sb[2]['gram_launches']}; weights and predictions bitwise equal to K = 1")

    # a gate miss: B = 16384 runs the scatter loop, on the card and the CPU
    big = list(SyntheticSource(total=GATE_MISS_ROWS, seed=12, base_ms=NOW_MS).produce())
    miss_argv = ["--batchBucket", str(GATE_MISS_ROWS)]
    miss = sparse_run("gate miss", "cuda", big, 1, miss_argv)
    if any(miss[2]["gram_launches"].values()):
        raise AssertionError(f"sparse gate miss: {miss[2]['gram_launches']}")
    miss_cpu = sparse_run("gate miss cpu twin", "cpu", big, 1, miss_argv)
    RECORDER.take()
    m_w, m_s, m_flips = hold_run("gate miss", miss, miss_cpu)
    phase("sparse", f"gate miss B={GATE_MISS_ROWS}: the scatter loop (B4/B7/B8 launches "
          f"{miss[2]['gram_launches']}), against the CPU twin: weights {m_w:.3e}, stats "
          f"{m_s:.3e}, {m_flips} flips; step {miss[0]['steps'][0]['step_ms']:.2f} ms")
    breakdown = sparse_breakdown(statuses)
    long_breakdown = sparse_breakdown(long, scatter_check=False)
    phase("sparse", f"phase wall {time.perf_counter() - t_phase:.1f} s | card: {smi}")
    return {"launches": rec["gram_launches"],
            "held": {k: {"weights_abs_err": v[0], "stats_rel_err": v[1], "flips": v[2]}
                     for k, v in held.items()},
            "gate_miss": {"weights_abs_err": m_w, "stats_rel_err": m_s, "flips": m_flips},
            "superbatch": {"launches": sb[2]["gram_launches"], "graphs": sb[2]["captured"]},
            "scatter_step_ms": [st["step_ms"] for st in scatter[0]["steps"]],
            "step_ms": [st["step_ms"] for st in totals["steps"]],
            "long": {"planes": long_planes, "weights_abs_err": l_w, "stats_rel_err": l_s,
                     "flips": l_flips,
                     "step_ms": [st["step_ms"] for st in long_run[0]["steps"]]},
            "breakdown": breakdown, "long_breakdown": long_breakdown}


def sparse_breakdown(statuses, scatter_check=True):
    """Where one Gram step's time goes, on batch 2 of ``statuses``
    (padded wire, on the card, from the weights batch 1 left): each piece's
    device time (CUDA events, work queued ahead), the whole step's device
    busy time and launches (profiler), its wall with the host's enqueue,
    and the device's idle share of that wall; with ``scatter_check``,
    whether two runs of the scatter loop on the same inputs are bitwise
    equal."""
    import torch

    from twtml_tpu_torch.apps.common import build_model
    from twtml_tpu_torch.config import ConfArguments
    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.models.sgd import batch_to_device, sparse_sgd_loop
    from twtml_tpu_torch.ops import fused_gram
    from twtml_tpu_torch.ops.gram import PLANE_INT8, PLANE_NAMES
    from twtml_tpu_torch.ops.quality import quality_vector
    from twtml_tpu_torch.ops.sparse import sparse_predict
    from twtml_tpu_torch.ops.stats import batch_stats
    from twtml_tpu_torch.ops.text_hash import hash_bigrams_device
    from twtml_tpu_torch.utils.rounding import torch_round_half_up

    featurizer = Featurizer(now_ms=NOW_MS, num_text_features=GRAM_F)
    batches = [featurizer.featurize_batch_units(statuses[i:i + GRAM_ROWS], row_bucket=GRAM_ROWS)
               for i in (0, GRAM_ROWS)]
    model = build_model(ConfArguments().parse(["--backend", "cuda", *SPARSE_ARGV]))
    float(model.step(batches[0]).mse)
    (plane,) = model.planes(batches[1])
    w = model._weights
    dev = batch_to_device(batches[1], "cuda", non_blocking=False)
    idx, val = hash_bigrams_device(dev.units, dev.length, GRAM_F)
    num, y, m = dev.numeric, dev.label, dev.mask
    f = GRAM_F
    kw = dict(num_iterations=OP_ITERS, step_size=0.005, l2_reg=0.1, convergence_tol=0.001)
    raw = sparse_predict(w[:f], w[f:], idx, val, num)
    counts = fused_gram.count_build(idx, val, f, int8=plane == PLANE_INT8)
    g = fused_gram.gram_from_counts(counts)
    g[:GRAM_ROWS, :GRAM_ROWS] += num @ num.T
    p_prev = torch.sum(w * w)
    c, alpha, its = fused_gram.dual_sgd(g, raw, y, m, p_prev=p_prev, **kw)

    def add_numeric():
        gg = fused_gram.gram_from_counts(counts)
        gg[:GRAM_ROWS, :GRAM_ROWS] += num @ num.T

    w_new = fused_gram.dual_writeback_counts(w, c, alpha, counts, num, f)

    def quality():  # the step's HALF_UP rounding, stats and quality vector
        preds = torch_round_half_up(raw)
        batch_stats(y, preds, m)
        quality_vector(w, w_new, residual=(raw - y) * m, preds=preds, labels=y, mask=m,
                       numeric=num, token_idx=idx, token_val=val)

    pieces = {
        "hash (units -> tokens)": lambda: hash_bigrams_device(dev.units, dev.length, f),
        "gather predict": lambda: sparse_predict(w[:f], w[f:], idx, val, num),
        "B4 count build": lambda: fused_gram.count_build(idx, val, f, int8=plane == PLANE_INT8),
        "G product (+ N·Nᵀ)": add_numeric,
        "B7 dual loop": lambda: fused_gram.dual_sgd(g, raw, y, m, p_prev=p_prev, **kw),
        "B8 write-back": lambda: fused_gram.dual_writeback_counts(w, c, alpha, counts, num, f),
        "rounding + stats + quality": quality,
    }
    times = {}
    for name, fn in pieces.items():
        fn()
        # a piece of many small launches is queued whole before the device
        # starts it, so its time is the device's, not the host's enqueue
        times[name] = timed(fn, 10, queue_ahead=True, ahead_cycles=STEP_AHEAD_CYCLES)[0]
    step = lambda: model._train_step(w, dev, plane=plane)  # noqa: E731
    step_ms, busy, launches = device_costs(step, 5)
    wall_ms = timed(step, 5)[0]
    idle = max(0.0, 1.0 - busy / wall_ms)
    phase("sparse", f"one Gram step of batch 2 (B={GRAM_ROWS}, {PLANE_NAMES[plane]} plane, "
          f"{int(its)} dual iterations run), device ms by piece (CUDA events, queued "
          "ahead, median of 10): " + "; ".join(f"{k} {v:.4f}" for k, v in times.items()))
    phase("sparse", f"the whole step: {step_ms:.3f} ms device (queued ahead), {busy:.3f} ms "
          f"device busy (profiler), {launches:g} kernel launches, {wall_ms:.3f} ms wall with "
          f"the host's enqueue: device idle {idle:.1%} of it")
    out = {"pieces_ms": times, "step_ms": step_ms, "busy_ms": busy, "launches": launches,
           "wall_ms": wall_ms, "idle": idle, "plane": PLANE_NAMES[plane],
           "dual_iterations": int(its)}
    if not scatter_check:
        return out
    # the scatter loop's reproducibility on the card (index_add_: float atomics)
    w1 = sparse_sgd_loop(w, idx, val, num, y, m, num_text_features=f, **kw)
    w2 = sparse_sgd_loop(w, idx, val, num, y, m, num_text_features=f, **kw)
    bitwise = bool(torch.equal(w1, w2))
    phase("sparse", f"scatter loop run twice on the same batch on the card: "
          f"{'bitwise equal' if bitwise else 'NOT bitwise equal'} (max abs difference "
          f"{(w1 - w2).abs().max().item():.3e})")
    return dict(out, scatter_bitwise=bitwise)


def bincount_ms(idx, val, rows, cols):
    """``torch.bincount`` of the flat (row, index) pairs weighted by the
    values, at ``minlength`` rows·cols: the dense counts in one PyTorch call
    (float32 for float32 weights; it sizes its output from max(index), a
    device-to-host read). Median device time of 10, queued ahead; and its
    output's dtype."""
    import torch

    flat = (torch.arange(idx.shape[0], device=idx.device)[:, None] * cols + idx).reshape(-1)
    w = val.reshape(-1)
    call = lambda: torch.bincount(flat, weights=w, minlength=rows * cols)  # noqa: E731
    dtype = str(call().dtype)
    return timed(call, 10, queue_ahead=True)[0], dtype


def f32_build_times(smi):
    """B4's f32 build on tweet-length rows: batch 2 of the sparse phase's
    ``long_statuses`` (140-280 code units, the exact plane), device-hashed at
    B = 2048 x 2^18: (a) the kernel on those tokens, (b) the same shape with
    every index out of range (only the zero-fill, the token staging and the
    sort), (c) ``torch.bincount``; its twin, its bound; the counts bitwise
    the CPU twin's and a rerun's, and the CPU twin's with the indices taken
    mod 1024 (crowded steps)."""
    import torch

    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.models.sgd import batch_to_device
    from twtml_tpu_torch.ops import fused_gram
    from twtml_tpu_torch.ops.text_hash import hash_bigrams_device

    tweets = long_statuses(LONG_SPANS, GRAM_ROWS, seed=14)[GRAM_ROWS:2 * GRAM_ROWS]
    host = Featurizer(now_ms=NOW_MS, num_text_features=GRAM_F).featurize_batch_units(
        tweets, row_bucket=GRAM_ROWS)
    dev = batch_to_device(host, "cuda", non_blocking=False)
    idx, val = hash_bigrams_device(dev.units, dev.length, GRAM_F)
    b, l = idx.shape
    f = GRAM_F
    build = lambda i: fused_gram.count_build(i, val, f, int8=False)  # noqa: E731
    c = build(idx)
    rows, cols = c.shape
    again = build(idx)
    twin = fused_gram.count_build_reference(idx.cpu(), val.cpu(), f, int8=False,
                                            rows_out=rows, cols_out=cols)
    card_twin = fused_gram.count_build_reference(idx, val, f, int8=False, rows_out=rows,
                                                 cols_out=cols)
    torch.cuda.synchronize()
    if not torch.equal(bits(c), bits(again)):
        raise AssertionError("count_build f32 L=511: reruns are not bitwise equal")
    if not torch.equal(bits(c).cpu(), bits(twin)):
        raise AssertionError("count_build f32 L=511: differs bitwise from the CPU twin")
    card_twin_bitwise = bool(torch.equal(bits(c), bits(card_twin)))
    del again, twin, card_twin
    # every row's keys in the first 1024 columns: steps (32 chunks) that hold
    # more keys than a warp's window of 32
    crowded = build(idx % 1024)
    crowded_twin = fused_gram.count_build_reference((idx % 1024).cpu(), val.cpu(), 1024,
                                                    int8=False, rows_out=rows)
    if (not torch.equal(bits(crowded[:, :1024]).cpu(), bits(crowded_twin))
            or bool(crowded[:, 1024:].any())):
        raise AssertionError("count_build f32 L=511, crowded steps: differs bitwise from the "
                             "CPU twin")
    del crowded, crowded_twin
    oor = torch.full_like(idx, f)  # every index out of range: nothing counts
    if bool(build(oor).any()):
        raise AssertionError("count_build f32: an out-of-range index was counted")
    a_ms, a_all = timed(lambda: build(idx), 25, queue_ahead=True)
    b_ms, b_all = timed(lambda: build(oor), 25, queue_ahead=True)
    lib_ms, lib_dtype = bincount_ms(idx, val, rows, cols)
    twin_ms, _ = timed(lambda: fused_gram.count_build_reference(
        idx, val, f, int8=False, rows_out=rows, cols_out=cols), 5)
    io_bytes = rows * cols * 4 + b * l * 8
    bound_ms = io_bytes / HBM_BYTES_PER_S * 1e3
    phase("times", f"B4 f32 build on tweet-length rows (card: {smi}): B={b} L={l} F={f}, C "
          f"{rows} x {cols} f32; (a) tokens: median {a_ms:.4f} ms over 25 (min "
          f"{min(a_all):.4f}); (b) every index out of range: {b_ms:.4f} ms (min "
          f"{min(b_all):.4f}); (a) - (b) = {a_ms - b_ms:.4f} ms; rows crowded into 1024 columns "
          f"bitwise the CPU twin; (c) torch.bincount "
          f"({lib_dtype}): {lib_ms:.4f} ms; twin {twin_ms:.4f} ms; bound {io_bytes} B / "
          f"3.35e12 B/s = {bound_ms:.5f} ms "
          f"(bytes), the kernel at {bound_ms / a_ms:.0%} of it; counts bitwise the CPU "
          f"twin's and a rerun's (the card's twin: "
          f"{'bitwise' if card_twin_bitwise else 'NOT bitwise'})")
    return {"ms": a_ms, "tokens": l,
            "out_of_range_ms": b_ms, "token_pass_ms": a_ms - b_ms, "plain_ms": twin_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib_ms,
            "library_call": "torch.bincount", "library_dtype": lib_dtype,
            "bitwise_cpu_twin": True, "bitwise_card_twin": card_twin_bitwise,
            "rerun_bitwise": True}


def gram_times(smi, errs, launches):
    """B4, the G product, B7 and B8 at config #4's operating point (B = 2048
    synthetic tweets at F = 2^18, device-hashed, the int8 plane): each
    kernel alone as device time, its twin, its bound, the library call where
    one exists; the kernels line's records."""
    import numpy as np
    import torch

    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.models.sgd import batch_to_device, host_planes
    from twtml_tpu_torch.ops import fused_gram
    from twtml_tpu_torch.ops.gram import PLANE_INT8, PLANE_NAMES
    from twtml_tpu_torch.ops.sparse import sparse_predict
    from twtml_tpu_torch.ops.text_hash import hash_bigrams_device
    from twtml_tpu_torch.streaming.sources import SyntheticSource

    tweets = list(SyntheticSource(total=GRAM_ROWS, seed=11, base_ms=NOW_MS).produce())
    host = Featurizer(now_ms=NOW_MS, num_text_features=GRAM_F).featurize_batch_units(
        tweets, row_bucket=GRAM_ROWS)
    (plane,) = host_planes(host)
    dev = batch_to_device(host, "cuda", non_blocking=False)
    idx, val = hash_bigrams_device(dev.units, dev.length, GRAM_F)
    b, l = idx.shape
    f = GRAM_F
    int8 = plane == PLANE_INT8
    w = torch.from_numpy((np.random.default_rng(5).normal(size=f + 4) * 1e-3)
                         .astype(np.float32)).cuda()
    num, y, m = dev.numeric, dev.label, dev.mask

    def record(name, source_line, ms, twin_ms, bound, extra):
        bytes_ms, ops_ms = bound
        return dict({
            "name": name, "route": "cuda", "source": "twtml_tpu_torch/csrc/gram.cu",
            "replaces": source_line, "tpu_function": None,
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": twin_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
        }, **extra)

    # B4
    counts = fused_gram.count_build(idx, val, f, int8=int8)
    rows, cols = counts.shape
    b4_ms, b4_all = timed(lambda: fused_gram.count_build(idx, val, f, int8=int8), 25,
                          queue_ahead=True)
    b4_twin, _ = timed(lambda: fused_gram.count_build_reference(
        idx, val, f, int8=int8, rows_out=rows, cols_out=cols), 5)
    b4_bytes = rows * cols * counts.element_size() + b * l * 8
    b4_bound = (b4_bytes / HBM_BYTES_PER_S * 1e3, 0.0)
    b4_lib, b4_lib_dtype = bincount_ms(idx, val, rows, cols)
    # the G product: torch._int_mm (s8 x s8 -> s32) and the f32 cast
    mm_ms, _ = timed(lambda: torch._int_mm(counts, counts.t()), 10, queue_ahead=True)
    g_ms, _ = timed(lambda: fused_gram.gram_from_counts(counts), 10, queue_ahead=True)
    mm_ops = 2 * rows * rows * cols
    mm_bound = max(mm_ops / INT8_OPS_PER_S, (rows * cols + rows * rows * 4) / HBM_BYTES_PER_S) * 1e3
    counts_f32 = counts.float()
    f32_ms, _ = timed(lambda: counts_f32 @ counts_f32.t(), 3, queue_ahead=True)
    del counts_f32
    phase("times", f"B4 count build at B={b} L={l} F={f} ({PLANE_NAMES[plane]} plane, "
          f"C {tuple(counts.shape)} {counts.dtype}): median {b4_ms:.4f} ms over 25 (min "
          f"{min(b4_all):.4f}); twin {b4_twin:.4f} ms; torch.bincount ({b4_lib_dtype} counts) {b4_lib:.4f} ms; bound "
          f"{b4_bytes} B / 3.35e12 B/s = {b4_bound[0]:.5f} ms (bytes); "
          f"{b4_ms / b4_bound[0]:.1f}x | card: {smi}")
    f32_build = f32_build_times(smi)
    phase("times", f"G product: torch._int_mm {tuple(counts.shape)} x its transpose "
          f"{mm_ms:.4f} ms (with the f32 cast {g_ms:.4f}); bound {mm_ops} int8 operations / "
          f"1979e12 = {mm_bound:.5f} ms ({mm_ms / mm_bound:.1f}x); the f32 planes' f32 matmul "
          f"at the same shape {f32_ms:.3f} ms")
    # B7 at the app's tolerance and with every iteration run
    g = fused_gram.gram_from_counts(counts)
    g[:b, :b] += num @ num.T
    raw = sparse_predict(w[:f], w[f:], idx, val, num)
    p_prev = torch.sum(w * w)
    kw = dict(num_iterations=OP_ITERS, step_size=0.005, l2_reg=0.1)
    b7 = {}
    for tol in (0.001, 0.0):
        call = lambda: fused_gram.dual_sgd(g, raw, y, m, p_prev=p_prev,  # noqa: E731
                                           convergence_tol=tol, **kw)
        _, _, its = call()
        b7[tol] = timed(call, 25, queue_ahead=True) + (int(its),)
    b7_twin, _ = timed(lambda: fused_gram.dual_sgd_reference(
        g, raw, y, m, p_prev=p_prev, convergence_tol=0.001, **kw), 5)
    plan = fused_gram.dual_plan(b, **sm_limits())
    its = b7[0.001][2]
    # each iteration needs one product, G·α_new (2·B² flops: G·Δα is its
    # difference with the last one, though the kernel computes both), and
    # ~12·B elementwise (residual, α update, the four dot products); G read once
    b7_ops = its * (2 * b * b + 12 * b)
    b7_bytes = b * b * 4 + 5 * b * 4
    b7_bound = (b7_bytes / HBM_BYTES_PER_S * 1e3, b7_ops / F32_FLOPS_PER_S * 1e3)
    phase("times", f"B7 dual loop at B={b}: grid {plan.grid}, {plan.resident_rows} rows of G "
          f"resident, {plan.shared_bytes} B shared a CTA; tol 0.001: median "
          f"{b7[0.001][0]:.4f} ms ({its} iterations run), tol 0: {b7[0.0][0]:.4f} ms "
          f"({b7[0.0][2]} iterations); per iteration "
          f"{b7[0.0][0] / max(b7[0.0][2], 1) * 1e3:.2f} us; twin {b7_twin:.4f} ms; bound "
          f"bytes {b7_bytes} B = {b7_bound[0]:.5f} ms, operations {b7_ops} f32 / 67e12 = "
          f"{b7_bound[1]:.5f} ms")
    # B8
    c, alpha, _ = fused_gram.dual_sgd(g, raw, y, m, p_prev=p_prev, convergence_tol=0.001, **kw)
    b8_ms, _ = timed(lambda: fused_gram.dual_writeback_counts(w, c, alpha, counts, num, f), 25,
                     queue_ahead=True)
    b8_twin, _ = timed(lambda: fused_gram.dual_writeback_reference(w, c, alpha, counts, num, f),
                       5)
    cf = counts[:b, :f].float()
    wt = w[:f].clone()
    addmv_ms, _ = timed(lambda: torch.addmv(wt, cf.t(), alpha, beta=float(c)), 10,
                        queue_ahead=True)
    del cf
    b8_bytes = b * cols * counts.element_size() + b * 4 * 5 + (f + 4) * 4 * 2
    b8_ops = 2 * b * f
    b8_bound = (b8_bytes / HBM_BYTES_PER_S * 1e3, b8_ops / F32_FLOPS_PER_S * 1e3)
    phase("times", f"B8 write-back at B={b} F={f}: median {b8_ms:.4f} ms; twin {b8_twin:.4f} "
          f"ms; bound bytes {b8_bytes} B = {b8_bound[0]:.5f} ms, operations {b8_ops} = "
          f"{b8_bound[1]:.5f} ms; torch.addmv on f32 counts of the same batch (the int8 C "
          f"has no single library call) {addmv_ms:.4f} ms")
    return [
        record("count_build", "twtml_tpu/ops/gram.py:133 (onehot_counts_int8; :112 "
               "onehot_counts, sparse.py:29 densify_text)", b4_ms, b4_twin, b4_bound, {
                   "kernel": "B4", "plane": PLANE_NAMES[plane], "tokens": l,
                   "library_ms": b4_lib, "library_call": "torch.bincount",
                   "library_dtype": b4_lib_dtype, "f32_build": f32_build,
                   "gram_product": {"call": "torch._int_mm", "ms": mm_ms,
                                    "with_f32_cast_ms": g_ms, "bound_ms": mm_bound,
                                    "bound_by": "operations", "f32_matmul_ms": f32_ms,
                                    "replaces": "twtml_tpu/ops/gram.py:210"}}),
        record("dual_sgd", "twtml_tpu/models/sgd.py:155 (run_dual_loop)", b7[0.001][0],
               b7_twin, b7_bound, {"kernel": "B7", "iterations_run": its,
                                   "all_iterations_ms": b7[0.0][0], "grid": plan.grid,
                                   "shared_bytes": plan.shared_bytes}),
        record("dual_writeback_counts", "twtml_tpu/ops/gram.py:269 (dual_writeback)", b8_ms,
               b8_twin, b8_bound, {"kernel": "B8", "addmv_f32_counts_ms": addmv_ms}),
    ]


def timed(fn, runs, queue_ahead=False, ahead_cycles=QUEUE_AHEAD_CYCLES):
    """Median and all of ``runs`` CUDA-event times of ``fn``. With
    ``queue_ahead`` the device is kept busy (``ahead_cycles`` of
    ``torch.cuda._sleep``) while the host enqueues, so the time is the
    device's alone; without it the host's enqueue gap counts."""
    import torch

    times = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        if queue_ahead:
            torch.cuda._sleep(ahead_cycles)
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


def logistic_times(smi, max_err, launches):
    """B1's logistic mode at the operating point (0/1 labels from a fixed
    seed): the kernel alone as device time with all 50 iterations run
    (tolerance 0: no freeze), and at the app's tolerance, its twin, its
    bound (the least-squares mode's work plus σ: an exp, an add, a divide
    and a subtract a row an iteration)."""
    import torch

    from twtml_tpu_torch.ops import fused_sgd

    dev = torch.device("cuda")
    x, _, m, w0 = op_point_inputs(dev)
    y = op_point_labels(dev)
    b, f = x.shape
    plan = fused_sgd.launch_plan(b, f, **sm_limits())
    w = torch.empty(f, device=dev)
    preds = torch.empty(b, device=dev)
    spill = torch.empty(plan.spill_elements, dtype=torch.bfloat16, device=dev)
    scratch = torch.empty(plan.scratch_floats, device=dev)

    def kernel_only(tol):
        fused_sgd.call_kernel(plan, fused_sgd.kernel_args(
            plan, x, y, m, w0, w, preds, spill, scratch, num_iterations=OP_ITERS,
            step_size=0.1, l2_reg=0.0, convergence_tol=tol, mode=1))

    runs = {}
    for tol in (0.0, 0.001):
        for _ in range(3):
            kernel_only(tol)
        runs[tol] = timed(lambda: kernel_only(tol), 25, queue_ahead=True)
        runs[tol] = runs[tol] + (int(scratch[-1].item()),)
    kernel_ms, times, iters = runs[0.0]
    app_ms, _, app_iters = runs[0.001]
    kw = dict(num_iterations=OP_ITERS, step_size=0.1, convergence_tol=0.0,
              residual_fn=fused_sgd.logistic_residual)
    twin_ms, _ = timed(lambda: fused_sgd.fused_dense_sgd_reference(x, y, m, w0, **kw), 10)
    io_bytes = b * f * 4 + 4 * b * 2 + 4 * b + 4 * f * 2
    flops = iters * (4 * b * f + 4 * b + 6 * f)
    bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    phase("times", f"logistic mode (card: {smi}): kernel alone, {iters} iterations "
          f"(tolerance 0), device time median {kernel_ms:.4f} ms over 25 runs (min "
          f"{min(times):.4f}, max {max(times):.4f}); at the app's tolerance 0.001: "
          f"{app_ms:.4f} ms, {app_iters} iterations run; twin on the card median "
          f"{twin_ms:.4f} ms over 10 runs; bound: bytes {io_bytes} B = {bytes_ms:.5f} ms, "
          f"operations {flops} = {ops_ms:.5f} ms, bound_ms {bound_ms:.5f} ({bound_by}); "
          f"kernel at {kernel_ms / bound_ms:.1f}x its bound")
    return {
        "name": "fused_dense_sgd (logistic mode)",
        "route": "cuda",
        "source": "twtml_tpu_torch/csrc/fused_sgd.cu",
        "replaces": "twtml_tpu/ops/pallas_sgd.py:55",
        "tpu_function": "_sgd_kernel",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "app_tolerance_ms": app_ms,
        "app_tolerance_iterations": app_iters,
        "plain_ms": twin_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "iterations_run": iters,
    }


# ---- phase 20: the serving plane and its fleet router on the card ----------

SERVE_ROWS = 256  # --serveBatchRows's default: the predict step's B
SERVE_REQUESTS = 2000
SERVE_CLIENTS = 16
SERVE_MAX_ROWS = 16
SWAP_AT = SERVE_REQUESTS // 3  # the second checkpoint lands after this many answers
FLEET_REQUESTS = 320
FLEET_CLIENTS = 8
SPARSE_SERVE_REQUESTS = 64
RAW_ATOL = 2e-3  # tests/test_torch_step.py's tolerance on raw margins, card vs CPU


def serve_pool(statuses):
    """The request rows: the stream phase's originals as the JSON face."""
    return [{
        "text": s.retweeted_status.text,
        "followers_count": s.retweeted_status.followers_count,
        "favourites_count": s.retweeted_status.favourites_count,
        "friends_count": s.retweeted_status.friends_count,
        "created_at_ms": s.retweeted_status.created_at_ms,
        "retweet_count": s.retweeted_status.retweet_count,
    } for s in statuses]


def serve_load(url, pool, requests, clients, seed, progress=None):
    """``requests`` POST /api/predict of 1-16 rows (a seeded slice of
    ``pool`` each) from ``clients`` threads through ``ServingClient``:
    [(first row, rows, response, latency s)], the client errors, the
    wall seconds. ``progress(n)`` sees each answer's running count."""
    import numpy as np

    from twtml_tpu_torch.serving import ServingClient

    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, SERVE_MAX_ROWS + 1, size=requests)
    starts = rng.integers(0, len(pool) - SERVE_MAX_ROWS, size=requests)
    jobs = list(zip(starts.tolist(), sizes.tolist()))
    out, errors, lock = [], [], threading.Lock()

    def client_thread(k):
        client = ServingClient(url, timeout=60.0, retries=3)
        for start, n in jobs[k::clients]:
            t0 = time.perf_counter()
            try:
                res = client.predict(pool[start:start + n])
            except Exception as exc:  # every client error is counted and fails the phase
                with lock:
                    errors.append(repr(exc))
                continue
            with lock:
                out.append((start, n, res, time.perf_counter() - t0))
                done = len(out)
            if progress is not None:
                progress(done)

    threads = [threading.Thread(target=client_thread, args=(k,)) for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if any(t.is_alive() for t in threads):
        raise AssertionError("serve: a load client did not finish within 300 s")
    return out, errors, time.perf_counter() - t0


class RowRefs:
    """Each row's reference prediction under a snapshot's weights, computed
    in batches of ``SERVE_ROWS`` rows of another composition than served:
    ``train`` is the card's train step (50 iterations; its pre-update
    predictions), ``cpu`` the CPU predict engine, ``raw_cuda``/``raw_cpu``
    the raw margins (rounding off) on each device."""

    def __init__(self, pool, weights_by_step, num_text_features=1000):
        self.pool = pool
        self.weights = weights_by_step
        self.nf = num_text_features
        self.cache: dict = {}

    def model(self, kind):
        from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
        from twtml_tpu_torch.serving.engine import PredictEngine

        class Raw(StreamingLinearRegressionWithSGD):
            round_predictions = False

        if kind == "train":
            return StreamingLinearRegressionWithSGD(num_text_features=self.nf)
        device = "cpu" if kind in ("cpu", "raw_cpu") else "cuda"
        cls = Raw if kind.startswith("raw") else None
        return PredictEngine(num_text_features=self.nf, model_cls=cls, device=device).model

    def get(self, kind, step, rows):
        """{row index: prediction} for ``rows`` (indices into the pool)."""
        import numpy as np

        from twtml_tpu_torch.features.featurizer import Featurizer
        from twtml_tpu_torch.serving.plane import ServingPlane

        have = self.cache.setdefault((kind, step), {})
        todo = sorted(set(rows) - set(have))
        if not todo:
            return have
        model = self.model(kind)
        feat = Featurizer(num_text_features=self.nf)
        for i in range(0, len(todo), SERVE_ROWS):
            chunk = todo[i:i + SERVE_ROWS][::-1]  # another order than served
            model.set_initial_weights(self.weights[step])
            batch = feat.featurize_batch_ragged(
                ServingPlane.statuses_from_rows([self.pool[j] for j in chunk]),
                row_bucket=SERVE_ROWS, pre_filtered=True)
            pending = model.fetch_output(model.step(batch))
            pending.wait()
            preds = pending.result().predictions[np.asarray(batch.mask) > 0]
            have.update(zip(chunk, preds.tolist()))
        return have


def check_served(name, answers, refs, steps):
    """Each answer's predictions against the card's train step under the
    snapshot its ``snapshotStep`` names: bitwise. Returns the steps seen."""
    import numpy as np

    seen = {}
    for start, n, res, _ in answers:
        step = res["snapshotStep"]
        if step not in steps or res["servedRows"] != n:
            raise AssertionError(f"{name}: an answer of {res['servedRows']} rows for {n} "
                                 f"names step {step}, want one of {steps}")
        seen.setdefault(step, []).append((start, n, res))
    for step, group in seen.items():
        rows = [j for start, n, _ in group for j in range(start, start + n)]
        want = refs.get("train", step, rows)
        for start, n, res in group:
            got = np.asarray(res["predictions"], np.float32)
            ref = np.asarray([want[j] for j in range(start, start + n)], np.float32)
            if got.tobytes() != ref.tobytes():  # JSON floats hold float32 exactly
                raise AssertionError(f"{name}: rows {start}..{start + n} under step {step}: "
                                     f"served {got[:4]} != train step {ref[:4]}")
    return {step: len(group) for step, group in seen.items()}


def hold_cpu(name, answers, refs, step):
    """Served (card) against the CPU predict engine: rounded predictions
    equal except HALF_UP flips of a raw margin within ``RAW_ATOL`` of a
    half, and raw margins within ``RAW_ATOL``. Returns (rows, flips, max
    raw error)."""
    rows = sorted({j for start, n, res, _ in answers if res["snapshotStep"] == step
                   for j in range(start, start + n)})
    cpu = refs.get("cpu", step, rows)
    raw_gpu, raw_cpu = refs.get("raw_cuda", step, rows), refs.get("raw_cpu", step, rows)
    served = {}
    for start, n, res, _ in answers:
        if res["snapshotStep"] == step:
            served.update(zip(range(start, start + n), res["predictions"]))
    flips, err = 0, 0.0
    for j in rows:
        err = max(err, abs(raw_gpu[j] - raw_cpu[j]))
        if served[j] != cpu[j]:
            if abs(abs(raw_cpu[j] % 1.0) - 0.5) > RAW_ATOL:
                raise AssertionError(f"{name}: row {j} served {served[j]} cpu {cpu[j]} "
                                     f"(raw {raw_gpu[j]} / {raw_cpu[j]}), not a HALF_UP flip")
            flips += 1
    if err > RAW_ATOL:
        raise AssertionError(f"{name}: raw margins {err:.3e} apart, card against CPU")
    return len(rows), flips, err


def spawn_serve(ck, port, log_path):
    """``python -m twtml_tpu_torch.apps.serve`` on the card, a process of
    its own, every dispatch under the sync-debug mode."""
    from twtml_tpu_torch.apps.common import SYNC_DEBUG_ENV

    env = dict(os.environ, **{SYNC_DEBUG_ENV: "error"})
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "twtml_tpu_torch.apps.serve", "--backend", "cuda",
         "--checkpointDir", ck, "--servePort", str(port), "--servePromoteEvery", "0.2",
         "--blackbox", "off"],
        cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT)
    proc.log = log
    return proc


def wait_serving(url, step, proc, seconds=120.0):
    """Until the replica's published Serving view names ``step``."""
    from twtml_tpu_torch.serving import ServingClient

    client = ServingClient(url, timeout=2.0, retries=0)
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        if proc.poll() is not None:
            break
        try:
            if client.serving().get("snapshotStep", -1) >= step:
                return
        except OSError:
            pass  # not listening yet
        time.sleep(0.2)
    proc.log.flush()
    with open(proc.log.name) as fh:
        tail = fh.read()[-3000:]
    raise AssertionError(f"serve replica {url} never served step {step}:\n{tail}")


def fleet_arm(ck, pool, refs, step):
    """Two serve processes on the card behind ``apps/router.run``: a load
    under ``p99``, then one under ``hash`` with replica 0 killed halfway.
    No client error; every answer equals the train step under its step;
    the kill counted as an ejection."""
    import signal

    from twtml_tpu_torch.apps import router as router_app
    from twtml_tpu_torch.config import ConfArguments
    from twtml_tpu_torch.telemetry import metrics

    ports = (free_port(), free_port())
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    logs = [os.path.join(os.path.dirname(ck), f"replica{i}.log") for i in range(2)]
    procs = [spawn_serve(ck, p, log) for p, log in zip(ports, logs)]
    results = {}
    try:
        t0 = time.perf_counter()
        for url, proc in zip(urls, procs):
            wait_serving(url, step, proc)
        phase("serve", f"fleet: 2 serve processes on the card up in "
              f"{time.perf_counter() - t0:.1f} s (torch import, CUDA context, warm-up)")
        for policy, kill in (("p99", False), ("hash", True)):
            ready, stop, got = threading.Event(), threading.Event(), {}

            def started(server, router, got=got, ready=ready):
                got["port"], got["router"] = server.port, router
                ready.set()

            conf = ConfArguments().parse(["--replicas", ",".join(urls), "--routerPort", "0",
                                          "--routePolicy", policy])
            runner = threading.Thread(target=router_app.run, kwargs=dict(
                conf=conf, started=started, stop_event=stop))
            runner.start()
            if not ready.wait(30):
                raise AssertionError("fleet: the router never came up")
            reg = metrics.get_registry()
            eject0 = reg.counter("fleet.replica_ejections").snapshot()

            def progress(n, kill=kill):
                if kill and n == FLEET_REQUESTS // 2 and procs[0].poll() is None:
                    procs[0].send_signal(signal.SIGKILL)

            try:
                answers, errors, wall = serve_load(
                    f"http://127.0.0.1:{got['port']}", pool, FLEET_REQUESTS, FLEET_CLIENTS,
                    seed=31 if kill else 30, progress=progress)
                if kill:
                    procs[0].wait(timeout=30)
                    router = got["router"]
                    end = time.monotonic() + 30
                    while router.replicas[0].healthy and time.monotonic() < end:
                        router.health_check_once()
                view = got["router"].stats()
            finally:
                stop.set()
                runner.join(timeout=30)
            if errors:
                raise AssertionError(f"fleet {policy}: {len(errors)} client errors: "
                                     f"{errors[:3]}")
            check_served(f"fleet {policy}", answers, refs, {step})
            ejections = reg.counter("fleet.replica_ejections").snapshot() - eject0
            if kill and (ejections < 1 or view["replicas"][0]["healthy"]):
                raise AssertionError(f"fleet {policy}: the killed replica was not ejected "
                                     f"({view})")
            lat = sorted(a[3] for a in answers)
            results[policy] = {
                "requests": len(answers), "client_errors": len(errors),
                "qps": len(answers) / wall, "p50_ms": lat[len(lat) // 2] * 1e3,
                "p99_ms": lat[int(0.99 * (len(lat) - 1))] * 1e3,
                "replica_requests": [r["requests"] for r in view["replicas"]],
                "retries": view["retries"], "ejections": ejections,
            }
            phase("serve", f"fleet {policy}{' (replica 0 killed halfway)' if kill else ''}: "
                  f"{len(answers)} answers, 0 client errors, each bitwise the train step's; "
                  f"{results[policy]['qps']:.0f} requests/s, p50 "
                  f"{results[policy]['p50_ms']:.2f} ms, p99 {results[policy]['p99_ms']:.2f} ms; "
                  f"per replica {results[policy]['replica_requests']}, router retries "
                  f"{view['retries']}, ejections {ejections}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=10)
            proc.log.close()
    return results


PREDICT_AHEAD_CYCLES = 2_000_000  # ~1 ms: the wrapper's host work stays off the clock


def bits(t):
    """A float32 tensor's bit patterns (a comparison that tells -0 from 0)."""
    import torch

    return t.contiguous().view(dtype=torch.int32)


def predict_case(name, x, y, m, w0):
    """The predict kernel (N = 0) against the training kernel's first row
    pass (N = 1) on the same batch, bitwise; w returned bitwise w0, 0
    iterations; the twin within RTOL/ATOL. Returns (preds, max abs err)."""
    import torch

    from twtml_tpu_torch.ops import fused_sgd

    w, preds = fused_sgd.fused_dense_sgd(x, y, m, w0, num_iterations=0, step_size=0.005)
    iterations = int(fused_sgd.fused_dense_sgd.last_iterations.item())
    _, train = fused_sgd.fused_dense_sgd(x, y, m, w0, num_iterations=1, step_size=0.005)
    again = fused_sgd.fused_dense_sgd(x, y, m, w0, num_iterations=0, step_size=0.005)[1]
    _, twin = fused_sgd.fused_dense_sgd_reference(x, y, m, w0, num_iterations=0,
                                                  step_size=0.005)
    torch.cuda.synchronize()
    if not torch.equal(bits(preds), bits(train)):
        diff = int((bits(preds) != bits(train)).sum())
        raise AssertionError(f"predict {name}: {diff} predictions differ bitwise from the "
                             "N = 1 launch's first pass")
    if not torch.equal(bits(w), bits(w0)) or iterations != 0:
        raise AssertionError(f"predict {name}: w changed or {iterations} iterations ran")
    if not torch.equal(bits(preds), bits(again)):
        raise AssertionError(f"predict {name}: reruns are not bitwise equal")
    err, _ = compare(f"predict {name}", preds, twin)
    return preds, err


def predict_mode_times(smi, launches):
    """B1's predict-only kernel (N = 0, the serving path's) at B = 256 and
    16384: bitwise the N = 1 launch's first-pass predictions, w bitwise w0,
    0 iterations, the twin within RTOL/ATOL, an all-padding batch predicting
    zeros; the same at F = 2000 and 8196 (the wide order) and with NaN/Inf
    in masked rows, bitwise ignored; the kernel alone through its wrapper (device time,
    queued ahead), its twin, the one PyTorch call of the same function
    (``torch.mv``: X·w0), the bound. The kernels line's record."""
    import numpy as np
    import torch

    from twtml_tpu_torch.ops import fused_sgd

    dev = torch.device("cuda")
    x_full, y_full, m_full, w0 = op_point_inputs(dev)
    out = {}
    for b in (SERVE_ROWS, OP_ROWS):
        x, y, m = (t[:b].contiguous() for t in (x_full, y_full, m_full))
        f = x.shape[1]
        kw = dict(num_iterations=0, step_size=0.005)
        preds, err = predict_case(f"B={b}", x, y, m, w0)
        _, empty = fused_sgd.fused_dense_sgd(x, y, torch.zeros_like(m), w0, **kw)
        if empty.abs().max().item() != 0.0:
            raise AssertionError(f"predict mode B={b}: an all-padding batch predicts non-zero")
        call = lambda: fused_sgd.fused_dense_sgd(x, y, m, w0, **kw)  # noqa: E731
        for _ in range(3):
            call()
        kernel_ms, times = timed(call, 50, queue_ahead=True,
                                 ahead_cycles=PREDICT_AHEAD_CYCLES)
        twin_ms, _ = timed(lambda: fused_sgd.fused_dense_sgd_reference(x, y, m, w0, **kw), 20,
                           queue_ahead=True, ahead_cycles=PREDICT_AHEAD_CYCLES)
        for _ in range(3):
            torch.mv(x, w0)
        mv_ms, _ = timed(lambda: torch.mv(x, w0), 50, queue_ahead=True,
                         ahead_cycles=PREDICT_AHEAD_CYCLES)
        mv_err = (torch.mv(x, w0) - preds)[m > 0].abs().max().item()
        # each input the function needs read once, each output written once:
        # f32 X, mask and w0; preds and w (it reads no labels)
        io_bytes = b * f * 4 + 4 * b + 4 * f + 4 * b + 4 * f
        flops = 2 * b * f
        bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        out[b] = {
            "ms": kernel_ms, "plain_ms": twin_ms,
            "library_ms": mv_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "max_abs_err": err,
            "mv_max_abs_diff": mv_err, "bitwise_first_pass": True,
        }
        phase("serve", f"B1 predict kernel (N = 0) at B={b} F={f} (card: {smi}): kernel "
              f"alone median {kernel_ms:.4f} ms over 50 runs (min {min(times):.4f}); twin "
              f"{twin_ms:.4f} ms; torch.mv "
              f"(X·w0, the library call) {mv_ms:.4f} ms, within {mv_err:.2e} of the kernel; "
              f"bound: bytes {io_bytes} B = {bytes_ms:.5f} ms, operations {flops} = "
              f"{ops_ms:.5f} ms; kernel at {kernel_ms / bound_ms:.1f}x its bound, "
              f"{kernel_ms / mv_ms:.2f}x torch.mv; preds bitwise the N = 1 launch's first "
              f"pass, w bitwise w0, 0 iterations, max abs err vs twin {err:.2e}, all-padding "
              "zeros")

    # the wide order (F > 1024) and NaN/Inf in masked rows, each bitwise
    # the training kernel's first pass
    rng = np.random.default_rng(2030)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    for rows, feats, valid in ((1024, 2000, 1000), (SERVE_ROWS, 1004, 130), (300, 8196, 250)):
        x, y, m = design(rng, rows, feats, valid)
        w = to((rng.normal(size=feats) * 1e-2).astype("float32"))
        clean, err = predict_case(f"B={rows} F={feats}", to(x * m[:, None]), to(y), to(m), w)
        x[m == 0] = np.nan
        x[(m == 0).nonzero()[0][::2], 1] = np.inf
        dirty, _ = predict_case(f"B={rows} F={feats} NaN/Inf", to(x), to(y), to(m), w)
        if not torch.equal(bits(clean), bits(dirty)):
            raise AssertionError(f"predict B={rows} F={feats}: NaN/Inf in masked rows reached "
                                 "the predictions")
        phase("serve", f"B1 predict kernel at B={rows} F={feats} "
              f"({'wide' if feats > fused_sgd.TILE_COLUMNS else 'narrow'} order): preds "
              f"bitwise the N = 1 launch's first pass, max abs err vs twin {err:.2e}; "
              f"NaN/Inf in {rows - valid} masked rows: bitwise equal")
    serve = out[SERVE_ROWS]
    return dict({
        "name": "fused_dense_predict", "route": "cuda",
        "source": "twtml_tpu_torch/csrc/fused_sgd.cu",
        "replaces": "twtml_tpu/ops/pallas_sgd.py:55 (_sgd_kernel at num_iterations=0)",
        "tpu_function": "_sgd_kernel", "launches": launches,
        "max_abs_err": max(o["max_abs_err"] for o in out.values()),
        "library_call": "torch.mv(X, w0)", "shape": [SERVE_ROWS, x_full.shape[1]],
    }, **{k: serve[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        at_16384=out[OP_ROWS])


def serve_step_costs(weights, pool):
    """One full serve batch (B = 256) through the predict engine on the
    card: device ms (queued ahead), device busy and launches (profiler),
    and the host wall of a step with its fetch."""
    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.serving import ServingSnapshot
    from twtml_tpu_torch.serving.engine import PredictEngine
    from twtml_tpu_torch.serving.plane import ServingPlane

    engine = PredictEngine()
    engine.set_snapshot(ServingSnapshot(step=0, weights=weights))
    batch = Featurizer().featurize_batch_ragged(
        ServingPlane.statuses_from_rows(pool[:SERVE_ROWS]), row_bucket=SERVE_ROWS,
        pre_filtered=True)
    wire = engine.pack_for_wire(batch)
    event_ms, busy, launches = device_costs(lambda: engine.step(wire), 20)
    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        pending = engine.fetch_output(engine.step(wire))
        pending.wait()
        walls.append((time.perf_counter() - t0) * 1e3)
    return {"device_ms": event_ms, "busy_ms": busy, "launches": launches,
            "host_wall_ms": statistics.median(walls)}


def serve_phase(smi, main_weights, statuses):
    """The serving plane on the card (module docstring, phase 20)."""
    import tempfile

    import numpy as np
    import torch

    from twtml_tpu_torch.apps import serve as serve_app
    from twtml_tpu_torch.apps.common import SYNC_DEBUG_ENV
    from twtml_tpu_torch.checkpoint import Checkpointer
    from twtml_tpu_torch.config import ConfArguments
    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.ops import fused_gram, fused_sgd
    from twtml_tpu_torch.serving import ServingSnapshot
    from twtml_tpu_torch.serving.plane import ServingPlane
    from twtml_tpu_torch.telemetry import metrics

    t_phase = time.perf_counter()
    pool = serve_pool(statuses)
    w1 = np.asarray(main_weights, np.float32)
    w2 = (w1 * np.float32(0.75)).astype(np.float32)
    refs = RowRefs(pool, {4: w1, 8: w2})
    ok = {"quality": {"level": "ok"}}
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        Checkpointer(ck).save(4, w1, dict(ok, count=4 * OP_ROWS, batches=4))
        reg = metrics.get_registry()
        batches0 = reg.counter("serve.batches").snapshot()
        ready, stop, got = threading.Event(), threading.Event(), {}

        def started(server, plane, promoter):
            got["url"], got["plane"] = f"http://127.0.0.1:{server.port}", plane
            ready.set()

        def run():
            try:
                got["stats"] = serve_app.run(ConfArguments().parse([
                    "--backend", "cuda", "--checkpointDir", ck, "--servePort",
                    str(free_port()), "--servePromoteEvery", "0.2", "--blackbox", "off",
                ]), started=started, stop_event=stop)
            except BaseException as exc:  # raised below
                got["error"] = exc
                ready.set()

        fused_sgd.fused_dense_sgd.launches = 0
        fused_sgd.fused_dense_sgd.predict_launches = 0
        for fn in fused_gram.KERNELS:
            fn.launches = 0
        os.environ[SYNC_DEBUG_ENV] = "error"
        server = threading.Thread(target=run)
        t0 = time.perf_counter()
        server.start()
        try:
            if not ready.wait(120) or "error" in got:
                raise AssertionError(f"serve: apps/serve.run did not come up: {got.get('error')}")
            boot_s = time.perf_counter() - t0

            def progress(n):
                if n == SWAP_AT:  # mid-load, the trainer's next checkpoint
                    Checkpointer(ck).save(8, w2, dict(ok, count=8 * OP_ROWS, batches=8))

            answers, errors, wall = serve_load(got["url"], pool, SERVE_REQUESTS,
                                               SERVE_CLIENTS, seed=20, progress=progress)
        finally:
            stop.set()
            server.join(timeout=60)
            del os.environ[SYNC_DEBUG_ENV]
        torch.cuda.synchronize()
        launches = fused_sgd.fused_dense_sgd.launches
        predict_launches = fused_sgd.fused_dense_sgd.predict_launches
        gram_launches = {fn.__name__: fn.launches for fn in fused_gram.KERNELS}
        served_batches = reg.counter("serve.batches").snapshot() - batches0
        plane = got["plane"]
        if server.is_alive() or "error" in got:
            raise AssertionError(f"serve: the app did not stop cleanly: {got.get('error')}")
        if errors:
            raise AssertionError(f"serve: {len(errors)} client errors: {errors[:3]}")
        if (launches != served_batches + 1 or predict_launches != launches
                or any(gram_launches.values())):
            raise AssertionError(f"serve: B1 launched {launches} times ({predict_launches} "
                                 f"of them its predict kernel) for {served_batches} batches "
                                 f"+ the warm-up; Gram kernels {gram_launches}")
        if (int(fused_sgd.fused_dense_sgd.last_iterations.item()) != 0
                or not np.array_equal(plane._engine.model.latest_weights, w2)):
            raise AssertionError("serve: the predict-only launches moved the snapshot's weights")
        seen = check_served("serve", answers, refs, {4, 8})
        if set(seen) != {4, 8}:
            raise AssertionError(f"serve: the hot swap served steps {seen}")
        lat = sorted(a[3] for a in answers)
        rows = sum(a[1] for a in answers)
        phase("serve", f"apps/serve.run on the card up in {boot_s:.2f} s (snapshot of the main "
              f"phase's 4 batches, step 4); {len(answers)} requests of 1-{SERVE_MAX_ROWS} rows "
              f"({rows} rows) from {SERVE_CLIENTS} ServingClient threads in {wall:.3f} s = "
              f"{len(answers) / wall:.0f} requests/s, {rows / wall:.0f} rows/s; latency p50 "
              f"{lat[len(lat) // 2] * 1e3:.2f} ms, p99 {lat[int(0.99 * (len(lat) - 1))] * 1e3:.2f}"
              f" ms; {served_batches} batches, fill {rows / served_batches:.1f} rows of "
              f"{SERVE_ROWS}; every dispatch under set_sync_debug_mode('error'), 0 client errors")
        phase("serve", f"B1 launched {launches} times = {served_batches} batches + the warm-up, "
              f"each its predict kernel ({predict_launches} predict launches, last iterations "
              f"0), the served weights bitwise the snapshot's; Gram kernels 0")
        phase("serve", f"hot swap mid-load to step 8: answers by snapshot step {seen}; every "
              "answer bitwise equal to the card's train-step pre-update predictions of its rows "
              f"under the step it names, the references batched {SERVE_ROWS} rows at a time in "
              "another composition and order (each row's prediction is row-local)")
        held = {step: hold_cpu("serve", answers, refs, step) for step in (4, 8)}
        phase("serve", "against the --backend cpu predict engine: " + "; ".join(
            f"step {s}: {n} rows, {fl} HALF_UP flips, raw margins within {e:.2e}"
            for s, (n, fl, e) in held.items()) + f" (tolerance {RAW_ATOL})")
        fleet = fleet_arm(ck, pool, refs, 8)

    # config #4: a 262,148-weight snapshot on the card's gather predict
    sparse_w = (np.random.default_rng(18).standard_normal(GRAM_F + 4) * 2.0).astype(np.float32)
    fused_sgd.fused_dense_sgd.launches = 0
    sparse_refs = RowRefs(pool, {1: sparse_w}, num_text_features=GRAM_F)
    os.environ[SYNC_DEBUG_ENV] = "error"
    sp = ServingPlane(ServingSnapshot(step=1, weights=sparse_w), num_text_features=GRAM_F,
                      featurizer=Featurizer(num_text_features=GRAM_F))
    try:
        sp.warmup()
        sp.start()
        rng = np.random.default_rng(44)
        jobs = [(int(s), int(n)) for s, n in zip(
            rng.integers(0, len(pool) - SERVE_MAX_ROWS, SPARSE_SERVE_REQUESTS),
            rng.integers(1, SERVE_MAX_ROWS + 1, SPARSE_SERVE_REQUESTS))]
        futs = [(s, n, sp.submit(sp.statuses_from_rows(pool[s:s + n]))) for s, n in jobs]
        sparse_answers = [(s, n, {"snapshotStep": 1, "servedRows": n,
                                  "predictions": f.result(timeout=120)["predictions"]}, 0.0)
                          for s, n, f in futs]
    finally:
        sp.stop()
        del os.environ[SYNC_DEBUG_ENV]
    if fused_sgd.fused_dense_sgd.launches or sp._engine.model.route != "scatter":
        raise AssertionError(f"serve config #4: route {sp._engine.model.route}, B1 launched "
                             f"{fused_sgd.fused_dense_sgd.launches} times")
    n4, flips4, err4 = hold_cpu("serve config #4", sparse_answers, sparse_refs, 1)
    phase("serve", f"config #4 (2^18 + 4 = {GRAM_F + 4} weights): {len(sparse_answers)} requests "
          f"({n4} rows) on the card's gather predict (route scatter, 0 iterations: no "
          f"kernel), B1 launched 0 times; against the CPU twin {flips4} HALF_UP flips, raw "
          f"margins within {err4:.2e}")

    step = serve_step_costs(w1, pool)
    phase("serve", f"one serve step (B = {SERVE_ROWS}, packed ragged wire, H2D copy "
          f"included): device {step['device_ms']:.4f} ms (CUDA events, queued ahead), "
          f"{step['busy_ms']:.4f} ms busy and {step['launches']:.0f} launches (profiler), "
          f"host wall of step + fetch {step['host_wall_ms']:.3f} ms (median of 20)")
    predict = predict_mode_times(smi, predict_launches)
    phase("serve", f"phase wall {time.perf_counter() - t_phase:.1f} s")
    return {
        "requests": len(answers), "qps": len(answers) / wall,
        "p50_ms": lat[len(lat) // 2] * 1e3, "p99_ms": lat[int(0.99 * (len(lat) - 1))] * 1e3,
        "batches": served_batches, "fill_rows": rows / served_batches, "steps_seen": seen,
        "cpu_flips": {s: v[1] for s, v in held.items()}, "fleet": fleet, "step": step,
        "predict_kernel": predict,
    }


def times_only(smi):
    """``--times-only``: the kernels' device times alone (B1's training
    kernel in its logistic mode, its predict-only mode, B4 in both planes,
    the G product, B7 and B8), no app phase; with ``--package-root DIR`` on
    the port found in DIR (another checkout, e.g. a parent commit unpacked
    there), so that two versions are timed in one call, in turns. It calls
    only the kernels' wrappers and C entries."""
    from collections import defaultdict

    out = {"package_root": PACKAGE_ROOT, "logistic": logistic_times(smi, 0.0, 0)}
    out["predict"] = predict_mode_times(smi, 0)
    out["gram"] = gram_times(smi, defaultdict(float), defaultdict(int))
    print(json.dumps({"times_only": out}), flush=True)


def main() -> None:
    global RECORDER, PACKAGE_ROOT
    t_start = time.perf_counter()
    argv = sys.argv[1:]
    if "--package-root" in argv:
        PACKAGE_ROOT = os.path.abspath(argv[argv.index("--package-root") + 1])
    smi = device_phase()
    build_phase()
    if "--times-only" in argv:
        times_only(smi)
        return
    max_errs, kernel_cases = kernel_phase()
    gram_errs, gram_cases = gram_kernel_phase()
    # pins the featurizer's clock and the synthetic tweets' creation times:
    # the wires and backends compared below featurize identical tweets
    os.environ["TWTML_NOW_MS"] = str(NOW_MS)
    RECORDER = Recorder()
    try:
        launches, ragged_rec = main_path_phase()
        padded_rec = padded_phase(ragged_rec)
        replay_phase()
        stream = stream_phase()
        guards = guards_phase(smi)
        sampled = sampled_phase(smi)
        dtypes = dtype_phase(smi)
        clock_launches = clock_phase()
        web_statuses = stream.pop("statuses")
        web = web_phase(web_statuses, stream["publish_ms"])
        live = live_phase()
        hosthash = hosthash_phase(padded_rec)
        logistic = logistic_phase(smi)
        superbatch = superbatch_phase(web_statuses, smi)
        kmeans = kmeans_phase(smi)
        sparse = sparse_phase(smi)
    finally:
        RECORDER.close()
    record = times_phase(smi, max_errs[0], launches)
    record["cases"] = [name for name in kernel_cases if not name.startswith("logistic")]
    logistic_record = logistic_times(smi, max_errs[1], logistic.pop("launches"))
    logistic_record.update(cases=[n for n in kernel_cases if n.startswith("logistic")],
                           app=logistic)
    record.update(launches_stream=stream["launches"], launches_clock=clock_launches,
                  stream_tweets_per_s=stream["rate"],
                  guards_tweets_per_s=guards["rates"],
                  sampled_route=sampled, bfloat16_route=dtypes,
                  stream_device_idle=(stream["timeline"] or {}).get("idle"),
                  launches_hosthash=hosthash["launches"], web=web, live=live,
                  hosthash_featurize_ms=hosthash["host_featurize_ms"],
                  superbatch=superbatch, kmeans=kmeans)
    gram_records = gram_times(smi, gram_errs, sparse.pop("launches"))
    for r in gram_records:
        r["cases"] = [c for c in gram_cases if c.startswith(r["name"])]
    gram_records[0]["sparse_phase"] = sparse
    serve = serve_phase(smi, ragged_rec["weights"], web_statuses)
    predict_record = serve.pop("predict_kernel")
    record["serve"] = serve
    import torch

    phase("done", f"chip_smoke wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [record, logistic_record, predict_record, *gram_records]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
