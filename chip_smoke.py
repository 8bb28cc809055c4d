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
               0.001 and tolerances that stop it at iterations 2 and N - 1,
               with the twin's iterations run and one grid barrier an update
               (the count the kernel writes), NaN/Inf in masked rows bitwise
               ignored, within rtol 1e-4 / atol 1e-5, and two replays of a
               CUDA graph that captured it bitwise the eager launch; B8 (the
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
               (µs an iteration and the spread at both tolerances, grid
               barriers, one barrier crossing alone on a probe kernel; and
               at B = 3072 and 4096, G spilled) and B8 at config #4's
               operating point (B = 2048, F = 2^18),
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
 21. tenants — the tenant plane (``--tenants``, parallel/tenants.py) on the
               card, 4 ticks of the stream phase's tweets from a pre-filled
               source under the sync-debug mode "error", ``--modelWatch on``:
               the linear app at M = 4 (hash key, ragged wire), B1 launched
               4 x (4 ticks + the warm-up) times, one fetch a tick (the
               model's ``fetch_output`` calls and ``fetch.count``); every
               tenant's predictions, stats, quality and final weights bitwise
               a standalone card learner stepped on its routed parts; the
               [4, 1004] stack and the pooled stats within 1e-4 of the
               ``--backend cpu`` twin; ``TWTML_FORCE_TENANT_PLANE=1
               --tenants 1`` bitwise the plain run (lines, weights);
               ``--chaos source.nan@3`` with a checkpoint every tick rolls
               the whole stack back to the verified archive once, replays,
               loses no row and ends bitwise the clean run; the logistic app
               at M = 2 and ``--tenantKey lang`` at M = 4 (a dry tenant)
               each bitwise standalone learners; from ``--profileDir``
               traces, M = 4 against the plain M = 1 run: host wall, device
               busy ms, launches and H2D/D2H copies a tick (one D2H), and
               tweets/s;
 22. abtest  — champion/challenger serving: ``--tenants 3`` trained on the
               card with ``--checkpointDir`` (the stack and a quality stamp a
               tenant in its verified meta); ``apps.serve --abtest on`` over
               that stack and a single-model ``apps.serve`` (the champion's
               weights) as processes of their own, every dispatch under the
               sync-debug mode; 2,000 requests from 16 ``ServingClient``
               threads of this process to each: every A/B answer bitwise the
               champion tenant's card train step under the step it names,
               across a checkpoint written mid-load whose stamps promote
               challenger 1 once and refuse the alert challenger 2
               (``promotions`` 1, ``refusedPromotions`` 1 in the Serving
               view), the router's Fleet view naming the champion; B1
               launched 3 x (served batches + the warm-up) times in the A/B
               process, each its predict kernel; requests/s and client
               p50/p99 of both servers.
23. block   — block ingest and the digram wire codec: the superbatch
               phase's 8 one-bucket batches written as a replay file; the
               linear app on the card with ``--ingest object``, ``--ingest
               block`` and ``--ingest block --wireCodec dict`` (``--seconds
               0 --batchBucket 16384``, every dispatch under the sync-debug
               mode "error"): the same 8 batches (rows a batch), lines,
               weights, predictions, stats and quality bitwise equal across
               the arms, B1 launched 8 + 1 times each, the C wire emitter
               parsing with 0 degraded parses, fills or packs and 0 codec
               fallbacks; the coded arm against its ``--backend cpu`` twin
               (batch 1's line identical, every stat within 1e-4); each
               arm's featurize by sub-stage, pack, wire bytes (raw and
               coded, ``wire.codec_ratio``), parse rate and tweets/s over
               batches 2-8; the raw and coded wires' pack ms, H2D ms, device
               busy ms and kernels a step (the difference: the decode's
               kernels) and ``units_from_codes`` alone (CUDA events, median
               of 25); ``--superBatch 8 --wirePack group`` over the file
               twice (the second group replays the CUDA graph, the decode
               inside) and ``--tenants 4 --wirePack group``, each with the
               codec bitwise without it; the logistic app (4 two-class
               batches) and k-means (4 batches) with ``--ingest block``,
               lines equal the CPU runs'; ``--chaos source.nan@5
               --checkpointEvery 1`` rolling back once and replaying its
               rows from kind-2 (block) journal records, 0 rows lost, lines
               and the final archive bitwise the clean block run's.
24. multihost — the lockstep multi-host runtime: B1's data-parallel
               split at world size 1 (a one-rank gloo group, through
               MultiHostSGDModel) bitwise B1 in both residual modes (2
               steps: weights, predictions, stats), each split entry against
               its twin at a rank's B = 8192; then the stream phase's first
               4 x 16384 tweets as a replay file and the linear app on 2
               ranks (``--master twtml://``, subprocesses, both on cuda:0,
               so gloo) at 8192 rows a rank against one process on the card
               at 16384: the lead's lines (count and batch exact, rounded
               stats within 2), the follower silent, the final weights
               within rtol 1e-4 and atol 1e-7, each rank 50 launches of each
               split entry a step, 52 all-reduces, one alignment all-gather
               a batch, no fused launch; the same for ``--wireCodec dict``,
               ``--superBatch 4`` and the 2^18 Gram route at B = 2048;
               ``--ingest block`` on byte-range shards against its emulation
               on the card; a resume that trains nothing; ``source.nan@3``
               rolled back on both ranks; ``peer.kill`` of rank 1 at tick 3
               (rank 1 exits 77, the survivor non-zero within the watchdog);
               a rank's step ms, launches, all-reduce and cadence all-gather
               ms, host wall a tick, tweets/s against one process, and each
               split entry's device time, twin time and bound.
25. elastic — ``--elastic on`` on the same 2 ranks and file: a healthy
               run with the lockstep main arm's collectives, fetches and
               split launches (as many cadence all-gathers as ticks), its
               host wall a tick and tweets/s beside the lockstep run's;
               ``peer.kill`` of uid 1 at tick 3 (``--checkpointEvery 1``):
               the survivor forms epoch 1 alone, and its final weights are
               bitwise those of a world-1 split run and of B1, each from
               the archive it restored, on the card in this process (the
               rescue's seconds from the kill, rows rolled back and
               replayed); ``peer.kill`` of uid 0: uid 1 wins the election,
               promotes its standby archives, held the same way; a
               restarted uid 1 parks and is admitted at an epoch boundary,
               its first tick's state CRC the lead's; the split kernels'
               launches and the phase's wall. The detached store processes
               the ranks start are gone (or stopped) when the phase ends.
No app run publishes anywhere but the loopback recorder and, in the web,
serve and abtest phases, the port's own servers on loopback ports. The line before
the last is the kernels' JSON record (B1's least-squares mode with its
``tenants`` launches and the ``block`` phase's figures, its logistic mode, its predict kernel with its
``abtest`` launches, B4 with its f32 build on tweet-length rows, B7,
B8 and the split's three entries with their ``elastic`` launches); the last line is ``{"ok": true,
"device": {...}}``.

``python3 chip_smoke.py --times-only [--package-root DIR]`` runs phases 1
and 2 and then only the kernels' device times (B1's logistic mode, its
predict kernel, B4 in both planes, the G product, B7 at B = 2048, 3072
and 4096, B8), importing the port from DIR (another checkout unpacked
there), so that two versions can be timed in turns in one call; its last
line is that JSON.

``python3 chip_smoke.py --elastic-ab N`` runs phases 1 and 2 and then
only N alternating pairs of healthy group runs, lockstep and ``--elastic
on`` (``elastic_ab``); its last line is their JSON.
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
    2047, 2048, 3072, 4095 and 4096 (G spilled to L2 past 2048), count 0,
    the logistic mode, ``-b 0.5`` masks, tolerance 0, 0.001 and the
    tolerances that stop the twin at iterations 2 and N - 1, each with the
    same iterations run and the grid barriers ``expected_barriers`` counts,
    NaN/Inf in masked rows bitwise ignored; within RTOL/ATOL; a CUDA graph
    of it replayed twice, bitwise the eager launch; at B % 4 != 0 on
    NaN-filled scratch, bitwise the launch on other scratch. B8: within
    WEIGHT_RTOL of the scatter write-back and of its twin."""
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

    def expected_barriers(mask, kw, its):
        """B7's grid barriers: one an update, less the last update's when no
        test is pending (tolerance 0), plus one that carries the test that
        stopped the loop early; 0 when no iteration selects a row, None (not
        checked) when only some select none."""
        masks, n = kw.get("masks"), kw["num_iterations"]
        counts = (mask if masks is None else mask * masks).reshape(-1, mask.shape[0]).sum(1)
        if not (counts > 0).any():
            return 0
        if not (counts > 0).all():
            return None
        return min(its + 1, n) if kw["convergence_tol"] > 0 else n - 1

    def dual_case(name, g, u, y, mask, dirty=False, **kw):
        kw = dict(dict(num_iterations=OP_ITERS, step_size=0.005, l2_reg=0.1,
                       convergence_tol=0.001, p_prev=torch.tensor(3.0, device=dev)), **kw)
        c, a, its = fused_gram.dual_sgd(g, u, y, mask, **kw)
        barriers = fused_gram.dual_sgd.last_barriers
        c2, a2, its2 = fused_gram.dual_sgd(g, u, y, mask, **kw)
        c_r, a_r, its_r = fused_gram.dual_sgd_reference(g, u, y, mask, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(a, a2) and torch.equal(c, c2) and int(its) == int(its2)):
            raise AssertionError(f"dual_sgd {name}: reruns are not bitwise equal")
        if int(its) != int(its_r):
            raise AssertionError(f"dual_sgd {name}: {int(its)} iterations run, the twin "
                                 f"{int(its_r)}")
        want = expected_barriers(mask, kw, int(its))
        if want is not None and int(barriers) != want:
            raise AssertionError(f"dual_sgd {name}: {int(barriers)} grid barriers crossed "
                                 f"in {int(its)} iterations, want {want}")
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
        where = ("G in registers" if plan.in_registers
                 else f"{plan.resident_rows} rows of G resident, {plan.spill_rows} spilled")
        phase("kernel", f"dual_sgd {name}: B={mask.shape[0]} grid {plan.grid}, {where}; "
              f"{int(its)} iterations run (twin {int(its_r)}), {int(barriers)} grid barriers "
              f"crossed; max abs err alpha {ea:.3e} (rel {ra:.3e}) c {ec:.3e}; {note}")
        errs["dual_sgd"] = max(errs["dual_sgd"], ea, ec)
        cases.append(f"dual_sgd {name}")
        return c, a, its

    def stopping_tol(k, g, u, y, mask):
        """A tolerance at which the twin stops at iteration k, and the ratio
        of the widest band of tolerances that do: the loop stops at the first
        iteration whose test ratio falls below the tolerance, so the
        iterations run fall as it grows; the band's geometric middle."""
        p_prev = torch.tensor(3.0, device=dev)

        def stops_by(tol, j):
            return int(fused_gram.dual_sgd_reference(
                g, u, y, mask, p_prev=p_prev, num_iterations=OP_ITERS, step_size=0.005,
                l2_reg=0.1, convergence_tol=tol)[2]) <= j

        def edge(j):  # the least tolerance (by log bisection) that stops it by iteration j
            lo, hi = 1e-7, 1.0
            for _ in range(30):
                mid = math.sqrt(lo * hi)
                lo, hi = (lo, mid) if stops_by(mid, j) else (mid, hi)
            return hi

        a, b = edge(k), edge(k - 1)
        if not a < b:
            raise AssertionError(f"dual_sgd: no tolerance stops the twin at iteration {k}")
        return math.sqrt(a * b), b / a

    dual_case("B=1", *dual_inputs(1, 1))
    dual_case("B=16", *dual_inputs(16, 12), dirty=True)
    g, u, y, m = dual_inputs(GRAM_ROWS, GRAM_ROWS - 100)
    dual_case("B=2048 tol 0.001", g, u, y, m, dirty=True)
    # labels near the margins: the loop freezes early at tolerance 0.001
    near = u + to((rng.normal(size=GRAM_ROWS) * 10).astype(np.float32))
    _, _, its = dual_case("B=2048 tol 0.001 (freezes)", g, u, near, m, dirty=True)
    if not 1 < int(its) < OP_ITERS:
        raise AssertionError(f"dual_sgd freeze case: {int(its)} iterations run")
    # the folded test's first and last crossings: stops at iteration 2 and N - 1
    for k in (2, OP_ITERS - 1):
        tol, band = stopping_tol(k, g, u, near, m)
        _, _, its = dual_case(f"B=2048 tol {tol:.6g} (stops at {k}; band x{band:.4f})", g, u,
                              near, m, convergence_tol=tol)
        if int(its) != k:
            raise AssertionError(f"dual_sgd stops at {int(its)}, not {k}")
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
    # captured in a CUDA graph (as step_many captures it) and replayed twice:
    # each replay bitwise the eager launch, so no barrier state outlives one
    kw = dict(num_iterations=OP_ITERS, step_size=0.005, l2_reg=0.1, convergence_tol=0.001,
              p_prev=torch.tensor(3.0, device=dev))
    eager = fused_gram.dual_sgd(g, u, near, m, **kw) + (fused_gram.dual_sgd.last_barriers,)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fused_gram.dual_sgd(g, u, near, m, **kw) + (fused_gram.dual_sgd.last_barriers,)
    for replay in (1, 2):
        graph.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(x, e) for x, e in zip(captured, eager)):
            raise AssertionError(f"dual_sgd in a CUDA graph: replay {replay} differs from the "
                                 "eager launch")
    phase("kernel", f"dual_sgd CUDA graph: B={GRAM_ROWS}, tol 0.001, labels near the margins; "
          f"2 replays bitwise equal to the eager launch (c, alpha, {int(eager[2])} iterations, "
          f"{int(eager[3])} grid barriers)")
    cases.append("dual_sgd CUDA graph")
    del graph, captured, g
    dual_case("B=3072 (G spilled)", *dual_inputs(3072, 3000), dirty=True)
    dual_case("B=4096 (G spilled)", *dual_inputs(4096, 4000), dirty=True)

    def nan_scratch_case(name, rows, n_valid):
        """B % 4 != 0 on scratch that held NaN: G·α loads α's padding [B, bp)
        as whole float4s, and it must meet G's zero columns as 0."""
        g, u, y, m = dual_inputs(rows, n_valid)
        kw = dict(num_iterations=OP_ITERS, step_size=0.005, l2_reg=0.1, convergence_tol=0.001,
                  p_prev=torch.tensor(3.0, device=dev))
        c, a, its = dual_case(name, g, u, y, m, dirty=True)
        plan = fused_gram.dual_plan(rows, **sm_limits())
        # NaN in free blocks of the scratch's size, each kept from merging
        # with the next by a live one, so that the launch's scratch is one
        held = [torch.full((plan.scratch_floats,), float("nan"), device=dev)
                for _ in range(64)]
        nan_ptrs = {t.data_ptr() for t in held[::2]}
        del held[::2]
        c_n, a_n, its_n = fused_gram.dual_sgd(g, u, y, m, **kw)
        base = fused_gram.dual_sgd.last_barriers.data_ptr() - 4 * (plan.scratch_floats - 1)
        del held
        torch.cuda.synchronize()
        if base not in nan_ptrs:
            raise AssertionError(f"dual_sgd {name}: its scratch is not a NaN-filled block")
        if not (torch.equal(a, a_n) and torch.equal(c, c_n) and int(its) == int(its_n)):
            raise AssertionError(f"dual_sgd {name}: NaN left in its scratch reached the result")
        phase("kernel", f"dual_sgd {name} on NaN-filled scratch: {plan.bp - rows} padding "
              f"float(s) of alpha; bitwise equal to the launch on other scratch")
        cases.append(f"dual_sgd {name} on NaN-filled scratch")

    nan_scratch_case("B=2047 (G in registers)", 2047, 2000)
    nan_scratch_case("B=4095 (G spilled)", 4095, 4000)

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
        app.build_source = lambda conf, **_: source
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
        rec["parse"] = dict(native.PARSE_COUNTERS)
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


def archive(directory, step=None):
    """(weights, meta) of the directory's newest verified archive, or of
    ``step``'s."""
    from twtml_tpu_torch.checkpoint import Checkpointer

    restored = Checkpointer(directory).restore(step=step)
    if restored is None:
        raise AssertionError(f"no verified archive (step {step}) in {directory}")
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

    def start(self, **kw):
        marks["start"] = time.perf_counter()
        base_start(self, **kw)

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
    return {"stream": first, "one_bucket": replay, "pool": pool}


KMEANS_BATCHES = 4
KMEANS_ARGV = ["--source", "synthetic", "--seconds", "0", "--batchBucket", str(OP_ROWS)]
KMEANS_RTOL = 1e-5


def kmeans_run(backend, statuses, argv=KMEANS_ARGV):
    """``apps/kmeans.py`` on ``backend`` over a pre-filled source of
    ``statuses`` (None: the source ``argv`` configures): (totals, lines,
    the model, each batch's assignments on the host)."""
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
    if statuses is not None:
        kmeans.build_source = lambda conf, **_: prefilled_source(statuses)
    out = io.StringIO()
    try:
        conf = ConfArguments().parse(["--backend", backend, *argv, "--lightning",
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


def gram_times(smi, errs, launches, structure=True):
    """B4, the G product, B7 and B8 at config #4's operating point (B = 2048
    synthetic tweets at F = 2^18, device-hashed, the int8 plane), and B7 at
    B = 3072 and 4096 (G spilled): each kernel alone as device time, its
    twin, its bound, the library call where one exists; the kernels line's
    records. With ``structure`` also B7's grid barriers at each tolerance,
    one barrier crossing alone and where G lives; without it only what
    every tree's ``dual_sgd`` and ``dual_plan`` expose (``--times-only``
    against another checkout)."""
    import numpy as np
    import torch

    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.models.sgd import batch_to_device, host_planes
    from twtml_tpu_torch.ops import fused_gram
    from twtml_tpu_torch.ops.gram import PLANE_INT8, PLANE_NAMES
    from twtml_tpu_torch.ops.sparse import sparse_predict
    from twtml_tpu_torch.ops.text_hash import hash_bigrams_device
    from twtml_tpu_torch.streaming.sources import SyntheticSource

    def tweet_batch(rows):
        """``rows`` synthetic tweets featurized onto the card: the batch, its
        plane and its device-hashed bigrams."""
        tweets = list(SyntheticSource(total=rows, seed=11, base_ms=NOW_MS).produce())
        host = Featurizer(now_ms=NOW_MS, num_text_features=GRAM_F).featurize_batch_units(
            tweets, row_bucket=rows)
        (plane,) = host_planes(host)
        dev = batch_to_device(host, "cuda", non_blocking=False)
        return (dev, plane) + hash_bigrams_device(dev.units, dev.length, GRAM_F)

    dev, plane, idx, val = tweet_batch(GRAM_ROWS)
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

    def b7_time(g, raw, y, m, tol):
        call = lambda: fused_gram.dual_sgd(g, raw, y, m, p_prev=p_prev,  # noqa: E731
                                           convergence_tol=tol, **kw)
        _, _, its = call()
        r = {"barriers": int(fused_gram.dual_sgd.last_barriers)} if structure else {}
        ms, all_ms = timed(call, 25, queue_ahead=True)
        return dict(r, ms=ms, min_ms=min(all_ms), max_ms=max(all_ms), iterations=int(its),
                    us_per_iteration=ms / max(int(its), 1) * 1e3)

    def b7_line(r):
        crossed = f", {r['barriers']} grid barriers" if structure else ""
        return (f"median {r['ms']:.4f} ms over 25 (min {r['min_ms']:.4f}, max "
                f"{r['max_ms']:.4f}), {r['iterations']} iterations run{crossed}, "
                f"{r['us_per_iteration']:.2f} us an iteration")

    b7 = {tol: b7_time(g, raw, y, m, tol) for tol in (0.001, 0.0)}
    b7_twin, _ = timed(lambda: fused_gram.dual_sgd_reference(
        g, raw, y, m, p_prev=p_prev, convergence_tol=0.001, **kw), 5)
    plan = fused_gram.dual_plan(b, **sm_limits())
    its = b7[0.001]["iterations"]
    # each iteration needs one product, G·α_new (2·B² flops: G·Δα is its
    # difference with the last one), and ~12·B elementwise (residual, α
    # update, the four dot products); G read once
    b7_ops = its * (2 * b * b + 12 * b)
    b7_bytes = b * b * 4 + 5 * b * 4
    b7_bound = (b7_bytes / HBM_BYTES_PER_S * 1e3, b7_ops / F32_FLOPS_PER_S * 1e3)
    spread = "; ".join(f"tol {tol}: {b7_line(r)}" for tol, r in b7.items())
    if structure:
        # one barrier crossing alone: the probe on B7's grid, 1000 crossings less none
        fused_gram.dual_barrier_probe(plan.grid, 1000)
        none_ms, _ = timed(lambda: fused_gram.dual_barrier_probe(plan.grid, 0), 25,
                           queue_ahead=True)
        many_ms, _ = timed(lambda: fused_gram.dual_barrier_probe(plan.grid, 1000), 25,
                           queue_ahead=True)
        barrier_us = (many_ms - none_ms) / 1000 * 1e3
        where = ("G in registers" if plan.in_registers
                 else f"{plan.resident_rows} rows of G resident")
        spread += (f"; one grid barrier crossing alone {barrier_us:.3f} us (1000 crossings "
                   f"on {plan.grid} CTAs); {where}")
    phase("times", f"B7 dual loop at B={b}: grid {plan.grid}, {plan.shared_bytes} B shared a "
          f"CTA; {spread}; twin {b7_twin:.4f} ms; bound bytes {b7_bytes} B = "
          f"{b7_bound[0]:.5f} ms, operations {b7_ops} f32 / 67e12 = {b7_bound[1]:.5f} ms")
    # B7 where G's rows do not all fit on chip: B = 3072 and 4096 tweets
    # (the 2^18 route's 4 GiB gate admits both), tolerance 0.001
    spilled = {}
    for rows in (3072, 4096):
        dev_s, plane_s, idx_s, val_s = tweet_batch(rows)
        g_s = fused_gram.gram_from_counts(
            fused_gram.count_build(idx_s, val_s, f, int8=plane_s == PLANE_INT8))
        g_s[:rows, :rows] += dev_s.numeric @ dev_s.numeric.T
        raw_s = sparse_predict(w[:f], w[f:], idx_s, val_s, dev_s.numeric)
        plan_s = fused_gram.dual_plan(rows, **sm_limits())
        spilled[rows] = dict(b7_time(g_s, raw_s, dev_s.label, dev_s.mask, 0.001),
                             grid=plan_s.grid, resident_rows=plan_s.resident_rows,
                             spill_rows=plan_s.spill_rows)
        phase("times", f"B7 dual loop at B={rows} (G spilled): grid {plan_s.grid}, "
              f"{plan_s.resident_rows} rows of G resident, {plan_s.spill_rows} spilled; tol "
              f"0.001: {b7_line(spilled[rows])}")
        del dev_s, idx_s, val_s, g_s, raw_s
    b7_extra = {"kernel": "B7", "iterations_run": its, "all_iterations_ms": b7[0.0]["ms"],
                "grid": plan.grid, "shared_bytes": plan.shared_bytes,
                "tolerances": {str(tol): r for tol, r in b7.items()},
                "spilled": {str(rows): r for rows, r in spilled.items()}}
    if structure:
        b7_extra.update(g_in_registers=plan.in_registers, barrier_crossing_us=barrier_us)
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
        record("dual_sgd", "twtml_tpu/models/sgd.py:155 (run_dual_loop)", b7[0.001]["ms"],
               b7_twin, b7_bound, b7_extra),
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


def spawn_serve(ck, port, log_path, extra=(), counted=False):
    """``python -m twtml_tpu_torch.apps.serve`` on the card, a process of
    its own, every dispatch under the sync-debug mode, with ``extra``
    flags; ``counted`` runs the same entry point under ``COUNTED_SERVE``
    (stop it with ``stop_counted``)."""
    from twtml_tpu_torch.apps.common import SYNC_DEBUG_ENV

    env = dict(os.environ, **{SYNC_DEBUG_ENV: "error"})
    log = open(log_path, "w")
    entry = ["-c", COUNTED_SERVE] if counted else ["-m", "twtml_tpu_torch.apps.serve"]
    proc = subprocess.Popen(
        [sys.executable, *entry, "--backend", "cuda", "--checkpointDir", ck, "--servePort",
         str(port), "--servePromoteEvery", "0.2", "--blackbox", "off", *extra],
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


# ---- phase 21: the tenant plane --------------------------------------------

TENANT_BATCHES = 4
TENANT_M = 4
TENANT_ARGV = [*STREAM_ARGV, "--modelWatch", "on"]
# phrases whose widest code unit puts a row in the lang key's class 102 (CJK:
# U+6587) or 5 (Cyrillic: U+0442); ASCII rows are class 0
LANG_TAILS = (" café 中文", " привет")


def copy_batch(b):
    """A host batch with fresh arrays (the run's arena buffers are reused)."""
    import numpy as np

    from twtml_tpu_torch.features.batch import RaggedUnitBatch

    if isinstance(b, RaggedUnitBatch):
        return RaggedUnitBatch(*(np.array(a) for a in (b.units, b.offsets, b.numeric,
                                                      b.label, b.mask)), row_len=b.row_len)
    return type(b)(*(np.array(a) for a in b))


def tenant_parts(model, wire):
    """The M host parts a tick's wire carried (the routed split of a host
    batch on the padded wire), copied."""
    from twtml_tpu_torch.features.batch import PackedBatch, unpack_batch
    from twtml_tpu_torch.models.sgd import _batch_at

    if isinstance(wire, PackedBatch):
        wire = unpack_batch(wire.buffer.copy(), wire.layout)
    if not model._is_tenant_wire(wire):
        return [copy_batch(p) for p in model.split(wire)]
    return [copy_batch(_batch_at(wire, m)) for m in range(model.num_tenants)]


def tenant_app_run(argv, statuses, app_module=None, expected_errors=(), sync_debug=True):
    """One app run on the tenant plane (``--tenants`` in ``argv``) from a
    pre-filled source of ``statuses`` (None: the source ``argv``
    configures), every dispatch under the sync-debug
    mode "error" unless ``sync_debug`` is False, B1's launch counters set to
    0 just before it and read just after. Records what the run's
    ``TenantStackModel`` saw and returned: each tick's M host parts and
    [M]-leading device StepOutput (the warm-up's apart, checked to train
    nothing), the host fetches it started (``fetch_output``), each stack
    ``set_initial_weights`` installed, the final stack, the tenant view,
    and the registry's guard counters and ``fetch.count`` as deltas."""
    import numpy as np
    import torch

    from twtml_tpu_torch.apps import linear_regression as app
    from twtml_tpu_torch.apps.common import SYNC_DEBUG_ENV
    from twtml_tpu_torch.ops import fused_sgd
    from twtml_tpu_torch.parallel import tenants
    from twtml_tpu_torch.telemetry import metrics, modelwatch
    from twtml_tpu_torch.telemetry import tenants as tenant_view

    rec = {"parts": [], "outputs": [], "fetches": 0, "restored": []}
    base = tenants.TenantStackModel

    class RecordedStack(base):
        def step(self, batch):
            rec["parts"].append(tenant_parts(self, batch))
            out = super().step(batch)
            rec["outputs"].append(out)
            rec["model"] = self
            return out

        def fetch_output(self, out):
            rec["fetches"] += 1
            return base.fetch_output(out)

        def set_initial_weights(self, weights):
            super().set_initial_weights(weights)
            rec["restored"].append(self._weights)
            return self

    reg = metrics.get_registry()
    keys = GUARD_COUNTERS + ("fetch.count",)
    before = {k: reg.counter(k).snapshot() for k in keys}
    base_source = app.build_source
    tenants.TenantStackModel = RecordedStack
    if statuses is not None:
        app.build_source = lambda conf, **_: prefilled_source(statuses)
    # the process-wide model watch keeps a track per tenant it has seen
    # (both packages): a run at another M starts from a fresh watch
    tenant_view.reset_for_tests()
    modelwatch.reset_for_tests()
    errors = ErrorLog()
    logging.getLogger("twtml_tpu_torch").addHandler(errors)
    if sync_debug:
        os.environ[SYNC_DEBUG_ENV] = "error"
    try:
        fused_sgd.fused_dense_sgd.launches = 0
        fused_sgd.fused_dense_sgd.predict_launches = 0
        t0 = time.perf_counter()
        totals, lines = app_run(argv, app_module=app_module)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        rec["wall_s"] = time.perf_counter() - t0
        rec["launches"] = fused_sgd.fused_dense_sgd.launches
        rec["predict_launches"] = fused_sgd.fused_dense_sgd.predict_launches
    finally:
        os.environ.pop(SYNC_DEBUG_ENV, None)
        logging.getLogger("twtml_tpu_torch").removeHandler(errors)
        tenants.TenantStackModel = base
        app.build_source = base_source
    unexpected = [r for r in errors.records
                  if not r.getMessage().startswith(tuple(expected_errors) or ("\0",))]
    if unexpected:
        raise AssertionError("the tenant run logged errors: " + "; ".join(
            f"{r.getMessage()} {r.exc_text or ''}" for r in unexpected))
    rec["counters"] = {k: int(reg.counter(k).snapshot() - before[k]) for k in keys}
    warm = rec["outputs"].pop(0)
    rec["parts"].pop(0)
    rec["fetches"] -= 1  # the warm-up's
    if warm.count.abs().sum().item() != 0:
        raise AssertionError("the tenant warm-up trained rows")
    rec["weights"] = rec["model"].latest_weights
    rec["view"] = tenant_view.last_tenants()
    return totals, lines, rec


def hold_standalone(name, argv, rec, learner_cls):
    """Each tenant against a standalone card learner of the app's
    configuration (its step size and L2) stepped on the tenant's parts:
    every tick's predictions, stats and quality and the final weights
    bitwise."""
    import torch

    from twtml_tpu_torch.config import ConfArguments

    model = rec["model"]
    conf = ConfArguments().parse(list(argv))
    singles = [learner_cls.from_conf(conf, step_size=model.step_sizes[m],
                                     l2_reg=model.l2_regs[m])
               for m in range(model.num_tenants)]
    for t, (out, parts) in enumerate(zip(rec["outputs"], rec["parts"], strict=True)):
        for m, (single, part) in enumerate(zip(singles, parts, strict=True)):
            ref = single.step(part)
            for k in ("predictions", "count", "mse", "real_stdev", "pred_stdev", "quality"):
                a, b = getattr(out, k), getattr(ref, k)
                if (a is None) != (b is None) or (a is not None and not torch.equal(a[m], b)):
                    raise AssertionError(f"{name} tick {t + 1} tenant {m}: {k} is not the "
                                         "standalone learner's")
    for m, single in enumerate(singles):
        if single.latest_weights.tobytes() != rec["weights"][m].tobytes():
            raise AssertionError(f"{name} tenant {m}: final weights are not the standalone "
                                 "learner's")


def tick_rate(totals):
    """Tweets/s over ticks 2..n (delivery to delivery)."""
    steps = totals["steps"]
    return (len(steps) - 1) * OP_ROWS / (steps[-1]["delivered_s"] - steps[0]["delivered_s"])


def trace_costs(profile_dir):
    """Per tick of a ``--profileDir`` run: host launches and copies by
    direction (``dispatch_costs``), and the device's busy ms over the whole
    traced stream (the union of its kernels, copies and sets)."""
    import glob

    path = glob.glob(os.path.join(profile_dir, "*.pt.trace.json"))[0]
    costs = dispatch_costs(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, cursor = 0.0, -math.inf
    for lo, hi in spans:
        lo = max(lo, cursor)
        if hi > lo:
            busy += hi - lo
            cursor = hi
    b1 = sum(1 for e in events if e.get("cat") == "kernel" and KERNEL in e.get("name", ""))
    return costs, busy / 1e3, b1


def lang_statuses(n, seed):
    """``n`` synthetic tweets, every third original's text ending in a
    Latin-1 and CJK or a Cyrillic phrase: rows of three scripts for the
    ``lang`` key (at 4 tenants ASCII rows go to 0, Cyrillic to 1, CJK to 2;
    tenant 3 stays dry)."""
    from twtml_tpu_torch.streaming.sources import SyntheticSource

    statuses = list(SyntheticSource(total=n, seed=seed, base_ms=NOW_MS).produce())
    for i, st in enumerate(statuses):
        if i % 3 == 0:
            st.retweeted_status.text += LANG_TAILS[(i // 3) % 2]
    return statuses


def tenants_phase(stream_statuses, smi):
    """The tenant plane on the card (module docstring, phase 21)."""
    import tempfile

    import numpy as np

    from twtml_tpu_torch.apps import logistic_regression
    from twtml_tpu_torch.apps.common import FORCE_TENANT_PLANE_ENV, SYNC_DEBUG_ENV
    from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
    from twtml_tpu_torch.models.logistic import StreamingLogisticRegressionWithSGD

    t_phase = time.perf_counter()
    n = TENANT_BATCHES
    statuses = stream_statuses[:n * OP_ROWS]
    argv = [*TENANT_ARGV, "--tenants", str(TENANT_M)]
    totals, lines, rec = tenant_app_run(argv, statuses)
    RECORDER.take()
    if (totals["batches"], totals["count"], totals["tenants"], len(rec["outputs"])) != (
            n, n * OP_ROWS, TENANT_M, n):
        raise AssertionError(f"tenants: {totals['batches']} ticks, {totals['count']} rows, "
                             f"{totals['tenants']} tenants, {len(rec['outputs'])} outputs")
    if (rec["launches"], rec["fetches"], rec["counters"]["fetch.count"]) != (
            TENANT_M * (n + 1), n, n) or rec["model"].route != "fused_dense_sgd":
        raise AssertionError(f"tenants: B1 launched {rec['launches']} times, "
                             f"{rec['fetches']} fetches started, fetch.count "
                             f"{rec['counters']['fetch.count']} for {n} ticks + the warm-up")
    hold_standalone("tenants M=4", argv, rec, StreamingLinearRegressionWithSGD)
    rows = [t["rows"] for t in rec["view"]["tenants"]]
    if sum(rows) != n * OP_ROWS:
        raise AssertionError(f"tenants: the view's rows {rows} for {n * OP_ROWS}")
    for line, st in zip(lines, totals["steps"]):
        phase("tenants", f"{line} | host wall {st['pack_ms'] + st['dispatch_ms'] + st['fetch_wait_ms']:.3f}"
              f" ms (route + split + stack {st['pack_ms']:.3f}, dispatch "
              f"{st['dispatch_ms']:.3f}, fetch wait {st['fetch_wait_ms']:.3f}), step "
              f"{st['step_ms']:.3f} ms (CUDA events, {TENANT_M} tenants)")
    phase("tenants", f"M = {TENANT_M}, hash key, ragged wire, {n} ticks of {OP_ROWS} under "
          f"set_sync_debug_mode('error'): B1 launched {rec['launches']} = {TENANT_M} x ({n} "
          f"ticks + the warm-up); {rec['fetches']} fetches for {n} ticks (fetch.count "
          f"{rec['counters']['fetch.count']}): one D2H a tick; rows a tenant {rows}; each "
          "tenant's predictions, stats, quality and final weights bitwise a standalone card "
          "learner stepped on its routed parts")

    twin = tenant_app_run([*argv, "--backend", "cpu"], statuses, sync_debug=False)
    RECORDER.take()
    if twin[1][:1] != lines[:1]:
        raise AssertionError(f"tenants: tick 1 {lines[:1]} != the CPU twin's {twin[1][:1]}")
    w_err, s_err = compare_twin("tenants", (totals, lines, rec), twin, RTOL)
    phase("tenants", f"against the --backend cpu twin: the [{TENANT_M}, 1004] stack "
          f"{w_err:.3g} of the largest weight, pooled stats {s_err:.3g} (tolerance "
          f"{RTOL:g}); tick 1's line identical")

    os.environ[FORCE_TENANT_PLANE_ENV] = "1"
    try:
        forced = tenant_app_run([*TENANT_ARGV, "--tenants", "1"], statuses)
    finally:
        del os.environ[FORCE_TENANT_PLANE_ENV]
    os.environ[SYNC_DEBUG_ENV] = "error"
    try:
        plain = recorded_app_run(TENANT_ARGV, 0, source=prefilled_source(statuses))
    finally:
        del os.environ[SYNC_DEBUG_ENV]
    RECORDER.take()
    launches = (forced[2]["launches"], plain[2]["launches"])
    if (forced[1] != plain[1] or forced[2]["weights"].shape != (1, 1004)
            or forced[2]["weights"][0].tobytes() != plain[2]["weights"].tobytes()
            or launches != (n + 1, n + 1)):
        raise AssertionError("tenants: TWTML_FORCE_TENANT_PLANE=1 --tenants 1 is not the "
                             f"plain run (lines equal {forced[1] == plain[1]}, B1 launched "
                             f"{launches} times)")
    phase("tenants", f"TWTML_FORCE_TENANT_PLANE=1 at --tenants 1: the plain run's {n} lines "
          f"and its weights bitwise, B1 launched {forced[2]['launches']} times as there")

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        poisoned = tenant_app_run(
            [*argv, "--checkpointDir", ck, "--checkpointEvery", "1", "--chaos", "source.nan@3"],
            statuses, expected_errors=GUARD_ERRORS)
        RECORDER.take()
        verified, meta = archive(ck, step=2)
    prec = poisoned[2]
    expect("tenants poisoned", prec["counters"],
           {"model.rollbacks": 1, "model.rows_lost": 0, "model.sentinel_aborts": 0})
    rolled = prec["restored"][-1].cpu().numpy()
    if (poisoned[0]["batches"], poisoned[0]["count"]) != (n, n * OP_ROWS) \
            or rolled.shape != (TENANT_M, 1004) or rolled.tobytes() != verified.tobytes() \
            or prec["weights"].tobytes() != rec["weights"].tobytes() \
            or poisoned[1] != lines or prec["counters"]["journal.replayed_rows"] <= 0:
        raise AssertionError("tenants: the poisoned run did not roll the whole stack back to "
                             "the verified checkpoint and end as the clean run")
    phase("tenants", f"--chaos source.nan@3 with a checkpoint every tick: 1 rollback of the "
          f"whole [{TENANT_M}, 1004] stack, bitwise the verified archive of tick "
          f"{meta.get('step')}; {prec['counters']['journal.replayed_rows']} rows replayed, 0 "
          f"lost; the final stack and the {n} lines bitwise the clean run's; B1 launched "
          f"{prec['launches']} times ({n + 1} ticks + the warm-up, x {TENANT_M})")

    two = two_class_statuses(n * OP_ROWS, 13)
    lg_argv = [*TENANT_ARGV, "--tenants", "2"]
    lg = tenant_app_run(lg_argv, two, app_module=logistic_regression)
    hold_standalone("tenants logistic M=2", lg_argv, lg[2], StreamingLogisticRegressionWithSGD)
    if lg[2]["launches"] != 2 * (n + 1) or lg[0]["batches"] != n:
        raise AssertionError(f"tenants logistic: B1 launched {lg[2]['launches']} times")
    lang_argv = [*argv, "--tenantKey", "lang"]
    lang = tenant_app_run(lang_argv, lang_statuses(n * OP_ROWS, 7))
    RECORDER.take()
    hold_standalone("tenants lang M=4", lang_argv, lang[2], StreamingLinearRegressionWithSGD)
    lang_rows = [t["rows"] for t in lang[2]["view"]["tenants"]]
    dry = [m for m, r in enumerate(lang_rows) if r == 0]
    if sum(r > 0 for r in lang_rows) < 2 or not dry or lang[2]["weights"][dry].any():
        raise AssertionError(f"tenants lang: rows a tenant {lang_rows}")
    phase("tenants", f"the logistic app at M = 2 ({lg[1][-1]}) and --tenantKey lang at M = "
          f"{TENANT_M} (rows a tenant {lang_rows}: dry tenant(s) {dry} with finite stats and "
          "zero weights): each tenant bitwise its standalone card learner; B1 launched "
          f"{lg[2]['launches']} and {lang[2]['launches']} times")

    with tempfile.TemporaryDirectory() as tmp:
        prof = tenant_app_run([*argv, "--profileDir", os.path.join(tmp, "m4")], statuses)
        p_m4 = trace_costs(os.path.join(tmp, "m4"))
        recorded_app_run([*TENANT_ARGV, "--profileDir", os.path.join(tmp, "m1")], 0,
                         source=prefilled_source(statuses))
        p_m1 = trace_costs(os.path.join(tmp, "m1"))
    RECORDER.take()
    if [c["d2h"] for c in p_m4[0]] != [1] * n:
        raise AssertionError(f"tenants: D2H copies a tick {[c['d2h'] for c in p_m4[0]]}")
    out = {"M": TENANT_M}
    for name, run, (costs, busy_ms, b1) in (("M=4", (totals, rec), p_m4),
                                             ("M=1", plain, p_m1)):
        steps = run[0]["steps"][1:]
        host = statistics.mean(st["pack_ms"] + st["dispatch_ms"] + st["fetch_wait_ms"]
                               for st in steps)
        out[name] = {"host_wall_ms_a_tick": host, "device_busy_ms_a_tick": busy_ms / n,
                     "launches_a_tick": statistics.mean(c["launches"] for c in costs),
                     "b1_a_tick": b1 / n, "d2h_a_tick": statistics.mean(c["d2h"] for c in costs),
                     "h2d_a_tick": statistics.mean(c["h2d"] for c in costs),
                     "tweets_per_s": tick_rate(run[0])}
        phase("tenants", f"{name}: host wall {host:.3f} ms a tick (ticks 2-{n}: route/split/"
              f"pack + dispatch + fetch wait), device busy {busy_ms / n:.3f} ms a tick "
              f"(profiler), {out[name]['launches_a_tick']:.0f} host launches a tick "
              f"({b1 / n:.0f} of B1), {out[name]['h2d_a_tick']:.0f} H2D and "
              f"{out[name]['d2h_a_tick']:.0f} D2H copies a tick; {out[name]['tweets_per_s']:.0f}"
              f" tweets/s over ticks 2-{n}")
    out.update(rows_a_tenant=rows, lang_rows=lang_rows, twin_weights_err=w_err,
               twin_stats_err=s_err, launches=rec["launches"],
               launches_logistic=lg[2]["launches"], launches_lang=lang[2]["launches"],
               launches_poisoned=prec["launches"], profiled_stream_s=prof[0]["stream_seconds"])
    phase("tenants", f"phase wall {time.perf_counter() - t_phase:.1f} s | card: {smi}")
    return out


# ---- phase 22: champion/challenger serving -----------------------------------

AB_M = 3
# the serve entry point with the B1 counters and the served batches printed
# as JSON when it stops (SIGINT), so a serve process reports its launches
COUNTED_SERVE = (
    "import json, sys\n"
    "from twtml_tpu_torch.apps import serve\n"
    "from twtml_tpu_torch.ops import fused_sgd\n"
    "from twtml_tpu_torch.telemetry import metrics\n"
    "try:\n"
    "    serve.main(sys.argv[1:])\n"
    "finally:\n"
    "    print(json.dumps({'launches': fused_sgd.fused_dense_sgd.launches,\n"
    "                      'predict_launches': fused_sgd.fused_dense_sgd.predict_launches,\n"
    "                      'batches': int(metrics.get_registry().counter('serve.batches')\n"
    "                                     .snapshot())}), flush=True)\n"
)


def stamps(entries):
    """A checkpoint's quality stamp with a stamp a tenant: [(level, loss)]."""
    return {"level": "ok", "tenants": [
        {"tenant": i, "level": level, "loss": loss, "drift_score": 9.0 if level == "alert"
         else 0.5, "loss_trend": 0.0} for i, (level, loss) in enumerate(entries)]}


def stop_counted(proc):
    """SIGINT a counted serve process and read the counters it printed
    ({} when it printed none: the caller's gate then fails)."""
    import signal

    proc.send_signal(signal.SIGINT)
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)
    proc.log.flush()
    with open(proc.log.name) as fh:
        lines = [ln for ln in fh.read().splitlines() if ln.startswith('{"launches"')]
    return json.loads(lines[-1]) if lines else {}


def abtest_phase(smi, statuses):
    """Champion/challenger serving on the card (module docstring, phase 22)."""
    import tempfile

    import numpy as np

    from twtml_tpu_torch.checkpoint import Checkpointer
    from twtml_tpu_torch.serving import FleetRouter, ServingClient

    t_phase = time.perf_counter()
    n = TENANT_BATCHES
    with tempfile.TemporaryDirectory() as tmp:
        train_ck = os.path.join(tmp, "train")
        totals, _, rec = tenant_app_run(
            [*TENANT_ARGV, "--tenants", str(AB_M), "--checkpointDir", train_ck,
             "--checkpointEvery", "2"], statuses[:n * OP_ROWS])
        RECORDER.take()
        stack1, meta = archive(train_ck)
        trained = (meta.get("quality") or {}).get("tenants") or []
        if (stack1.shape != (AB_M, 1004) or stack1.tobytes() != rec["weights"].tobytes()
                or [t.get("tenant") for t in trained] != list(range(AB_M))):
            raise AssertionError(f"abtest: the trained checkpoint holds {stack1.shape}, "
                                 f"tenant stamps {trained}")
        phase("abtest", f"trained --tenants {AB_M} on the card ({totals['batches']} ticks, "
              f"B1 launched {rec['launches']} times): the verified checkpoint holds the "
              f"[{AB_M}, 1004] stack and a quality stamp a tenant: "
              + json.dumps([{k: t[k] for k in ("tenant", "level", "loss")} for t in trained]))
        stack2 = (stack1 * np.array([[1.0], [0.75], [1.0]], np.float32)).astype(np.float32)
        base = {"count": totals["count"], "batches": totals["batches"]}
        ab_ck, one_ck = os.path.join(tmp, "ab"), os.path.join(tmp, "one")
        Checkpointer(ab_ck).save(1, stack1, dict(base, quality=stamps(
            [("ok", 1.0), ("ok", 5.0), ("ok", 9.0)])))
        Checkpointer(one_ck).save(1, stack1[0], dict(base, quality={"level": "ok"}))
        ports = (free_port(), free_port())
        urls = [f"http://127.0.0.1:{p}" for p in ports]
        procs = [spawn_serve(ab_ck, ports[0], os.path.join(tmp, "ab.log"),
                             extra=("--abtest", "on"), counted=True),
                 spawn_serve(one_ck, ports[1], os.path.join(tmp, "one.log"), counted=True)]
        counts = {}
        try:
            t0 = time.perf_counter()
            for url, proc in zip(urls, procs):
                wait_serving(url, 1, proc)
            boot_s = time.perf_counter() - t0
            pool = serve_pool(statuses)
            refs = RowRefs(pool, {1: stack1[0], 2: stack2[1]})

            def progress(done):
                if done == SWAP_AT:  # mid-load: a checkpoint favouring challenger 1
                    Checkpointer(ab_ck).save(2, stack2, dict(base, quality=stamps(
                        [("ok", 1.0), ("ok", 0.5), ("alert", 0.1)])))

            answers, errors, wall = serve_load(urls[0], pool, SERVE_REQUESTS, SERVE_CLIENTS,
                                               seed=40, progress=progress)
            client = ServingClient(urls[0], timeout=2.0, retries=0)
            end = time.monotonic() + 30
            view = client.serving()
            while (view.get("promotions"), view.get("refusedPromotions")) != (1, 1) \
                    and time.monotonic() < end:
                time.sleep(0.2)
                view = client.serving()
            router = FleetRouter([urls[0]])
            try:
                router.health_check_once()
                fleet = router.stats()
            finally:
                router.stop()
            answers1, errors1, wall1 = serve_load(urls[1], pool, SERVE_REQUESTS,
                                                  SERVE_CLIENTS, seed=40)
        finally:
            for name, proc in zip(("ab", "one"), procs):
                counts[name] = stop_counted(proc) if proc.poll() is None else {}
                proc.log.close()
    if errors or errors1:
        raise AssertionError(f"abtest: client errors {errors[:3]} {errors1[:3]}")
    seen = check_served("abtest", answers, refs, {1, 2})
    check_served("abtest single", answers1, refs, {1})
    if set(seen) != {1, 2}:
        raise AssertionError(f"abtest: answers by step {seen}: the swap did not serve both")
    if (view.get("champion"), view.get("promotions"), view.get("refusedPromotions"),
            fleet.get("champion")) != (1, 1, 1, 1):
        raise AssertionError(f"abtest: Serving view {view}, Fleet view {fleet}")
    ab, one = counts["ab"], counts["one"]
    if (ab.get("predict_launches") != AB_M * (ab.get("batches", -1) + 1)
            or ab.get("launches") != ab.get("predict_launches")
            or one.get("predict_launches") != one.get("batches", -1) + 1):
        raise AssertionError(f"abtest: B1 counts {ab} (A/B), {one} (single model)")
    out = {"boot_s": boot_s, "steps_seen": seen, "counts_ab": ab, "counts_single": one,
           "shadows": view.get("shadows")}
    for name, ans, w in (("A/B", answers, wall), ("single", answers1, wall1)):
        lat = sorted(a[3] for a in ans)
        rows = sum(a[1] for a in ans)
        out[name] = {"requests_per_s": len(ans) / w, "p50_ms": lat[len(lat) // 2] * 1e3,
                     "p99_ms": lat[int(0.99 * (len(lat) - 1))] * 1e3, "rows": rows}
        phase("abtest", f"{name} server (its own process; the {SERVE_CLIENTS} ServingClient "
              f"threads in this one): {len(ans)} requests ({rows} rows) in {w:.3f} s = "
              f"{len(ans) / w:.0f} requests/s, client p50 {out[name]['p50_ms']:.2f} ms, p99 "
              f"{out[name]['p99_ms']:.2f} ms, 0 client errors")
    phase("abtest", f"apps.serve --abtest on up with the single-model server in {boot_s:.1f} "
          f"s; answers by snapshot step {seen}: each bitwise the champion tenant's card train "
          "step under the step it names (step 1: tenant 0; step 2, written mid-load: tenant "
          f"1), none torn; B1 launched {ab['predict_launches']} times = {AB_M} x "
          f"({ab['batches']} served batches + the warm-up), every launch its predict kernel; "
          f"the single model {one['predict_launches']} = {one['batches']} + 1")
    phase("abtest", f"step 2's stamps: challenger 1 (ok, loss 0.5) promoted once "
          f"(abtest.promotions {view['promotions']}), challenger 2 (alert, loss 0.1) refused "
          f"(abtest.promotions_refused {view['refusedPromotions']}); Serving view champion "
          f"{view['champion']}, the router's Fleet view champion {fleet['champion']}; "
          f"shadows {json.dumps(view.get('shadows'))}")
    phase("abtest", f"phase wall {time.perf_counter() - t_phase:.1f} s | card: {smi}")
    return out


# ---- phase 23: block ingest and the digram wire codec ------------------------

BLOCK_BATCHES = 8
BLOCK_ARGV = ["--source", "replay", "--seconds", "0", "--batchBucket", str(OP_ROWS),
              "--maxQueueRows", "-1"]
BLOCK_ARMS = (("object", []), ("block", ["--ingest", "block"]),
              ("block+codec", ["--ingest", "block", "--wireCodec", "dict"]))
BLOCK_COUNTERS = GUARD_COUNTERS + ("wire.codec_fallbacks", "ingest.rows_dropped_parse")
BLOCK_FIELDS = ("predictions", "quality", "count", "mse", "real_stdev", "pred_stdev")
# CUDA-event timings of the device decode
DECODE_RUNS = 25


def block_run(argv, max_batches=0, **kw):
    """One app run of the block phase from the replay file ``argv`` names,
    every dispatch under the sync-debug mode "error" on the card: the
    registry's counters as deltas over the run, and the parse rate gauge."""
    from twtml_tpu_torch.apps.common import SYNC_DEBUG_ENV
    from twtml_tpu_torch.telemetry import metrics

    reg = metrics.get_registry()
    before = {k: reg.counter(k).snapshot() for k in BLOCK_COUNTERS}
    reg.gauge("ingest.parse_tweets_per_s").set(0.0)
    os.environ[SYNC_DEBUG_ENV] = "error"
    try:
        totals, lines, rec = recorded_app_run(argv, max_batches,
                                              expected_errors=GUARD_ERRORS, **kw)
    finally:
        del os.environ[SYNC_DEBUG_ENV]
    rec["counters"] = {k: int(reg.counter(k).snapshot() - before[k]) for k in BLOCK_COUNTERS}
    rec["parse_rate"] = reg.gauge("ingest.parse_tweets_per_s").value
    rec["codec_ratio"] = reg.gauge("wire.codec_ratio").value
    return totals, lines, rec


def hold_bitwise(name, runs):
    """Every run of ``runs`` ({arm: (totals, lines, rec)}) bitwise the
    first's: the rows of each batch, the lines, the final weights, and each
    batch's predictions, quality and stats."""
    import numpy as np
    import torch

    (ref_arm, (ref_totals, ref_lines, ref)), *rest = runs.items()
    ref_rows = [st["count"] for st in ref_totals["steps"]]
    for arm, (totals, lines, rec) in rest:
        rows = [st["count"] for st in totals["steps"]]
        if rows != ref_rows:
            raise AssertionError(f"{name} {arm}: batch rows {rows} against {ref_arm}'s "
                                 f"{ref_rows}")
        if lines != ref_lines or not np.array_equal(rec["weights"], ref["weights"]):
            raise AssertionError(f"{name} {arm}: lines or weights differ from {ref_arm}'s")
        for i, (a, b) in enumerate(zip(rec["outputs"], ref["outputs"], strict=True)):
            for k in BLOCK_FIELDS:
                x, y = getattr(a, k), getattr(b, k)
                if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
                    raise AssertionError(f"{name} {arm} batch {i + 1}: {k} differs from "
                                         f"{ref_arm}'s")
    return ref_rows


def block_wires(path, n=3):
    """The first ``n`` batches of the replay file through the block parser
    (the wire emitter) and ``featurize_parsed_block``: (ragged batches, raw
    packed wires, coded packed wires, median ms of the raw pack and of the
    coded pack over 5 runs of each batch)."""
    from twtml_tpu_torch.features.batch import pack_batch
    from twtml_tpu_torch.features.blocks import iter_row_chunks
    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.streaming.sources import BlockReplayFileSource

    featurizer = Featurizer(now_ms=NOW_MS)
    chunks = iter_row_chunks(BlockReplayFileSource(path, wire=True).produce(), OP_ROWS)
    batches = [featurizer.featurize_parsed_block(next(chunks), row_bucket=OP_ROWS, ragged=True)
               for _ in range(n)]
    times = {"raw": [], "dict": []}
    for rb in batches:
        for codec in ("raw", "dict"):
            for _ in range(5):
                t0 = time.perf_counter()
                wire = pack_batch(rb, codec=None if codec == "raw" else codec)
                times[codec].append((time.perf_counter() - t0) * 1e3)
                wire.lease.retire()
    raw = [pack_batch(rb) for rb in batches]
    coded = [pack_batch(rb, codec="dict") for rb in batches]
    return batches, raw, coded, {k: statistics.median(v) for k, v in times.items()}


def step_profile(wires):
    """Device busy ms and device kernels (copies apart) a step over steps
    2..n of ``wires`` on a fresh card model (step 1 pays first-use set-up),
    from torch.profiler's device events."""
    from torch.profiler import ProfilerActivity, profile

    model = model_after_batch_1(wires)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for wire in wires[1:]:
            float(model.step(wire).mse)
    events = [ev for ev in prof.key_averages() if ev.device_time_total]
    steps = sum(ev.count for ev in events if KERNEL in ev.key)
    if not steps:
        return None
    busy = sum(ev.device_time_total for ev in events) / steps / 1e3
    kernels = sum(ev.count for ev in events
                  if "Memcpy" not in ev.key and "Memset" not in ev.key) / steps
    copies = sum(ev.count for ev in events if "Memcpy" in ev.key) / steps
    return {"busy_ms": busy, "kernels": kernels, "copies": copies, "steps": steps}


def decode_times(coded):
    """``units_from_codes`` on the card at the operating point: the coded
    units of a packed wire decoded DECODE_RUNS times between CUDA events,
    bitwise the host decode: the device's time (queued ahead: median, min
    ms) and the call's time as the step issues it (its launches not queued
    ahead: median ms)."""
    import numpy as np
    import torch

    from twtml_tpu_torch.features.batch import _layout_codec
    from twtml_tpu_torch.features.wirecodec import decode_np
    from twtml_tpu_torch.ops.ragged import units_from_codes

    (m,), _ = coded.layout[1][0]
    out_len = int(np.prod(_layout_codec(coded.layout)[1]))
    codes = torch.from_numpy(np.asarray(coded.buffer[:m]).copy()).to("cuda")
    got = units_from_codes(codes, out_len)
    if not np.array_equal(got.cpu().numpy(), decode_np(np.asarray(coded.buffer[:m]), out_len)):
        raise AssertionError("block: units_from_codes on the card differs from the host decode")
    ms, times = timed(lambda: units_from_codes(codes, out_len), DECODE_RUNS, queue_ahead=True,
                      ahead_cycles=PREDICT_AHEAD_CYCLES)
    issued, _ = timed(lambda: units_from_codes(codes, out_len), DECODE_RUNS)
    return {"ms": ms, "min_ms": min(times), "issued_ms": issued, "codes": m, "units": out_len}


def block_phase(pool, smi):
    """Block ingest and the digram codec on the card (module docstring,
    phase 23), from a replay file of the superbatch phase's 8 one-bucket
    batches."""
    import tempfile

    import numpy as np

    from twtml_tpu_torch.apps import kmeans as kmeans_app
    from twtml_tpu_torch.apps import logistic_regression
    from twtml_tpu_torch.features.arena import get_arena
    from twtml_tpu_torch.features.blocks import ParsedBlock
    from twtml_tpu_torch.models.logistic import StreamingLogisticRegressionWithSGD
    from twtml_tpu_torch.streaming.journal import IntakeJournal

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="twtml-block-")
    path = os.path.join(tmp, "stream.jsonl")
    write_replay(path, pool)
    twice = os.path.join(tmp, "twice.jsonl")
    with open(path, "rb") as src, open(twice, "wb") as dst:
        data = src.read()
        dst.write(data + data)
    phase("block", f"replay file of {len(pool)} tweets ({len(data)} B), written in "
          f"{time.perf_counter() - t_phase:.2f} s | card: {smi}")
    argv = ["--backend", "cuda", *BLOCK_ARGV, "--replayFile", path]

    # -- the three ingest arms: the same batches, bitwise
    runs = {}
    for arm, extra in BLOCK_ARMS:
        totals, lines, rec = block_run([*argv, *extra])
        if (totals["batches"], totals["count"], rec["launches"]) != (
                BLOCK_BATCHES, BLOCK_BATCHES * OP_ROWS, BLOCK_BATCHES + 1):
            raise AssertionError(f"block {arm}: {totals['batches']} batches, "
                                 f"{totals['count']} rows, B1 launched {rec['launches']}")
        check_counters(f"block {arm}", rec, BLOCK_BATCHES, "ragged")
        parse = rec["parse"]
        if arm != "object" and not (parse["parses_wire"] >= 1 and parse["parses_native"]
                                    == parse["parses_python"] == parse["wire_degraded"]
                                    == parse["native_degraded"] == 0):
            raise AssertionError(f"block {arm}: parse counters {parse}")
        if rec["counters"]["wire.codec_fallbacks"] or rec["counters"][
                "ingest.rows_dropped_parse"]:
            raise AssertionError(f"block {arm}: counters {rec['counters']}")
        if arm == "block+codec" and not all(st.get("units_coded_bytes") for st in
                                            totals["steps"]):
            raise AssertionError("block+codec: a batch shipped raw units")
        runs[arm] = (totals, lines, rec)
    rows = hold_bitwise("block", runs)
    phase("block", f"object, block and block+codec arms: batch rows {rows}, lines, "
          "weights, predictions, stats and quality bitwise equal; B1 launched "
          f"{BLOCK_BATCHES} + 1 times in each, every dispatch under "
          "set_sync_debug_mode('error'); wire emitter parses "
          f"{runs['block+codec'][2]['parse']['parses_wire']}, 0 degraded, 0 codec fallbacks")
    summary = {}
    for arm, (totals, lines, rec) in runs.items():
        later = totals["steps"][1:]
        subs = {}
        for st in later:
            for k, v in st["featurize_substages_ms"].items():
                subs[k] = subs.get(k, 0.0) + v / len(later)
        span = later[-1]["delivered_s"] - totals["steps"][0]["delivered_s"]
        rate = len(later) * OP_ROWS / span
        mean = {k: statistics.mean(st[k] for st in later)
                for k in ("featurize_ms", "pack_ms", "wire_bytes", "step_ms", "dispatch_ms")}
        units = [st.get("units_bytes") for st in later]
        coded = [st.get("units_coded_bytes") for st in later]
        summary[arm] = {"featurize_ms": mean["featurize_ms"], "substages_ms": subs,
                        "pack_ms": mean["pack_ms"], "wire_bytes": mean["wire_bytes"],
                        "step_ms": mean["step_ms"], "tweets_per_s": rate,
                        "parse_tweets_per_s": rec["parse_rate"] or None,
                        "units_bytes": units[0], "units_coded_bytes": coded[0],
                        "codec_ratio": rec["codec_ratio"] if coded[0] else None,
                        "parse": rec["parse"]}
        phase("block", f"{arm}: batches 2-{BLOCK_BATCHES} mean featurize "
              f"{mean['featurize_ms']:.2f} ms (" + ", ".join(
                  f"{k} {v:.2f}" for k, v in subs.items()) + f"), pack {mean['pack_ms']:.3f} "
              f"ms, wire {mean['wire_bytes']:.0f} B" + (
                  f" (units {units[0]} B raw, {coded[0]} B coded, wire.codec_ratio "
                  f"{rec['codec_ratio']})" if coded[0] else "")
              + f", step {mean['step_ms']:.3f} ms (CUDA events); "
              f"{len(later) * OP_ROWS} tweets delivered in {span:.4f} s = {rate:.0f} "
              f"tweets/s; parse rate {rec['parse_rate']:.0f} tweets/s (the "
              "ingest.parse_tweets_per_s gauge, last chunk)" + "; lines: " + " / ".join(
                  lines[:2]))

    # -- the CPU twin of the coded arm
    cpu_totals, cpu_lines = app_run(["--backend", "cpu", *BLOCK_ARGV, "--replayFile", path,
                                     *BLOCK_ARMS[2][1]])
    card_totals, card_lines, _ = runs["block+codec"]
    if card_lines[0] != cpu_lines[0] or len(cpu_lines) != BLOCK_BATCHES:
        raise AssertionError(f"block: batch 1 on the card {card_lines[0]!r}, on the CPU "
                             f"{cpu_lines[0]!r} ({len(cpu_lines)} lines)")
    s_err = 0.0
    for i, (g, c) in enumerate(zip(card_totals["steps"], cpu_totals["steps"], strict=True)):
        for k in ("count", "mse", "real_stdev", "pred_stdev"):
            err = abs(g[k] - c[k]) / max(abs(c[k]), 1e-30)
            s_err = max(s_err, err)
            if abs(g[k] - c[k]) > RTOL * abs(c[k]) + ATOL:
                raise AssertionError(f"block batch {i + 1} {k}: card {g[k]} cpu {c[k]}")
    phase("block", f"block+codec against --backend cpu: batch 1's line identical, every "
          f"stat of {BLOCK_BATCHES} batches within rtol {RTOL:g} (largest {s_err:.3g})")

    # -- the wire and the device decode at the operating point
    get_arena().use_device("cuda")
    batches, raw, coded, pack_ms = block_wires(path)
    h2d = {"raw": h2d_ms(raw[1]), "dict": h2d_ms(coded[1])}
    prof = {"raw": step_profile(raw), "dict": step_profile(coded)}
    decode = decode_times(coded[0])
    decode_launches = (None if None in prof.values()
                       else prof["dict"]["kernels"] - prof["raw"]["kernels"])
    phase("block", f"pack of a batch (median of 15): raw {pack_ms['raw']:.3f} ms, coded "
          f"{pack_ms['dict']:.3f} ms (the encode: {pack_ms['dict'] - pack_ms['raw']:.3f} ms); "
          f"wire {raw[1].buffer.nbytes} B raw, {coded[1].buffer.nbytes} B coded; H2D "
          f"(batch_to_device, synchronised, median/min of 20): raw {h2d['raw'][0]:.3f}/"
          f"{h2d['raw'][1]:.3f} ms, coded {h2d['dict'][0]:.3f}/{h2d['dict'][1]:.3f} ms")
    for codec, p in prof.items():
        if p is None:
            phase("block", f"{codec} step: the profiler recorded no step kernel; not measured")
            continue
        phase("block", f"{codec} wire, steps 2-3 (profiler): {p['busy_ms']:.3f} ms device "
              f"busy a step, {p['kernels']:g} device kernels and {p['copies']:g} copies a "
              "step")
    phase("block", f"the codec's decode: {decode_launches} kernels a step; "
          f"units_from_codes alone {decode['ms']:.4f} ms of device time (queued ahead, "
          f"median of {DECODE_RUNS}, min {decode['min_ms']:.4f}; CUDA events), "
          f"{decode['issued_ms']:.4f} ms as the step issues it (its launches not queued "
          f"ahead), for {decode['codes']} codes to {decode['units']} units, bitwise the "
          "host decode")

    # -- the superbatch and the tenant plane with the codec
    sb_argv = ["--backend", "cuda", *BLOCK_ARGV, "--replayFile", twice, "--ingest", "block",
               "--superBatch", str(SB_K), "--tokenBucket", "64", "--wirePack", "group"]
    sb = {}
    for arm, extra in (("group", []), ("group+codec", ["--wireCodec", "dict"])):
        totals, lines, rec = block_run([*sb_argv, *extra])
        if (totals["batches"], rec["groups"], rec["captured"]) != (2 * BLOCK_BATCHES, 3, 2):
            raise AssertionError(f"block superbatch {arm}: {totals['batches']} batches, "
                                 f"{rec['groups']} step_many calls, {rec['captured']} graphs")
        rec["outputs"] = rec["outputs"][SB_K:]  # the warm-up group's
        sb[arm] = (totals, lines, rec)
    hold_bitwise("block superbatch", sb)
    phase("block", f"--superBatch {SB_K} --wirePack group, {2 * BLOCK_BATCHES} block batches: "
          "with --wireCodec dict bitwise without it; 2 groups a run, the second replaying "
          "the CUDA graph the first captured (the decode inside it); B1 launches "
          f"{sb['group+codec'][2]['launches']} (the warm-up group's included)")
    tn_argv = ["--backend", "cuda", *BLOCK_ARGV, "--replayFile", path, "--ingest", "block",
               "--tenants", str(TENANT_M), "--wirePack", "group"]
    tn = {}
    for arm, extra in (("group", []), ("group+codec", ["--wireCodec", "dict"])):
        totals, lines, rec = tenant_app_run([*tn_argv, *extra], None)
        if (totals["batches"], rec["launches"]) != (BLOCK_BATCHES,
                                                    TENANT_M * (BLOCK_BATCHES + 1)):
            raise AssertionError(f"block tenants {arm}: {totals['batches']} ticks, B1 "
                                 f"launched {rec['launches']}")
        tn[arm] = (totals, lines, rec)
    hold_bitwise("block tenants", tn)
    RECORDER.take()
    phase("block", f"--tenants {TENANT_M} --wirePack group on the block source: with "
          f"--wireCodec dict bitwise without it over {BLOCK_BATCHES} ticks (lines, the "
          f"[{TENANT_M}, 1004] stack, each tick's outputs); B1 "
          f"{tn['group+codec'][2]['launches']} launches")

    # -- the logistic and k-means apps on block batches, against the CPU
    two = os.path.join(tmp, "two_class.jsonl")
    write_replay(two, two_class_statuses(LOGISTIC_BATCHES * OP_ROWS, 11))
    lg = dict(app_module=logistic_regression, learner=StreamingLogisticRegressionWithSGD)
    lg_argv = [*BLOCK_ARGV, "--replayFile", two, "--ingest", "block"]
    totals, lines, rec = block_run(["--backend", "cuda", *lg_argv], LOGISTIC_BATCHES, **lg)
    _, cpu_lines, _ = recorded_app_run(["--backend", "cpu", *lg_argv], LOGISTIC_BATCHES, **lg)
    if lines != cpu_lines or rec["launches"] != LOGISTIC_BATCHES + 1:
        raise AssertionError(f"block logistic: lines {lines} against the CPU's {cpu_lines}, "
                             f"B1 launched {rec['launches']}")
    km_argv = [*BLOCK_ARGV, "--replayFile", path, "--ingest", "block"]
    _, km_lines, km = kmeans_run("cuda", None, km_argv)
    _, kc_lines, kc = kmeans_run("cpu", None, km_argv)
    RECORDER.take()
    if (km_lines != kc_lines or len(km_lines) != KMEANS_BATCHES
            or not all(np.array_equal(a, b) for a, b in zip(km["assign"], kc["assign"],
                                                             strict=True))):
        raise AssertionError(f"block kmeans: lines {km_lines} against the CPU's {kc_lines}")
    phase("block", f"logistic app, {LOGISTIC_BATCHES} two-class block batches: lines equal "
          f"the CPU run's ({lines[-1]}); k-means, {KMEANS_BATCHES} block batches (every "
          f"retweet): lines and assignments equal the CPU run's ({km_lines[-1]})")

    # -- a poisoned batch rolls back and replays its rows from kind-2 records
    ck = ["--ingest", "block", "--checkpointEvery", "1"]
    clean, clean_lines, _ = block_run([*argv, *ck, "--checkpointDir", f"{tmp}/clean"])
    got, lines, rec = block_run([*argv, *ck, "--checkpointDir", f"{tmp}/poison",
                                 "--chaos", "source.nan@5"])
    expect("block poison@5", {**rec["counters"], "batches": got["batches"],
                              "count": got["count"], "fetches": rec["fetches"]},
           {"model.rollbacks": 1, "model.nonfinite_batches": 1, "model.rows_lost": 0,
            "journal.replayed_rows": OP_ROWS, "fetch.aborts": 0, "checkpoint.quarantined": 0,
            "fetches": BLOCK_BATCHES + 1, "batches": BLOCK_BATCHES,
            "count": BLOCK_BATCHES * OP_ROWS})
    journal = IntakeJournal(f"{tmp}/poison/journal")
    items = [item for _, its in journal.records_from(0) for item in its]
    journal.close()
    w_p, meta_p = archive(f"{tmp}/poison")
    w_c, meta_c = archive(f"{tmp}/clean")
    if (lines != clean_lines or not np.array_equal(w_p, w_c)
            or meta_p["count"] != meta_c["count"]
            or not items or not all(isinstance(b, ParsedBlock) for b in items)):
        raise AssertionError(f"block poison@5: lines, final archive or the journal's "
                             f"{len(items)} records differ from the clean run's")
    RECORDER.take()
    wall = time.perf_counter() - t_phase
    phase("block", f"--chaos source.nan@5 --checkpointEvery 1: 1 rollback, "
          f"{OP_ROWS} rows replayed from the journal's kind-2 (block) records "
          f"({len(items)} records, {sum(b.rows for b in items)} rows on disk), 0 lost; "
          f"lines and the final archive bitwise the clean run's; phase wall {wall:.1f} s "
          f"| card: {smi}")
    return {"launches": runs["block+codec"][2]["launches"], "arms": summary,
            "cpu_stats_err": s_err, "pack_ms": pack_ms,
            "wire_bytes": {"raw": int(raw[1].buffer.nbytes),
                           "dict": int(coded[1].buffer.nbytes)},
            "h2d_ms": {k: v[0] for k, v in h2d.items()}, "step": prof,
            "decode_launches": decode_launches, "decode": decode, "seconds": wall}


# ---- the multihost phase: the lockstep runtime, 2 ranks on cuda:0 over gloo ----

MH_RANKS = 2
MH_ROWS = OP_ROWS // MH_RANKS  # a rank's rows of the global B = 16384
MH_BATCHES = 4
MH_ARGV = ["--backend", "cuda", "--source", "replay", "--seconds", "0", "--tokenBucket", "64",
           "--maxQueueRows", "-1"]
MH_GRAM_ARGV = ["--numTextFeatures", str(GRAM_F), "--l2Reg", "0.1"]
MH_TIMEOUT_S = 300
MH_WATCHDOG_S = 20  # TWTML_LOCKSTEP_TIMEOUT_S of the peer.kill arm
MH_WEIGHT_RTOL, MH_WEIGHT_ATOL = 1e-4, 1e-7  # the JAX multi-host test's
MH_STAT_SLACK = 2  # rounded stats: the JAX multi-host test's rule
SPLIT_ENTRIES = ("fused_dense_grad", "fused_dense_grad_reduce", "fused_dense_update")

# one rank: the linear app as ``main`` runs it (``run`` on the parsed flags),
# then its launch counts, collectives and step times as the last line
MH_RANK = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from twtml_tpu_torch.apps import linear_regression
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.ops import fused_gram, fused_sgd
from twtml_tpu_torch.parallel import distributed
from twtml_tpu_torch.telemetry import metrics
failed, totals = None, {}
try:
    totals = linear_regression.run(ConfArguments().parse(sys.argv[2:]))
except RuntimeError as exc:
    failed = str(exc)
launches = {n: getattr(fused_sgd, n).launches for n in
            ("fused_dense_grad", "fused_dense_grad_reduce", "fused_dense_update")}
launches["fused_dense_sgd"] = fused_sgd.fused_dense_sgd.launches
launches.update({fn.__name__: fn.launches for fn in fused_gram.KERNELS})
print(json.dumps({"failed": failed, "count": totals.get("count"),
                  "batches": totals.get("batches"),
                  "stream_seconds": totals.get("stream_seconds"),
                  "step_ms": [s.get("step_ms") for s in totals.get("steps", [])],
                  "launches": launches, "collectives": distributed.COUNTERS,
                  "seconds": distributed.SECONDS,
                  "counters": metrics.get_registry().snapshot()["counters"]}), flush=True)
sys.stdout.flush()
sys.exit(3 if failed else 0)
"""


def mh_group(name, argv, env=None, timeout=MH_TIMEOUT_S):
    """The linear app on MH_RANKS ranks of one group (``--master
    twtml://``, every rank on cuda:0, so gloo): each rank's (exit code,
    stats lines, its JSON record or None, stderr tail, wall s). Every rank
    is stopped before this returns."""
    port = free_port()
    full_env = dict(os.environ, **(env or {}))
    full_env.pop("TWTML_SYNC_DEBUG", None)  # a gloo all-reduce waits for the card
    procs, t0 = [], time.perf_counter()
    for rank in range(MH_RANKS):
        args = [sys.executable, "-c", MH_RANK, PACKAGE_ROOT, *argv,
                "--lightning", RECORDER.url, "--twtweb", RECORDER.url,
                "--master", f"twtml://127.0.0.1:{port}", "--numProcesses", str(MH_RANKS),
                "--processId", str(rank)]
        procs.append(subprocess.Popen(args, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True, env=full_env))
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=timeout)
            lines = stdout.splitlines()
            rec = None
            if lines and lines[-1].startswith("{"):
                rec = json.loads(lines[-1])
            out.append((p.returncode, [ln for ln in lines if ln.startswith("count:")], rec,
                        stderr[-4000:], time.perf_counter() - t0))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return out


def mh_ok(name, results):
    for rank, (rc, _lines, rec, err, _wall) in enumerate(results):
        if rc != 0 or rec is None or rec["failed"]:
            raise AssertionError(f"multihost {name}: rank {rank} exited {rc}:\n{err}")
    return results


def mh_hold_lines(name, got, want):
    """The JAX multi-host test's rule for the lead's lines against one
    process's: as many lines, count and batch exact, rounded stats within
    MH_STAT_SLACK."""
    import re

    if len(got) != len(want) or not got:
        raise AssertionError(f"multihost {name}: {len(got)} lines against {len(want)}")
    for g_line, w_line in zip(got, want):
        g = [int(x) for x in re.findall(r"-?\d+", g_line)]
        w = [int(x) for x in re.findall(r"-?\d+", w_line)]
        if g[:2] != w[:2] or len(g) != len(w) or any(
                abs(a - b) > MH_STAT_SLACK for a, b in zip(g[2:], w[2:])):
            raise AssertionError(f"multihost {name}: {g_line!r} against {w_line!r}")


def mh_hold_weights(name, got_dir, want):
    import numpy as np

    from twtml_tpu_torch.checkpoint import Checkpointer

    got, meta = Checkpointer(got_dir).restore()
    got = np.asarray(got)
    err = float(np.max(np.abs(got - want)))
    if not np.allclose(got, want, rtol=MH_WEIGHT_RTOL, atol=MH_WEIGHT_ATOL):
        raise AssertionError(f"multihost {name}: weights differ from one process's by "
                             f"{err:.3g} (rtol {MH_WEIGHT_RTOL}, atol {MH_WEIGHT_ATOL})")
    return err, meta


def mh_arm(name, path, workdir, rows, extra=(), single_rows=None):
    """One arm: the group on ``path`` at ``rows`` a rank against one
    process on the card (in this process) at ``single_rows``; the lead's
    lines and the final weights held, the follower silent. Returns the
    ranks' records, the single run's totals and the weights' max error."""
    from twtml_tpu_torch.checkpoint import Checkpointer

    d_multi, d_single = (os.path.join(workdir, f"{name}-{k}") for k in ("multi", "single"))
    argv = [*MH_ARGV, "--replayFile", path, *extra]
    totals, single_lines = app_run(
        [*argv, "--batchBucket", str(single_rows or rows * MH_RANKS),
         "--checkpointDir", d_single])
    results = mh_ok(name, mh_group(name, [*argv, "--batchBucket", str(rows),
                                          "--checkpointDir", d_multi]))
    if results[1][1]:
        raise AssertionError(f"multihost {name}: the follower printed {results[1][1][:2]}")
    single_lines = [ln for ln in single_lines if ln.startswith("count:")]
    mh_hold_lines(name, results[0][1], single_lines)
    err, meta = mh_hold_weights(name, d_multi, Checkpointer(d_single).restore()[0])
    if meta["count"] != totals["count"]:
        raise AssertionError(f"multihost {name}: the group counted {meta['count']} rows, "
                             f"one process {totals['count']}")
    phase("multihost", f"{name}: {len(single_lines)} lines held (count and batch exact, "
          f"stats within {MH_STAT_SLACK}), weights within {err:.3g} of one process's, "
          f"follower silent; group wall {results[0][4]:.1f} s")
    return [r[2] for r in results], totals, err, d_multi, argv


def mh_rank_numbers(name, recs, totals, steps):
    """Per rank: step device ms, launches a step (``steps``: the batches and
    the warm-up's), the all-reduce's and the cadence all-gather's host ms,
    host wall a tick; tweets/s against one process."""
    import statistics as st

    out = []
    single_rate = totals["count"] / totals["stream_seconds"]
    for rank, rec in enumerate(recs):
        c, s = rec["collectives"], rec["seconds"]
        ticks = max(1, c["cadence_allgathers"])
        row = {
            "rank": rank,
            "step_device_ms": st.median(rec["step_ms"]) if rec["step_ms"] else None,
            "launches_a_step": {k: v / steps for k, v in rec["launches"].items() if v},
            "allreduce_ms": 1e3 * s["allreduce"] / max(1, c["allreduces"]),
            "allreduces_a_step": c["allreduces"] / steps,
            "cadence_allgather_ms": 1e3 * s["cadence_allgather"] / ticks,
            "host_wall_a_tick_ms": 1e3 * rec["stream_seconds"] / ticks,
            "ticks": ticks,
            "tweets_per_s": rec["count"] / rec["stream_seconds"],
            "single_process_tweets_per_s": single_rate,
        }
        out.append(row)
        phase("multihost", f"{name} rank {rank}: step {row['step_device_ms']:.3f} ms "
              f"(CUDA events), launches a step {row['launches_a_step']}, all-reduce "
              f"{row['allreduce_ms']:.3f} ms x {row['allreduces_a_step']:.0f} a step, cadence "
              f"all-gather {row['cadence_allgather_ms']:.3f} ms, host wall a tick "
              f"{row['host_wall_a_tick_ms']:.1f} ms, {row['tweets_per_s']:.0f} tweets/s "
              f"(one process {single_rate:.0f})")
    return out


def split_checks():
    """The split at world size 1 through MultiHostSGDModel (a one-rank gloo
    group) against B1 on the same wire, bitwise, in both residual modes;
    each split entry against its plain twin on the card. Returns each
    entry's max error against its twin."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
    from twtml_tpu_torch.models.logistic import StreamingLogisticRegressionWithSGD
    from twtml_tpu_torch.ops import fused_sgd
    from twtml_tpu_torch.parallel import distributed as D
    from twtml_tpu_torch.parallel.mesh import make_mesh
    from twtml_tpu_torch.parallel.sharding import ParallelSGDModel
    from twtml_tpu_torch.streaming.sources import SyntheticSource

    statuses = list(SyntheticSource(total=OP_ROWS, seed=11, base_ms=NOW_MS).produce())
    batch = Featurizer(now_ms=NOW_MS).featurize_batch_ragged(
        statuses, row_bucket=OP_ROWS, unit_bucket=64)
    store = dist.TCPStore("127.0.0.1", free_port(), 1, is_master=True,
                          timeout=datetime.timedelta(seconds=60))
    dist.init_process_group("gloo", store=store, world_size=1, rank=0)
    try:
        for learner in (StreamingLinearRegressionWithSGD, StreamingLogisticRegressionWithSGD):
            plain = learner(device="cuda", quality=True)
            mesh = make_mesh(num_processes=1)
            inner = ParallelSGDModel(
                mesh, D.Collectives(rank=0, world=1, staged=True), device="cuda",
                quality=True, residual_fn=learner.residual_fn,
                prediction_fn=learner.prediction_fn,
                round_predictions=learner.round_predictions,
                step_size=learner.default_step_size)
            multi = D.MultiHostSGDModel(inner, mesh)
            before = fused_sgd.fused_dense_grad.launches
            for _ in range(2):  # the second step from the first's weights
                a, b = plain.step(batch), multi.step(multi.pack_for_wire(batch))
            torch.cuda.synchronize()
            if fused_sgd.fused_dense_grad.launches - before != 2 * OP_ITERS:
                raise AssertionError("the world-size-1 step did not run the split kernels")
            same = (np.array_equal(plain.latest_weights, multi.latest_weights)
                    and torch.equal(a.predictions, b.predictions)
                    and all(torch.equal(getattr(a, k), getattr(b, k))
                            for k in ("count", "mse", "real_stdev", "pred_stdev")))
            if not same:
                raise AssertionError(f"{learner.__name__}: the split loop at world size 1 "
                                     "differs from B1")
            phase("multihost", f"split at world size 1 through MultiHostSGDModel, "
                  f"{learner.__name__}: weights, predictions and stats bitwise B1's "
                  "(2 steps)")
    finally:
        dist.destroy_process_group()
    return split_twin_errors()


SPLIT_SHAPES = ((MH_ROWS, 1004), (4096, 2000), (4096, 8196))  # narrow, wide (2 and 9 tiles)


def split_inputs(rows=MH_ROWS, features=1004, seed=5, logistic=False):
    """A tweet-like batch (``design``) on the card for the split's checks
    and times: 97 % of the rows valid, a small w0, 0/1 labels for the
    logistic mode."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x, y, m = design(rng, rows, features, rows - rows // 32)
    if logistic:
        y = (rng.random(rows) < 0.5).astype("float32")
    w0 = rng.normal(size=features).astype("float32") * 1e-3
    return tuple(torch.from_numpy(a).cuda() for a in (x, y, m, w0))


def split_update_twin(w, gbuf, f, *, it, step_size, l2_reg, tol):
    """The update entry's function as torch ops: B1's f32 update of the
    F columns with the all-reduced Xᵀr and count (no update at count 0),
    then ‖Δw‖², ‖w‖² and the converged test. Returns (w', converged)."""
    import torch

    from twtml_tpu_torch.models.sgd import _step_scalars

    eta, scale = _step_scalars(step_size, l2_reg, it, torch.float32)
    count = gbuf[-1]
    w_new = torch.where(count > 0, w * scale - eta * gbuf[:f] / count.clamp(min=1.0), w)
    d, n = ((w_new - w) ** 2).sum(), (w_new * w_new).sum()
    return w_new, bool(tol > 0) & (d.sqrt() < tol * n.sqrt().clamp(min=1.0))


def split_loop_check(name, x, y, m, w0, **kw):
    """The split loop at world size 1 (the all-reduce an identity) against
    B1 on the same inputs: weights and margins bitwise; with NaN/Inf in the
    masked rows, bitwise the clean run's."""
    import torch

    from twtml_tpu_torch.ops import fused_sgd

    w_b1, p_b1 = fused_sgd.fused_dense_sgd(x, y, m, w0, **kw)
    w_s, p_s = fused_sgd.fused_dense_sgd_split(x, y, m, w0, allreduce=lambda t: t, **kw)
    keep = m > 0
    x_d = torch.where(keep[:, None], x, float("nan"))
    y_d = torch.where(keep, y, float("inf"))
    w_d, p_d = fused_sgd.fused_dense_sgd_split(x_d, y_d, m, w0, allreduce=lambda t: t, **kw)
    torch.cuda.synchronize()
    if not (torch.isfinite(w_b1).all() and torch.equal(w_s, w_b1) and torch.equal(p_s, p_b1)):
        raise AssertionError(f"split loop {name}: differs from B1 by "
                             f"{float((w_s - w_b1).abs().max()):.3g} (weights), "
                             f"{float((p_s - p_b1).abs().max()):.3g} (margins)")
    if not (torch.equal(w_d, w_s) and torch.equal(p_d, p_s)):
        raise AssertionError(f"split loop {name}: NaN/Inf in masked rows reached the result")
    return int((~keep).sum())


def split_twin_errors():
    """The split at each of SPLIT_SHAPES (B1's narrow pass at a rank's
    operating point, its tiled wide pass at 2000 and 8196 columns), in both
    residual modes: the loop at world size 1 bitwise B1's, NaN/Inf in masked
    rows bitwise ignored; each entry against its twin: the grad entry's
    per-CTA partials summed in torch against ``fused_dense_grad_reference``'s
    Xᵀr (its margins too), the reduce entry's Xᵀr against the same partials
    summed in float64 and its count exact, the update entry bitwise against
    ``split_update_twin`` (weights and converged flag). Then a batch on
    which the loop diverges (dense 0-2 counts at 4096 x 8196, step 0.005,
    50 iterations: the weights overflow) through B1 and the split: the same
    non-finite pattern and values. Returns each entry's max abs error and
    max relative error against its twin."""
    import torch

    from twtml_tpu_torch.ops import fused_sgd

    sms, shared = fused_sgd.device_limits(torch.cuda.current_device())
    abs_err = dict.fromkeys(SPLIT_ENTRIES, 0.0)
    rel_err = dict.fromkeys(SPLIT_ENTRIES, 0.0)
    for rows, f in SPLIT_SHAPES:
        for mode, rf in enumerate((fused_sgd.least_squares_residual,
                                   fused_sgd.logistic_residual)):
            x, y, m, w0 = split_inputs(rows, f, seed=5 + mode, logistic=bool(mode))
            step = 0.1 if mode else 0.005
            masked = split_loop_check(f"{rows} x {f} mode {mode}", x, y, m, w0,
                                      num_iterations=OP_ITERS, step_size=step, l2_reg=0.01,
                                      residual_fn=rf)
            plan = fused_sgd.split_plan(rows, f, sm_count=sms, shared_limit=shared)
            bufs = fused_sgd.split_buffers(plan, x.device)
            w, preds = torch.empty_like(w0), torch.empty_like(y)
            fused_sgd.fused_dense_grad(plan, bufs, x, y, m, w0, w, preds, first=True, mode=mode)
            partials = bufs.scratch[:plan.grid * plan.fpad].view(plan.grid, plan.fpad).clone()
            fused_sgd.fused_dense_grad_reduce(plan, bufs, f)
            g_ref, count_ref, raw_ref = fused_sgd.fused_dense_grad_reference(
                x, y, m, w0, residual_fn=rf)
            torch.cuda.synchronize()
            fpad = plan.fpad
            scale_g = float(g_ref.abs().max().clamp(min=1))
            summed = partials.double().sum(dim=0)
            g_abs = float((summed[:f] - g_ref.double()).abs().max())
            p_abs = float((preds - raw_ref).abs().max())
            pad_abs = float(summed[f:].abs().max()) if fpad > f else 0.0
            r_abs = float((bufs.gbuf[:fpad].double() - summed).abs().max())
            if bufs.gbuf[fpad].item() != count_ref.item():
                raise AssertionError("fused_dense_grad_reduce: the count differs from the twin's")
            if g_abs > 1e-5 * scale_g or p_abs > 1e-3 or pad_abs:
                raise AssertionError(f"fused_dense_grad ({rows} x {f}, mode {mode}): Xᵀr off "
                                     f"by {g_abs:.3g} (max |Xᵀr| {scale_g:.3g}), margins by "
                                     f"{p_abs:.3g}, padded columns {pad_abs:.3g}")
            if r_abs > 1e-6 * scale_g:
                raise AssertionError(f"fused_dense_grad_reduce ({rows} x {f}, mode {mode}): "
                                     f"off the partials' sum by {r_abs:.3g}")
            want, conv = split_update_twin(w0, torch.cat([bufs.gbuf[:f], bufs.gbuf[fpad:]]), f,
                                           it=1, step_size=step, l2_reg=0.01, tol=0.001)
            fused_sgd.fused_dense_update(plan, bufs, w, f, it=1, step_size=step, l2_reg=0.01,
                                         convergence_tol=0.001)
            torch.cuda.synchronize()
            if not torch.equal(w, want) or bool(bufs.state[0].item()) != bool(conv):
                raise AssertionError(f"fused_dense_update ({rows} x {f}, mode {mode}) differs "
                                     f"from its twin by {float((w - want).abs().max()):.3g} "
                                     f"(converged {bufs.state[0].item()} against {bool(conv)})")
            for e, a, r in (("fused_dense_grad", max(g_abs, p_abs), g_abs / scale_g),
                            ("fused_dense_grad_reduce", r_abs, r_abs / scale_g)):
                abs_err[e], rel_err[e] = max(abs_err[e], a), max(rel_err[e], r)
            phase("multihost", f"split at {rows} x {f} ({'narrow' if f <= 1024 else 'wide'} "
                  f"pass, mode {mode}): the loop at world size 1 bitwise B1's ({OP_ITERS} "
                  f"iterations), NaN/Inf in {masked} masked rows bitwise ignored; grad's "
                  f"partials within {g_abs:.3g} of the twin's Xᵀr (max |Xᵀr| {scale_g:.3g}), "
                  f"margins within {p_abs:.3g}; reduce within {r_abs:.3g} of the partials' "
                  "sum, the count exact; the update and its converged flag bitwise")
    # a divergent batch: dense 0-2 counts overflow the loop at 8196 columns
    g = torch.Generator().manual_seed(5)
    x = torch.randint(0, 3, (4096, 8196), generator=g).float()
    x[:, -4:] = torch.rand(4096, 4, generator=g) * 1e-3
    y = torch.rand(4096, generator=g) * 1000
    m = (torch.rand(4096, generator=g) < 0.95).float()
    w0 = torch.randn(8196, generator=g) * 1e-3
    x, y, m, w0 = (t.cuda() for t in (x, y, m, w0))
    kw = dict(num_iterations=OP_ITERS, step_size=0.005)
    w_b1, p_b1 = fused_sgd.fused_dense_sgd(x, y, m, w0, **kw)
    w_s, p_s = fused_sgd.fused_dense_sgd_split(x, y, m, w0, allreduce=lambda t: t, **kw)
    torch.cuda.synchronize()
    bad = int((~torch.isfinite(w_b1)).sum())
    same = (torch.equal(w_b1.isnan(), w_s.isnan())
            and torch.equal(w_b1.nan_to_num(0.0), w_s.nan_to_num(0.0))
            and torch.equal(p_b1, p_s))
    if not same:
        raise AssertionError("the divergent 4096 x 8196 batch: the split's weights differ "
                             f"from B1's ({bad} of B1's are not finite)")
    phase("multihost", f"a divergent 4096 x 8196 batch: B1's own weights have "
          f"{bad} non-finite of 8196 (the step diverges on dense 0-2 counts), the split's the "
          f"same pattern and values (bit patterns equal: "
          f"{torch.equal(w_b1.view(torch.int32), w_s.view(torch.int32))})")
    return abs_err, rel_err


def split_times(smi, errs, launches):
    """Each split entry's device time at a rank's operating point (an
    iteration after the first: X staged), its twin's, and its bound.
    ``errs``: (max abs error, max relative error) by entry."""
    import torch

    from twtml_tpu_torch.ops import fused_sgd

    x, y, m, w0 = split_inputs()
    rows, f = x.shape
    sms, shared = fused_sgd.device_limits(torch.cuda.current_device())
    plan = fused_sgd.split_plan(rows, f, sm_count=sms, shared_limit=shared)
    bufs = fused_sgd.split_buffers(plan, x.device)
    w, preds = torch.empty_like(w0), torch.empty_like(y)
    fused_sgd.fused_dense_grad(plan, bufs, x, y, m, w0, w, preds, first=True)
    fused_sgd.fused_dense_grad_reduce(plan, bufs, f)
    fused_sgd.fused_dense_update(plan, bufs, w, f, it=1, step_size=1e-12, l2_reg=0.0,
                                 convergence_tol=0.0)  # tol 0: never converged
    n = 50
    g_count = torch.cat([bufs.gbuf[:f], bufs.gbuf[plan.fpad:]])
    calls = {
        "fused_dense_grad": lambda: fused_sgd.fused_dense_grad(
            plan, bufs, x, y, m, w0, w, preds, first=False),
        "fused_dense_grad_reduce": lambda: fused_sgd.fused_dense_grad_reduce(plan, bufs, f),
        "fused_dense_update": lambda: fused_sgd.fused_dense_update(
            plan, bufs, w, f, it=2, step_size=1e-12, l2_reg=0.0, convergence_tol=0.0),
    }
    plains = {
        "fused_dense_grad": lambda: fused_sgd.fused_dense_grad_reference(x, y, m, w0),
        "fused_dense_grad_reduce": lambda: bufs.scratch[:plan.grid * plan.fpad].view(
            plan.grid, plan.fpad).sum(dim=0),
        "fused_dense_update": lambda: split_update_twin(
            w0, g_count, f, it=2, step_size=1e-12, l2_reg=0.0, tol=0.001),
    }
    # bytes each entry's function must move, each input read once and each
    # output written once, at the batch's own size (no padding, none of the
    # design's own scratch): grad reads X (bf16, as B1 stores it), y, the
    # mask and w and writes Xᵀr [F]; reduce reads the [grid, fpad] partials
    # and the counts and writes Xᵀr and the count; update reads w, Xᵀr and
    # the count and writes w
    moved = {
        "fused_dense_grad": 2 * rows * f + 4 * (2 * rows + 2 * f),
        "fused_dense_grad_reduce": 4 * (plan.grid * plan.fpad + plan.grid + f + 1),
        "fused_dense_update": 4 * (3 * f + 1),
    }
    ops = {  # x·w and r·x: two FMAs an element of X
        "fused_dense_grad": 4 * rows * f,
        "fused_dense_grad_reduce": plan.grid * f,
        "fused_dense_update": 8 * f,
    }
    records = []
    for name in SPLIT_ENTRIES:
        call, plain = calls[name], plains[name]

        def many(fn=call):
            for _ in range(n):
                fn()

        def many_plain(fn=plain):
            for _ in range(n):
                fn()

        many()
        ms = timed(many, 5, queue_ahead=True)[0] / n
        plain_ms = timed(many_plain, 3, queue_ahead=True)[0] / n
        bytes_ms = moved[name] / HBM_BYTES_PER_S * 1e3
        ops_ms = ops[name] / F32_FLOPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        records.append({
            "name": name, "route": "cuda", "source": "twtml_tpu_torch/csrc/fused_sgd.cu",
            "replaces": "twtml_tpu/ops/pallas_sgd.py:55", "launches": launches[name],
            "max_abs_err": errs[0][name], "max_rel_err": errs[1][name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "library_ms": None,
            "bound_bytes": moved[name], "card": smi, "rows": rows, "features": f,
            "grid": plan.grid, "shapes_checked": [list(sh) for sh in SPLIT_SHAPES],
        })
        phase("multihost", f"{name}: {ms:.5f} ms a launch at B = {rows} x {f} (CUDA events, "
              f"{n} launches), twin {plain_ms:.5f} ms, bound {bound_ms:.5f} ms "
              f"({records[-1]['bound_by']}, {moved[name]} B), launches on the main arm "
              f"{launches[name]}")
    total = sum(r["ms"] for r in records)
    phase("multihost", f"split kernels {total:.5f} ms an iteration (grad + reduce + update); "
          f"card: {smi}")
    return records, total


def mh_block_emulation(path, lines):
    """The group's --ingest block run's weights, emulated in this process:
    tick k's per-rank buckets of their byte-range shards (host 0's rows,
    then host 1's) through one card learner."""
    import numpy as np

    from twtml_tpu_torch.features.batch import UnitBatch
    from twtml_tpu_torch.features.blocks import empty_block, iter_row_chunks
    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
    from twtml_tpu_torch.streaming.sources import BlockReplayFileSource

    feat = Featurizer(now_ms=NOW_MS)
    chunks = [list(iter_row_chunks(BlockReplayFileSource(
        path, shard_index=i, shard_count=MH_RANKS).produce(), MH_ROWS))
        for i in range(MH_RANKS)]
    ticks = max(len(c) for c in chunks)
    model = StreamingLinearRegressionWithSGD(device=MH_ARGV[1])
    for k in range(ticks):
        parts = [feat.featurize_parsed_block(c[k] if k < len(c) else empty_block(),
                                             row_bucket=MH_ROWS, unit_bucket=64)
                 for c in chunks]
        model.step(UnitBatch(*(np.concatenate([getattr(b, fld) for b in parts])
                               for fld in UnitBatch._fields)))
    if len(lines) != ticks:
        raise AssertionError(f"multihost block: {len(lines)} lines for {ticks} ticks")
    return model.latest_weights


def multihost_phase(smi, statuses):
    """The multihost phase: the lockstep multi-host runtime, 2 ranks of the linear
    app on the one card over gloo, at the global B = 16384 (8192 a rank),
    full width, 50 iterations, on the stream phase's tweets as a replay
    file, against one process on the card; the split kernels against B1
    and their twins; the arms (codec, superbatch, block ingest, the 2^18
    Gram route), a resume, a rollback and a killed peer."""
    import shutil
    import tempfile

    import numpy as np

    from twtml_tpu_torch.checkpoint import Checkpointer

    workdir = tempfile.mkdtemp(prefix="twtml-multihost-")
    try:
        errs = split_checks()
        path = os.path.join(workdir, "tweets.jsonl")
        write_replay(path, statuses[:MH_BATCHES * OP_ROWS])
        # the main arm: the default wire; its counts are the split kernels' launches
        recs, totals, w_err, d_main, argv = mh_arm("main", path, workdir, MH_ROWS)
        launches = {e: sum(r["launches"][e] for r in recs) for e in SPLIT_ENTRIES}
        for rank, rec in enumerate(recs):
            steps = MH_BATCHES + 1
            want = {e: steps * OP_ITERS for e in SPLIT_ENTRIES}
            got = {e: rec["launches"][e] for e in SPLIT_ENTRIES}
            c = rec["collectives"]
            if got != want or rec["launches"]["fused_dense_sgd"]:
                raise AssertionError(f"multihost main rank {rank}: launches {rec['launches']}, "
                                     f"want {want} and no fused launch")
            if c["allreduces"] != steps * (OP_ITERS + 2) or c["align_allgathers"] != steps:
                raise AssertionError(f"multihost main rank {rank}: collectives {c} for "
                                     f"{steps} steps")
        numbers = {"main": mh_rank_numbers("main", recs, totals, MH_BATCHES + 1),
                   "weights_max_err": w_err}
        # a second run on the same directory: the journal resumes exactly
        again = mh_ok("resume", mh_group("resume", [*argv, "--batchBucket", str(MH_ROWS),
                                                     "--checkpointDir", d_main]))
        meta = Checkpointer(d_main).restore()[1]
        if again[0][1] or meta["count"] != totals["count"]:
            raise AssertionError(f"multihost resume: {len(again[0][1])} new lines, count "
                                 f"{meta['count']}")
        phase("multihost", "resume: the second run trained no batch (count unchanged)")
        # the superbatch's warm-up also steps one all-padding group of K
        for name, extra, steps in (("codec", ["--wireCodec", "dict"], MH_BATCHES + 1),
                                   ("superbatch", ["--superBatch", "4"], MH_BATCHES + 5)):
            recs_x, totals_x, err_x, _d, _a = mh_arm(name, path, workdir, MH_ROWS, extra)
            numbers[name] = {"weights_max_err": err_x,
                             "ranks": mh_rank_numbers(name, recs_x, totals_x, steps)}
        # block ingest on byte-range shards, against its emulation on the card
        d_block = os.path.join(workdir, "block")
        block = mh_ok("block", mh_group("block", [*MH_ARGV, "--replayFile", path,
                                                   "--ingest", "block", "--batchBucket",
                                                   str(MH_ROWS), "--checkpointDir", d_block]))
        err_b, _meta = mh_hold_weights("block", d_block, mh_block_emulation(path, block[0][1]))
        numbers["block"] = {"weights_max_err": err_b}
        phase("multihost", f"block: {len(block[0][1])} ticks of byte-range shards, weights "
              f"within {err_b:.3g} of the emulation on the card")
        # the 2^18 Gram route at B = 2048 (1024 a rank) on short rows
        gram_path = os.path.join(workdir, "gram.jsonl")
        write_replay(gram_path, statuses[:MH_BATCHES * GRAM_ROWS])
        recs_g, totals_g, err_g, _d, _a = mh_arm("gram", gram_path, workdir,
                                                 GRAM_ROWS // MH_RANKS, MH_GRAM_ARGV)
        for rank, rec in enumerate(recs_g):
            if not all(rec["launches"][k] for k in ("count_build", "dual_sgd",
                                                    "dual_writeback_counts")):
                raise AssertionError(f"multihost gram rank {rank}: launches {rec['launches']}")
        numbers["gram"] = {"weights_max_err": err_g,
                           "ranks": mh_rank_numbers("gram", recs_g, totals_g,
                                                    MH_BATCHES + 1)}
        # a poisoned batch rolled back on both ranks
        d_roll = os.path.join(workdir, "rollback")
        roll = mh_ok("rollback", mh_group("rollback", [
            *argv, "--batchBucket", str(MH_ROWS), "--checkpointDir", d_roll,
            "--checkpointEvery", "1", "--chaos", "source.nan@3"]))
        for rank, (_rc, _lines, _rec, err, _wall) in enumerate(roll):
            if "rolled back to verified checkpoint" not in err or "disagree" in err:
                raise AssertionError(f"multihost rollback rank {rank}:\n{err}")
        state, meta = Checkpointer(d_roll).restore()
        if (len(roll[0][1]) != MH_BATCHES or meta["count"] != totals["count"]
                or not np.isfinite(np.asarray(state)).all()):
            raise AssertionError(f"multihost rollback: {len(roll[0][1])} lines, count "
                                 f"{meta['count']}")
        phase("multihost", "rollback: source.nan@3 rolled both ranks back (the follower from "
              f"the lead's broadcast), the journal replayed, {MH_BATCHES} batches trained")
        # a peer killed at tick 3: the survivor aborts within the watchdog's bound
        kill = mh_group("peer.kill", [*argv, "--batchBucket", str(MH_ROWS),
                                      "--chaos", "peer.kill:uid=1:tick=3"],
                        env={"TWTML_LOCKSTEP_TIMEOUT_S": str(MH_WATCHDOG_S)})
        (rc0, _l0, _r0, err0, wall0), (rc1, *_rest) = kill
        # the survivor's wall holds its start-up (a process reaches the card
        # in ~8 s), the warm-up and two ticks, then at most the watchdog
        if rc1 != 77 or rc0 == 0 or "lockstep" not in err0 or wall0 > MH_WATCHDOG_S + 90:
            raise AssertionError(f"multihost peer.kill: exit codes {rc0}, {rc1} after "
                                 f"{wall0:.1f} s:\n{err0}")
        numbers["peer_kill"] = {"survivor_exit": rc0, "survivor_wall_s": wall0}
        phase("multihost", f"peer.kill at tick 3: the peer exited 77, the survivor {rc0} "
              f"after {wall0:.1f} s (watchdog {MH_WATCHDOG_S} s), no hang")
        records, split_ms = split_times(smi, errs, launches)
        numbers["split_ms_an_iteration"] = split_ms
        return records, numbers, {"recs": recs, "numbers": numbers["main"]}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# ---- the elastic phase: --elastic on, 2 ranks on cuda:0 over gloo ----------

EL_WATCHDOG_S = 5  # TWTML_LOCKSTEP_TIMEOUT_S of the elastic arms
EL_ENV = {"TWTML_LOCKSTEP_TIMEOUT_S": str(EL_WATCHDOG_S), "TWTML_ELASTIC_RESCUE_GRACE_S": "2",
          "TWTML_ELASTIC_SERVICE_LINGER_S": "3"}
EL_TIMEOUT_S = 240
EL_KILL_TICK = 3
# the rejoin arm: the lead pauses 6 s a tick from the tick after the kill,
# so the restarted rank (~8 s to reach the card) parks before its data ends;
# the arm's watchdog outlasts the pause (the kill shows as a failed all-gather)
EL_PAUSE = f"peer.pause:uid=0:ticks=12@from{EL_KILL_TICK + 1}"
EL_REJOIN_ENV = {"TWTML_LOCKSTEP_TIMEOUT_S": "30"}
# set on every elastic rank to the phase's own work directory: the store
# processes the ranks spawn inherit it, and the phase stops only those
EL_TAG_ENV = "TWTML_CHIP_ELASTIC_RUN"

# one elastic rank: the linear app as ``main`` runs it; it leaves through
# elastic_exit's hard exit, so its record (totals, launches, collectives,
# counters) prints just before
EL_RANK = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from twtml_tpu_torch.apps import linear_regression
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.ops import fused_sgd
from twtml_tpu_torch.parallel import distributed
from twtml_tpu_torch.telemetry import metrics
kept = []
checkpoint = linear_regression.AppCheckpoint
def keeping(conf, get_state, set_state, totals, lead=True):
    kept.append(totals)
    return checkpoint(conf, get_state, set_state, totals, lead=lead)
def report(failed, hard_exit):
    totals = kept[0] if kept else {}
    launches = {n: getattr(fused_sgd, n).launches for n in
                ("fused_dense_grad", "fused_dense_grad_reduce", "fused_dense_update")}
    launches["fused_dense_sgd"] = fused_sgd.fused_dense_sgd.launches
    snap = metrics.get_registry().snapshot()
    print(json.dumps({"failed": failed, "hard_exit": hard_exit, "count": totals.get("count"),
                      "batches": totals.get("batches"),
                      "stream_seconds": totals.get("stream_seconds"),
                      "launches": launches, "collectives": distributed.COUNTERS,
                      "seconds": distributed.SECONDS, "counters": snap["counters"],
                      "gauges": snap["gauges"]}), flush=True)
elastic_exit = linear_regression.elastic_exit
def exit_reporting(failed=False):
    report("the run failed" if failed else None, True)
    elastic_exit(failed)
linear_regression.AppCheckpoint = keeping
linear_regression.elastic_exit = exit_reporting
try:
    linear_regression.run(ConfArguments().parse(sys.argv[2:]))
except RuntimeError as exc:
    report(str(exc), False)
    sys.exit(3)
report("the run returned instead of leaving through the elastic exit", False)
sys.exit(4)
"""


def el_base_port() -> int:
    """A base port with the elastic group's ports free from it (the beacon
    on base + 1, epoch e's store on base + 2 + e)."""
    from twtml_tpu_torch.parallel.elastic import free_base_port

    return free_base_port()


def el_spawn(tag, rank, argv, base, extra=(), env=None):
    """One elastic rank of the linear app (``--master twtml://``, cuda:0).
    ``tag`` goes into its environment as EL_TAG_ENV, which the store
    processes it spawns inherit: el_reap_store_hosts finds this phase's by
    it."""
    env = dict(os.environ, **{**EL_ENV, **(env or {}), EL_TAG_ENV: tag})
    env.pop("TWTML_SYNC_DEBUG", None)  # a gloo all-reduce waits for the card
    args = [sys.executable, "-c", EL_RANK, PACKAGE_ROOT, *argv, *extra,
            "--lightning", RECORDER.url, "--twtweb", RECORDER.url,
            "--master", f"twtml://127.0.0.1:{base}", "--numProcesses", str(MH_RANKS),
            "--processId", str(rank)]
    return subprocess.Popen(args, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env)


def el_collect(procs, t0, name=""):
    """Each process's (exit code, stats lines, record or None, stderr, wall
    s); every process is stopped before this returns. With
    ``TWTML_CHIP_LOG_DIR`` set, each stderr is also written there."""
    out = []
    log_dir = os.environ.get("TWTML_CHIP_LOG_DIR", "")
    try:
        for i, p in enumerate(procs):
            stdout, stderr = p.communicate(timeout=EL_TIMEOUT_S)
            if log_dir:
                with open(os.path.join(log_dir, f"elastic-{name}-{i}.log"), "w") as fh:
                    fh.write(stderr)
            lines = stdout.splitlines()
            rec = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
            out.append((p.returncode, [ln for ln in lines if ln.startswith("count:")], rec,
                        stderr, time.perf_counter() - t0))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return out


def el_group(tag, name, argv, extra=((), ())):
    """The two elastic ranks with ``argv`` (and each rank's ``extra``)."""
    t0 = time.perf_counter()
    base = el_base_port()
    return el_collect([el_spawn(tag, r, argv, base, extra[r]) for r in range(MH_RANKS)], t0,
                      name)


def el_tick_split(rec):
    """A rank's host wall a tick (ms) and the part of it in the gloo
    all-reduces and in the cadence all-gather; the rest is the host's own
    (featurize, dispatch, the plane, checkpoint saves). The collectives'
    seconds are the run's (the warm-up step's included) over its ticks, so
    the rest is a lower bound."""
    ticks = max(1, rec["collectives"]["cadence_allgathers"])
    wall, sec = 1e3 * rec["stream_seconds"] / ticks, rec["seconds"]
    allreduce = 1e3 * sec["allreduce"] / ticks
    allgather = 1e3 * sec["cadence_allgather"] / ticks
    return {"host_wall": wall, "allreduces": allreduce, "allgather": allgather,
            "rest": wall - allreduce - allgather}


def el_tick_text(t):
    return (f"{t['host_wall']:.1f} ms (all-reduces {t['allreduces']:.1f}, all-gather "
            f"{t['allgather']:.1f}, rest {t['rest']:.1f})")


def el_survived(name, res, want_rc=(0, 0)):
    for rank, (rc, _lines, rec, err, _wall) in enumerate(res):
        if rc != want_rc[rank]:
            raise AssertionError(f"elastic {name}: rank {rank} exited {rc} (want "
                                 f"{want_rc[rank]}):\n{err[-4000:]}")
        if rc == 0 and (rec is None or rec["failed"] or not rec["hard_exit"]):
            raise AssertionError(f"elastic {name}: rank {rank}'s record {rec}:\n{err[-4000:]}")


def el_log_time(err, text):
    """The host clock (s) of the first log line of ``err`` holding
    ``text`` (the log's asctime, to the millisecond), or None."""
    import datetime

    for line in err.splitlines():
        if text in line:
            stamp = datetime.datetime.strptime(line[:23], "%Y-%m-%d %H:%M:%S,%f")
            return stamp.timestamp()
    return None


def el_resync(name, err):
    import re

    m = re.search(r"elastic resync: state from the lead's verified checkpoint \(count=(\d+), "
                  r"batches=(\d+), state crc ([0-9a-f]+)\)(?: — (\d+) row\(s\) of "
                  r"post-checkpoint progress rolled back)?", err)
    if m is None:
        raise AssertionError(f"elastic {name}: the survivor never logged its resync:\n"
                             f"{err[-4000:]}")
    replayed = re.findall(r"journal: replayed (\d+) row\(s\) from cursor \d+ after elastic", err)
    return (int(m.group(1)), int(m.group(2)), m.group(3), int(m.group(4) or 0),
            sum(int(r) for r in replayed))


def el_clean_run(state, rows):
    """The survivor's continuation in this process, on the card: the world-1
    split (``MultiHostSGDModel`` over a ``ParallelSGDModel`` on a group of
    one) and B1's fused learner, each from ``state`` over ``rows`` in
    MH_ROWS-row batches. Returns (split weights, B1 weights)."""
    from twtml_tpu_torch.config import ConfArguments
    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
    from twtml_tpu_torch.parallel.distributed import Collectives, MultiHostSGDModel
    from twtml_tpu_torch.parallel.mesh import make_mesh
    from twtml_tpu_torch.parallel.sharding import ParallelSGDModel

    conf = ConfArguments().parse(["--backend", MH_ARGV[1]])
    mesh = make_mesh(num_processes=1)
    split = MultiHostSGDModel(ParallelSGDModel.from_conf(conf, mesh, Collectives()), mesh)
    plain = StreamingLinearRegressionWithSGD.from_conf(conf)
    split.set_initial_weights(state)
    plain.set_initial_weights(state)
    feat = Featurizer(now_ms=NOW_MS)
    for lo in range(0, len(rows), MH_ROWS):
        batch = feat.featurize_batch_ragged(rows[lo:lo + MH_ROWS], row_bucket=MH_ROWS,
                                            unit_bucket=64)
        split.step(split.pack_for_wire(batch))
        plain.step(batch)
    return split.latest_weights, plain.latest_weights


def el_hold_continuation(name, final_dir, archive_dir, step, rows):
    """The survivor's final archive against its clean continuation on the
    card from the archive it restored (step ``step``): bitwise the world-1
    split's and B1's."""
    import numpy as np

    from twtml_tpu_torch.checkpoint import Checkpointer

    state, _meta = Checkpointer(archive_dir).restore(step=step)
    final, meta = Checkpointer(final_dir).restore()
    split_w, b1_w = el_clean_run(state, rows)
    if not (np.array_equal(np.asarray(final), split_w) and np.array_equal(split_w, b1_w)):
        raise AssertionError(
            f"elastic {name}: the survivor's weights differ from the clean run from step "
            f"{step} by {float(np.max(np.abs(np.asarray(final) - split_w))):.3g} (split), the "
            f"split from B1's by {float(np.max(np.abs(split_w - b1_w))):.3g}")
    return state, int(meta["count"])


def el_reap_store_hosts(tag, deadline_s=30.0):
    """Wait for the store processes this phase's ranks spawned
    (parallel/service_host.py, detached, ``tag`` in their environment) to
    reap themselves once their beacon is gone; stop any still there at the
    deadline. A process whose environment cannot be read is not this
    phase's. Returns how many were stopped."""
    import signal

    mark = f"{EL_TAG_ENV}={tag}".encode()

    def hosts():
        pids = []
        for d in os.listdir("/proc"):
            if d.isdigit():
                try:
                    with open(f"/proc/{d}/cmdline", "rb") as fh:
                        if b"twtml_tpu_torch.parallel.service_host" not in fh.read():
                            continue
                    with open(f"/proc/{d}/environ", "rb") as fh:
                        if mark in fh.read().split(b"\0"):
                            pids.append(int(d))
                except OSError:
                    pass
        return pids

    t0 = time.monotonic()
    while hosts() and time.monotonic() - t0 < deadline_s:
        time.sleep(0.5)
    left = hosts()
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    return len(left)


def elastic_phase(smi, statuses, lockstep):
    """The elastic phase (``--elastic on``): 2 ranks of the linear app on the
    one card over gloo, full width, 8192 rows a rank, on the multihost
    phase's replay file. A healthy run counted against the lockstep main
    arm (``lockstep``: its ranks' records and numbers) and timed between it
    and a lockstep run of the same flags after it; ``peer.kill`` on uid
    1 at tick 3: the survivor shrinks and its continuation is bitwise the
    world-1 split's and B1's from the restored archive on the card;
    ``peer.kill`` on uid 0: the election, held the same way from uid 1's
    standby archive; a restarted uid 1: admitted, its first tick's state
    CRC the lead's. Returns the phase's numbers."""
    import re
    import shutil
    import tempfile

    from twtml_tpu_torch.streaming.sources import ReplayFileSource

    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="twtml-elastic-")
    out = {}
    try:
        path = os.path.join(workdir, "tweets.jsonl")
        write_replay(path, statuses[:MH_BATCHES * OP_ROWS])
        rows = list(ReplayFileSource(path).produce())
        off = [*MH_ARGV, "--replayFile", path, "--batchBucket", str(MH_ROWS)]
        argv = [*off, "--elastic", "on"]
        steps = MH_BATCHES + 1  # and the warm-up's
        # healthy: the lockstep main arm's collectives, fetches and launches;
        # its tick timed between that arm (run before) and a lockstep run
        # with this arm's flags but --elastic off (run after)
        d_h = os.path.join(workdir, "healthy")
        res = el_group(workdir, "healthy", [*argv, "--checkpointDir", d_h])
        el_survived("healthy", res)
        d_after = os.path.join(workdir, "lockstep-after")
        after = mh_ok("elastic lockstep-after", mh_group(
            "elastic lockstep-after", [*off, "--checkpointDir", d_after], env=EL_ENV))
        healthy = []
        for rank, (_rc, lines, rec, _err, wall) in enumerate(res):
            c = rec["collectives"]
            for ref in (lockstep["recs"][rank], after[rank][2]):
                if (c["cadence_allgathers"] != rec["counters"]["lockstep.ticks"]
                        or {k: c[k] for k in ref["collectives"]} != ref["collectives"]
                        or rec["counters"]["fetch.count"] != ref["counters"]["fetch.count"]
                        or rec["count"] != ref["count"]
                        or {k: rec["launches"][k] for k in SPLIT_ENTRIES}
                        != {k: ref["launches"][k] for k in SPLIT_ENTRIES}):
                    raise AssertionError(f"elastic healthy rank {rank}: {rec} against the "
                                         f"lockstep run's {ref}")
            ticks = c["cadence_allgathers"]
            row = {"rank": rank, "ticks": ticks, "collectives": c,
                   "fetches": rec["counters"]["fetch.count"],
                   "host_wall_a_tick_ms": 1e3 * rec["stream_seconds"] / ticks,
                   "tweets_per_s": rec["count"] / rec["stream_seconds"],
                   "tick_ms": el_tick_split(rec),
                   "lockstep_host_wall_a_tick_ms":
                       lockstep["numbers"][rank]["host_wall_a_tick_ms"],
                   "lockstep_tweets_per_s": lockstep["numbers"][rank]["tweets_per_s"],
                   "lockstep_tick_ms": el_tick_split(lockstep["recs"][rank]),
                   "lockstep_after_tick_ms": el_tick_split(after[rank][2]),
                   "lockstep_after_tweets_per_s":
                       after[rank][2]["count"] / after[rank][2]["stream_seconds"],
                   "group_wall_s": wall}
            healthy.append(row)
            phase("elastic", f"healthy rank {rank}: {ticks} ticks, {ticks} cadence all-gathers, "
                  f"collectives and {row['fetches']} fetches as --elastic off; a tick "
                  f"{el_tick_text(row['tick_ms'])} against lockstep before "
                  f"{el_tick_text(row['lockstep_tick_ms'])} and after "
                  f"{el_tick_text(row['lockstep_after_tick_ms'])}; {row['tweets_per_s']:.0f} "
                  f"tweets/s against {row['lockstep_tweets_per_s']:.0f} before and "
                  f"{row['lockstep_after_tweets_per_s']:.0f} after")
        out["healthy"] = healthy
        launches = {e: sum(r[2]["launches"][e] for r in res) for e in SPLIT_ENTRIES}
        # a follower killed at a tick boundary: the survivor shrinks
        every = ["--checkpointEvery", "1"]
        kill1 = f"peer.kill:uid=1:tick={EL_KILL_TICK}"
        d_k = os.path.join(workdir, "kill1")
        res = el_group(workdir, "kill1", [*argv, *every, "--checkpointDir", d_k],
                       extra=((), ("--chaos", kill1)))
        el_survived("kill1", res, (0, 77))
        err0, err1 = res[0][3], res[1][3]
        if "elastic epoch 1 formed: 1 host(s) [0]" not in err0:
            raise AssertionError(f"elastic kill1: no shrink:\n{err0[-4000:]}")
        count, batches, crc, rolled, replayed = el_resync("kill1", err0)
        done = batches * MH_ROWS  # the survivor's rows inside the restored archive
        _state, final_count = el_hold_continuation("kill1", d_k, d_k, batches,
                                                   rows[0::2][done:])
        t_kill = el_log_time(err1, "peer.kill firing")
        t_seen = el_log_time(err0, "lockstep collective failed")
        t_formed = el_log_time(err0, "elastic epoch 1 formed")
        rec = res[0][2]
        out["kill1"] = {
            "resync": {"count": count, "batches": batches, "crc": crc},
            "rows_rolled_back": rolled, "rows_replayed": replayed,
            "final_count": final_count, "detect_s": t_seen - t_kill,
            "rescue_s": t_formed - t_kill,
            "launches_survivor": {e: rec["launches"][e] for e in SPLIT_ENTRIES},
            "allreduces_survivor": rec["collectives"]["allreduces"], "wall_s": res[0][4]}
        phase("elastic", f"peer.kill uid 1 at tick {EL_KILL_TICK}: the survivor formed epoch 1 "
              f"alone {t_formed - t_kill:.3f} s after the kill (the failed all-gather seen "
              f"after {t_seen - t_kill:.3f} s), resynced to step {batches} (count {count}, crc "
              f"{crc}), {rolled} rows rolled back, {replayed} replayed; final count "
              f"{final_count}, weights bitwise the clean world-1 split's and B1's on the card; "
              f"survivor's split launches {out['kill1']['launches_survivor']}")
        # the lead killed: uid 1 wins the election and promotes its standby
        d_l = os.path.join(workdir, "kill0")
        res = el_group(workdir, "kill0", [*argv, *every, "--checkpointDir", d_l, "--chaos",
                                 f"peer.kill:uid=0:tick={EL_KILL_TICK}"])
        el_survived("kill0", res, (77, 0))
        err0, err1 = res[0][3], res[1][3]
        for text in ("uid 1 WON the election", "checkpoint authority PROMOTED",
                     "elastic epoch 1 formed: 1 host(s) [1]"):
            if text not in err1:
                raise AssertionError(f"elastic kill0: no {text!r}:\n{err1[-4000:]}")
        count, batches, crc, rolled, replayed = el_resync("kill0", err1)
        done = batches * MH_ROWS
        standby = os.path.join(d_l, "standby-u1")
        _state, final_count = el_hold_continuation("kill0", standby, standby, batches,
                                                   rows[1::2][done:])
        t_kill = el_log_time(err0, "peer.kill firing")
        t_formed = el_log_time(err1, "elastic epoch 1 formed")
        out["kill0"] = {"resync": {"count": count, "batches": batches, "crc": crc},
                        "rows_rolled_back": rolled, "rows_replayed": replayed,
                        "final_count": final_count, "rescue_s": t_formed - t_kill,
                        "wall_s": res[1][4]}
        phase("elastic", f"peer.kill uid 0 at tick {EL_KILL_TICK}: uid 1 won the election, "
              f"formed epoch 1 {t_formed - t_kill:.3f} s after the kill from its own step "
              f"{batches} (crc {crc}); final count {final_count}, weights bitwise the clean "
              "world-1 split's and B1's on the card")
        # a restarted uid 1: parks, admitted at an epoch boundary
        d_r = os.path.join(workdir, "rejoin")
        t0 = time.perf_counter()
        base = el_base_port()
        argv_r = [*argv, *every, "--checkpointDir", d_r]
        lead = el_spawn(workdir, 0, argv_r, base, ("--chaos", EL_PAUSE), EL_REJOIN_ENV)
        peer = el_spawn(workdir, 1, argv_r, base, ("--chaos", f"{EL_PAUSE},{kill1}"),
                        EL_REJOIN_ENV)
        rejoiner = None
        try:
            peer_rc = peer.wait(timeout=EL_TIMEOUT_S)
            rejoiner = el_spawn(workdir, 1, argv_r, base, ("--chaos", EL_PAUSE), EL_REJOIN_ENV)
            res = el_collect([lead, rejoiner], t0, "rejoin")
        finally:
            for p in (lead, peer, rejoiner):
                if p is not None:
                    p.kill()
                    p.wait()
        if peer_rc != 77:
            raise AssertionError(f"elastic rejoin: the killed rank exited {peer_rc}")
        for rank, r in enumerate(res):
            if r[0] != 0:
                raise AssertionError(f"elastic rejoin: rank {rank} exited {r[0]}:\n"
                                     f"{res[0][3][-3000:]}\n-- the rejoiner:\n{res[1][3][-3000:]}")
        el_survived("rejoin", res)
        err0, errr = res[0][3], res[1][3]
        for text, err in (("elastic epoch 2 formed: 2 host(s) [0, 1]", err0),
                          ("parking this host (uid 1) for admission", errr)):
            if text not in err:
                raise AssertionError(f"elastic rejoin: no {text!r}:\n{err[-4000:]}")
        lead_crc = re.findall(r"elastic resync: .* state crc ([0-9a-f]+)", err0)
        join_crc = re.findall(r"multi-host state synchronized from the lead \(count=(\d+), "
                              r"state crc ([0-9a-f]+)\)", errr)
        if not (lead_crc and join_crc and join_crc[-1][1] == lead_crc[-1]):
            raise AssertionError(f"elastic rejoin: the rejoiner's first-tick crc {join_crc} "
                                 f"against the lead's {lead_crc}")
        t_formed = el_log_time(err0, "elastic epoch 2 formed")
        t_parked = el_log_time(errr, "parking this host")
        out["rejoin"] = {"crc": lead_crc[-1], "count_at_admission": int(join_crc[-1][0]),
                         "parked_to_admitted_s": t_formed - t_parked,
                         "lead_final_count": res[0][2]["count"], "wall_s": res[0][4]}
        phase("elastic", f"restarted uid 1: parked, admitted at epoch 2 "
              f"{t_formed - t_parked:.3f} s later; its first tick's state crc {lead_crc[-1]} "
              f"the lead's (count {join_crc[-1][0]})")
        stopped = el_reap_store_hosts(workdir)
        out.update(launches=launches, store_hosts_stopped=stopped,
                   wall_s=time.perf_counter() - t_phase, card=smi)
        phase("elastic", f"split launches on the healthy run (both ranks) {launches}; store "
              f"processes stopped at the end {stopped}; phase wall {out['wall_s']:.1f} s | "
              f"card: {smi}")
        return out
    finally:
        el_reap_store_hosts(workdir)
        shutil.rmtree(workdir, ignore_errors=True)


EL_AB_BATCHES = 8  # a run's global batches in ``--elastic-ab``


def elastic_ab(smi, pairs):
    """``--elastic-ab N``: the healthy elastic tick against lockstep alone,
    in N pairs of group runs of the same flags, environment and checkpoint
    settings, the order alternating (lockstep first in even pairs, elastic
    first in odd ones), each on EL_AB_BATCHES x 16384 synthetic tweets
    (8192 rows a rank): per run and rank the host wall a tick split into
    the all-reduces, the cadence all-gather and the rest
    (``el_tick_split``), then the medians by arm. The counted collectives
    and fetches are held equal in every pair."""
    import shutil
    import tempfile

    from twtml_tpu_torch.streaming.sources import SyntheticSource

    workdir = tempfile.mkdtemp(prefix="twtml-elastic-ab-")
    runs = {"lockstep": [], "elastic": []}
    ratios = []  # elastic over lockstep host wall a tick, a pair and rank
    try:
        path = os.path.join(workdir, "tweets.jsonl")
        write_replay(path, SyntheticSource(total=EL_AB_BATCHES * OP_ROWS, seed=5,
                                           base_ms=NOW_MS).produce())
        off = [*MH_ARGV, "--replayFile", path, "--batchBucket", str(MH_ROWS)]
        for i in range(pairs):
            order = ("lockstep", "elastic") if i % 2 == 0 else ("elastic", "lockstep")
            recs = {}
            for arm in order:
                ck = ["--checkpointDir", os.path.join(workdir, f"{arm}-{i}")]
                if arm == "elastic":
                    res = el_group(workdir, f"ab-{i}", [*off, "--elastic", "on", *ck])
                    el_survived(f"ab-{i}", res)
                else:
                    res = mh_ok(f"elastic-ab lockstep {i}",
                                mh_group(f"ab-{i}", [*off, *ck], env=EL_ENV))
                recs[arm] = [r[2] for r in res]
                for rank, rec in enumerate(recs[arm]):
                    t = dict(el_tick_split(rec), pair=i, rank=rank, position=order.index(arm),
                             tweets_per_s=rec["count"] / rec["stream_seconds"])
                    runs[arm].append(t)
                    phase("elastic-ab", f"pair {i} {arm} (run {order.index(arm) + 1} of 2) "
                          f"rank {rank}: a tick {el_tick_text(t)}, "
                          f"{t['tweets_per_s']:.0f} tweets/s")
            for rank in range(MH_RANKS):
                e, lk = recs["elastic"][rank], recs["lockstep"][rank]
                if ({k: e["collectives"][k] for k in lk["collectives"]} != lk["collectives"]
                        or e["counters"]["fetch.count"] != lk["counters"]["fetch.count"]):
                    raise AssertionError(f"elastic-ab pair {i} rank {rank}: {e} against {lk}")
                ratios.append(runs["elastic"][-MH_RANKS + rank]["host_wall"]
                              / runs["lockstep"][-MH_RANKS + rank]["host_wall"])
            phase("elastic-ab", f"pair {i}: elastic over lockstep, a tick's host wall "
                  f"{[round(r, 4) for r in ratios[-MH_RANKS:]]} (ranks 0, 1)")
        summary = {}
        for arm, rows in runs.items():
            summary[arm] = {k: statistics.median(r[k] for r in rows)
                            for k in ("host_wall", "allreduces", "allgather", "rest",
                                      "tweets_per_s")}
        ratio = summary["elastic"]["host_wall"] / summary["lockstep"]["host_wall"]
        pair_ratio = statistics.median(ratios)
        phase("elastic-ab", f"medians over {pairs} pairs x {MH_RANKS} ranks: elastic a tick "
              f"{el_tick_text(summary['elastic'])} against lockstep "
              f"{el_tick_text(summary['lockstep'])}: {ratio:.4f}x; the pairs' ratios "
              f"{min(ratios):.4f}-{max(ratios):.4f}, median {pair_ratio:.4f} | card: {smi}")
        print(json.dumps({"elastic_ab": {"pairs": pairs, "batches": EL_AB_BATCHES,
                                         "runs": runs, "medians": summary,
                                         "host_wall_ratio": ratio, "pair_ratios": ratios,
                                         "pair_ratio_median": pair_ratio, "card": smi}}),
              flush=True)
    finally:
        el_reap_store_hosts(workdir)
        shutil.rmtree(workdir, ignore_errors=True)


def times_only(smi):
    """``--times-only``: the kernels' device times alone (B1's training
    kernel in its logistic mode, its predict-only mode, B4 in both planes,
    the G product, B7 and B8), no app phase; with ``--package-root DIR`` on
    the port found in DIR (another checkout, e.g. a parent commit unpacked
    there), so that two versions are timed in one call, in turns. It calls
    only the kernels' wrappers and C entries, and reads of B7 only what
    every tree exposes: no barrier count or probe."""
    from collections import defaultdict

    out = {"package_root": PACKAGE_ROOT, "logistic": logistic_times(smi, 0.0, 0)}
    out["predict"] = predict_mode_times(smi, 0)
    out["gram"] = gram_times(smi, defaultdict(float), defaultdict(int), structure=False)
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
    if "--elastic-ab" in argv:
        os.environ["TWTML_NOW_MS"] = str(NOW_MS)
        RECORDER = Recorder()
        try:
            elastic_ab(smi, int(argv[argv.index("--elastic-ab") + 1]))
        finally:
            RECORDER.close()
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
        block_pool = superbatch.pop("pool")
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
    RECORDER = Recorder()  # the tenant and block phases' app runs publish to it
    try:
        tenants = tenants_phase(web_statuses, smi)
        abtest = abtest_phase(smi, web_statuses)
        block = block_phase(block_pool, smi)
    finally:
        RECORDER.close()
    RECORDER = Recorder()  # the multihost and elastic phases' app runs publish to it
    try:
        split_records, multihost, lockstep = multihost_phase(smi, web_statuses)
        elastic = elastic_phase(smi, web_statuses, lockstep)
    finally:
        RECORDER.close()
    for r in split_records:
        r["launches_elastic"] = elastic["launches"][r["name"]]
    record.update(tenants=tenants, launches_tenants=tenants["launches"], block=block,
                  launches_block=block["launches"], multihost=multihost, elastic=elastic)
    predict_record.update(abtest=abtest, launches_abtest=abtest["counts_ab"]["predict_launches"])
    import torch

    phase("done", f"chip_smoke wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [record, logistic_record, predict_record, *gram_records,
                                  *split_records]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
