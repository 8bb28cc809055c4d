"""Streaming linear-regression entry point, the flagship application
(counterpart of ``twtml_tpu/apps/linear_regression.py``).

config -> featurizer -> model -> source -> per micro-batch: featurize on the
host, one fused predict-then-train step on the device, print the batch's
stats line. The default wire is the JAX package's back-to-back default:
one native C pass fills the ragged wire's arrays, a second packs them into
ONE uint8 buffer, and the step copies that buffer to the device once and
decodes it there (``--wire padded`` keeps the padded units wire). Each
micro-batch is the next ``--batchBucket`` tweets of the source; there is no
time-interval streaming context, dashboard publishing, checkpoint or
runtime guard in this port yet.

Run: ``python -m twtml_tpu_torch.apps.linear_regression --source replay \
      --replayFile tests/data/tweets.jsonl --batchBucket 4 --backend cpu``
"""

from __future__ import annotations

import itertools
import os
import sys
import time

import torch

from ..config import ConfArguments
from ..features import assemble, featurize_native, native
from ..features.batch import PackedBatch, wire_nbytes
from ..features.featurizer import Featurizer
from ..models.linear import StreamingLinearRegressionWithSGD
from ..streaming.sources import ReplayFileSource, SyntheticSource
from ..utils.rounding import round_half_up


def build_source(conf):
    """The configured source. ``TWTML_NOW_MS`` (env), which pins the
    featurizer's clock, also pins the synthetic tweets' creation times, so a
    pinned synthetic run gives the same batches every time."""
    if conf.source == "replay":
        if not conf.replayFile:
            raise SystemExit("--source replay requires --replayFile <path.jsonl>")
        return ReplayFileSource(conf.replayFile)
    now_env = os.environ.get("TWTML_NOW_MS", "")
    return SyntheticSource(base_ms=int(now_env) if now_env else None)


def run(conf: ConfArguments, max_batches: int = 0) -> dict:
    """Train on the configured source until it ends or ``max_batches``
    micro-batches ran (0 = no cap). Returns the totals, with one entry per
    batch in ``totals["steps"]``: the unrounded stats, the quality vector
    (or None), the host featurize time with its sub-stages, the step time
    (CUDA events on ``cuda``, the host clock on ``cpu``), all in ms, and
    the batch's wire: its name, its bytes, and whether the native fill and
    the native pack built it."""
    featurize_native.configure(conf.featurizeNative)
    assemble.configure(conf.wireAssemble)
    wire = conf.effective_wire()
    featurizer = Featurizer.from_conf(conf)
    model = StreamingLinearRegressionWithSGD.from_conf(conf)
    on_cuda = model.device.type == "cuda"
    source = iter(build_source(conf))
    totals = {"count": 0, "batches": 0, "steps": []}

    while not max_batches or totals["batches"] < max_batches:
        chunk = list(itertools.islice(source, conf.batchBucket))
        if not chunk:
            break
        fills, packs = native.COUNTERS["fills_native"], native.COUNTERS["packs_native"]
        t0 = time.perf_counter()
        if wire == "ragged":
            batch = featurizer.featurize_batch_ragged(
                chunk, row_bucket=conf.batchBucket, pack=True
            )
        else:
            batch = featurizer.featurize_batch_units(chunk, row_bucket=conf.batchBucket)
        featurize_ms = (time.perf_counter() - t0) * 1e3
        if on_cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        out = model.step(batch)
        if on_cuda:
            end.record()
        if isinstance(batch, PackedBatch) and batch.lease is not None:
            # the step's copy of the buffer has completed (a synchronous
            # copy from pageable memory; on the CPU the step has run)
            batch.lease.retire()
        # reading the stats waits for the step
        stats = {k: float(getattr(out, k)) for k in
                 ("count", "mse", "real_stdev", "pred_stdev")}
        step_ms = (
            start.elapsed_time(end) if on_cuda else (time.perf_counter() - t0) * 1e3
        )
        b = int(stats["count"])
        totals["count"] += b
        totals["batches"] += 1
        mse = round_half_up(stats["mse"])
        real_stdev = round_half_up(stats["real_stdev"])
        pred_stdev = round_half_up(stats["pred_stdev"])
        print(
            f"count: {totals['count']}  batch: {b}  mse: {mse}  "
            f"stdev (real, pred): ({int(real_stdev)}, {int(pred_stdev)})",
            flush=True,
        )
        totals["steps"].append(dict(
            stats,
            quality=None if out.quality is None else out.quality.tolist(),
            featurize_ms=featurize_ms,
            featurize_substages_ms={
                name: seconds * 1e3 for name, _, seconds in featurizer.last_substages
            },
            step_ms=step_ms,
            wire=wire,
            wire_bytes=wire_nbytes(batch),
            native_fill=native.COUNTERS["fills_native"] > fills,
            native_pack=native.COUNTERS["packs_native"] > packs,
        ))
    return totals


def main(argv=None) -> None:
    conf = (
        ConfArguments()
        .setAppName("twitter-stream-ml-linear-regression")
        .parse(list(sys.argv[1:] if argv is None else argv))
    )
    totals = run(conf)
    print(
        f"done: {totals['count']} tweets in {totals['batches']} batches",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
