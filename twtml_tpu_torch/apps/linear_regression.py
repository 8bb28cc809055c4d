"""Streaming linear-regression entry point, the flagship application
(counterpart of ``twtml_tpu/apps/linear_regression.py``).

config -> featurizer -> model -> source -> per micro-batch: featurize on the
host (padded units wire), one fused predict-then-train step on the device,
print the batch's stats line. Each micro-batch is the next ``--batchBucket``
tweets of the source; there is no time-interval streaming context,
dashboard publishing, checkpoint or runtime guard in this port yet.

Run: ``python -m twtml_tpu_torch.apps.linear_regression --source replay \
      --replayFile tests/data/tweets.jsonl --batchBucket 4 --backend cpu``
"""

from __future__ import annotations

import itertools
import sys
import time

import torch

from ..config import ConfArguments
from ..features.featurizer import Featurizer
from ..models.linear import StreamingLinearRegressionWithSGD
from ..streaming.sources import ReplayFileSource, SyntheticSource
from ..utils.rounding import round_half_up


def build_source(conf):
    if conf.source == "replay":
        if not conf.replayFile:
            raise SystemExit("--source replay requires --replayFile <path.jsonl>")
        return ReplayFileSource(conf.replayFile)
    return SyntheticSource()


def run(conf: ConfArguments, max_batches: int = 0) -> dict:
    """Train on the configured source until it ends or ``max_batches``
    micro-batches ran (0 = no cap). Returns the totals, with one entry per
    batch in ``totals["steps"]``: the unrounded stats, the quality vector
    (or None), the host featurize time and the step time (CUDA events on
    ``cuda``, the host clock on ``cpu``), both in ms."""
    featurizer = Featurizer.from_conf(conf)
    model = StreamingLinearRegressionWithSGD.from_conf(conf)
    on_cuda = model.device.type == "cuda"
    source = iter(build_source(conf))
    totals = {"count": 0, "batches": 0, "steps": []}

    while not max_batches or totals["batches"] < max_batches:
        chunk = list(itertools.islice(source, conf.batchBucket))
        if not chunk:
            break
        t0 = time.perf_counter()
        batch = featurizer.featurize_batch_units(chunk, row_bucket=conf.batchBucket)
        featurize_ms = (time.perf_counter() - t0) * 1e3
        if on_cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        out = model.step(batch)
        if on_cuda:
            end.record()
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
            step_ms=step_ms,
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
