"""Streaming linear-regression entry point, the flagship application
(counterpart of ``twtml_tpu/apps/linear_regression.py``), single host.

config -> model -> session stats (the twtml-web dashboard and Lightning) ->
featurizer -> streaming context -> source -> per micro-batch: featurize on
the host, pack, one fused predict-then-train step on the device, fetch the
stats, print the batch's line and publish it. ``--seconds 0`` runs back to
back: each batch is the next ``--batchBucket`` tweets, on the ragged packed
wire by default, with up to 8 batches in flight (apps/common.py
``FetchPipeline``). ``--seconds N > 0`` batches whatever arrived in each
N-second interval, on the padded wire by default, one synchronous fetch a
batch. The step is built and warmed before the stream starts. Checkpoints,
runtime guards, the journal, the historian and multi-host are not ported
(ROADMAP A5, A10).

Run: ``python -m twtml_tpu_torch.apps.linear_regression --backend cpu \
      --source replay --replayFile tests/data/tweets.jsonl --seconds 0 \
      --batchBucket 4 --twtweb http://localhost:8899 \
      --lightning http://localhost:3000``
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..config import ConfArguments
from ..features.featurizer import Featurizer
from ..streaming.context import StreamingContext
from ..telemetry.session_stats import SessionStats
from ..utils import get_logger, round_half_up
from .common import (
    FETCH_DEPTH,
    attach_super_batcher,
    build_model,
    build_source,
    warmup_compile,
)

log = get_logger("apps.linear")


def run(conf: ConfArguments, max_batches: int = 0, fetch_depth: int = FETCH_DEPTH) -> dict:
    """Train on the configured source until it ends or ``max_batches``
    micro-batches trained (0 = no cap). Returns the totals: ``count``,
    ``batches``, ``stream_seconds`` (from the stream's start to its last
    delivery) and ``stream_started_s`` (``time.perf_counter()`` at the
    start), and one record a batch in ``totals["steps"]``: the unrounded
    stats and quality vector (or None), the host featurize ms (the pack
    included) with its sub-stages, the step's ms (CUDA events on ``cuda``,
    the host clock on ``cpu``), the dispatch ms (pack excluded), the host's
    wait on the batch's fetch, the batches in flight at its dispatch, the
    publish ms, when its featurize started and when it was delivered
    (``time.perf_counter()``), and its wire: name, bytes, native fill and
    pack.
    ``fetch_depth`` sets the back-to-back stream's batches in flight."""
    # the model first: without a card the default --backend cuda fails here,
    # before anything is published
    model = build_model(conf)
    log.info("Initializing session stats...")
    session = SessionStats(conf).open()
    featurizer = Featurizer.from_conf(conf)
    wire = conf.effective_wire()

    log.info("Initializing streaming context... %s sec/batch", conf.seconds)
    ssc = StreamingContext(
        batch_interval=conf.seconds,
        max_queue_rows=conf.effective_max_queue_rows(),
        shed_policy=conf.shedPolicy,
        thread_init=model.bind_thread,
    )
    stream = ssc.source_stream(
        build_source(conf), featurizer, row_bucket=conf.batchBucket,
        token_bucket=conf.tokenBucket, ragged=wire == "ragged",
    )
    totals = {"count": 0, "batches": 0, "steps": []}

    def handle(out, batch, _batch_time, at_boundary=True, stamp=None) -> None:
        delivered_s = time.perf_counter()
        b = int(out.count)
        totals["count"] += b
        totals["batches"] += 1
        mse = round_half_up(float(out.mse))
        real_stdev = round_half_up(float(out.real_stdev))
        pred_stdev = round_half_up(float(out.pred_stdev))
        valid = batch.mask.astype(bool)
        real = batch.label[valid].astype(np.float64)
        pred = np.asarray(out.predictions)[valid].astype(np.float64)
        print(
            f"count: {totals['count']}  batch: {b}  mse: {mse}  "
            f"stdev (real, pred): ({int(real_stdev)}, {int(pred_stdev)})",
            flush=True,
        )
        t0 = time.perf_counter()
        session.update(totals["count"], b, mse, real_stdev, pred_stdev, real, pred)
        stamp = dict(stamp or {})
        subs = dict(stamp.pop("featurize_substages_ms", {}))
        if "pack_ms" in stamp and stream.ragged:
            subs["pack"] = stamp["pack_ms"]
        totals["steps"].append(dict(
            stamp,
            count=float(out.count), mse=float(out.mse),
            real_stdev=float(out.real_stdev), pred_stdev=float(out.pred_stdev),
            quality=None if out.quality is None else [float(v) for v in out.quality],
            featurize_ms=stamp.get("featurize_ms", 0.0) + stamp.get("pack_ms", 0.0),
            featurize_substages_ms=subs,
            publish_ms=(time.perf_counter() - t0) * 1e3,
            delivered_s=delivered_s,
            wire=wire,
        ))
        if max_batches and totals["batches"] >= max_batches:
            ssc.request_stop()

    flush = attach_super_batcher(
        conf, stream, model, handle,
        stop_requested=lambda: ssc.stop_requested,
        max_dispatch=max_batches,
        abort=ssc.request_abort,  # fetch-watchdog aborts fail the run loudly
        fetch_depth=fetch_depth,
        stamp=lambda: stream.last_featurize,
    )

    warmup_compile(stream, model)

    log.info("Starting the streaming computation...")
    t_stream = totals["stream_started_s"] = time.perf_counter()
    ssc.start()
    try:
        ssc.await_termination()
    except KeyboardInterrupt:
        pass
    finally:
        ssc.stop()
        flush()  # deliver what is still in flight
        totals["stream_seconds"] = time.perf_counter() - t_stream
        session.publish_metrics()  # the dashboard's panel ends current
    if ssc.failed:
        raise RuntimeError(
            "run aborted: a fetch watchdog abort or a scheduler failure "
            "(see the critical log above)"
        )
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
