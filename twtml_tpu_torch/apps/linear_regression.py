"""Streaming linear-regression entry point, the flagship application
(counterpart of ``twtml_tpu/apps/linear_regression.py``).

config -> model -> session stats (the twtml-web dashboard and Lightning) ->
featurizer -> streaming context -> source -> per micro-batch: featurize on
the host, pack, one fused predict-then-train step on the device, fetch the
stats, print the batch's line and publish it. ``--seconds 0`` runs back to
back: each batch is the next ``--batchBucket`` tweets, on the ragged packed
wire by default, with up to 8 batches in flight (apps/common.py
``FetchPipeline``). ``--seconds N > 0`` batches whatever arrived in each
N-second interval, on the padded wire by default, one synchronous fetch a
batch. The step is built and warmed before the stream starts.

``--hashOn host`` hashes the bigrams on the host (native/fasthash.cpp) and
ships the padded tokens; the step densifies them and trains through the
same fused kernel. ``--profileDir`` writes a ``torch.profiler`` Chrome
trace of the stream (utils/tracing.py), started after the warm-up and
stopped after the last delivery, as the JAX app runs its profiler.

The runtime guards are wired as in the JAX app: the tracer (``--trace``),
the fault injector (``--chaos``), the flight recorder (``--blackbox``, on
by default) and, with ``--checkpointDir``, the intake journal and the
telemetry historian; the checkpoint restores, the journal's boot replay
resumes, the recycler (``--recycleAfterMb``) watches RSS; every delivery
passes the divergence sentinel, the model watch and the freshness plane
(all on by default). A clean shutdown stamps the historian's perfGuard
baseline.

Across hosts (``--master twtml://host:port --numProcesses N --processId
I``, or ``--coordinator``): the process joins the group first
(``init_distributed``), reads its own shard of the source, trains its rows
of each global batch in lockstep with the others (``MultiHostSGDModel``,
one cadence all-gather a tick), and only the lead (process 0) prints,
publishes and writes checkpoints. ``--elastic on`` makes the group elastic
(``attach_elastic``): a dead host shrinks it, a dead lead is replaced by
the lowest live uid, a restarted host is readmitted at an epoch boundary,
and the process leaves through a hard exit (``elastic_exit``) once its
checkpoint and telemetry flushed.

``--superBatch K`` (back to back, pinned ``--batchBucket``/``--tokenBucket``)
groups K batches into one ``step_many`` dispatch (apps/common.py
``SuperBatcher``), on the stacked wire or, with ``--wirePack group``, one
packed buffer a group; each batch is still reported on its own.

``--tenants M`` trains M models on the stream (the tenant plane,
parallel/tenants.py): each batch's rows route to the tenants on the host,
one wire and M steps go to the device, ONE fetch comes back, and the batch
is reported once, its stats pooled over the tenants (the JAX app's line).

``run_learner`` is the streaming loop every SGD entry point shares; the
logistic app (apps/logistic_regression.py) runs it with its learner, its
labels and its report.

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
from ..streaming import journal as _journal
from ..streaming.context import StreamingContext
from ..telemetry import freshness as _freshness
from ..telemetry import historian as _historian
from ..telemetry import trace as _trace
from ..telemetry.session_stats import SessionStats
from ..utils import get_logger, round_half_up
from ..utils.tracing import Tracer, annotate
from .common import (
    FETCH_DEPTH,
    AppCheckpoint,
    DivergenceSentinel,
    FreshnessGuard,
    ModelWatchGuard,
    ProcessRecycler,
    attach_elastic,
    attach_super_batcher,
    build_model,
    build_source,
    elastic_exit,
    install_blackbox,
    install_chaos,
    install_historian,
    install_journal,
    init_distributed,
    install_trace,
    journal_boot_replay,
    select_backend,
    warmup_compile,
)
from ..parallel.distributed import is_multihost
from ..parallel.distributed import shutdown as shutdown_distributed

log = get_logger("apps.linear")


def report_linear(out, totals: dict, b: int, session, real, pred) -> str:
    """The flagship app's line of one batch, and its session update: MSE
    and the two stdevs, HALF_UP-rounded."""
    mse = round_half_up(float(out.mse))
    real_stdev = round_half_up(float(out.real_stdev))
    pred_stdev = round_half_up(float(out.pred_stdev))
    with annotate("twtml.publish"):
        session.update(totals["count"], b, mse, real_stdev, pred_stdev, real, pred)
    return (f"count: {totals['count']}  batch: {b}  mse: {mse}  "
            f"stdev (real, pred): ({int(real_stdev)}, {int(pred_stdev)})")


def run(conf: ConfArguments, max_batches: int = 0, fetch_depth: int = FETCH_DEPTH) -> dict:
    """The flagship app: ``run_learner`` with the least-squares learner."""
    return run_learner(conf, max_batches, fetch_depth)


def run_learner(conf: ConfArguments, max_batches: int = 0, fetch_depth: int = FETCH_DEPTH,
                *, learner=None, report=report_linear, label_fns=None) -> dict:
    """Train ``learner`` (None: the least-squares learner, the flagship
    app's) on the configured source until it ends or ``max_batches``
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
    ``fetch_depth`` sets the back-to-back stream's batches in flight.
    ``report(out, totals, b, session, real, pred)`` publishes one batch and
    returns its line; ``label_fns`` (label_fn, batch_label_fn,
    unit_label_fn) set the featurizer's labelers (the last labels parsed
    blocks, ``--ingest block``).
    A run a runtime guard aborted (the fetch watchdog, the sentinel's
    rollback budget) raises after its shutdown saved the final checkpoint."""
    # a multi-host group forms first: the rank's device is chosen before
    # anything touches the card
    lead = init_distributed(conf)
    select_backend(conf)
    # the model first: without a card the default --backend cuda fails here,
    # before anything is published
    model = build_model(conf) if learner is None else build_model(conf, learner)
    lockstep = is_multihost()
    log.info("Initializing session stats...")
    # one telemetry session a run: the lead publishes the global stats
    session = SessionStats(conf).open() if lead else None
    featurizer = Featurizer.from_conf(conf)
    if label_fns is not None:
        (featurizer.label_fn, featurizer.batch_label_fn,
         featurizer.unit_label_fn) = label_fns
    wire = conf.effective_wire()
    install_trace(conf)
    install_chaos(conf)
    install_blackbox(conf)
    install_journal(conf)
    install_historian(conf)

    log.info("Initializing streaming context... %s sec/batch", conf.seconds)
    ssc = StreamingContext(
        batch_interval=conf.seconds,
        max_queue_rows=conf.effective_max_queue_rows(),
        shed_policy=conf.shedPolicy,
        thread_init=model.bind_thread,
    )
    stream = ssc.source_stream(
        build_source(conf, allow_block=True), featurizer, row_bucket=conf.batchBucket,
        token_bucket=conf.tokenBucket, ragged=wire == "ragged",
        device_hash=conf.hashOn == "device",
    )
    # the tenant count in the run record, as the JAX app keeps it
    totals = {"count": 0, "batches": 0, "steps": [],
              "tenants": int(getattr(model, "num_tenants", 1) or 1)}
    # the checkpoint's state is the one f32 weight vector (key "w"), or the
    # tenant plane's [M, F+4] stack
    ckpt = AppCheckpoint(conf, get_state=lambda: model.latest_weights,
                         set_state=model.set_initial_weights, totals=totals, lead=lead)
    journal_boot_replay(conf, ssc, ckpt, totals)
    recycler = ProcessRecycler(conf, ckpt, totals)
    sentinel = DivergenceSentinel(conf, model, ckpt, ssc, totals=totals)
    modelwatch = ModelWatchGuard(conf, ckpt, totals)
    _freshness.configure(conf)
    freshness = FreshnessGuard(conf, ckpt, totals)
    tracer = Tracer(conf.profileDir, model.device)

    def handle(out, batch, _batch_time, at_boundary=True, stamp=None) -> None:
        delivered_s = time.perf_counter()
        b = int(out.count)
        totals["count"] += b
        totals["batches"] += 1
        publish_ms = 0.0
        if lead:
            # the stats are global, the per-row series this rank's rows
            valid = batch.mask.astype(bool)
            real = batch.label[valid].astype(np.float64)
            pred = np.asarray(out.predictions)[valid].astype(np.float64)
            t0 = time.perf_counter()
            line = report(out, totals, b, session, real, pred)
            publish_ms = (time.perf_counter() - t0) * 1e3
            print(line, flush=True)
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
            publish_ms=publish_ms,
            delivered_s=delivered_s,
            wire=wire,
        ))
        ckpt.maybe_save(totals, at_boundary)
        recycler.check(at_boundary)
        if max_batches and totals["batches"] >= max_batches:
            ssc.request_stop()

    # --elastic on: a host's loss shrinks the group instead of ending the
    # run, and a recovered host rejoins at an epoch boundary
    elastic = attach_elastic(conf, ssc, model, stream, ckpt, totals)

    flush = attach_super_batcher(
        conf, stream, model, handle,
        stop_requested=lambda: ssc.stop_requested,
        # a resumed run trains up to the cap, counting the restored batches
        max_dispatch=max(1, max_batches - totals["batches"]) if max_batches else 0,
        abort=ssc.request_abort,  # fetch-watchdog aborts fail the run loudly
        fetch_depth=fetch_depth,
        stamp=lambda: stream.last_featurize,
        sentinel=sentinel,
        modelwatch=modelwatch,
        freshness=freshness,
        elastic=elastic,
    )

    warmup_compile(stream, model, super_batch=flush.group_k, group_wire=flush.group_wire,
                   wire_codec=flush.wire_codec)

    log.info("Starting the streaming computation...")
    tracer.start()
    t_stream = totals["stream_started_s"] = time.perf_counter()
    ssc.start(lockstep=lockstep)
    try:
        ssc.await_termination()
    except KeyboardInterrupt:
        pass
    finally:
        ssc.stop()
        flush()  # deliver what is still in flight
        totals["stream_seconds"] = time.perf_counter() - t_stream
        try:
            totals["profile"] = tracer.stop()
        finally:
            if session is not None:
                session.publish_metrics()  # the dashboard's panel ends current
            _trace.uninstall()
            ckpt.final_save(totals)
            # after the final save, which stamps the journal's cursor; a
            # later run() in this process starts without it
            _journal.uninstall()
            # the perfGuard baseline stamps on a clean shutdown only: an
            # aborted run's stage costs must not become the next run's
            # healthy baseline
            if not ssc.failed:
                _historian.stamp_baseline()
            _historian.uninstall()
        if lockstep and not ssc.failed and elastic is None:
            # an aborted rank leaves the group with the process: a peer may
            # be gone mid-collective
            shutdown_distributed()
    if ssc.failed:
        # an elastic run leaves through a hard exit either way
        elastic_exit(failed=True)
        raise RuntimeError(
            "run aborted by a runtime guard: a lockstep peer's loss, a fetch "
            "watchdog abort, the divergence sentinel's rollback budget or a "
            "scheduler failure (see the critical log above); progress up to "
            "the failure is checkpointed"
        )
    elastic_exit(failed=False)
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
