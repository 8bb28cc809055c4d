"""Streaming k-means entry point, single host (counterpart of
``twtml_tpu/apps/kmeans.py``; reference: KMeans.scala).

Retweets only (``isRetweet``; NO retweet-count interval here, unlike the
SGD apps), each featurized to the dense pair (original's retweetCount,
original's followersCount); per batch, padded to a power-of-two row bucket,
StandardScaler(withMean=false, withStd=true) (ops/scaler.py), the manual
``update`` of a k=3 model with a half-life of 5 batches and random 2-d
centers (models/kmeans.py), then the nearest-center prediction of every
point and the line ``count: … batch: … centers: … sizes: …``. The cluster
scatter chart the reference sketches streams to Lightning from a daemon
thread behind a drop-oldest queue (best effort: training never waits on
it). The model's centers and weights live on the card unless ``--backend
cpu`` is given; ``--checkpointDir`` saves and restores ``{centers,
weights}`` as the JAX app does. ``--ingest block`` parses with the
retweet-count interval opened to every retweet (the parser's filter is then
``isRetweet`` alone) and takes both dimensions from the parsed block's
numeric columns.

K-means across hosts (a lockstep group, ``--master twtml://`` or
``--coordinator``, as the SGD apps join it) needs ``--batchBucket``: each
rank reads its shard of the source into a fixed bucket of rows a tick
(all padding when it has none), the StandardScaler is fitted on the global
batch, the model's per-center sums are all-reduced
(``StreamingKMeans(mesh=, group=)``), one all-gather a batch agrees the
global count and cluster sizes, and only the lead prints and charts.
``--elastic on`` exits with the JAX app's message (the elastic rebuild is
wired for the SGD apps only).

Run: ``python -m twtml_tpu_torch.apps.kmeans --backend cpu --source replay \\
      --replayFile tests/data/tweets.jsonl --seconds 0 \\
      --lightning http://localhost:3000``
"""

from __future__ import annotations

import queue
import sys
import threading

import numpy as np
import torch

from ..config import ConfArguments
from ..features.batch import pad_row_count
from ..features.blocks import COL_FOLLOWERS, COL_LABEL, ParsedBlock, merge_blocks
from ..features.featurizer import Status
from ..models.kmeans import StreamingKMeans, sq_dists
from ..ops.scaler import standard_scale
from ..streaming.context import StreamingContext
from ..telemetry import historian as _historian
from ..telemetry import trace as _trace
from ..telemetry.lightning import CHART_MAX_POINTS, Lightning
from ..utils import get_logger
from ..utils.rss import RssWatchdog
from .common import (
    AppCheckpoint,
    ProcessRecycler,
    build_source,
    init_distributed,
    install_blackbox,
    install_chaos,
    install_historian,
    install_trace,
    select_backend,
)

log = get_logger("apps.kmeans")

NUM_DIMENSIONS = 2  # KMeans.scala:57
NUM_CLUSTERS = 3  # KMeans.scala:58
CHART_FAILURE_LIMIT = 5  # consecutive append failures before giving up


def _start_chart_worker(conf) -> "queue.Queue":
    """A daemon thread owning every Lightning call of the cluster chart;
    returns its frame queue (drop-oldest, depth 2). It creates the session
    and the scatter chart, then appends frames, and gives up for good after
    CHART_FAILURE_LIMIT failures in a row."""
    q: "queue.Queue" = queue.Queue(maxsize=2)

    def _worker() -> None:
        try:
            lgn = Lightning(host=conf.lightning)
            lgn.create_session(conf.appName)
            viz = lgn.scatter_streaming([], [])
            log.info("lightning cluster chart: %s/visualizations/%s", conf.lightning, viz.id)
        except Exception as exc:  # lawcheck: disable=TW005 -- best-effort telemetry: the chart is disabled, training goes on
            log.warning("lightning unavailable (%s); cluster chart disabled", exc)
            return
        failures = 0
        while failures < CHART_FAILURE_LIMIT:
            x, y, label = q.get()
            try:
                lgn.scatter_streaming(x, y, label=label, viz=viz)
                failures = 0
            except Exception as exc:  # lawcheck: disable=TW005 -- best-effort telemetry: counted, and the chart gives up after CHART_FAILURE_LIMIT
                failures += 1
                log.debug("lightning append failed (%s)", exc)
        log.warning("cluster chart disabled after repeated append failures")

    threading.Thread(target=_worker, daemon=True).start()
    return q


def featurize(status: Status) -> np.ndarray:
    """Dense (retweetCount, followersCount) of the original tweet."""
    original = status.retweeted_status
    return np.array([float(original.retweet_count), float(original.followers_count)],
                    dtype=np.float32)


def batch_points(statuses: list, rows_for) -> "tuple[np.ndarray, int]":
    """A micro-batch's points, [rows_for(n), 2] float32 with its n valid
    rows first, and n: both dimensions of each retweet, or of each row of
    the parsed blocks (``--ingest block``)."""
    if statuses and isinstance(statuses[0], ParsedBlock):
        block = merge_blocks(statuses)
        n = block.rows
        pts = np.zeros((rows_for(n), NUM_DIMENSIONS), np.float32)
        pts[:n, 0] = block.numeric[:, COL_LABEL]
        pts[:n, 1] = block.numeric[:, COL_FOLLOWERS]
        return pts, n
    retweets = [s for s in statuses if s.is_retweet]
    n = len(retweets)
    pts = np.zeros((rows_for(n), NUM_DIMENSIONS), np.float32)
    if n:
        pts[:n] = np.stack([featurize(s) for s in retweets])
    return pts, n


def run(conf: ConfArguments, max_batches: int = 0, wall_clock: bool = True) -> dict:
    """Cluster the configured source's retweets until it ends or
    ``max_batches`` batches ran (0 = no cap); ``wall_clock=False`` drives
    the source synchronously (``run_to_completion``; a group always runs
    the lockstep scheduler). Returns the totals (``count``, ``batches``)."""
    from ..parallel import distributed as _dist

    if conf.elastic == "on":
        # the JAX app's exit: its raw-stream handler owns the global
        # assembly, and the elastic rebuild is wired for the SGD apps only
        raise SystemExit("--elastic on is wired for the SGD entry points (linear, "
                         "logistic); the k-means plane keeps the abort-on-peer-loss "
                         "behavior for now")
    # a multi-host group forms first: the rank's device is chosen before
    # anything touches the card
    lead = init_distributed(conf)
    select_backend(conf)
    multihost = _dist.is_multihost()
    if multihost and conf.batchBucket <= 0:
        raise SystemExit("multi-host k-means needs --batchBucket: every host must "
                         "dispatch the same fixed-shape collective program each tick")
    install_trace(conf)
    install_chaos(conf)
    install_blackbox(conf)
    install_historian(conf)
    # every retweet, no retweet-count interval (KMeans.scala:77-80): block
    # ingest opens the parser's interval filter
    source = build_source(conf, allow_block=True, block_interval=(0, 2**62))
    # one chart a run: the lead's
    chart_q = _start_chart_worker(conf) if lead else None
    group = _dist.Collectives.from_group() if multihost else None
    model = (
        StreamingKMeans(mesh=_dist.mesh() if multihost else None, group=group,
                        device=_dist.device() if multihost else conf.backend)
        .set_k(NUM_CLUSTERS)
        .set_half_life(5, "batches")
        .set_random_centers(NUM_DIMENSIONS, 0.0)
    )
    ssc = StreamingContext(
        batch_interval=conf.seconds,
        max_queue_rows=conf.effective_max_queue_rows(),
        shed_policy=conf.shedPolicy,
    )
    totals = {"count": 0, "batches": 0}
    ckpt = AppCheckpoint(
        conf,
        get_state=lambda: {"centers": model.latest_centers, "weights": model.latest_weights},
        set_state=lambda st: model.set_initial_centers(st["centers"], st["weights"]),
        totals=totals, lead=lead,
    )
    recycler = ProcessRecycler(conf, ckpt, totals)
    watchdog = RssWatchdog()
    # a group's fixed rows a rank a tick (lockstep drains cap at it)
    local_bucket = pad_row_count(conf.batchBucket, conf.batchBucket) if multihost else 0

    def deliver(n_total: int, centers, sizes, scaled_host, pred, n: int) -> None:
        totals["count"] += n_total
        totals["batches"] += 1
        watchdog.tick()
        if lead:
            print(
                f"count: {totals['count']}  batch: {n_total}  "
                f"centers: {np.round(centers, 3).tolist()}  "
                f"sizes: {sizes.tolist()}",
                flush=True,
            )
            m = min(n, CHART_MAX_POINTS)
            try:
                chart_q.put_nowait((scaled_host[:m, 0], scaled_host[:m, 1], pred[:m]))
            except queue.Full:
                pass  # the chart is behind: the latest batch wins the next slot
        ckpt.maybe_save(totals)
        recycler.check()
        if max_batches and totals["batches"] >= max_batches:
            ssc.request_stop()

    def on_batch(statuses: list, _batch_time) -> None:
        pts, n = batch_points(statuses, lambda k: pad_row_count(k, 0))
        if n == 0:
            log.debug("batch: 0")
            return
        mask = np.zeros((pts.shape[0],), np.float32)
        mask[:n] = 1.0
        mask_d = torch.from_numpy(mask).to(model.device)
        scaled = standard_scale(torch.from_numpy(pts).to(model.device), mask_d)
        assign = model.update_device(scaled, mask_d)[:n].cpu().numpy()
        pred = torch.argmin(sq_dists(scaled[:n], model.centers), dim=1).cpu().numpy()
        log.debug("assignments: %s", assign.tolist())
        deliver(n, model.latest_centers, np.bincount(pred, minlength=NUM_CLUSTERS),
                scaled[:n].cpu().numpy(), pred, n)

    def on_batch_multihost(statuses: list, _batch_time) -> None:
        """This rank's rows of a global batch: a rank with none still
        dispatches (all padding: the update is a no-op when the GLOBAL
        batch is empty), the scaler's fit and the model's sums span every
        rank, and ONE all-gather agrees the global count and cluster
        sizes (every rank calls it: the lockstep keeps the order)."""
        pts, n = batch_points(statuses, lambda k: max(k, local_bucket))
        if n > local_bucket:
            log.error("dropping %d rows over --batchBucket in multi-host lockstep (raise "
                      "--batchBucket)", n - local_bucket)
            pts, n = pts[:local_bucket], local_bucket
        mask = np.zeros((local_bucket,), np.float32)
        mask[:n] = 1.0
        mask_d = torch.from_numpy(mask).to(model.device)
        scaled = standard_scale(torch.from_numpy(pts).to(model.device), mask_d,
                                reduce=group.allreduce_)
        assign = model.update_device(scaled, mask_d)[:n].cpu().numpy()
        centers = model.latest_centers
        pred = torch.argmin(sq_dists(scaled[:n], model.centers), dim=1).cpu().numpy()
        agg = _dist.host_allgather(np.concatenate(
            [[n], np.bincount(pred, minlength=NUM_CLUSTERS)]).astype(np.float64),
            "stats").sum(axis=0).astype(np.int64)
        if agg[0] == 0:
            log.debug("batch: 0 (global)")  # the update was a state no-op
            return
        log.debug("assignments: %s", assign.tolist())
        deliver(int(agg[0]), centers, agg[1:], scaled[:n].cpu().numpy(), pred, n)

    ssc.raw_stream(
        source, row_bucket=local_bucket if multihost else max(0, conf.batchBucket),
    ).foreach_batch(on_batch_multihost if multihost else on_batch)
    try:
        if wall_clock or multihost:
            # a group always runs the lockstep scheduler, whatever the interval
            ssc.start(lockstep=multihost)
            try:
                ssc.await_termination()
            except KeyboardInterrupt:
                pass
            finally:
                ssc.stop()
        else:
            ssc.run_to_completion()
    finally:
        _trace.uninstall()
        ckpt.final_save(totals)
        if not ssc.failed:
            _historian.stamp_baseline()
        _historian.uninstall()
    if ssc.failed:
        raise RuntimeError("run aborted by a runtime guard (see the critical log above); "
                           "progress up to the failure is checkpointed")
    if multihost:
        _dist.shutdown()
    return totals


def main(argv=None) -> None:
    conf = (
        ConfArguments()
        .setAppName("twitter-stream-ml-kmeans")
        .parse(list(sys.argv[1:] if argv is None else argv))
    )
    totals = run(conf)
    print(f"done: {totals['count']} tweets in {totals['batches']} batches", file=sys.stderr)


if __name__ == "__main__":
    main()
