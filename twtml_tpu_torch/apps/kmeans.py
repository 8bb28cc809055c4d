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
numeric columns. K-means across hosts (its mesh) is ROADMAP A10c: the
multi-host flags stop the run before anything is built, and ``--elastic
on`` exits with the JAX app's message (the elastic rebuild is wired for
the SGD apps only).

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


def run(conf: ConfArguments, max_batches: int = 0, wall_clock: bool = True) -> dict:
    """Cluster the configured source's retweets until it ends or
    ``max_batches`` batches ran (0 = no cap); ``wall_clock=False`` drives
    the source synchronously (``run_to_completion``). Returns the totals
    (``count``, ``batches``)."""
    if conf.elastic == "on":
        # the JAX app's exit: its raw-stream handler owns the global
        # assembly, and the elastic rebuild is wired for the SGD apps only
        raise SystemExit("--elastic on is wired for the SGD entry points (linear, "
                         "logistic); the k-means plane keeps the abort-on-peer-loss "
                         "behavior for now")
    select_backend(conf)
    if conf.multihost() is not None:
        raise NotImplementedError("k-means across hosts (its data-parallel mesh) is not "
                                  "ported (ROADMAP A10c)")
    install_trace(conf)
    install_chaos(conf)
    install_blackbox(conf)
    install_historian(conf)
    # every retweet, no retweet-count interval (KMeans.scala:77-80): block
    # ingest opens the parser's interval filter
    source = build_source(conf, allow_block=True, block_interval=(0, 2**62))
    chart_q = _start_chart_worker(conf)
    model = (
        StreamingKMeans(device=conf.backend)
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
        totals=totals,
    )
    recycler = ProcessRecycler(conf, ckpt, totals)
    watchdog = RssWatchdog()

    def on_batch(statuses: list, _batch_time) -> None:
        if statuses and isinstance(statuses[0], ParsedBlock):
            # block ingest: both dimensions are numeric columns
            block = merge_blocks(statuses)
            n = block.rows
            if n == 0:
                log.debug("batch: 0")
                return
            rows = pad_row_count(n, 0)
            pts = np.zeros((rows, NUM_DIMENSIONS), np.float32)
            pts[:n, 0] = block.numeric[:, COL_LABEL]
            pts[:n, 1] = block.numeric[:, COL_FOLLOWERS]
        else:
            retweets = [s for s in statuses if s.is_retweet]
            if not retweets:
                log.debug("batch: 0")
                return
            n = len(retweets)
            rows = pad_row_count(n, 0)
            pts = np.zeros((rows, NUM_DIMENSIONS), np.float32)
            pts[:n] = np.stack([featurize(s) for s in retweets])
        mask = np.zeros((rows,), np.float32)
        mask[:n] = 1.0
        mask_d = torch.from_numpy(mask).to(model.device)
        scaled = standard_scale(torch.from_numpy(pts).to(model.device), mask_d)
        assign = model.update_device(scaled, mask_d)[:n].cpu().numpy()
        pred = torch.argmin(sq_dists(scaled[:n], model.centers), dim=1).cpu().numpy()
        scaled_host = scaled[:n].cpu().numpy()
        totals["count"] += n
        totals["batches"] += 1
        watchdog.tick()
        print(
            f"count: {totals['count']}  batch: {n}  "
            f"centers: {np.round(model.latest_centers, 3).tolist()}  "
            f"sizes: {np.bincount(pred, minlength=NUM_CLUSTERS).tolist()}",
            flush=True,
        )
        log.debug("assignments: %s", assign.tolist())
        m = min(n, CHART_MAX_POINTS)
        try:
            chart_q.put_nowait((scaled_host[:m, 0], scaled_host[:m, 1], pred[:m]))
        except queue.Full:
            pass  # the chart is behind: the latest batch wins the next slot
        ckpt.maybe_save(totals)
        recycler.check()
        if max_batches and totals["batches"] >= max_batches:
            ssc.request_stop()

    ssc.raw_stream(source, row_bucket=max(0, conf.batchBucket)).foreach_batch(on_batch)
    try:
        if wall_clock:
            ssc.start()
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
