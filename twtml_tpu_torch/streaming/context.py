"""Micro-batch streaming runtime, single host (counterpart of
``twtml_tpu/streaming/context.py``): the DStream/StreamingContext
equivalent.

A ``StreamingContext`` owns one source feeding a thread-safe intake queue;
a scheduler thread wakes every ``batch_interval`` seconds (or back to back,
``--seconds 0``), drains the queue, featurizes the tweets into one batch and
invokes every registered output in registration order.

- ``batch_interval > 0`` drains the whole interval;
- ``batch_interval == 0`` with a pinned row bucket waits until a full bucket
  is queued (or the source ended) and drains exactly one bucket, so a fast
  source gives deterministic full batches and one tail;
- ``run_to_completion`` drives the source synchronously in fixed-size
  batches, with no scheduler thread.

The scheduler runs the outputs, and so the model's dispatch, on its own
thread: ``thread_init`` (the model's ``bind_thread``) sets that thread's
CUDA device and stream where it starts. A batch whose outputs raise is
logged and skipped, as in the JAX package.

The batch seams of the runtime guards sit here, where the JAX package has
them: a batch entering featurize opens its freshness lineage record and is
appended to the intake journal (``FeatureStream._process``, the one journal
seam); ``--chaos source.nan`` poisons a featurized batch; a recovery puts
journaled rows back at the queue FRONT (``StreamingContext._putback``); and
``request_abort`` dumps the flight recorder's bundle. The drain and the
featurize are the ``source_read`` and ``featurize`` stages of the stage
clock and of ``--trace``.

Block ingest (``--ingest block``): the queue's items are ``ParsedBlock``s
(features/blocks.py), each counting its rows in the row-bounded queue and
in ``putback``; a drain capped at the row bucket cuts a block at the cap
(``slice_block``) and leaves its tail at the front, so back-to-back block
batches are bucket-sized as object batches are; a batch of blocks is merged
and featurized by ``Featurizer.featurize_parsed_block``.

Multi-host (``start(lockstep=True)``): every rank of the group must run the
same sequence of collectives, so the lockstep scheduler agrees each tick
with ONE all-gather over the host group (``_lockstep_loop``): whether any
rank has rows, whether more are coming, whether one aborts, the sentinel's
rollback count, and each rank's telemetry sideband (telemetry/sideband.py).
A rank whose shard ran dry dispatches all-padding batches until every rank
is done; a failure after featurize aborts the group; a dead peer trips the
progress watchdog (``TWTML_LOCKSTEP_TIMEOUT_S``) or the transport's error
and the survivor aborts loudly instead of hanging. Elastic membership is
ROADMAP A10b.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable

from ..config import SHED_POLICIES
from ..features.batch import FeatureBatch, RaggedUnitBatch, pad_row_count
from ..features.blocks import ParsedBlock, merge_blocks, slice_block
from ..features.featurizer import Featurizer, Status
from ..telemetry import blackbox as _blackbox
from ..telemetry import lineage as _lineage
from ..telemetry import metrics as _metrics
from ..telemetry import sideband as _sideband
from ..telemetry import trace as _trace
from ..utils import get_logger
from ..utils.clock import now_s
from ..utils.tracing import annotate
from . import faults as _faults
from . import journal as _journal
from .sources import Source

log = get_logger("streaming.context")

# the lockstep peer watchdog: how long the tick's cadence all-gather may make
# no progress before this rank concludes a peer is gone and aborts (0
# disables). Generous: ticks legitimately skew by a slow rank's featurize
# and first-use builds.
LOCKSTEP_TIMEOUT_ENV = "TWTML_LOCKSTEP_TIMEOUT_S"
LOCKSTEP_TIMEOUT_DEFAULT_S = 120.0


def _watched_allgather(arr, timeout_s: float):
    """One cadence all-gather (parallel/distributed.py ``host_allgather``)
    under a progress watchdog: the gathered [ranks, n] array, or None when
    the watchdog fired. The collective runs on a daemon thread (a wedged one
    must not hang interpreter exit); the scheduler waits for it before
    anything else, so the order of collectives stays total. A transport
    error from the collective (the other way a dead peer shows) propagates."""
    from ..parallel.distributed import host_allgather

    if timeout_s <= 0:
        return host_allgather(arr)
    box: dict = {}
    done = threading.Event()

    def run() -> None:
        try:
            box["out"] = host_allgather(arr)
        except BaseException as exc:  # noqa: BLE001  # lawcheck: disable=TW005 -- not a swallow: re-raised by the waiting caller
            box["exc"] = exc
        done.set()

    threading.Thread(target=run, daemon=True, name="twtml-lockstep-allgather").start()
    if not done.wait(timeout_s):
        return None
    if "exc" in box:
        raise box["exc"]
    return box["out"]


class _RowCountQueue(queue.Queue):
    """queue.Queue that also counts the queued ROWS (an item with a
    ``rows`` attribute counts its rows, a Status counts 1), kept inside
    ``_put``/``_get`` under the queue's own mutex.

    ``configure_bound`` arms a row ceiling (``--maxQueueRows``) with two
    overload policies:

    - ``block``: the producer waits until the consumer drains below the
      bound (replay and backfill sources: the data cannot be lost);
    - ``shed-oldest``: whole items drop from the queue FRONT until the new
      item fits (live sources: the freshest rows are the valuable ones).
      Shedding from the front never reorders the survivors.

    Shed rows are counted (``ingest.rows_shed``); an item bigger than the
    whole bound is admitted alone; ``close()`` releases a blocked producer
    at shutdown. ``max_rows=0`` is unbounded.

    Items put back at the front (``putback``: a drain's remainder, or rows
    a journal replay re-ingests) count in ``rows_queued`` and are never
    shed: they were admitted once, and replayed rows must re-cross the
    journal's seam in order, or its replay suppression would swallow fresh
    rows instead."""

    max_rows = 0
    policy = "block"

    def _init(self, maxsize: int) -> None:
        super()._init(maxsize)
        self.rows_queued = 0
        self.rows_shed_total = 0
        self._closed = False
        self._protected = 0  # items at the front that were put back

    def configure_bound(self, max_rows: int, policy: str = "block") -> None:
        if policy not in SHED_POLICIES:
            raise ValueError(
                f"shed policy must be one of {SHED_POLICIES}, got {policy!r}"
            )
        self.max_rows = max(0, int(max_rows))
        self.policy = policy

    def close(self) -> None:
        """Release producers blocked on a full bounded queue."""
        with self.mutex:
            self._closed = True
            self.not_full.notify_all()

    def put(self, item, block=True, timeout=None) -> None:
        if self.max_rows <= 0:
            return super().put(item, block, timeout)
        rows = getattr(item, "rows", 1)
        with self.not_full:
            if self.policy == "block":
                # admit when empty regardless of size: one item larger than
                # the whole bound must pass, not deadlock
                while (
                    self.rows_queued > 0
                    and self.rows_queued + rows > self.max_rows
                    and not self._closed
                ):
                    self.not_full.wait(0.1)
            else:  # shed-oldest
                shed = 0
                while (len(self.queue) > self._protected
                       and self.rows_queued + rows > self.max_rows):
                    old = self.queue[self._protected]
                    del self.queue[self._protected]
                    r = getattr(old, "rows", 1)
                    self.rows_queued -= r
                    shed += r
                if shed:
                    self.rows_shed_total += shed
                    reg = _metrics.get_registry()
                    reg.counter("ingest.rows_shed").inc(shed)
                    reg.gauge("ingest.queue_rows").set(self.rows_queued)
                    log.warning(
                        "intake queue over --maxQueueRows %d: shed %d "
                        "oldest row(s) to admit %d new (total shed %d)",
                        self.max_rows, shed, rows, self.rows_shed_total,
                    )
            self._put(item)
            self.unfinished_tasks += 1
            self.not_empty.notify()

    def putback(self, item) -> None:
        """Return an item to the FRONT of the queue, exempt from the bound
        (its rows were admitted once already)."""
        with self.mutex:
            self.queue.appendleft(item)
            self._protected += 1
            self.rows_queued += getattr(item, "rows", 1)
            self.not_empty.notify()

    def drain_rows(self, limit: int = 0, slicer=None):
        """Pop queued items up to ``limit`` ROWS (0 = everything) under ONE
        mutex acquire, splitting an overshooting multi-row item with
        ``slicer(item, cut) -> (head, tail)``, the tail left at the front.
        One ``notify_all`` a drain wakes a bound-blocked producer once."""
        out: list = []
        rows = 0
        with self.mutex:
            while self.queue and (not limit or rows < limit):
                item = self.queue[0]
                take = getattr(item, "rows", None)
                if take is not None and limit and rows + take > limit:
                    cut = limit - rows
                    head, tail = slicer(item, cut)
                    self.queue[0] = tail
                    self.rows_queued -= cut
                    out.append(head)
                    rows = limit
                    break
                self.queue.popleft()
                self._protected = max(0, self._protected - 1)
                taken = take if take is not None else 1
                self.rows_queued -= taken
                rows += taken
                out.append(item)
            self.not_full.notify_all()
        return out

    def _put(self, item) -> None:
        super()._put(item)
        self.rows_queued += getattr(item, "rows", 1)

    def _get(self):
        item = super()._get()
        self._protected = max(0, self._protected - 1)
        self.rows_queued -= getattr(item, "rows", 1)
        return item


class RawStream:
    """A stream of raw Status lists, for apps that featurize on their own
    (the k-means entry: a dense pair a retweet); outputs fire per
    micro-batch in registration order. ``row_bucket`` caps back-to-back
    drains."""

    def __init__(self, row_bucket: int = 0):
        self._outputs: list[Callable] = []
        self.row_bucket = row_bucket

    def foreach_batch(self, fn) -> "RawStream":
        self._outputs.append(fn)
        return self

    def _process(self, statuses: list[Status], batch_time: float):
        for fn in self._outputs:
            fn(statuses, batch_time)


class FeatureStream(RawStream):
    """A RawStream whose outputs receive featurized host batches: the
    padded units wire (``UnitBatch``) or, with ``ragged``, the ragged units
    wire (``RaggedUnitBatch``, unpacked; the fetch pipeline packs it), both
    hashed on the device; or, without ``device_hash`` (``--hashOn host``),
    a ``FeatureBatch`` of bigram counts hashed on the host, which only the
    padded wire carries (ragged raises, as in the JAX package).

    ``last_featurize`` describes the newest batch: when its featurize
    started (``time.perf_counter()``), its featurize ms, the featurizer's
    sub-stage ms, and whether the native fill built it."""

    def __init__(self, featurizer: Featurizer, row_bucket: int = 0,
                 token_bucket: int = 0, ragged: bool = False, device_hash: bool = True):
        super().__init__(row_bucket)
        if ragged and not device_hash:
            raise ValueError("the ragged wire IS a device-hash wire format: "
                             "--wire ragged requires --hashOn device")
        self.featurizer = featurizer
        self.token_bucket = token_bucket
        self.ragged = ragged
        self.device_hash = device_hash
        self.last_featurize: dict = {}
        self._bucket_overflow_warned = False
        self._pinned_rows = pad_row_count(0, row_bucket) if row_bucket > 0 else 0

    @staticmethod
    def batch_shape(batch) -> "tuple[int, int]":
        """(rows, units or tokens) of a featurized batch: the two axes the
        pinned buckets govern (a ragged batch's static row length is its
        units axis)."""
        if isinstance(batch, RaggedUnitBatch):
            return batch.mask.shape[0], batch.row_len
        if isinstance(batch, FeatureBatch):
            return batch.mask.shape[0], batch.token_idx.shape[1]
        return batch.mask.shape[0], batch.units.shape[1]

    def bucket_overflow(self, batch) -> bool:
        """Whether a batch outgrew the pinned buckets (the featurizer grows
        a bucket rather than truncate)."""
        rows, units = self.batch_shape(batch)
        return (0 < self._pinned_rows < rows) or (0 < self.token_bucket < units)

    def _check_buckets(self, batch) -> None:
        """Warn once when a batch overflowed the pinned buckets: its shape
        differs from the warm-up's, so the step's buffers and launch plan
        change size mid-stream."""
        if self._bucket_overflow_warned or not self.bucket_overflow(batch):
            return
        self._bucket_overflow_warned = True
        rows, units = self.batch_shape(batch)
        log.warning(
            "batch shape (%d, %d) overflowed the pinned buckets (%d, %d): "
            "raise --batchBucket/--tokenBucket to keep one shape",
            rows, units, self.row_bucket, self.token_bucket,
        )

    def _featurize(self, statuses: list):
        """The ONE featurize dispatch of this stream's configuration (a
        batch of ParsedBlocks takes the block featurizer),
        shared by the per-batch path and ``featurize_empty``, timed into
        ``last_featurize``, the ``featurize.<name>_ms`` gauges and the
        stage clock (a span, and one a sub-stage, under ``--trace``). A real
        batch (statuses not empty) is the ``--chaos source.nan`` injection
        point: the warm-up's empty batch never counts a call."""
        from ..features import native

        tr = _trace.get()
        fills = native.COUNTERS["fills_native"]
        t0 = time.perf_counter()
        with tr.span("featurize", items=len(statuses)) as sp, annotate("twtml.featurize"):
            if statuses and isinstance(statuses[0], ParsedBlock):
                # block ingest: pre-filtered columnar rows, no Status objects
                batch = self.featurizer.featurize_parsed_block(
                    merge_blocks(statuses), row_bucket=self.row_bucket,
                    unit_bucket=self.token_bucket, ragged=self.ragged,
                )
            elif not self.device_hash:
                # host hashing: bigram counts hashed here, padded tokens
                # on the wire
                batch = self.featurizer.featurize_batch(
                    statuses, row_bucket=self.row_bucket, token_bucket=self.token_bucket,
                )
            elif self.ragged:
                batch = self.featurizer.featurize_batch_ragged(
                    statuses, row_bucket=self.row_bucket, unit_bucket=self.token_bucket,
                )
            else:
                batch = self.featurizer.featurize_batch_units(
                    statuses, row_bucket=self.row_bucket, unit_bucket=self.token_bucket,
                )
            if tr.enabled:
                from ..features.batch import wire_nbytes

                sp.add(rows=int(batch.mask.shape[0]), valid=batch.num_valid,
                       wire_bytes=wire_nbytes(batch))
        t1 = time.perf_counter()
        _sideband.record_stage("featurize", t1 - t0)
        featurize_ms = (t1 - t0) * 1e3
        subs: dict[str, float] = {}
        for name, sub_t0, seconds in self.featurizer.last_substages:
            subs[name] = subs.get(name, 0.0) + seconds * 1e3
            if tr.enabled:
                tr.complete("featurize." + name, sub_t0, seconds)
        reg = _metrics.get_registry()
        for name, ms in subs.items():
            reg.gauge(f"featurize.{name}_ms").set(round(ms, 4))
        self.last_featurize = {
            "featurize_started_s": t0,
            "featurize_ms": featurize_ms,
            "featurize_substages_ms": subs,
            "native_fill": native.COUNTERS["fills_native"] > fills,
        }
        if statuses and _faults.get_chaos() is not None:
            batch = _faults.maybe_poison_labels(batch)
        return batch

    @staticmethod
    def _record_metrics(batch) -> None:
        from ..features.batch import wire_nbytes

        reg = _metrics.get_registry()
        reg.counter("pipeline.batches").inc()
        reg.counter("pipeline.tweets").inc(batch.num_valid)
        reg.counter("wire.bytes").inc(wire_nbytes(batch))

    def featurize_empty(self):
        """An all-padding batch of this stream's configured shape, for the
        pre-stream warm-up."""
        return self._featurize([])

    def _process(self, statuses: list[Status], batch_time: float):
        # the batch's freshness lineage record, and THE intake journal
        # seam: raw rows become a replay record before featurize, so a
        # recovery re-ingests what the unchanged featurize path reads
        _lineage.open_batch(statuses)
        _journal.record_intake(statuses)
        batch = self._featurize(statuses)
        self._check_buckets(batch)
        self._record_metrics(batch)
        for fn in self._outputs:
            fn(batch, batch_time)
        return batch


def _split_block(block, cut: int):
    """(first ``cut`` rows, the rest) of a ParsedBlock: a capped drain's
    slicer."""
    return slice_block(block, 0, cut), slice_block(block, cut, block.rows)


class StreamingContext:
    def __init__(self, batch_interval: float = 5.0, max_queue_rows: int = 0,
                 shed_policy: str = "block", thread_init: Callable | None = None):
        """``max_queue_rows``/``shed_policy`` arm the bounded intake queue
        (``--maxQueueRows``/``--shedPolicy``; 0 = unbounded).
        ``thread_init`` runs first on the scheduler thread."""
        self.batch_interval = batch_interval
        self._queue: _RowCountQueue = _RowCountQueue()
        if max_queue_rows > 0:
            self._queue.configure_bound(max_queue_rows, shed_policy)
        self._thread_init = thread_init
        self._source: Source | None = None
        self._stream: RawStream | None = None
        self._scheduler: threading.Thread | None = None
        self._stop = threading.Event()
        self._terminated = threading.Event()
        self.batches_processed = 0
        # set by request_abort: the app raises instead of reporting success
        self.failed = False
        # the sentinel's cumulative rollback count (DivergenceSentinel sets
        # it): it rides the lockstep scheduler's cadence all-gather, where
        # every rank must report the same
        self.rollback_count_fn: "Callable[[], int] | None" = None
        # lockstep ticks run (the peer.* chaos points and the tests)
        self.ticks = 0

    def source_stream(self, source: Source, featurizer: Featurizer,
                      row_bucket: int = 0, token_bucket: int = 0,
                      ragged: bool = False, device_hash: bool = True) -> FeatureStream:
        """Attach the (single) source and build its feature stream."""
        if self._source is not None:
            raise ValueError("StreamingContext supports one source stream")
        self._source = source
        self._stream = FeatureStream(featurizer, row_bucket, token_bucket, ragged,
                                     device_hash)
        return self._stream

    def raw_stream(self, source: Source, row_bucket: int = 0) -> RawStream:
        """Attach the (single) source with no featurization: outputs receive
        each micro-batch's Status list. ``row_bucket`` caps back-to-back
        drains."""
        if self._source is not None:
            raise ValueError("StreamingContext supports one source stream")
        self._source = source
        self._stream = RawStream(row_bucket)
        return self._stream

    def _drain(self, limit: int = 0) -> list[Status]:
        """Drain queued items, at most ``limit`` rows (0 = all; a block
        that would overshoot is cut at the cap, its tail left at the
        front), and set the ``ingest.queue_rows`` gauge (once a drain,
        never a tweet); the ``source_read`` stage."""
        t0 = time.perf_counter()
        with _trace.get().span("source_read") as sp:
            out = self._queue.drain_rows(limit, slicer=_split_block)
            sp.add(items=len(out))
        _sideband.record_stage("source_read", time.perf_counter() - t0)
        _metrics.get_registry().gauge("ingest.queue_rows").set(self._queue.rows_queued)
        return out

    def _putback(self, items: list) -> None:
        """Return ``items`` to the queue FRONT in their order (a journal
        replay's rows train next, before anything queued after them)."""
        for item in reversed(items):
            self._queue.putback(item)

    def _run_batch(self, statuses: list[Status], batch_time: float) -> None:
        try:
            self._stream._process(statuses, batch_time)
            self.batches_processed += 1
        except Exception:
            log.exception("batch at t=%.3f failed", batch_time)

    def _scheduler_loop(self) -> None:
        try:
            if self._thread_init is not None:
                try:
                    self._thread_init()
                except Exception:
                    log.exception("scheduler thread set-up failed")
                    self.failed = True
                    return
            # back to back (--seconds 0) with a pinned row bucket: one
            # bucket a batch; a wall clock drains the whole interval
            limit = self._stream.row_bucket if self.batch_interval == 0 else 0
            next_tick = time.monotonic() + self.batch_interval
            while not self._stop.is_set():
                delay = next_tick - time.monotonic()
                if delay > 0 and self._stop.wait(delay):
                    break
                next_tick += self.batch_interval
                if (limit and self._queue.rows_queued < limit
                        and not self._source.exhausted):
                    # fill the bucket before processing: batch boundaries
                    # stay deterministic instead of racing the producer
                    self._stop.wait(0.002)
                    continue
                self._run_batch(self._drain(limit), now_s())
                if self._source.exhausted and self._queue.empty():
                    break
        finally:
            self._terminated.set()

    def _run_batch_aligned(self, statuses: list, batch_time: float) -> None:
        """A lockstep tick's batch: a host-side failure must not change
        this rank's sequence of collectives. A featurize failure (nothing
        dispatched yet) substitutes the all-padding batch (its rows lost,
        loudly); a batch that outgrew the pinned buckets would dispatch
        other shapes than the peers', so its over-long rows are dropped
        (counted in ``ingest.rows_dropped_overflow``), the whole batch if
        that is not enough. A failure in the outputs (dispatch, handler)
        propagates: after a partial dispatch the group's alignment is
        unknown, and the loop aborts the group."""
        stream = self._stream
        if not isinstance(stream, FeatureStream):
            stream._process(statuses, batch_time)
            self.batches_processed += 1
            return
        _lineage.open_batch(statuses)
        _journal.record_intake(statuses)
        try:
            batch = stream._featurize(statuses)
        except Exception:  # lawcheck: disable=TW005 -- logged and counted as lost rows; the peers' collectives need this rank's batch
            log.exception("featurize failed in lockstep mode; substituting an all-padding "
                          "batch to keep the group's collectives aligned (these rows are "
                          "lost)")
            batch = stream._featurize([])
        if stream.bucket_overflow(batch):
            kept = [s for s in statuses
                    if isinstance(s, Status)
                    and stream.featurizer.unit_len(s) <= stream.token_bucket]
            rows, units = stream.batch_shape(batch)
            log.error("batch shape (%d, %d) overflowed the pinned buckets (%d, %d) in a "
                      "multi-host run; dropping %d over-long row(s) to keep the group's "
                      "shapes aligned: raise --batchBucket/--tokenBucket", rows, units,
                      stream.row_bucket, stream.token_bucket, len(statuses) - len(kept))
            reg = _metrics.get_registry()
            reg.counter("ingest.rows_dropped_overflow").inc(len(statuses) - len(kept))
            batch = stream._featurize(kept)
            if stream.bucket_overflow(batch):
                log.error("overflow persists; dropping the whole batch")
                reg.counter("ingest.rows_dropped_overflow").inc(len(kept))
                batch = stream._featurize([])
        stream._record_metrics(batch)
        for fn in stream._outputs:
            fn(batch, batch_time)
        self.batches_processed += 1

    def _lockstep_loop(self) -> None:
        """The multi-host scheduler: each tick one all-gather of (has rows,
        more coming, aborting, sentinel rollbacks, the sideband vector)
        decides for every rank at once whether to dispatch, stop or abort.
        A rank with no rows dispatches an all-padding batch while any rank
        has rows (a zero-count step changes no weight). A batch failure
        after featurize sets ``aborting``: the rank dispatches nothing more
        and its next tick tells the peers, so every rank stops at the same
        tick, ``failed``. A cadence all-gather with no progress in
        ``TWTML_LOCKSTEP_TIMEOUT_S`` (or one that raises: a dead peer)
        aborts this rank loudly (``lockstep.watchdog_aborts``). Ranks that
        disagree on the sentinel's rollback count have diverged and abort
        too. Drains are capped at the row bucket in both clock modes, so a
        batch never outgrows the peers' shapes."""
        import os

        import numpy as np

        from ..parallel import distributed as _dist

        if self._thread_init is not None:
            try:
                self._thread_init()
            except Exception:  # lawcheck: disable=TW005 -- logged; the run is marked failed
                log.exception("scheduler thread set-up failed")
                self.failed = True
                self._terminated.set()
                return
        watch_s = float(os.environ.get(LOCKSTEP_TIMEOUT_ENV, "") or LOCKSTEP_TIMEOUT_DEFAULT_S)
        mesh = _dist.mesh()
        tele = _sideband.LockstepTelemetry(mesh.process_index, mesh.num_processes)
        reg = _metrics.get_registry()
        limit = self._stream.row_bucket
        next_tick = time.monotonic() + self.batch_interval
        aborting = False
        try:
            while not self._stop.is_set():
                if self.batch_interval > 0 and not aborting:
                    delay = next_tick - time.monotonic()
                    if delay > 0 and self._stop.wait(delay):
                        break
                    next_tick += self.batch_interval
                elif limit and not aborting:
                    while (self._queue.rows_queued < limit and not self._source.exhausted
                           and not self._stop.is_set()):
                        self._stop.wait(0.002)
                self.ticks += 1
                _faults.lockstep_chaos(self.ticks, self.batch_interval,
                                       uid=mesh.process_index)
                local = self._drain(limit)
                rows = sum(getattr(s, "rows", 1) for s in local)
                more = (not self._source.exhausted) or self._queue.rows_queued > 0
                rollbacks = (int(self.rollback_count_fn())
                             if self.rollback_count_fn is not None else 0)
                try:
                    flags = _watched_allgather(np.concatenate([
                        np.array([rows > 0 and not aborting, more and not aborting,
                                  aborting, rollbacks], np.float64),
                        tele.vector(rollbacks=rollbacks),
                    ]), watch_s)
                except Exception:  # lawcheck: disable=TW005 -- logged, counted and the run aborted
                    log.critical("lockstep cadence all-gather FAILED: a peer likely died "
                                 "mid-run; aborting this rank loudly (progress up to the "
                                 "last checkpoint is saved)", exc_info=True)
                    reg.counter("lockstep.watchdog_aborts").inc()
                    self.request_abort("lockstep cadence all-gather failed (peer death / "
                                       "transport error)")
                    break
                tele.tick_done()
                if flags is None:
                    log.critical("lockstep peer watchdog: the cadence all-gather made no "
                                 "progress in %.0fs: a peer is gone. Aborting this rank "
                                 "loudly instead of hanging; tune with %s (0 disables)",
                                 watch_s, LOCKSTEP_TIMEOUT_ENV)
                    reg.counter("lockstep.watchdog_aborts").inc()
                    _trace.get().instant("lockstep_watchdog", timeout_s=watch_s)
                    self.request_abort(f"lockstep peer watchdog: no all-gather progress in "
                                       f"{watch_s:.0f}s")
                    break
                fi = flags[:, :4].astype(np.int64)
                tele.ingest(flags[:, 4:])
                if fi[:, 2].any():
                    if not aborting:
                        log.critical("a peer rank aborted the lockstep run")
                    self.request_abort("lockstep batch failure on this rank" if aborting
                                       else "a peer rank aborted the lockstep run")
                    break
                if len(set(fi[:, 3].tolist())) > 1:
                    log.critical("lockstep ranks disagree on sentinel rollback counts %s: "
                                 "their models have diverged; aborting the group",
                                 fi[:, 3].tolist())
                    reg.counter("lockstep.rollback_disagreements").inc()
                    self.request_abort("lockstep ranks disagree on sentinel rollback "
                                       f"counts {fi[:, 3].tolist()}")
                    break
                if fi[:, 0].any():
                    try:
                        self._run_batch_aligned(local, now_s())
                    except Exception:  # lawcheck: disable=TW005 -- logged; the next tick aborts the group
                        log.critical("lockstep batch failed after featurize; this rank's "
                                     "collective alignment is unknown: aborting the group",
                                     exc_info=True)
                        aborting = True
                if not aborting and not (fi[:, 0].any() or fi[:, 1].any()):
                    break
        finally:
            self._terminated.set()

    def request_stop(self) -> None:
        """Stop after the current batch (the apps' max-batches hook)."""
        self._stop.set()

    def request_abort(self, reason: str = "runtime guard abort") -> None:
        """Mark the run failed and stop after the current batch: the hook
        of every runtime guard that aborts (the fetch watchdog, the
        sentinel's rollback budget), so the app's shutdown still saves its
        final checkpoint. Every abort comes through here, so this dumps the
        flight recorder's bundle (once; a no-op without ``--blackbox``)."""
        log.critical("run aborting: %s", reason)
        self.failed = True
        _blackbox.abort_dump(reason)
        self.request_stop()

    @property
    def stop_requested(self) -> bool:
        return self._stop.is_set()

    # -- lifecycle (ssc.start/awaitTermination, LinearRegression.scala:89-91) --
    def start(self, lockstep: bool = False) -> None:
        """Start the source and the scheduler thread: the lockstep one
        (``_lockstep_loop``) for a multi-host group."""
        if self._stream is None:
            raise ValueError("no stream registered")
        self._stop.clear()
        self._terminated.clear()
        self.failed = False
        self._source.start(self._queue.put)
        self._scheduler = threading.Thread(
            target=self._lockstep_loop if lockstep else self._scheduler_loop,
            name="twtml-batch-scheduler", daemon=True,
        )
        self._scheduler.start()

    def await_termination(self, timeout: float | None = None) -> bool:
        return self._terminated.wait(timeout)

    def stop(self) -> None:
        self._stop.set()
        # release a producer blocked on a full bounded queue FIRST, or the
        # source's join would time out against a wedged put()
        self._queue.close()
        if self._source is not None:
            self._source.stop()
        if self._scheduler is not None:
            self._scheduler.join(timeout=10)
        self._terminated.set()

    # -- deterministic replay mode (no wall clock) ---------------------------
    def run_to_completion(self, max_batch_size: int = 1024) -> int:
        """Drive the source synchronously in batches of up to
        ``max_batch_size`` tweets, back to back; returns the batches run."""
        if self._stream is None:
            raise ValueError("no stream registered")
        self._source.start(self._queue.put)
        n0 = self.batches_processed
        pending: list[Status] = []
        while not self._stop.is_set():
            try:
                pending.append(self._queue.get(timeout=0.05))
                if len(pending) >= max_batch_size:
                    self._run_batch(pending, now_s())
                    pending = []
            except queue.Empty:
                if self._source.exhausted:
                    # the source may have emitted between the timeout and
                    # the exhausted flag
                    pending.extend(self._drain())
                    break
        if pending and not self._stop.is_set():
            self._run_batch(pending, now_s())
        self._terminated.set()
        return self.batches_processed - n0
