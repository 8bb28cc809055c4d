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
logged and skipped, as in the JAX package. The lockstep (multi-host)
scheduler, elastic membership, block ingest, the intake journal, lineage and
chaos hooks are not ported (ROADMAP A5, A10, A12).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable

from ..config import SHED_POLICIES
from ..features.batch import RaggedUnitBatch, pad_row_count
from ..features.featurizer import Featurizer, Status
from ..telemetry import metrics as _metrics
from ..utils import get_logger
from ..utils.clock import now_s
from .sources import Source

log = get_logger("streaming.context")


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
    at shutdown. ``max_rows=0`` is unbounded."""

    max_rows = 0
    policy = "block"

    def _init(self, maxsize: int) -> None:
        super()._init(maxsize)
        self.rows_queued = 0
        self.rows_shed_total = 0
        self._closed = False

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
                while self.queue and self.rows_queued + rows > self.max_rows:
                    old = self.queue.popleft()
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
        self.rows_queued -= getattr(item, "rows", 1)
        return item


class RawStream:
    """A stream of raw Status lists; outputs fire per micro-batch in
    registration order. ``row_bucket`` caps back-to-back drains."""

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
    wire (``RaggedUnitBatch``, unpacked; the fetch pipeline packs it). Both
    are device-hash wires: host hashing is not ported.

    ``last_featurize`` describes the newest batch: when its featurize
    started (``time.perf_counter()``), its featurize ms, the featurizer's
    sub-stage ms, and whether the native fill built it."""

    def __init__(self, featurizer: Featurizer, row_bucket: int = 0,
                 token_bucket: int = 0, ragged: bool = False):
        super().__init__(row_bucket)
        self.featurizer = featurizer
        self.token_bucket = token_bucket
        self.ragged = ragged
        self.last_featurize: dict = {}
        self._bucket_overflow_warned = False
        self._pinned_rows = pad_row_count(0, row_bucket) if row_bucket > 0 else 0

    @staticmethod
    def batch_shape(batch) -> "tuple[int, int]":
        """(rows, units) of a featurized batch: the two axes the pinned
        buckets govern (a ragged batch's static row length is its units
        axis)."""
        if isinstance(batch, RaggedUnitBatch):
            return batch.mask.shape[0], batch.row_len
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
        """The ONE featurize dispatch of this stream's configuration,
        shared by the per-batch path and ``featurize_empty``, timed into
        ``last_featurize`` and the ``featurize.<name>_ms`` gauges."""
        from ..features import native

        fills = native.COUNTERS["fills_native"]
        t0 = time.perf_counter()
        if self.ragged:
            batch = self.featurizer.featurize_batch_ragged(
                statuses, row_bucket=self.row_bucket, unit_bucket=self.token_bucket,
            )
        else:
            batch = self.featurizer.featurize_batch_units(
                statuses, row_bucket=self.row_bucket, unit_bucket=self.token_bucket,
            )
        featurize_ms = (time.perf_counter() - t0) * 1e3
        subs: dict[str, float] = {}
        for name, _t0, seconds in self.featurizer.last_substages:
            subs[name] = subs.get(name, 0.0) + seconds * 1e3
        reg = _metrics.get_registry()
        for name, ms in subs.items():
            reg.gauge(f"featurize.{name}_ms").set(round(ms, 4))
        self.last_featurize = {
            "featurize_started_s": t0,
            "featurize_ms": featurize_ms,
            "featurize_substages_ms": subs,
            "native_fill": native.COUNTERS["fills_native"] > fills,
        }
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
        batch = self._featurize(statuses)
        self._check_buckets(batch)
        self._record_metrics(batch)
        for fn in self._outputs:
            fn(batch, batch_time)
        return batch


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

    def source_stream(self, source: Source, featurizer: Featurizer,
                      row_bucket: int = 0, token_bucket: int = 0,
                      ragged: bool = False) -> FeatureStream:
        """Attach the (single) source and build its feature stream."""
        if self._source is not None:
            raise ValueError("StreamingContext supports one source stream")
        self._source = source
        self._stream = FeatureStream(featurizer, row_bucket, token_bucket, ragged)
        return self._stream

    def _drain(self, limit: int = 0) -> list[Status]:
        """Drain queued items, at most ``limit`` rows (0 = all), and set the
        ``ingest.queue_rows`` gauge (once a drain, never a tweet)."""
        out = self._queue.drain_rows(limit)
        _metrics.get_registry().gauge("ingest.queue_rows").set(self._queue.rows_queued)
        return out

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

    def request_stop(self) -> None:
        """Stop after the current batch (the apps' max-batches hook)."""
        self._stop.set()

    def request_abort(self, reason: str = "runtime guard abort") -> None:
        """Mark the run failed and stop after the current batch (the fetch
        watchdog's abort hook)."""
        log.critical("run aborting: %s", reason)
        self.failed = True
        self.request_stop()

    @property
    def stop_requested(self) -> bool:
        return self._stop.is_set()

    # -- lifecycle (ssc.start/awaitTermination, LinearRegression.scala:89-91) --
    def start(self) -> None:
        if self._stream is None:
            raise ValueError("no stream registered")
        self._stop.clear()
        self._terminated.clear()
        self.failed = False
        self._source.start(self._queue.put)
        self._scheduler = threading.Thread(
            target=self._scheduler_loop, name="twtml-batch-scheduler", daemon=True
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
