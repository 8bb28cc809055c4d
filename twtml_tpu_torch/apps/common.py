"""Shared app runtime, single host (counterpart of the single-host parts of
``twtml_tpu/apps/common.py``): source and model construction, the fetch
watchdog, the depth-D fetch pipeline of back-to-back streams, the
synchronous per-batch path of wall-clock streams, and the pre-stream
warm-up.

A batch's life on ``cuda``: the stream featurizes it on the host (the
unpacked batch, whose arrays the handler reads); the pipeline packs it into
a page-locked arena buffer (the ragged wire), ``model.step`` queues the
non-blocking H2D copy and the step's kernels on the model's stream, and
``model.fetch_output`` queues ONE device-to-host copy of the predictions,
stats and quality vector into pinned memory with one event behind it. No
call in that dispatch waits for the card. The handler runs once the event
has fired, on the host copies, in dispatch order; then the batch's leases
retire (the H2D copy ran before the step on the same stream, so it is done).

Checkpoints, runtime guards, the superbatch, multi-host, chaos, lineage,
journal and trace hooks of the JAX package's runtime are not ported
(ROADMAP A4, A5, A10).
"""

from __future__ import annotations

import contextlib
import os
import time

from ..features import assemble, featurize_native, native
from ..features.arena import chain_leases, get_arena
from ..features.batch import (
    FeatureBatch, PackedBatch, RaggedUnitBatch, UnitBatch, pack_batch, wire_nbytes,
)
from ..models.linear import StreamingLinearRegressionWithSGD
from ..streaming.sources import ReplayFileSource, Source, SyntheticSource
from ..telemetry import metrics as _metrics
from ..utils import get_logger

log = get_logger("apps.common")

# fetch-watchdog policy (see FetchWatchdog): the deadline derives from the
# health monitor's rolling fetch wait, clamped; generous, because a retry
# only helps a lost copy, not a busy card
FETCH_DEADLINE_MULT = 25.0
FETCH_DEADLINE_MIN_S = 30.0
FETCH_DEADLINE_MAX_S = 180.0
FETCH_RETRIES = 3

# batches in flight in a back-to-back stream (FetchPipeline)
FETCH_DEPTH = 8

# torch.cuda.set_sync_debug_mode around every dispatch when set ("warn" or
# "error"): a hidden host sync in the dispatch path then warns or raises
SYNC_DEBUG_ENV = "TWTML_SYNC_DEBUG"


class FetchAbort(RuntimeError):
    """The fetch watchdog exhausted its retries: the run is aborting."""


def build_source(conf) -> Source:
    """The configured source. ``--replaySpeed`` paces a replay (x realtime)
    or a synthetic stream (tweets/s). ``TWTML_NOW_MS`` (env), which pins the
    featurizer's clock, also pins the synthetic tweets' creation times, so
    a pinned synthetic run gives the same batches every time."""
    if conf.source == "replay":
        if not conf.replayFile:
            raise SystemExit("--source replay requires --replayFile <path.jsonl>")
        return ReplayFileSource(conf.replayFile, speed=conf.replaySpeed)
    now_env = os.environ.get("TWTML_NOW_MS", "")
    return SyntheticSource(
        rate=conf.replaySpeed or 0.0, base_ms=int(now_env) if now_env else None
    )


def build_model(conf, model_cls=StreamingLinearRegressionWithSGD):
    """The single-device learner on ``--backend``, with the process-wide
    native seams (``--featurizeNative``, ``--wireAssemble``) set and the
    wire arena serving page-locked buffers to a ``cuda`` model."""
    featurize_native.configure(conf.featurizeNative)
    assemble.configure(conf.wireAssemble)
    model = model_cls.from_conf(conf)
    get_arena().use_device(model.device)
    return model


class FetchWatchdog:
    """Deadline + bounded-retry + clean-abort guard over the host fetches.

    A fetch is a pending device-to-host copy (``models/sgd.HostOutput``)
    whose event is polled (``done()``) against the deadline: an event wait
    cannot time out. A fetch that missed its deadline or raised is
    RE-ISSUED as a fresh copy of the same device output, which stays
    resident. The deadline derives from the health monitor's rolling fetch
    wait (``FETCH_DEADLINE_MULT`` x median, clamped to
    [``FETCH_DEADLINE_MIN_S``, ``FETCH_DEADLINE_MAX_S``]; the maximum
    before the first sample). After ``retries`` re-issues the run aborts:
    the abort hook marks it failed and stops the stream, and ``FetchAbort``
    is raised.

    Env overrides: ``TWTML_FETCH_DEADLINE_S`` pins a fixed deadline,
    ``TWTML_FETCH_RETRIES`` the retry budget. Constructor arguments win."""

    # the polling interval grows from the first to the last value
    POLL_FIRST_S = 20e-6
    POLL_MAX_S = 500e-6

    def __init__(self, health, abort=None, deadline_s: float = 0.0,
                 retries: "int | None" = None):
        self._health = health
        self._abort = abort
        self.deadline_s = deadline_s or float(
            os.environ.get("TWTML_FETCH_DEADLINE_S", "0") or 0
        )
        self.retries = (
            retries if retries is not None
            else int(os.environ.get("TWTML_FETCH_RETRIES", FETCH_RETRIES))
        )
        reg = _metrics.get_registry()
        self._retry_count = reg.counter("fetch.retries")
        self._abort_count = reg.counter("fetch.aborts")
        self.aborted = False

    def deadline(self) -> float:
        if self.deadline_s > 0:
            return self.deadline_s
        med_s = self._health.median_ms() / 1e3
        if med_s <= 0:
            return FETCH_DEADLINE_MAX_S
        return min(max(FETCH_DEADLINE_MULT * med_s, FETCH_DEADLINE_MIN_S),
                   FETCH_DEADLINE_MAX_S)

    def _ready_within(self, pending, seconds: float) -> bool:
        end = time.monotonic() + seconds
        nap = self.POLL_FIRST_S
        while not pending.done():
            if time.monotonic() >= end:
                return False
            time.sleep(nap)
            nap = min(2 * nap, self.POLL_MAX_S)
        return True

    def await_result(self, pending, reissue):
        """The host result of ``pending`` within the deadline; ``reissue()``
        starts a fresh fetch of the same device output and returns it."""
        attempts = 0
        while True:
            deadline = self.deadline()
            try:
                if self._ready_within(pending, deadline):
                    return pending.result()
                why = f"made no progress within its {deadline:.3g}s deadline"
            except Exception as exc:  # lawcheck: disable=TW005 -- not a swallow: the failure is captured into `why` and drives the watchdog's retry/abort machine below
                why = f"failed ({exc!r})"
            attempts += 1
            if attempts > self.retries:
                self.aborted = True
                self._abort_count.inc()
                log.critical(
                    "stats fetch %s after %d attempt(s); aborting the run "
                    "(FetchWatchdog)", why, attempts,
                )
                if self._abort is not None:
                    self._abort()
                raise FetchAbort(f"fetch {why} after {attempts} attempts")
            self._retry_count.inc()
            log.warning(
                "stats fetch %s; re-issuing (retry %d/%d: the device output "
                "is still resident, a fresh copy reads the same bytes)",
                why, attempts, self.retries,
            )
            pending = reissue()


class _Ready:
    """A fetch that is complete at once: a model without ``fetch_output``
    returns host values from ``step``."""

    __slots__ = ("_value",)

    def __init__(self, value):
        self._value = value

    def done(self) -> bool:
        return True

    def wait(self) -> None:
        pass

    def result(self):
        return self._value


def _fetcher(model):
    fetch = getattr(model, "fetch_output", None)
    return fetch if fetch is not None else _Ready


@contextlib.contextmanager
def _sync_debug(model, mode: str):
    """``torch.cuda.set_sync_debug_mode(mode)`` around a dispatch on a cuda
    model (no-op when ``mode`` is empty or the model is not on cuda)."""
    device = getattr(model, "device", None)
    if not mode or device is None or device.type != "cuda":
        yield
        return
    import torch

    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


_WIRE_TYPES = (PackedBatch, RaggedUnitBatch, UnitBatch, FeatureBatch)


def _dispatch(model, batch, pack: bool, fetch, sync_debug: str, stamp: dict):
    """Pack (the ragged wire), step and start the fetch of one host batch,
    timing each part into ``stamp``; returns (pending fetch, device output,
    the batch's leases). On cuda the step's device time is bracketed by two
    events, read at delivery (``_finish_stamp``)."""
    device = getattr(model, "device", None)
    events = None
    with _sync_debug(model, sync_debug):
        packs = native.COUNTERS["packs_native"]
        t0 = time.perf_counter()
        wire = pack_batch(batch) if pack else batch
        t1 = time.perf_counter()
        if device is not None and device.type == "cuda":
            import torch

            events = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
            events[0].record()
        out = model.step(wire)
        if events is not None:
            events[1].record()
        t2 = time.perf_counter()
        pending = fetch(out)
        t3 = time.perf_counter()
    stamp.update(
        pack_ms=(t1 - t0) * 1e3, step_host_ms=(t2 - t1) * 1e3,
        dispatch_ms=(t3 - t1) * 1e3, step_events=events,
        wire_bytes=wire_nbytes(wire) if isinstance(wire, _WIRE_TYPES) else None,
        native_pack=native.COUNTERS["packs_native"] > packs,
    )
    return pending, out, chain_leases(getattr(wire, "lease", None),
                                       getattr(batch, "lease", None))


def _finish_stamp(stamp: dict, fetch_wait_s: float) -> None:
    """Delivery-time fields: the fetch wait and the step's time (CUDA
    events on cuda, both complete once the fetch is; the host clock of the
    synchronous step on the CPU)."""
    stamp["fetch_wait_ms"] = fetch_wait_s * 1e3
    events = stamp.pop("step_events", None)
    stamp["step_ms"] = (
        events[0].elapsed_time(events[1]) if events is not None
        else stamp["step_host_ms"]
    )


class FetchPipeline:
    """Depth-D in-order fetch for back-to-back streams: the scheduler thread
    packs and dispatches each batch (``model.step`` and the start of its
    host fetch, nothing waited for), keeps up to ``depth`` fetches in
    flight, and delivers the results IN ORDER to ``handle(host, batch, t,
    at_boundary, stamp)``: blocking on the oldest when ``depth`` are in
    flight, and early for every finished head. ``stamp`` holds the
    batch's timings (``stamp()`` at dispatch, then pack, dispatch, step,
    fetch wait, the in-flight depth at dispatch).

    Semantics of the synchronous path: per-batch stats identical and in
    order; ``at_boundary`` only when nothing newer is in flight (a drain);
    ``max_dispatch`` caps the batches that may train EXACTLY (enforced
    before dispatch, and a batch past the cap still delivers the pending
    ones, where the app's stop fires); ``boundary_every`` drains on a
    monotonic cadence counter; ``flush()`` drains the tail. A batch's
    leases retire after its handler (the handler reads the unpacked
    arrays), and are discarded on a fetch abort, never recycled."""

    def __init__(self, model, handle, depth: int = FETCH_DEPTH, stop_requested=None,
                 boundary_every: int = 0, max_dispatch: int = 0, pack: bool = False,
                 abort=None, fetch_deadline_s: float = 0.0,
                 fetch_retries: "int | None" = None, stamp=None,
                 sync_debug: str = ""):
        self.model = model
        self.handle = handle
        self.depth = max(1, depth)
        self.pack = pack
        self._stop_requested = stop_requested
        self.boundary_every = boundary_every
        self.max_dispatch = max_dispatch
        self._stamp = stamp
        self.sync_debug = sync_debug
        self._fetch = _fetcher(model)
        self._registry = _metrics.get_registry()
        self._health = _metrics.get_health_monitor()
        self._fetch_count = self._registry.counter("fetch.count")
        self._fetch_hist = self._registry.histogram("fetch.latency_s")
        self._depth_gauge = self._registry.gauge("fetch.queue_depth")
        self._refund_count = self._registry.counter("fetch.refunds")
        self._watchdog = FetchWatchdog(
            self._health, abort=abort, deadline_s=fetch_deadline_s,
            retries=fetch_retries,
        )
        self._pending: list = []  # [(fetch, out, batch, t, lease, stamp)], oldest first
        self._dispatched = 0
        # the cadence runs on its own monotonic counter: a refund must not
        # make it pass a point twice or skip one
        self._cadence = 0
        self._last_boundary = 0

    def _emit_one(self) -> None:
        pending, out, batch, t, lease, stamp = self._pending.pop(0)
        t0 = time.perf_counter()
        try:
            host = self._watchdog.await_result(pending, lambda: self._fetch(out))
        except FetchAbort:
            # the dispatch may still run on a wedged card: never hand its
            # buffers out again
            if lease is not None:
                lease.discard()
            raise
        dt = time.perf_counter() - t0
        self._fetch_count.inc()
        self._fetch_hist.observe(dt)
        self._health.observe(dt)
        _finish_stamp(stamp, dt)
        self.handle(host, batch, t, at_boundary=not self._pending, stamp=stamp)
        if lease is not None:
            lease.retire()

    def _drain(self) -> None:
        while self._pending:
            self._emit_one()

    def on_batch(self, batch, t) -> None:
        if self._watchdog.aborted:
            return  # a fetch abort is in flight: nothing more may train
        stop = self._stop_requested
        if stop is not None and stop():
            return
        if self.max_dispatch and self._dispatched >= self.max_dispatch:
            # cap reached: this batch must not train, but what did train is
            # delivered now, or the handler-side stop never fires
            self._drain()
            return
        while len(self._pending) >= self.depth or (
            self._pending and self._pending[0][0].done()
        ):
            self._emit_one()
            if stop is not None and stop():
                return  # the cap landed on an emitted batch: no dispatch
        stamp = dict(self._stamp()) if self._stamp is not None else {}
        stamp["depth"] = len(self._pending)
        pending, out, lease = _dispatch(
            self.model, batch, self.pack, self._fetch, self.sync_debug, stamp
        )
        self._pending.append((pending, out, batch, t, lease, stamp))
        self._depth_gauge.set(len(self._pending))
        self._dispatched += 1
        self._cadence += 1
        if self.boundary_every and (
            self._cadence - self._last_boundary >= self.boundary_every
        ):
            self._drain()
            self._last_boundary = self._cadence

    def refund_dispatch(self) -> None:
        """Give back one ``max_dispatch`` slot (a handler that skips a
        delivered batch)."""
        self._dispatched -= 1
        self._refund_count.inc()

    def flush(self) -> None:
        try:
            self._drain()
        except FetchAbort:
            # logged and the abort hook fired; never raise into shutdown
            if self._pending:
                log.warning("dropping %d undelivered batch output(s) after the "
                            "fetch abort", len(self._pending))
                for entry in self._pending:
                    if entry[4] is not None:
                        entry[4].discard()
                self._pending.clear()


def attach_super_batcher(conf, stream, model, handle, stop_requested=None,
                         max_dispatch: int = 0, abort=None,
                         fetch_depth: int = FETCH_DEPTH, stamp=None):
    """Wire the app's ``handle(host, batch, t, at_boundary, stamp)`` to the
    stream (the K = 1 part of the JAX package's function: no superbatch) and
    return the ``flush`` the app calls after the stream terminated.

    Back to back (``--seconds 0``): a ``FetchPipeline`` of ``fetch_depth``.
    Under a wall clock: one synchronous fetch a batch, so each interval's
    stats reach the dashboard in that interval. Either way the ragged wire
    is packed at dispatch, and a batch with no valid row is skipped before
    the step (its host mask is read, never a device tensor)."""
    pack = bool(getattr(stream, "ragged", False))
    sync_debug = os.environ.get(SYNC_DEBUG_ENV, "")

    def skip_empty(fn):
        def cb(batch, t):
            if batch.num_valid == 0:
                log.debug("batch: 0")
                return
            fn(batch, t)

        return cb

    if conf.seconds <= 0:
        pipe = FetchPipeline(
            model, handle, depth=fetch_depth, stop_requested=stop_requested,
            max_dispatch=max_dispatch, pack=pack, abort=abort, stamp=stamp,
            sync_debug=sync_debug,
        )
        stream.foreach_batch(skip_empty(pipe.on_batch))
        return pipe.flush

    fetch = _fetcher(model)
    reg = _metrics.get_registry()

    def per_batch(batch, t):
        # wall clock: ONE synchronous host fetch of the whole StepOutput
        st = dict(stamp()) if stamp is not None else {}
        st["depth"] = 0
        pending, _out, lease = _dispatch(model, batch, pack, fetch, sync_debug, st)
        t0 = time.perf_counter()
        pending.wait()
        host = pending.result()
        dt = time.perf_counter() - t0
        reg.counter("fetch.count").inc()
        reg.histogram("fetch.latency_s").observe(dt)
        _metrics.get_health_monitor().observe(dt)
        _finish_stamp(st, dt)
        handle(host, batch, t, at_boundary=True, stamp=st)
        if lease is not None:
            lease.retire()  # after the handler, which reads the host arrays

    stream.foreach_batch(skip_empty(per_batch))
    return lambda: None


def warmup_compile(stream, model) -> None:
    """Build and warm the step BEFORE the stream starts, so the first
    wall-clock interval does not swallow the first-use builds (nvcc of the
    fused kernel, g++ of the native host library: seconds each) while a
    live source keeps producing. The warm batch is the stream's own
    all-padding batch (``featurize_empty``), packed as the stream's batches
    are, stepped and fetched: zero valid rows, so the weights stay as they
    are (a zero-count iteration is a no-op).

    The JAX package's warm-up returns early on the ragged wire, whose XLA
    program depends on the data-dependent units bucket. The port compiles
    no program per shape (the kernel builds once; its launch plan is
    computed each call), so it warms on every wire and every bucket."""
    t0 = time.perf_counter()
    empty = stream.featurize_empty()
    wire = pack_batch(empty) if getattr(stream, "ragged", False) else empty
    pending = _fetcher(model)(model.step(wire))
    pending.wait()
    count = float(pending.result().count)
    lease = chain_leases(getattr(wire, "lease", None), getattr(empty, "lease", None))
    if lease is not None:
        lease.retire()
    if count != 0:
        raise RuntimeError(f"warm-up batch trained {count} rows; it must train none")
    log.info("warmed the train step (builds and one all-padding step) in %.1fs",
             time.perf_counter() - t0)
