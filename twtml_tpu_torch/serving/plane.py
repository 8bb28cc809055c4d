"""The serving plane: bounded-latency request coalescing over the predict
engine, with depth-K pipelined result fetches (counterpart of
``twtml_tpu/serving/plane.py``).

- **Coalesce**: requests are admitted until ``--serveBatchRows`` rows or
  ``--serveMaxWaitMs`` since the oldest admitted request, then featurized
  once and dispatched once (one launch of the fused kernel in its
  predict-only mode on the dense route), padded to the row bucket on the
  packed ragged wire. A request is never split across batches.
- **Pipeline**: the result fetches go through ``apps/common.FetchPipeline``
  at ``--serveDepth``: batches N+1..N+K dispatch while batch N's
  predictions are still on their way to the host; every dispatch happens
  on the one serve-loop thread, which binds the model's CUDA device and
  stream before its first.
- **Hot swap**: a promoter hands a new snapshot to ``hot_swap`` (any
  thread); the serve loop installs it BETWEEN dispatches, so a batch in
  flight completes with the weights it dispatched with, and each response
  carries its dispatch-time snapshot step and staleness.
- **Fail loudly, never hang**: the pipeline's FetchWatchdog re-issues a
  stalled or failed fetch and at last aborts, and the abort REJECTS every
  in-flight and queued request future.

The plane reads verified snapshots from DISK (the promoter), shares no
mutable state with a co-located trainer and issues no fetch against it.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from concurrent.futures import Future

import numpy as np

from ..apps.common import SYNC_DEBUG_ENV, FetchAbort, FetchPipeline
from ..telemetry import blackbox as _blackbox
from ..telemetry import metrics as _metrics
from ..utils import get_logger
from ..utils.clock import now_ms, now_s
from .engine import PredictEngine

log = get_logger("serving.plane")

# rolling completion window of the QPS view (stats()), bounded
COMPLETION_WINDOW = 4096
QPS_WINDOW_S = 30.0


class _Request:
    __slots__ = ("statuses", "future", "t_arrival")

    def __init__(self, statuses, future, t_arrival):
        self.statuses = statuses
        self.future = future
        self.t_arrival = t_arrival


class ServingPlane:
    """Request front end over one ``PredictEngine``. ``submit`` is
    thread-safe (the web server's event loop, load generators); featurize,
    dispatch and swap happen on the serve-loop thread alone."""

    def __init__(self, snapshot, *, num_text_features: int = 1000, batch_rows: int = 256,
                 max_wait_ms: float = 5.0, depth: int = 8, model_cls=None, dtype=None,
                 featurizer=None, engine: "PredictEngine | None" = None,
                 stale_slo_s: float = 0.0, device="cuda") -> None:
        from ..features.featurizer import Featurizer

        self.batch_rows = max(1, int(batch_rows))
        self.max_wait_s = max(0.0, float(max_wait_ms) / 1e3)
        self.depth = max(1, int(depth))
        self._engine = engine if engine is not None else PredictEngine(
            num_text_features=num_text_features, dtype=dtype, model_cls=model_cls,
            device=device)
        self._feat = featurizer if featurizer is not None else Featurizer(
            num_text_features=num_text_features)
        self._cond = threading.Condition()
        self._queue: "collections.deque[_Request]" = collections.deque()
        self._inflight: "set[_Request]" = set()
        self._pending_snapshot = None
        self._snapshot_level = ""
        self._stopping = False
        self.failed = False
        self._thread: "threading.Thread | None" = None
        reg = _metrics.get_registry()
        self._req_count = reg.counter("serve.requests")
        self._row_count = reg.counter("serve.rows")
        self._err_count = reg.counter("serve.errors")
        self._batch_count = reg.counter("serve.batches")
        self._swap_count = reg.counter("serve.hot_swaps")
        self._queue_gauge = reg.gauge("serve.queue_depth")
        self._step_gauge = reg.gauge("serve.snapshot_step")
        # snapshot staleness: the install moment through the TWTML_NOW_MS
        # seam gives serving.snapshot_age_s and every response's
        # dispatch-time staleness; --servingStaleSloS > 0 arms a warn-only
        # breach episode
        self._age_gauge = reg.gauge("serving.snapshot_age_s")
        self._stale_breach_count = reg.counter("serve.stale_breaches")
        self.stale_slo_s = max(0.0, float(stale_slo_s or 0.0))
        self._installed_at_s = -1.0
        self._in_stale_episode = False
        self._latency = reg.histogram("serve.latency_s")
        self._batch_fill = reg.histogram("serve.batch_rows")
        # (t_done, rows) of recent completions, for the QPS view
        self._completions: "collections.deque[tuple[float, int]]" = collections.deque(
            maxlen=COMPLETION_WINDOW)
        self._started_s = time.monotonic()
        # the train path's depth-K pipeline, with its --chaos fetch/step
        # points and its FetchWatchdog; TWTML_SYNC_DEBUG runs each dispatch
        # under torch.cuda.set_sync_debug_mode, as in the apps
        self._pipe = FetchPipeline(
            self._engine, self._deliver, depth=self.depth,
            pack=self._engine.accepts_packed, abort=self._on_abort,
            sync_debug=os.environ.get(SYNC_DEBUG_ENV, ""),
        )
        self._install(snapshot)

    @classmethod
    def from_conf(cls, conf, snapshot, model_cls=None, featurizer=None, engine=None):
        from ..models.sgd import DTYPES

        return cls(
            snapshot,
            num_text_features=conf.numTextFeatures,
            batch_rows=int(getattr(conf, "serveBatchRows", 256) or 256),
            max_wait_ms=float(getattr(conf, "serveMaxWaitMs", 5.0) or 0.0),
            depth=int(getattr(conf, "serveDepth", 8) or 8),
            model_cls=model_cls,
            dtype=DTYPES[conf.dtype],
            featurizer=featurizer,
            engine=engine,
            stale_slo_s=float(getattr(conf, "servingStaleSloS", 0.0) or 0.0),
            device=conf.backend,
        )

    # -- request intake ------------------------------------------------------
    @property
    def snapshot_step(self) -> int:
        return self._engine.snapshot_step

    @property
    def num_tenants(self) -> int:
        return self._engine.num_tenants

    def submit(self, statuses) -> Future:
        """Enqueue one predict request (featurizer ``Status`` rows; see
        ``statuses_from_rows`` for the JSON face). Returns a future of
        ``{"predictions": [...], "snapshot_step": N, "model_staleness_s":
        s}``. Thread-safe; never waits on the device."""
        fut: Future = Future()
        if self.failed:
            fut.set_exception(RuntimeError(
                "serving plane aborted (fetch watchdog); restart the server"))
            return fut
        if self._stopping:
            fut.set_exception(RuntimeError("serving plane is shutting down"))
            return fut
        statuses = list(statuses)
        if not statuses:
            fut.set_result({"predictions": [], "snapshot_step": self.snapshot_step})
            return fut
        if len(statuses) > self.batch_rows:
            fut.set_exception(ValueError(
                f"request carries {len(statuses)} rows; the serve batch bucket is "
                f"{self.batch_rows} (--serveBatchRows) — split the request"))
            return fut
        self._req_count.inc()
        self._row_count.inc(len(statuses))
        req = _Request(statuses, fut, time.perf_counter())
        with self._cond:
            self._queue.append(req)
            self._queue_gauge.set(len(self._queue))
            self._cond.notify_all()
        return fut

    @staticmethod
    def statuses_from_rows(rows):
        """The JSON request face as featurizer ``Status`` rows. A row is a
        plain object ``{"text", "followers_count", "favourites_count",
        "friends_count", "created_at_ms", "retweet_count", "lang"}`` for
        the ORIGINAL tweet the model scores (a bare string is ``{"text":
        ...}``), or a standard-API tweet JSON with a ``retweeted_status``,
        parsed by ``Status.from_json``. ``created_at_ms`` defaults to now
        (age feature 0), read through the TWTML_NOW_MS seam."""
        from ..features.featurizer import Status

        default_created_ms = now_ms()
        out = []
        for row in rows:
            if isinstance(row, str):
                row = {"text": row}
            if not isinstance(row, dict):
                raise ValueError(f"bad predict row: {row!r}")
            if row.get("retweeted_status"):
                out.append(Status.from_json(row))
                continue
            original = Status(
                text=str(row.get("text", "")),
                retweet_count=int(row.get("retweet_count") or 0),
                followers_count=int(row.get("followers_count") or 0),
                favourites_count=int(row.get("favourites_count") or 0),
                friends_count=int(row.get("friends_count") or 0),
                created_at_ms=int(row.get("created_at_ms") or default_created_ms),
                lang=str(row.get("lang") or ""),
            )
            out.append(Status(text=original.text, retweeted_status=original,
                              lang=original.lang))
        return out

    # -- snapshot management -------------------------------------------------
    def hot_swap(self, snapshot) -> None:
        """Stage a snapshot (any thread); the serve loop installs it between
        dispatches."""
        with self._cond:
            self._pending_snapshot = snapshot
            self._cond.notify_all()

    def _install(self, snapshot) -> None:
        self._engine.set_snapshot(snapshot)
        self._snapshot_level = snapshot.quality_level
        self._step_gauge.set(self._engine.snapshot_step)
        self._installed_at_s = now_s()
        self._age_gauge.set(0.0)

    def _apply_pending_swap(self) -> None:
        with self._cond:
            snap, self._pending_snapshot = self._pending_snapshot, None
        if snap is not None:
            self._install(snap)
            self._swap_count.inc()
            log.info("hot-swapped serving snapshot to step %d", snap.step)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ServingPlane":
        self._thread = threading.Thread(target=self._loop, name="twtml-serve-loop",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop intake, drain queued and in-flight requests, join the loop."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=60)

    def warmup(self) -> None:
        """Build and launch the predict step once before traffic, so the
        first request does not pay the kernel's nvcc build: one all-padding
        batch of the row bucket, packed, stepped and fetched. It must come
        back with count 0 and zero predictions."""
        batch = self._featurize([])
        wire = self._engine.pack_for_wire(batch)
        pending = self._engine.fetch_output(self._engine.step(wire))
        pending.wait()
        out = pending.result()
        for lease in (getattr(wire, "lease", None), getattr(batch, "lease", None)):
            if lease is not None:
                lease.retire()
        if float(out.count) != 0.0 or np.any(np.asarray(out.predictions) != 0):
            raise RuntimeError("the serve warm-up's all-padding batch must predict zeros "
                               f"over 0 rows; got count {float(out.count)}")

    # -- the serve loop -------------------------------------------------------
    def _featurize(self, statuses):
        return self._feat.featurize_batch_ragged(statuses, row_bucket=self.batch_rows,
                                                 pre_filtered=True)

    def _take_group(self):
        """Admit requests until the row bucket fills or the oldest admitted
        one has waited ``max_wait_s``: the bounded-latency coalescer. A
        list of requests, or None on an idle or stop tick (the caller polls
        the pipeline then)."""
        group: "list[_Request]" = []
        rows = 0
        with self._cond:
            while True:
                while self._queue and rows + len(self._queue[0].statuses) <= self.batch_rows:
                    req = self._queue.popleft()
                    group.append(req)
                    rows += len(req.statuses)
                self._queue_gauge.set(len(self._queue))
                if rows >= self.batch_rows or (group and self._queue):
                    # the bucket is full or the next request does not fit
                    return group
                if group:
                    left = group[0].t_arrival + self.max_wait_s - time.perf_counter()
                    if left <= 0 or self._stopping:
                        return group
                    self._cond.wait(timeout=left)
                    continue
                if self._stopping or self._pending_snapshot is not None:
                    return None
                # idle: a short tick while fetches are in flight (results
                # must deliver promptly), a longer one when quiet
                self._cond.wait(timeout=0.002 if self._pipe.pending_fetches else 0.05)
                if not self._queue:
                    return None

    def _loop(self) -> None:
        self._engine.bind_thread()
        while True:
            group = self._take_group()
            if group is None:
                self._apply_pending_swap()
                try:
                    self._pipe.poll()
                except FetchAbort:
                    self._abort_requests()
                if (self._stopping and not self._queue) or self.failed:
                    break
                continue
            self._apply_pending_swap()  # swaps land BETWEEN dispatches
            statuses = [s for req in group for s in req.statuses]
            try:
                batch = self._featurize(statuses)
                self._batch_fill.observe(len(statuses))
                self._batch_count.inc()
                for req in group:
                    self._inflight.add(req)
                # ONE dispatch a coalesced batch; the snapshot step and its
                # install time ride the payload, so a response names the
                # weights that served it even if a swap lands before its fetch
                self._pipe.on_batch(batch, (group, self._engine.snapshot_step,
                                            self._installed_at_s))
            except FetchAbort:
                self._abort_requests()
                break
            except Exception as exc:
                # this batch failed to featurize or dispatch (a refused
                # launch, a sync under the sync-debug mode): its requests
                # get the error, the plane serves on
                log.exception("serve batch of %d rows failed", len(statuses))
                self._reject(group, f"serve batch failed: {exc!r}")
        try:
            self._pipe.flush()
        except Exception:
            log.exception("serve pipeline flush failed")
        self._abort_requests(reason="serving plane stopped" if not self.failed else None)

    def _deliver(self, host_out, batch, payload, at_boundary=True, stamp=None) -> None:
        """FetchPipeline handler: the batch's predictions, sliced back to
        the requests that rode it, resolve their futures."""
        group, step, installed = payload
        # how old the serving weights were when THIS batch dispatched
        staleness = max(0.0, now_s() - installed) if installed >= 0.0 else -1.0
        preds = self._engine.predictions_for(host_out, batch)
        now = time.perf_counter()
        offset = 0
        for req in group:
            n = len(req.statuses)
            self._inflight.discard(req)
            self._latency.observe(now - req.t_arrival)
            self._completions.append((time.monotonic(), n))
            if not req.future.done():  # done: its HTTP handler was cancelled
                req.future.set_result({
                    "predictions": [float(v) for v in preds[offset:offset + n]],
                    "snapshot_step": int(step),
                    "model_staleness_s": round(staleness, 3),
                })
            offset += n

    def _on_abort(self) -> None:
        self.failed = True
        with self._cond:
            self._cond.notify_all()

    def _abort_requests(self, reason: "str | None" = None) -> None:
        """Reject every in-flight and queued request future: the watchdog
        already logged why; clients get an error, never a hang."""
        with self._cond:
            pending = list(self._queue)
            self._queue.clear()
            self._queue_gauge.set(0)
        stranded = pending + list(self._inflight)
        self._inflight.clear()
        if not stranded:
            return
        why = reason or ("serving fetch aborted by the watchdog (wedged transport); "
                         "see the critical log")
        self._reject(stranded, why)
        log.warning("rejected %d stranded predict request(s): %s", len(stranded), why)

    def _reject(self, requests, why: str) -> None:
        for req in requests:
            self._inflight.discard(req)
            self._err_count.inc()
            if not req.future.done():
                req.future.set_exception(RuntimeError(why))

    # -- telemetry view -------------------------------------------------------
    def stats(self) -> dict:
        """The ``Serving`` view: QPS over the rolling window, latency
        quantiles of the serve histogram, the active snapshot and its age.
        Host bookkeeping only."""
        now = time.monotonic()
        window = min(QPS_WINDOW_S, max(now - self._started_s, 1e-3))
        lo = now - window
        reqs = rows = 0
        for t_done, n in reversed(self._completions):
            if t_done < lo:
                break
            reqs += 1
            rows += n
        age = max(0.0, now_s() - self._installed_at_s) if self._installed_at_s >= 0.0 else -1.0
        self._age_gauge.set(round(age, 1))
        if self.stale_slo_s > 0.0 and age > self.stale_slo_s:
            if not self._in_stale_episode:
                # one flight-recorder event and count a breach episode;
                # warn only, serving goes on
                self._in_stale_episode = True
                self._stale_breach_count.inc()
                _blackbox.record("serving_stale_breach", age_s=round(age, 1),
                                 slo_s=self.stale_slo_s, step=int(self.snapshot_step))
                log.warning("serving snapshot is stale: age %.1f s > SLO %.1f s (step %d) — "
                            "promotion/handoff may be wedged",
                            age, self.stale_slo_s, self.snapshot_step)
        else:
            self._in_stale_episode = False
        return {
            "qps": round(reqs / window, 2),
            "rowsPerSec": round(rows / window, 1),
            "p50Ms": round(self._latency.percentile(0.50) * 1e3, 2),
            "p95Ms": round(self._latency.percentile(0.95) * 1e3, 2),
            "p99Ms": round(self._latency.percentile(0.99) * 1e3, 2),
            "snapshotAgeS": round(age, 1),
            "snapshotStep": int(self.snapshot_step),
            "level": self._snapshot_level,
            "requests": int(self._req_count.snapshot()),
            "rows": int(self._row_count.snapshot()),
            "errors": int(self._err_count.snapshot()),
            "tenants": [],
        }
