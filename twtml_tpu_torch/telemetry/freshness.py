"""End-to-end freshness plane (counterpart of
``twtml_tpu/telemetry/freshness.py``), verdict for verdict.

Consumes the per-batch lineage records (telemetry/lineage.py): host
arithmetic over rolling windows, no added copy from the card.

- **event-time lag**: p50/p95/p99 of tweet ``created_at_ms`` to fetch
  delivery (exact, over a rolling window), the same lag to the stats
  publish, and a low watermark (now - the oldest event time still in
  flight);
- **critical path**: each batch's dominant stage delta between open and
  delivery, counted in ``freshness.critical.<edge>.ticks``;
- **SLO**: ``--freshnessSloMs`` with a sustained-breach run; the delivery
  adapter (apps/common.py ``FreshnessGuard``) forces one verified
  checkpoint an episode. Warn-only.

``record_delivery`` is the adapter's hook, ``record_publish`` the session
publisher's, ``last_freshness`` the dashboard view and
``snapshot_for_checkpoint`` the checkpoint stamp. All no-ops until
``configure`` turns the plane on.
"""

from __future__ import annotations

import threading
from collections import deque

from ..utils import get_logger
from ..utils.clock import now_ms
from . import blackbox as _blackbox
from . import lineage as _lineage
from . import metrics as _metrics

log = get_logger("telemetry.freshness")

LAG_WINDOW = 512
SPARK_WINDOW = 64
PUBLISH_PENDING_MAX = 1024
# delivered batches over the SLO before an episode fires
BREACH_WINDOW = 8
# ms-scale histogram bounds (1 ms .. ~2.3 h)
LAG_BOUNDS = tuple(1.0 * (2.0 ** i) for i in range(24))


def _pct(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return -1.0
    return float(sorted_vals[min(len(sorted_vals) - 1, int(q * len(sorted_vals)))])


class FreshnessPlane:
    """The process's rolling freshness state; thread-safe."""

    def __init__(self, slo_ms: float = 0.0, window: int = BREACH_WINDOW):
        self.slo_ms = float(slo_ms)
        self.window = int(window)
        self._lock = threading.Lock()
        self._lags: deque = deque(maxlen=LAG_WINDOW)
        self._publish_lags: deque = deque(maxlen=LAG_WINDOW)
        self._spark: deque = deque(maxlen=SPARK_WINDOW)
        self._pending_publish: deque = deque(maxlen=PUBLISH_PENDING_MAX)
        self._edge_ticks: dict = {}
        self._batches = 0
        self._rows = 0
        self._last_lag = -1.0
        self._last_watermark = -1.0
        self._critical = ""
        self._breach_run = 0
        self._breaches = 0
        self._in_episode = False

    def record_delivery(self) -> "dict | None":
        """Pop the oldest in-flight lineage record and fold it in; returns
        the SLO verdict (None for a blank or absent record)."""
        rec = _lineage.pop_delivery()
        if rec is None:
            return None
        delivered = rec["delivered_ms"]
        event_hi = rec.get("event_max_ms", 0)
        lag = float(delivered - event_hi) if event_hi > 0 else -1.0
        floor = _lineage.open_event_floor() or rec.get("event_min_ms", 0)
        watermark = float(delivered - floor) if floor > 0 else lag
        critical = rec.get("critical", "")
        with self._lock:
            self._batches += 1
            self._rows += rec.get("rows", 0)
            self._critical = critical
            self._last_lag = lag
            if lag >= 0.0:
                self._lags.append(lag)
            self._last_watermark = watermark
            if watermark >= 0.0:
                self._spark.append(watermark)
            if critical:
                self._edge_ticks[critical] = self._edge_ticks.get(critical, 0) + 1
            if event_hi > 0:
                self._pending_publish.append(event_hi)
            breach = self.slo_ms > 0.0 and lag >= 0.0 and lag > self.slo_ms
            if breach:
                self._breach_run += 1
            else:
                self._breach_run = 0
                self._in_episode = False
            run = self._breach_run
            sustained = False
            if run >= self.window and not self._in_episode:
                self._in_episode = True
                self._breaches += 1
                sustained = True
            in_episode = self._in_episode
            lags_sorted = sorted(self._lags)
        self._publish_gauges(lag, watermark, critical, lags_sorted)
        if sustained:
            _metrics.get_registry().counter("freshness.slo_breaches").inc()
            _blackbox.record("freshness_slo_breach", lag_ms=round(lag, 1),
                             slo_ms=self.slo_ms, run=run, critical=critical)
            log.warning("freshness SLO breach sustained: event lag %.0f ms > %.0f ms "
                        "for %d batches (critical edge: %s)", lag, self.slo_ms, run,
                        critical or "?")
        return {"event_lag_ms": lag, "watermark_lag_ms": watermark,
                "critical": critical, "breach": breach, "breach_run": run,
                "sustained": sustained, "in_episode": in_episode}

    def record_publish(self) -> None:
        """Stamp the event-to-publish lag of every batch delivered since the
        last stats publish."""
        with self._lock:
            if not self._pending_publish:
                return
            ms = now_ms()
            while self._pending_publish:
                self._publish_lags.append(float(ms - self._pending_publish.popleft()))
            pub_sorted = sorted(self._publish_lags)
        _metrics.get_registry().gauge("freshness.publish_lag_p95_ms").set(
            round(_pct(pub_sorted, 0.95), 1))

    @staticmethod
    def _publish_gauges(lag, watermark, critical, lags_sorted) -> None:
        reg = _metrics.get_registry()
        if lag >= 0.0:
            reg.histogram("freshness.event_lag_ms", bounds=LAG_BOUNDS).observe(lag)
            for q, name in ((0.50, "p50"), (0.95, "p95"), (0.99, "p99")):
                reg.gauge(f"freshness.event_lag_{name}_ms").set(
                    round(_pct(lags_sorted, q), 1))
        if watermark >= 0.0:
            reg.gauge("freshness.watermark_lag_ms").set(round(watermark, 1))
        if critical:
            reg.counter(f"freshness.critical.{critical}.ticks").inc()

    def last_event_lag_ms(self) -> float:
        with self._lock:
            return self._last_lag if self._last_lag >= 0.0 else 0.0

    def view(self) -> "dict | None":
        """The dashboard view (None before the first delivery)."""
        with self._lock:
            if self._batches == 0:
                return None
            lags = sorted(self._lags)
            pubs = sorted(self._publish_lags)
            return {
                "batches": self._batches,
                "rows": self._rows,
                "eventLagMs": round(self._last_lag, 1),
                "eventLagP50Ms": round(_pct(lags, 0.50), 1),
                "eventLagP95Ms": round(_pct(lags, 0.95), 1),
                "eventLagP99Ms": round(_pct(lags, 0.99), 1),
                "publishLagP95Ms": round(_pct(pubs, 0.95), 1),
                "watermarkLagMs": round(self._last_watermark, 1),
                "watermark": [round(v, 1) for v in self._spark],
                "critical": self._critical,
                "criticalTicks": dict(self._edge_ticks),
                "sloMs": self.slo_ms,
                "breachRun": self._breach_run,
                "breaches": self._breaches,
            }

    def checkpoint_snapshot(self) -> "dict | None":
        """The freshness stamp of a verified checkpoint's meta."""
        with self._lock:
            if self._batches == 0:
                return None
            return {
                "event_lag_p95_ms": round(_pct(sorted(self._lags), 0.95), 1),
                "watermark_lag_ms": round(self._last_watermark, 1),
                "critical": self._critical,
                "batches": self._batches,
                "breaches": self._breaches,
            }


_lock = threading.Lock()
_PLANE: "FreshnessPlane | None" = None
_ON = False


def configure(conf=None, *, on=None, slo_ms=None, window=None) -> None:
    """Install the plane from a config (``--freshness``,
    ``--freshnessSloMs``) or explicit knobs; off also turns the lineage
    FIFOs off."""
    global _PLANE, _ON
    if conf is not None:
        on = getattr(conf, "freshness", "on") == "on" if on is None else on
        slo_ms = float(getattr(conf, "freshnessSloMs", 0.0)) if slo_ms is None else slo_ms
    enabled = bool(on) if on is not None else True
    with _lock:
        _ON = enabled
        _PLANE = (FreshnessPlane(slo_ms=slo_ms or 0.0, window=window or BREACH_WINDOW)
                  if enabled else None)
    _lineage.configure(enabled)


def enabled() -> bool:
    return _ON


def get_plane() -> "FreshnessPlane | None":
    with _lock:
        return _PLANE


def record_delivery() -> "dict | None":
    plane = get_plane()
    return plane.record_delivery() if plane is not None else None


def record_publish() -> None:
    plane = get_plane()
    if plane is not None:
        plane.record_publish()


def last_event_lag_ms() -> float:
    plane = get_plane()
    return plane.last_event_lag_ms() if plane is not None else 0.0


def last_freshness() -> "dict | None":
    """The latest freshness view; None when off or before a delivery."""
    plane = get_plane()
    return plane.view() if plane is not None else None


def snapshot_for_checkpoint() -> "dict | None":
    plane = get_plane()
    return plane.checkpoint_snapshot() if plane is not None else None


def reset_for_tests() -> None:
    global _PLANE, _ON
    with _lock:
        _PLANE = None
        _ON = False
    _lineage.reset_for_tests()
