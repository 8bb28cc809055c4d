"""Model-health watcher, the host half (counterpart of
``twtml_tpu/telemetry/modelwatch.py``), verdict for verdict.

Consumes the in-step quality vector (ops/quality.py) the pipeline already
fetched with the batch's stats: host numpy over rolling windows, no added
copy from the card.

- **drift**: for each monitored moment (prediction, label and residual
  means, the 4 numeric-feature means, the hash-bucket skew), the z-shift of
  a RECENT window's mean against a lagged REFERENCE window; the reference
  freezes while the level is not ok, so a sustained shift stays an alert.
  The model's drift score is the max over fields; none before ``min_ref``
  reference ticks.
- **loss trend**: fast/slow EWMAs of the batch mse; the trend is the fast
  one's relative elevation over the slow one.
- **levels**: ok -> warn -> alert on fixed thresholds; a non-finite quality
  entry is an alert at once. Levels are telemetry; the sentinel owns
  rollback.

``record_tick`` is the delivery adapter's hook (apps/common.py
``ModelWatchGuard``), ``last_model`` the dashboard view, and
``snapshot_for_checkpoint`` the stamp every verified checkpoint carries.
One track a model, so the tenant plane (``--tenants M``) keeps one a
tenant from its [M, Q] quality leaf, and the checkpoint stamp carries each
tenant's.
"""

from __future__ import annotations

import math
import threading
from collections import deque

import numpy as np

from ..ops.quality import QUALITY_INDEX, QUALITY_WIDTH
from ..utils import get_logger
from . import blackbox as _blackbox
from . import metrics as _metrics

log = get_logger("telemetry.modelwatch")

LEVELS = ("ok", "warn", "alert")
LEVEL_RANK = {name: i for i, name in enumerate(LEVELS)}

REF_WINDOW = 96
RECENT_WINDOW = 16
MIN_REF = 24

# drift thresholds: z of the recent mean against the reference
WARN_Z = 4.0
ALERT_Z = 8.0

# loss trend = fast/slow EWMA - 1
TREND_FAST_ALPHA = 0.2
TREND_SLOW_ALPHA = 0.02
TREND_WARN = 0.25
TREND_ALERT = 1.0

DRIFT_FIELDS = (
    "pred_mean", "label_mean", "resid_mean",
    "num_mean_0", "num_mean_1", "num_mean_2", "num_mean_3",
    "bucket_top_share",
)

# the loss sparkline shipped to the dashboard (ModelHealth.mse)
SPARK_WINDOW = 64


class _Track:
    """Rolling drift and trend state of one model; deterministic given the
    tick stream."""

    def __init__(self, watch: "ModelWatch"):
        self._w = watch
        self.ref = {f: deque(maxlen=watch.ref_window) for f in DRIFT_FIELDS}
        self.recent = {f: deque(maxlen=watch.recent_window) for f in DRIFT_FIELDS}
        self.ewma_fast: "float | None" = None
        self.ewma_slow: "float | None" = None
        self.level = "ok"
        self.drift = 0.0
        self.trend = 0.0
        self.drift_field = ""
        self.alert_run = 0
        self.ticks = 0

    def observe(self, q: np.ndarray, mse: float) -> None:
        w = self._w
        self.ticks += 1
        finite = bool(np.isfinite(q).all()) and math.isfinite(mse)
        if finite:
            # a value leaving the recent window graduates into the
            # reference, only while the level is ok
            frozen = self.level != "ok"
            for f in DRIFT_FIELDS:
                rec = self.recent[f]
                if len(rec) == rec.maxlen and not frozen:
                    self.ref[f].append(rec[0])
                rec.append(float(q[QUALITY_INDEX[f]]))
            if self.ewma_fast is None:
                self.ewma_fast = self.ewma_slow = mse
            else:
                self.ewma_fast += w.trend_fast * (mse - self.ewma_fast)
                self.ewma_slow += w.trend_slow * (mse - self.ewma_slow)
            self.trend = (self.ewma_fast / max(self.ewma_slow, 1e-12) - 1.0
                          if self.ewma_slow and self.ewma_slow > 0 else 0.0)
            self.drift, self.drift_field = self._drift_score()
        level = self._level(finite)
        self.alert_run = self.alert_run + 1 if level == "alert" else 0
        self.level = level

    def _drift_score(self) -> "tuple[float, str]":
        w = self._w
        best, best_field = 0.0, ""
        for f in DRIFT_FIELDS:
            ref, recent = self.ref[f], self.recent[f]
            if len(ref) < w.min_ref or len(recent) < recent.maxlen:
                continue
            rv = np.asarray(ref, np.float64)
            ref_mean = float(rv.mean())
            # floor the scale: a near-constant reference must not turn float
            # noise into an infinite z
            scale = max(float(rv.std()), 1e-3 * abs(ref_mean), 1e-9)
            z = abs(float(np.asarray(recent, np.float64).mean()) - ref_mean) / scale
            if z > best:
                best, best_field = z, f
        return best, best_field

    def _level(self, finite: bool) -> str:
        w = self._w
        if not finite:
            return "alert"
        if self.drift >= w.alert_z or self.trend >= w.trend_alert:
            return "alert"
        if self.drift >= w.warn_z or self.trend >= w.trend_warn:
            return "warn"
        return "ok"


class ModelWatch:
    """The process's watcher: tracks, gauges, flight-recorder events and
    the dashboard and checkpoint views. Thresholds are injectable."""

    def __init__(self, ref_window: int = REF_WINDOW, recent_window: int = RECENT_WINDOW,
                 min_ref: int = MIN_REF, warn_z: float = WARN_Z, alert_z: float = ALERT_Z,
                 trend_fast: float = TREND_FAST_ALPHA, trend_slow: float = TREND_SLOW_ALPHA,
                 trend_warn: float = TREND_WARN, trend_alert: float = TREND_ALERT):
        self.ref_window = ref_window
        self.recent_window = recent_window
        self.min_ref = min_ref
        self.warn_z = warn_z
        self.alert_z = alert_z
        self.trend_fast = trend_fast
        self.trend_slow = trend_slow
        self.trend_warn = trend_warn
        self.trend_alert = trend_alert
        self._tracks: "list[_Track]" = []
        self._mse_hist: deque = deque(maxlen=SPARK_WINDOW)
        self._level = "ok"
        self._episodes = 0
        self._flips = 0
        self._ticks = 0
        self._last_norms = (0.0, 0.0, 0.0)
        self._lock = threading.Lock()

    def observe(self, quality, count, mse) -> dict:
        """One delivered tick: ``quality`` [Q] (or [M, Q]), ``count`` and
        ``mse`` scalars (or [M]). Returns the verdict the adapter acts on."""
        q = np.asarray(quality, np.float64)
        if q.ndim == 1:
            q = q[None, :]
        counts = np.atleast_1d(np.asarray(count, np.float64))
        mses = np.atleast_1d(np.asarray(mse, np.float64))
        if q.shape[1] != QUALITY_WIDTH:
            raise ValueError(f"quality vector width {q.shape[1]} != {QUALITY_WIDTH}")
        m = q.shape[0]
        with self._lock:
            while len(self._tracks) < m:
                self._tracks.append(_Track(self))
            prev_level = self._level
            for i in range(m):
                if counts[i] > 0:
                    self._tracks[i].observe(q[i], float(mses[i]))
            self._ticks += 1
            total = float(counts.sum())
            agg_mse = float((counts * mses).sum() / total) if total > 0 else 0.0
            if total > 0 and math.isfinite(agg_mse):
                self._mse_hist.append(agg_mse)
            tracks = self._tracks[:m]
            self._level = max(tracks, key=lambda t: LEVEL_RANK[t.level]).level
            active = counts > 0
            wn = un = gn = 0.0
            if active.any():
                aw = counts[active] / counts[active].sum()
                qa = q[active]
                wn = float((aw * qa[:, QUALITY_INDEX["weight_norm"]]).sum())
                un = float((aw * qa[:, QUALITY_INDEX["update_norm"]]).sum())
                gn = float((aw * qa[:, QUALITY_INDEX["grad_norm"]]).sum())
            self._last_norms = (wn, un, gn)
            drift = max((t.drift for t in tracks), default=0.0)
            trend = max((t.trend for t in tracks), default=0.0)
            alert_run = max((t.alert_run for t in tracks), default=0)
            level = self._level
            flipped = level != prev_level
            episode = flipped and prev_level == "ok"
            if flipped:
                self._flips += 1
            if episode:
                self._episodes += 1
        self._publish(level, drift, trend, wn, un, gn)
        if flipped:
            _blackbox.record("model_health", level=level, prev=prev_level,
                             drift=round(drift, 3), trend=round(trend, 4))
            (log.warning if level != "ok" else log.info)(
                "model health %s -> %s (drift z=%.2f, loss trend %+.1f%%)",
                prev_level, level, drift, trend * 100.0)
        if episode:
            _metrics.get_registry().counter("model.drift_episodes").inc()
            _blackbox.record("drift_episode", drift=round(drift, 3),
                             field=max(tracks, key=lambda t: t.drift).drift_field)
        return {"level": level, "drift_score": drift, "loss_trend": trend,
                "alert_run": alert_run, "flipped": flipped}

    @staticmethod
    def _publish(level, drift, trend, wn, un, gn) -> None:
        reg = _metrics.get_registry()
        reg.gauge("model.weight_norm").set(round(wn, 4))
        reg.gauge("model.update_norm").set(round(un, 4))
        reg.gauge("model.grad_norm").set(round(gn, 4))
        reg.gauge("model.drift_score").set(round(drift, 4))
        reg.gauge("model.loss_trend").set(round(trend, 4))
        reg.gauge("model.health_level").set(LEVEL_RANK[level])

    def view(self) -> "dict | None":
        """The dashboard view (None before the first tick)."""
        with self._lock:
            if self._ticks == 0:
                return None
            wn, un, gn = self._last_norms
            return {
                "level": self._level,
                "drift_score": round(max((t.drift for t in self._tracks), default=0.0), 3),
                "loss_trend": round(max((t.trend for t in self._tracks), default=0.0), 4),
                "weight_norm": round(wn, 3),
                "update_norm": round(un, 4),
                "grad_norm": round(gn, 3),
                "mse": [round(v, 3) for v in self._mse_hist],
                "tenants": [
                    {"tenant": i, "level": t.level, "drift": round(t.drift, 3),
                     "trend": round(t.trend, 4)}
                    for i, t in enumerate(self._tracks)
                ] if len(self._tracks) > 1 else [],
                "episodes": self._episodes,
                "ticks": self._ticks,
            }

    def checkpoint_snapshot(self) -> "dict | None":
        """The quality stamp of a verified checkpoint's meta (None before
        the first tick). With more than one track (the tenant plane) it
        carries a ``tenants`` stamp a tenant (level, drift, trend and the
        fast loss EWMA), which champion/challenger serving ranks
        (serving/abtest.py)."""
        with self._lock:
            if self._ticks == 0:
                return None
            wn, un, gn = self._last_norms
            stamp = {
                "level": self._level,
                "drift_score": round(max((t.drift for t in self._tracks), default=0.0), 4),
                "loss_trend": round(max((t.trend for t in self._tracks), default=0.0), 4),
                "weight_norm": round(wn, 4),
                "update_norm": round(un, 4),
                "grad_norm": round(gn, 4),
                "mse": round(self._mse_hist[-1], 4) if self._mse_hist else -1.0,
                "ticks": self._ticks,
                "episodes": self._episodes,
            }
            if len(self._tracks) > 1:
                stamp["tenants"] = [
                    {"tenant": i, "level": t.level, "drift_score": round(t.drift, 4),
                     "loss_trend": round(t.trend, 4),
                     "loss": round(t.ewma_fast, 4) if t.ewma_fast is not None else -1.0}
                    for i, t in enumerate(self._tracks)
                ]
            return stamp


_lock = threading.Lock()
_WATCH: "ModelWatch | None" = None


def get_watch() -> ModelWatch:
    global _WATCH
    with _lock:
        if _WATCH is None:
            _WATCH = ModelWatch()
        return _WATCH


def record_tick(quality, count, mse) -> dict:
    """The delivery adapter's hook."""
    return get_watch().observe(quality, count, mse)


def last_model() -> "dict | None":
    """The latest model-health view; None before any tick."""
    with _lock:
        watch = _WATCH
    return watch.view() if watch is not None else None


def snapshot_for_checkpoint() -> "dict | None":
    with _lock:
        watch = _WATCH
    return watch.checkpoint_snapshot() if watch is not None else None


def reset_for_tests() -> None:
    global _WATCH
    with _lock:
        _WATCH = None
