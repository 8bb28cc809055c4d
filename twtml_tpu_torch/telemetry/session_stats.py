"""Per-session stats publishing (counterpart of
``twtml_tpu/telemetry/session_stats.py``; reference: SessionStats.scala).

Opens a 4-series Lightning streaming line chart (real = blue, pred =
yellow, with lighter "detail" shades), registers the session with the twtml
web dashboard (``web.config``), and pushes each batch's stats to both. Every
network call is best-effort, as the reference's ``Try``: the learning loop
survives any telemetry outage.

As in the JAX package: each endpoint sits behind a circuit breaker
(telemetry/breaker.py), so a dead dashboard stops costing every batch its
``--webTimeout``; the per-batch series frame is cut to ``SERIES_MAX_POINTS``
points, and while the health monitor reports a DEGRADED transport only
every ``SERIES_SHED_EVERY``-th series frame ships (the scalar stats keep
full resolution); a metrics snapshot ships every ``METRICS_EVERY`` updates,
with the host-process gauges (``host.rss_mb``, ``host.uptime_s``,
``host.rss_slope_mb_per_min``), followed by the tenant plane's, the
model-health and the freshness views once they hold a delivery, and the
historian's view. Each metrics
publish samples the telemetry historian (``historian.sample``, host views
only, before the breaker gate: the historian writes to local disk, so a
dead dashboard does not stop it). Each update is the ``stats_publish``
stage (the stage clock, and a span under ``--trace``) and stamps the
freshness plane's event-to-publish lag. A lockstep run's lead also ships
the per-host view (telemetry/sideband.py ``last_hosts``) with each metrics
snapshot, as the JAX package's publisher does.
"""

from __future__ import annotations

import collections
import time

import numpy as np

from ..utils import get_logger
from ..utils.rss import rss_mb, slope_mb_per_min
from . import freshness as _freshness
from . import historian as _historian
from . import metrics as _metrics
from . import modelwatch as _modelwatch
from . import sideband as _sideband
from . import tenants as _tenants
from . import trace as _trace
from .breaker import CircuitBreaker
from .lightning import CHART_MAX_POINTS, Lightning, Visualization
from .web_client import WebClient

log = get_logger("telemetry.session")

# per-batch cap on chart series points shipped to the dashboard
SERIES_MAX_POINTS = CHART_MAX_POINTS

# publish a pipeline-metrics snapshot every N stats updates
METRICS_EVERY = 8

# degraded-transport load shedding: ship only every Nth batch's series frame
SERIES_SHED_EVERY = 8

# SessionStats.scala:15-20
REAL_COLOR_DET = [173.0, 216.0, 230.0]  # light blue
REAL_COLOR = [30.0, 144.0, 255.0]  # blue
PRED_COLOR_DET = [238.0, 232.0, 170.0]  # pale yellow
PRED_COLOR = [255.0, 215.0, 0.0]  # gold

# the process's start, for the host.uptime_s gauge (this module is imported
# at the app's start)
_PROCESS_START_S = time.monotonic()


class SessionStats:
    def __init__(self, conf):
        self.conf = conf
        self.lgn = Lightning(host=conf.lightning)
        self.web = WebClient(conf.twtweb, timeout=float(conf.webTimeout))
        self.viz: Visualization | None = None
        self._updates = 0
        # one breaker per endpoint: the dashboard and Lightning fail apart
        self._web_breaker = CircuitBreaker("web")
        self._lgn_breaker = CircuitBreaker("lightning")
        # (monotonic s, rss MB) a metrics publish, for the leak-rate gauge
        self._rss_samples: collections.deque = collections.deque(maxlen=256)

    def open(self) -> "SessionStats":
        log.info("Initializing plot on lightning server: %s", self.conf.lightning)
        try:
            self.viz = self.lgn.line_streaming(
                series=[[0.0]] * 4,
                size=[1.0, 1.0, 2.0, 2.0],
                color=[REAL_COLOR_DET, PRED_COLOR_DET, REAL_COLOR, PRED_COLOR],
            )
            log.info(
                "lightning session: %s/sessions/%s — %s/visualizations/%s/pym",
                self.conf.lightning, self.viz.session,
                self.conf.lightning, self.viz.id,
            )
        except Exception as exc:  # lawcheck: disable=TW005 -- Try-parity: a dead Lightning server disables the charts, never the run (logged)
            log.warning("lightning unavailable (%s); charts disabled", exc)

        log.info("Initializing config on web server: %s", self.conf.twtweb)
        try:
            self.web.config(
                self.viz.session if self.viz else "",
                self.lgn.host,
                [self.viz.id] if self.viz else [],
            )
        except Exception as exc:  # lawcheck: disable=TW005 -- Try-parity: a dead dashboard disables publishing, never the run (logged)
            log.warning("twtml-web unavailable (%s); dashboard disabled", exc)
        return self

    def update(
        self,
        count: int,
        batch: int,
        mse: float,
        real_stdev: float,
        pred_stdev: float,
        real: np.ndarray,
        pred: np.ndarray,
    ) -> None:
        """Push one batch of stats, as SessionStats.update: mse and stdevs
        arrive HALF_UP-rounded and are truncated to int for the dashboard
        like ``.toLong``. Timed as the ``stats_publish`` stage."""
        tr = _trace.get()
        t0 = time.perf_counter()
        if tr.enabled:
            with tr.span("stats_publish", batch=int(batch)):
                self._update(count, batch, mse, real_stdev, pred_stdev, real, pred)
        else:
            self._update(count, batch, mse, real_stdev, pred_stdev, real, pred)
        _sideband.record_stage("stats_publish", time.perf_counter() - t0)

    def _update(self, count, batch, mse, real_stdev, pred_stdev, real, pred) -> None:
        stats_ok = False
        if self._web_breaker.allow():
            try:
                self.web.stats(count, batch, int(mse), int(real_stdev), int(pred_stdev))
                self._web_breaker.record_success()
                stats_ok = True
            except Exception:  # lawcheck: disable=TW005 -- Try-parity: counted by the breaker, logged
                self._web_breaker.record_failure()
                log.debug("web.stats failed", exc_info=True)
        if stats_ok and self._series_due():
            try:
                self.web.series(
                    list(real[:SERIES_MAX_POINTS]), list(pred[:SERIES_MAX_POINTS]),
                    real_stdev, pred_stdev,
                )
                self._web_breaker.record_success()
            except Exception:  # lawcheck: disable=TW005 -- Try-parity: counted by the breaker, logged
                self._web_breaker.record_failure()
                log.debug("web.series failed", exc_info=True)
        if self.viz is not None and self._lgn_breaker.allow():
            try:
                self.lgn.line_streaming(
                    series=[list(real), list(pred), [real_stdev] * int(batch),
                            [pred_stdev] * int(batch)],
                    viz=self.viz,
                )
                self._lgn_breaker.record_success()
            except Exception:  # lawcheck: disable=TW005 -- Try-parity: counted by the breaker, logged
                self._lgn_breaker.record_failure()
                log.debug("lightning append failed", exc_info=True)
        # the event-to-publish lag of the batches delivered since the last
        # update: host clock reads, inside the timed publish
        _freshness.record_publish()
        self._updates += 1
        if self._updates % METRICS_EVERY == 0:
            self.publish_metrics()

    def _series_due(self) -> bool:
        """Whether this batch's series frame ships: always on a healthy
        transport, every ``SERIES_SHED_EVERY``-th while DEGRADED (a shed
        frame counts in ``publish.series_shed``)."""
        monitor = _metrics.get_health_monitor()
        if monitor.phase != monitor.DEGRADED:
            return True
        if self._updates % SERIES_SHED_EVERY == 0:
            return True
        _metrics.get_registry().counter("publish.series_shed").inc()
        return False

    def publish_metrics(self) -> None:
        """Best-effort push of the metrics registry and the health summary,
        with per-histogram count/mean/p50/p95/p99 (not the raw buckets),
        then the hosts, tenant, model-health, freshness and historian views. The host
        gauges are sampled first (statm reads), then the historian."""
        reg = _metrics.get_registry()
        cur_mb = rss_mb()
        now = time.monotonic()
        reg.gauge("host.rss_mb").set(round(cur_mb, 1))
        reg.gauge("host.uptime_s").set(round(now - _PROCESS_START_S, 1))
        self._rss_samples.append((now, cur_mb))
        reg.gauge("host.rss_slope_mb_per_min").set(
            round(slope_mb_per_min(self._rss_samples), 3))
        # the historian's one sampling seam; a no-op with --history off
        _historian.sample()
        if not self._web_breaker.allow():
            return
        try:
            snap = _metrics.get_registry().snapshot()
            hists = {
                name: {k: h[k] for k in ("count", "mean", "p50", "p95", "p99")}
                for name, h in snap["histograms"].items()
            }
            self.web.metrics(
                snap["counters"], snap["gauges"],
                _metrics.get_health_monitor().summary(), histograms=hists,
            )
            self._web_breaker.record_success()
        except Exception:  # lawcheck: disable=TW005 -- Try-parity: counted by the breaker, logged
            self._web_breaker.record_failure()
            log.debug("web.metrics failed", exc_info=True)
        view = _sideband.last_hosts()
        if view is not None and self._web_breaker.allow():
            try:
                self.web.hosts(view["hosts"], view["straggler"], view["stage"],
                               view["skew_ms"])
                self._web_breaker.record_success()
            except Exception:  # lawcheck: disable=TW005 -- Try-parity: counted by the breaker, logged
                self._web_breaker.record_failure()
                log.debug("web.hosts failed", exc_info=True)
        tview = _tenants.last_tenants()
        if tview is not None and self._web_breaker.allow():
            try:
                self.web.tenants(tview["tenants"], tview["gating"], tview["active"])
                self._web_breaker.record_success()
            except Exception:  # lawcheck: disable=TW005 -- Try-parity: counted by the breaker, logged
                self._web_breaker.record_failure()
                log.debug("web.tenants failed", exc_info=True)
        mview = _modelwatch.last_model()
        if mview is not None and self._web_breaker.allow():
            try:
                self.web.model_health(
                    level=mview["level"], drift_score=mview["drift_score"],
                    loss_trend=mview["loss_trend"], weight_norm=mview["weight_norm"],
                    update_norm=mview["update_norm"], grad_norm=mview["grad_norm"],
                    mse=mview["mse"], tenants=mview["tenants"],
                    episodes=mview["episodes"],
                )
                self._web_breaker.record_success()
            except Exception:  # lawcheck: disable=TW005 -- Try-parity: counted by the breaker, logged
                self._web_breaker.record_failure()
                log.debug("web.model_health failed", exc_info=True)
        fview = _freshness.last_freshness()
        if fview is not None and self._web_breaker.allow():
            try:
                self.web.freshness(fview)
                self._web_breaker.record_success()
            except Exception:  # lawcheck: disable=TW005 -- Try-parity: counted by the breaker, logged
                self._web_breaker.record_failure()
                log.debug("web.freshness failed", exc_info=True)
        hview = _historian.last_history()
        if hview is not None and self._web_breaker.allow():
            try:
                self.web.history(hview)
                self._web_breaker.record_success()
            except Exception:  # lawcheck: disable=TW005 -- Try-parity: counted by the breaker, logged
                self._web_breaker.record_failure()
                log.debug("web.history failed", exc_info=True)
