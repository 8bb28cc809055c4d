"""Minimal JSON/HTTP client of the twtml web API (counterpart of
``twtml_tpu/telemetry/web_client.py``): POST Config/Stats/Series/Metrics/
Hosts/Tenants/ModelHealth/Freshness/History/Serving/Fleet to ``{server}/api`` with stdlib
urllib. Callers wrap every call best-effort, as the reference wraps them in
``Try`` (telemetry/session_stats.py). Each request is a ``--chaos`` ``web``
injection point."""

from __future__ import annotations

import sys
import urllib.request

from .api_types import (
    Config, Fleet, Freshness, History, Hosts, Metrics, ModelHealth, Series, Serving, Stats,
    Tenants, encode,
)

DEFAULT_SERVER = "http://localhost:8888"

_FAULTS = __name__.rsplit(".", 2)[0] + ".streaming.faults"


class WebClient:
    def __init__(self, server: str = "", timeout: float = 2.0):
        self.server = server or DEFAULT_SERVER
        self.timeout = timeout

    def _post(self, obj) -> None:
        # the --chaos "web" point; a process that never loaded the injector
        # (the fleet router) has none installed, and does not load it here
        # (it would pull in the model layer)
        faults = sys.modules.get(_FAULTS)
        if faults is not None:
            faults.perturb("web")
        req = urllib.request.Request(
            self.server + "/api",
            data=encode(obj).encode("utf-8"),
            headers={"content-type": "application/json", "accept": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            resp.read()

    def config(self, id: str, host: str, viz: list[str]) -> None:
        self._post(Config(id=id, host=host, viz=list(viz)))

    def stats(
        self, count: int, batch: int, mse: int, real_stddev: int, pred_stddev: int
    ) -> None:
        self._post(Stats(
            count=int(count), batch=int(batch), mse=int(mse),
            realStddev=int(real_stddev), predStddev=int(pred_stddev),
        ))

    def series(self, real, pred, real_stddev: float, pred_stddev: float) -> None:
        """One batch's real/pred series for the built-in live chart."""
        self._post(Series(
            real=[float(v) for v in real], pred=[float(v) for v in pred],
            realStddev=float(real_stddev), predStddev=float(pred_stddev),
        ))

    def metrics(self, counters: dict, gauges: dict, health: dict,
                histograms: "dict | None" = None) -> None:
        """A pipeline-metrics snapshot for the observability panel."""
        self._post(Metrics(counters=dict(counters), gauges=dict(gauges),
                           health=dict(health), histograms=dict(histograms or {})))

    def hosts(self, hosts: list, straggler: int = -1, stage: str = "",
              skew_ms: float = 0.0, epoch: int = -1, live_hosts: int = 0,
              departed: int = 0, rejoined: int = 0, lead_uid: int = -1) -> None:
        """The lockstep sideband's per-host view (telemetry/sideband.py
        ``last_hosts``) and the elastic membership's summary: the epoch, the
        live hosts, hosts departed and rejoined so far, and the current
        lead's uid (streaming/membership.py's gauges; their defaults when
        the run is not elastic)."""
        self._post(Hosts(hosts=list(hosts), straggler=int(straggler), stage=str(stage),
                         skewMs=float(skew_ms), epoch=int(epoch), liveHosts=int(live_hosts),
                         departed=int(departed), rejoined=int(rejoined),
                         leadUid=int(lead_uid)))

    def tenants(self, tenants: list, gating: int = -1, active: int = 0) -> None:
        """The tenant plane's view (telemetry/tenants.py ``last_tenants``)."""
        self._post(Tenants(tenants=list(tenants), gating=int(gating), active=int(active)))

    def model_health(self, level: str = "ok", drift_score: float = 0.0,
                     loss_trend: float = 0.0, weight_norm: float = 0.0,
                     update_norm: float = 0.0, grad_norm: float = 0.0,
                     mse=None, tenants=None, episodes: int = 0) -> None:
        """The model-health view (telemetry/modelwatch.py)."""
        self._post(ModelHealth(
            level=str(level), driftScore=float(drift_score),
            lossTrend=float(loss_trend), weightNorm=float(weight_norm),
            updateNorm=float(update_norm), gradNorm=float(grad_norm),
            mse=[float(v) for v in (mse or [])],
            tenants=list(tenants or []), episodes=int(episodes),
        ))

    def freshness(self, view: dict) -> None:
        """The freshness view (telemetry/freshness.py ``last_freshness``)."""
        known = Freshness.__dataclass_fields__
        self._post(Freshness(**{k: v for k, v in view.items() if k in known}))

    def history(self, view: dict) -> None:
        """The historian's view (telemetry/historian.py ``last_history``)."""
        known = History.__dataclass_fields__
        self._post(History(**{k: v for k, v in view.items() if k in known}))

    def serving(self, view: dict) -> None:
        """The serving plane's view (``ServingPlane.stats()``)."""
        known = Serving.__dataclass_fields__
        self._post(Serving(**{k: v for k, v in view.items() if k in known}))

    def fleet(self, view: dict) -> None:
        """The read fleet's view (``FleetRouter.stats()``)."""
        known = Fleet.__dataclass_fields__
        self._post(Fleet(**{k: v for k, v in view.items() if k in known}))
