"""Minimal JSON/HTTP client of the twtml web API (counterpart of
``twtml_tpu/telemetry/web_client.py``): POST Config/Stats/Series/Metrics to
``{server}/api`` with stdlib urllib. Callers wrap every call best-effort, as
the reference wraps them in ``Try`` (telemetry/session_stats.py)."""

from __future__ import annotations

import urllib.request

from .api_types import Config, Metrics, Series, Stats, encode

DEFAULT_SERVER = "http://localhost:8888"


class WebClient:
    def __init__(self, server: str = "", timeout: float = 2.0):
        self.server = server or DEFAULT_SERVER
        self.timeout = timeout

    def _post(self, obj) -> None:
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
