"""Library client of the serving front door, ``POST /api/predict``
(counterpart of ``twtml_tpu/serving/client.py``).

Standard-library urllib, like ``telemetry/web_client.py``, but a predict
call RAISES on failure instead of the telemetry client's best-effort
semantics: a load generator or an ops script must see a refused or aborted
predict. A 503 or a refused connection is retried on a jittered backoff.
"""

from __future__ import annotations

import json
import random
import time
import urllib.error
import urllib.request

DEFAULT_SERVER = "http://localhost:8888"

# the retry ladder: exponential, jittered, capped (the sources' reconnect
# shape), so N clients retrying one briefly-503ing front door do not
# reconnect in phase. Small on purpose: a client behind a router rides its
# replica failover, so a retry here covers only a whole-fleet (or a lone
# server's) outage
RETRY_BACKOFF_BASE_S = 0.1
RETRY_BACKOFF_CAP_S = 2.0
# statuses worth a retry: 503 (no plane yet, a fleet draining), 502, and 0
# (connection refused or reset: the URLError face of a dead server)
RETRYABLE_STATUSES = (0, 502, 503)


class ServingError(RuntimeError):
    """A predict request failed (a watchdog abort, bad rows, serving not
    attached); ``status`` is the HTTP code when there was one, else 0."""

    def __init__(self, message: str, status: int = 0):
        super().__init__(message)
        self.status = status


class ServingClient:
    def __init__(self, server: str = "", timeout: float = 10.0, retries: int = 2):
        self.server = server or DEFAULT_SERVER
        self.timeout = timeout
        self.retries = max(0, int(retries))

    @staticmethod
    def _backoff(attempt: int) -> float:
        """Sleep before retry ``attempt`` (1-based): exponential, jittered
        into [0.5x, 1x], capped."""
        base = min(RETRY_BACKOFF_BASE_S * (2 ** min(attempt - 1, 12)), RETRY_BACKOFF_CAP_S)
        return base * (0.5 + 0.5 * random.random())

    def predict(self, rows) -> dict:
        """POST rows (each a dict with ``text`` and optional author numbers,
        or a bare string) to ``/api/predict``; returns ``{"predictions":
        [...], "snapshotStep": N, "servedRows": n, "modelStalenessS": s}``.
        A 503 or a refused connection retries up to ``retries`` times
        (counted in ``serve.client_retries``); anything else raises at once."""
        body = json.dumps({"rows": list(rows)}).encode("utf-8")
        attempt = 0
        while True:
            try:
                return self._predict_once(body)
            except ServingError as exc:
                attempt += 1
                if exc.status not in RETRYABLE_STATUSES or attempt > self.retries:
                    raise
                from ..telemetry import metrics as _metrics

                _metrics.get_registry().counter("serve.client_retries").inc()
                time.sleep(self._backoff(attempt))

    def _predict_once(self, body: bytes) -> dict:
        req = urllib.request.Request(
            self.server + "/api/predict", data=body,
            headers={"content-type": "application/json", "accept": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as exc:
            try:
                detail = json.loads(exc.read().decode("utf-8")).get("error", "")
            except (ValueError, AttributeError, OSError):
                detail = ""  # the error body is optional detail only
            raise ServingError(detail or f"predict failed: HTTP {exc.code}",
                               status=exc.code) from exc
        except urllib.error.URLError as exc:
            raise ServingError(f"predict failed: {exc.reason}") from exc

    def _get(self, route: str) -> dict:
        req = urllib.request.Request(self.server + route,
                                     headers={"accept": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def serving(self) -> dict:
        """The latest ``Serving`` view (``GET /api/serving``)."""
        return self._get("/api/serving")

    def fleet(self) -> dict:
        """The ``Fleet`` view (``GET /api/fleet``: live on a router, the
        cached view elsewhere)."""
        return self._get("/api/fleet")
