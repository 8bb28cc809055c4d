"""Publish circuit breaker: keeps a dead dashboard off the hot path
(counterpart of ``twtml_tpu/telemetry/breaker.py``).

Every publish is best-effort (the reference wraps them in ``Try``), but each
failed attempt still blocks the batch handler for up to ``--webTimeout``.
The breaker decides whether the attempt is made at all:

- CLOSED: publishes flow; ``failure_threshold`` consecutive failures open it.
- OPEN: publishes are dropped and counted for ``cooldown_s``.
- HALF-OPEN: after the cooldown exactly one probe is admitted; success
  closes the breaker, failure opens it for another cooldown.

Transitions are logged and stamped into the metrics registry
(``publish.<name>.breaker_open`` gauge, ``.failures``/``.dropped``
counters). ``now`` is injectable for deterministic tests.
"""

from __future__ import annotations

import threading
import time

from ..utils import get_logger
from . import metrics as _metrics

log = get_logger("telemetry.breaker")

FAILURE_THRESHOLD = 5  # consecutive failures that open the breaker
COOLDOWN_S = 30.0  # open duration before the half-open probe


class CircuitBreaker:
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half-open"

    def __init__(
        self,
        name: str,
        failure_threshold: int = FAILURE_THRESHOLD,
        cooldown_s: float = COOLDOWN_S,
        registry: "object | None" = None,
        now=time.monotonic,
    ):
        self.name = name
        self.failure_threshold = max(1, failure_threshold)
        self.cooldown_s = cooldown_s
        self._now = now
        self._lock = threading.Lock()
        self.state = self.CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        reg = registry if registry is not None else _metrics.get_registry()
        self._open_gauge = reg.gauge(f"publish.{name}.breaker_open")
        self._dropped = reg.counter(f"publish.{name}.dropped")
        self._failures = reg.counter(f"publish.{name}.failures")

    def allow(self) -> bool:
        """Whether the caller should attempt its publish now. While OPEN,
        returns False and counts a drop, until the cooldown elapses and
        exactly one probe is admitted (HALF-OPEN)."""
        with self._lock:
            if self.state == self.CLOSED:
                return True
            if self.state == self.OPEN and (
                self._now() - self._opened_at >= self.cooldown_s
            ):
                self.state = self.HALF_OPEN
                self._transition("probing the endpoint after cooldown")
                return True
            self._dropped.inc()
            return False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            if self.state != self.CLOSED:
                self.state = self.CLOSED
                self._open_gauge.set(0)
                self._transition("endpoint recovered; publishes re-admitted")

    def record_failure(self) -> None:
        with self._lock:
            self._failures.inc()
            self._consecutive += 1
            if self.state == self.HALF_OPEN or (
                self.state == self.CLOSED
                and self._consecutive >= self.failure_threshold
            ):
                reopened = self.state == self.HALF_OPEN
                self.state = self.OPEN
                self._opened_at = self._now()
                self._open_gauge.set(1)
                self._transition(
                    "probe failed; re-opened for %gs" % self.cooldown_s
                    if reopened
                    else "opened after %d consecutive failures; publishes "
                    "dropped for %gs then probed"
                    % (self._consecutive, self.cooldown_s)
                )

    def _transition(self, why: str) -> None:
        log.warning("publish breaker %r %s: %s", self.name, self.state, why)
