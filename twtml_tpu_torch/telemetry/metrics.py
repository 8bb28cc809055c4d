"""Process-local metrics registry and transport-health classification
(counterpart of ``twtml_tpu/telemetry/metrics.py``).

Counters, gauges and histograms kept on the hot path (adds under a
per-metric lock: no device traffic, no threads), snapshot on demand and
published to the dashboard as a ``Metrics`` message (telemetry/api_types.py).
Nothing here touches the card: every value is host bookkeeping over timings
the pipeline already takes.

``TunnelHealthMonitor`` classifies the stream of fetch waits into healthy and
degraded phases, self-relative: degraded when the rolling median sits
``degrade_factor`` times above the best wait seen. On the card the fetch
wait is the host's wait on a batch's device-to-host copy event
(apps/common.py ``FetchPipeline``); the watchdog's deadline derives from its
median. A phase flip is stamped, as in the JAX package, into the registry,
the active trace (a ``health_phase`` instant) and the flight recorder's
ring (a ``health_phase`` record).
"""

from __future__ import annotations

import bisect
import statistics
import threading
import time
from collections import deque

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "TunnelHealthMonitor",
    "get_registry",
    "get_health_monitor",
    "reset_for_tests",
]


class Counter:
    """Monotonic add-only counter."""

    def __init__(self, name: str):
        self.name = name
        self.value: float = 0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1) -> None:
        with self._lock:
            self.value += amount

    def snapshot(self) -> float:
        return self.value


class Gauge:
    """Last-value gauge (``set`` wins; ``add`` for up/down tracking)."""

    def __init__(self, name: str):
        self.name = name
        self.value: float = 0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = value

    def add(self, amount: float) -> None:
        with self._lock:
            self.value += amount

    def snapshot(self) -> float:
        return self.value


# geometric latency buckets: 1 ms .. ~524 s, doubling
DEFAULT_BOUNDS = tuple(0.001 * (2.0 ** i) for i in range(20))


class Histogram:
    """Fixed-bound histogram with count/sum/min/max and a percentile
    estimate (the winning bucket's upper bound)."""

    def __init__(self, name: str, bounds: "tuple[float, ...]" = DEFAULT_BOUNDS):
        self.name = name
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)  # +1: overflow bucket
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += value
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)

    def percentile(self, p: float) -> float:
        """Approximate p-quantile (0..1) from the bucket counts."""
        with self._lock:
            return self._percentile_locked(p)

    def _percentile_locked(self, p: float) -> float:
        if self.count == 0:
            return 0.0
        target = p * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                if i >= len(self.bounds):
                    return float(self.max)
                return self.bounds[i]
        return float(self.max)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "count": self.count,
                "sum": self.sum,
                "min": self.min,
                "max": self.max,
                "mean": (self.sum / self.count) if self.count else 0.0,
                "p50": self._percentile_locked(0.50),
                "p95": self._percentile_locked(0.95),
                "p99": self._percentile_locked(0.99),
                "buckets": [
                    [b, c] for b, c in zip(self.bounds, self.counts) if c
                ] + ([["inf", self.counts[-1]]] if self.counts[-1] else []),
            }


class MetricsRegistry:
    """Named metric store with get-or-create accessors and an isolated
    ``snapshot()`` (plain dicts and floats)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            m = self._counters.get(name)
            if m is None:
                m = self._counters[name] = Counter(name)
            return m

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            m = self._gauges.get(name)
            if m is None:
                m = self._gauges[name] = Gauge(name)
            return m

    def histogram(
        self, name: str, bounds: "tuple[float, ...]" = DEFAULT_BOUNDS
    ) -> Histogram:
        with self._lock:
            m = self._histograms.get(name)
            if m is None:
                m = self._histograms[name] = Histogram(name, bounds)
            return m

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {k: m.snapshot() for k, m in counters.items()},
            "gauges": {k: m.snapshot() for k, m in gauges.items()},
            "histograms": {k: m.snapshot() for k, m in histograms.items()},
        }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


class TunnelHealthMonitor:
    """Healthy/degraded phases from a stream of latency observations
    (seconds), with hysteresis: with at least ``min_samples`` in the rolling
    window, DEGRADED when the window median exceeds ``degrade_factor`` x the
    best latency ever seen (and ``floor_s``), HEALTHY again under
    ``recover_factor`` x best (or ``floor_s``). A transition counts in the
    registry (``tunnel.phase_transitions``, ``tunnel.degraded``) and lands as
    a ``health_phase`` instant in the active trace and a ``health_phase``
    record in the flight recorder's ring (``_stamp``). ``now`` is injectable
    for deterministic tests."""

    HEALTHY = "healthy"
    DEGRADED = "degraded"

    def __init__(
        self,
        window: int = 16,
        min_samples: int = 5,
        degrade_factor: float = 2.5,
        recover_factor: float = 1.5,
        floor_s: float = 0.030,
        registry: "MetricsRegistry | None" = None,
    ):
        self._window: deque[float] = deque(maxlen=window)
        self.min_samples = min_samples
        self.degrade_factor = degrade_factor
        self.recover_factor = recover_factor
        self.floor_s = floor_s
        self.best: float | None = None
        self.phase = self.HEALTHY
        self.transitions: list[tuple[float, str]] = []
        self.observations = {self.HEALTHY: 0, self.DEGRADED: 0}
        self._registry = registry
        self._lock = threading.Lock()

    def observe(self, latency_s: float, now: "float | None" = None) -> str:
        """Feed one latency; returns the (possibly new) phase."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            self._window.append(latency_s)
            self.best = latency_s if self.best is None else min(self.best, latency_s)
            new_phase = self.phase
            if len(self._window) >= self.min_samples:
                med = statistics.median(self._window)
                base = max(self.best, 1e-9)
                if self.phase == self.HEALTHY:
                    if med > self.floor_s and med > self.degrade_factor * base:
                        new_phase = self.DEGRADED
                elif med <= self.floor_s or med <= self.recover_factor * base:
                    new_phase = self.HEALTHY
            flipped = new_phase != self.phase
            self.phase = new_phase
            self.observations[new_phase] += 1
            if flipped:
                self.transitions.append((now, new_phase))
        if flipped:
            self._stamp(new_phase, latency_s)
        return new_phase

    def _stamp(self, phase: str, latency_s: float) -> None:
        """A phase flip in the registry, the active trace and the flight
        recorder's ring (outside the lock: the trace writer takes its own),
        with the JAX package's names and fields."""
        from . import blackbox as _blackbox
        from . import trace as _trace

        reg = self._registry if self._registry is not None else get_registry()
        reg.counter("tunnel.phase_transitions").inc()
        reg.gauge("tunnel.degraded").set(1 if phase == self.DEGRADED else 0)
        latency_ms = round(latency_s * 1e3, 3)
        _trace.get().instant("health_phase", phase=phase, latency_ms=latency_ms)
        _blackbox.record("health_phase", phase=phase, latency_ms=latency_ms)

    def median_ms(self) -> float:
        with self._lock:
            if not self._window:
                return 0.0
            return statistics.median(self._window) * 1e3

    def summary(self) -> dict:
        """The health block the ``Metrics`` message publishes."""
        with self._lock:
            return {
                "phase": self.phase,
                "transitions": len(self.transitions),
                "rtt_ms": round(
                    statistics.median(self._window) * 1e3, 3
                ) if self._window else 0.0,
                "best_ms": round(self.best * 1e3, 3) if self.best else 0.0,
                "observations": dict(self.observations),
            }


# one registry and one health monitor a process: the instrumentation points
# (sources, context, fetch pipeline, stats) feed one run-level story

_REGISTRY = MetricsRegistry()
_HEALTH = TunnelHealthMonitor(registry=_REGISTRY)


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def get_health_monitor() -> TunnelHealthMonitor:
    return _HEALTH


def reset_for_tests() -> None:
    """Clear the process-wide registry and health monitor (the hot path
    holds no references across calls, so swapping state is safe)."""
    global _HEALTH
    _REGISTRY.reset()
    _HEALTH = TunnelHealthMonitor(registry=_REGISTRY)
