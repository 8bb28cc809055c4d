"""The stage clock and the per-host lockstep sideband (counterpart of
``twtml_tpu/telemetry/sideband.py``).

- The stage clock: cumulative wall seconds per pipeline stage, fed by the
  seams that already time their work (source read, featurize, wire pack,
  dispatch, fetch wait, stats publish). The freshness plane's lineage
  records diff it per batch to name a batch's critical edge. One lock and
  one float add a stage a batch.
- ``SidebandCollector``: this host's fixed ``FIELDS`` vector each lockstep
  tick, from the stage clock's deltas, registry gauges and the health
  monitor: host bookkeeping only, no device read and no collective.
- ``LockstepTelemetry``: the lockstep scheduler's driver. Its vector rides
  the tick's ONE cadence all-gather (streaming/context.py widens the flags,
  never adds a collective); ``ingest`` takes the gathered [hosts, WIDTH]
  matrix, names the straggler (telemetry/straggler.py) and publishes the
  ``hosts[]`` view (``publish_hosts``/``last_hosts``) that the dashboard's
  ``GET /api/hosts`` and the flight recorder read.
"""

from __future__ import annotations

import threading
import time

import numpy as np

# The fixed sideband layout (the JAX package's): every host ships exactly
# this vector behind the lockstep flags, so its width is part of the
# collective's contract.
FIELDS = (
    "tick_prep_ms",  # wall ms of this host's own work between cadence all-gathers
    "source_read_ms",  # per-stage wall ms since the last tick
    "parse_ms",
    "featurize_ms",
    "dispatch_ms",
    "fetch_ms",
    "publish_ms",
    "queue_rows",  # intake queue depth (ingest.queue_rows)
    "fetch_rtt_ms",  # the health monitor's rolling median
    "rollbacks",  # divergence-sentinel rollbacks
    "rows_shed",  # ingest.rows_shed
    "health_degraded",  # 0 healthy / 1 degraded
    "wire_pack_ms",
    "event_lag_ms",  # freshness: the last event-to-delivery lag
)
WIDTH = len(FIELDS)

# FIELDS entries that are per-tick deltas of the stage clock
STAGE_FIELDS = {
    "source_read_ms": "source_read",
    "parse_ms": "parse",
    "featurize_ms": "featurize",
    "dispatch_ms": "dispatch",
    "fetch_ms": "fetch",
    "publish_ms": "stats_publish",
    "wire_pack_ms": "wire_pack",
}

_STAGE_LOCK = threading.Lock()
_STAGE_SECONDS: "dict[str, float]" = {}
_CLOCK_ON = True


def record_stage(stage: str, dur_s: float) -> None:
    """Accumulate one stage timing in seconds."""
    if not _CLOCK_ON:
        return
    with _STAGE_LOCK:
        _STAGE_SECONDS[stage] = _STAGE_SECONDS.get(stage, 0.0) + dur_s


def stage_seconds() -> "dict[str, float]":
    with _STAGE_LOCK:
        return dict(_STAGE_SECONDS)


def set_stage_clock(on: bool) -> None:
    """Turn the clock off for an all-off control arm."""
    global _CLOCK_ON
    _CLOCK_ON = bool(on)


class SidebandCollector:
    """This host's sideband vector, built each lockstep tick from host
    state."""

    def __init__(self):
        self._prev_stages = stage_seconds()
        self._prev_tick = time.perf_counter()

    def collect(self, rollbacks: int = 0) -> np.ndarray:
        from . import freshness as _freshness
        from . import metrics as _metrics

        now = time.perf_counter()
        cur = stage_seconds()
        reg = _metrics.get_registry()
        health = _metrics.get_health_monitor()
        vec = np.zeros((WIDTH,), dtype=np.float64)
        for i, name in enumerate(FIELDS):
            stage = STAGE_FIELDS.get(name)
            if stage is not None:
                vec[i] = (cur.get(stage, 0.0) - self._prev_stages.get(stage, 0.0)) * 1e3
        vec[FIELDS.index("tick_prep_ms")] = (now - self._prev_tick) * 1e3
        vec[FIELDS.index("queue_rows")] = reg.gauge("ingest.queue_rows").snapshot()
        vec[FIELDS.index("fetch_rtt_ms")] = health.median_ms()
        vec[FIELDS.index("rollbacks")] = float(rollbacks)
        vec[FIELDS.index("rows_shed")] = reg.counter("ingest.rows_shed").snapshot()
        vec[FIELDS.index("health_degraded")] = 1.0 if health.phase == health.DEGRADED else 0.0
        vec[FIELDS.index("event_lag_ms")] = _freshness.last_event_lag_ms()
        self._prev_stages = cur
        # a non-finite value must never ride the collective
        np.nan_to_num(vec, copy=False, posinf=0.0, neginf=0.0)
        return vec

    def tick_done(self) -> None:
        """The cadence all-gather returned: time spent waiting in it is not
        this host's own work."""
        self._prev_tick = time.perf_counter()


_VIEW_LOCK = threading.Lock()
_LAST_VIEW: "dict | None" = None


def publish_hosts(view: dict) -> None:
    global _LAST_VIEW
    with _VIEW_LOCK:
        _LAST_VIEW = view


def last_hosts() -> "dict | None":
    """The newest hosts[] view (None before a lockstep tick)."""
    with _VIEW_LOCK:
        return None if _LAST_VIEW is None else dict(_LAST_VIEW)


class LockstepTelemetry:
    """One a lockstep loop: ``vector()`` before the cadence all-gather,
    ``tick_done()`` right after it, ``ingest(matrix)`` on its rows."""

    def __init__(self, process_index: int = 0, num_processes: int = 1):
        from . import metrics as _metrics
        from .straggler import StragglerAttributor

        self.process_index = process_index
        self.num_processes = num_processes
        self._collector = SidebandCollector()
        self._attributor = StragglerAttributor()
        self._ticks = _metrics.get_registry().counter("lockstep.ticks")

    def vector(self, rollbacks: int = 0) -> np.ndarray:
        return self._collector.collect(rollbacks=rollbacks)

    def tick_done(self) -> None:
        self._collector.tick_done()

    def ingest(self, matrix: np.ndarray) -> dict:
        """The gathered [hosts, WIDTH] block: the straggler verdict, the
        published hosts[] view (returned) and a flight-recorder record."""
        from . import blackbox as _blackbox

        self._ticks.inc()
        verdict = self._attributor.observe(matrix)
        hosts = []
        for h in range(matrix.shape[0]):
            row = {"host": h}
            for i, name in enumerate(FIELDS):
                row[name] = round(float(matrix[h, i]), 3)
            hosts.append(row)
        view = {"hosts": hosts, "straggler": verdict["host"], "stage": verdict["stage"],
                "skew_ms": verdict["skew_ms"]}
        publish_hosts(view)
        _blackbox.record("sideband", straggler=verdict["host"], stage=verdict["stage"],
                         skew_ms=verdict["skew_ms"],
                         prep_ms=[round(float(v), 2) for v in matrix[:, 0]])
        return view


def reset_for_tests() -> None:
    global _CLOCK_ON, _LAST_VIEW
    with _STAGE_LOCK:
        _STAGE_SECONDS.clear()
    with _VIEW_LOCK:
        _LAST_VIEW = None
    _CLOCK_ON = True
