"""Lockstep straggler attribution over the per-host sideband matrix
(counterpart of ``twtml_tpu/telemetry/straggler.py``).

Every lockstep tick the slowest host silently gates the whole group (the
cadence allgather is a barrier). Given the gathered ``[hosts,
sideband.WIDTH]`` matrix, this classifier names the gating host (largest
``tick_prep_ms`` — the wall time each host spent on its OWN work between
allgathers, waiting-in-collective excluded) and attributes it to a stage on
the bottleneck ladder:

    upload (dispatch — argument uploads ride it) > parse > featurize >
    fetch > device

Attribution rule: with enough history (``min_history`` ticks), the stage
whose current value deviates most ABOVE that host's own rolling median —
self-relative, like the tunnel-health classifier, so a host that is simply
configured slower than its peers doesn't drown the signal of what CHANGED.
Cold (or when no host stage moved), the largest absolute stage time wins;
and when the host's stage clocks account for almost none of its tick time,
the verdict falls back to ``device`` — time spent outside host-side stages
(the device step / collective interior), which host clocks cannot see.

Outputs are registry state (``lockstep.straggler_host``,
``lockstep.tick_skew_ms`` gauges + per-stage ``straggler.<stage>.ticks``
counters) and the verdict dict the sideband publishes to the dashboard's
``Hosts`` tile row. Pure host-side bookkeeping — no device traffic.
"""

from __future__ import annotations

import statistics
from collections import deque

import numpy as np

from ..utils import get_logger

log = get_logger("telemetry.straggler")

# sideband stage field → bottleneck-ladder name (dispatch carries the
# batch's host-to-device copy)
LADDER = {
    "dispatch_ms": "upload",
    "parse_ms": "parse",
    "featurize_ms": "featurize",
    "fetch_ms": "fetch",
    "source_read_ms": "ingest",
    "publish_ms": "publish",
}

# below this tick skew (ms) no host is meaningfully gating — at CPU-test
# scale every host lands within scheduler noise of its peers
MIN_SKEW_MS = 5.0

# fraction of the gating host's tick time its host-side stages must explain
# before a stage verdict beats the "device" fallback
MIN_STAGE_SHARE = 0.2


class StragglerAttributor:
    def __init__(self, window: int = 64, min_history: int = 8):
        self.window = window
        self.min_history = min_history
        # history[host][field_index] -> deque of recent values
        self._history: "dict[int, dict[int, deque]]" = {}
        self.last: "dict | None" = None
        self.ticks = 0

    def _push(self, host: int, col: int, value: float) -> float:
        """Record a value and return the PRIOR rolling median (0 when no
        history yet) — the deviation baseline must not include the value
        being judged."""
        cols = self._history.setdefault(host, {})
        dq = cols.setdefault(col, deque(maxlen=self.window))
        med = statistics.median(dq) if len(dq) >= self.min_history else None
        dq.append(value)
        return med if med is not None else 0.0

    def observe(self, matrix: np.ndarray) -> dict:
        """One gathered sideband matrix → the tick's verdict dict
        ``{host, stage, skew_ms, prep_ms}``."""
        from . import metrics as _metrics
        from .sideband import FIELDS

        self.ticks += 1
        matrix = np.asarray(matrix, dtype=np.float64)
        prep = matrix[:, FIELDS.index("tick_prep_ms")]
        gate = int(np.argmax(prep))
        skew = float(prep.max() - prep.min()) if matrix.shape[0] > 1 else 0.0

        stage_cols = [
            (i, LADDER[name])
            for i, name in enumerate(FIELDS)
            if name in LADDER
        ]
        # update every host's rolling history (the baselines must advance
        # for all hosts every tick, not just the gating one)
        deviations: "dict[int, dict[str, tuple[float, float]]]" = {}
        for h in range(matrix.shape[0]):
            per = {}
            for col, ladder_name in stage_cols:
                v = float(matrix[h, col])
                med = self._push(h, col, v)
                per[ladder_name] = (v, v - med)
            deviations[h] = per

        stage = ""
        if matrix.shape[0] > 1 and skew >= MIN_SKEW_MS:
            per = deviations[gate]
            cold = self.ticks <= self.min_history
            # deviation-ranked once history exists; absolute-ranked cold
            key = (lambda kv: kv[1][0]) if cold else (lambda kv: kv[1][1])
            name, (value, _dev) = max(per.items(), key=key)
            total_stage_ms = sum(v for v, _ in per.values())
            prep_gate = float(prep[gate])
            if value <= 0 or (
                prep_gate > 0 and total_stage_ms < MIN_STAGE_SHARE * prep_gate
            ):
                # the host clocks explain almost none of the tick: the time
                # went to the device step / collective interior
                stage = "device"
            else:
                stage = name
            _metrics.get_registry().counter(
                f"straggler.{stage}.ticks"
            ).inc()
        gating = stage != ""
        reg = _metrics.get_registry()
        reg.gauge("lockstep.straggler_host").set(gate if gating else -1)
        reg.gauge("lockstep.tick_skew_ms").set(round(skew, 3))
        self.last = {
            "host": gate if gating else -1,
            "stage": stage,
            "skew_ms": round(skew, 3),
            "prep_ms": [round(float(v), 3) for v in prep],
        }
        return self.last

    def summary(self) -> dict:
        """Last verdict + per-host rolling stage medians (for reports)."""
        from .sideband import FIELDS

        medians: "dict[int, dict[str, float]]" = {}
        for host, cols in self._history.items():
            medians[host] = {
                LADDER[FIELDS[col]]: round(statistics.median(dq), 3)
                for col, dq in cols.items()
                if dq and FIELDS[col] in LADDER
            }
        return {"last": self.last, "ticks": self.ticks, "medians": medians}
