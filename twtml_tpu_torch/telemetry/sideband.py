"""The stage clock (counterpart of the stage-clock part of
``twtml_tpu/telemetry/sideband.py``): cumulative wall seconds per pipeline
stage, fed by the seams that already time their work (source read,
featurize, wire pack, dispatch, fetch wait, stats publish). The freshness
plane's lineage records diff it per batch to name a batch's critical edge.
One lock and one float add a stage a batch. The per-host sideband vector
and its collector ride the multi-host lockstep scheduler (ROADMAP A10).
"""

from __future__ import annotations

import threading

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


def reset_for_tests() -> None:
    global _CLOCK_ON
    with _STAGE_LOCK:
        _STAGE_SECONDS.clear()
    _CLOCK_ON = True
