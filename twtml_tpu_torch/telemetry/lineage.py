"""Per-batch lineage records of the freshness plane (counterpart of
``twtml_tpu/telemetry/lineage.py``).

Every batch gets ONE record, stamped at seams the pipeline already crosses:

  open      ``FeatureStream._process``, before featurize: a stage-clock
            snapshot, one ``now_ms()`` read (the ``TWTML_NOW_MS`` seam) and
            the batch's event-time span (min/max ``created_at_ms``);
  dispatch  each dispatch site (apps/common.py): the oldest open record
            moves to the in-flight FIFO;
  delivery  ``FreshnessGuard`` (the outermost delivery wrapper): the oldest
            in-flight record is popped and its stage-clock deltas name the
            dominant edge.

Two FIFOs, matched by position: deliveries come in dispatch order. A
dispatch with no open record pushes a blank, so the FIFOs stay aligned; a
batch shed before dispatch is dropped with ``drop_newest``. Both FIFOs are
bounded. Every hook is a no-op until ``configure(True)``.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..utils.clock import now_ms
from . import sideband as _sideband

# the edges eligible for critical-path attribution (stage-clock keys)
EDGES = ("source_read", "parse", "featurize", "wire_pack", "dispatch", "fetch")

MAX_RECORDS = 4096

_LOCK = threading.Lock()
_ON = False
_PREP: deque = deque(maxlen=MAX_RECORDS)
_INFLIGHT: deque = deque(maxlen=MAX_RECORDS)


def configure(on: bool) -> None:
    global _ON
    with _LOCK:
        _ON = bool(on)


def enabled() -> bool:
    return _ON


def _event_span(statuses) -> "tuple[int, int]":
    """(min_ms, max_ms) of ``created_at_ms`` over a Status list; zeros
    mean unknown."""
    lo = hi = 0
    for item in statuses:
        ms = getattr(item, "created_at_ms", 0)
        if ms > 0:
            if lo == 0 or ms < lo:
                lo = ms
            if ms > hi:
                hi = ms
    return lo, hi


def open_batch(statuses) -> None:
    """Stamp a lineage record as the batch enters featurize."""
    if not _ON:
        return
    lo, hi = _event_span(statuses)
    rec = {
        "t_open": time.perf_counter(),
        "opened_ms": now_ms(),
        "stages": _sideband.stage_seconds(),
        "event_min_ms": lo,
        "event_max_ms": hi,
        "rows": len(statuses),
    }
    with _LOCK:
        _PREP.append(rec)


def drop_newest() -> None:
    """The just-opened batch was shed before dispatch (``skip_empty``)."""
    if not _ON:
        return
    with _LOCK:
        if _PREP:
            _PREP.pop()


def mark_dispatch(n: int = 1) -> None:
    """Move the ``n`` oldest open records in flight (a blank when none is
    open: a warm-up or a bare pipeline)."""
    if not _ON:
        return
    with _LOCK:
        for _ in range(n):
            _INFLIGHT.append(_PREP.popleft() if _PREP else None)


def pop_delivery() -> "dict | None":
    """Pop the oldest in-flight record at delivery, with its stage-clock
    deltas since open; None when the FIFO is empty or the record blank."""
    if not _ON:
        return None
    with _LOCK:
        rec = _INFLIGHT.popleft() if _INFLIGHT else None
    if rec is None:
        return None
    cur = _sideband.stage_seconds()
    base = rec.get("stages") or {}
    edges = {s: max(0.0, (cur.get(s, 0.0) - base.get(s, 0.0)) * 1e3) for s in EDGES}
    rec["edges_ms"] = edges
    rec["delivered_ms"] = now_ms()
    rec["e2e_ms"] = (time.perf_counter() - rec["t_open"]) * 1e3
    critical = max(edges, key=edges.get)
    rec["critical"] = critical if edges[critical] > 0.0 else ""
    return rec


def open_event_floor() -> int:
    """The oldest event time still open or in flight (0 when none is
    known): the low watermark's input."""
    if not _ON:
        return 0
    floor = 0
    with _LOCK:
        for rec in (*_PREP, *_INFLIGHT):
            if rec is None:
                continue
            lo = rec.get("event_min_ms", 0)
            if lo > 0 and (floor == 0 or lo < floor):
                floor = lo
    return floor


def depths() -> "tuple[int, int]":
    with _LOCK:
        return len(_PREP), len(_INFLIGHT)


def reset_for_tests() -> None:
    global _ON
    with _LOCK:
        _ON = False
        _PREP.clear()
        _INFLIGHT.clear()
