"""Crash flight recorder (counterpart of ``twtml_tpu/telemetry/blackbox.py``):
a bounded in-memory ring of recent telemetry, dumped as ONE post-mortem JSON
bundle when a run aborts.

Every abort path (fetch-watchdog exhaustion, the sentinel's rollback budget)
goes through ``StreamingContext.request_abort``, which calls ``abort_dump``;
a SIGTERM dumps too. The bundle lands next to the checkpoint directory: the
config, sticky notes (the last checkpoint, the last rollback), the event ring
(trace spans under ``--trace``, guard events, chaos firings), a metrics
snapshot and the health summary. Its keys are the JAX package's, so that
package's ``tools/postmortem_report.py`` renders it; ``hosts`` and
``history`` are None (the per-host sideband and the historian are not
ported).

Recording is one lock and one deque append on the host; the dump runs once,
on the way down. Nothing here touches the device.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from collections import deque

from ..utils import get_logger

log = get_logger("telemetry.blackbox")

BUNDLE_KIND = "twtml-postmortem"
BUNDLE_VERSION = 1
DEFAULT_CAPACITY = 512

# keys a bundle must carry to be parseable
REQUIRED_KEYS = (
    "kind", "version", "reason", "time_unix", "config", "events", "metrics",
)


class FlightRecorder:
    def __init__(self, config: "dict | None" = None, out_dir: str = "",
                 process_index: int = 0, capacity: int = DEFAULT_CAPACITY):
        self.config = dict(config or {})
        self.out_dir = out_dir or os.getcwd()
        self.process_index = int(process_index)
        self._ring: deque = deque(maxlen=capacity)
        self._dropped = 0
        self._notes: dict = {}
        self._lock = threading.Lock()
        self.last_dump_path: "str | None" = None
        self._dumped = False

    def record(self, kind: str, **payload) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append({"t": round(time.time(), 3), "kind": kind, **payload})

    def note(self, key: str, value) -> None:
        """Sticky context that outlives the ring (the last checkpoint)."""
        with self._lock:
            self._notes[key] = value

    def on_trace_event(self, ev: dict) -> None:
        """Trace sink: complete spans and instants join the ring in compact
        form; metadata and counter tracks do not."""
        ph = ev.get("ph")
        if ph == "X":
            self.record("span", name=ev.get("name"),
                        dur_ms=round(float(ev.get("dur", 0.0)) / 1e3, 3),
                        **(ev.get("args") or {}))
        elif ph == "i":
            self.record("instant", name=ev.get("name"), **(ev.get("args") or {}))

    def bundle(self, reason: str) -> dict:
        from . import metrics as _metrics

        with self._lock:
            events = list(self._ring)
            notes = dict(self._notes)
            dropped = self._dropped
        return {
            "kind": BUNDLE_KIND,
            "version": BUNDLE_VERSION,
            "reason": reason,
            "time_unix": round(time.time(), 3),
            "process_index": self.process_index,
            "config": self.config,
            "notes": notes,
            "events": events,
            "events_dropped": dropped,
            "metrics": _metrics.get_registry().snapshot(),
            "health": _metrics.get_health_monitor().summary(),
            "hosts": None,
            "history": None,
        }

    def dump(self, reason: str, out_dir: "str | None" = None,
             force: bool = False) -> "str | None":
        """Write the bundle (atomic rename) and return its path. One bundle
        a process: the abort funnel and the SIGTERM handler may both fire on
        one shutdown; ``force`` writes again."""
        with self._lock:
            if self._dumped and not force:
                return self.last_dump_path
            self._dumped = True
        target_dir = out_dir or self.out_dir
        path = os.path.join(target_dir,
                            f"postmortem.p{self.process_index}.{os.getpid()}.json")
        try:
            os.makedirs(target_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(self.bundle(reason), fh, default=_json_default)
            os.replace(tmp, path)
        except OSError:
            log.exception("post-mortem bundle write failed (%s)", path)
            return None
        self.last_dump_path = path
        log.critical("post-mortem bundle written: %s (reason: %s)", path, reason)
        return path


def _json_default(obj):
    """numpy scalars and arrays in a payload serialize; anything else as
    its repr."""
    import numpy as np

    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return repr(obj)


_RECORDER: "FlightRecorder | None" = None
_PREV_SIGTERM = None
_SIGTERM_INSTALLED = False


def install(config: "dict | None" = None, out_dir: str = "", process_index: int = 0,
            capacity: int = DEFAULT_CAPACITY) -> FlightRecorder:
    """Activate the recorder process-wide (a re-install starts a fresh ring:
    each run records its own story) and hook it to the trace writer."""
    global _RECORDER
    _RECORDER = FlightRecorder(config=config, out_dir=out_dir,
                               process_index=process_index, capacity=capacity)
    from . import trace as _trace

    _trace.set_event_sink(_RECORDER.on_trace_event)
    return _RECORDER


def uninstall() -> None:
    global _RECORDER
    _RECORDER = None
    from . import trace as _trace

    _trace.set_event_sink(None)


def get() -> "FlightRecorder | None":
    return _RECORDER


def record(kind: str, **payload) -> None:
    """Ring append; one None check when no recorder is installed."""
    if _RECORDER is not None:
        _RECORDER.record(kind, **payload)


def note(key: str, value) -> None:
    if _RECORDER is not None:
        _RECORDER.note(key, value)


def abort_dump(reason: str) -> "str | None":
    """The abort funnel (``StreamingContext.request_abort``): record the
    abort and dump the bundle."""
    if _RECORDER is None:
        return None
    _RECORDER.record("abort", reason=reason)
    return _RECORDER.dump(reason)


def last_dump_path() -> "str | None":
    return _RECORDER.last_dump_path if _RECORDER is not None else None


def dump(reason: str, out_dir: "str | None" = None, force: bool = False) -> "str | None":
    if _RECORDER is None:
        return None
    return _RECORDER.dump(reason, out_dir=out_dir, force=force)


def _on_sigterm(signum, frame) -> None:
    """Dump on SIGTERM, then hand the signal to the handler that was there
    before (by default: terminate)."""
    if _RECORDER is not None:
        _RECORDER.record("sigterm")
        _RECORDER.dump("SIGTERM")
    prev = _PREV_SIGTERM
    if callable(prev):
        prev(signum, frame)
    elif prev == signal.SIG_DFL:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)


def install_signal_handler() -> bool:
    """Hook SIGTERM once a process. Only the main thread may install a
    signal handler: elsewhere this returns False and the abort funnel alone
    dumps."""
    global _PREV_SIGTERM, _SIGTERM_INSTALLED
    if _SIGTERM_INSTALLED:
        return True
    if threading.current_thread() is not threading.main_thread():
        return False
    _PREV_SIGTERM = signal.signal(signal.SIGTERM, _on_sigterm)
    _SIGTERM_INSTALLED = True
    return True
