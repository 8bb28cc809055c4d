"""Pipeline tracing (counterpart of ``twtml_tpu/telemetry/trace.py``):
Chrome-trace-event spans over the per-batch stages, written by ``--trace
PATH``.

File format: the Chrome JSON array format written incrementally, a ``[``
line and then one complete event object per line with a trailing comma (the
closing ``]`` is optional in that format, so a crash loses nothing). Loads
in Perfetto and ``chrome://tracing``; the JAX package's
``tools/trace_report.py`` reads it, the stage names being the same.

Off by default, and then ``get()`` returns a null tracer whose ``enabled``
is False: instrumentation sites check ``enabled`` before computing any
argument. Spans only time work the pipeline already does; none adds a
device sync or a copy.

Size rotation: when the file crosses ``max_bytes`` it becomes ``PATH.1``
(replacing an older ``PATH.1``, whose events are counted in
``trace.dropped_events``) and a fresh ``PATH`` starts (``--traceMaxMb``; 0
disables rotation).

``set_event_sink`` lets the flight recorder (telemetry/blackbox.py) see each
written event: recent spans ride its in-memory ring.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time

from ..utils import get_logger

log = get_logger("telemetry.trace")

# the per-batch pipeline stages, as the JAX package names them
STAGES = (
    "source_read",    # queue drain on the batch scheduler
    "parse",          # bytes -> Status, on the source thread
    "featurize",      # host featurize incl. the wire's arrays
    "wire_pack",      # one-buffer pack of the ragged wire (mode, wire_bytes)
    "dispatch",       # model.step enqueue (H2D copy, step, fetch start)
    "fetch",          # the host's wait on the batch's D2H copy
    "stats_publish",  # dashboard and Lightning posts
)


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **args) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _NullTrace:
    """The tracer when ``--trace`` is not set: every call is a no-op."""

    enabled = False
    path = ""

    def span(self, name, **args):
        return _NULL_SPAN

    def complete(self, name, t0_s, dur_s, **args):
        pass

    def instant(self, name, **args):
        pass

    def counter(self, name, **values):
        pass

    def close(self):
        pass


_NULL = _NullTrace()


class _Span:
    """Context manager recording one complete ("X") event on exit."""

    __slots__ = ("_trace", "_name", "_args", "_t0")

    def __init__(self, trace: "PipelineTrace", name: str, args: dict):
        self._trace = trace
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def add(self, **args) -> None:
        """Attach arguments known only inside the span."""
        self._args.update(args)

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self._args["error"] = exc_type.__name__
        self._trace.complete(self._name, self._t0, time.perf_counter() - self._t0,
                             **self._args)
        return False


def _meta_event(pid: int) -> dict:
    return {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "twtml-tpu pipeline"}}


class PipelineTrace:
    """Chrome-trace-event writer. ``ts`` is ``time.perf_counter`` in µs (one
    monotonic timebase across threads); line-buffered, so a crash loses at
    most the event being formatted; one lock around each line write."""

    enabled = True

    def __init__(self, path: str, max_bytes: int = 0):
        self.path = path
        self.max_bytes = max(0, int(max_bytes))
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._bytes = 0
        self._events_in_file = 0
        self._rotated_events = 0  # events in the current PATH.1
        self._fh = open(path, "w", encoding="utf-8", buffering=1)
        self._fh.write("[\n")
        self._event(_meta_event(self._pid))

    def _event(self, ev: dict) -> None:
        line = json.dumps(ev, separators=(",", ":"))
        with self._lock:
            if self._fh.closed:
                return
            self._fh.write(line + ",\n")
            self._bytes += len(line) + 2
            self._events_in_file += 1
            if self.max_bytes and self._bytes >= self.max_bytes:
                self._rotate_locked()
        sink = _SINK
        if sink is not None:
            sink(ev)

    def _rotate_locked(self) -> None:
        """The active file becomes PATH.1; an older PATH.1's events are
        dropped and counted (disk stays at ~2 x max_bytes)."""
        self._fh.close()
        rotated = self.path + ".1"
        if self._rotated_events:
            from . import metrics as _metrics

            _metrics.get_registry().counter("trace.dropped_events").inc(
                self._rotated_events)
            log.warning("trace rotation dropped %d event(s) from the oldest "
                        "segment (%s)", self._rotated_events, rotated)
        os.replace(self.path, rotated)
        self._rotated_events = self._events_in_file
        self._bytes = 0
        self._events_in_file = 0
        self._fh = open(self.path, "w", encoding="utf-8", buffering=1)
        self._fh.write("[\n")
        # the fresh segment carries its own metadata, so it loads alone
        line = json.dumps(_meta_event(self._pid), separators=(",", ":"))
        self._fh.write(line + ",\n")
        self._bytes += len(line) + 2
        self._events_in_file += 1

    def _base(self, name: str) -> dict:
        return {"name": name, "cat": "pipeline", "pid": self._pid,
                "tid": threading.get_ident() & 0xFFFFFFFF}

    def span(self, name: str, **args) -> _Span:
        """``with trace.span("featurize", rows=...):`` records one complete
        event over the block."""
        return _Span(self, name, args)

    def complete(self, name: str, t0_s: float, dur_s: float, **args) -> None:
        """A complete event from an already-taken (start, duration)."""
        ev = self._base(name)
        ev["ph"] = "X"
        ev["ts"] = round(t0_s * 1e6, 1)
        ev["dur"] = round(dur_s * 1e6, 1)
        if args:
            ev["args"] = args
        self._event(ev)

    def instant(self, name: str, **args) -> None:
        """A zero-duration, process-scoped mark (guard events)."""
        ev = self._base(name)
        ev["ph"] = "i"
        ev["ts"] = round(time.perf_counter() * 1e6, 1)
        ev["s"] = "p"
        if args:
            ev["args"] = args
        self._event(ev)

    def counter(self, name: str, **values) -> None:
        """A Chrome counter track."""
        ev = self._base(name)
        ev["ph"] = "C"
        ev["ts"] = round(time.perf_counter() * 1e6, 1)
        ev["args"] = values
        self._event(ev)

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()


_active: "PipelineTrace | _NullTrace" = _NULL
# the per-event callback (the flight recorder's ring), None when unset
_SINK = None


def set_event_sink(sink) -> None:
    """Attach (or, with None, detach) the per-event callback. Events flow
    only while a tracer is installed."""
    global _SINK
    _SINK = sink


def install(path: str, max_bytes: int = 0) -> "PipelineTrace | _NullTrace":
    """Trace to ``path`` (an empty path leaves tracing as it is), closing an
    earlier tracer; the file also closes at exit."""
    global _active
    if not path:
        return _active
    if _active.enabled:
        _active.close()
    _active = PipelineTrace(path, max_bytes=max_bytes)
    atexit.register(_active.close)
    log.info("pipeline trace -> %s (Perfetto-loadable)", path)
    return _active


def uninstall() -> None:
    """Close the tracer and turn tracing off (the app's shutdown)."""
    global _active
    if _active.enabled:
        _active.close()
    _active = _NULL


def get() -> "PipelineTrace | _NullTrace":
    return _active
