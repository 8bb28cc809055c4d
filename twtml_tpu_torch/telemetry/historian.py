"""Telemetry historian (counterpart of ``twtml_tpu/telemetry/historian.py``),
segment for segment: a directory either package writes reads in the other,
and for the same records both write the same bytes.

- **Sampled at the stats publish.** ``sample()`` is called from one place,
  ``SessionStats.publish_metrics``, and snapshots views the host already
  holds: the metrics registry, the health monitor, the cumulative stage
  clock and ``/proc/self/statm``. It adds no device copy and no launch.
- **The journal's durability discipline.** CRC32-framed JSON records in
  rotated segments (``seg-<seq>.twh``); a torn tail (a kill mid-append)
  fails the CRC and is truncated loudly on recovery
  (``history.torn_tails``); ``--historyMaxMb`` drops the oldest whole
  segments past the ceiling (``history.segments_dropped``). A restart
  appends after the recovered tail, so one directory holds a multi-run
  timeline.
- **Phase records.** The health monitor's transitions persist as labelled
  records, so ``phase_intervals``, ``rss_slope`` and ``phase_trends``
  rebuild phase-matched statistics from a dead run's segments alone.
- **Cross-run regression sentinel** (``--perfGuard warn|off``): healthy-phase
  per-stage medians of the per-sample stage deltas are stamped into
  ``<dir>/baseline.json`` at a clean shutdown; the next run raises one
  warn-only flight-recorder event and ``perf.regressions`` per episode in
  which a stage stays above ``--perfGuardRatio`` x its baseline for
  ``GUARD_WINDOW`` healthy samples. It never aborts.

``--history off`` installs nothing: the sample hook is a no-op.

Frame (little-endian): ``b"TWTH" | u32 payload_len | u32 crc32(payload) |
payload``, the payload one UTF-8 JSON object (compact separators) with a
``"k"`` kind tag: ``"r"`` run header (run id, config fingerprint), ``"s"``
sample, ``"p"`` phase transition.
"""

from __future__ import annotations

import json
import os
import re
import struct
import threading
import zlib
from collections import deque

from ..utils import get_logger
from ..utils.clock import now_ms
from . import metrics as _metrics
from . import sideband as _sideband

log = get_logger("telemetry.historian")

MAGIC = b"TWTH"
_FRAME = struct.Struct("<4sII")  # magic, payload_len, crc32(payload)
_SEG_RE = re.compile(r"^seg-(\d{20})\.twh$")
_PAYLOAD_MAX = 1 << 31  # sanity bound when scanning a possibly garbage tail

# segments rotate at this size unless --historyMaxMb forces smaller (the
# drop granularity under the disk ceiling: segments retire whole)
_SEGMENT_BYTES_DEFAULT = 4 * 1024 * 1024

BASELINE_NAME = "baseline.json"

# consecutive healthy samples a stage must stay above ratio x baseline
# before one episode fires
GUARD_WINDOW = 8
# stages cheaper than this a sample are timing noise; the sentinel skips them
GUARD_MIN_BASELINE_MS = 0.5
# healthy samples needed before a baseline stamp means anything
BASELINE_MIN_SAMPLES = GUARD_WINDOW
# per-stage healthy-sample history kept for the shutdown stamp
_STAGE_HISTORY = 4096
# in-memory tail ring: the flight recorder's bundle and the dashboard view
# read this, never the disk
TAIL_RING = 256
# samples shipped a view or bundle
TAIL_SAMPLES = 64


def _median(vals) -> float:
    s = sorted(vals)
    if not s:
        return 0.0
    n = len(s)
    if n % 2:
        return float(s[n // 2])
    return (s[n // 2 - 1] + s[n // 2]) / 2.0


class Historian:
    """Bounded on-disk time-series historian for one process. ``sample()``
    runs on the publish path; views and the bundle tail may be read from
    other threads, so the bookkeeping and the file handle sit under one
    lock."""

    def __init__(self, directory: str, max_mb: int = 256, perf_guard: bool = True,
                 guard_ratio: float = 1.5, run_id: int = 0, fingerprint: str = ""):
        self.directory = directory
        self.max_bytes = max(1, int(max_mb)) * 1024 * 1024
        self.segment_bytes = max(64 * 1024, min(_SEGMENT_BYTES_DEFAULT, self.max_bytes // 4))
        self.perf_guard = bool(perf_guard)
        self.guard_ratio = float(guard_ratio)
        self.run_id = int(run_id)
        self.fingerprint = str(fingerprint)
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._fh = None
        self._active_size = 0
        reg = _metrics.get_registry()
        self._samples_c = reg.counter("history.samples")
        self._torn = reg.counter("history.torn_tails")
        self._dropped_segments = reg.counter("history.segments_dropped")
        self._regressions = reg.counter("perf.regressions")
        self._disk_gauge = reg.gauge("history.disk_mb")
        self.next_seq = 0
        self._recover_tail()
        self._disk_bytes = self.disk_bytes()
        self._update_disk_gauge()
        # the stage clock at the previous sample: each sample records the
        # per-stage deltas since then
        self._prev_stages: "dict[str, float]" = dict(_sideband.stage_seconds())
        self._seen_transitions = 0
        self._tail: deque = deque(maxlen=TAIL_RING)
        self._stage_hist: "dict[str, deque]" = {}
        self._healthy_samples = 0
        # the sentinel: consecutive breaches a stage, and the episode latch
        self._breach_run: "dict[str, int]" = {}
        self._in_episode: "dict[str, bool]" = {}
        self.baseline: "dict | None" = self._load_baseline()
        self._write({
            "k": "r", "t_ms": now_ms(), "run_id": self.run_id,
            "fingerprint": self.fingerprint,
            "phase": _metrics.get_health_monitor().phase,
        })

    # -- disk ------------------------------------------------------------------
    def _segments(self) -> "list[tuple[int, str]]":
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in names:
            m = _SEG_RE.match(name)
            if m:
                out.append((int(m.group(1)), os.path.join(self.directory, name)))
        out.sort()
        return out

    def _seg_path(self, first_seq: int) -> str:
        return os.path.join(self.directory, f"seg-{first_seq:020d}.twh")

    def _recover_tail(self) -> None:
        """Find the append position from the newest segment with a valid
        frame, truncating a torn tail loudly."""
        for first_seq, path in reversed(self._segments()):
            size = os.path.getsize(path)
            valid_end = 0
            count = 0
            for _rec, end in _scan_segment(path):
                valid_end = end
                count += 1
            if valid_end < size:
                self._torn.inc()
                log.error(
                    "historian: TORN TAIL in %s: %d byte(s) after the last "
                    "CRC-valid frame truncated (a kill mid-append); every "
                    "complete record before it survives", path, size - valid_end,
                )
                with open(path, "r+b") as fh:
                    fh.truncate(valid_end)
            if count:
                self.next_seq = first_seq + count
                return
            if valid_end == 0 and first_seq != 0:
                os.unlink(path)  # a fully torn husk; the position is below it
                continue
            self.next_seq = first_seq
            return

    def _rotate_if_needed(self) -> None:
        if self._fh is not None and self._active_size < self.segment_bytes:
            return
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        self._fh = open(self._seg_path(self.next_seq), "ab")
        self._active_size = self._fh.tell()

    def disk_bytes(self) -> int:
        return sum(os.path.getsize(p) for _, p in self._segments())

    def _update_disk_gauge(self) -> None:
        self._disk_gauge.set(round(self._disk_bytes / (1024 * 1024), 3))

    def _enforce_max_bytes(self) -> None:
        """``--historyMaxMb`` is a hard ceiling: drop the oldest whole
        segments (never the active one) until under it, loudly."""
        if self._disk_bytes <= self.max_bytes:
            return
        for _, path in self._segments()[:-1]:
            if self._disk_bytes <= self.max_bytes:
                break
            size = os.path.getsize(path)
            os.unlink(path)
            self._disk_bytes -= size
            self._dropped_segments.inc()
            log.warning(
                "historian: disk ceiling --historyMaxMb exceeded: dropped the "
                "oldest segment %s (%d bytes); its samples are gone from the "
                "timeline (counted in history.segments_dropped)",
                os.path.basename(path), size,
            )

    def _write(self, rec: dict) -> None:
        """Append one CRC-framed JSON record."""
        payload = json.dumps(rec, separators=(",", ":"), ensure_ascii=False).encode("utf-8")
        with self._lock:
            self._rotate_if_needed()
            self._fh.write(_FRAME.pack(MAGIC, len(payload), zlib.crc32(payload)))
            self._fh.write(payload)
            self._fh.flush()
            self._active_size += _FRAME.size + len(payload)
            self._disk_bytes += _FRAME.size + len(payload)
            self.next_seq += 1
            if self._active_size >= self.segment_bytes:
                self._enforce_max_bytes()
            self._update_disk_gauge()

    # -- sample ----------------------------------------------------------------
    def sample(self) -> None:
        """Snapshot the host-side telemetry views into one durable record:
        the phase transitions since the last sample, then the registry,
        the health summary, the stage-clock deltas and the RSS."""
        from ..utils.rss import rss_mb

        monitor = _metrics.get_health_monitor()
        with monitor._lock:
            transitions = list(monitor.transitions)
            phase = monitor.phase
        for t, ph in transitions[self._seen_transitions:]:
            self._write({"k": "p", "t_ms": int(t * 1000.0), "phase": ph})
        self._seen_transitions = len(transitions)

        stages = _sideband.stage_seconds()
        deltas = {
            k: round((v - self._prev_stages.get(k, 0.0)) * 1000.0, 3)
            for k, v in stages.items()
        }
        self._prev_stages = stages
        snap = _metrics.get_registry().snapshot()
        summary = monitor.summary()
        rec = {
            "k": "s",
            "seq": self.next_seq,
            "t_ms": now_ms(),
            "run_id": self.run_id,
            "phase": phase,
            "rss_mb": round(rss_mb(), 2),
            "rtt_ms": summary["rtt_ms"],
            "stages_ms": deltas,
            "counters": snap["counters"],
            "gauges": snap["gauges"],
        }
        self._write(rec)
        self._samples_c.inc()
        with self._lock:
            self._tail.append({
                "t_ms": rec["t_ms"], "phase": phase, "rss_mb": rec["rss_mb"],
                "rtt_ms": rec["rtt_ms"], "stages_ms": deltas,
            })
            if phase == monitor.HEALTHY:
                self._healthy_samples += 1
                for stage, ms in deltas.items():
                    self._stage_hist.setdefault(
                        stage, deque(maxlen=_STAGE_HISTORY)).append(ms)
        if self.perf_guard and phase == monitor.HEALTHY:
            self._guard_check(deltas)

    # -- regression sentinel ---------------------------------------------------
    def _guard_check(self, deltas: "dict[str, float]") -> None:
        """Sustained-regression detection against the previous run's
        baseline, healthy samples only: one flight-recorder event and one
        ``perf.regressions`` a stage episode, never a raise."""
        base = self.baseline
        if not base:
            return
        for stage, base_ms in base.get("stages_ms", {}).items():
            if base_ms < GUARD_MIN_BASELINE_MS:
                continue
            cur = deltas.get(stage)
            if cur is None:
                continue
            if cur > self.guard_ratio * base_ms:
                run = self._breach_run.get(stage, 0) + 1
                self._breach_run[stage] = run
            else:
                self._breach_run[stage] = 0
                self._in_episode[stage] = False
                continue
            if run >= GUARD_WINDOW and not self._in_episode.get(stage):
                self._in_episode[stage] = True
                self._regressions.inc()
                ratio = round(cur / base_ms, 2)
                from . import blackbox as _blackbox

                _blackbox.record(
                    "perf_regression", stage=stage, ratio=ratio,
                    baseline_ms=round(base_ms, 3), current_ms=round(cur, 3),
                    window=run, baseline_run_id=base.get("run_id", -1),
                )
                log.warning(
                    "perfGuard: stage %r sustained at %.2fx the healthy-phase "
                    "baseline (%.3f ms -> %.3f ms a publish tick, %d consecutive "
                    "healthy samples; baseline from run %s); warn-only, counted "
                    "in perf.regressions", stage, ratio, base_ms, cur, run,
                    base.get("run_id", "?"),
                )

    def _load_baseline(self) -> "dict | None":
        path = os.path.join(self.directory, BASELINE_NAME)
        try:
            with open(path, encoding="utf-8") as fh:
                doc = json.load(fh)
            if isinstance(doc, dict) and isinstance(doc.get("stages_ms"), dict):
                log.info("perfGuard: baseline loaded from %s (run %s, %d healthy "
                         "samples)", path, doc.get("run_id", "?"), doc.get("samples", 0))
                return doc
        except FileNotFoundError:
            pass
        except Exception:  # lawcheck: disable=TW005 -- an unreadable baseline disarms the warn-only sentinel (logged)
            log.warning("perfGuard: unreadable baseline %s ignored", path, exc_info=True)
        return None

    def stamp_baseline(self) -> "dict | None":
        """Write the per-stage healthy-phase medians as the next run's
        baseline (a clean shutdown only; temp file and rename). None when
        too few healthy samples exist."""
        with self._lock:
            if self._healthy_samples < BASELINE_MIN_SAMPLES:
                return None
            stages = {
                stage: round(_median(vals), 3)
                for stage, vals in self._stage_hist.items() if vals
            }
            samples = self._healthy_samples
        doc = {
            "version": 1,
            "run_id": self.run_id,
            "fingerprint": self.fingerprint,
            "samples": samples,
            "stages_ms": stages,
        }
        path = os.path.join(self.directory, BASELINE_NAME)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
        os.replace(tmp, path)
        log.info("perfGuard: baseline stamped to %s (%d healthy samples, %d stages)",
                 path, samples, len(stages))
        return doc

    # -- views -----------------------------------------------------------------
    def view(self) -> "dict | None":
        """The dashboard's ``History`` view from the in-memory tail (None
        before the first sample)."""
        with self._lock:
            if not self._tail:
                return None
            tail = list(self._tail)[-TAIL_SAMPLES:]
            disk_mb = round(self._disk_bytes / (1024 * 1024), 2)
        from ..utils.rss import slope_mb_per_min

        slope = slope_mb_per_min([(t["t_ms"] / 1000.0, t["rss_mb"]) for t in tail])
        return {
            "samples": int(self._samples_c.snapshot()),
            "runId": self.run_id,
            "phase": tail[-1]["phase"],
            "rssMb": tail[-1]["rss_mb"],
            "rssSlopeMbPerMin": round(slope, 3),
            "rttMs": tail[-1]["rtt_ms"],
            "diskMb": disk_mb,
            "regressions": int(self._regressions.snapshot()),
            "rss": [t["rss_mb"] for t in tail],
            "rtt": [t["rtt_ms"] for t in tail],
            "stageMs": [round(sum(t["stages_ms"].values()), 2) for t in tail],
        }

    def bundle_tail(self, samples: int = TAIL_SAMPLES) -> dict:
        """The flight recorder's fold-in: the tail samples and every phase
        transition this process saw, from memory (no disk read mid-crash)."""
        with self._lock:
            tail = list(self._tail)[-samples:]
        monitor = _metrics.get_health_monitor()
        with monitor._lock:
            transitions = [[int(t * 1000.0), ph] for t, ph in monitor.transitions]
        return {
            "run_id": self.run_id,
            "fingerprint": self.fingerprint,
            "samples": tail,
            "transitions": transitions,
            "baseline": self.baseline,
        }

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


# -- raw readers: a dead run's directory, with no live process state ------------

def _scan_segment(path: str):
    """Yield (record, end offset) for every CRC-valid frame of a segment,
    stopping at the first invalid one (a torn tail)."""
    with open(path, "rb") as fh:
        data = fh.read()
    pos = 0
    while pos + _FRAME.size <= len(data):
        magic, plen, crc = _FRAME.unpack_from(data, pos)
        if magic != MAGIC or plen == 0 or plen > _PAYLOAD_MAX:
            return
        end = pos + _FRAME.size + plen
        if end > len(data):
            return  # torn mid-payload
        payload = data[pos + _FRAME.size: end]
        if zlib.crc32(payload) != crc:
            return  # torn mid-frame, or bit rot
        try:
            rec = json.loads(payload.decode("utf-8"))
        except ValueError:
            return
        yield rec, end
        pos = end


def read_series(directory: str) -> "list[dict]":
    """Every CRC-valid record of every segment, in append order; a torn
    tail is skipped, not an error."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    segs = sorted(
        (int(m.group(1)), os.path.join(directory, n))
        for n in names if (m := _SEG_RE.match(n))
    )
    return [rec for _first, path in segs for rec, _end in _scan_segment(path)]


def phase_intervals(records: "list[dict]") -> "list[dict]":
    """Healthy/degraded episodes as labelled [start_ms, end_ms] intervals
    from the run-header, phase and sample records. A sample or header with
    a new phase flips the interval too (a torn tail may have eaten the
    transition record)."""
    out: "list[dict]" = []
    cur_phase = None
    cur_start = None
    last_t = None
    n_samples = 0

    def _close(end_ms):
        if cur_phase is not None and cur_start is not None:
            out.append({"phase": cur_phase, "start_ms": int(cur_start),
                        "end_ms": int(end_ms), "samples": n_samples})

    for rec in records:
        t = rec.get("t_ms")
        if t is None:
            continue
        kind = rec.get("k")
        phase = rec.get("phase")
        if kind == "s":
            last_t = t
        if not phase:
            continue
        if cur_phase is None:
            cur_phase, cur_start = phase, t
        elif phase != cur_phase:
            _close(t)
            cur_phase, cur_start = phase, t
            n_samples = 0
        if kind == "s":
            n_samples += 1
    _close(last_t if last_t is not None else cur_start)
    return out


def rss_slope(records: "list[dict]") -> float:
    """Least-squares RSS slope (MB/min) over every sample record."""
    from ..utils.rss import slope_mb_per_min

    return slope_mb_per_min([
        (rec["t_ms"] / 1000.0, rec["rss_mb"])
        for rec in records if rec.get("k") == "s" and "rss_mb" in rec
    ])


def phase_trends(records: "list[dict]") -> "dict[str, dict]":
    """Per-phase medians of fetch RTT, RSS, per-sample stage costs and
    rows/s (from the journal's appended-rows counter between samples of
    one run)."""
    by_phase: "dict[str, dict]" = {}
    prev: "dict | None" = None
    for rec in records:
        if rec.get("k") != "s":
            continue
        bucket = by_phase.setdefault(rec.get("phase", "?"), {
            "samples": 0, "rtt_ms": [], "rss_mb": [], "stages_ms": {}, "rows_per_s": [],
        })
        bucket["samples"] += 1
        if rec.get("rtt_ms", 0) > 0:
            bucket["rtt_ms"].append(rec["rtt_ms"])
        if "rss_mb" in rec:
            bucket["rss_mb"].append(rec["rss_mb"])
        for stage, ms in rec.get("stages_ms", {}).items():
            bucket["stages_ms"].setdefault(stage, []).append(ms)
        if prev is not None and prev.get("run_id") == rec.get("run_id"):
            dt_s = (rec["t_ms"] - prev["t_ms"]) / 1000.0
            rows = (rec.get("counters", {}).get("journal.appended_rows", 0)
                    - prev.get("counters", {}).get("journal.appended_rows", 0))
            if dt_s > 0 and rows > 0:
                bucket["rows_per_s"].append(rows / dt_s)
        prev = rec
    return {
        phase: {
            "samples": b["samples"],
            "rtt_ms": round(_median(b["rtt_ms"]), 3),
            "rss_mb": round(_median(b["rss_mb"]), 2),
            "rows_per_s": round(_median(b["rows_per_s"]), 1),
            "stages_ms": {stage: round(_median(vals), 3)
                          for stage, vals in sorted(b["stages_ms"].items())},
        }
        for phase, b in by_phase.items()
    }


# -- the module face: the app installs once, the publish seam samples -----------

_HISTORIAN: "Historian | None" = None


def configure(directory: str, max_mb: int = 256, perf_guard: bool = True,
              guard_ratio: float = 1.5, run_id: int = 0, fingerprint: str = "") -> Historian:
    global _HISTORIAN
    if _HISTORIAN is not None:
        _HISTORIAN.close()
    _HISTORIAN = Historian(directory, max_mb=max_mb, perf_guard=perf_guard,
                           guard_ratio=guard_ratio, run_id=run_id, fingerprint=fingerprint)
    log.info("telemetry historian ON: %s (max %d MB, run_id=%d, perfGuard=%s, "
             "resumed at seq %d)", directory, max_mb, run_id,
             "warn" if perf_guard else "off", _HISTORIAN.next_seq)
    return _HISTORIAN


def enabled() -> bool:
    return _HISTORIAN is not None


def get() -> "Historian | None":
    return _HISTORIAN


def sample() -> None:
    """The sampling hook (``SessionStats.publish_metrics`` only); a no-op
    when the historian is off."""
    if _HISTORIAN is not None:
        _HISTORIAN.sample()


def last_history() -> "dict | None":
    """The latest ``History`` view; None when off or before a sample."""
    return _HISTORIAN.view() if _HISTORIAN is not None else None


def bundle_tail() -> "dict | None":
    """The flight recorder's fold-in; None when off."""
    return _HISTORIAN.bundle_tail() if _HISTORIAN is not None else None


def stamp_baseline() -> "dict | None":
    """The clean-shutdown hook: stamp this run's healthy-phase stage
    medians as the next run's perfGuard baseline."""
    if _HISTORIAN is not None and _HISTORIAN.perf_guard:
        return _HISTORIAN.stamp_baseline()
    return None


def uninstall() -> None:
    global _HISTORIAN
    if _HISTORIAN is not None:
        _HISTORIAN.close()
    _HISTORIAN = None


def reset_for_tests() -> None:
    uninstall()
