"""Process-RSS sampling for long-running loops (counterpart of
``twtml_tpu/utils/rss.py``).

``rss_mb`` reads the resident set size; ``slope_mb_per_min`` is the
least-squares growth rate the session publisher's
``host.rss_slope_mb_per_min`` gauge reports; ``RssWatchdog`` samples on the
batch cadence and warns each time RSS grows by another threshold step. The
remedy for a process that keeps growing is bounded lifetime:
``--recycleAfterMb`` checkpoints and re-execs it, and the restart resumes
exactly (apps/common.py ``ProcessRecycler``).
"""

from __future__ import annotations

import os
import resource

from .logging import get_logger

log = get_logger("utils.rss")


def rss_mb() -> float:
    """Current resident set size in MB (``/proc/self/statm``; the Linux
    ``ru_maxrss`` high-water mark, in KB, where statm is unreadable)."""
    try:
        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        return pages * os.sysconf("SC_PAGESIZE") / 1e6
    except (OSError, ValueError, IndexError):
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def slope_mb_per_min(samples) -> float:
    """Least-squares slope of ``(t_seconds, rss_mb)`` samples in MB/min;
    0.0 until two samples exist or when all timestamps coincide."""
    pts = list(samples)
    if len(pts) < 2:
        return 0.0
    xs = [t / 60.0 for t, _ in pts]
    ys = [m for _, m in pts]
    n = float(len(pts))
    mx = sum(xs) / n
    my = sum(ys) / n
    var = sum((x - mx) ** 2 for x in xs)
    if var == 0.0:
        return 0.0
    cov = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    return cov / var


class RssWatchdog:
    """``tick()`` once a batch; samples every ``sample_every`` ticks into the
    ``host.rss_mb`` gauge and warns when RSS has grown ``warn_growth_mb``
    beyond the first sample (then again at each further step).
    ``TWTML_RSS_WARN_MB`` sets the step; 0 disables the warning."""

    def __init__(self, warn_growth_mb: "float | None" = None, sample_every: int = 64):
        if warn_growth_mb is None:
            warn_growth_mb = float(os.environ.get("TWTML_RSS_WARN_MB", 2048))
        self.warn_growth_mb = warn_growth_mb
        self.sample_every = max(1, sample_every)
        self.last_mb: "float | None" = None
        self.warn_count = 0
        self._base: "float | None" = None
        self._next_warn = warn_growth_mb
        self._ticks = 0

    def tick(self) -> None:
        self._ticks += 1
        if self._ticks % self.sample_every:
            return
        from ..telemetry import metrics as _metrics

        cur = rss_mb()
        self.last_mb = cur
        _metrics.get_registry().gauge("host.rss_mb").set(round(cur, 1))
        if self._base is None:
            self._base = cur
            return
        growth = cur - self._base
        if self.warn_growth_mb > 0 and growth >= self._next_warn:
            log.warning(
                "process RSS grew %.0f MB since start (now %.0f MB); bound the "
                "process lifetime with --recycleAfterMb (checkpoint + exact "
                "re-exec, needs --checkpointDir)", growth, cur,
            )
            self.warn_count += 1
            self._next_warn = growth + self.warn_growth_mb
