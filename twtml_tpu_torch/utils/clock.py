"""The wall-clock seam: one place where ``TWTML_NOW_MS`` pins time
(counterpart of ``twtml_tpu/utils/clock.py``).

Code that stamps batches or tweets with the wall clock reads this seam, so
a pinned run replays bit for bit. ``time.monotonic()`` stays the clock of
pure intervals (deadlines, backoff), which are not part of a replay.
"""

from __future__ import annotations

import os
import time


def now_ms() -> int:
    """Epoch milliseconds, pinned by ``TWTML_NOW_MS`` when set. A malformed
    pin raises: falling back to the wall clock would un-pin a replay that
    believes itself pinned."""
    env = os.environ.get("TWTML_NOW_MS", "")
    if env:
        return int(env)
    return int(time.time() * 1000)


def now_s() -> float:
    """Epoch seconds through the same seam (batch timestamps)."""
    return now_ms() / 1000.0
