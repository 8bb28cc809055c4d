"""Stream sources: the receiver layer (counterpart of the single-host
sources of ``twtml_tpu/streaming/sources.py``).

A source is a small supervised producer thread pushing parsed ``Status``
objects into the streaming context's intake queue:

- ``ReplayFileSource`` replays a tweets .jsonl fixture, as fast as it parses
  or paced at ``speed`` x realtime;
- ``SyntheticSource`` generates tweets whose retweet counts follow a known
  linear function of the features, with the same numpy draws in the same
  order as the JAX package's, so one seed gives the same tweets in both;
- ``QueueSource`` is pushed to by its caller (tests, pre-filled streams);
- ``SkipRowsSource`` fast-forwards past the rows a restarted run's intake
  journal already holds (apps/common.py ``journal_boot_replay``);
- ``MultiSource`` runs N inner sources concurrently into one stream (the
  single-host fan-in of sharded receivers).

Supervision: a crashed producer restarts with jittered exponential backoff,
up to ``max_restarts`` consecutive failures (counted in ``source.restarts``).
``produce()`` is also the plain generator of a source's tweets. The
``--chaos`` ``source.burst`` rule re-emits a tweet from the supervised loop
(streaming/faults.py). The live Twitter source is ``streaming/twitter.py``;
block ingest and the multi-host sharded sources are not ported.
"""

from __future__ import annotations

import json
import queue
import random
import threading
import time
from typing import Callable, Iterator

from ..features.featurizer import Status
from ..telemetry import metrics as _metrics
from ..utils import get_logger
from ..utils.clock import now_ms

log = get_logger("streaming.sources")

# streaming/faults.py imports this module, so it is bound at first use
_faults_mod = None


def _burst_extra() -> int:
    """Extra re-emits of the current tweet under ``--chaos source.burst``
    (one global read and a None check when chaos is off)."""
    global _faults_mod
    if _faults_mod is None:
        from . import faults

        _faults_mod = faults
    return _faults_mod.burst_extra()


class Source:
    """Base: override ``produce`` (a generator of Status); ``start`` runs it
    on a supervised thread feeding ``emit``."""

    name = "source"

    # restart backoff ceiling, and how long stop() waits for the producer
    BACKOFF_CAP_S = 30.0
    JOIN_TIMEOUT_S = 5.0

    def __init__(self, max_restarts: int = 3, restart_backoff: float = 1.0):
        self._emit: Callable[[Status], None] | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._exhausted = threading.Event()
        self.max_restarts = max_restarts
        self.restart_backoff = restart_backoff

    def produce(self) -> Iterator[Status]:  # pragma: no cover - abstract
        raise NotImplementedError

    def start(self, emit: Callable[[Status], None]) -> None:
        self._emit = emit
        self._stop.clear()
        self._exhausted.clear()
        self._thread = threading.Thread(
            target=self._run_supervised, name=f"twtml-source-{self.name}", daemon=True
        )
        self._thread.start()

    def _run_supervised(self) -> None:
        restarts = 0
        while not self._stop.is_set():
            emitted_any = False
            try:
                for status in self.produce():
                    if self._stop.is_set():
                        return
                    self._emit(status)
                    emitted_any = True
                    for _ in range(_burst_extra()):  # --chaos source.burst
                        self._emit(status)
                self._exhausted.set()
                return  # clean end of stream
            except Exception as exc:
                if emitted_any:
                    # a run that produced data was a healthy connection:
                    # max_restarts bounds CONSECUTIVE failures
                    restarts = 0
                restarts += 1
                if restarts > self.max_restarts:
                    log.exception("source %s died permanently", self.name)
                    self._exhausted.set()
                    return
                backoff = self._backoff(exc, restarts)
                reg = _metrics.get_registry()
                reg.counter("source.restarts").inc()
                reg.counter(f"source.{self.name}.restarts").inc()
                log.exception(
                    "source %s crashed; restart %d/%d in %.1fs",
                    self.name, restarts, self.max_restarts, backoff,
                )
                if self._stop.wait(backoff):
                    return

    def _backoff(self, exc: Exception, restarts: int) -> float:
        """Seconds before restart ``restarts`` (1-based): exponential from
        ``restart_backoff``, jittered uniformly in [0.5x, 1x] (restarting
        shards of one dead upstream must not reconnect in phase), capped at
        ``BACKOFF_CAP_S``, with the exponent capped so 2**n cannot
        overflow."""
        del exc
        base = min(
            self.restart_backoff * (2 ** min(restarts - 1, 12)),
            self.BACKOFF_CAP_S,
        )
        return base * (0.5 + 0.5 * random.random())

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=self.JOIN_TIMEOUT_S)
            if thread.is_alive():
                log.warning(
                    "source %s did not stop: producer thread %r still "
                    "running %.1fs after the stop request (wedged in a "
                    "blocking call?); proceeding with shutdown",
                    self.name, thread.name, self.JOIN_TIMEOUT_S,
                )

    @property
    def exhausted(self) -> bool:
        return self._exhausted.is_set()


class ReplayFileSource(Source):
    """Replay a .jsonl file of tweet objects. ``speed`` = 0 replays as fast
    as possible; otherwise tweets are paced at ``speed`` x realtime by the
    gaps between their timestamps (10 ms where a timestamp is missing).
    ``loop`` starts over at the end of the file."""

    name = "replay"

    def __init__(self, path: str, speed: float = 0.0, loop: bool = False, **kw):
        super().__init__(**kw)
        self.path = path
        self.speed = speed
        self.loop = loop

    def produce(self) -> Iterator[Status]:
        while True:
            prev_ms: int | None = None
            with open(self.path, encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    status = Status.from_json(json.loads(line))
                    if self.speed > 0:
                        gap_ms = 10.0
                        if prev_ms and status.created_at_ms > prev_ms:
                            gap_ms = status.created_at_ms - prev_ms
                        prev_ms = status.created_at_ms or prev_ms
                        if self._stop.wait(gap_ms / 1000.0 / self.speed):
                            return
                    yield status
            if not self.loop:
                return


class SyntheticSource(Source):
    """Tweets whose retweet counts follow a known linear function of the
    features. ``rate`` = tweets/s (0 = unpaced), ``total`` = stop after n
    (0 = unbounded), ``base_ms`` pins the created_at base (the wall clock,
    through the ``TWTML_NOW_MS`` seam, when None)."""

    name = "synthetic"

    _WORDS = (
        "tpu stream learn fast jax pallas shard mesh grad psum tweet viral "
        "scale batch online model predict train news data"
    ).split()

    def __init__(self, total: int = 0, rate: float = 0.0, seed: int = 0,
                 base_ms: int | None = None, **kw):
        super().__init__(**kw)
        self.total = total
        self.rate = rate
        self.seed = seed
        self.base_ms = base_ms

    def produce(self) -> Iterator[Status]:
        import numpy as np

        rng = np.random.default_rng(self.seed)
        count = 0
        while self.total <= 0 or count < self.total:
            n_words = int(rng.integers(3, 9))
            words = rng.choice(self._WORDS, size=n_words)
            text = " ".join(words)
            followers = int(rng.integers(100, 2_000_000))
            # ground truth: label correlates with followers + text length
            label = int(
                np.clip(100 + followers * 4e-4 + len(text) * 2 + rng.normal(0, 20),
                        100, 1000)
            )
            original = Status(
                text=text,
                retweet_count=label,
                followers_count=followers,
                favourites_count=int(rng.integers(0, 50_000)),
                friends_count=int(rng.integers(0, 10_000)),
                created_at_ms=(
                    self.base_ms if self.base_ms is not None else now_ms()
                ) - int(rng.integers(0, 86_400_000)),
            )
            yield Status(text="RT " + text, retweeted_status=original)
            count += 1
            if self.rate > 0 and self._stop.wait(1.0 / self.rate):
                return


class QueueSource(Source):
    """A source its caller pushes Status objects into; ``close`` ends the
    stream after what was pushed."""

    name = "queue"

    def __init__(self, **kw):
        super().__init__(**kw)
        self._q: "queue.Queue[Status | None]" = queue.Queue()

    def push(self, status: Status) -> None:
        self._q.put(status)

    def close(self) -> None:
        self._q.put(None)

    def produce(self) -> Iterator[Status]:
        while True:
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    return  # interruptible without close()
                continue
            if item is None:
                return
            yield item


class SkipRowsSource(Source):
    """Drop the first ``skip_rows`` tweets of an inner source: the boot half
    of journal recovery. On a restart every row the journal holds is either
    inside the restored checkpoint or replayed from the journal, so a source
    that re-produces the same stream (a replay file, a pinned synthetic or
    pre-filled source) must skip all of them."""

    name = "skiprows"

    def __init__(self, inner: Source, skip_rows: int, **kw):
        kw.setdefault("max_restarts", inner.max_restarts)
        kw.setdefault("restart_backoff", inner.restart_backoff)
        super().__init__(**kw)
        self.inner = inner
        self.skip_rows = int(skip_rows)

    def produce(self) -> Iterator[Status]:
        # a supervised restart re-enters produce() and the inner source
        # re-produces from its top, so the skip applies from the top too
        remaining = self.skip_rows
        for item in self.inner.produce():
            if remaining > 0:
                remaining -= 1
                continue
            yield item

    def stop(self) -> None:
        self.inner.stop()
        super().stop()


class MultiSource(Source):
    """Sharded receiver fan-in on one host: N inner sources run concurrently,
    each on its own supervised thread, into one ``emit``; a watcher thread
    marks the stream exhausted once every shard is."""

    name = "multi"
    # how often the watcher looks at the shards
    WATCH_S = 0.05

    def __init__(self, sources: list[Source], **kw):
        super().__init__(**kw)
        self.sources = sources

    def start(self, emit: Callable[[Status], None]) -> None:
        self._emit = emit
        self._stop.clear()
        self._exhausted.clear()
        for src in self.sources:
            src.start(emit)
        self._thread = threading.Thread(
            target=self._watch, name="twtml-source-multi", daemon=True
        )
        self._thread.start()

    def _watch(self) -> None:
        while not self._stop.is_set():
            if all(s.exhausted for s in self.sources):
                self._exhausted.set()
                return
            if self._stop.wait(self.WATCH_S):
                return

    def stop(self) -> None:
        for src in self.sources:
            src.stop()
        super().stop()

    def produce(self) -> Iterator[Status]:
        """The shards' tweets one shard after another (the threads of
        ``start`` interleave them instead)."""
        for src in self.sources:
            yield from src.produce()
