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
(streaming/faults.py). The live Twitter source is ``streaming/twitter.py``.

Block ingest (``--ingest block``): ``BlockReplayFileSource`` replays a file
through the native block parser (``BlockParserMixin``, which the live
``BlockTwitterSource`` shares), yielding columnar ``ParsedBlock`` items
(features/blocks.py) with no per-tweet Python object; across hosts each
process parses its own line-aligned byte range of the file. The multi-host
intake shards: ``ShardedSource`` (round-robin over a replay or synthetic
stream) and ``IdShardedSource`` (by status id, for a live stream).
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
from ..telemetry import sideband as _sideband
from ..telemetry import trace as _trace
from ..utils import get_logger
from ..utils.clock import now_ms

log = get_logger("streaming.sources")

# streaming/faults.py imports this module, so it is bound at first use
_faults_mod = None


def _faults():
    global _faults_mod
    if _faults_mod is None:
        from . import faults

        _faults_mod = faults
    return _faults_mod


def _burst_extra() -> int:
    """Extra re-emits of the current tweet under ``--chaos source.burst``
    (one global read and a None check when chaos is off)."""
    return _faults().burst_extra()


def _count_parse_drops(n: int) -> None:
    """Malformed lines the block parser skipped, in the registry
    (``ingest.rows_dropped_parse``) beside the other ingest losses."""
    _metrics.get_registry().counter("ingest.rows_dropped_parse").inc(n)


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


class BlockParserMixin:
    """Bytes -> ``ParsedBlock``, the stage both block sources share (the
    file replay below and the live ``BlockTwitterSource``, twitter.py). A
    consumer sets ``begin``/``end`` (the retweet-count interval) and
    ``wire``.

    ``wire=True`` parses through the zero-copy wire emitter
    (``native.parse_tweet_block_wire``): blocks carry uint8 units whenever
    every kept row is ASCII, the narrow wire dtype, so the featurizer has
    no downcast pass. Its rows and arrays equal the legacy parser's; only
    the bad-line COUNT may undercount on keyless malformed lines (its
    prescreen skips whole-line validation there, native/tweetjson.cpp).
    The parse degrades in order: the wire emitter, the legacy C parser,
    the Python ground truth; each step down is counted in
    ``native.PARSE_COUNTERS`` and warned once, and each parse counts its
    parser there. ``--chaos source.garbage`` damages the bytes before the
    parser, whose skip-and-count contract absorbs it."""

    begin: int
    end: int
    wire: bool = False

    def parse_buffer(self, data: bytes) -> list:
        """Parse a whole byte buffer (ending at a line boundary) into
        ParsedBlocks, looping over the parser's capacity bounds so an
        oversized buffer cannot drop its tail."""
        blocks = []
        while data.strip():
            if not data.endswith(b"\n"):
                data += b"\n"
            block, rest = self._parse(data)
            if block is not None and block.rows:
                blocks.append(block)
            if not rest or rest == data:
                break
            data = rest
        return blocks

    def _parse(self, data: bytes):
        """(ParsedBlock | None, carry bytes) of one buffered chunk: the
        ``parse`` stage (a span a chunk under ``--trace``), the
        ``ingest.parse_bytes`` counter and the ``ingest.parse_tweets_per_s``
        gauge."""
        tr = _trace.get()
        t0 = time.perf_counter()
        with tr.span("parse", bytes=len(data)) as sp:
            block, rest = self._parse_impl(data)
            if tr.enabled and block is not None:
                sp.add(rows=int(block.rows))
        dt = time.perf_counter() - t0
        _sideband.record_stage("parse", dt)
        reg = _metrics.get_registry()
        reg.counter("ingest.parse_bytes").inc(len(data))
        if block is not None and dt > 0:
            reg.gauge("ingest.parse_tweets_per_s").set(round(block.rows / dt, 1))
        return block, rest

    def _parse_impl(self, data: bytes):
        from ..features import native
        from ..features.blocks import ParsedBlock

        data = _faults().maybe_corrupt_block(data)  # --chaos source.garbage
        out = None
        if self.wire:
            out = native.parse_tweet_block_wire(data, self.begin, self.end)
            if out is None:
                native.note_parse_degraded(
                    "wire", "the native library lacks parse_tweet_block_wire; the legacy "
                    "C parser runs")
            else:
                native.PARSE_COUNTERS["parses_wire"] += 1
        if out is None:
            out = native.parse_tweet_block(data, self.begin, self.end)
            if out is None:
                native.note_parse_degraded(
                    "native", "the native block parser is unavailable; the Python "
                    "ground truth parses")
            else:
                native.PARSE_COUNTERS["parses_native"] += 1
        if out is None:
            native.PARSE_COUNTERS["parses_python"] += 1
            return self._py_parse(data)
        numeric, units, offsets, ascii_flags, consumed, bad = out
        if bad:
            log.warning("block parser skipped %d malformed lines", bad)
            _count_parse_drops(bad)
        return ParsedBlock(numeric, units, offsets, ascii_flags), data[consumed:]

    def _py_parse(self, data: bytes):
        """The ground truth: ``json.loads`` and ``Status`` a line. A
        retweeted status with ANY direct ``text``/``full_text`` occurrence
        (duplicate keys included: the C scanner bounds every occurrence,
        where a dict keeps the last) over ``native.MAX_TEXT_UNITS`` makes
        its line a counted bad line, as in the C parsers; malformed lines
        and JSON that is not a tweet object skip and count."""
        import numpy as np

        from ..features.blocks import ParsedBlock
        from ..features.featurizer import encode_texts
        from ..features.native import MAX_TEXT_UNITS

        class _Obj(dict):
            oversized = False  # a direct text/full_text value too big
            rt_oversized = False  # any retweeted_status occurrence oversized

        def _pairs_hook(pairs):
            d = _Obj(pairs)
            for k, v in pairs:
                if (k in ("text", "full_text") and isinstance(v, str)
                        and len(v.encode("utf-16-le", "surrogatepass")) // 2
                        > MAX_TEXT_UNITS):
                    d.oversized = True
                if k == "retweeted_status" and getattr(v, "oversized", False):
                    d.rt_oversized = True
            return d

        nl = data.rfind(b"\n")
        if nl < 0:
            return None, data
        lines, carry = data[:nl].split(b"\n"), data[nl + 1:]
        numerics, texts = [], []
        for ln in lines:
            ln = ln.strip()
            if not ln:
                continue
            try:
                obj = json.loads(ln, object_pairs_hook=_pairs_hook)
                if getattr(obj, "rt_oversized", False):
                    raise ValueError("text exceeds the wire-format unit bound")
                status = Status.from_json(obj)
            except (ValueError, AttributeError, TypeError):
                log.warning("block parser skipped a malformed line")
                _count_parse_drops(1)
                continue
            o = status.retweeted_status
            if o is not None and self.begin <= o.retweet_count <= self.end:
                numerics.append((o.retweet_count, o.followers_count, o.favourites_count,
                                 o.friends_count, o.created_at_ms))
                texts.append(o.text)
        units, offsets = encode_texts(texts)
        block = ParsedBlock(
            np.array(numerics, np.int64).reshape(len(texts), 5),
            units[: offsets[-1]],
            offsets,
            np.array([1 if t.isascii() else 0 for t in texts], np.uint8),
        )
        return block, carry


class BlockReplayFileSource(BlockParserMixin, Source):
    """Replay a .jsonl file through the native block parser: each item is a
    columnar ParsedBlock with the isRetweet and retweet-count filter
    applied, no per-tweet Python object (the Python ground truth when the
    C library is unavailable). As fast as it parses: block ingest has no
    per-tweet pacing.

    ``shard_index``/``shard_count`` select a line-aligned BYTE-RANGE shard
    of the file: its span splits into ``shard_count`` equal ranges, and a
    line belongs to the shard holding its first byte, so each reader parses
    only its share, sequentially, with no line read twice: a multi-host
    run's intake shard, from the process id and count."""

    name = "replay-block"

    def __init__(self, path: str, num_retweet_begin: int = 100,
                 num_retweet_end: int = 1000, block_bytes: int = 1 << 20,
                 loop: bool = False, wire: bool = False,
                 shard_index: int = 0, shard_count: int = 1, **kw):
        super().__init__(**kw)
        self.path = path
        self.begin = num_retweet_begin
        self.end = num_retweet_end
        self.block_bytes = block_bytes
        self.loop = loop
        self.wire = wire
        if not 0 <= shard_index < max(1, shard_count):
            raise ValueError(f"shard index {shard_index} out of range for {shard_count}")
        self.shard_index = shard_index
        self.shard_count = max(1, shard_count)

    def _shard_range(self) -> "tuple[int, int]":
        """This shard's [start, stop) byte range, line-aligned: a raw range
        boundary moves forward past the line holding it (unless it sits at
        a line start), the same for this shard's stop and the next shard's
        start, so every line lands in exactly one shard."""
        import os

        size = os.path.getsize(self.path)
        if self.shard_count <= 1:
            return 0, size

        def boundary(pos: int) -> int:
            if pos <= 0 or pos >= size:
                return min(max(pos, 0), size)
            with open(self.path, "rb") as fh:
                fh.seek(pos - 1)
                if fh.read(1) != b"\n":
                    fh.readline()  # mid-line: the line belongs to the left
                return fh.tell()

        lo = size * self.shard_index // self.shard_count
        hi = size * (self.shard_index + 1) // self.shard_count
        return boundary(lo), boundary(hi)

    def produce(self) -> Iterator:
        while True:
            lo, hi = self._shard_range()
            with open(self.path, "rb") as fh:
                fh.seek(lo)
                remaining = hi - lo
                carry = b""
                while True:
                    chunk = fh.read(min(self.block_bytes, remaining)) if remaining > 0 else b""
                    remaining -= len(chunk)
                    if not chunk:
                        # the tail goes through the capacity-bound loop
                        yield from self.parse_buffer(carry)
                        break
                    block, carry = self._parse(carry + chunk)
                    if block is not None and block.rows:
                        yield block
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


class ShardedSource(Source):
    """Items ``index``-of-``count`` (round-robin) of an inner source: a
    multi-host run's intake shard. Every process opens the same replay or
    synthetic source and keeps 1/N of it, so the union of the shards is the
    single-host stream, and tick k of the N processes together covers the
    rows a single-host run batches at tick k.

    Elastic rebalance (``--elastic on``): the shard is a RESIDUE SET, and
    ``count`` stays the launch process count; a departed host's residues
    are adopted by survivors (``adopt_residues``), so coverage going
    forward is exact without re-keying anyone's position. ``produce``
    reads the set an item at a time, so an adoption takes effect from the
    adopter's current position (items of the departed residues before the
    takeover are the counted loss window, streaming/membership.py)."""

    name = "shard"

    def __init__(self, inner: Source, index: int, count: int, **kw):
        super().__init__(**kw)
        if not 0 <= index < count:
            raise ValueError(f"shard index {index} out of range for {count}")
        self.inner = inner
        self.index = index
        self.count = count
        self.residues = {index}

    def adopt_residues(self, residues) -> None:
        """Take over the given residue classes (a departed host's shard),
        from this source's current position."""
        self.residues |= {int(r) % self.count for r in residues}
        log.warning("intake shard rebalanced: now serving residues %s of %d",
                    sorted(self.residues), self.count)

    def release_residues(self, residues) -> None:
        """Hand residue classes back (a rejoined live host resumes its own
        slice); this host's own residue is never released."""
        self.residues -= {int(r) % self.count for r in residues}
        self.residues.add(self.index)

    def produce(self) -> Iterator[Status]:
        for i, status in enumerate(self.inner.produce()):
            if i % self.count in self.residues:
                yield status


class IdShardedSource(Source):
    """Rows whose status id is ``index`` mod ``count`` of an inner source:
    the live stream's multi-host intake shard. Separately opened live
    connections give no common order, so the round-robin shard cannot cut
    them; the tweet's id can (each process keeps a disjoint id residue, and
    no tweet trains twice). Rows without an id (id 0) land on shard 0."""

    name = "idshard"

    def __init__(self, inner: Source, index: int, count: int, **kw):
        # supervision runs on this wrapper: the live source's restart policy
        # carries through
        kw.setdefault("max_restarts", inner.max_restarts)
        kw.setdefault("restart_backoff", inner.restart_backoff)
        super().__init__(**kw)
        if not 0 <= index < count:
            raise ValueError(f"shard index {index} out of range for {count}")
        self.inner = inner
        self.index = index
        self.count = count
        self.residues = {index}

    def adopt_residues(self, residues) -> None:
        """Serve a departed host's id residues too, from this connection,
        going forward: exact coverage of a live stream (ids are
        position-free, unlike replay indexes)."""
        self.residues |= {int(r) % self.count for r in residues}
        log.warning("live intake shard rebalanced: now serving id residues %s of %d",
                    sorted(self.residues), self.count)

    def release_residues(self, residues) -> None:
        self.residues -= {int(r) % self.count for r in residues}
        self.residues.add(self.index)

    def produce(self) -> Iterator[Status]:
        for status in self.inner.produce():
            if status.id % self.count in self.residues:
                yield status

    def _backoff(self, exc: Exception, restarts: int) -> float:
        return self.inner._backoff(exc, restarts)


class SkipRowsSource(Source):
    """Drop the first ``skip_rows`` tweets of an inner source (a ParsedBlock
    counts its rows and is cut at the boundary): the boot half of journal
    recovery. On a restart every row the journal holds is either
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
                take = getattr(item, "rows", None)
                if take is None:
                    remaining -= 1
                    continue
                if take <= remaining:
                    remaining -= take
                    continue
                # a block straddles the skip boundary: keep its tail rows
                from ..features.blocks import slice_block

                item, remaining = slice_block(item, remaining, take), 0
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
