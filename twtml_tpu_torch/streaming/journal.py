"""Durable intake journal (counterpart of ``twtml_tpu/streaming/journal.py``),
segment for segment: a journal either package writes replays in the other.

Every batch of raw rows is appended at the ONE intake seam (post-parse,
pre-featurize: ``FeatureStream._process`` in streaming/context.py) as a
CRC32-framed record with a monotonic id. Verified checkpoints stamp a
cursor (``snapshot_for_checkpoint``), and every recovery path (the
sentinel's rollback, a restart) re-ingests the rows after it instead of
counting them lost.

- **Host only.** Buffered file writes and one ``flush()`` an append (no
  fsync: a killed process's flushed pages survive; a machine crash tears
  the tail, which the frame CRC turns into a loud truncation).
- **Exact replay.** An object record serializes the Status fields the
  featurizer reads (recursively through ``retweeted_status``); replayed
  rows re-enter the unchanged featurize path.
- **Bounded disk.** Segments rotate at a fixed size and retire once the
  oldest retained verified checkpoint covers them; ``--journalMaxMb`` drops
  the oldest segments past the ceiling, loudly and counted.
- **Replay suppression.** Replayed rows re-cross the seam from the queue
  front; the journal does not append them again (else a second rollback to
  the same checkpoint would train them twice).
- **Dispatch tokens.** The fetch pipeline dispatches ahead of delivery, so
  the journal's tail is not what the weights hold. Each seam crossing
  pushes a token, each delivery pops one in dispatch order, and an
  admitted delivery commits it; checkpoints stamp the committed cursor.

Frame (little-endian): ``b"TWJL" | u32 payload_len | u32 crc32(payload) |
payload``, ``payload = u64 record_id | u64 rows_after | u8 kind | u32 nrows
| body``; an object record's body is a JSON array of 9-element rows
``[text, retweet_count, followers_count, favourites_count, friends_count,
created_at_ms, lang, id, retweeted_status-row-or-null]``; a block record's
(kind 2, ``--ingest block``) is ``u8 units dtype code (1 uint8, 2 uint16) |
u64 units length`` and then the merged ParsedBlock's arrays as bytes:
numeric int64 [n, 5], units, offsets int64 [n+1], ascii uint8 [n]. Both
kinds are the JAX package's bytes, so each package replays the other's
journal.
"""

from __future__ import annotations

import collections
import json
import operator
import os
import re
import struct
import threading
import zlib

from ..telemetry import metrics as _metrics
from ..utils import get_logger

log = get_logger("streaming.journal")

MAGIC = b"TWJL"
_FRAME = struct.Struct("<4sII")  # magic, payload_len, crc32(payload)
_RECORD = struct.Struct("<QQBI")  # record id, rows_after, kind, nrows
KIND_OBJ = 1
KIND_BLOCK = 2
# block body header: units dtype code (1 = the uint8 ASCII wire, 2 = uint16),
# units length
_BLOCK = struct.Struct("<BQ")
_SEG_RE = re.compile(r"^seg-(\d{20})\.twj$")

# segments rotate at this size unless --journalMaxMb forces smaller (a
# segment retires whole)
_SEGMENT_BYTES_DEFAULT = 16 * 1024 * 1024
_PAYLOAD_MAX = 1 << 31  # bound when scanning a possibly-garbage tail

_STATUS_FIELDS = operator.attrgetter(
    "text", "retweet_count", "followers_count", "favourites_count",
    "friends_count", "created_at_ms", "lang", "id", "retweeted_status",
)


def _status_to_row(s) -> tuple:
    row = _STATUS_FIELDS(s)
    if row[8] is None:
        return row
    return row[:8] + (_status_to_row(row[8]),)


def _row_to_status(v):
    from ..features.featurizer import Status

    rs = v[8]
    return Status(
        text=v[0], retweet_count=v[1], followers_count=v[2], favourites_count=v[3],
        friends_count=v[4], created_at_ms=v[5], lang=v[6], id=v[7],
        retweeted_status=_row_to_status(rs) if rs is not None else None,
    )


def _encode_block(block) -> bytes:
    import numpy as np

    units = np.ascontiguousarray(block.units)
    return b"".join((
        _BLOCK.pack(1 if units.dtype == np.uint8 else 2, units.size),
        np.ascontiguousarray(block.numeric, dtype=np.int64).tobytes(),
        units.tobytes(),
        np.ascontiguousarray(block.offsets, dtype=np.int64).tobytes(),
        np.ascontiguousarray(block.ascii, dtype=np.uint8).tobytes(),
    ))


def _decode_block(nrows: int, body: bytes):
    """The ParsedBlock of a kind-2 body, its units in the dtype written."""
    import numpy as np

    from ..features.blocks import ParsedBlock

    code, units_len = _BLOCK.unpack_from(body, 0)
    pos = _BLOCK.size
    numeric = np.frombuffer(body, np.int64, nrows * 5, pos).reshape(nrows, 5).copy()
    pos += nrows * 5 * 8
    units_dtype = np.uint8 if code == 1 else np.uint16
    units = np.frombuffer(body, units_dtype, units_len, pos).copy()
    pos += units_len * np.dtype(units_dtype).itemsize
    offsets = np.frombuffer(body, np.int64, nrows + 1, pos).copy()
    pos += (nrows + 1) * 8
    ascii_col = np.frombuffer(body, np.uint8, nrows, pos).copy()
    return ParsedBlock(numeric, units, offsets, ascii_col)


def _decode_record(kind: int, nrows: int, body: bytes) -> list:
    """The items of one record as they crossed the seam: a Status list, or
    a one-ParsedBlock list for a block record."""
    if kind == KIND_BLOCK:
        return [_decode_block(nrows, body)]
    return [_row_to_status(d) for d in json.loads(body.decode("utf-8"))]


def rows_of(items: list) -> int:
    """Rows of a seam batch: a batch is all Status objects or all blocks
    (one source kind), so the first item decides."""
    if not items or getattr(items[0], "rows", None) is None:
        return len(items)
    return sum(item.rows for item in items)


def _encode_items(items: list):
    """(kind, body, rows) of a seam batch's record: a block batch merges
    into one kind-2 block, a Status batch is a kind-1 JSON array."""
    if getattr(items[0], "rows", None) is not None:
        from ..features.blocks import merge_blocks

        block = merge_blocks(list(items))
        return KIND_BLOCK, _encode_block(block), block.rows
    body = json.dumps([_status_to_row(s) for s in items], separators=(",", ":"),
                      ensure_ascii=False).encode("utf-8")
    return KIND_OBJ, body, len(items)


def drop_rows(items: list, skip_rows: int) -> list:
    """A seam batch without its first ``skip_rows`` rows (the replayed head
    of a mixed drain)."""
    if getattr(items[0], "rows", None) is None:
        return items[skip_rows:]
    from ..features.blocks import merge_blocks, slice_block

    block = merge_blocks(list(items))
    return [slice_block(block, skip_rows, block.rows)]


class IntakeJournal:
    """Append-only, segment-rotated, CRC-framed row journal. Appends,
    replays and retirement run on the scheduler thread (or before the
    stream starts); the lock guards the bookkeeping against readers."""

    def __init__(self, directory: str, max_mb: int = 512):
        self.directory = directory
        self.max_bytes = max(1, int(max_mb)) * 1024 * 1024
        self.segment_bytes = max(1024 * 1024,
                                 min(_SEGMENT_BYTES_DEFAULT, self.max_bytes // 4))
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._fh = None
        self._active_size = 0
        self._pending_replay = 0  # replayed rows whose re-append is suppressed
        reg = _metrics.get_registry()
        self._appended = reg.counter("journal.appended_rows")
        self._replayed = reg.counter("journal.replayed_rows")
        self._torn = reg.counter("journal.torn_tails")
        self._dropped_segments = reg.counter("journal.segments_dropped")
        self._disk_gauge = reg.gauge("journal.disk_mb")
        self.next_id = 0
        self.rows_total = 0
        self._recover_tail()
        self._inflight: collections.deque = collections.deque()
        self._delivery_pos: "tuple[int, int] | None" = None
        self._replay_draining = False
        self._committed = (self.next_id, self.rows_total)
        # kept incrementally (one listdir + stat sweep at open and on
        # retire/drop, never per append)
        self._disk_bytes = self.disk_bytes()
        self._update_disk_gauge()

    # ---------------------------------------------------------------- disk

    def _segments(self) -> "list[tuple[int, str]]":
        """Sorted (first_record_id, path) of every segment on disk."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        out = []
        for name in names:
            m = _SEG_RE.match(name)
            if m:
                out.append((int(m.group(1)), os.path.join(self.directory, name)))
        out.sort()
        return out

    def _seg_path(self, first_id: int) -> str:
        return os.path.join(self.directory, f"seg-{first_id:020d}.twj")

    @staticmethod
    def _scan_segment(path: str):
        """(record_id, rows_after, kind, nrows, body, end_offset) of every
        CRC-valid frame, stopping at the first invalid one."""
        with open(path, "rb") as fh:
            data = fh.read()
        pos = 0
        while pos + _FRAME.size <= len(data):
            magic, plen, crc = _FRAME.unpack_from(data, pos)
            if magic != MAGIC or plen < _RECORD.size or plen > _PAYLOAD_MAX:
                return
            end = pos + _FRAME.size + plen
            if end > len(data):
                return  # torn mid-payload
            payload = data[pos + _FRAME.size: end]
            if zlib.crc32(payload) != crc:
                return  # torn mid-frame, or bit rot
            rec_id, rows_after, kind, nrows = _RECORD.unpack_from(payload, 0)
            yield rec_id, rows_after, kind, nrows, payload[_RECORD.size:], end
            pos = end

    def _recover_tail(self) -> None:
        """The journal position (next_id, rows_total) from the newest
        segment holding a valid frame; a torn tail is truncated loudly."""
        for first_id, path in reversed(self._segments()):
            size = os.path.getsize(path)
            valid_end = 0
            last = None
            for rec in self._scan_segment(path):
                last = rec
                valid_end = rec[5]
            if valid_end < size:
                self._torn.inc()
                log.error("journal: TORN TAIL in %s: %d byte(s) after the last "
                          "CRC-valid frame truncated (a kill mid-append); every "
                          "complete record before it survives", path, size - valid_end)
                with open(path, "r+b") as fh:
                    fh.truncate(valid_end)
            if last is not None:
                self.next_id = last[0] + 1
                self.rows_total = last[1]
                return
            if valid_end == 0 and first_id != 0:
                # a fully torn empty segment: the position comes from the
                # previous segment's tail
                os.unlink(path)
                continue
            self.next_id = first_id
            return

    def _rotate_if_needed(self) -> None:
        if self._fh is not None and self._active_size < self.segment_bytes:
            return
        if self._fh is not None:
            self._fh.close()
        self._fh = open(self._seg_path(self.next_id), "ab")
        self._active_size = self._fh.tell()

    def disk_bytes(self) -> int:
        return sum(os.path.getsize(p) for _, p in self._segments())

    def _update_disk_gauge(self) -> None:
        self._disk_gauge.set(round(self._disk_bytes / (1024 * 1024), 3))

    def _enforce_max_bytes(self) -> None:
        """``--journalMaxMb`` is a hard ceiling: drop the oldest whole
        segments (never the active one), loudly: their rows can no longer
        be replayed."""
        if self._disk_bytes <= self.max_bytes:
            return
        for _, path in self._segments()[:-1]:
            if self._disk_bytes <= self.max_bytes:
                break
            size = os.path.getsize(path)
            os.unlink(path)
            self._disk_bytes -= size
            self._dropped_segments.inc()
            log.warning("journal: disk ceiling --journalMaxMb exceeded: dropped "
                        "oldest segment %s (%d bytes); rows in it are no longer "
                        "replayable (counted in journal.segments_dropped)",
                        os.path.basename(path), size)

    # -------------------------------------------------------------- append

    def append(self, items: list) -> None:
        """Journal one seam batch (a list of Status, or of ParsedBlocks).
        Empty batches are skipped; rows under replay suppression are not
        appended again (a batch of replayed head and fresh tail appends
        only the tail)."""
        rows = rows_of(items)
        if rows == 0:
            return
        with self._lock:
            if self._pending_replay:
                if rows <= self._pending_replay:
                    self._pending_replay -= rows
                    return
                items = drop_rows(items, self._pending_replay)
                self._pending_replay = 0
            kind, body, rows = _encode_items(items)
            payload = _RECORD.pack(self.next_id, self.rows_total + rows, kind,
                                   rows) + body
            self._rotate_if_needed()
            self._fh.write(_FRAME.pack(MAGIC, len(payload), zlib.crc32(payload)))
            self._fh.write(payload)
            self._fh.flush()
            self._active_size += _FRAME.size + len(payload)
            self._disk_bytes += _FRAME.size + len(payload)
            self.next_id += 1
            self.rows_total += rows
            self._appended.inc(rows)
            if self._active_size >= self.segment_bytes:
                self._enforce_max_bytes()
            self._update_disk_gauge()

    # ------------------------------------------------- dispatch-token cursor

    def push_dispatch(self) -> None:
        """Once a seam crossing, after ``append``: push the post-append
        position, or None while replay suppression is armed (a mid-replay
        batch's delivery must not move the committed cursor)."""
        with self._lock:
            if self._pending_replay > 0:
                self._inflight.append(None)
            else:
                self._inflight.append((self.next_id, self.rows_total))

    def pop_dispatch(self) -> None:
        """Once a delivered batch, at the OUTERMOST delivery wrapper, before
        any filter may skip it: deliveries come in dispatch order."""
        with self._lock:
            self._delivery_pos = self._inflight.popleft() if self._inflight else None

    def note_delivered(self) -> None:
        """At the INNERMOST delivery wrapper, which only admitted batches
        reach: commit the popped token."""
        with self._lock:
            pos = self._delivery_pos
            self._delivery_pos = None
            if pos is not None and pos[0] >= self._committed[0]:
                self._committed = pos
                self._replay_draining = False

    def drop_newest(self) -> None:
        """An empty batch was shed before dispatch: un-push its token (the
        scheduler is single-threaded, so the newest token is its)."""
        with self._lock:
            if self._inflight:
                self._inflight.pop()

    def clear_inflight(self) -> None:
        """An elastic re-formation discarded the fetch pipeline's in-flight
        deliveries wholesale (``drain_discard``): their tokens would strand
        and skew every later pairing. Drop them; the replay re-covers their
        rows."""
        with self._lock:
            self._inflight.clear()
            self._delivery_pos = None

    @property
    def save_allowed(self) -> bool:
        """False while a replay drains through the seam: a save now would
        stamp a cursor the weights do not cover yet."""
        with self._lock:
            return not self._replay_draining

    # -------------------------------------------------------------- replay

    def records_from(self, cursor: int):
        """(record_id, items) of every record with id >= cursor, in id
        order: a Status list, or a one-ParsedBlock list for a block record.
        A CRC failure mid-history raises: a silent partial replay would
        lose rows."""
        segments = self._segments()
        for i, (first_id, path) in enumerate(segments):
            next_first = segments[i + 1][0] if i + 1 < len(segments) else self.next_id
            if next_first <= cursor:
                continue
            expect = first_id
            for rec_id, _rows_after, kind, nrows, body, _end in self._scan_segment(path):
                expect = rec_id + 1
                if rec_id >= cursor:
                    yield rec_id, _decode_record(kind, nrows, body)
            if expect < next_first:
                raise RuntimeError(
                    f"journal segment {path} is corrupt mid-history (valid through "
                    f"record {expect - 1}, expected {next_first - 1}); replay would "
                    "silently lose rows"
                )

    def replay_from(self, cursor: int) -> "tuple[list, int]":
        """Every record with id >= cursor as queue items, with replay
        suppression armed for their rows. Returns (items, rows); counted in
        ``journal.replayed_rows``."""
        items: list = []
        for _rec_id, rec_items in self.records_from(cursor):
            items.extend(rec_items)
        rows = rows_of(items)
        with self._lock:
            self._pending_replay += rows
            # the restored weights hold exactly [0, cursor): re-base the
            # committed position and hold saves until the replay delivers
            self._committed = (cursor, self.rows_total - rows)
            self._replay_draining = rows > 0
        if rows:
            self._replayed.inc(rows)
        return items, rows

    def cancel_pending_replay(self) -> int:
        """Rows of an earlier replay still waiting to re-cross the seam; a
        new replay covers them, so the caller removes them from the queue
        front and their suppression is dropped."""
        with self._lock:
            stale = self._pending_replay
            self._pending_replay = 0
            return stale

    def rows_from(self, cursor: int) -> int:
        """Rows of the records with id >= cursor (headers only)."""
        rows = 0
        segments = self._segments()
        for i, (_first_id, path) in enumerate(segments):
            next_first = segments[i + 1][0] if i + 1 < len(segments) else self.next_id
            if next_first <= cursor:
                continue
            for rec_id, _ra, _kind, nrows, _body, _end in self._scan_segment(path):
                if rec_id >= cursor:
                    rows += nrows
        return rows

    # ---------------------------------------------------- checkpoint hooks

    def snapshot_for_checkpoint(self) -> dict:
        """The cursor a verified checkpoint stamps: every record with id <
        cursor is inside the saved weights (the committed position, not the
        tail)."""
        with self._lock:
            return {"cursor": self._committed[0], "rows": self._committed[1]}

    def retire_covered(self, cursor: int) -> int:
        """Unlink whole segments whose records are all < cursor (never the
        active one)."""
        segments = self._segments()
        retired = 0
        for i, (_first_id, path) in enumerate(segments[:-1]):
            if segments[i + 1][0] > cursor:
                break
            try:
                os.unlink(path)
            except OSError:
                log.warning("journal: could not retire %s", path)
                break
            retired += 1
        if retired:
            log.info("journal: retired %d segment(s) covered by verified checkpoint "
                     "cursor %d", retired, cursor)
            self._disk_bytes = self.disk_bytes()
            self._update_disk_gauge()
        return retired

    def reset(self) -> None:
        """Drop every journaled record (an elastic rejoin: this host's
        pre-departure rows were adopted by the survivors, and replaying them
        would train them twice). Record ids stay monotonic: the next append
        opens a fresh segment at ``next_id``, so cursors in older archives
        stay ordered. Also clears an armed replay suppression."""
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            for _first_id, path in self._segments():
                try:
                    os.unlink(path)
                except OSError:
                    pass
            self._active_size = 0
            self._pending_replay = 0
            self._inflight.clear()
            self._delivery_pos = None
            self._replay_draining = False
            self._committed = (self.next_id, self.rows_total)
            self._disk_bytes = self.disk_bytes()
            self._update_disk_gauge()
        log.warning("journal: RESET: all segments dropped, the next append starts a "
                    "fresh segment at id %d", self.next_id)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


# one journal a process: the app installs it, the seam and the delivery
# wrappers call the module-level hooks, tests uninstall
_JOURNAL: "IntakeJournal | None" = None


def install(directory: str, max_mb: int = 512) -> IntakeJournal:
    global _JOURNAL
    if _JOURNAL is not None:
        _JOURNAL.close()
    _JOURNAL = IntakeJournal(directory, max_mb=max_mb)
    log.info("intake journal ON: %s (max %d MB, position id=%d rows=%d)",
             directory, max_mb, _JOURNAL.next_id, _JOURNAL.rows_total)
    return _JOURNAL


def get() -> "IntakeJournal | None":
    return _JOURNAL


def uninstall() -> None:
    global _JOURNAL
    if _JOURNAL is not None:
        _JOURNAL.close()
    _JOURNAL = None


def record_intake(items: list) -> None:
    """THE intake seam hook (streaming/context.py only): append one drained
    batch and push its dispatch token; a no-op with no journal."""
    if _JOURNAL is not None:
        _JOURNAL.append(items)
        _JOURNAL.push_dispatch()


def snapshot_for_checkpoint() -> "dict | None":
    return _JOURNAL.snapshot_for_checkpoint() if _JOURNAL is not None else None
