"""Columnar tweet blocks: the block parser's output format (counterpart of
``twtml_tpu/features/blocks.py``).

A ``ParsedBlock`` is a filtered batch of tweets in columnar form, straight
from the C parser (``native/tweetjson.cpp``): the numeric fields the
featurizer reads, plus the original tweets' texts as concatenated UTF-16
code units. No per-tweet Python object is built between the bytes and the
featurizer: ``Featurizer.featurize_parsed_block`` turns one block (or
several merged) into the wire's batch.

The object path (``ReplayFileSource`` -> ``Status`` -> featurize) is the
semantic ground truth; the tests hold the two paths to equal batches.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

# columns of ParsedBlock.numeric (int64), in parser output order
COL_LABEL = 0  # retweeted status' retweet_count (the label)
COL_FOLLOWERS = 1
COL_FAVOURITES = 2
COL_FRIENDS = 3
COL_CREATED_MS = 4


class ParsedBlock(NamedTuple):
    """Filtered, columnar tweets. ``numeric`` is int64 [rows, 5] (see COL_*),
    ``units`` the concatenated UTF-16 code units of the original texts (NOT
    lowercased), ``offsets`` int64 [rows+1] into units, ``ascii`` uint8
    [rows] (1 = every unit < 128, so ASCII pad-time folding suffices).

    ``units`` is uint16, or **uint8** straight from the zero-copy wire
    parser (``native.parse_tweet_block_wire``) when every row is ASCII —
    the ragged wire's narrow dtype, carried from the parser so no
    downstream downcast pass exists. The values are the same code units
    either way; ``merge_blocks`` of mixed-dtype blocks promotes to uint16
    (numpy concatenate), which is exactly the non-ASCII wire dtype."""

    numeric: np.ndarray
    units: np.ndarray
    offsets: np.ndarray
    ascii: np.ndarray

    @property
    def rows(self) -> int:
        return int(self.numeric.shape[0])


def slice_block(block: ParsedBlock, start: int, stop: int) -> ParsedBlock:
    """Rows [start, stop) as a standalone block (offsets re-based)."""
    return ParsedBlock(
        block.numeric[start:stop],
        block.units[block.offsets[start] : block.offsets[stop]],
        block.offsets[start : stop + 1] - block.offsets[start],
        block.ascii[start:stop],
    )


def iter_row_chunks(blocks, rows: int):
    """Regroup a stream of ParsedBlocks into blocks of exactly ``rows`` rows
    (the final chunk may be short) — the micro-batch slicer between the
    native parser's IO-sized blocks and the learner's fixed batch shape.
    Consumes ``blocks`` lazily, so it composes with a parser running on
    another thread (the parse/featurize/train pipeline)."""
    pending: list[ParsedBlock] = []
    have = 0
    for b in blocks:
        if b.rows == 0:
            continue
        pending.append(b)
        have += b.rows
        while have >= rows:
            take, acc = rows, []
            while take:
                head = pending[0]
                if head.rows <= take:
                    acc.append(pending.pop(0))
                    take -= head.rows
                else:
                    acc.append(slice_block(head, 0, take))
                    pending[0] = slice_block(head, take, head.rows)
                    take = 0
            have -= rows
            yield merge_blocks(acc)
    if have:
        yield merge_blocks(pending)


def empty_block() -> ParsedBlock:
    """A zero-row block (a replay file where no line passed the filter)."""
    return ParsedBlock(
        np.zeros((0, 5), np.int64),
        np.zeros((0,), np.uint16),
        np.zeros((1,), np.int64),
        np.zeros((0,), np.uint8),
    )


def merge_blocks(blocks: "list[ParsedBlock]") -> ParsedBlock:
    """Concatenate blocks drained from one micro-batch interval; an empty
    list merges to a zero-row block."""
    if not blocks:
        return empty_block()
    if len(blocks) == 1:
        return blocks[0]
    numeric = np.concatenate([b.numeric for b in blocks], axis=0)
    units = np.concatenate([b.units for b in blocks])
    sizes = [b.offsets[-1] for b in blocks]
    offsets = [blocks[0].offsets]
    base = sizes[0]
    for b, size in zip(blocks[1:], sizes[1:]):
        offsets.append(b.offsets[1:] + base)
        base += size
    return ParsedBlock(
        numeric,
        units,
        np.concatenate(offsets),
        np.concatenate([b.ascii for b in blocks]),
    )
