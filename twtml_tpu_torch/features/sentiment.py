"""Lexicon sentiment labels for the streaming logistic learner
(counterpart of ``twtml_tpu/features/sentiment.py``).

The label is the JAX package's own definition: 1.0 when the ORIGINAL
tweet's text holds at least as many positive-lexicon words as negative ones
(lowercased ``[a-z']+`` tokens), else 0.0. ``sentiment_labels`` scores a
batch in one C scan (``native/fasthash.cpp`` ``lexicon_score_batch``, bound
in features/native.py) with the lexicons packed as UTF-16 units, offsets and
Java hash codes; rows with non-ASCII units, and every row when the native
library is unavailable, take the per-row Python labeler, which the C scan
equals on ASCII rows. ``sentiment_labels_from_units`` labels a parsed
block (``--ingest block``, no Status objects) from its ragged raw units by
the same scan and the same per-row fallback.
"""

from __future__ import annotations

import re

import numpy as np

from .featurizer import Status, encode_texts
from .hashing import java_string_hashcode

POSITIVE = frozenset(
    """good great awesome amazing love happy excellent fantastic wonderful best
    beautiful fun win winning cool nice brilliant perfect thanks thank glad
    excited super sweet favorite favourite enjoy enjoyed impressive stunning
    delightful positive success successful""".split()
)

NEGATIVE = frozenset(
    """bad terrible awful hate sad horrible worst ugly fail failing broken
    angry annoying disappointing disappointed poor boring gross nasty sucks
    suck wrong problem problems negative disaster painful worse useless""".split()
)

_WORD = re.compile(r"[a-z']+")


def sentiment_score(text: str) -> int:
    """#positive − #negative lexicon hits over lowercased word tokens."""
    words = _WORD.findall(text.lower())
    return sum(w in POSITIVE for w in words) - sum(w in NEGATIVE for w in words)


def sentiment_label(status: Status) -> float:
    """Binary label from the ORIGINAL tweet's text."""
    return 1.0 if sentiment_score(status.retweeted_status.text) >= 0 else 0.0


def _pack_lexicon(words: frozenset) -> tuple:
    """A lexicon as (concatenated UTF-16 units, int64 offsets, Java hash
    codes) for the C scorer."""
    ws = sorted(words)
    units = np.concatenate([np.frombuffer(w.encode("utf-16-le"), np.uint16) for w in ws])
    off = np.zeros(len(ws) + 1, np.int64)
    np.cumsum([len(w) for w in ws], out=off[1:])
    hashes = np.array([java_string_hashcode(w) for w in ws], np.int32)
    return units, off, hashes


_POS_PACKED = _pack_lexicon(POSITIVE)
_NEG_PACKED = _pack_lexicon(NEGATIVE)


def sentiment_labels(statuses: list, encoded=None) -> np.ndarray:
    """``sentiment_label`` of every status, batched: one C scan over the
    originals' UTF-16 units, the Python labeler for non-ASCII rows and
    when the library is unavailable. ``encoded``: the featurizer's
    (units, offsets) of the originals' texts, raw or lowercased (the C scan
    folds ASCII case), reused instead of a second encode."""
    from . import native

    n = len(statuses)
    out = None
    if n:
        if encoded is None:
            encoded = encode_texts([s.retweeted_status.text for s in statuses])
        out = native.lexicon_scores(encoded, n, _POS_PACKED, _NEG_PACKED)
    if out is None:
        return np.array([sentiment_label(s) for s in statuses], np.float32)
    score, ok = out
    labels = (score >= 0).astype(np.float32)
    for i in np.nonzero(ok == 0)[0]:
        labels[i] = sentiment_label(statuses[i])
    return labels


def sentiment_labels_from_units(units, offsets) -> np.ndarray:
    """The labels of ragged UTF-16 units (a parsed block's originals' raw
    texts, uint8 or uint16 units, int64 offsets [n+1]): the C scan for
    ASCII rows, the Python scorer for the others (and for every row when
    the library is unavailable); pre-lowered units score the same, since
    ``sentiment_score`` lowercases."""
    from . import native

    n = offsets.size - 1
    if n <= 0:
        return np.zeros((0,), np.float32)
    if units.dtype == np.uint8:
        units = units.astype(np.uint16)  # the C scan reads uint16 units
    out = native.lexicon_scores((units, offsets), n, _POS_PACKED, _NEG_PACKED)
    if out is None:
        score, ok = np.zeros((n,), np.int32), np.zeros((n,), np.uint8)
    else:
        score, ok = out
    labels = (score >= 0).astype(np.float32)
    for i in np.nonzero(ok == 0)[0]:
        text = units[offsets[i]: offsets[i + 1]].tobytes().decode("utf-16-le", "surrogatepass")
        labels[i] = 1.0 if sentiment_score(text) >= 0 else 0.0
    return labels
