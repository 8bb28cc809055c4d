"""Digram dictionary codec of the ragged units wire (``--wireCodec dict``;
counterpart of ``twtml_tpu/features/wirecodec.py``, its tables and streams
byte for byte).

A byte-pair (digram) substitution code over the uint8 (all-ASCII) ragged
units buffer, with a STATIC 128-entry dictionary, so the decode table is a
constant on the device and no table bytes ride the wire. Input bytes are
ASCII (< 0x80, the narrow wire's metadata gate, features/batch.py), so
output bytes 0x00..0x7F are literals (one unit each) and 0x80..0xFF are
dictionary codes (two units each, from ``decode_table()``). Encoding is
greedy left-to-right maximal munch: the sequential C loop
(``native/wirecodec.cpp`` ``digram_encode``) and the vectorized numpy
run-parity form below emit the same stream.

Decode is a bounded gather-expand plus a cumsum: on the device
``ops/ragged.units_from_codes`` (torch ops), on the host ``decode_np``
here. Decoded units equal the uncompressed wire's bytes, the zero tail
included (the dictionary's entry 0 is ``"\\x00\\x00"``, so bucket
padding halves too). The codec changes the wire's representation only,
never features, order or rounding.
"""

from __future__ import annotations

import numpy as np

# first byte value of the two-unit dictionary codes; 0x00..0x7F stay literal
CODE_BASE = 128

# the compressed buffer rounds up to this multiple: same program-count
# argument as features/batch.RAGGED_UNIT_MULTIPLE (compressed totals
# concentrate like raw totals), finer-grained because the codec also runs
# per shard/group segment where buffers are smaller
CODEC_UNIT_MULTIPLE = 1024

# The static dictionary: 128 digrams of ASCII tweet text. Entry 0 is the
# zero-pair (bucket-padding tail); then English letter digrams by corpus
# frequency, and the t.co link fragments every retweet body carries
# ("https://t.co/…" under greedy left-to-right pairing hits "ht tp s: //
# t. co"). Quality here moves the RATIO only — parity never depends on the
# dictionary, and changing it is wire-compatible per run (both ends read
# this one table) but NOT across a mixed-version fleet; treat the list as
# frozen like a wire format.
_DIGRAMS: "tuple[bytes, ...]" = (
    b"\x00\x00",
    b"e ", b" t", b"th", b"he", b"s ", b" a", b"t ", b"in", b"d ", b"er",
    b"an", b" s", b"on", b"re", b" w", b"at", b"en", b" o", b"or", b"es",
    b" i", b"is", b"te", b"it", b" b", b"ar", b"nd", b" m", b"ou", b" h",
    b"ed", b"to", b"nt", b" f", b"as", b"st", b" c", b"io", b"ng", b"le",
    b"al", b"me", b"ve", b"y ", b" p", b"co", b"ro", b"ll", b"ea", b"se",
    b"of", b"no", b"f ", b" d", b"ha", b"ne", b"ur", b"ni", b"ti", b"ri",
    b"hi", b"o ", b"r ", b"n ", b"a ", b"g ", b"ho", b"ma", b"li", b"om",
    b"ce", b"ow", b"us", b"ut", b"ac", b"el", b"la", b"ta", b"wh", b"be",
    b"wa", b"un", b"wi", b"et", b"ad", b"ch", b"fo", b"de", b"pe", b"ee",
    b"ld", b"ca", b"ra", b"so", b"do", b"yo", b"sh", b"we", b"ai", b"lo",
    b"im", b"oo", b"pr", b"mo", b"su", b"id", b"ge", b"em", b"tt", b"ay",
    b"ke", b"am", b"ic", b"il", b"gh", b"ig", b"ot",
    b"ht", b"tp", b"s:", b"//", b"t.", b".c", b"o/",
    b", ", b". ", b"'s",
)

_lut: "np.ndarray | None" = None
_table: "np.ndarray | None" = None


def _build_tables() -> "tuple[np.ndarray, np.ndarray]":
    """(pair LUT uint8[65536], decode table uint8[128, 2]) from the static
    dictionary. LUT[(b0 << 8) | b1] is the dictionary index, 0xFF = no
    code (literal). Built once; validates the frozen-list invariants."""
    global _lut, _table
    if _lut is not None and _table is not None:
        return _lut, _table
    assert len(_DIGRAMS) == CODE_BASE, len(_DIGRAMS)
    assert len(set(_DIGRAMS)) == CODE_BASE, "duplicate dictionary digram"
    table = np.zeros((CODE_BASE, 2), np.uint8)
    lut = np.full((65536,), 0xFF, np.uint8)
    for i, pair in enumerate(_DIGRAMS):
        assert len(pair) == 2 and max(pair) < CODE_BASE, pair
        table[i, 0], table[i, 1] = pair[0], pair[1]
        lut[(pair[0] << 8) | pair[1]] = i
    _lut, _table = lut, table
    return lut, table


def pair_lut() -> np.ndarray:
    """uint8[65536] digram → code index (0xFF = literal) — the one table
    both encoders (numpy below, C ``digram_encode``) read."""
    return _build_tables()[0]


def decode_table() -> np.ndarray:
    """uint8[128, 2] code → its two units — the decode-side constant
    (cached on each device by ``ops/ragged.units_from_codes``)."""
    return _build_tables()[1]


def encode_np(buf: np.ndarray) -> np.ndarray:
    """Greedy digram encode, vectorized numpy — the ground truth.

    Greedy maximal munch has a sequential look ("pair here consumes the
    next byte"), but with a STATIC dictionary it reduces to run parity:
    within each maximal run of consecutive hit positions (positions whose
    byte pair is in the dictionary), greedy takes exactly the pairs at
    EVEN offsets from the run start — every run start is provably arrived
    at (the preceding position either emitted a literal and stepped 1, or
    closed a pair of the previous run and stepped past it), so the whole
    decision is position arithmetic over runs. That makes the encode three
    vectorized passes over the buffer, never a per-byte Python loop.
    """
    b = np.ascontiguousarray(buf).reshape(-1)
    if b.dtype != np.uint8:
        raise TypeError("digram codec encodes the uint8 (ASCII) units wire")
    n = b.shape[0]
    if n < 2:
        return b.copy()
    lut = pair_lut()
    cand = lut[(b[:-1].astype(np.uint16) << 8) | b[1:]]  # [n-1]
    hit = cand != 0xFF
    idx = np.arange(n - 1, dtype=np.int64)
    run_start = hit & ~np.concatenate(([False], hit[:-1]))
    start_of = np.maximum.accumulate(np.where(run_start, idx, -1))
    taken = hit & (((idx - start_of) & 1) == 0)
    # emit = every position not consumed as a pair's second byte
    second = np.concatenate(([False], taken))  # [n]
    taken_full = np.concatenate((taken, [False]))  # [n]
    emit = ~second
    cand_full = np.concatenate((cand, [0]))
    out = np.where(
        taken_full[emit],
        cand_full[emit].astype(np.int16) + CODE_BASE,
        b[emit],
    )
    return out.astype(np.uint8)


def encode(buf: np.ndarray) -> np.ndarray:
    """Greedy digram encode — the C fast path when the native library
    carries ``digram_encode`` (native/wirecodec.cpp; byte-identical to
    ``encode_np`` — same algorithm, same LUT, differential-tested), the
    numpy ground truth otherwise. One pass over the units at memcpy-class
    speed, riding the native ingest machinery like every fast path."""
    b = np.ascontiguousarray(buf).reshape(-1)
    if b.dtype != np.uint8:
        raise TypeError("digram codec encodes the uint8 (ASCII) units wire")
    if b.shape[0] >= 2:
        from . import native

        out = native.digram_encode(b, pair_lut())
        if out is not None:
            return out
    return encode_np(b)


def decode_np(codes: np.ndarray, out_len: int) -> np.ndarray:
    """Host twin of ``ops/ragged.units_from_codes``: code stream(s) →
    the first ``out_len`` expanded units, uint8. Accepts a leading batch
    axis ([..., M] → [..., out_len]) like the device decode. Trailing
    padding codes past ``out_len`` are never read — the encoder zero-pads
    the bucketed stream with literal codes, exactly like the raw wire's
    zero tail."""
    c = np.asarray(codes)
    lead = c.shape[:-1]
    if out_len == 0 or c.shape[-1] == 0:
        if out_len:
            raise ValueError(f"empty code stream; {out_len} units requested")
        return np.zeros(lead + (0,), np.uint8)
    c2 = c.reshape(-1, c.shape[-1]).astype(np.int64)
    table = decode_table()
    out = np.empty((c2.shape[0], out_len), np.uint8)
    t = np.arange(out_len, dtype=np.int64)
    for r in range(c2.shape[0]):
        row = c2[r]
        lens = 1 + (row >= CODE_BASE).astype(np.int64)
        ends = np.cumsum(lens)
        if out_len and (ends.size == 0 or ends[-1] < out_len):
            raise ValueError(
                f"code stream expands to {int(ends[-1]) if ends.size else 0}"
                f" units; {out_len} requested"
            )
        j = np.searchsorted(ends, t, side="right")
        k = t - (ends[j] - lens[j])
        cj = row[j]
        exp = table[np.clip(cj - CODE_BASE, 0, CODE_BASE - 1), k]
        out[r] = np.where(cj < CODE_BASE, cj, exp).astype(np.uint8)
    return out.reshape(lead + (out_len,))


def encoded_bucket(m: int) -> int:
    """Compressed-buffer bucket: round up to CODEC_UNIT_MULTIPLE (program
    count stays finite, like the raw wire's RAGGED_UNIT_MULTIPLE)."""
    return max(
        CODEC_UNIT_MULTIPLE,
        -(-int(m) // CODEC_UNIT_MULTIPLE) * CODEC_UNIT_MULTIPLE,
    )


def encode_bucketed(buf: np.ndarray) -> "np.ndarray | None":
    """Encode + zero-pad to the codec bucket, or None when the bucketed
    encoding is not strictly smaller than the raw buffer — the
    incompressible fallback (caller ships the raw wire and counts it,
    like the int32 offset fallback)."""
    raw = np.ascontiguousarray(buf).reshape(-1)
    codes = encode(raw)
    bucket = encoded_bucket(codes.shape[0])
    if bucket >= raw.shape[0]:
        return None
    out = np.zeros((bucket,), np.uint8)
    out[: codes.shape[0]] = codes
    return out
