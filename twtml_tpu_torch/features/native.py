"""ctypes loader of the native host sources the port's wire path runs
(counterpart of the loader half of ``twtml_tpu/features/native.py``).

``native/featurize.cpp`` (the one-pass featurize fill), ``native/
wireassemble.cpp`` (the packed-wire assembler, flat and group, with the
digram codec), ``native/wirecodec.cpp`` (the digram encoder, bound as
``digram_encode`` and linked into the assembler), ``native/fasthash.cpp``
(the host bigram hasher of ``--hashOn host`` and the lexicon sentiment
scorer of the logistic app) and ``native/tweetjson.cpp`` (the block
parsers of ``--ingest block``: ``parse_tweet_block`` and the zero-copy
wire emitter ``parse_tweet_block_wire``) are compiled with g++ at first
use into ``build/twtml_tpu_torch/`` at the repository root. The library is
named by a hash of its sources and flags, so an edited source builds a new
library beside the old one.

Concurrent builds (pytest workers, two apps) are safe: a process takes an
``fcntl`` lock on the library's lock file, builds to a temporary name of its
own and ``os.replace``s it into place. No process can load a half-written
library, and a process that waited on the lock finds the library built.

Degrade seam, as in the JAX package: no compiler, a failed build, a library
that will not load, or one that lacks an entry gives one warning, and the
caller runs the byte-identical numpy path. ``COUNTERS`` counts, per
process, the fills and packs that ran natively and those that degraded
(the native entry was wanted but unavailable); ``HASH_COUNTERS`` the same
for host hashing, whose degraded path is the Python per-tweet hasher;
``PARSE_COUNTERS`` the block parses by parser and each step of the block
parse's degrade chain, as in the JAX package: the wire emitter degrades to
the legacy C parser, which degrades to the Python ground truth
(``streaming/sources.py`` ``BlockParserMixin``), each step counted and
warned once a process.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import warnings
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCES = tuple(
    REPO / "native" / name
    for name in ("featurize.cpp", "wireassemble.cpp", "wirecodec.cpp", "fasthash.cpp",
                 "tweetjson.cpp")
)
BUILD_DIR = REPO / "build" / "twtml_tpu_torch"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread", "-Wall", "-Wextra")

COUNTERS = {
    "fills_native": 0, "fills_degraded": 0,
    "packs_native": 0, "packs_degraded": 0,
}
HASH_COUNTERS = {"hashes_native": 0, "hashes_degraded": 0}
PARSE_COUNTERS = {
    "parses_wire": 0, "parses_native": 0, "parses_python": 0,
    "wire_degraded": 0, "native_degraded": 0,
}

# the C data-loader's per-row text bound (kMaxTextUnits, native/tweetjson.cpp):
# a retweeted status whose text or full_text exceeds this many UTF-16 units
# makes its line a counted bad line in every block parser (C and Python)
MAX_TEXT_UNITS = 4096


def reset_counters() -> None:
    for counters in (COUNTERS, HASH_COUNTERS, PARSE_COUNTERS):
        for key in counters:
            counters[key] = 0


def library_path(build_dir=None) -> Path:
    """Where the library of the current sources and flags lives in
    ``build_dir`` (default ``BUILD_DIR``)."""
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for src in SOURCES:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    name = f"libtwtml_native-{digest.hexdigest()[:16]}.so"
    return Path(BUILD_DIR if build_dir is None else build_dir) / name


def build(build_dir=None) -> Path:
    """The native library in ``build_dir`` (default ``BUILD_DIR``), compiled
    first if it is not there. Raises RuntimeError when g++ is missing or
    fails."""
    path = library_path(build_dir)
    if path.exists():
        return path
    compiler = shutil.which("g++")
    if compiler is None:
        raise RuntimeError("g++ not found on PATH: the native host path is "
                           "built from native/*.cpp at first use")
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.with_name(path.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if path.exists():  # another process built it while this one waited
            return path
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        try:
            proc = subprocess.run(
                [compiler, *FLAGS, "-o", str(tmp), *map(str, SOURCES)],
                capture_output=True, text=True, timeout=300,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to build {path.name} "
                                   f"(exit {proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, path)
        finally:
            tmp.unlink(missing_ok=True)
    return path


# every pointer is c_void_p: the callers pass raw ``.ctypes.data`` integers
_ENTRIES = {
    # (units, unit_size, offsets [n+1] i64, cols_f64, cols_i64, col_order,
    #  n, b, n_bucket, now_ms, narrow, out_units, out_offsets [b+1] i32,
    #  out_numeric [b,4], out_label [b], out_mask [b]) -> max row length
    "featurize_wire": [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ],
    # (units/offsets/numeric/label/mask pointer arrays [k], k, s, n_sb, bl,
    #  unit_size, narrow_offsets, lut, forced_bucket, scratch, enc_lens,
    #  out, cap, out_enc_bucket) -> bytes written
    "wire_assemble": [ctypes.POINTER(ctypes.c_void_p)] * 5 + [ctypes.c_int64] * 6 + [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
    ],
}

# the entries of the codec and the block parsers, bound without a load-time
# warning (a library that predates them still serves the wire path): a
# caller that wants one it lacks degrades at first use, counted and warned
# there
_LATER_ENTRIES = {
    # (in, n, lut [65536], out, cap) -> bytes written, -1 past cap
    "digram_encode": [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64,
    ],
    # (buf, len, begin, end, cap_rows, cap_units, out_numeric [rows, 5] i64,
    #  out_units u16, out_offsets [rows+1] i64, out_ascii [rows] u8,
    #  consumed, bad_lines) -> rows
    "parse_tweet_block": [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ],
    # the same, with two unit buffers (u8, u16) and two outputs after the
    # counts: narrow (the u8 buffer holds the units) and needs_wide
    "parse_tweet_block_wire": [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ],
}


# (units u16, offsets [n+1] i64, n, num_features, l_max, out_idx [b, l_max]
#  i32, out_val [b, l_max] f32, out_ntok [b] i32, n_threads) -> max distinct
# terms a row; bound without a load-time warning (the wire path's stale
# libraries predate it): a library without it warns at first use
_HASH_ENTRY = ("fasthash_batch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
    ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int32,
])

# (units u16, offsets [n+1] i64, n, then per lexicon (words u16, word
#  offsets i64, word hashes i32, count), out_score [n] i32, out_ok [n] u8);
# returns nothing. Bound like fasthash_batch: a library without it scores in
# Python
_LEXICON_ENTRY = ("lexicon_score_batch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
    ctypes.c_void_p, ctypes.c_void_p,
])


class NativeLibrary:
    """A loaded native library with its entries bound. An entry of the
    wire path the library lacks (a stale build) is None, with one warning;
    a missing ``fasthash_batch``, ``lexicon_score_batch``, codec encoder or
    block parser is None, and warns where it is wanted."""

    def __init__(self, path) -> None:
        self.path = Path(path)
        cdll = ctypes.CDLL(str(self.path))
        for (name, argtypes), restype in ((_HASH_ENTRY, ctypes.c_int32),
                                          (_LEXICON_ENTRY, None),
                                          *((e, ctypes.c_int64) for e in _LATER_ENTRIES.items())):
            fn = getattr(cdll, name, None)
            if fn is not None:
                fn.restype = restype
                fn.argtypes = argtypes
            setattr(self, name, fn)
        for name, argtypes in _ENTRIES.items():
            fn = getattr(cdll, name, None)
            if fn is None:
                warnings.warn(
                    f"native library {self.path.name} lacks {name}: that "
                    "stage runs the byte-identical numpy path (delete the "
                    "library to rebuild it)", RuntimeWarning, stacklevel=2,
                )
            else:
                fn.restype = ctypes.c_int64
                fn.argtypes = argtypes
            setattr(self, name, fn)


@functools.cache
def get_lib() -> NativeLibrary | None:
    """The process's native library, built in ``BUILD_DIR`` at first use;
    None (one warning) when it cannot be built or loaded."""
    try:
        return NativeLibrary(build())
    except (RuntimeError, OSError, subprocess.TimeoutExpired) as exc:
        warnings.warn(f"native library unavailable ({exc}); host featurize "
                      "and pack run the numpy path", RuntimeWarning, stacklevel=2)
        return None


def featurize_available() -> bool:
    lib = get_lib()
    return lib is not None and lib.featurize_wire is not None


def assemble_available() -> bool:
    lib = get_lib()
    return lib is not None and lib.wire_assemble is not None


def featurize_wire_raw(*args) -> int | None:
    """The one-pass featurize entry on raw pointers (``args`` are the C
    signature's 16 values, every pointer a plain int or None). Returns the
    max row length, or None when the entry is unavailable or refuses the
    input (offsets past ``n_bucket``)."""
    lib = get_lib()
    if lib is None or lib.featurize_wire is None:
        return None
    max_len = lib.featurize_wire(*args)
    return None if max_len < 0 else int(max_len)


def wire_assemble(fields_per_batch, narrow: bool, out, lut=None, scratch=None,
                  enc_lens=None, shards: int = 1,
                  forced_bucket: int = 0) -> "tuple[int, int] | None":
    """One C pass from K ragged batches' five field arrays (units, offsets,
    numeric, label, mask each) to the packed wire in ``out``: the flat
    layout for K = 1, the group layout's K segments otherwise, shard-major
    over ``shards`` S shard-aligned segments ([S, K, segment]). With the
    pair ``lut`` (features/wirecodec.py) every segment's units are
    digram-coded into ``scratch`` (S·K x a segment's units bytes;
    ``enc_lens`` int64 [S·K]) and laid down in one shared bucket, or
    shipped raw when that bucket is not smaller; ``forced_bucket`` > 0 is a
    bucket the ranks of a multi-host group agreed. Returns (bytes written,
    codec bucket: 0 for raw units), or None when the entry is unavailable
    or refuses the input (a length delta past uint16, ``out`` too small, a
    segment past the forced bucket)."""
    lib = get_lib()
    if lib is None or lib.wire_assemble is None:
        return None
    k = len(fields_per_batch)
    ptrs = [(ctypes.c_void_p * k)(*(f[i].ctypes.data for f in fields_per_batch))
            for i in range(5)]
    units, mask = fields_per_batch[0][0], fields_per_batch[0][4]
    enc_bucket = ctypes.c_int64(0)
    total = lib.wire_assemble(
        *ptrs, k, int(shards), int(units.shape[0]) // shards, int(mask.shape[0]) // shards,
        int(units.dtype.itemsize), 1 if narrow else 0,
        None if lut is None else lut.ctypes.data, int(forced_bucket),
        None if scratch is None else scratch.ctypes.data,
        None if enc_lens is None else enc_lens.ctypes.data,
        out.ctypes.data, int(out.shape[0]), ctypes.byref(enc_bucket),
    )
    return None if total < 0 else (int(total), int(enc_bucket.value))


_warned_no_encode: list[bool] = []


def digram_encode(buf: np.ndarray, lut: np.ndarray) -> np.ndarray | None:
    """The C greedy digram encode of a uint8 buffer (features/wirecodec.py
    holds the dictionary and the byte-identical numpy encoder), or None
    when the entry is unavailable (a library without it warns once a
    process): the caller runs ``encode_np``. The output never exceeds the
    input (a pair shrinks, a literal copies), so a buffer of the input's
    size always holds it."""
    lib = get_lib()
    if lib is None:
        return None
    if lib.digram_encode is None:
        if not _warned_no_encode:
            _warned_no_encode.append(True)
            warnings.warn(f"native library {lib.path.name} lacks digram_encode: the codec "
                          "encodes with numpy (delete the library to rebuild it)",
                          RuntimeWarning, stacklevel=2)
        return None
    n = int(buf.shape[0])
    out = np.empty((n,), np.uint8)
    m = lib.digram_encode(buf.ctypes.data, n, lut.ctypes.data, out.ctypes.data, n)
    if m < 0:
        raise RuntimeError("digram_encode overflowed its full-size buffer")
    return out[:m].copy()


def wire_available() -> bool:
    """Whether the zero-copy wire emitter (``parse_tweet_block_wire``) loads."""
    lib = get_lib()
    return lib is not None and lib.parse_tweet_block_wire is not None


_warned_parse: set = set()


def note_parse_degraded(step: str, why: str) -> None:
    """Count one step down the block parse's degrade chain (``wire``: the
    wire emitter was wanted and the legacy C parser ran; ``native``: a C
    parser was wanted and the Python ground truth ran) and warn once a
    process for each step."""
    PARSE_COUNTERS[f"{step}_degraded"] += 1
    if step not in _warned_parse:
        _warned_parse.add(step)
        warnings.warn(f"block parse degraded ({step}): {why}", RuntimeWarning, stacklevel=3)


def _parse_capacity(n: int) -> tuple[int, int]:
    """(rows, units) capacity of a block parse of ``n`` bytes: rows from an
    over-provision (real tweet lines are hundreds of bytes; shorter ones
    stop the parser early and the caller continues from ``consumed``), and
    units past the input size plus one full row of headroom, which the
    parser reserves before each line."""
    return max(16, n >> 6), n + MAX_TEXT_UNITS + 1


def _block_out(numeric, units, offsets, ascii_flags, rows, consumed, bad):
    """The parse's tuple: copies of the filled parts of the worst-case-sized
    buffers, then the consumed bytes and the bad lines."""
    total = int(offsets[rows]) if rows else 0
    arrays = (numeric[:rows], units[:total], offsets[: rows + 1], ascii_flags[:rows])
    return (*(a.copy() for a in arrays), int(consumed.value), int(bad.value))


def parse_tweet_block(data: bytes, begin: int, end: int) -> tuple | None:
    """Parse newline-delimited tweet JSON with the C data-loader, applying
    the isRetweet and ``[begin, end]`` retweet-count filter in line:
    (numeric int64 [rows, 5] = {label, followers, favourites, friends,
    created_ms}, units uint16, offsets int64 [rows+1], ascii uint8 [rows],
    consumed bytes, bad lines), or None when the entry is unavailable (the
    caller runs the Python ground truth)."""
    lib = get_lib()
    if lib is None or lib.parse_tweet_block is None:
        return None
    n = len(data)
    cap_rows, cap_units = _parse_capacity(n)
    numeric = np.empty((cap_rows, 5), np.int64)
    units = np.empty((cap_units,), np.uint16)
    offsets = np.empty((cap_rows + 1,), np.int64)
    ascii_flags = np.empty((cap_rows,), np.uint8)
    consumed, bad = ctypes.c_int64(0), ctypes.c_int64(0)
    rows = lib.parse_tweet_block(
        data, n, begin, end, cap_rows, cap_units, numeric.ctypes.data,
        units.ctypes.data, offsets.ctypes.data, ascii_flags.ctypes.data,
        ctypes.byref(consumed), ctypes.byref(bad),
    )
    return _block_out(numeric, units, offsets, ascii_flags, rows, consumed, bad)


def parse_tweet_block_wire(data: bytes, begin: int, end: int) -> tuple | None:
    """One C pass from raw block bytes to the ragged wire's units: the same
    rows, numeric columns, offsets and ascii flags as ``parse_tweet_block``,
    with the units uint8 whenever every kept row is ASCII (the narrow wire,
    no downcast pass) and uint16 otherwise (the parser widens its committed
    prefix once, when the first non-ASCII row commits). The same tuple, or
    None when the entry is unavailable (the caller runs the legacy
    parser). The wide buffer is allocated but stays untouched unless a row
    widens."""
    lib = get_lib()
    if lib is None or lib.parse_tweet_block_wire is None:
        return None
    n = len(data)
    cap_rows, cap_units = _parse_capacity(n)
    numeric = np.empty((cap_rows, 5), np.int64)
    units_u8 = np.empty((cap_units,), np.uint8)
    units_u16 = np.empty((cap_units,), np.uint16)
    offsets = np.empty((cap_rows + 1,), np.int64)
    ascii_flags = np.empty((cap_rows,), np.uint8)
    consumed, bad = ctypes.c_int64(0), ctypes.c_int64(0)
    narrow, needs_wide = ctypes.c_int64(0), ctypes.c_int64(0)
    rows = lib.parse_tweet_block_wire(
        data, n, begin, end, cap_rows, cap_units, numeric.ctypes.data,
        units_u8.ctypes.data, units_u16.ctypes.data, offsets.ctypes.data,
        ascii_flags.ctypes.data, ctypes.byref(consumed), ctypes.byref(bad),
        ctypes.byref(narrow), ctypes.byref(needs_wide),
    )
    if needs_wide.value:  # a wide buffer is always given
        raise RuntimeError("wire parser requested a wide buffer it was given")
    units = units_u8 if narrow.value else units_u16
    return _block_out(numeric, units, offsets, ascii_flags, rows, consumed, bad)


_warned_no_hash: list[bool] = []


def hash_available() -> bool:
    """Whether host hashing runs natively; a library without
    ``fasthash_batch`` (a stale build) warns once a process."""
    lib = get_lib()
    if lib is None:
        return False
    if lib.fasthash_batch is None and not _warned_no_hash:
        _warned_no_hash.append(True)
        warnings.warn(f"native library {lib.path.name} lacks fasthash_batch: host hashing "
                      "runs the Python path (delete the library to rebuild it)",
                      RuntimeWarning, stacklevel=2)
    return lib.fasthash_batch is not None


def hash_texts(units, offsets, n: int, num_features: int, out_idx, out_val):
    """Hash ``n`` lowercased texts (their UTF-16 ``units`` and int64
    ``offsets``) into the caller's zeroed [B, L] ``out_idx`` (int32) and
    ``out_val`` (float32) with ``native/fasthash.cpp``. Returns the per-row
    distinct-term counts, or None when the entry is unavailable, L was too
    small, or a row overflowed the C scratch table: the caller then runs
    the Python hasher."""
    if not hash_available():
        return None
    lib = get_lib()
    b, l_max = out_idx.shape
    if not (out_idx.dtype == np.int32 and out_val.dtype == np.float32 and n <= b
            and out_val.shape == out_idx.shape and out_idx.flags.c_contiguous
            and out_val.flags.c_contiguous and offsets.dtype == np.int64
            and units.dtype == np.uint16 and units.flags.c_contiguous
            and offsets.flags.c_contiguous and offsets.shape[0] == n + 1):
        raise ValueError("hash_texts: buffers of the wrong dtype, shape or layout")
    ntok = np.zeros(b, dtype=np.int32)
    try:
        threads = int(os.environ.get("TWTML_NATIVE_THREADS", "0"))
    except ValueError:
        threads = 0
    max_terms = lib.fasthash_batch(
        units.ctypes.data, offsets.ctypes.data, n, num_features, l_max,
        out_idx.ctypes.data, out_val.ctypes.data, ntok.ctypes.data, threads,
    )
    if max_terms > l_max or (ntok[:n] < 0).any():
        return None
    return ntok


def lexicon_scores(encoded, n: int, pos_lex: tuple, neg_lex: tuple):
    """Lexicon sentiment scores of ``n`` texts, their UTF-16 ``encoded``
    (units, int64 offsets [n+1]), with ``native/fasthash.cpp``
    ``lexicon_score_batch``: (scores int32 [n], ok uint8 [n]), where ok 0
    marks a row with non-ASCII units, which the caller scores in Python.
    ``pos_lex``/``neg_lex`` are (words' units, offsets, Java hash codes)
    (features/sentiment.py). None when the entry is unavailable."""
    lib = get_lib()
    if lib is None or lib.lexicon_score_batch is None:
        return None
    units, offsets = (np.ascontiguousarray(a) for a in encoded)
    if units.dtype != np.uint16 or offsets.dtype != np.int64 or offsets.shape != (n + 1,):
        raise ValueError("lexicon_scores: units must be uint16 and offsets int64 [n + 1]")
    score = np.empty((n,), np.int32)
    ok = np.empty((n,), np.uint8)
    (pw, po, ph), (nw, no, nh) = pos_lex, neg_lex
    lib.lexicon_score_batch(
        units.ctypes.data, offsets.ctypes.data, n,
        pw.ctypes.data, po.ctypes.data, ph.ctypes.data, len(ph),
        nw.ctypes.data, no.ctypes.data, nh.ctypes.data, len(nh),
        score.ctypes.data, ok.ctypes.data,
    )
    return score, ok
