"""ctypes loader of the native host sources the port's wire path runs
(counterpart of the loader half of ``twtml_tpu/features/native.py``).

``native/featurize.cpp`` (the one-pass featurize fill), ``native/
wireassemble.cpp`` (the packed-wire assembler), ``native/wirecodec.cpp``
(the digram encoder the assembler links against) and ``native/
fasthash.cpp`` (the host bigram hasher of ``--hashOn host``) are compiled
with g++ at first use into ``build/twtml_tpu_torch/`` at the repository
root. The library is named by a hash of its sources and flags, so an
edited source builds a new library beside the old one.

Concurrent builds (pytest workers, two apps) are safe: a process takes an
``fcntl`` lock on the library's lock file, builds to a temporary name of its
own and ``os.replace``s it into place. No process can load a half-written
library, and a process that waited on the lock finds the library built.

Degrade seam, as in the JAX package: no compiler, a failed build, a library
that will not load, or one that lacks an entry gives one warning, and the
caller runs the byte-identical numpy path. ``COUNTERS`` counts, per
process, the fills and packs that ran natively and those that degraded
(the native entry was wanted but unavailable); ``HASH_COUNTERS`` the same
for host hashing, whose degraded path is the Python per-tweet hasher.
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
    for name in ("featurize.cpp", "wireassemble.cpp", "wirecodec.cpp", "fasthash.cpp")
)
BUILD_DIR = REPO / "build" / "twtml_tpu_torch"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread", "-Wall", "-Wextra")

COUNTERS = {
    "fills_native": 0, "fills_degraded": 0,
    "packs_native": 0, "packs_degraded": 0,
}
HASH_COUNTERS = {"hashes_native": 0, "hashes_degraded": 0}


def reset_counters() -> None:
    for counters in (COUNTERS, HASH_COUNTERS):
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


# (units u16, offsets [n+1] i64, n, num_features, l_max, out_idx [b, l_max]
#  i32, out_val [b, l_max] f32, out_ntok [b] i32, n_threads) -> max distinct
# terms a row; bound without a load-time warning (the wire path's stale
# libraries predate it): a library without it warns at first use
_HASH_ENTRY = ("fasthash_batch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
    ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int32,
])


class NativeLibrary:
    """A loaded native library with its entries bound. An entry of the
    wire path the library lacks (a stale build) is None, with one warning;
    a missing ``fasthash_batch`` is None, and warns where it is wanted."""

    def __init__(self, path) -> None:
        self.path = Path(path)
        cdll = ctypes.CDLL(str(self.path))
        name, argtypes = _HASH_ENTRY
        fn = getattr(cdll, name, None)
        if fn is not None:
            fn.restype = ctypes.c_int32
            fn.argtypes = argtypes
        self.fasthash_batch = fn
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


def wire_assemble(units, offsets, numeric, label, mask, narrow: bool, out) -> int | None:
    """One C pass from one ragged batch's five field arrays to the flat
    packed wire in ``out`` (the k = 1, s = 1 form of the entry, no codec).
    Returns the bytes written, or None when the entry is unavailable or
    refuses the input (a length delta past uint16, ``out`` too small)."""
    lib = get_lib()
    if lib is None or lib.wire_assemble is None:
        return None

    def one(a):
        return (ctypes.c_void_p * 1)(a.ctypes.data)

    enc_bucket = ctypes.c_int64(0)
    total = lib.wire_assemble(
        one(units), one(offsets), one(numeric), one(label), one(mask),
        1, 1, int(units.shape[0]), int(mask.shape[0]), int(units.dtype.itemsize),
        1 if narrow else 0, None, 0, None, None,
        out.ctypes.data, int(out.shape[0]), ctypes.byref(enc_bucket),
    )
    return None if total < 0 else int(total)


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
