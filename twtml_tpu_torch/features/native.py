"""ctypes loader of the native host sources the port's wire path runs
(counterpart of the loader half of ``twtml_tpu/features/native.py``).

``native/featurize.cpp`` (the one-pass featurize fill), ``native/
wireassemble.cpp`` (the packed-wire assembler) and ``native/wirecodec.cpp``
(the digram encoder the assembler links against) are compiled with g++ at
first use into ``build/twtml_tpu_torch/`` at the repository root. The
library is named by a hash of its sources and flags, so an edited source
builds a new library beside the old one.

Concurrent builds (pytest workers, two apps) are safe: a process takes an
``fcntl`` lock on the library's lock file, builds to a temporary name of its
own and ``os.replace``s it into place. No process can load a half-written
library, and a process that waited on the lock finds the library built.

Degrade seam, as in the JAX package: no compiler, a failed build, a library
that will not load, or one that lacks an entry gives one warning, and the
caller runs the byte-identical numpy path. ``COUNTERS`` counts, per
process, the fills and packs that ran natively and those that degraded
(the native entry was wanted but unavailable).
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

REPO = Path(__file__).resolve().parents[2]
SOURCES = tuple(
    REPO / "native" / name
    for name in ("featurize.cpp", "wireassemble.cpp", "wirecodec.cpp")
)
BUILD_DIR = REPO / "build" / "twtml_tpu_torch"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-Wall", "-Wextra")

COUNTERS = {
    "fills_native": 0, "fills_degraded": 0,
    "packs_native": 0, "packs_degraded": 0,
}


def reset_counters() -> None:
    for key in COUNTERS:
        COUNTERS[key] = 0


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


class NativeLibrary:
    """A loaded native library with its entries bound. An entry the
    library lacks (a stale build) is None, with one warning."""

    def __init__(self, path) -> None:
        self.path = Path(path)
        cdll = ctypes.CDLL(str(self.path))
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
