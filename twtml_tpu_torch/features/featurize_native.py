"""One-pass host featurize: the native fast path of the ragged-wire
featurize stage, behind ``--featurizeNative`` (counterpart of
``twtml_tpu/features/featurize_native.py``).

One C sweep (``native/featurize.cpp``) takes the batch's encoded units and
numeric columns straight to the final ragged-wire arrays: flat units (uint8
under the caller's all-ASCII gate), padded int32 offsets, scaled float32
numeric/label/mask, carved as views out of ONE arena lease
(features/arena.py).

``try_fill`` returns those arrays byte for byte as the numpy path in
``features/featurizer.py`` would build them, or None: mode off, the native
entry unavailable (counted in ``native.COUNTERS["fills_degraded"]``), or an
input the C pass refuses. The featurizer then runs the numpy path.

``--featurizeNative <auto|on|off>`` drives ``configure``; as in the JAX
package, ``auto`` and ``on`` both mean "whenever the native entry loads".
"""

from __future__ import annotations

import contextlib
import weakref

import numpy as np

from . import native
from .arena import lease_wire
from .batch import NUM_NUMBER_FEATURES, RAGGED_UNIT_MULTIPLE

# the column order the C pass reads (followers, favourites, friends,
# created_ms, label): in the Status traversal's float64 [n, 5] columns, and
# in a parsed block's int64 [n, 5] columns (features/blocks.py COL_*)
_OBJECT_COL_ORDER = np.arange(5, dtype=np.int64)
_BLOCK_COL_ORDER = np.array([1, 2, 3, 4, 0], np.int64)

_MODES = ("auto", "on", "off")
_mode = "auto"


def configure(mode: str) -> None:
    """Set the process-wide featurize mode (the ``--featurizeNative`` seam)."""
    global _mode
    if mode not in _MODES:
        raise ValueError(f"featurizeNative must be one of {_MODES}, got {mode!r}")
    _mode = mode


def mode() -> str:
    return _mode


def available() -> bool:
    """Whether featurize will ride the C pass right now."""
    return _mode != "off" and native.featurize_available()


@contextlib.contextmanager
def forced(mode_: str):
    """Scoped mode override, for tests that run both paths."""
    prev = _mode
    configure(mode_)
    try:
        yield
    finally:
        configure(prev)


def _lease_views(b: int, n_bucket: int, unit_dtype):
    """ONE arena lease carved into the five wire arrays, every 4-byte field
    at a 4-byte offset: numeric [b,4] f32 | label [b] f32 | mask [b] f32 |
    offsets [b+1] i32 | units [n_bucket] u8|u16. Also returns the five
    section pointers (units, offsets, numeric, label, mask), derived from
    the lease's one base address."""
    unit_itemsize = np.dtype(unit_dtype).itemsize
    o_label = b * NUM_NUMBER_FEATURES * 4
    o_mask = o_label + b * 4
    o_offsets = o_mask + b * 4
    o_units = o_offsets + (b + 1) * 4
    lease = lease_wire(o_units + n_bucket * unit_itemsize)
    buf = lease.buf
    base = buf.ctypes.data
    numeric = buf[0:o_label].view(np.float32).reshape(b, NUM_NUMBER_FEATURES)
    label = buf[o_label:o_mask].view(np.float32)
    mask = buf[o_mask:o_offsets].view(np.float32)
    offsets = buf[o_offsets:o_units].view(np.int32)
    units = buf[o_units:].view(unit_dtype)
    ptrs = (base + o_units, base + o_offsets, base, base + o_label, base + o_mask)
    return lease, units, offsets, numeric, label, mask, ptrs


def try_fill(units, offsets, cols, col_order, n: int, b: int, narrow: bool, now_ms: int):
    """The fused fill: (flat units, padded offsets, numeric, label, mask,
    max row length, lease), or None for the numpy path. ``cols`` is float64
    [n, 5] in ``object_col_order()`` (the Status traversal's) or int64
    [n, 5] in ``block_col_order()`` (a parsed block's columns); the C pass
    applies the reference scaling bit for bit (float64 multiply, f32 cast
    on store)."""
    if _mode == "off":
        return None
    if not native.featurize_available():
        native.COUNTERS["fills_degraded"] += 1
        return None
    units = np.ascontiguousarray(units)
    offsets = np.ascontiguousarray(offsets)
    cols = np.ascontiguousarray(cols)
    if (
        offsets.dtype != np.int64
        or units.dtype not in (np.uint8, np.uint16)
        or (n and cols.dtype not in (np.float64, np.int64))
    ):
        return None
    cols_f64 = cols.ctypes.data if n and cols.dtype == np.float64 else None
    cols_i64 = cols.ctypes.data if n and cols.dtype == np.int64 else None
    total = int(offsets[n]) if n else 0
    n_bucket = max(
        RAGGED_UNIT_MULTIPLE,
        -(-total // RAGGED_UNIT_MULTIPLE) * RAGGED_UNIT_MULTIPLE,
    )
    lease, out_units, out_offsets, numeric, label, mask, ptrs = _lease_views(
        b, n_bucket, np.uint8 if narrow else np.uint16
    )
    max_len = native.featurize_wire_raw(
        units.ctypes.data, int(units.dtype.itemsize), offsets.ctypes.data,
        cols_f64, cols_i64, col_order.ctypes.data,
        n, b, n_bucket, int(now_ms), 1 if narrow else 0, *ptrs,
    )
    if max_len is None:
        lease.retire()  # untouched: straight back to the pool
        return None
    native.COUNTERS["fills_native"] += 1
    return out_units, out_offsets, numeric, label, mask, max_len, lease


def attach_lease(batch, lease) -> None:
    """Hang the fill's lease on the batch, with a GC finalizer that
    ``discard``s it if the batch is never packed or stepped."""
    batch.lease = lease
    weakref.finalize(batch, lease.discard)


def object_col_order() -> np.ndarray:
    return _OBJECT_COL_ORDER


def block_col_order() -> np.ndarray:
    return _BLOCK_COL_ORDER
