"""One-pass wire assembly: the native fast path of the flat packed ragged
wire, behind ``--wireAssemble`` (counterpart of the flat form of
``twtml_tpu/features/assemble.py``).

One C sweep (``native/wireassemble.cpp``) lays the final ``PackedBatch``
buffer down: the units copied, the offsets as uint16 length deltas under the
static ``row_len`` gate (int32 beyond it), the numeric/label/mask sideband
behind them, into a buffer leased from the arena (features/arena.py).

``try_assemble_flat`` returns a PackedBatch byte for byte as
``batch.pack_batch``'s numpy path would build it, or None: mode off, the
native entry unavailable (counted in ``native.COUNTERS["packs_degraded"]``),
a field off the wire schema, or an input the C pass refuses (a delta past
uint16); the packer then runs the numpy path, which raises the canonical
errors. No digram codec: it stays queued.

``--wireAssemble <auto|on|off>`` drives ``configure``; ``auto`` and ``on``
both mean "whenever the native entry loads".
"""

from __future__ import annotations

import contextlib

import numpy as np

from . import native
from .arena import lease_wire
from .batch import NUM_NUMBER_FEATURES, PackedBatch

_MODES = ("auto", "on", "off")
_mode = "auto"


def configure(mode: str) -> None:
    """Set the process-wide assembler mode (the ``--wireAssemble`` seam)."""
    global _mode
    if mode not in _MODES:
        raise ValueError(f"wireAssemble must be one of {_MODES}, got {mode!r}")
    _mode = mode


def mode() -> str:
    return _mode


def available() -> bool:
    """Whether packs will ride the C pass right now."""
    return _mode != "off" and native.assemble_available()


@contextlib.contextmanager
def forced(mode_: str):
    """Scoped mode override, for tests that run both paths."""
    prev = _mode
    configure(mode_)
    try:
        yield
    finally:
        configure(prev)


def _field_arrays(rb) -> tuple | None:
    """(units, offsets, numeric, label, mask) as contiguous arrays in the
    exact wire dtypes the C pass assumes, or None when a field is off the
    schema (the numpy path handles it)."""
    units, offsets, numeric, label, mask = (
        np.ascontiguousarray(np.asarray(a))
        for a in (rb.units, rb.offsets, rb.numeric, rb.label, rb.mask)
    )
    b = mask.shape[0] if mask.ndim == 1 else -1
    if (
        units.dtype not in (np.uint8, np.uint16) or units.ndim != 1
        or offsets.dtype != np.int32 or offsets.shape != (b + 1,)
        or numeric.dtype != np.float32 or numeric.shape != (b, NUM_NUMBER_FEATURES)
        or label.dtype != np.float32 or label.shape != (b,)
        or mask.dtype != np.float32
    ):
        return None
    return units, offsets, numeric, label, mask


def try_assemble_flat(rb, narrow: bool) -> PackedBatch | None:
    """The flat ragged pack in one C pass (one segment holding the whole
    batch, fields back to back), or None for the numpy path."""
    if _mode == "off":
        return None
    if not native.assemble_available():
        native.COUNTERS["packs_degraded"] += 1
        return None
    fields = _field_arrays(rb)
    if fields is None:
        return None
    units, mask = fields[0], fields[4]
    n, b = units.shape[0], mask.shape[0]
    offs_bytes = b * 2 if narrow else (b + 1) * 4
    lease = lease_wire(n * units.dtype.itemsize + offs_bytes + b * (NUM_NUMBER_FEATURES + 2) * 4)
    total = native.wire_assemble(*fields, narrow, lease.buf)
    if total is None:
        lease.retire()
        return None
    native.COUNTERS["packs_native"] += 1
    f4 = np.dtype(np.float32).str
    layout = (
        "RaggedUnitBatch",
        (
            ((n,), units.dtype.str),
            ((b,), np.dtype(np.uint16).str) if narrow else ((b + 1,), np.dtype(np.int32).str),
            ((b, NUM_NUMBER_FEATURES), f4), ((b,), f4), ((b,), f4),
        ),
        (rb.row_len, 1, "u16delta" if narrow else "i32"),
    )
    return PackedBatch(lease.buf[:total], layout, lease)
