"""One-pass wire assembly: the native fast path of the flat packed ragged
wire, of the shard-segment wire (a multi-host rank's pack) and of the
superbatch's group wire, behind ``--wireAssemble`` (counterpart of
``twtml_tpu/features/assemble.py``).

One C sweep (``native/wireassemble.cpp``) lays the final ``PackedBatch``
buffer down: for each of the K batches (K = 1 on the flat wire) the units
copied, or digram-coded in the copy under ``--wireCodec dict`` (the pair
LUT of features/wirecodec.py, the same greedy encode, one shared bucket and
the all-or-nothing raw fallback of ``batch._encode_units_segments``), the
offsets as uint16 length deltas under the static ``row_len`` gate (int32
beyond it), the numeric/label/mask sideband behind them, into a buffer
leased from the arena (features/arena.py).

``try_assemble_flat``, ``try_assemble_sharded`` and ``try_assemble_group``
return a PackedBatch byte for byte as ``batch.pack_batch``'s,
``batch.pack_ragged_sharded``'s or ``batch.pack_ragged_group``'s numpy path
would build it, or None: mode off, the
native entry unavailable (counted in ``native.COUNTERS["packs_degraded"]``),
a field off the wire schema, or an input the C pass refuses (a delta past
uint16); the packer then runs the numpy path, which raises the canonical
errors.

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
    schema (the numpy path handles it). A shard-aligned batch carries one
    offsets block a shard."""
    units, offsets, numeric, label, mask = (
        np.ascontiguousarray(np.asarray(a))
        for a in (rb.units, rb.offsets, rb.numeric, rb.label, rb.mask)
    )
    b = mask.shape[0] if mask.ndim == 1 else -1
    s = int(getattr(rb, "num_shards", 1) or 1)
    if (
        units.dtype not in (np.uint8, np.uint16) or units.ndim != 1
        or offsets.dtype != np.int32 or offsets.shape != (b + s,)
        or numeric.dtype != np.float32 or numeric.shape != (b, NUM_NUMBER_FEATURES)
        or label.dtype != np.float32 or label.shape != (b,)
        or mask.dtype != np.float32
    ):
        return None
    return units, offsets, numeric, label, mask


def _codec_lut(codec: "str | None", units_dtype):
    """The pair LUT when the codec applies, None for the raw wire (codec
    off, or uint16 units, which ship raw as on the numpy path), or ``()``
    for an unknown codec, which the numpy path refuses."""
    if codec is None or codec in ("", "off"):
        return None
    if codec != "dict":
        return ()
    if np.dtype(units_dtype) != np.uint8:
        return None
    from .wirecodec import pair_lut

    return pair_lut()


def _assemble(fields_per_batch: list, narrow: bool, lut, shards: int = 1,
              forced_bucket: int = 0):
    """The C pass over K batches' fields (each S = ``shards`` segments) into
    a leased buffer: (buffer, codec bucket, lease), or None (the entry
    refused the input). With a LUT the codes go through a leased scratch of
    the K raw units buffers, which returns to the pool when the pass is
    done."""
    k = len(fields_per_batch)
    units, mask = fields_per_batch[0][0], fields_per_batch[0][4]
    n, b = units.shape[0], mask.shape[0]
    offs_bytes = b * 2 if narrow else (b + shards) * 4
    per_batch = n * units.dtype.itemsize + offs_bytes + b * (NUM_NUMBER_FEATURES + 2) * 4
    scratch = enc_lens = None
    if lut is not None:
        scratch = lease_wire(k * n)
        enc_lens = np.empty((k * shards,), np.int64)
    lease = lease_wire(k * per_batch)
    try:
        got = native.wire_assemble(fields_per_batch, narrow, lease.buf, lut,
                                   None if scratch is None else scratch.buf, enc_lens,
                                   shards=shards, forced_bucket=forced_bucket)
    finally:
        if scratch is not None:
            scratch.retire()
    if got is None:
        lease.retire()
        return None
    native.COUNTERS["packs_native"] += 1
    total, enc_bucket = got
    return lease.buf[:total], enc_bucket, lease


def _field_metas(fields: tuple, narrow: bool, enc_bucket: int, shards: int = 1) -> tuple:
    """The per-segment field metas of a packed ragged layout (the units as
    ``enc_bucket`` codes when it is not 0), a segment being the whole batch
    or one of its ``shards`` shard segments."""
    units, mask = fields[0], fields[4]
    bl = mask.shape[0] // shards
    f4 = np.dtype(np.float32).str
    return (
        ((enc_bucket,), np.dtype(np.uint8).str) if enc_bucket
        else ((units.shape[0] // shards,), units.dtype.str),
        ((bl,), np.dtype(np.uint16).str) if narrow else ((bl + 1,), np.dtype(np.int32).str),
        ((bl, NUM_NUMBER_FEATURES), f4), ((bl,), f4), ((bl,), f4),
    )


def _native_fields(batches) -> list | None:
    """Every batch's wire fields, or None: mode off, the entry unavailable
    (counted as a degraded pack) or a field off the schema."""
    if _mode == "off":
        return None
    if not native.assemble_available():
        native.COUNTERS["packs_degraded"] += 1
        return None
    fields = [_field_arrays(rb) for rb in batches]
    return None if any(f is None for f in fields) else fields


def _run(batches, narrow: bool, codec, shards: int = 1, forced_bucket: int = 0):
    """(fields, buffer, codec bucket, lease) of the C pass over
    ``batches``, or None for the numpy path."""
    lut = _codec_lut(codec, np.asarray(batches[0].units).dtype)
    if isinstance(lut, tuple):
        return None
    fields = _native_fields(batches)
    got = (None if fields is None
           else _assemble(fields, narrow, lut, shards, int(forced_bucket or 0)))
    return None if got is None else (fields, *got)


def try_assemble_flat(rb, narrow: bool, codec: "str | None" = None) -> PackedBatch | None:
    """The flat ragged pack in one C pass (one segment holding the whole
    batch, fields back to back), or None for the numpy path. A
    shard-aligned flat pack keeps the numpy path, as in the JAX package."""
    if rb.num_shards != 1:
        return None
    got = _run([rb], narrow, codec)
    if got is None:
        return None
    fields, buffer, enc_bucket, lease = got
    n = fields[0][0].shape[0]
    layout = ("RaggedUnitBatch", _field_metas(fields[0], narrow, enc_bucket),
              (rb.row_len, 1, "u16delta" if narrow else "i32")
              + ((("dict", (n,)),) if enc_bucket else ()))
    return PackedBatch(buffer, layout, lease)


def try_assemble_sharded(rb, narrow: bool, codec: "str | None" = None,
                         codec_bucket: "int | None" = None,
                         num_shards_out: int = 0) -> PackedBatch | None:
    """The shard-segment pack (``pack_ragged_sharded``) in one C pass, or
    None for the numpy path."""
    s = rb.num_shards
    got = _run([rb], narrow, codec, s, codec_bucket or 0)
    if got is None:
        return None
    fields, buffer, enc_bucket, lease = got
    n_sb = fields[0][0].shape[0] // s
    layout = ("RaggedShardSegments", _field_metas(fields[0], narrow, enc_bucket, s),
              (rb.row_len, num_shards_out or s, "u16delta" if narrow else "i32")
              + ((("dict", n_sb),) if enc_bucket else ()))
    return PackedBatch(buffer, layout, lease)


def try_assemble_group(batches, narrow: bool, codec: "str | None" = None,
                       codec_bucket: "int | None" = None,
                       num_shards_out: int = 0) -> PackedBatch | None:
    """The group pack of K ragged batches (``pack_ragged_group``, which
    checked their signature) in one C pass, shard-major over their shard
    segments, or None for the numpy path."""
    s = batches[0].num_shards
    got = _run(batches, narrow, codec, s, codec_bucket or 0)
    if got is None:
        return None
    fields, buffer, enc_bucket, lease = got
    n_sb = fields[0][0].shape[0] // s
    layout = ("RaggedGroupSegments", _field_metas(fields[0], narrow, enc_bucket, s),
              (batches[0].row_len, num_shards_out or s, len(batches),
               "u16delta" if narrow else "i32")
              + ((("dict", n_sb),) if enc_bucket else ()))
    return PackedBatch(buffer, layout, lease)
