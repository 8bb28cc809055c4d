"""Micro-batch containers and the wire formats (counterpart of a subset of
``twtml_tpu/features/batch.py``).

A micro-batch is a struct of host arrays: the text half (hashed tokens, or
raw UTF-16 code units on the units wires), the 4 dense numeric features,
labels, and a validity mask. Row counts are padded up to bucket sizes so a
stream of varying batch sizes reuses a few shapes. Three wires:

- padded (``UnitBatch``): units as a [B, L] buffer;
- ragged (``RaggedUnitBatch``): units concatenated, plus row offsets; the
  step re-pads them on the device (ops/ragged.py);
- packed (``PackedBatch``): any batch's fields back to back in ONE uint8
  buffer, one H2D copy; the ragged offsets ship as uint16 length deltas
  when the static row length allows. ``unpack_batch`` reinterprets the
  buffer, on the host or on the device, with the same bytes.

Plain classes of numpy arrays (no pytree registration); the learner moves
them to its device. The flat layouts only: the shard-segment and group
layouts, and the digram codec, are not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

NUM_NUMBER_FEATURES = 4  # MllibHelper.scala:13


class FeatureBatch(NamedTuple):
    """One padded micro-batch of host-hashed tokens.

    Shapes (B = padded rows, L = padded tokens/tweet):
      token_idx: int  [B, L] — hashed bigram indices into [0, numTextFeatures)
      token_val: num  [B, L] — term-frequency counts (0 where padded)
      numeric:   float32[B, 4] — scaled followers/favourites/friends/age
      label:     float32[B]    — retweet count of the retweeted status
      mask:      float32[B]    — 1.0 for real rows, 0.0 for padding
    """

    token_idx: np.ndarray
    token_val: np.ndarray
    numeric: np.ndarray
    label: np.ndarray
    mask: np.ndarray

    @property
    def num_valid(self) -> int:
        return int(self.mask.sum())


class UnitBatch(NamedTuple):
    """A padded micro-batch carrying raw UTF-16 code units; the learner
    hashes the bigrams on its device (ops/text_hash.py).

    Shapes (B = padded rows, L = padded units/tweet, L >= 2):
      units:   uint8|uint16 [B, L] — lowercased text as UTF-16-LE code units;
               uint8 when every row is ASCII
      length:  int32  [B]      — real unit count per row (0 for padding)
      numeric: float32[B, 4], label: float32[B], mask: float32[B] — as in
      FeatureBatch.
    """

    units: np.ndarray
    length: np.ndarray
    numeric: np.ndarray
    label: np.ndarray
    mask: np.ndarray

    @property
    def num_valid(self) -> int:
        return int(self.mask.sum())


def _bucket(n: int, minimum: int = 8) -> int:
    """Next power-of-two bucket >= n (>= minimum)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def pad_row_count(n: int, row_bucket: int, row_multiple: int = 1) -> int:
    """Padded row count: the requested bucket when it fits, else the
    power-of-two bucket, then rounded up to ``row_multiple``."""
    b = row_bucket if row_bucket >= n and row_bucket > 0 else _bucket(max(n, 1))
    if row_multiple > 1:
        b += (-b) % row_multiple
    return b


class RaggedUnitBatch:
    """A micro-batch whose text ships as CONCATENATED code units plus row
    offsets, with no per-row padding on the wire; the step re-pads it to
    [B, ``row_len``] on the device (ops/ragged.py ``ragged_repad``).

    Fields: units [N] uint8|uint16 (uint8 iff every row is ASCII; N is the
    total rounded up to ``RAGGED_UNIT_MULTIPLE``), offsets [B+1] int32 (pad
    rows hold the total: length 0), numeric/label/mask as in UnitBatch.
    ``row_len`` is the padded row length L the device rebuilds. ``lease``
    is the arena lease of the native fill whose buffer holds the fields
    (features/featurize_native.py), or None."""

    def __init__(self, units, offsets, numeric, label, mask, row_len: int, lease=None):
        self.units = units
        self.offsets = offsets
        self.numeric = numeric
        self.label = label
        self.mask = mask
        self.row_len = int(row_len)
        self.lease = lease

    @property
    def num_valid(self) -> int:
        return int(np.asarray(self.mask).sum())


class PackedBatch:
    """A batch's fields back to back in ONE contiguous uint8 buffer, plus
    the static layout that rebuilds them: (class name, ((shape, dtype
    str), ...)[, ragged extra]). ``lease`` is the arena lease that owns the
    buffer (features/arena.py), or None."""

    def __init__(self, buffer, layout: tuple, lease=None):
        self.buffer = buffer
        self.layout = layout
        self.lease = lease


def wire_nbytes(batch) -> int:
    """Bytes this batch puts on the host-to-device wire."""
    if isinstance(batch, PackedBatch):
        return int(batch.buffer.nbytes)
    fields = (
        (batch.units, batch.offsets, batch.numeric, batch.label, batch.mask)
        if isinstance(batch, RaggedUnitBatch) else tuple(batch)
    )
    return sum(int(a.nbytes) for a in fields)


# the ragged units buffer rounds its total up to this multiple: waste is at
# most this many units a batch, and a stream sees few distinct sizes
RAGGED_UNIT_MULTIPLE = 4096

# The ragged offsets are bounded by the static row length L, so whenever L
# fits uint16 they ship as per-row LENGTH DELTAS in half the bytes; the
# device cumsums them back (ops/ragged.offsets_from_deltas). The gate is
# static in L, never sniffed from the data; int32 offsets beyond it.
OFFSET_DELTA_MAX = 2**16 - 1


def offsets_narrow(row_len: int) -> bool:
    """Whether a batch's offsets may ship as uint16 length deltas."""
    return 0 < int(row_len) <= OFFSET_DELTA_MAX


def _offsets_to_deltas(offsets) -> np.ndarray:
    """int32 offsets [B+1] (starting at 0) -> uint16 length deltas [B]. A
    delta past uint16 means the ``row_len`` gate was misdeclared: raise,
    never wrap."""
    offs = np.asarray(offsets, np.int64)
    d = offs[1:] - offs[:-1]
    if d.size and (d.min() < 0 or d.max() > OFFSET_DELTA_MAX):
        raise ValueError(
            "offsets are not uint16-delta encodable (negative or "
            f"> {OFFSET_DELTA_MAX} length); keep the int32 offset wire"
        )
    return d.astype(np.uint16)


def _deltas_to_offsets_np(deltas) -> np.ndarray:
    """Host twin of ``ops/ragged.offsets_from_deltas``."""
    d = np.asarray(deltas, np.int64)
    out = np.zeros((d.shape[0] + 1,), np.int64)
    np.cumsum(d, out=out[1:])
    return out.astype(np.int32)


def ragged_wire_arrays(
    units: np.ndarray, offsets: np.ndarray, n: int, b: int, narrow: bool
) -> tuple[np.ndarray, np.ndarray]:
    """(flat units buffer, padded [b+1] int32 offsets) for the ragged wire:
    ``narrow`` ships uint8 (lossless iff every row is ASCII, the caller's
    metadata gate); pad rows get ``offsets[i] = total`` (length 0)."""
    total = int(offsets[-1]) if n else 0
    n_bucket = max(
        RAGGED_UNIT_MULTIPLE,
        -(-total // RAGGED_UNIT_MULTIPLE) * RAGGED_UNIT_MULTIPLE,
    )
    flat = np.zeros((n_bucket,), np.uint8 if narrow else np.uint16)
    flat[:total] = units[:total]
    offs = np.full((b + 1,), total, np.int32)
    offs[: n + 1] = offsets[: n + 1].astype(np.int32)
    return flat, offs


def _finish_pack(chunks, layout: tuple) -> PackedBatch:
    """Concatenate the uint8 field chunks into an arena-leased buffer."""
    from .arena import lease_wire

    lease = lease_wire(sum(c.nbytes for c in chunks))
    np.concatenate(chunks, out=lease.buf)
    return PackedBatch(lease.buf, layout, lease)


def pack_batch(
    batch: "FeatureBatch | UnitBatch | RaggedUnitBatch",
    narrow_offsets: "bool | None" = None,
) -> PackedBatch:
    """Flatten a host batch into one uint8 wire buffer. A RaggedUnitBatch
    records ``row_len`` in the layout's third element, and its offsets ship
    as uint16 length deltas whenever ``offsets_narrow(row_len)`` allows
    (``narrow_offsets`` overrides). The native assembler fills the buffer
    when it can (features/assemble.py), byte for byte as this numpy path."""
    if isinstance(batch, RaggedUnitBatch):
        narrow = (
            offsets_narrow(batch.row_len) if narrow_offsets is None
            else narrow_offsets
        )
        from .assemble import try_assemble_flat

        fast = try_assemble_flat(batch, narrow)
        if fast is not None:
            return fast
        arrays: tuple = (
            batch.units,
            _offsets_to_deltas(batch.offsets) if narrow else batch.offsets,
            batch.numeric, batch.label, batch.mask,
        )
        extra: tuple | None = (batch.row_len, 1, "u16delta" if narrow else "i32")
    else:
        arrays = tuple(batch)
        extra = None
    fields = tuple(np.ascontiguousarray(a) for a in arrays)
    layout = (
        type(batch).__name__,
        tuple((a.shape, a.dtype.str) for a in fields),
    ) + ((extra,) if extra is not None else ())
    return _finish_pack([a.view(np.uint8).reshape(-1) for a in fields], layout)


def _tensor_view(chunk, dt: np.dtype):
    """A uint8 tensor's bytes as a tensor of ``dt``'s width, the bytes
    reinterpreted (``Tensor.view(dtype)``). uint16 comes back as int16 (the
    same bits; consumers widen with ``& 0xFFFF``). torch refuses a dtype
    view at a storage offset that is not a multiple of the item size, which
    the packed layout gives a 4-byte field behind an odd number of uint16s:
    such a chunk is copied to an aligned buffer first."""
    import torch

    dtypes = {
        "u1": torch.uint8, "i1": torch.int8, "u2": torch.int16,
        "i2": torch.int16, "i4": torch.int32, "f4": torch.float32,
    }
    if dt.itemsize > 1 and chunk.storage_offset() % dt.itemsize:
        chunk = chunk.clone()
    return chunk.view(dtypes[f"{dt.kind}{dt.itemsize}"])


def unpack_batch(buffer, layout: tuple):
    """Rebuild the batch from a packed buffer: a numpy uint8 array gives
    numpy views; a torch uint8 tensor (on any device) gives tensors whose
    bytes are the same. The flat layouts only."""
    cls = {
        "FeatureBatch": FeatureBatch,
        "UnitBatch": UnitBatch,
        "RaggedUnitBatch": RaggedUnitBatch,
    }.get(layout[0])
    if cls is None:
        raise NotImplementedError(
            f"the {layout[0]} layout is not ported (group layout: ROADMAP A4, "
            "shard segments: A10)"
        )
    fields = []
    off = 0
    for shape, dtype_str in layout[1]:
        dt = np.dtype(dtype_str)
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        chunk = buffer[off: off + count * dt.itemsize]
        off += count * dt.itemsize
        if isinstance(chunk, np.ndarray):
            fields.append(chunk.view(dt).reshape(shape))
        else:
            fields.append(_tensor_view(chunk, dt).reshape(shape))
    if cls is not RaggedUnitBatch:
        return cls(*fields)
    row_len, num_shards, offsets_form = layout[2][:3]
    if num_shards != 1 or len(layout[2]) > 3:
        raise NotImplementedError(
            "shard-aligned and digram-coded ragged layouts are not ported "
            "(ROADMAP A10, A11)"
        )
    if offsets_form == "u16delta":
        if isinstance(fields[1], np.ndarray):
            fields[1] = _deltas_to_offsets_np(fields[1])
        else:
            from ..ops.ragged import offsets_from_deltas

            fields[1] = offsets_from_deltas(fields[1])
    return RaggedUnitBatch(*fields, row_len=row_len)
