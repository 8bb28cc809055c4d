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

The superbatch wires (``--superBatch K``): ``stack_batches`` gives K
same-shape batches' fields a leading [K] axis (the stacked wire), and
``pack_ragged_group`` lays K ragged batches into ONE buffer (the group
wire, layout ``RaggedGroupSegments``: segment k holds batch k's five
fields back to back), which ``unpack_batch`` turns back into the stacked
batch. The buffer and layout are the JAX package's, byte for byte.

Tenant routing (``--tenants M``, parallel/tenants.py): ``tenant_route_keys``
gives each row a tenant by a deterministic host key, ``tenant_rows`` lists
each tenant's valid rows, and ``split_batch_tenants`` makes M batches of
the batch's own padded shape (a dry tenant's is all padding), which the
superbatch wires then carry as the M-tenant wire. Every output is the JAX
package's, byte for byte.

The digram codec (``--wireCodec dict``, features/wirecodec.py) rides the
packed forms: ``pack_batch`` and ``pack_ragged_group`` code a uint8 units
buffer (each group segment on its own, in one shared bucket) and record
``("dict", raw units)`` in the layout; ``unpack_batch`` decodes it, with
``decode_np`` on the host and ``ops/ragged.units_from_codes`` on a tensor.
uint16 units and a batch whose coded bucket is not smaller ship raw, with
the raw layout. Bytes and layouts are the JAX package's.

Plain classes of numpy arrays (no pytree registration); the learner moves
them to its device. A multi-host rank packs its rows as its segment of the
shard-segment wire (``pack_ragged_sharded``, ``align_ragged_shards``), byte
for byte the JAX package's.
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


def compact_tokens(token_idx: np.ndarray, token_val: np.ndarray, num_features: int,
                   counts: bool = False, validate: bool = True):
    """The token arrays in the narrowest lossless wire dtype (the JAX
    package's ``compact_tokens``): indices to int16 when ``num_features``
    <= 2**15, values to uint16 when the caller declares them term counts
    (a property of the schema, never sniffed from the data, so a stream
    keeps one dtype). Out-of-range indices, or counts that do not survive
    uint16, raise; ``validate=False`` skips those passes for arrays that
    are in range by construction (the C hasher's)."""
    if 0 < num_features <= np.iinfo(np.int16).max + 1:
        if validate and token_idx.size and (
                token_idx.min() < 0 or token_idx.max() >= num_features):
            raise ValueError("token indices outside the declared feature space "
                             f"[0, {num_features})")
        token_idx = token_idx.astype(np.int16)
    if counts:
        compacted = token_val.astype(np.uint16)
        if validate and not np.array_equal(compacted, token_val):
            raise ValueError("counts=True but token values are not uint16-exact "
                             "(fractional, negative, or >= 2**16)")
        token_val = compacted
    return token_idx, token_val


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


def pad_feature_batch(rows, row_bucket: int = 0, token_bucket: int = 0,
                      num_features: int = 0, counts: bool = False) -> FeatureBatch:
    """Per-tweet (text counts {index: count}, numeric[4], label) rows as one
    padded FeatureBatch (the JAX package's ``pad_feature_batch``): padding
    rows carry mask 0."""
    n = len(rows)
    max_tok = max((len(r[0]) for r in rows), default=1)
    b = pad_row_count(n, row_bucket)
    lt = token_bucket if token_bucket >= max_tok and token_bucket > 0 else _bucket(max(max_tok, 1))
    token_idx = np.zeros((b, lt), dtype=np.int32)
    token_val = np.zeros((b, lt), dtype=np.float32)
    numeric = np.zeros((b, NUM_NUMBER_FEATURES), dtype=np.float32)
    label = np.zeros((b,), dtype=np.float32)
    mask = np.zeros((b,), dtype=np.float32)
    for i, (text_counts, nums, lab) in enumerate(rows):
        for j, (idx, val) in enumerate(text_counts.items()):
            token_idx[i, j] = idx
            token_val[i, j] = val
        numeric[i] = nums
        label[i] = lab
        mask[i] = 1.0
    token_idx, token_val = compact_tokens(token_idx, token_val, num_features, counts=counts)
    return FeatureBatch(token_idx, token_val, numeric, label, mask)


class RaggedUnitBatch:
    """A micro-batch whose text ships as CONCATENATED code units plus row
    offsets, with no per-row padding on the wire; the step re-pads it to
    [B, ``row_len``] on the device (ops/ragged.py ``ragged_repad``).

    Fields: units [N] uint8|uint16 (uint8 iff every row is ASCII; N is the
    total rounded up to ``RAGGED_UNIT_MULTIPLE``), offsets [B+1] int32 (pad
    rows hold the total: length 0), numeric/label/mask as in UnitBatch.
    ``row_len`` is the padded row length L the device rebuilds. ``lease``
    is the arena lease of the native fill whose buffer holds the fields
    (features/featurize_native.py), or None. ``num_shards`` S > 1 marks a
    shard-ALIGNED batch (``align_ragged_shards``): the units are S equal
    sub-buffers and the offsets S segment-relative [B/S + 1] blocks."""

    def __init__(self, units, offsets, numeric, label, mask, row_len: int, lease=None,
                 num_shards: int = 1):
        self.units = units
        self.offsets = offsets
        self.numeric = numeric
        self.label = label
        self.mask = mask
        self.row_len = int(row_len)
        self.lease = lease
        self.num_shards = int(num_shards)

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


def wire_composition(batch) -> "dict[str, int]":
    """A batch's wire bytes split {units, offsets, sideband} (the JAX
    package's ``wire_composition``): ``units`` the text payload (code
    units, or hashed token indices and values), ``offsets`` the row
    boundaries (offsets, length deltas or lengths), ``sideband`` numeric,
    label and mask. A PackedBatch reports its layout's fields (times its
    segments), so its packed and unpacked views agree; a coded layout keeps
    ``units`` at the RAW bytes and adds ``units_compressed``, the bytes the
    copy carries."""
    if isinstance(batch, PackedBatch):
        tag = batch.layout[0]
        names = ("units", "units" if tag == "FeatureBatch" else "offsets",
                 "sideband", "sideband", "sideband")
        segs = 1
        if tag in ("RaggedGroupSegments", "RaggedShardSegments"):
            per_seg = sum(int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize
                          for shape, dt in batch.layout[1])
            if per_seg:
                segs = int(batch.buffer.shape[0]) // per_seg
        out = {"units": 0, "offsets": 0, "sideband": 0}
        for name, (shape, dt) in zip(names, batch.layout[1]):
            out[name] += segs * int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize
        codec_tag = _layout_codec(batch.layout)
        if codec_tag is not None:
            out["units_compressed"] = out["units"]
            out["units"] = (int(np.prod(codec_tag[1], dtype=np.int64))
                            if tag == "RaggedUnitBatch" else segs * int(codec_tag[1]))
        return out
    groups = {
        "units": ("units", "token_idx", "token_val"),
        "offsets": ("offsets", "length"),
        "sideband": ("numeric", "label", "mask"),
    }
    return {name: sum(int(getattr(getattr(batch, a, None), "nbytes", 0) or 0) for a in attrs)
            for name, attrs in groups.items()}


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

def _shard_segment_need(rb: "RaggedUnitBatch", num_shards: int) -> int:
    """Raw units the longest of ``num_shards`` row-contiguous shards holds."""
    b = rb.mask.shape[0]
    if b % num_shards:
        raise ValueError(f"batch rows {b} not divisible by {num_shards} shards")
    offs = np.asarray(rb.offsets, np.int64)
    starts = offs[0: b + 1: b // num_shards]
    return int((starts[1:] - starts[:-1]).max())


def ragged_shard_bucket(rb: "RaggedUnitBatch", num_shards: int) -> int:
    """The per-shard sub-buffer capacity ``align_ragged_shards`` would pick
    (a batch already aligned to ``num_shards``: its own), which the ranks of
    a multi-host group all-gather and agree on the maximum of."""
    if rb.num_shards == num_shards:
        return rb.units.shape[0] // num_shards
    if rb.num_shards != 1:
        raise ValueError(f"batch is aligned to {rb.num_shards} shards; re-align from "
                         f"flat before bucketing for {num_shards}")
    need = _shard_segment_need(rb, num_shards)
    return max(RAGGED_UNIT_MULTIPLE,
               -(-need // RAGGED_UNIT_MULTIPLE) * RAGGED_UNIT_MULTIPLE)


def align_ragged_shards(rb: "RaggedUnitBatch", num_shards: int,
                        unit_bucket: int = 0) -> "RaggedUnitBatch":
    """Re-lay a ragged batch into ``num_shards`` equal shard segments: S unit
    sub-buffers of one capacity and S segment-relative offset blocks (the
    JAX package's layout, byte for byte). ``unit_bucket`` pins the
    capacity (the value a multi-host group agreed); 0 sizes it from the
    longest shard, rounded to ``RAGGED_UNIT_MULTIPLE``. A batch aligned to
    ``num_shards`` already grows each sub-buffer to a larger pinned bucket
    (its offsets stay)."""
    if rb.num_shards == num_shards:
        cur = rb.units.shape[0] // num_shards
        if not unit_bucket or unit_bucket == cur:
            return rb
        if unit_bucket < cur:
            raise ValueError(f"batch is aligned to sub-buffers of {cur} units; cannot "
                             f"shrink to the pinned bucket {unit_bucket}")
        grown = np.zeros((num_shards, unit_bucket), rb.units.dtype)
        grown[:, :cur] = np.asarray(rb.units).reshape(num_shards, cur)
        return RaggedUnitBatch(grown.reshape(-1), rb.offsets, rb.numeric, rb.label,
                               rb.mask, row_len=rb.row_len, num_shards=num_shards)
    if rb.num_shards != 1:
        raise ValueError("batch is already shard-aligned; re-align from flat")
    b = rb.mask.shape[0]
    b_local = b // num_shards
    need = _shard_segment_need(rb, num_shards)
    n_sb = ragged_shard_bucket(rb, num_shards)
    offs = np.asarray(rb.offsets, np.int64)
    starts = offs[0: b + 1: b_local]
    if unit_bucket:
        if need > unit_bucket:
            raise ValueError(f"shard units {need} exceed the pinned bucket {unit_bucket}")
        n_sb = unit_bucket
    units = np.asarray(rb.units)
    flat = np.zeros((num_shards * n_sb,), units.dtype)
    new_offs = np.empty((b + num_shards,), np.int32)
    for s in range(num_shards):
        lo, hi = int(starts[s]), int(starts[s + 1])
        flat[s * n_sb: s * n_sb + (hi - lo)] = units[lo:hi]
        new_offs[s * (b_local + 1):(s + 1) * (b_local + 1)] = (
            offs[s * b_local:(s + 1) * b_local + 1] - lo)
    return RaggedUnitBatch(flat, new_offs, rb.numeric, rb.label, rb.mask,
                           row_len=rb.row_len, num_shards=num_shards)


# The ragged offsets are bounded by the static row length L, so whenever L
# fits uint16 they ship as per-row LENGTH DELTAS in half the bytes; the
# device cumsums them back (ops/ragged.offsets_from_deltas). The gate is
# static in L, never sniffed from the data; int32 offsets beyond it.
OFFSET_DELTA_MAX = 2**16 - 1


def offsets_narrow(row_len: int) -> bool:
    """Whether a batch's offsets may ship as uint16 length deltas."""
    return 0 < int(row_len) <= OFFSET_DELTA_MAX


def _offsets_to_deltas(offsets, num_segments: int = 1) -> np.ndarray:
    """Segment-relative int32 offsets [S·(B_s+1)] (each segment starting at
    0) -> uint16 length deltas [S·B_s]. A delta past uint16 means the
    ``row_len`` gate was misdeclared: raise, never wrap."""
    offs = np.asarray(offsets, np.int64).reshape(num_segments, -1)
    d = (offs[:, 1:] - offs[:, :-1]).reshape(-1)
    if d.size and (d.min() < 0 or d.max() > OFFSET_DELTA_MAX):
        raise ValueError(
            "offsets are not uint16-delta encodable (negative or "
            f"> {OFFSET_DELTA_MAX} length); keep the int32 offset wire"
        )
    return d.astype(np.uint16)


def _deltas_to_offsets_np(deltas, num_segments: int = 1) -> np.ndarray:
    """Host twin of ``ops/ragged.offsets_from_deltas``: deltas [..., S·B_s]
    -> int32 offsets [..., S·(B_s+1)], each segment starting at 0."""
    d = np.asarray(deltas, np.int64)
    lead = d.shape[:-1]
    d = d.reshape(lead + (num_segments, -1))
    out = np.zeros(d.shape[:-1] + (d.shape[-1] + 1,), np.int64)
    np.cumsum(d, axis=-1, out=out[..., 1:])
    return out.reshape(lead + (-1,)).astype(np.int32)


# ---- the digram-coded units wire (--wireCodec dict) -------------------------
# Only the packed forms carry it: every host consumer between featurize and
# pack (tenant routing, stacking) indexes raw units by offset. Two gates,
# both lossless: uint16 units ship raw (a metadata gate, like the int32
# offsets), and so does a batch whose coded bucket is not strictly smaller
# than its raw buffer (the layout says so; apps/common.py counts it in
# ``wire.codec_fallbacks``).

def _encode_units_segments(units: np.ndarray, num_segments: int, codec: "str | None",
                           bucket: "int | None" = None):
    """Per-segment digram codes [num_segments, shared bucket] of a
    segmented raw units buffer (a group's K segments or a batch's shard
    sub-buffers, each decoded on its own; the flat wire is one segment), or
    None for the raw wire (codec off, uint16 units, or an incompressible
    batch). The bucket is the largest segment's, rounded, so every segment
    has one shape; the fallback is all or nothing; an unknown codec raises.
    ``bucket`` forces the shared bucket to a value the ranks of a
    multi-host group agreed (parallel/distributed.py): every rank then
    emits the same segment shapes, and a segment that encodes past it
    raises (a codec bug, never a silent truncation)."""
    if codec is None or codec in ("", "off"):
        return None
    if codec != "dict":
        raise ValueError(f"unknown wire codec {codec!r} (know: dict)")
    u = np.asarray(units)
    if u.dtype != np.uint8:
        return None
    from .wirecodec import encode, encoded_bucket

    rows = u.reshape(num_segments, -1)
    enc = [encode(r) for r in rows]
    if bucket is None:
        bucket = encoded_bucket(max(e.shape[0] for e in enc))
        if bucket >= rows.shape[1]:
            return None
    else:
        over = max(e.shape[0] for e in enc)
        if over > bucket:
            raise ValueError(
                f"agreed codec bucket {bucket} under-covers a segment encoding of "
                f"{over} units: the cross-host zero-pad bound is violated (codec bug)")
    out = np.zeros((num_segments, bucket), np.uint8)
    for i, e in enumerate(enc):
        out[i, : e.shape[0]] = e
    return out


def _decode_units(arr, out_len: int):
    """Decode a coded units field (codes along the LAST axis, [..., M] ->
    [..., out_len]): ``decode_np`` on a numpy array, the device decode
    (``ops/ragged.units_from_codes``) on a tensor; either gives the raw
    wire's bytes."""
    if isinstance(arr, np.ndarray):
        from .wirecodec import decode_np

        return decode_np(arr, out_len)
    from ..ops.ragged import units_from_codes

    return units_from_codes(arr, out_len)


def _layout_codec(layout: tuple) -> "tuple | None":
    """The codec entry ``("dict", raw units)`` of a packed layout, or None
    for the raw wire: ``extra[3]`` of a ``RaggedUnitBatch`` layout (the raw
    shape, a tuple) or of a ``RaggedShardSegments`` one (the raw units a
    shard, an int), ``extra[4]`` of a ``RaggedGroupSegments`` one (the raw
    units a segment, an int). One reader, so the entry cannot drift."""
    extra = layout[2] if len(layout) > 2 else None
    if not extra:
        return None
    at = {"RaggedUnitBatch": 3, "RaggedShardSegments": 3,
          "RaggedGroupSegments": 4}.get(layout[0])
    if at is None or len(extra) <= at:
        return None
    return extra[at]


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
    codec: "str | None" = None,
) -> PackedBatch:
    """Flatten a host batch into one uint8 wire buffer. A RaggedUnitBatch
    records ``row_len`` in the layout's third element, and its offsets ship
    as uint16 length deltas whenever ``offsets_narrow(row_len)`` allows
    (``narrow_offsets`` overrides); ``codec="dict"`` digram-codes its uint8
    units (one stream) and appends ``("dict", raw shape)`` to that element.
    The native assembler fills the buffer when it can
    (features/assemble.py), byte for byte as this numpy path."""
    if isinstance(batch, RaggedUnitBatch):
        narrow = (
            offsets_narrow(batch.row_len) if narrow_offsets is None
            else narrow_offsets
        )
        from .assemble import try_assemble_flat

        fast = try_assemble_flat(batch, narrow, codec)
        if fast is not None:
            return fast
        units = np.asarray(batch.units)
        codes = _encode_units_segments(units, 1, codec)
        arrays: tuple = (
            units if codes is None else codes.reshape(-1),
            _offsets_to_deltas(batch.offsets, batch.num_shards) if narrow else batch.offsets,
            batch.numeric, batch.label, batch.mask,
        )
        extra: tuple | None = (batch.row_len, batch.num_shards,
                               "u16delta" if narrow else "i32") + (
            () if codes is None else (("dict", tuple(units.shape)),))
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


def stack_batches(batches):
    """K same-shape batches -> one batch whose fields carry a leading [K]
    axis: the stacked superbatch wire of ``step_many``. Every batch must
    share type, shapes and dtypes (ragged ones also ``row_len``)."""
    first = batches[0]
    for b in batches[1:]:
        if type(b) is not type(first):
            raise TypeError("cannot stack mixed batch types")
    if isinstance(first, RaggedUnitBatch):
        for b in batches[1:]:
            if b.row_len != first.row_len:
                raise ValueError("cannot stack ragged batches with different row_len")
        return RaggedUnitBatch(
            *(np.stack([getattr(b, f) for b in batches])
              for f in ("units", "offsets", "numeric", "label", "mask")),
            row_len=first.row_len,
        )
    return type(first)(*(np.stack(arrs) for arrs in zip(*batches)))


def pack_ragged_sharded(rb: RaggedUnitBatch, num_shards_out: int = 0,
                        narrow_offsets: "bool | None" = None, codec: "str | None" = None,
                        codec_bucket: "int | None" = None) -> PackedBatch:
    """A shard-aligned ragged batch -> ONE uint8 buffer laid out per shard
    (the JAX package's ``RaggedShardSegments`` wire, byte for byte): S equal
    segments, segment s holding shard s's units sub-buffer, offsets (uint16
    length deltas under the static ``row_len`` gate), numeric, label and
    mask back to back. The layout records the per-shard field metas and
    (row_len, ``num_shards_out`` or S, offsets form). A multi-host rank
    packs its local rows as S = 1 and records the group's shard count: its
    buffer is its segment of the group's wire. ``codec="dict"`` codes each
    shard's uint8 units into one shared bucket (``codec_bucket``: the
    group's agreed one) and appends ``("dict", raw units a shard)``. The
    native assembler fills the buffer when it can (features/assemble.py)."""
    s = rb.num_shards
    b = rb.mask.shape[0]
    bl = b // s
    n_sb = rb.units.shape[0] // s
    narrow = offsets_narrow(rb.row_len) if narrow_offsets is None else narrow_offsets
    from .assemble import try_assemble_sharded

    fast = try_assemble_sharded(rb, narrow, codec, codec_bucket, num_shards_out)
    if fast is not None:
        return fast
    offs_wire = ((_offsets_to_deltas(rb.offsets, s), (bl,)) if narrow
                 else (rb.offsets, (bl + 1,)))
    codes = _encode_units_segments(rb.units, s, codec, bucket=codec_bucket)
    units_wire = (rb.units, (n_sb,)) if codes is None else (codes, (codes.shape[1],))
    fields = tuple(
        np.ascontiguousarray(np.asarray(a).reshape((s,) + shape))
        for a, shape in (units_wire, offs_wire, (rb.numeric, (bl, NUM_NUMBER_FEATURES)),
                         (rb.label, (bl,)), (rb.mask, (bl,)))
    )
    layout = (
        "RaggedShardSegments",
        tuple((f.shape[1:], f.dtype.str) for f in fields),
        (rb.row_len, num_shards_out or s, "u16delta" if narrow else "i32")
        + (() if codes is None else (("dict", n_sb),)),
    )
    from .arena import lease_wire

    chunks = [f.view(np.uint8).reshape(s, -1) for f in fields]
    lease = lease_wire(sum(c.nbytes for c in chunks))
    np.concatenate(chunks, axis=1, out=lease.buf.reshape(s, -1))
    return PackedBatch(lease.buf, layout, lease)


def _segment_field(buffer, segs: int, per_seg: int, off: int, shape: tuple, dt):
    """Field ``(shape, dt)`` at byte ``off`` of each of ``segs`` segments of
    ``per_seg`` bytes: [segs, *shape], a numpy view or a reinterpreted
    tensor copy (one strided copy)."""
    nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
    chunk = buffer.reshape(segs, per_seg)[:, off: off + nbytes]
    if isinstance(chunk, np.ndarray):
        return np.ascontiguousarray(chunk).view(dt).reshape((segs,) + tuple(shape))
    return _tensor_view(chunk.contiguous(), dt).reshape((segs,) + tuple(shape))


def _decode_deltas(arr, num_segments: int):
    """Length deltas -> segment-relative int32 offsets, on the host or the
    device."""
    if isinstance(arr, np.ndarray):
        return _deltas_to_offsets_np(arr, num_segments)
    from ..ops.ragged import offsets_from_deltas

    return offsets_from_deltas(arr, num_segments)


def _unpack_ragged_shards(buffer, layout: tuple) -> RaggedUnitBatch:
    """The shard-aligned ragged batch of a ``RaggedShardSegments`` buffer:
    its S segments (a multi-host rank's own buffer holds one: its rows,
    ``num_shards`` 1), codes decoded and deltas summed back to
    segment-relative offsets. Numpy views of a numpy buffer; tensors on a
    tensor's device."""
    fields_meta = layout[1]
    row_len, offs_mode = layout[2][0], layout[2][2] if len(layout[2]) > 2 else "i32"
    codec_tag = _layout_codec(layout)
    per_seg = sum(int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize
                  for shape, dt in fields_meta)
    s_here = buffer.shape[0] // per_seg
    if buffer.shape[0] != s_here * per_seg:
        raise ValueError(f"buffer of {buffer.shape[0]} bytes is not a whole number of "
                         f"{per_seg}-byte shard segments")
    fields, off = [], 0
    for shape, dtype_str in fields_meta:
        dt = np.dtype(dtype_str)
        arr = _segment_field(buffer, s_here, per_seg, off, tuple(shape), dt)
        off += int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        fields.append(arr.reshape((s_here * shape[0],) + tuple(shape[1:])))
    if codec_tag is not None:
        n_sb = int(codec_tag[1])
        fields[0] = _decode_units(fields[0].reshape(s_here, -1), n_sb).reshape(s_here * n_sb)
    if offs_mode == "u16delta":
        fields[1] = _decode_deltas(fields[1], s_here)
    return RaggedUnitBatch(*fields, row_len=row_len, num_shards=s_here)


def pack_ragged_group(batches, num_shards_out: int = 0, narrow_offsets: "bool | None" = None,
                      codec: "str | None" = None,
                      codec_bucket: "int | None" = None) -> PackedBatch:
    """K ragged batches of one wire signature -> ONE uint8 buffer (the
    group wire): segment k holds batch k's units, offsets (uint16 length
    deltas under the static ``row_len`` gate, int32 beyond it), numeric,
    label and mask back to back, segments in batch order; shard-aligned
    batches lay it out shard-major ([S, K, segment], the JAX package's
    layout). The layout is ``("RaggedGroupSegments", per-segment field
    metas, (row_len, num_shards_out or S, K, offsets form))``;
    ``codec="dict"`` codes each segment's uint8 units into one shared
    bucket (``_encode_units_segments``; ``codec_bucket`` a multi-host
    group's agreed one) and appends ``("dict", raw units a segment)``. The
    native assembler fills the buffer when it can (features/assemble.py),
    byte for byte as the numpy path here."""
    if not batches:
        raise ValueError("cannot pack an empty group")
    first = batches[0]
    if not isinstance(first, RaggedUnitBatch):
        raise TypeError("pack_ragged_group is the ragged wire's group pack")
    for rb in batches[1:]:
        if (not isinstance(rb, RaggedUnitBatch)
                or (rb.row_len, rb.num_shards) != (first.row_len, first.num_shards)
                or rb.units.shape != first.units.shape
                or rb.units.dtype != first.units.dtype
                or rb.mask.shape != first.mask.shape):
            raise ValueError("group batches must share one wire signature (shapes, "
                             "dtypes, row_len, shard alignment)")
    k = len(batches)
    s = first.num_shards
    bl = first.mask.shape[0] // s
    n_sb = first.units.shape[0] // s
    narrow = offsets_narrow(first.row_len) if narrow_offsets is None else narrow_offsets
    from .assemble import try_assemble_group

    fast = try_assemble_group(batches, narrow, codec, codec_bucket, num_shards_out)
    if fast is not None:
        return fast
    specs = (
        ((lambda rb: rb.units), (n_sb,)),
        ((lambda rb: _offsets_to_deltas(rb.offsets, s)) if narrow else (lambda rb: rb.offsets),
         (bl,) if narrow else (bl + 1,)),
        ((lambda rb: rb.numeric), (bl, NUM_NUMBER_FEATURES)),
        ((lambda rb: rb.label), (bl,)),
        ((lambda rb: rb.mask), (bl,)),
    )
    fields = [
        np.ascontiguousarray(np.stack(
            [np.asarray(get(rb)).reshape((s,) + shape) for rb in batches], axis=1))
        for get, shape in specs
    ]
    codes = _encode_units_segments(fields[0], s * k, codec, bucket=codec_bucket)
    if codes is not None:
        fields[0] = np.ascontiguousarray(codes.reshape(s, k, codes.shape[1]))
    layout = (
        "RaggedGroupSegments",
        tuple((f.shape[2:], f.dtype.str) for f in fields),
        (first.row_len, num_shards_out or s, k, "u16delta" if narrow else "i32")
        + (() if codes is None else (("dict", n_sb),)),
    )
    from .arena import lease_wire

    chunks = [f.view(np.uint8).reshape(s, k, -1) for f in fields]
    lease = lease_wire(sum(c.nbytes for c in chunks))
    np.concatenate(chunks, axis=2, out=lease.buf.reshape(s, k, -1))
    return PackedBatch(lease.buf, layout, lease)


def _unpack_ragged_group(buffer, layout: tuple) -> RaggedUnitBatch:
    """The stacked ragged batch ([K]-leading fields, what ``stack_batches``
    gives) of a ``RaggedGroupSegments`` buffer, over the S shard segments
    it holds (a multi-host rank's own buffer holds one): numpy views of a
    numpy buffer; of a torch tensor, each field's bytes copied out of the
    segments (one strided copy a field) and reinterpreted."""
    fields_meta = layout[1]
    row_len, _s_total, k, offs_mode = layout[2][:4]
    codec_tag = _layout_codec(layout)
    per_seg = sum(int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize
                  for shape, dt in fields_meta)
    s_here = buffer.shape[0] // (k * per_seg)
    if buffer.shape[0] != s_here * k * per_seg:
        raise ValueError(f"buffer of {buffer.shape[0]} bytes is not a whole number of "
                         f"{k}x{per_seg}-byte group segments")
    fields, off = [], 0
    for shape, dtype_str in fields_meta:
        dt = np.dtype(dtype_str)
        arr = _segment_field(buffer, s_here * k, per_seg, off, tuple(shape), dt)
        off += int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        if s_here > 1:  # [S, K, d0, ...] -> [K, S·d0, ...]
            arr = arr.reshape((s_here, k) + tuple(shape))
            arr = (np.ascontiguousarray(np.swapaxes(arr, 0, 1))
                   if isinstance(arr, np.ndarray) else arr.transpose(0, 1).contiguous())
        fields.append(arr.reshape((k, s_here * shape[0]) + tuple(shape[1:])))
    if codec_tag is not None:
        n_sb = int(codec_tag[1])
        fields[0] = _decode_units(fields[0].reshape(k, s_here, -1), n_sb).reshape(
            k, s_here * n_sb)
    if offs_mode == "u16delta":
        fields[1] = _decode_deltas(fields[1], s_here)
    return RaggedUnitBatch(*fields, row_len=row_len, num_shards=s_here)


def unpack_batch(buffer, layout: tuple):
    """Rebuild the batch from a packed buffer: a numpy uint8 array gives
    numpy views; a torch uint8 tensor (on any device) gives tensors whose
    bytes are the same. The flat layouts, the shard-segment layout and the
    group layout (a stacked ragged batch); a coded units field decodes to
    the raw wire's bytes."""
    if layout[0] == "RaggedShardSegments":
        return _unpack_ragged_shards(buffer, layout)
    if layout[0] == "RaggedGroupSegments":
        return _unpack_ragged_group(buffer, layout)
    cls = {
        "FeatureBatch": FeatureBatch,
        "UnitBatch": UnitBatch,
        "RaggedUnitBatch": RaggedUnitBatch,
    }[layout[0]]
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
    codec_tag = _layout_codec(layout)
    if codec_tag is not None:
        raw_shape = tuple(codec_tag[1])
        fields[0] = _decode_units(fields[0].reshape(-1),
                                  int(np.prod(raw_shape, dtype=np.int64))).reshape(raw_shape)
    if offsets_form == "u16delta":
        fields[1] = _decode_deltas(fields[1], num_shards)
    return RaggedUnitBatch(*fields, row_len=row_len, num_shards=num_shards)


def _splitmix(x: np.ndarray) -> np.ndarray:
    """SplitMix64's finalizer over uint64 lanes: a routing mixer, not a
    cryptographic hash."""
    x = x ^ (x >> np.uint64(33))
    x = x * np.uint64(0xFF51AFD7ED558CCD)
    return x ^ (x >> np.uint64(33))


def _ragged_row_sums(units: np.ndarray, offsets: np.ndarray):
    """(unit sum, length) of each row of a flat ragged buffer, by cumsum."""
    offs = np.asarray(offsets, np.int64)
    u = np.asarray(units, np.uint64)
    c = np.zeros((u.shape[0] + 1,), np.uint64)
    np.cumsum(u, out=c[1:])
    return c[offs[1:]] - c[offs[:-1]], (offs[1:] - offs[:-1])


def _script_class(maxs: np.ndarray, m: np.uint64) -> np.ndarray:
    """The ``lang`` key of rows whose largest code unit is ``maxs``: 0 for
    ASCII, else 1 + the unit's high byte, modulo the tenant count."""
    cls = np.where(maxs < 128, np.uint64(0), np.uint64(1) + (maxs >> np.uint64(8)))
    return (cls % m).astype(np.int32)


def tenant_route_keys(batch, num_tenants: int, mode: str = "hash") -> np.ndarray:
    """The tenant id [B] of each row of a host batch (``--tenantKey``).

    ``hash``: SplitMix64 over each row's (unit sum, length), a uniform
    A/B-arm split; a FeatureBatch keys off its hashed tokens' index sums and
    non-zero counts. ``lang``: a script class from the row's largest code
    unit (0 for pure ASCII, else keyed by that unit's high byte); it needs
    a units wire, since host-hashed tokens carry no script. Padding rows
    get some id too; every tenant batch masks them out."""
    m = np.uint64(num_tenants)
    if isinstance(batch, RaggedUnitBatch):
        sums, lengths = _ragged_row_sums(batch.units, batch.offsets)
        if mode == "lang":
            units = np.asarray(batch.units, np.uint64)
            offs = np.asarray(batch.offsets, np.int64)
            if units.shape[0] == 0:
                maxs = np.zeros(lengths.shape, np.uint64)
            else:
                maxs = np.maximum.reduceat(units, np.minimum(offs[:-1], units.shape[0] - 1))
            return _script_class(np.where(lengths > 0, maxs, np.uint64(0)), m)
    elif isinstance(batch, UnitBatch):
        units = np.asarray(batch.units, np.uint64)
        sums = units.sum(axis=1)
        lengths = np.asarray(batch.length, np.uint64)
        if mode == "lang":
            return _script_class(units.max(axis=1) if units.shape[1] else np.zeros_like(sums),
                                 m)
    elif isinstance(batch, FeatureBatch):
        if mode == "lang":
            raise ValueError("--tenantKey lang needs a raw-units wire (--hashOn device); "
                             "host-hashed tokens carry no script signal")
        sums = np.asarray(batch.token_idx, np.int64).astype(np.uint64).sum(axis=1)
        lengths = (np.asarray(batch.token_val) != 0).sum(axis=1).astype(np.uint64)
    else:
        raise TypeError(f"cannot route a {type(batch).__name__}")
    if mode != "hash":
        raise ValueError(f"tenant key mode must be 'hash' or 'lang', got {mode!r}")
    x = (sums.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
         + lengths.astype(np.uint64) * np.uint64(0xBF58476D1CE4E5B9))
    return (_splitmix(x) % m).astype(np.int32)


def tenant_rows(batch, tenant_ids: np.ndarray, num_tenants: int) -> list:
    """Each tenant's original row indices (valid rows only, ascending)."""
    valid = np.asarray(batch.mask) > 0
    ids = np.where(valid, np.asarray(tenant_ids), -1)
    return [np.nonzero(ids == m)[0] for m in range(num_tenants)]


def tenant_valid_rows(masks) -> list:
    """Each tenant part's rows up to its last valid one (mask > 0), from
    the host masks [M, B] (or M masks [B]): the rows the vmap form's kernel
    reads as X. A part from ``split_batch_tenants`` holds its valid rows at
    the front, so this is its valid count; a part with valid rows further
    back is bounded by its last one, and its masked rows before it stay
    masked."""
    out = []
    for mask in masks:
        rows = np.flatnonzero(np.asarray(mask) > 0)
        out.append(int(rows[-1]) + 1 if rows.size else 0)
    return out


def split_batch_tenants(batch, tenant_ids: np.ndarray, num_tenants: int) -> list:
    """One host batch -> M batches of its padded shape (row bucket, units
    buffer or token shape, ``row_len``): tenant m's valid rows packed to the
    front in their original order, a dry tenant all padding. The M batches
    share one wire signature, so ``stack_batches`` and ``pack_ragged_group``
    take them."""
    rows_per = tenant_rows(batch, tenant_ids, num_tenants)
    if isinstance(batch, RaggedUnitBatch):
        units = np.asarray(batch.units)
        offs = np.asarray(batch.offsets, np.int64)
        lengths = offs[1:] - offs[:-1]
        b = batch.mask.shape[0]
        out = []
        for rows in rows_per:
            lens_m = lengths[rows]
            total = int(lens_m.sum())
            units_m = np.zeros_like(units)
            cml = np.zeros((rows.shape[0] + 1,), np.int64)
            np.cumsum(lens_m, out=cml[1:])
            if total:
                idx = (np.arange(total, dtype=np.int64) - np.repeat(cml[:-1], lens_m)
                       + np.repeat(offs[rows], lens_m))
                units_m[:total] = units[idx]
            offs_m = np.full((b + 1,), total, np.int32)
            offs_m[: rows.shape[0] + 1] = cml.astype(np.int32)
            n = rows.shape[0]
            numeric = np.zeros_like(np.asarray(batch.numeric))
            label = np.zeros_like(np.asarray(batch.label))
            mask = np.zeros_like(np.asarray(batch.mask))
            numeric[:n] = np.asarray(batch.numeric)[rows]
            label[:n] = np.asarray(batch.label)[rows]
            mask[:n] = 1.0
            out.append(RaggedUnitBatch(units_m, offs_m, numeric, label, mask,
                                       row_len=batch.row_len))
        return out
    out = []
    for rows in rows_per:
        n = rows.shape[0]
        fields = []
        for arr in batch:
            arr = np.asarray(arr)
            dest = np.zeros_like(arr)
            dest[:n] = arr[rows]
            fields.append(dest)
        out.append(type(batch)(*fields))
    return out
