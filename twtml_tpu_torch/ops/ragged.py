"""Device decode of the ragged units wire (counterpart of
``twtml_tpu/ops/ragged.py``), as plain torch ops, for the flat, group and
shard-segment layouts.

The ragged wire (features/batch.py ``RaggedUnitBatch``) ships text as
concatenated code units plus row offsets, the offsets as uint16 length
deltas when the packed layout allows. The step rebuilds the padded-wire
layout [B, L] on its device with one gather and folds ASCII case there,
which the padded wire's host pad copy did: the features are the padded
wire's, bit for bit. uint16 arrives as int16 (the same bits) and is widened
with ``& 0xFFFF``. Under ``--wireCodec dict`` the uint8 units arrive
digram-coded and ``units_from_codes`` decodes them first.
"""

from __future__ import annotations

import torch

# the digram decode table [128, 2] as int32, flattened, one a device
_DECODE_TABLES: dict = {}


def _widen(t):
    """Integer tensor -> int32 values; int16 holds uint16 bits."""
    w = t.to(torch.int32)
    return w & 0xFFFF if t.dtype == torch.int16 else w


def offsets_from_deltas(deltas, num_segments: int = 1):
    """uint16 per-row length deltas [..., S·B_s] -> int32 offsets [...,
    S·(B_s+1)], each of the S segments starting at 0: the decode half of
    the narrow offset wire (a shard-segment wire carries one segment a
    shard)."""
    d = _widen(deltas)
    lead = d.shape[:-1]
    d = d.reshape(lead + (num_segments, -1))
    zero = torch.zeros(lead + (num_segments, 1), dtype=torch.int32, device=d.device)
    out = torch.cat([zero, torch.cumsum(d, dim=-1, dtype=torch.int32)], dim=-1)
    return out.reshape(lead + (-1,))


def ragged_repad(units, offsets, row_len: int, num_segments: int = 1):
    """(flat units [N], int32 offsets, static L) -> (int32 [B, L] units with
    ASCII case folded and zeros past each row, int32 [B] lengths): the
    padded wire's layout. A shard-aligned buffer (``num_segments`` S > 1)
    holds S equal unit sub-buffers and S segment-relative [B/S + 1] offset
    blocks; segment s's starts shift by s·N/S. The gather's indices are
    clipped into the buffer, so a pad slot reads a real unit that
    ``where`` then zeroes: no scatter, no out-of-range read."""
    offs = offsets.to(torch.int32)
    if num_segments > 1:
        ob = offs.reshape(num_segments, -1)
        base = (torch.arange(num_segments, dtype=torch.int32, device=units.device)
                * (units.shape[0] // num_segments))[:, None]
        starts = (ob[:, :-1] + base).reshape(-1)
        lens = (ob[:, 1:] - ob[:, :-1]).reshape(-1)
    else:
        starts, lens = offs[:-1], offs[1:] - offs[:-1]
    cols = torch.arange(row_len, dtype=torch.int32, device=units.device)[None, :]
    idx = torch.clamp(starts[:, None] + cols, 0, units.shape[0] - 1)
    buf = torch.where(cols < lens[:, None], _widen(units[idx.long()]), 0)
    upper = (buf >= 65) & (buf <= 90)
    return torch.where(upper, buf + 32, buf), lens


def _decode_table(device: torch.device) -> torch.Tensor:
    """The codec's [128, 2] decode table, flattened to int32 [256], on
    ``device``, made once a device: from page-locked memory with a
    non-blocking copy on cuda (no host sync, so a first use inside a
    sync-debug window passes), the host array kept with it until then."""
    key = str(device)
    got = _DECODE_TABLES.get(key)
    if got is None:
        from ..features.wirecodec import decode_table

        host = torch.from_numpy(decode_table().astype("int32").reshape(-1))
        if device.type == "cuda":
            host = host.pin_memory()
        got = _DECODE_TABLES[key] = (host, host.to(device, non_blocking=True))
    return got[1]


def units_from_codes(codes, out_len: int):
    """Digram-coded units [..., M] (uint8: literals < 128, dictionary codes
    >= 128 for two units) -> the raw uint8 units [..., out_len] (the JAX
    package's ``units_from_codes``, the same bytes). A bounded
    gather-expand: each code's expanded length (1 or 2), their running sum
    (the codes' ends), one ``searchsorted`` mapping each of the
    ``out_len`` output slots to its code, and gathers through the table.
    No host sync and no data-dependent shape (``out_len`` is the layout's),
    so it runs inside a captured CUDA graph; padding codes past
    ``out_len`` are never read. Leading axes pass through (a group's [K,
    M] decodes in one call)."""
    from ..features.wirecodec import CODE_BASE

    lead, m = tuple(codes.shape[:-1]), codes.shape[-1]
    rows = 1
    for d in lead:
        rows *= d
    if out_len == 0 or m == 0 or rows == 0:
        return torch.zeros(lead + (out_len,), dtype=torch.uint8, device=codes.device)
    c = codes.reshape(rows, m).to(torch.int32)
    lens = 1 + (c >= CODE_BASE).to(torch.int32)
    ends = torch.cumsum(lens, dim=-1, dtype=torch.int32)  # inclusive ends
    t = torch.arange(out_len, dtype=torch.int32, device=c.device).expand(rows, out_len)
    j = torch.searchsorted(ends, t.contiguous(), right=True).clamp_(max=m - 1)
    cj = torch.gather(c, 1, j)
    start = torch.gather(ends - lens, 1, j)
    k = (t - start).clamp_(0, 1)
    slot = (cj - CODE_BASE).clamp_(0, CODE_BASE - 1) * 2 + k
    out = torch.where(cj < CODE_BASE, cj, _decode_table(c.device)[slot.long()])
    return out.to(torch.uint8).reshape(lead + (out_len,))
