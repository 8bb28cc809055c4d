"""Device decode of the ragged units wire (counterpart of the single-segment
forms of ``twtml_tpu/ops/ragged.py``), as plain torch ops.

The ragged wire (features/batch.py ``RaggedUnitBatch``) ships text as
concatenated code units plus row offsets, the offsets as uint16 length
deltas when the packed layout allows. The step rebuilds the padded-wire
layout [B, L] on its device with one gather and folds ASCII case there,
which the padded wire's host pad copy did: the features are the padded
wire's, bit for bit. uint16 arrives as int16 (the same bits) and is widened
with ``& 0xFFFF``.
"""

from __future__ import annotations

import torch


def _widen(t):
    """Integer tensor -> int32 values; int16 holds uint16 bits."""
    w = t.to(torch.int32)
    return w & 0xFFFF if t.dtype == torch.int16 else w


def offsets_from_deltas(deltas):
    """uint16 per-row length deltas [..., B] -> int32 offsets [..., B+1]
    starting at 0: the decode half of the narrow offset wire."""
    d = _widen(deltas)
    zero = torch.zeros(d.shape[:-1] + (1,), dtype=torch.int32, device=d.device)
    return torch.cat([zero, torch.cumsum(d, dim=-1, dtype=torch.int32)], dim=-1)


def ragged_repad(units, offsets, row_len: int):
    """(flat units [N], int32 offsets [B+1], static L) -> (int32 [B, L]
    units with ASCII case folded and zeros past each row, int32 [B]
    lengths): the padded wire's layout. The gather's indices are clipped
    into the buffer, so a pad slot reads a real unit that ``where`` then
    zeroes: no scatter, no out-of-range read."""
    offs = offsets.to(torch.int32)
    starts, lens = offs[:-1], offs[1:] - offs[:-1]
    cols = torch.arange(row_len, dtype=torch.int32, device=units.device)[None, :]
    idx = torch.clamp(starts[:, None] + cols, 0, units.shape[0] - 1)
    buf = torch.where(cols < lens[:, None], _widen(units[idx.long()]), 0)
    upper = (buf >= 65) & (buf <= 90)
    return torch.where(upper, buf + 32, buf), lens
