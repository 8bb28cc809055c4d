"""On-device char-bigram HashingTF (counterpart of ``twtml_tpu/ops/text_hash.py``).

Java ``String.hashCode`` of a 2-unit string is ``31*c1 + c2`` over its UTF-16
code units (at most 31*65535 + 65535 < 2^31: no wraparound, never negative),
so the device hashes the padded code units with two shifted loads, a
multiply-add and a mod. Semantics as in features/hashing.py:
- length >= 2: units [u0..u_{n-1}] give n-1 terms, term j hashing to
  ``(31*u_j + u_{j+1}) % F``;
- length == 1: the 1-char string is the single term, hashing to ``u_0 % F``;
- length == 0: no terms (padding rows).
"""

from __future__ import annotations

import torch


def hash_bigrams_device(units, length, num_features: int, dtype=torch.float32):
    """[B, L] code units + [B] lengths -> ([B, L-1] int32 idx, [B, L-1] val).

    ``units`` may be uint8, int32, or uint16 carried as int16 (the units wire
    reinterprets uint16 as int16 for the transfer; the low 16 bits are the
    code unit). Padded slots give idx 0 and val 0.
    """
    u = units.to(torch.int32)
    if units.dtype == torch.int16:
        u = u & 0xFFFF
    length = length.to(torch.int32)
    h = 31 * u[:, :-1] + u[:, 1:]
    single = length == 1
    # sliding(2) on a single-unit string yields the string itself: the
    # row's one term hashes to u0 (Java hashCode of a 1-char string)
    h[:, 0] = torch.where(single, u[:, 0], h[:, 0])
    n_terms = torch.where(single, 1, torch.clamp(length - 1, min=0))
    cols = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    valid = cols[None, :] < n_terms[:, None]
    token_idx = torch.where(valid, h % num_features, 0)
    token_val = valid.to(dtype)
    return token_idx, token_val
