"""Sparse-to-dense feature assembly (counterpart of ``densify_text`` in
``twtml_tpu/ops/sparse.py``).

The dense regime (numTextFeatures <= 8192, the default 1000 + 4 numeric
dims) scatters the padded (idx, val) token pairs into a dense [B, F_text]
matrix once per batch; every SGD iteration then runs on that matrix. Padded
token slots carry (idx 0, val 0) and add nothing.
"""

from __future__ import annotations

import torch


def densify_text(token_idx, token_val, num_text_features: int):
    """[B, L] (idx, val) pairs -> dense [B, F_text] term-frequency matrix.
    The values are integer counts, so the order in which the scatter adds
    them does not change the result. A flat ``scatter_add_`` (atomics into
    mostly distinct addresses), not ``index_put_(accumulate=True)``, which
    sorts the indices first on CUDA (~0.5 ms a step at B = 16384,
    chip_smoke.py's step profile)."""
    b = token_idx.shape[0]
    rows = torch.arange(b, device=token_idx.device)[:, None] * num_text_features
    flat = (rows + token_idx.long()).reshape(-1)
    dense = torch.zeros(
        (b, num_text_features), dtype=token_val.dtype, device=token_val.device
    )
    dense.view(-1).scatter_add_(0, flat, token_val.reshape(-1))
    return dense
