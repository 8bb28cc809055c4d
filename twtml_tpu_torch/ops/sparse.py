"""Sparse-to-dense feature assembly and the sparse regime's gather and
scatter (counterpart of ``twtml_tpu/ops/sparse.py``).

The dense regime (numTextFeatures <= 8192, the default 1000 + 4 numeric
dims) scatters the padded (idx, val) token pairs into a dense [B, F_text]
matrix once per batch; every SGD iteration then runs on that matrix. The
sparse regime (numTextFeatures = 2^18, BASELINE config #4) never forms it:
predictions gather the weights at the token indices (``sparse_predict``),
and the per-iteration loop's gradient scatters the residuals back
(``sparse_grad_text``). Padded token slots carry (idx 0, val 0) and add
nothing to either. Both take a leading tenant axis (the vmap form of a
tenant stack): M parts' [M, B, L] tokens against [M, F] weights, tenant
m's indices offset by m rows of the weights into ONE gather and ONE
``index_add_``.
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


def _tenant_index(token_idx, row_stride: int):
    """[M, B, L] indices as flat indices into M rows of ``row_stride``
    elements: tenant m's offset by m·row_stride."""
    offsets = torch.arange(token_idx.shape[0], device=token_idx.device) * row_stride
    return (token_idx.long() + offsets[:, None, None]).reshape(-1)


def sparse_text_dot(w_text, token_idx, token_val):
    """sum_j w_text[idx_j] * val_j for each row: the text half of the sparse
    dot. One gather, then a sum over each row's [L] products, in a fixed
    order (torch's reduction of a given shape does not depend on the data).
    With a leading tenant axis (``w_text`` [M, F], the tokens [M, B, L]) the
    gather reads tenant m's row of ``w_text``, which may be a view of wider
    rows (the [M, F + 4] stack's text columns): read in place, no copy."""
    if token_idx.dim() == 3:
        m, f = w_text.shape
        stride = w_text.stride(0)
        flat = w_text.as_strided(((m - 1) * stride + f,), (1,))
        gathered = flat.index_select(0, _tenant_index(token_idx, stride))
        return torch.sum(gathered.view(token_idx.shape) * token_val, dim=-1)
    b, l = token_idx.shape
    gathered = w_text.index_select(0, token_idx.reshape(-1)).view(b, l)
    return torch.sum(gathered * token_val, dim=1)


def sparse_predict(w_text, w_num, token_idx, token_val, numeric):
    """y_hat = sum_j w_text[idx_j] * val_j + numeric . w_num, the dense
    matrix never formed (MLlib's SparseVector dot); [M, B] for M tenants'
    [M, F] and [M, 4] weights on their [M, B] rows."""
    if token_idx.dim() == 3:
        num = torch.bmm(numeric, w_num[..., None])[..., 0]
        return sparse_text_dot(w_text, token_idx, token_val) + num
    return sparse_text_dot(w_text, token_idx, token_val) + numeric @ w_num


def sparse_grad_text(token_idx, token_val, residual, num_text_features: int):
    """The text half of the least-squares gradient sum, sum_i r_i * x_i: a
    scatter-add of r_i * val_ij at idx_ij into [F_text].

    ``index_add_``: sequential (so bitwise reproducible) on the CPU; float
    atomics on CUDA, whose order, and so whose last bits, change from run to
    run where two rows share a feature: two 50-iteration runs of the scatter
    loop on one 2,048-tweet batch at 2^18 ended 3.8e-6 apart on an H100
    (chip_smoke.py's ``sparse`` phase reports it each run). The scatter
    route is held within tolerance, not bitwise; the Gram route's kernels
    use no atomics.

    With a leading tenant axis ([M, B, L] tokens, [M, B] residuals) the M
    tenants' sums go into one [M·F] buffer, tenant m's at m·F: [M, F].
    """
    contrib = (token_val * residual[..., None]).reshape(-1)
    if token_idx.dim() == 3:
        m = token_idx.shape[0]
        out = torch.zeros((m * num_text_features,), dtype=contrib.dtype, device=contrib.device)
        out.index_add_(0, _tenant_index(token_idx, num_text_features), contrib)
        return out.view(m, num_text_features)
    out = torch.zeros((num_text_features,), dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, token_idx.reshape(-1), contrib)
