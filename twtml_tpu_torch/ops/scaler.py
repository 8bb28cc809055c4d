"""Per-batch standard scaling (counterpart of ``twtml_tpu/ops/scaler.py``;
the reference's MLlib ``new StandardScaler(false, true).fit(rdd)
.transform(rdd)`` in the k-means entry).

``withMean=false, withStd=true``: each column divided by its standard
deviation, no centering. The variance is the unbiased sample variance
(n − 1), as MLlib's summarizer computes it; a column with zero std maps to
0.0. Masked rows are left out of the fit and zeroed in the output.
"""

from __future__ import annotations

import torch


def standard_scale(points, mask):
    """points [B, D], mask [B] -> scaled [B, D], on the tensors' device."""
    m = mask[:, None]
    n = torch.clamp(torch.sum(mask), min=1.0)
    mean = torch.sum(points * m, dim=0) / n
    var = torch.sum(((points - mean) * m) ** 2, dim=0) / torch.clamp(n - 1.0, min=1.0)
    std = torch.sqrt(var)
    factor = torch.where(std > 0, 1.0 / torch.clamp(std, min=1e-30), 0.0)
    return points * factor[None, :] * m
