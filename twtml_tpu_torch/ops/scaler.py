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


def standard_scale(points, mask, reduce=None):
    """points [B, D], mask [B] -> scaled [B, D], on the tensors' device.
    With ``reduce`` (a data-parallel group's in-place SUM; each rank holds
    its rows of the global batch) the fit is the global batch's: the
    column sums and the count, then the squared deviations, are summed over
    the ranks (two all-reduces)."""
    m = mask[:, None]
    if reduce is None:
        n = torch.clamp(torch.sum(mask), min=1.0)
        mean = torch.sum(points * m, dim=0) / n
        sq = torch.sum(((points - mean) * m) ** 2, dim=0)
    else:
        sums = reduce(torch.cat([torch.sum(points * m, dim=0), torch.sum(mask)[None]]))
        n = torch.clamp(sums[-1], min=1.0)
        mean = sums[:-1] / n
        sq = reduce(torch.sum(((points - mean) * m) ** 2, dim=0))
    var = sq / torch.clamp(n - 1.0, min=1.0)
    std = torch.sqrt(var)
    factor = torch.where(std > 0, 1.0 / torch.clamp(std, min=1e-30), 0.0)
    return points * factor[None, :] * m
