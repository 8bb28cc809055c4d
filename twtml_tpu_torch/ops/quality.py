"""In-step model/data quality vector (counterpart of ``twtml_tpu/ops/quality.py``,
single device).

One fixed ``[QUALITY_WIDTH]`` f32 vector computed in the same step as the
training update, observation only: no value feeds back into the weights,
predictions or reported stats. The layout (``QUALITY_FIELDS``) is the JAX
package's, field for field:

- ``weight_norm`` / ``update_norm``: ||w_new|| and ||w_new - w_prev||;
- ``grad_norm``: L2 norm of the masked pre-update residual;
- prediction / label / residual means and population variances (masked);
- per-column means and variances of the 4 dense numeric features;
- ``bucket_occupancy`` / ``bucket_top_share``: a ``QUALITY_NBINS``-bin folded
  histogram of the hashed token mass (fraction of bins touched, share of the
  largest bin).
"""

from __future__ import annotations

import torch

QUALITY_NBINS = 32
NUM_NUMERIC = 4

QUALITY_FIELDS = (
    "weight_norm",
    "update_norm",
    "grad_norm",
    "pred_mean",
    "pred_var",
    "label_mean",
    "label_var",
    "resid_mean",
    "resid_var",
    "num_mean_0",
    "num_mean_1",
    "num_mean_2",
    "num_mean_3",
    "num_var_0",
    "num_var_1",
    "num_var_2",
    "num_var_3",
    "bucket_occupancy",
    "bucket_top_share",
)
QUALITY_WIDTH = len(QUALITY_FIELDS)
QUALITY_INDEX = {name: i for i, name in enumerate(QUALITY_FIELDS)}


def quality_vector(
    w_prev, w_new, *, residual, preds, labels, mask, numeric, token_idx, token_val
):
    """The ``[QUALITY_WIDTH]`` f32 quality vector for one micro-batch.

    ``residual`` is the masked pre-update residual, ``preds`` the reported
    (rounded) predictions, ``mask`` the valid-row mask."""
    f32 = torch.float32
    m = mask.to(f32)
    denom = torch.clamp(torch.sum(m), min=1.0)

    w_sq = torch.sum(w_new.to(f32) ** 2)
    upd_sq = torch.sum((w_new.to(f32) - w_prev.to(f32)) ** 2)
    grad_sq = torch.sum(residual.to(f32) ** 2)

    def moments(x):
        x = x.to(f32)
        mean = torch.sum(x * m) / denom
        var = torch.sum(x * x * m) / denom - mean * mean
        return mean, torch.clamp(var, min=0.0)

    pred_mean, pred_var = moments(preds)
    label_mean, label_var = moments(labels)
    resid_mean, resid_var = moments(labels.to(f32) - preds.to(f32))

    if numeric.shape[1] != NUM_NUMERIC:
        raise ValueError(
            f"quality_vector pins {NUM_NUMERIC} numeric columns "
            f"(QUALITY_FIELDS layout); got {numeric.shape[1]}"
        )
    num = numeric.to(f32)
    num_mean = torch.sum(num * m[:, None], dim=0) / denom
    num_sq = torch.sum(num * num * m[:, None], dim=0) / denom
    num_var = torch.clamp(num_sq - num_mean * num_mean, min=0.0)

    # folded hash-bucket histogram; padding tokens carry zero value and
    # padded rows are masked, so only real token mass lands in the bins.
    # The values are integer counts, so the order of the adds is exact.
    # Each row's mass goes into its own 32 bins first (a [B, 32] scatter
    # with few collisions), then the rows are summed: not index_add_, whose
    # global atomics on 32 addresses cost ~1 ms a step at B = 16384
    # (chip_smoke.py's step profile), and not bincount, which reads the
    # input's max back to the host on CUDA (a sync inside the dispatch).
    # Every partial sum is an integer below 2**24, so the bins are exact.
    folded = torch.bitwise_and(token_idx.to(torch.int64), QUALITY_NBINS - 1)
    folded = folded.reshape(folded.shape[0], -1)
    tv = (token_val.to(f32) * m[:, None]).reshape(folded.shape)
    row_bins = torch.zeros((folded.shape[0], QUALITY_NBINS), dtype=f32, device=tv.device)
    bins = row_bins.scatter_add_(1, folded, tv).sum(dim=0)
    total = torch.sum(bins)
    occupancy = torch.mean((bins > 0).to(f32))
    top_share = torch.max(bins) / torch.clamp(total, min=1.0)

    return torch.stack(
        [
            torch.sqrt(w_sq),
            torch.sqrt(upd_sq),
            torch.sqrt(grad_sq),
            pred_mean,
            pred_var,
            label_mean,
            label_var,
            resid_mean,
            resid_var,
        ]
        + [num_mean[i] for i in range(NUM_NUMERIC)]
        + [num_var[i] for i in range(NUM_NUMERIC)]
        + [occupancy, top_share]
    ).to(f32)
