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
    w_prev, w_new, *, residual, preds, labels, mask, numeric, token_idx, token_val,
    reduce=None,
):
    """The ``[QUALITY_WIDTH]`` f32 quality vector for one micro-batch, or
    [M, QUALITY_WIDTH] for M tenants at once (the vmap form: every input
    with a leading [M], the sums taken per tenant).

    ``residual`` is the masked pre-update residual, ``preds`` the reported
    (rounded) predictions, ``mask`` the valid-row mask. With ``reduce`` (a
    data-parallel group's in-place SUM over its ranks, the JAX package's
    ``psum`` over the data axis) the row inputs are this rank's, and their
    sums (count, squared residual, moments, numeric moments, the 32 bins)
    go through ONE ``reduce`` before any division, so every rank gets the
    global vector; the weights are replicated and need none."""
    f32 = torch.float32
    m = mask.to(f32)

    w_sq = torch.sum(w_new.to(f32) ** 2, dim=-1)
    upd_sq = torch.sum((w_new.to(f32) - w_prev.to(f32)) ** 2, dim=-1)

    if numeric.shape[-1] != NUM_NUMERIC:
        raise ValueError(
            f"quality_vector pins {NUM_NUMERIC} numeric columns "
            f"(QUALITY_FIELDS layout); got {numeric.shape[-1]}"
        )
    num = numeric.to(f32)
    x_p, x_l = preds.to(f32), labels.to(f32)
    x_r = x_l - x_p

    # folded hash-bucket histogram; padding tokens carry zero value and
    # padded rows are masked, so only real token mass lands in the bins.
    # The values are integer counts, so the order of the adds is exact.
    # Each row's mass goes into its own 32 bins first (a [B, 32] scatter
    # with few collisions), then the rows are summed: not index_add_, whose
    # global atomics on 32 addresses cost ~1 ms a step at B = 16384
    # (chip_smoke.py's step profile), and not bincount, which reads the
    # input's max back to the host on CUDA (a sync inside the dispatch).
    # Every partial sum is an integer below 2**24, so the bins are exact.
    lead = m.shape[:-1]  # () for one batch, (M,) for M tenants
    rows = m.numel()
    folded = torch.bitwise_and(token_idx.to(torch.int64), QUALITY_NBINS - 1)
    folded = folded.reshape(rows, -1)
    tv = (token_val.to(f32) * m[..., None]).reshape(folded.shape)
    row_bins = torch.zeros((rows, QUALITY_NBINS), dtype=f32, device=tv.device)
    bins = row_bins.scatter_add_(1, folded, tv).reshape(lead + (-1, QUALITY_NBINS)).sum(dim=-2)

    # every sum over the rows, in one vector: [count, Σr², Σx·m, Σx²·m for
    # preds, labels and labels − preds, the numeric sums, their squares,
    # the bins]
    sums = torch.cat([
        torch.stack([
            torch.sum(m, dim=-1), torch.sum(residual.to(f32) ** 2, dim=-1),
            torch.sum(x_p * m, dim=-1), torch.sum(x_p * x_p * m, dim=-1),
            torch.sum(x_l * m, dim=-1), torch.sum(x_l * x_l * m, dim=-1),
            torch.sum(x_r * m, dim=-1), torch.sum(x_r * x_r * m, dim=-1),
        ], dim=-1),
        torch.sum(num * m[..., None], dim=-2),
        torch.sum(num * num * m[..., None], dim=-2),
        bins,
    ], dim=-1)
    if reduce is not None:
        reduce(sums)
    denom = torch.clamp(sums[..., 0], min=1.0)

    def moments(at: int):
        mean = sums[..., at] / denom
        var = sums[..., at + 1] / denom - mean * mean
        return mean, torch.clamp(var, min=0.0)

    pred_mean, pred_var = moments(2)
    label_mean, label_var = moments(4)
    resid_mean, resid_var = moments(6)
    num_mean = sums[..., 8:8 + NUM_NUMERIC] / denom[..., None]
    num_sq = sums[..., 8 + NUM_NUMERIC:8 + 2 * NUM_NUMERIC] / denom[..., None]
    num_var = torch.clamp(num_sq - num_mean * num_mean, min=0.0)
    bins = sums[..., 8 + 2 * NUM_NUMERIC:]
    total = torch.sum(bins, dim=-1)
    occupancy = torch.mean((bins > 0).to(f32), dim=-1)
    top_share = torch.amax(bins, dim=-1) / torch.clamp(total, min=1.0)

    return torch.stack(
        [
            torch.sqrt(w_sq),
            torch.sqrt(upd_sq),
            torch.sqrt(sums[..., 1]),
            pred_mean,
            pred_var,
            label_mean,
            label_var,
            resid_mean,
            resid_var,
        ]
        + [num_mean[..., i] for i in range(NUM_NUMERIC)]
        + [num_var[..., i] for i in range(NUM_NUMERIC)]
        + [occupancy, top_share],
        dim=-1,
    ).to(f32)
