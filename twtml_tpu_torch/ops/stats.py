"""Masked on-device batch statistics (counterpart of ``twtml_tpu/ops/stats.py``),
on one device or, with ``reduce``, over the ranks of a data-parallel group.

count / MSE / stdev(real) / stdev(pred) over the valid rows. ``RDD.stdev`` is
the population stdev, computed as E[x^2] - E[x]^2 clamped at 0 (not
``torch.std``, which is the sample stdev and sums in another order). The
rows are the last axis: [M, B] inputs (a tenant stack's vmap form) give
[M] stats, one a tenant.
"""

from __future__ import annotations

import torch


def masked_sum(x, mask):
    return torch.sum(x * mask, dim=-1)


def masked_count(mask):
    return torch.sum(mask, dim=-1)


def masked_mean(x, mask):
    return masked_sum(x, mask) / torch.clamp(masked_count(mask), min=1.0)


def masked_stdev(x, mask):
    """Population standard deviation over valid rows (Spark RDD.stdev)."""
    mean = masked_mean(x, mask)
    var = masked_mean(x * x, mask) - mean * mean
    return torch.sqrt(torch.clamp(var, min=0.0))


def batch_stats(labels, rounded_preds, mask, reduce=None) -> dict:
    """count, mse(y, rounded y_hat), stdev(y), stdev(y_hat). With ``reduce``
    (a data-parallel group's in-place SUM of a float tensor over its ranks,
    the JAX package's ``psum`` over the data axis) the six sums are this
    rank's rows' and go through ONE ``reduce`` before the divisions, so
    every rank gets the global stats; without it the sums are taken in the
    same order, and the results are the single-device ones. [M, B] inputs
    reduce their [6, M] sums in the same one call."""
    if reduce is None:
        count = masked_count(mask)
        err = (labels - rounded_preds) * mask
        mse = torch.sum(err * err, dim=-1) / torch.clamp(count, min=1.0)
        return {
            "count": count,
            "mse": mse,
            "real_stdev": masked_stdev(labels, mask),
            "pred_stdev": masked_stdev(rounded_preds, mask),
        }
    err = (labels - rounded_preds) * mask
    sums = torch.stack([
        masked_count(mask), torch.sum(err * err, dim=-1),
        masked_sum(labels, mask), masked_sum(labels * labels, mask),
        masked_sum(rounded_preds, mask), masked_sum(rounded_preds * rounded_preds, mask),
    ])
    reduce(sums)
    count, sq_err, y, yy, p, pp = sums.unbind()
    denom = torch.clamp(count, min=1.0)

    def stdev(total, total_sq):
        mean = total / denom
        return torch.sqrt(torch.clamp(total_sq / denom - mean * mean, min=0.0))

    return {"count": count, "mse": sq_err / denom, "real_stdev": stdev(y, yy),
            "pred_stdev": stdev(p, pp)}
