"""Masked on-device batch statistics (counterpart of ``twtml_tpu/ops/stats.py``,
single device, no mesh axis).

count / MSE / stdev(real) / stdev(pred) over the valid rows. ``RDD.stdev`` is
the population stdev, computed as E[x^2] - E[x]^2 clamped at 0 (not
``torch.std``, which is the sample stdev and sums in another order).
"""

from __future__ import annotations

import torch


def masked_sum(x, mask):
    return torch.sum(x * mask)


def masked_count(mask):
    return torch.sum(mask)


def masked_mean(x, mask):
    return masked_sum(x, mask) / torch.clamp(masked_count(mask), min=1.0)


def masked_stdev(x, mask):
    """Population standard deviation over valid rows (Spark RDD.stdev)."""
    mean = masked_mean(x, mask)
    var = masked_mean(x * x, mask) - mean * mean
    return torch.sqrt(torch.clamp(var, min=0.0))


def batch_stats(labels, rounded_preds, mask) -> dict:
    """count, mse(y, rounded y_hat), stdev(y), stdev(y_hat)."""
    count = masked_count(mask)
    err = (labels - rounded_preds) * mask
    mse = torch.sum(err * err) / torch.clamp(count, min=1.0)
    return {
        "count": count,
        "mse": mse,
        "real_stdev": masked_stdev(labels, mask),
        "pred_stdev": masked_stdev(rounded_preds, mask),
    }
