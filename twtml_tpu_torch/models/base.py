"""Shared learner contracts (counterpart of ``twtml_tpu/models/base.py``)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class StepOutput(NamedTuple):
    """Device results of one micro-batch step. ``predictions`` keeps the full
    padded [B] vector (``mask`` decides validity); the scalars are the
    dashboard stats; ``quality`` is the ``--modelWatch`` quality vector
    (ops/quality.QUALITY_FIELDS), None when the plane is off."""

    predictions: torch.Tensor  # [B] rounded predictions (pre-update weights)
    count: torch.Tensor  # scalar: valid rows in this batch
    mse: torch.Tensor  # scalar: mean((y - round(y_hat))^2) over valid rows
    real_stdev: torch.Tensor  # scalar: population stdev of labels
    pred_stdev: torch.Tensor  # scalar: population stdev of rounded preds
    quality: Optional[torch.Tensor] = None  # [QUALITY_WIDTH] side channel
