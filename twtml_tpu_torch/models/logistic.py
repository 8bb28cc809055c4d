"""Streaming logistic regression with SGD (counterpart of
``twtml_tpu/models/logistic.py``; BASELINE config #3, binary sentiment on
the tweet stream).

MLlib's ``StreamingLogisticRegressionWithSGD``: the linear learner's SGD
core with the logistic gradient multiplier σ(w·x) − y (LogisticGradient)
and thresholded class predictions, σ(w·x) > 0.5 → 1.0 (MLlib's default
threshold). At ``-b 1`` in float32 the step runs the fused kernel in its
logistic mode (ops/fused_sgd.py); ``-b < 1`` and ``--dtype bfloat16`` run
the torch loop with the same residual.
"""

from __future__ import annotations

import torch

from ..ops.fused_sgd import logistic_residual
from .sgd import StreamingSGDModel


def threshold_prediction(raw):
    """σ(raw) > 0.5 as 0/1 in raw's type. Not ``raw > 0``: σ of a tiny
    positive margin rounds to exactly 0.5, so the two differ there."""
    return (torch.sigmoid(raw) > 0.5).to(raw.dtype)


class StreamingLogisticRegressionWithSGD(StreamingSGDModel):
    residual_fn = staticmethod(logistic_residual)
    prediction_fn = staticmethod(threshold_prediction)
    round_predictions = False  # already a hard 0/1 class
    default_step_size = 0.1  # MLlib StreamingLogisticRegressionWithSGD default
