"""Streaming linear regression with SGD, the flagship model (counterpart of
``twtml_tpu/models/linear.py``): least-squares gradient, identity link,
HALF_UP-rounded predictions for the reported metrics, default step 0.005
(reference.conf:4)."""

from __future__ import annotations

from .sgd import StreamingSGDModel


class StreamingLinearRegressionWithSGD(StreamingSGDModel):
    round_predictions = True
    default_step_size = 0.005  # reference.conf:4
