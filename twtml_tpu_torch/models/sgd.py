"""Fused streaming-SGD step, dense regime (counterpart of a subset of
``twtml_tpu/models/sgd.py``).

Per micro-batch: hash the bigrams on the device, densify to [B, F_text] and
append the 4 numeric features, predict with the pre-update weights and
round HALF_UP, compute the batch stats (and the quality vector under
``--modelWatch``), then run ``numIterations`` of MLlib's GradientDescent.

MLlib semantics kept (``sgd_inner_loop``): 1-indexed stepSize/sqrt(i); L2
pre-scale w <- w(1 - eta*lambda); an iteration with zero samples leaves w
unchanged; converged once ||w_i - w_{i-1}|| < tol * max(||w_i||, 1), then
frozen.

The loop runs in ``ops/fused_sgd.fused_dense_sgd``: the hand-written kernel
when the model is on ``cuda``, its plain twin on the CPU. The predictions
are that call's ``raw_predictions`` output (X in bf16 times the pre-update
weights, summed in f32): the text counts are exact in bf16 and the numeric
features are of order 1e-6, so this differs from the JAX package's f32
``x @ w`` only in summation order and in the last bits of the numeric terms.

Outside this slice, configurations raise ``NotImplementedError``: the
sparse regime (numTextFeatures > 8192), Bernoulli mini-batch sampling
(miniBatchFraction < 1) and weight types other than float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..features.batch import NUM_NUMBER_FEATURES, FeatureBatch, UnitBatch
from ..ops.fused_sgd import fused_dense_sgd
from ..ops.quality import quality_vector
from ..ops.sparse import densify_text
from ..ops.stats import batch_stats
from ..ops.text_hash import hash_bigrams_device
from ..utils.device import resolve_device
from ..utils.rounding import torch_round_half_up
from .base import StepOutput

# above this text-feature count the JAX package switches to its sparse
# (gather/scatter, Gram) regime
DENSE_TEXT_FEATURE_LIMIT = 8192


def sgd_inner_loop(
    weights, *, num_iterations: int, step_size: float, l2_reg: float,
    convergence_tol: float, grad_and_count,
):
    """MLlib's GradientDescent loop over a weight tensor, with no host sync.

    ``grad_and_count(w)`` returns (gradient sum, selected count) as tensors.
    The arithmetic is the JAX loop's in f32: eta = f32(step)/sqrt(f32(i)),
    w * (1 - eta*lambda) - (eta * g) / max(count, 1)."""
    w = weights
    converged = torch.zeros((), dtype=torch.bool, device=w.device)
    for it in range(1, num_iterations + 1):
        grad_sum, count = grad_and_count(w)
        denom = torch.clamp(count, min=1.0)
        eta = np.float32(step_size) / np.sqrt(np.float32(it))
        scale = np.float32(1.0) - eta * np.float32(l2_reg)
        w_new = w * float(scale) - float(eta) * grad_sum / denom
        w_new = torch.where(count > 0, w_new, w)  # zero samples: no update
        if convergence_tol > 0:
            delta = torch.sqrt(torch.sum((w_new - w) ** 2))
            norm_new = torch.sqrt(torch.sum(w_new * w_new))
            conv_now = (count > 0) & (
                delta < convergence_tol * torch.clamp(norm_new, min=1.0)
            )
        else:
            conv_now = torch.zeros((), dtype=torch.bool, device=w.device)
        w = torch.where(converged, w, w_new)
        converged = converged | conv_now
    return w


def _check_slice(num_text_features: int, mini_batch_fraction: float, dtype) -> None:
    if num_text_features > DENSE_TEXT_FEATURE_LIMIT:
        raise NotImplementedError(
            f"numTextFeatures {num_text_features} > {DENSE_TEXT_FEATURE_LIMIT} "
            "needs the sparse/Gram regime (ROADMAP A6), not ported yet"
        )
    if mini_batch_fraction < 1.0:
        raise NotImplementedError(
            "miniBatchFraction < 1 needs the threefry Bernoulli sampling port "
            "(ROADMAP A2), not ported yet"
        )
    if dtype != torch.float32:
        raise NotImplementedError(
            f"dtype {dtype} is not ported; the port trains float32 weights"
        )


def make_sgd_train_step(
    *,
    num_text_features: int,
    num_iterations: int,
    step_size: float,
    mini_batch_fraction: float = 1.0,
    l2_reg: float = 0.0,
    convergence_tol: float = 0.001,
    round_predictions: bool = True,
    quality: bool = False,
    dtype=torch.float32,
):
    """Build the (weights, batch) -> (new_weights, StepOutput) step of the
    least-squares learner. ``batch`` is a FeatureBatch or UnitBatch of
    tensors on the weights' device."""
    _check_slice(num_text_features, mini_batch_fraction, dtype)
    f_text = num_text_features

    def train_step(weights, batch):
        if isinstance(batch, UnitBatch):
            token_idx, token_val = hash_bigrams_device(
                batch.units, batch.length, f_text, dtype
            )
        else:
            token_idx = batch.token_idx.to(torch.int32)
            token_val = batch.token_val.to(dtype)
        mask = batch.mask.to(dtype)
        labels = batch.label.to(dtype)
        numeric = batch.numeric.to(dtype)
        x_dense = torch.cat(
            [densify_text(token_idx, token_val, f_text), numeric], dim=1
        )
        w_new, raw = fused_dense_sgd(
            x_dense, labels, mask, weights,
            num_iterations=num_iterations, step_size=step_size,
            l2_reg=l2_reg, convergence_tol=convergence_tol,
        )
        preds = torch_round_half_up(raw) if round_predictions else raw
        stats = batch_stats(labels, preds, mask)
        q = None
        if quality:
            q = quality_vector(
                weights, w_new, residual=(raw - labels) * mask, preds=preds,
                labels=labels, mask=mask, numeric=numeric,
                token_idx=token_idx, token_val=token_val,
            )
        return w_new, StepOutput(predictions=preds, quality=q, **stats)

    return train_step


def zero_weights(num_text_features: int, dtype=torch.float32, device="cpu"):
    """MLlib initial weights: zeros(numFeatures) (LinearRegression.scala:32)."""
    return torch.zeros(
        (num_text_features + NUM_NUMBER_FEATURES,), dtype=dtype, device=device
    )


def batch_to_device(batch: FeatureBatch | UnitBatch, device):
    """Host numpy batch -> the same NamedTuple of tensors on ``device``.
    uint16 code units travel as int16 (same bits; the device hash masks
    them back), since torch's uint16 has few kernels."""

    def move(a: np.ndarray) -> torch.Tensor:
        if a.dtype == np.uint16:
            a = a.view(np.int16)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return type(batch)(*(move(a) for a in batch))


class StreamingSGDModel:
    """Shared surface of the streaming SGD learners: weights on the model's
    device (updated each step), the fused step, conf plumbing. Subclasses
    set ``round_predictions`` and ``default_step_size``."""

    round_predictions = True
    default_step_size = 0.1

    def __init__(
        self,
        num_text_features: int = 1000,
        num_iterations: int = 50,
        step_size: float | None = None,
        mini_batch_fraction: float = 1.0,
        l2_reg: float = 0.0,
        convergence_tol: float = 0.001,
        dtype=torch.float32,
        quality: bool = False,
        device="cuda",
    ) -> None:
        self.num_text_features = num_text_features
        self.dtype = dtype
        self.device = resolve_device(device)
        self._train_step = make_sgd_train_step(
            num_text_features=num_text_features,
            num_iterations=num_iterations,
            step_size=self.default_step_size if step_size is None else step_size,
            mini_batch_fraction=mini_batch_fraction,
            l2_reg=l2_reg,
            convergence_tol=convergence_tol,
            round_predictions=self.round_predictions,
            quality=quality,
            dtype=dtype,
        )
        self._weights = zero_weights(num_text_features, dtype, self.device)

    @classmethod
    def from_conf(cls, conf, **overrides):
        kwargs = dict(
            num_text_features=conf.numTextFeatures,
            num_iterations=conf.numIterations,
            step_size=conf.stepSize,
            mini_batch_fraction=conf.miniBatchFraction,
            l2_reg=conf.l2Reg,
            convergence_tol=conf.convergenceTol,
            quality=conf.modelWatch == "on",
            device=conf.backend,
        )
        kwargs.update(overrides)
        return cls(**kwargs)

    def set_initial_weights(self, weights) -> "StreamingSGDModel":
        w = torch.as_tensor(weights, dtype=self.dtype).to(self.device).clone()
        if tuple(w.shape) != tuple(self._weights.shape):
            raise ValueError(
                f"weights must have shape {tuple(self._weights.shape)}, "
                f"got {tuple(w.shape)}"
            )
        self._weights = w
        return self

    def reset(self) -> "StreamingSGDModel":
        """Back to MLlib's initial state: zero weights."""
        self._weights = zero_weights(self.num_text_features, self.dtype, self.device)
        return self

    @property
    def latest_weights(self) -> np.ndarray:
        return self._weights.detach().cpu().numpy().copy()

    def step(self, batch: FeatureBatch | UnitBatch) -> StepOutput:
        """Fused predict-then-train on one host micro-batch; advances the
        model and returns the device-side StepOutput."""
        self._weights, out = self._train_step(
            self._weights, batch_to_device(batch, self.device)
        )
        return out
