"""Fused streaming-SGD step, dense regime (counterpart of a subset of
``twtml_tpu/models/sgd.py``).

Per micro-batch: unpack the packed wire buffer and re-pad the ragged units
(the default wire), hash the bigrams on the device, densify to [B, F_text] and
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

from ..features.batch import (
    NUM_NUMBER_FEATURES,
    FeatureBatch,
    PackedBatch,
    RaggedUnitBatch,
    UnitBatch,
    unpack_batch,
)
from ..ops.fused_sgd import fused_dense_sgd
from ..ops.quality import quality_vector
from ..ops.ragged import ragged_repad
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
    least-squares learner. ``batch`` is a PackedBatch (a uint8 buffer
    tensor), RaggedUnitBatch, UnitBatch or FeatureBatch of tensors on the
    weights' device."""
    _check_slice(num_text_features, mini_batch_fraction, dtype)
    f_text = num_text_features

    def train_step(weights, batch):
        if isinstance(batch, PackedBatch):
            # one-buffer wire: reinterpret its bytes on the device (the
            # offsets' delta decode is the only arithmetic)
            batch = unpack_batch(batch.buffer, batch.layout)
        if isinstance(batch, RaggedUnitBatch):
            # ragged wire: re-pad + ASCII fold on the device, giving the
            # padded wire's units bit for bit
            units, length = ragged_repad(batch.units, batch.offsets, batch.row_len)
            batch = UnitBatch(units, length, batch.numeric, batch.label, batch.mask)
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


def zero_weights(num_text_features: int, dtype=torch.float32, device="cuda"):
    """MLlib initial weights: zeros(numFeatures) (LinearRegression.scala:32),
    on the card unless the caller asks for the CPU."""
    return torch.zeros(
        (num_text_features + NUM_NUMBER_FEATURES,), dtype=dtype,
        device=resolve_device(device),
    )


def batch_to_device(batch, device, non_blocking: bool = True):
    """Host numpy batch -> the same batch type of tensors on ``device``. A
    PackedBatch is ONE copy of its uint8 buffer. On ``cuda`` with
    ``non_blocking`` the copy is queued on the current stream and returns at
    once when the buffer is page-locked (the arena's buffers are, for a cuda
    model): the host buffer must then stay untouched until the stream has
    run the copy, which the fetch pipeline's lease rule guarantees (the
    lease retires after the batch's results were delivered). A pageable
    array is staged by the driver before the call returns. On the CPU the
    tensors share the host arrays. uint16 code units travel as int16 (same
    bits; the device ops mask them back), since torch's uint16 has few
    kernels."""

    def move(a: np.ndarray) -> torch.Tensor:
        if a.dtype == np.uint16:
            a = a.view(np.int16)
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device, non_blocking=non_blocking
        )

    if isinstance(batch, PackedBatch):
        return PackedBatch(move(batch.buffer), batch.layout)
    if isinstance(batch, RaggedUnitBatch):
        return RaggedUnitBatch(
            *(move(a) for a in (batch.units, batch.offsets, batch.numeric,
                                batch.label, batch.mask)),
            row_len=batch.row_len,
        )
    return type(batch)(*(move(a) for a in batch))


class HostOutput:
    """A StepOutput on its way to the host: ONE device-to-host copy of the
    predictions [B], the 4 stats and the quality vector, packed into one
    f32 vector, into page-locked memory, with one CUDA event recorded after
    it. ``done()`` asks the event without blocking; ``wait()`` blocks on it;
    ``result()`` (after ``done()``) is the StepOutput of numpy arrays, bit
    for bit the device values. On the CPU the result is ready at once."""

    __slots__ = ("_host", "_event", "_rows", "_has_quality")

    def __init__(self, host: torch.Tensor, event, rows: int, has_quality: bool):
        self._host = host
        self._event = event
        self._rows = rows
        self._has_quality = has_quality

    def done(self) -> bool:
        return self._event is None or self._event.query()

    def wait(self) -> None:
        if self._event is not None:
            self._event.synchronize()

    def result(self) -> StepOutput:
        v = self._host.numpy()
        b = self._rows
        return StepOutput(
            predictions=v[:b], count=v[b], mse=v[b + 1], real_stdev=v[b + 2],
            pred_stdev=v[b + 3], quality=v[b + 4:] if self._has_quality else None,
        )


def fetch_output(out: StepOutput) -> HostOutput:
    """Start the host fetch of a device StepOutput: one device-side
    concatenation, one non-blocking D2H copy into pinned memory and one
    event on the current stream, no host sync. Calling it again on the
    same output issues a fresh copy of the still-resident tensors."""
    parts = [out.predictions.reshape(-1),
             torch.stack([out.count, out.mse, out.real_stdev, out.pred_stdev])]
    if out.quality is not None:
        parts.append(out.quality.reshape(-1))
    vec = torch.cat([p.to(torch.float32) for p in parts])
    rows = out.predictions.numel()
    if vec.device.type != "cuda":
        return HostOutput(vec, None, rows, out.quality is not None)
    host = torch.empty(vec.shape, dtype=torch.float32, pin_memory=True)
    host.copy_(vec, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return HostOutput(host, event, rows, out.quality is not None)


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
        # H2D copies queue without waiting (batch_to_device); False makes
        # each copy synchronous, the reference order for a pipelined run
        self.non_blocking = True
        # the stream the model runs on: the constructing thread's current
        # stream, which bind_thread makes current on another thread
        self.stream = (
            torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
        )

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

    def bind_thread(self) -> None:
        """Make the model's CUDA device and stream current on the calling
        thread (both are per thread in PyTorch): the streaming scheduler
        calls it where its thread starts. No-op on the CPU."""
        if self.stream is not None:
            torch.cuda.set_device(self.stream.device)
            torch.cuda.set_stream(self.stream)

    def step(self, batch) -> StepOutput:
        """Fused predict-then-train on one host micro-batch; advances the
        model and returns the device-side StepOutput, with nothing waited
        for on ``cuda``."""
        self._weights, out = self._train_step(
            self._weights, batch_to_device(batch, self.device, self.non_blocking)
        )
        return out

    @staticmethod
    def fetch_output(out: StepOutput) -> HostOutput:
        """Start the host fetch of ``step``'s output (``fetch_output``)."""
        return fetch_output(out)
