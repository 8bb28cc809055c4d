"""Training over a process group (counterpart of
``twtml_tpu/parallel/sharding.py``): the data-parallel layout and the
feature-sharded 2D layout.

In the JAX package one ``shard_map`` program spans the mesh. In the port
every rank of a ``torch.distributed`` group runs the same step on its own
share with ``Collectives`` in place of the axis names:

- **data-parallel** (a ``DataMesh``): the batch's rows are sharded over
  the ranks, the weights replicated, and the single-device step runs with
  a ``Collectives`` object for its reductions (models/sgd.py
  ``make_sgd_train_step(group=...)``). Its weights stay identical on every
  rank, since every rank applies the same all-reduced update. The wire
  (this rank's segment of the shard-segment wire, at buckets every rank
  agreed) is ``parallel/distributed.py`` ``MultiHostSGDModel``'s, which
  wraps this one. Under ``--elastic on`` the model is rebuilt for each
  epoch's group (``MultiHostSGDModel.rebuild``); a group shrunk to one
  rank runs the split at one rank, bitwise B1, with no all-reduce.
- **feature-sharded** (a ``ModelMesh``, ``FeatureShardedSGDModel`` over
  ``make_feature_sharded_step``):
  the hashed text features are sharded over ``model``, so rank (d, m)
  holds the slice [m·F/M, (m+1)·F/M) of the text weights (and the 4
  numeric weights, replicated), and the rows of data shard d. Each rank
  hashes its rows to global indices and keeps the tokens of its slice; the
  margins sum over ``model``. The loop runs in the Gram (dual) basis where
  it applies (float32 weights and ``fits_gram`` at the slice's width, or
  ``use_gram=True``): ``models/sgd.gram_sgd_parallel`` with a model axis,
  which on the card launches B4, the G product, B7 and B8 at the slice's
  shapes, and no per-iteration collective. Elsewhere (bfloat16,
  ``use_gram=False``, a gate miss) it runs the JAX scatter loop, three
  reductions an iteration: the margins over ``model``, the gradient and
  count over ``data``, the two weight norms over ``model``. No app flag
  builds a model axis (nor does the JAX package's): it is the library's.

``step_many`` runs a group's K steps eagerly, one after the other, with one
fetch for the group: a gloo collective is a host round trip, which a CUDA
graph cannot capture.
"""

from __future__ import annotations

import numpy as np
import torch

from ..features.batch import NUM_NUMBER_FEATURES
from ..models.base import StepOutput
from ..models.sgd import (
    DTYPES,
    StreamingSGDModel,
    _reduced,
    batch_to_device,
    decode_batch,
    gram_sgd_parallel,
    mask_cache,
    sgd_inner_loop,
)
from ..ops.fused_sgd import least_squares_residual
from ..ops.gram import GRAM_INT8_PLANE, fits_gram
from ..ops.sparse import sparse_grad_text, sparse_text_dot
from ..ops.stats import batch_stats
from ..utils import get_logger
from ..utils.rounding import torch_round_half_up
from .mesh import DataMesh, ModelMesh

log = get_logger("parallel.sharding")


def make_feature_sharded_step(
    *, f_text: int, f_local: int, lo: int, num_iterations: int, step_size: float,
    mini_batch_fraction: float = 1.0, l2_reg: float = 0.0, convergence_tol: float = 0.001,
    residual_fn=None, prediction_fn=None, round_predictions: bool = True,
    dtype=torch.float32, use_gram: "bool | None" = None, gram_int8: "bool | None" = None,
    data, model,
):
    """The (weights, batch[, plane]) -> (new_weights, StepOutput) step of one
    rank of the 2D mesh (the JAX package's ``_make_feature_sharded_step``):
    ``weights`` are this rank's [f_local + 4], the text slice [lo, lo +
    f_local) then the 4 numeric weights; ``batch`` this rank's rows (its data
    shard's), any wire of ``make_sgd_train_step``; ``data`` and ``model``
    the ``Collectives`` of the two axes. ``plane`` is ignored: each model
    shard's Gram plane is its own slice's (``gram_sgd_parallel``).
    Predictions are this rank's rows', the stats sum over ``data``."""
    residual_fn = residual_fn or least_squares_residual
    int8_plane = GRAM_INT8_PLANE if gram_int8 is None else gram_int8
    sampled = mini_batch_fraction < 1.0
    loop_kw = dict(num_iterations=num_iterations, step_size=step_size, l2_reg=l2_reg,
                   convergence_tol=convergence_tol)
    masks_by_rows, masks_for = mask_cache(num_iterations, mini_batch_fraction, dtype)

    def text_sq(w):
        return torch.sum(w[:f_local] * w[:f_local])

    def train_step(weights, batch, plane: "int | None" = None):
        g_idx, token_val, numeric, labels, mask = decode_batch(batch, f_text, dtype)
        rel = g_idx - lo
        local_val = token_val * ((rel >= 0) & (rel < f_local)).to(dtype)
        rel = torch.clamp(rel, 0, f_local - 1)

        def predict(w):
            return model.allreduce_(sparse_text_dot(w[:f_local], rel, local_val)) \
                + numeric @ w[f_local:]

        raw = predict(weights)
        preds = raw if prediction_fn is None else prediction_fn(raw)
        if round_predictions:
            preds = torch_round_half_up(preds)
        stats = batch_stats(labels, preds, mask, reduce=data.allreduce_)
        rows = mask.shape[0]
        gram = (dtype == torch.float32 and fits_gram(rows * data.world, f_local,
                                                     num_iterations)
                if use_gram is None else use_gram)
        if gram:
            p_prev = model.allreduce_(text_sq(weights)) + torch.sum(
                weights[f_local:] * weights[f_local:])
            w_new = gram_sgd_parallel(
                weights, g_idx, token_val, numeric, raw, labels, mask, data=data,
                model=model, lo=lo, f_local=f_local, p_prev=p_prev,
                masks=masks_for(rows * data.world, mask.device, None) if sampled else None,
                int8_plane=int8_plane, residual_fn=residual_fn, **loop_kw)
            return w_new, StepOutput(predictions=preds, **stats)
        masks = masks_for(rows, mask.device, data.rank) if sampled else None

        def grad_and_count(w, it):
            sel = mask if masks is None else mask * masks[it - 1]
            residual = residual_fn(predict(w), labels) * sel
            grad = torch.cat([sparse_grad_text(rel, local_val, residual, f_local),
                              residual @ numeric])
            return grad, torch.sum(sel)

        def norms(w_new, w):
            # the text slices' sums over the model axis, in one all-reduce;
            # the numeric weights are replicated there
            d = w_new - w
            text = model.allreduce_(torch.stack([text_sq(d), text_sq(w_new)]))
            num = torch.stack([torch.sum(d[f_local:] * d[f_local:]),
                               torch.sum(w_new[f_local:] * w_new[f_local:])])
            return text[0] + num[0], text[1] + num[1]

        w_new = sgd_inner_loop(weights, grad_and_count=_reduced(grad_and_count,
                                                                data.allreduce_),
                               norms=norms, **loop_kw)
        return w_new, StepOutput(predictions=preds, **stats)

    train_step.route = ("gram" if dtype == torch.float32 else "scatter") \
        if use_gram is None else ("gram" if use_gram else "scatter")
    train_step.sparse = True
    train_step.int8_plane = int8_plane
    train_step.masks_by_rows = masks_by_rows
    return train_step


class ParallelSGDModel(StreamingSGDModel):
    """The rank-local learner of a data-parallel group over ``mesh``
    (``group``: the ``Collectives`` its step reduces over), with the step
    surface of the single-device learners. ``residual_fn``,
    ``prediction_fn`` and ``round_predictions`` (StreamingSGDModel's) are
    the learner's knobs, the JAX package's constructor arguments. Built on
    a ``ModelMesh`` it is a ``FeatureShardedSGDModel`` (the JAX package's
    ``ParallelSGDModel`` takes either mesh)."""

    def __new__(cls, mesh: "DataMesh | ModelMesh", *args, **kwargs):
        if cls is ParallelSGDModel and isinstance(mesh, ModelMesh):
            cls = FeatureShardedSGDModel
        return super().__new__(cls)

    def __init__(self, mesh: "DataMesh | ModelMesh", group, **kwargs):
        self.mesh = mesh
        self.group = group
        super().__init__(group=group, **kwargs)

    @classmethod
    def from_conf(cls, conf, mesh: "DataMesh | ModelMesh" = None, group=None, **overrides):
        kwargs = dict(
            num_text_features=conf.numTextFeatures,
            num_iterations=conf.numIterations,
            step_size=conf.stepSize,
            mini_batch_fraction=conf.miniBatchFraction,
            l2_reg=conf.l2Reg,
            convergence_tol=conf.convergenceTol,
            quality=conf.modelWatch == "on",
            dtype=DTYPES[conf.dtype],
            device=conf.backend,
        )
        kwargs.update(overrides)
        return cls(mesh, group, **kwargs)

    def step_many(self, stacked) -> StepOutput:
        """K steps of a stacked batch or packed group, eagerly (a collective
        inside cannot be captured over gloo); the [K]-leading outputs come
        back as one StepOutput, for one fetch."""
        planes = self.planes(stacked)
        self._weights, out = self._train_many(
            self._weights, batch_to_device(stacked, self.device, self.non_blocking), planes)
        return out


class FeatureShardedSGDModel(ParallelSGDModel):
    """The rank-local learner of a ``ModelMesh``: ``group`` is the
    ``MeshCollectives`` of its two axes, the step the feature-sharded one
    (``make_feature_sharded_step``), the weights this rank's text slice
    [lo, lo + F/num_model) and the 4 numeric weights. numTextFeatures must
    divide by the model axis."""

    def __init__(self, mesh: ModelMesh, group, **kwargs):
        f_text = kwargs.get("num_text_features", 1000)
        if f_text % mesh.num_model:
            raise ValueError(f"numTextFeatures={f_text} not divisible by model-axis size "
                             f"{mesh.num_model}")
        self.f_local = f_text // mesh.num_model
        self.lo = mesh.model_index * self.f_local
        if kwargs.get("quality"):
            # the JAX package's degrade: the 2D step's weight norms would
            # need model-axis sums the quality plane does not wire
            log.warning("--modelWatch quality vector is not wired for the "
                        "feature-sharded (2D model-axis) layout; disabling the "
                        "in-step quality leaf for this model")
            kwargs["quality"] = False
        super().__init__(mesh, group, **kwargs)

    def _make_step(self, *, num_text_features, quality, use_sparse, group, **kwargs):
        return make_feature_sharded_step(
            f_text=num_text_features, f_local=self.f_local, lo=self.lo, data=self.group.data,
            model=self.group.model, **kwargs)

    def _zero_weights(self):
        return torch.zeros((self.f_local + NUM_NUMBER_FEATURES,), dtype=self.dtype,
                           device=self.device)

    def planes(self, batch) -> tuple:
        """The step reads each slice's plane itself."""
        return ()

    @property
    def latest_weights(self) -> np.ndarray:
        """The whole [F + 4] weights on the host: the text slices
        all-gathered over ``model``. A collective, which every rank calls at
        the same point (the JAX package's ``_to_host``)."""
        w = self._weights.detach()
        text = self.group.model.all_gather_rows(w[:self.f_local])
        out = torch.cat([text, w[self.f_local:]])
        if out.dtype == torch.bfloat16:
            out = out.float()
        return out.cpu().numpy().copy()

    def set_initial_weights(self, weights) -> "FeatureShardedSGDModel":
        """The whole [F + 4] weights (a checkpoint's): this rank keeps its
        text slice and the numeric weights."""
        w = np.asarray(weights)
        f_text = self.num_text_features
        if w.shape != (f_text + NUM_NUMBER_FEATURES,):
            raise ValueError(f"weights must have shape ({f_text + NUM_NUMBER_FEATURES},), "
                             f"got {w.shape}")
        return super().set_initial_weights(
            np.concatenate([w[self.lo:self.lo + self.f_local], w[f_text:]]))
