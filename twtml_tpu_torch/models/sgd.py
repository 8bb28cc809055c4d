"""Fused streaming-SGD step (counterpart of ``twtml_tpu/models/sgd.py``),
for the least-squares and the logistic learner, in both feature regimes.

Per micro-batch: unpack the packed wire buffer and re-pad the ragged units
(the default wire), hash the bigrams on the device (or, under ``--hashOn
host``, take the host-hashed tokens of a ``FeatureBatch``, upcast from
their compact wire dtypes), predict with the pre-update weights
(``prediction_fn`` of the raw margin, rounded HALF_UP when
``round_predictions``), compute the batch stats (and the quality vector
under ``--modelWatch``), then run ``numIterations`` of MLlib's
GradientDescent, whose gradient multiplier is ``residual_fn(raw, label)``:
x·w − y for least squares (the default), σ(x·w) − y for the logistic
learner (models/logistic.py).

MLlib semantics kept (``sgd_inner_loop``): 1-indexed stepSize/sqrt(i); L2
pre-scale w <- w(1 - eta*lambda); Bernoulli mini-batch sampling per
iteration with the JAX package's threefry keys (PRNGKey(42) folded with i,
``ops/prng.py``); an iteration with zero samples leaves w unchanged;
converged once ||w_i - w_{i-1}|| < tol * max(||w_i||, 1), then frozen.

The loop's route is chosen by configuration (``dense_route``), never on a
failure. The dense regime (numTextFeatures <= 8192) densifies the tokens to
[B, F_text] and appends the 4 numeric features. At miniBatchFraction 1
with float32 weights (the default) it runs ``ops/fused_sgd.fused_dense_sgd``:
the hand-written kernel when the model is on ``cuda``, its plain twin on
the CPU, in the kernel's residual mode for ``residual_fn`` (a residual the
kernel has no mode for runs the torch loop). Its predictions are that
call's ``raw_predictions`` (X in bf16 times the pre-update weights, summed
in f32): the text counts are exact in bf16 and the numeric features are of
order 1e-6, so this differs from the JAX package's f32 ``x @ w`` only in
summation order and in the last bits of the numeric terms. A Bernoulli
mini-batch (fraction < 1) or bfloat16/float64 weights, which the kernel
does not compute, run the JAX package's loop as torch ops in the weights'
type (``dense_sgd_loop``), with every iteration's mask drawn in one batched
pass before the loop.

The sparse regime (numTextFeatures > 8192, or ``use_sparse``) never forms
X: predictions gather the weights (``ops/sparse.sparse_predict``). Its
``gram`` route (float32 weights, or ``use_gram=True``) runs the loop in the
dual basis of ``ops/gram.py`` for a batch that passes ``fits_gram``; a
batch that misses the gate, bfloat16/float64 weights and ``use_gram=False``
run the ``scatter`` route, the per-iteration gather/scatter loop as torch
ops (``sparse_sgd_loop``). On ``cuda`` in float32 the Gram route is the
hand kernels of ``ops/fused_gram.py``: B4 builds the counts C, C·Cᵀ
(``torch._int_mm`` in the int8 plane) plus N·Nᵀ gives G, B7 runs the dual
loop in one launch, B8 writes W back from the batch's tokens; elsewhere (the CPU, bfloat16) it is
the plain ``gram_matrix`` / ``run_dual_loop`` / ``dual_writeback``. The
plane of G (int8, bf16 or exact) is chosen by the batch's data, as the JAX
package's ``lax.switch`` chooses it, but from host metadata beside the
device batch (``host_planes``: the rows' unit counts on the units wires,
the token values of a host-hashed batch), so no dispatch reads the device.

``StreamingSGDModel.step_many`` runs K micro-batches as one dispatch (the
JAX package's ``lax.scan`` superbatch): a stacked batch or a packed group
(features/batch.py). On the card the K steps of a (wire signature, K,
planes) are captured once into a CUDA graph and replayed: the group's
bytes land in device buffers the graph owns (one H2D copy for a packed
group), the weights chain through the K steps exactly as K ``step`` calls
would, and the K outputs come back as one vector. The first group of a
signature runs the K steps eagerly (which also runs every first-use
set-up), then captures.
"""

from __future__ import annotations

from typing import NamedTuple

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
from ..ops import fused_gram, fused_sgd, prng
from ..ops.fused_sgd import fused_dense_sgd, least_squares_residual, residual_mode
from ..ops.gram import (
    GRAM_INT8_PLANE,
    PLANE_INT8,
    add_numeric_block,
    data_plane,
    dual_norm_sq,
    dual_writeback,
    fits_gram,
    gram_matrix,
    gram_plane,
    text_gram,
)
from ..ops.quality import quality_vector
from ..ops.ragged import ragged_repad
from ..ops.sparse import densify_text, sparse_grad_text, sparse_predict
from ..ops.stats import batch_stats
from ..ops.text_hash import hash_bigrams_device
from ..utils import get_logger
from ..utils.device import resolve_device
from ..utils.rounding import torch_round_half_up
from .base import StepOutput

log = get_logger("models.sgd")

# above this text-feature count the sparse regime (gather/scatter, Gram)
# takes over: the JAX package's limit
DENSE_TEXT_FEATURE_LIMIT = 8192

# GradientDescent samples with seed 42 (the JAX package's MLLIB_SAMPLING_SEED)
MLLIB_SAMPLING_SEED = 42

# --dtype names and their torch types
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}

# sampling-mask sets kept a step (one per batch row count)
_MASK_CACHE_SIZE = 8

# CUDA graphs kept a model (one per (wire signature, K) of step_many)
_GRAPH_CACHE_SIZE = 4


def _step_scalars(step_size: float, l2_reg: float, it: int, dtype) -> tuple[float, float]:
    """(eta, 1 - eta*lambda) of iteration ``it`` in the weights' float type,
    as the JAX loop computes them: eta = stepSize / sqrt(dtype(i)), each op
    rounded to ``dtype`` (host scalars, exactly representable in it)."""
    if dtype == torch.float32:
        eta = np.float32(step_size) / np.sqrt(np.float32(it))
        return float(eta), float(np.float32(1.0) - eta * np.float32(l2_reg))
    if dtype == torch.float64:
        eta = np.float64(step_size) / np.sqrt(np.float64(it))
        return float(eta), float(1.0 - eta * np.float64(l2_reg))
    one = torch.tensor(1.0, dtype=dtype)
    eta = torch.tensor(step_size, dtype=dtype) / torch.sqrt(torch.tensor(float(it), dtype=dtype))
    return float(eta), float(one - eta * torch.tensor(l2_reg, dtype=dtype))


def _tree_map(fn, *trees):
    """``fn`` over the leaves of weight trees: a tensor, or a dict of them."""
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree) -> list:
    return list(tree.values()) if isinstance(tree, dict) else [tree]


def sgd_inner_loop(
    weights, *, num_iterations: int, step_size: float, l2_reg: float,
    convergence_tol: float, grad_and_count, norm_sq=None, norms=None,
    with_iterations: bool = False, step_table=None,
):
    """MLlib's GradientDescent loop over a weight tensor, or a dict of them
    (the dual state {c, α}), with no host sync.

    ``grad_and_count(w, it)`` returns (gradient sum of w's structure,
    selected count) of 1-indexed iteration ``it`` as tensors. The arithmetic
    is the JAX loop's in the weights' float type: w * (1 - eta*lambda) -
    (eta * g) / max(count, 1), with eta = stepSize/sqrt(i); an iteration
    that selects no row makes no update and is not convergence.
    ``norm_sq(a, b)`` is ||a - b||² for the convergence test (default: the
    sum over the leaves; the dual loop passes ``ops/gram.dual_norm_sq``);
    ``norms(w_new, w)``, when given, returns (||w_new - w||², ||w_new||²)
    at once (a feature-sharded loop sums both over its model axis in one
    all-reduce).
    With ``with_iterations`` it returns (w, iterations run): the iteration
    that converged, else N, as a tensor.

    ``step_table`` (eta, scale), each [N, M, 1] in the weights' type, runs M
    tenants' loops at once (the vmap form of a tenant stack): ``weights``
    [M, F], ``grad_and_count`` giving [M, F] and [M], tenant m's iteration
    ``it`` with eta[it - 1, m] and scale[it - 1, m] (``_step_scalars`` of
    its own step size and L2), the zero-count rule and the converged freeze
    per tenant."""
    first = _leaves(weights)[0]
    dtype, device = first.dtype, first.device
    tenants = step_table is not None
    # per tenant: [M] counts and flags against [M, F] weights
    col = (lambda t: t[:, None]) if tenants else (lambda t: t)
    total = (lambda t: torch.sum(t, dim=-1)) if tenants else torch.sum
    w = weights
    flags = first.shape[:1] if tenants else ()
    converged = torch.zeros(flags, dtype=torch.bool, device=device)
    ran = torch.zeros(flags, dtype=torch.int64, device=device)
    for it in range(1, num_iterations + 1):
        grad_sum, count = grad_and_count(w, it)
        denom = col(torch.clamp(count, min=1.0))
        if tenants:
            eta, scale = step_table[0][it - 1], step_table[1][it - 1]
        else:
            eta, scale = _step_scalars(step_size, l2_reg, it, dtype)
        w_new = _tree_map(lambda wl, gl: wl * scale - eta * gl / denom, w, grad_sum)
        # zero samples: no update
        w_new = _tree_map(lambda nl, wl: torch.where(col(count > 0), nl, wl), w_new, w)
        if convergence_tol > 0:
            if norms is not None:
                delta_sq, norm_new_sq = norms(w_new, w)
            elif norm_sq is None:
                delta_sq = sum(total((nl - wl) ** 2)
                               for nl, wl in zip(_leaves(w_new), _leaves(w)))
                norm_new_sq = sum(total(nl * nl) for nl in _leaves(w_new))
            else:
                delta_sq = norm_sq(w_new, w)
                norm_new_sq = norm_sq(w_new, _tree_map(torch.zeros_like, w_new))
            conv_now = (count > 0) & (
                torch.sqrt(delta_sq) < convergence_tol * torch.clamp(torch.sqrt(norm_new_sq), min=1.0)
            )
        else:
            conv_now = torch.zeros(flags, dtype=torch.bool, device=device)
        w = _tree_map(lambda wl, nl: torch.where(col(converged), wl, nl), w, w_new)
        if with_iterations:
            ran = torch.where(converged, ran, it)
        converged = converged | conv_now
    return (w, ran) if with_iterations else w


def run_dual_loop(*, u, g, labels, mask, dtype, residual_fn, num_iterations: int,
                  step_size: float, l2_reg: float, convergence_tol: float, p_prev,
                  masks=None, with_iterations: bool = False):
    """MLlib's iteration loop in the Gram (dual) basis, as torch ops (the JAX
    package's ``run_dual_loop``): the state {c, α} starts at {1, 0}; each
    iteration's margin is c·u + G·α, its gradient {0, residual·sel} over
    the rows ``sel = mask * masks[i - 1]`` selects (``mask`` when ``masks``
    is None: the [N, B] draws of ``sampling_masks``, the unfolded
    PRNGKey(42) as in the JAX package), and convergence is measured through
    ``dual_norm_sq``. Returns {'c', 'alpha'}: W_new = c·W_prev + Zᵀα (and
    the iterations run with ``with_iterations``)."""

    def grad_and_count(w, it):
        sel = mask if masks is None else mask * masks[it - 1]
        raw = w["c"] * u + g @ w["alpha"]
        residual = residual_fn(raw, labels) * sel
        return {"c": torch.zeros((), dtype=dtype, device=u.device), "alpha": residual}, \
            torch.sum(sel)

    return sgd_inner_loop(
        {"c": torch.ones((), dtype=dtype, device=u.device),
         "alpha": torch.zeros(labels.shape, dtype=dtype, device=u.device)},
        num_iterations=num_iterations, step_size=step_size, l2_reg=l2_reg,
        convergence_tol=convergence_tol, grad_and_count=grad_and_count,
        norm_sq=dual_norm_sq(p_prev, u, g), with_iterations=with_iterations,
    )


def sampling_masks(rows: int, num_iterations: int, fraction: float, dtype, device,
                   shard: "int | None" = None):
    """The JAX loop's Bernoulli mini-batch draws of every iteration at once,
    as an [N, rows] 0/1 tensor of ``dtype``: row i is
    ``jax.random.bernoulli(fold_in(PRNGKey(42), i + 1), fraction, (rows,))``.
    A rank of a data-parallel group (``shard``) draws under
    ``fold_in(PRNGKey(42), shard)``, as the JAX package's ``sampling_key``
    folds the data-shard index in, so the ranks' masks are independent.
    The draw's float type follows ``fraction``: float32, or float64 in the
    JAX package's x64 mode (its ``--dtype float64``), which draws other
    masks. One batched pass of integer ops on ``device``, no host sync."""
    key = prng.prng_key(MLLIB_SAMPLING_SEED)
    if shard is not None:
        folded = prng.fold_in(key, torch.tensor(int(shard), dtype=torch.int64, device=device))
        key = (folded[0].to(torch.int64), folded[1].to(torch.int64))
    its = torch.arange(1, num_iterations + 1, dtype=torch.int64, device=device)
    draw = torch.float64 if dtype == torch.float64 else torch.float32
    keys = prng.fold_in(key, its)
    return prng.bernoulli(keys, fraction, (rows,), draw, device).to(dtype)


def _reduced(grad_and_count, reduce):
    """``grad_and_count`` whose (gradient, count) go through ONE ``reduce``
    (a data-parallel group's in-place SUM over its ranks: the JAX package's
    two ``psum``s of the gradient and the count), or itself without one.
    The tenant form (an [M, F] gradient and [M] counts, the vmap form of a
    tenant stack) reduces every tenant's in the same one buffer: the JAX
    vmap's psums of the M tenants' values as one collective."""
    if reduce is None:
        return grad_and_count

    def reduced(w, it):
        grad, count = grad_and_count(w, it)
        n = count.numel()
        buf = torch.cat([grad.reshape(-1), count.reshape(-1).to(grad.dtype)])
        reduce(buf)
        return buf[:-n].reshape(grad.shape), buf[-n:].reshape(count.shape)

    return reduced


def tenant_step_table(step_sizes, l2_regs, num_iterations: int, dtype) -> torch.Tensor:
    """(eta, scale) of every iteration and tenant as one host tensor [2, N,
    M, 1] in the weights' type (``_step_scalars`` of each tenant's step size
    and L2): ``sgd_inner_loop``'s ``step_table`` is its two halves."""
    table = torch.tensor(
        [[_step_scalars(s, l2, it, dtype) for s, l2 in zip(step_sizes, l2_regs)]
         for it in range(1, num_iterations + 1)],
        dtype=dtype).reshape(num_iterations, len(step_sizes), 2)
    return table.permute(2, 0, 1).contiguous()[..., None]


def _matvec(x, w):
    """X·w: [B, F] @ [F], or each tenant's [M, B, F] @ [M, F] as one batched
    product."""
    return x @ w if x.dim() == 2 else torch.bmm(x, w[..., None])[..., 0]


def _rmatvec(x, r):
    """Xᵀr: [B, F]ᵀ @ [B], or each tenant's as one batched product."""
    return x.T @ r if x.dim() == 2 else torch.bmm(x.transpose(1, 2), r[..., None])[..., 0]


def dense_sgd_loop(x_dense, labels, mask, weights, *, num_iterations: int,
                   step_size: float, l2_reg: float = 0.0,
                   convergence_tol: float = 0.001, masks=None,
                   residual_fn=least_squares_residual, reduce=None, step_table=None):
    """The JAX package's dense step as torch ops in the weights' float type
    (``twtml_tpu/models/sgd.py`` ``sgd_inner_loop`` over ``x_dense @ w``):
    predictions with the pre-update weights, then each iteration's gradient
    Xᵀ(residual_fn(X·w, y) * sel) over the rows ``sel = mask * masks[i - 1]``
    selects (all valid rows when ``masks`` is None), divided by the selected
    count. With ``reduce`` (a data-parallel group) the gradient and count
    are summed over the ranks each iteration. Returns (new_weights [F],
    raw_predictions [B]). With ``step_table`` (``sgd_inner_loop``'s, in place
    of ``step_size`` and ``l2_reg``) it runs M tenants at once, the JAX
    package's vmap of the step: ``x_dense`` [M, B, F], ``labels`` and
    ``mask`` [M, B], ``weights`` [M, F], every tenant on the same ``masks``
    (its draw takes no tenant index); it returns [M, F] and [M, B]."""
    raw = _matvec(x_dense, weights)

    def grad_and_count(w, it):
        sel = mask if masks is None else mask * masks[it - 1]
        residual = residual_fn(_matvec(x_dense, w), labels) * sel
        return _rmatvec(x_dense, residual), torch.sum(sel, dim=-1)

    w = sgd_inner_loop(
        weights, num_iterations=num_iterations, step_size=step_size,
        l2_reg=l2_reg, convergence_tol=convergence_tol,
        grad_and_count=_reduced(grad_and_count, reduce), step_table=step_table,
    )
    return w, raw


def sparse_sgd_loop(weights, token_idx, token_val, numeric, labels, mask, *,
                    num_text_features: int, num_iterations: int, step_size: float,
                    l2_reg: float = 0.0, convergence_tol: float = 0.001, masks=None,
                    residual_fn=least_squares_residual, reduce=None, step_table=None):
    """The sparse regime's per-iteration loop as torch ops (the JAX
    package's scatter loop): each iteration gathers the margins
    (``sparse_predict``) and scatters residual·val back
    (``sparse_grad_text``), plus the numeric columns' Nᵀr; with ``reduce``
    summed over a data-parallel group's ranks. Returns the new weights
    [F + 4]. With ``step_table`` (``sgd_inner_loop``'s, in place of
    ``step_size`` and ``l2_reg``) it runs M tenants at once, the JAX
    package's vmap of the step: ``weights`` [M, F + 4], the tokens [M, B,
    L], ``numeric`` [M, B, 4], ``labels`` and ``mask`` [M, B], every tenant
    on the same ``masks``; one gather and one ``index_add_`` an iteration
    for all M (tenant m's indices offset into [M·F]); it returns [M, F +
    4]."""
    f_text = num_text_features
    tenants = step_table is not None

    def grad_and_count(w, it):
        sel = mask if masks is None else mask * masks[it - 1]
        raw = sparse_predict(w[..., :f_text], w[..., f_text:], token_idx, token_val, numeric)
        residual = residual_fn(raw, labels) * sel
        if tenants:
            grad = torch.cat([sparse_grad_text(token_idx, token_val, residual, f_text),
                              _rmatvec(numeric, residual)], dim=1)
            return grad, torch.sum(sel, dim=-1)
        grad = torch.cat([sparse_grad_text(token_idx, token_val, residual, f_text),
                          residual @ numeric])
        return grad, torch.sum(sel)

    return sgd_inner_loop(
        weights, num_iterations=num_iterations, step_size=step_size, l2_reg=l2_reg,
        convergence_tol=convergence_tol, grad_and_count=_reduced(grad_and_count, reduce),
        step_table=step_table,
    )


def dense_route(mini_batch_fraction: float, dtype, residual_fn=None,
                sparse: bool = False, use_gram: "bool | None" = None) -> str:
    """Which loop a configuration's step runs, by configuration alone.
    Dense regime: ``fused_dense_sgd`` (the hand kernel on the card, its twin
    on the CPU) at fraction 1 in float32 for a residual the kernel has a
    mode for (least squares, logistic); ``torch_loop`` (``dense_sgd_loop``)
    for a Bernoulli mini-batch, another dtype or another residual. Sparse
    regime: ``gram`` (the dual loop; a batch that misses ``fits_gram`` runs
    the scatter loop unless ``use_gram`` is True) for float32 weights or
    ``use_gram=True``; ``scatter`` (``sparse_sgd_loop``) for other weights
    or ``use_gram=False``."""
    if sparse:
        if use_gram is None:
            return "gram" if dtype == torch.float32 else "scatter"
        return "gram" if use_gram else "scatter"
    if (mini_batch_fraction >= 1.0 and dtype == torch.float32
            and residual_mode(residual_fn) is not None):
        return "fused_dense_sgd"
    return "torch_loop"


def _check_slice(dtype) -> None:
    if dtype not in DTYPES.values():
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {dtype}")


def _unit_mass(lengths, row_len: int):
    """Row absolute masses of device-hashed tokens from the rows' unit
    counts: a row of n >= 2 units has n - 1 bigram terms of value 1.0, a
    1-unit row one term (ops/text_hash.py), at most ``row_len`` - 1."""
    n = np.asarray(lengths, np.int64)
    terms = np.where(n == 1, 1, np.maximum(n - 1, 0))
    return np.minimum(terms, max(int(row_len) - 1, 0))


def _bf16_exact(v: np.ndarray) -> np.ndarray:
    """Whether each float32 value survives a round trip through bfloat16
    (round to nearest even, as torch and XLA convert)."""
    bits = np.ascontiguousarray(v, np.float32).view(np.uint32).astype(np.uint64)
    rounded = ((bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return rounded.view(np.float32) == v


def host_planes(batch, int8_plane: "bool | None" = None) -> tuple:
    """The Gram plane of each batch in a HOST batch (numpy fields; one for a
    single batch, K for a stacked or grouped one), from what the host holds
    before the copy: the unit counts of the units wires (every device-hashed
    value is 1.0: integral and bf16-exact, the row mass its term count), the
    token values of a host-hashed ``FeatureBatch``. Equal to the branch the
    JAX package's predicates pick on the device (``ops/gram.gram_plane``)."""
    if isinstance(batch, PackedBatch):
        batch = unpack_batch(batch.buffer, batch.layout)
    if isinstance(batch, RaggedUnitBatch):
        offs = np.asarray(batch.offsets, np.int64)
        mass = _unit_mass(offs[..., 1:] - offs[..., :-1], batch.row_len)
        peaks = mass.max(axis=-1, initial=0).reshape(-1)
        return tuple(gram_plane(float(m), int8_plane=int8_plane) for m in peaks)
    if isinstance(batch, UnitBatch):
        mass = _unit_mass(batch.length, batch.units.shape[-1])
        peaks = mass.max(axis=-1, initial=0).reshape(-1)
        return tuple(gram_plane(float(m), int8_plane=int8_plane) for m in peaks)
    v = np.asarray(batch.token_val).astype(np.float32)
    v = v.reshape((-1,) + v.shape[-2:])  # [K, B, L]
    planes = []
    for vk in v:
        mass = np.abs(vk).sum(axis=-1, dtype=np.float32)
        planes.append(gram_plane(
            float(mass.max(initial=0.0)), bool(np.all(vk == np.round(vk))),
            bool(np.all(_bf16_exact(vk))), int8_plane,
        ))
    return tuple(planes)


def mask_cache(num_iterations: int, fraction: float, dtype) -> tuple:
    """A step's ``sampling_masks`` sets: (the cache, ``masks_for(rows,
    device, shard)``). Every batch draws the same masks (the key is
    PRNGKey(42) each batch), so a (row count, device, shard)'s [N, B] set is
    made once, on the step's device; at _MASK_CACHE_SIZE sets the cache
    starts over."""
    cache: dict = {}

    def masks_for(rows: int, device, shard: "int | None"):
        key = (rows, str(device), shard)
        if key not in cache:
            if len(cache) >= _MASK_CACHE_SIZE:
                cache.clear()
            cache[key] = sampling_masks(rows, num_iterations, fraction, dtype, device,
                                        shard=shard)
        return cache[key]

    return cache, masks_for


def decode_batch(batch, f_text: int, dtype) -> tuple:
    """A device wire batch as the step's inputs (token_idx [B, L] int32
    global indices, token_val [B, L], numeric [B, 4], labels [B], mask [B],
    the last four in ``dtype``): a PackedBatch reinterprets its bytes on the
    device (the offsets' delta decode is the only arithmetic), the ragged
    wire re-pads with the ASCII fold (the padded wire's units bit for bit),
    the units wires hash their bigrams on the device, and host-hashed
    tokens in their compact wire dtypes (int16 indices; uint16 counts,
    which travel as int16 bits) upcast once."""
    if isinstance(batch, PackedBatch):
        batch = unpack_batch(batch.buffer, batch.layout)
    if isinstance(batch, RaggedUnitBatch):
        units, length = ragged_repad(batch.units, batch.offsets, batch.row_len,
                                     batch.num_shards)
        batch = UnitBatch(units, length, batch.numeric, batch.label, batch.mask)
    if isinstance(batch, UnitBatch):
        token_idx, token_val = hash_bigrams_device(batch.units, batch.length, f_text, dtype)
    else:
        token_idx = batch.token_idx.to(torch.int32)
        token_val = batch.token_val
        if token_val.dtype == torch.int16:
            token_val = token_val.to(torch.int32) & 0xFFFF
        token_val = token_val.to(dtype)
    return (token_idx, token_val, batch.numeric.to(dtype), batch.label.to(dtype),
            batch.mask.to(dtype))


def gram_sgd_plain(weights, token_idx, token_val, numeric, raw, labels, mask, *, plane,
                   int8_plane, p_prev, masks, **loop_kw):
    """The Gram route's plain pieces on one batch (the CPU, bfloat16): G
    over the batch's occurring columns (``gram_matrix``, in ``plane``), the
    dual loop as torch ops (``run_dual_loop``; ``loop_kw`` its iterations,
    step size, L2, tolerance and residual), the write-back scatter. Returns
    the new weights [F + 4]."""
    f_text = weights.shape[0] - NUM_NUMBER_FEATURES
    g = gram_matrix(token_idx, token_val, numeric, f_text, weights.dtype, int8_plane, plane)
    dual = run_dual_loop(u=raw, g=g, labels=labels, mask=mask, dtype=weights.dtype,
                         p_prev=p_prev, masks=masks, **loop_kw)
    w_text, w_num = dual_writeback(weights[:f_text], weights[f_text:], dual["c"],
                                   dual["alpha"], token_idx, token_val, numeric)
    return torch.cat([w_text, w_num])


def gram_sgd_parallel(weights, token_idx, token_val, numeric, raw, labels, mask, *,
                      data, f_local: int, p_prev, model=None, lo: int = 0, masks=None,
                      int8_plane: "bool | None" = None, num_iterations: int,
                      step_size: float, l2_reg: float, convergence_tol: float,
                      residual_fn=least_squares_residual):
    """The JAX package's Gram route over a group, this rank's share of it:
    ONE all-gather of the rows over ``data`` (``Collectives``), this rank's
    [B_local, B] panel of G over its features (B4 and the G product on the
    card in float32), summed over ``model`` when the features are split
    over a model axis, an all-gather of the panels over ``data``, the
    numeric block, the dual loop replicated (B7 on the card), then this
    rank's rows' write-back (B8 on zero weights, from the rank's token
    rows: Zᵀα_local + Nᵀα_local) summed over ``data``, and W_new = c·W + that sum.

    ``weights`` are this rank's [f_local + 4]: the whole text (the data
    axis alone, ``model`` None) or the slice [lo, lo + f_local) of a
    feature-sharded model, then the 4 numeric weights. ``token_idx`` holds
    global indices: a slice keeps the tokens that land in it, each index
    made relative (``rel = idx − lo``, clipped) with the value zeroed
    outside. ``p_prev`` is ||W_prev||² over the whole model, ``masks`` the
    [N, B] Bernoulli draws of every global row (the unfolded key, as the
    JAX dual loop draws one global mask). The plane is the gathered rows'
    in this rank's features (read from the card: the group waits there
    anyway): every rank of a data axis builds its panel in the same one,
    and in the int8 and bf16 planes the panels are exact integer sums, so
    G summed over ``model`` is the one-process G bit for bit."""
    rows_local = mask.shape[0]
    g_idx, g_val, g_num, g_raw, g_mask, g_labels = data.all_gather_columns(
        token_idx, token_val, numeric, raw, mask, labels)
    if model is not None:
        rel = g_idx - lo
        g_val = g_val * ((rel >= 0) & (rel < f_local)).to(g_val.dtype)
        g_idx = torch.clamp(rel, 0, f_local - 1)
    plane = data_plane(g_val, int8_plane)
    rows = g_mask.shape[0]
    row0 = data.rank * rows_local
    dev = weights.device
    loop_kw = dict(num_iterations=num_iterations, step_size=step_size, l2_reg=l2_reg,
                   convergence_tol=convergence_tol, residual_fn=residual_fn)
    kernels = (dev.type == "cuda" and weights.dtype == torch.float32
               and residual_mode(residual_fn) is not None)
    if kernels:
        counts = fused_gram.count_build(g_idx, g_val, f_local, int8=plane == PLANE_INT8)
        panel = fused_gram.gram_from_counts(counts, rows=(row0, rows_local))[:, :rows]
    else:
        panel = text_gram(g_idx, g_val, f_local, row_start=row0, rows=rows_local,
                          int8_plane=int8_plane, plane=plane)
    panel = panel.contiguous()
    if model is not None:
        model.allreduce_(panel)
    g_text = data.all_gather_rows(panel)
    g = add_numeric_block(g_text, g_num, torch.float32 if kernels else weights.dtype)
    if kernels:
        c, alpha, _ = fused_gram.dual_sgd(g, g_raw, g_labels, g_mask, masks=masks,
                                          p_prev=p_prev, **loop_kw)
    else:
        dual = run_dual_loop(u=g_raw, g=g, labels=g_labels, mask=g_mask,
                             dtype=weights.dtype, p_prev=p_prev, masks=masks, **loop_kw)
        c, alpha = dual["c"], dual["alpha"]
    alpha_local = alpha[row0:row0 + rows_local].contiguous()
    zeros = torch.zeros_like(weights)
    if kernels:
        delta = fused_gram.dual_writeback_counts(
            zeros, c, alpha_local, g_idx[row0:row0 + rows_local], g_val[row0:row0 + rows_local],
            numeric, f_local)
    else:
        w_text, w_num = dual_writeback(zeros[:f_local], zeros[f_local:], c, alpha_local,
                                       g_idx[row0:row0 + rows_local],
                                       g_val[row0:row0 + rows_local], numeric)
        delta = torch.cat([w_text, w_num])
    data.allreduce_(delta)
    return weights * c + delta


class TenantRowTable(NamedTuple):
    """A data axis's gathered tenant rows (``Collectives.
    all_gather_tenant_rows``: tenant t's part holds every rank's ``rows``
    rows in rank order) and the blocks the Gram route builds from them:
    tenant t's block is its valid rows of each rank (``valid[r][t]``, from
    the gather's header) in rank order, each rank's padding skipped.
    ``rank`` is this rank."""

    valid: tuple
    rank: int
    rows: int

    @property
    def totals(self) -> tuple:
        """Each tenant's block rows: its valid rows over every rank."""
        return tuple(sum(v[t] for v in self.valid) for t in range(len(self.valid[0])))

    def first_row(self, r: int, t: int) -> int:
        """Rank r's first row in tenant t's block."""
        return sum(self.valid[q][t] for q in range(r))

    def segments(self) -> tuple:
        """Each tenant's (first gathered row, rows) runs, one a rank
        (``count_build_tenants``' segments)."""
        return tuple(tuple((r * self.rows, v[t]) for r, v in enumerate(self.valid))
                     for t in range(len(self.valid[0])))

    def mine(self) -> tuple:
        """This rank's (first row, rows) in each tenant's block."""
        return tuple((self.first_row(self.rank, t), self.valid[self.rank][t])
                     for t in range(len(self.valid[0])))

    def index(self, device) -> torch.Tensor:
        """[M, max(1, most block rows)] int64: row k of tenant t's block as
        its gathered row (0 past its block's rows, which nothing reads)."""
        totals = self.totals
        out = np.zeros((len(totals), max(1, max(totals))), np.int64)
        for t in range(len(totals)):
            out[t, :totals[t]] = np.concatenate(
                [r * self.rows + np.arange(v[t]) for r, v in enumerate(self.valid)])
        return torch.from_numpy(out).to(device)


def gather_tenant_panels(panels, table: TenantRowTable, data, int32, device) -> list:
    """Every tenant's text G of its block, [p, p] for its p block rows,
    from each rank's row panel of it (``panels[t]``: this rank's [n, ≥ p]
    rows of tenant t's G, None where it has none) in ONE all-gather: each
    rank lays its panels' first p columns end to end as 4-byte words, at the
    length of the longest rank's (every rank knows each one's rows), and
    each tenant's G stacks the ranks' panels in rank order. ``int32[t]``:
    tenant t's panel is the int8 product's s32 (else f32, carried as its
    bits). None for a tenant with no row on any rank. On ``device``."""
    totals = table.totals
    m, ranks = len(totals), len(table.valid)
    sizes = [[table.valid[r][t] * totals[t] for t in range(m)] for r in range(ranks)]
    width = max(1, max(sum(s) for s in sizes))
    buf = torch.zeros((1, width), dtype=torch.int32, device=device)
    at = 0
    for t, panel in enumerate(panels):
        if panel is not None:
            n, p = panel.shape[0], totals[t]
            buf[0, at:at + n * p].view(n, p).copy_(panel[:, :p].view(torch.int32))
        at += sizes[table.rank][t]
    gathered = data.all_gather_rows(buf)
    out = []
    for t in range(m):
        p = totals[t]
        pieces = [gathered[r, sum(sizes[r][:t]):sum(sizes[r][:t + 1])].view(v[t], p)
                  for r, v in enumerate(table.valid) if v[t]]
        g = torch.cat(pieces) if pieces else None
        out.append(g if g is None or int32[t] else g.view(torch.float32))
    return out


def tenants_by_plane(planes, rows) -> dict:
    """The tenants grouped by Gram plane for the tenant forms' launches
    (True: the int8 plane), each tenant with no row (``rows[t]`` 0) with the
    first tenant that has rows, so a dry tenant adds no launch."""
    live = [t for t in range(len(planes)) if rows[t]]
    lead = planes[live[0] if live else 0] == PLANE_INT8
    by_plane: dict = {}
    for t, plane in enumerate(planes):
        by_plane.setdefault(plane == PLANE_INT8 if rows[t] else lead, []).append(t)
    return by_plane


def gram_tenants_parallel(weights, token_idx, token_val, numeric, raw, labels, mask, *,
                          valid_rows, planes, data, masks_for, sampled: bool, step_sizes,
                          l2_regs, num_iterations: int, convergence_tol: float,
                          residual_fn=least_squares_residual):
    """The vmap form's Gram route over a data axis, this rank's share of M
    tenants' steps at once (the JAX vmap of ``gram_sgd_parallel``'s step
    inside ``shard_map``): ONE all-gather of every tenant's rows, each
    rank's valid rows and host plane of each riding in its header; each
    tenant's plane the lowest of the ranks' (each plane's gate holds for
    every row, so the gathered rows pass the tightest: every rank picks the
    same); each tenant's block its valid rows of every rank in rank order
    (``TenantRowTable``); this rank's row panel of each tenant's G; ONE
    all-gather of every tenant's panels; the M dual loops replicated, each
    tenant's rows keeping their global positions' ``-b`` < 1 draws (the
    unfolded key over the S·B gathered rows, as the JAX dual loop draws
    them); this rank's rows' write-back on zero weights; ONE all-reduce of
    the [M, F + 4] sums; W_new = c·W + that sum. On the card in float32
    the hand kernels' tenant forms: B4's over the segments (once a plane
    present), one library product a tenant's panel, B7's with each tenant's
    own draws, B8's at this rank's rows of each block (once a tick); else
    the plain pieces tenant by tenant. Inputs are this rank's [M, B_local]
    rows; ``valid_rows`` and ``planes`` this rank's, from the host."""
    m, rows_local = mask.shape
    f_text = weights.shape[1] - NUM_NUMBER_FEATURES
    dev = weights.device
    header = np.asarray([*valid_rows, *planes], np.int64)
    heads, (g_idx, g_val, g_num, g_raw, g_mask, g_labels) = data.all_gather_tenant_rows(
        header, token_idx, token_val, numeric, raw, mask, labels)
    table = TenantRowTable(valid=tuple(tuple(int(v) for v in h[:m]) for h in heads),
                           rank=data.rank, rows=rows_local)
    planes = [int(heads[:, m + t].min()) for t in range(m)]
    totals, mine = table.totals, table.mine()
    index = table.index(dev)
    tenant = torch.arange(m, device=dev)[:, None]
    u_b, y_b, mask_b, num_b = (x[tenant, index] for x in (g_raw, g_labels, g_mask, g_num))
    masks = None
    if sampled:  # [N, M, block rows]: each row's draw at its global position
        masks = masks_for(data.world * rows_local, dev, None)[:, index]
    p_prev = torch.sum(weights * weights, dim=1)
    loop_kw = dict(num_iterations=num_iterations, convergence_tol=convergence_tol,
                   residual_fn=residual_fn)
    if (dev.type == "cuda" and weights.dtype == torch.float32
            and residual_mode(residual_fn) is not None):
        panels = [None] * m
        for int8, tenants in tenants_by_plane(planes, totals).items():
            counts, at = fused_gram.count_build_tenants(
                g_idx, g_val, f_text, valid_rows=totals, int8=int8, tenants=tenants,
                segments=table.segments())
            for t, panel in zip(tenants, fused_gram.tenant_gram_blocks(
                    counts, at, [totals[t] for t in tenants], rows=[mine[t] for t in tenants])):
                panels[t] = panel
        gs = gather_tenant_panels(panels, table, data,
                                  [planes[t] == PLANE_INT8 for t in range(m)], dev)
        c, alpha, _ = fused_gram.dual_sgd_tenants(
            gs, u_b, y_b, mask_b, num_b, valid_rows=totals, masks=masks, p_prev=p_prev,
            step_sizes=step_sizes, l2_regs=l2_regs, **loop_kw)
        # this rank's rows of each block: its rows of each gathered part
        delta = fused_gram.dual_writeback_tenants(
            torch.zeros_like(weights), c, alpha, g_idx, g_val, num_b, f_text,
            valid_rows=[v for _, v in mine], first_rows=[o for o, _ in mine],
            token_rows=[data.rank * rows_local] * m)
    else:
        blocks = [(g_idx[t, index[t, :p]], g_val[t, index[t, :p]]) for t, p in enumerate(totals)]
        gs = gather_tenant_panels(
            [text_gram(i, v, f_text, row_start=o, rows=n, plane=planes[t]) if n else None
             for t, ((i, v), (o, n)) in enumerate(zip(blocks, mine))],
            table, data, [False] * m, dev)
        c = torch.ones((m,), dtype=weights.dtype, device=dev)
        delta = torch.zeros_like(weights)
        for t, p in enumerate(totals):
            if not p:  # no row on any rank: c = 1, no update
                continue
            dual = run_dual_loop(
                u=u_b[t, :p], g=add_numeric_block(gs[t], num_b[t, :p], weights.dtype),
                labels=y_b[t, :p], mask=mask_b[t, :p], dtype=weights.dtype, p_prev=p_prev[t],
                masks=None if masks is None else masks[:, t, :p], step_size=step_sizes[t],
                l2_reg=l2_regs[t], **loop_kw)
            c[t] = dual["c"]
            o, n = mine[t]
            w_text, w_num = dual_writeback(
                delta[t, :f_text], delta[t, f_text:], dual["c"], dual["alpha"][o:o + n],
                blocks[t][0][o:o + n], blocks[t][1][o:o + n], num_b[t, o:o + n])
            delta[t] = torch.cat([w_text, w_num])
    data.allreduce_(delta)
    return weights * c[:, None] + delta


def make_sgd_train_step(
    *,
    num_text_features: int,
    num_iterations: int,
    step_size: float,
    mini_batch_fraction: float = 1.0,
    l2_reg: float = 0.0,
    convergence_tol: float = 0.001,
    residual_fn=None,
    prediction_fn=None,
    round_predictions: bool = True,
    quality: bool = False,
    dtype=torch.float32,
    use_sparse: "bool | None" = None,
    use_gram: "bool | None" = None,
    gram_int8: "bool | None" = None,
    group=None,
):
    """Build the (weights, batch[, plane]) -> (new_weights, StepOutput) step.
    ``residual_fn(raw, label)`` is the per-row gradient multiplier (None:
    least squares, raw − label), ``prediction_fn(raw)`` maps the raw margin
    to the reported prediction (None: identity), rounded HALF_UP when
    ``round_predictions``: the JAX package's three knobs. ``batch`` is a
    PackedBatch (a uint8 buffer tensor), RaggedUnitBatch, UnitBatch or
    FeatureBatch of tensors on the weights' device. ``use_sparse`` (None:
    above 8192 text features), ``use_gram`` (None: the gate; False: the
    scatter loop) and ``gram_int8`` (None: ``GRAM_INT8_PLANE``) are the
    JAX package's. ``plane`` is the batch's Gram plane from
    ``host_planes`` (None: read from the tokens, which syncs on a card).

    ``group`` (parallel/distributed.py ``Collectives``; None: one process)
    makes the step this rank's share of a data-parallel step over the
    group's ranks, the JAX package's step under ``axis_name``: the batch is
    this rank's rows, the weights replicated. The stats and the quality
    vector sum over the ranks (one all-reduce each); the fused route runs
    B1's data-parallel split (``fused_dense_sgd_split``: one all-reduce of
    the gradient and count an iteration), the torch and scatter loops
    all-reduce the same, and under ``-b`` < 1 draw under the key folded
    with the group's rank (the data index, when ``group`` is a mesh's data
    axis); the Gram route (``gram_sgd_parallel``) all-gathers the rows
    once, builds this rank's [B_local, B] panel of G, all-gathers G, runs
    the dual loop replicated (under ``-b`` < 1 on one mask over the global
    rows, the unfolded key, as the JAX dual loop draws it) and writes back
    its own rows' share, all-reduced. The ``fits_gram`` gate counts the
    global rows, as the JAX package's does."""
    _check_slice(dtype)
    f_text = num_text_features
    sparse = f_text > DENSE_TEXT_FEATURE_LIMIT if use_sparse is None else use_sparse
    residual_fn = residual_fn or least_squares_residual
    route = dense_route(mini_batch_fraction, dtype, residual_fn, sparse, use_gram)
    int8_plane = GRAM_INT8_PLANE if gram_int8 is None else gram_int8
    sampled = mini_batch_fraction < 1.0
    reduce = None if group is None else group.allreduce_
    world = 1 if group is None else group.world
    masks_by_rows, masks_for = mask_cache(num_iterations, mini_batch_fraction, dtype)
    loop_kw = dict(num_iterations=num_iterations, step_size=step_size,
                   l2_reg=l2_reg, convergence_tol=convergence_tol, residual_fn=residual_fn)

    def gram_sgd(weights, token_idx, token_val, numeric, raw, labels, mask, masks, plane):
        """The loop in the dual basis: the hand kernels on the card in
        float32 (B4, the G product, B7, B8), the plain pieces elsewhere."""
        if group is not None:
            # the JAX dual loop draws one mask over the global rows with the
            # unfolded key
            return gram_sgd_parallel(
                weights, token_idx, token_val, numeric, raw, labels, mask, data=group,
                f_local=f_text, p_prev=torch.sum(weights * weights),
                masks=masks_for(mask.shape[0] * world, mask.device, None) if sampled else None,
                int8_plane=int8_plane, **loop_kw)
        rows = mask.shape[0]
        p_prev = torch.sum(weights * weights)
        dev = weights.device
        if (dev.type == "cuda" and weights.dtype == torch.float32
                and residual_mode(residual_fn) is not None):
            counts = fused_gram.count_build(token_idx, token_val, f_text,
                                            int8=plane == PLANE_INT8)
            g = fused_gram.gram_from_counts(counts)
            g[:rows, :rows] += numeric @ numeric.T  # add_numeric_block
            # B7 raises past the rows its shared memory holds (~19,000 on an
            # H100; the 2^18 gate admits at most 4,096)
            c, alpha, _ = fused_gram.dual_sgd(g, raw, labels, mask, masks=masks,
                                              p_prev=p_prev, **loop_kw)
            return fused_gram.dual_writeback_counts(weights, c, alpha, token_idx, token_val,
                                                    numeric, f_text)
        return gram_sgd_plain(weights, token_idx, token_val, numeric, raw, labels, mask,
                              plane=plane, int8_plane=int8_plane, p_prev=p_prev, masks=masks,
                              **loop_kw)

    def train_step(weights, batch, plane: "int | None" = None):
        token_idx, token_val, numeric, labels, mask = decode_batch(batch, f_text, dtype)
        rows = mask.shape[0]
        # a rank of a data axis draws under the key folded with its data
        # index (``group.rank``: the JAX package's ``sampling_key(data)``)
        shard = None if group is None else group.rank
        masks = masks_for(rows, mask.device, shard) if sampled else None
        if not sparse:
            x_dense = torch.cat(
                [densify_text(token_idx, token_val, f_text), numeric], dim=1
            )
            if route == "fused_dense_sgd" and group is not None:
                w_new, raw = fused_sgd.fused_dense_sgd_split(
                    x_dense, labels, mask, weights, allreduce=reduce, **loop_kw)
            elif route == "fused_dense_sgd":
                w_new, raw = fused_dense_sgd(x_dense, labels, mask, weights, **loop_kw)
            else:
                w_new, raw = dense_sgd_loop(x_dense, labels, mask, weights, masks=masks,
                                            reduce=reduce, **loop_kw)
        else:
            raw = sparse_predict(weights[:f_text], weights[f_text:], token_idx,
                                 token_val, numeric)
            if route == "gram" and (use_gram
                                    or fits_gram(rows * world, f_text, num_iterations)):
                if plane is None:
                    plane = data_plane(token_val, int8_plane)
                w_new = gram_sgd(weights, token_idx, token_val, numeric, raw, labels,
                                 mask, masks, plane)
            else:
                w_new = sparse_sgd_loop(weights, token_idx, token_val, numeric, labels,
                                        mask, num_text_features=f_text, masks=masks,
                                        reduce=reduce, **loop_kw)
        preds = raw if prediction_fn is None else prediction_fn(raw)
        if round_predictions:
            preds = torch_round_half_up(preds)
        stats = batch_stats(labels, preds, mask, reduce=reduce)
        q = None
        if quality:
            q = quality_vector(
                weights, w_new, residual=residual_fn(raw, labels) * mask, preds=preds,
                labels=labels, mask=mask, numeric=numeric,
                token_idx=token_idx, token_val=token_val, reduce=reduce,
            )
        return w_new, StepOutput(predictions=preds, quality=q, **stats)

    train_step.route = route
    train_step.sparse = sparse
    train_step.int8_plane = int8_plane
    # the sampled route's cached mask sets (a CUDA graph that reads one
    # holds a reference to it)
    train_step.masks_by_rows = masks_by_rows
    return train_step


def flatten_tenants(wire):
    """A stacked device wire ([M]-leading fields, or an unpacked group) as
    ONE batch of its M·B rows in tenant order: the padded wires' fields
    reshaped, the ragged wire's M unit buffers and offset blocks as the
    segments of a shard-segment batch (``ops/ragged.ragged_repad``), so
    ``decode_batch`` decodes every tenant at once, each row as alone."""
    if isinstance(wire, PackedBatch):
        wire = unpack_batch(wire.buffer, wire.layout)
    if isinstance(wire, RaggedUnitBatch):
        m = wire.mask.shape[0]
        return RaggedUnitBatch(
            wire.units.reshape(-1), wire.offsets.reshape(-1),
            wire.numeric.reshape((-1,) + tuple(wire.numeric.shape[2:])),
            wire.label.reshape(-1), wire.mask.reshape(-1), row_len=wire.row_len,
            num_shards=m * wire.num_shards)
    return type(wire)(*(a.reshape((-1,) + tuple(a.shape[2:])) for a in wire))


def make_sgd_tenant_step(
    *,
    num_tenants: int,
    step_sizes,
    l2_regs,
    num_text_features: int,
    num_iterations: int,
    mini_batch_fraction: float = 1.0,
    convergence_tol: float = 0.001,
    residual_fn=None,
    prediction_fn=None,
    round_predictions: bool = True,
    quality: bool = False,
    dtype=torch.float32,
    use_sparse: "bool | None" = None,
    use_gram: "bool | None" = None,
    gram_int8: "bool | None" = None,
    group=None,
):
    """The train step batched over M tenants: the JAX package's ``jax.vmap``
    of the step (``twtml_tpu/parallel/tenants.py``, ``mapping="vmap"``).
    Builds ``(weights [M, F+4], wire, valid_rows[, planes]) -> (new
    weights, [M]-leading StepOutput)``: ``wire`` a stacked device wire or
    an unpacked group of M tenant parts, ``valid_rows`` each part's rows up
    to its last valid one (``features/batch.tenant_valid_rows`` of the HOST
    masks, so nothing is read back), ``planes`` each part's Gram plane
    (``host_planes``; the Gram route reads them from the tokens when not
    given, which syncs on a card). Tenant m trains with ``step_sizes[m]``
    and ``l2_regs[m]``; the rest is shared.

    The M·B rows decode (and, in the dense regime, hash and densify) at
    once (``flatten_tenants``), then one loop trains every tenant, on the
    route of ``dense_route``. Dense regime: ``fused_dense_sgd_tenants`` (the
    tenant grid kernel on the card, its plain version on the CPU) or the
    batched torch loop (``dense_sgd_loop`` with a step table). Sparse regime
    (the 2^18 routes), predictions by one gather for every tenant: the
    ``gram`` route (a part's rows passing ``fits_gram``, as the JAX gate
    counts one tenant's rows) on the card in float32 is B4's tenant form
    once a plane present (the tenants grouped by their plane: a tenant in
    the f32 plane does not widen the others), one library G product a
    tenant with rows over its valid rows (``tenant_gram_blocks``), B7's
    tenant form once (N·Nᵀ added in its prologue) and B8's tenant form once
    (it reads the tokens, whatever the planes); elsewhere (the CPU, bfloat16) the plain pieces on each
    tenant's valid rows, as ``make_sgd_train_step``'s Gram route; the
    ``scatter`` route (and a batch over the gate) the batched scatter loop
    (``sparse_sgd_loop`` with a step table). Every tenant shares the ``-b``
    < 1 masks, as the JAX vmap draws them under one key. Rounding, the
    stats and the quality vector run over the leading M as batched ops.
    The sums run in another order than the scan form's M steps, so the two
    agree within float rounding, not bitwise, as the JAX package's vmap and
    scan do.

    ``group`` (``Collectives`` of a data axis; None: one process) makes it
    this rank's share of the M tenants' data-parallel steps, the JAX vmap
    inside ``shard_map``, whose psums over the data axis become one
    collective of the M tenants' values: the fused route runs
    ``fused_dense_sgd_tenants_split`` (on the card the tenant grid form of
    B1's split, one all-reduce of [M, fpad + 1] floats an iteration), the
    torch loop all-reduces the [M, F] gradients and [M] counts in one
    buffer an iteration and, under ``-b`` < 1, draws every tenant's masks
    under the key folded with the rank (the JAX vmap's one
    ``sampling_key(data)``); the stats and the quality vector take one
    all-reduce each. N + 1 all-reduces a step (N + 2 with the quality
    vector), whatever M. The sparse regime's scatter route is the batched
    scatter loop with the same one all-reduce an iteration: N + 1 (N + 2)
    a step. Its Gram route (``gram_tenants_parallel``, the ``fits_gram``
    gate counting a part's global rows, B_local x ranks, as the JAX gate's
    ``b_global``) makes one all-gather of every tenant's rows (each rank's
    valid rows and planes in its header), one of every tenant's G panels,
    one all-reduce of the write-backs, then the stats' (and the quality
    vector's): 2 all-gathers and 2 all-reduces a step (3 with the quality
    vector), whatever M."""
    _check_slice(dtype)
    f_text = num_text_features
    sparse = f_text > DENSE_TEXT_FEATURE_LIMIT if use_sparse is None else use_sparse
    residual_fn = residual_fn or least_squares_residual
    route = dense_route(mini_batch_fraction, dtype, residual_fn, sparse, use_gram)
    int8_plane = GRAM_INT8_PLANE if gram_int8 is None else gram_int8
    step_sizes = [float(v) for v in step_sizes]
    l2_regs = [float(v) for v in l2_regs]
    if not len(step_sizes) == len(l2_regs) == num_tenants:
        raise ValueError(f"{num_tenants} tenants need {num_tenants} step sizes and L2s")
    sampled = mini_batch_fraction < 1.0
    reduce = None if group is None else group.allreduce_
    shard = None if group is None else group.rank
    world = 1 if group is None else group.world
    _, masks_for = mask_cache(num_iterations, mini_batch_fraction, dtype)
    tables: dict = {}
    loop_kw = dict(num_iterations=num_iterations, convergence_tol=convergence_tol,
                   residual_fn=residual_fn)

    def step_table(device):
        """(eta, scale) [N, M, 1] of every iteration and tenant in the
        weights' type (``tenant_step_table``), made once a device: from
        page-locked memory with a non-blocking copy on cuda (no host sync),
        the host tensor kept with it."""
        key = str(device)
        if key not in tables:
            host = tenant_step_table(step_sizes, l2_regs, num_iterations, dtype)
            if device.type == "cuda":
                host = host.pin_memory()
            tables[key] = (host, host.to(device, non_blocking=True))
        dev = tables[key][1]
        return dev[0], dev[1]

    def gram_tenants(weights, token_idx, token_val, numeric, raw, labels, mask, masks, planes,
                     valid_rows):
        """Every tenant's step in the dual basis over its valid rows: the
        hand kernels' tenant forms on the card in float32, the plain pieces
        tenant by tenant elsewhere."""
        m = num_tenants
        if planes is None:
            planes = [data_plane(token_val[t], int8_plane) for t in range(m)]
        valid = [int(v) for v in valid_rows]
        if group is not None:
            return gram_tenants_parallel(
                weights, token_idx, token_val, numeric, raw, labels, mask, valid_rows=valid,
                planes=planes, data=group, masks_for=masks_for, sampled=sampled,
                step_sizes=step_sizes, l2_regs=l2_regs, **loop_kw)
        p_prev = torch.sum(weights * weights, dim=1)
        if (weights.device.type == "cuda" and weights.dtype == torch.float32
                and residual_mode(residual_fn) is not None):
            gs = [None] * m
            for int8, tenants in tenants_by_plane(planes, valid).items():
                counts, at = fused_gram.count_build_tenants(
                    token_idx, token_val, f_text, valid_rows=valid, int8=int8, tenants=tenants)
                for t, g in zip(tenants, fused_gram.tenant_gram_blocks(
                        counts, at, [valid[t] for t in tenants])):
                    gs[t] = g
            c, alpha, _ = fused_gram.dual_sgd_tenants(
                gs, raw, labels, mask, numeric, valid_rows=valid, masks=masks, p_prev=p_prev,
                step_sizes=step_sizes, l2_regs=l2_regs, **loop_kw)
            return fused_gram.dual_writeback_tenants(weights, c, alpha, token_idx, token_val,
                                                     numeric, f_text, valid_rows=valid,
                                                     out=torch.empty_like(weights))
        return torch.stack([
            gram_sgd_plain(weights[t], token_idx[t, :v], token_val[t, :v], numeric[t, :v],
                           raw[t, :v], labels[t, :v], mask[t, :v], plane=planes[t],
                           int8_plane=int8_plane, p_prev=p_prev[t],
                           masks=None if masks is None else masks[:, :v],
                           step_size=step_sizes[t], l2_reg=l2_regs[t], **loop_kw)
            if v else weights[t].clone()  # no row: c = 1, α empty, W unchanged
            for t, v in enumerate(valid)])

    def tenant_step(weights, wire, valid_rows, planes=None):
        m = num_tenants
        token_idx, token_val, numeric, labels, mask = decode_batch(
            flatten_tenants(wire), f_text, dtype)
        rows = mask.shape[0] // m
        labels, mask = labels.view(m, rows), mask.view(m, rows)
        token_idx, token_val = token_idx.view(m, rows, -1), token_val.view(m, rows, -1)
        numeric = numeric.view(m, rows, -1)
        # a rank of a data axis draws under the key folded with its data
        # index; the Gram route over one draws over the gathered rows
        masks = masks_for(rows, mask.device, shard) if sampled else None
        if sparse:
            raw = sparse_predict(weights[:, :f_text], weights[:, f_text:], token_idx,
                                 token_val, numeric)
            if route == "gram" and (use_gram
                                    or fits_gram(rows * world, f_text, num_iterations)):
                w_new = gram_tenants(weights, token_idx, token_val, numeric, raw, labels, mask,
                                     masks, planes, valid_rows)
            else:
                w_new = sparse_sgd_loop(weights, token_idx, token_val, numeric, labels, mask,
                                        num_text_features=f_text, masks=masks, step_size=None,
                                        step_table=step_table(mask.device), reduce=reduce,
                                        **loop_kw)
        else:
            x_dense = torch.cat([densify_text(token_idx.view(m * rows, -1),
                                              token_val.view(m * rows, -1), f_text),
                                 numeric.view(m * rows, -1)], dim=1).view(m, rows, -1)
            if route == "fused_dense_sgd" and group is not None:
                w_new, raw = fused_sgd.fused_dense_sgd_tenants_split(
                    x_dense, labels, mask, weights, valid_rows=valid_rows, allreduce=reduce,
                    step_sizes=step_sizes, l2_regs=l2_regs, **loop_kw)
            elif route == "fused_dense_sgd":
                w_new, raw = fused_sgd.fused_dense_sgd_tenants(
                    x_dense, labels, mask, weights, valid_rows=valid_rows,
                    step_sizes=step_sizes, l2_regs=l2_regs, **loop_kw)
            else:
                w_new, raw = dense_sgd_loop(x_dense, labels, mask, weights, masks=masks,
                                            step_size=None, step_table=step_table(mask.device),
                                            reduce=reduce, **loop_kw)
        preds = raw if prediction_fn is None else prediction_fn(raw)
        if round_predictions:
            preds = torch_round_half_up(preds)
        stats = batch_stats(labels, preds, mask, reduce=reduce)
        q = None
        if quality:
            q = quality_vector(
                weights, w_new, residual=residual_fn(raw, labels) * mask, preds=preds,
                labels=labels, mask=mask, numeric=numeric, token_idx=token_idx,
                token_val=token_val, reduce=reduce,
            )
        return w_new, StepOutput(predictions=preds, quality=q, **stats)

    tenant_step.route = route
    return tenant_step


def zero_weights(num_text_features: int, dtype=torch.float32, device="cuda"):
    """MLlib initial weights: zeros(numFeatures) (LinearRegression.scala:32),
    on the card unless the caller asks for the CPU."""
    return torch.zeros(
        (num_text_features + NUM_NUMBER_FEATURES,), dtype=dtype,
        device=resolve_device(device),
    )


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A host array as a CPU tensor sharing its memory; uint16 as int16."""
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    return torch.from_numpy(np.ascontiguousarray(a))


def batch_to_device(batch, device, non_blocking: bool = True):
    """Host numpy batch -> the same batch type of tensors on ``device``. A
    PackedBatch is ONE copy of its uint8 buffer. On ``cuda`` with
    ``non_blocking`` the copy is queued on the current stream and returns at
    once when the buffer is page-locked (the arena's buffers are, for a cuda
    model): the host buffer must then stay untouched until the stream has
    run the copy, which the fetch pipeline's lease rule guarantees (the
    lease retires after the batch's results were delivered). A pageable
    array is staged by the driver before the call returns. On the CPU the
    tensors share the host arrays. uint16 code units and term counts travel
    as int16 (same bits; the device ops mask them back), since torch's
    uint16 has few kernels."""

    def move(a: np.ndarray) -> torch.Tensor:
        return _host_tensor(a).to(device, non_blocking=non_blocking)

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
    predictions, the 4 stats and the quality vector, packed into one f32
    vector (f64 for a float64 step), into page-locked memory, with one CUDA
    event recorded after it. ``done()`` asks the event without blocking;
    ``wait()`` blocks on it; ``result()`` (after ``done()``) is the
    StepOutput of numpy arrays, bit for bit the device values: a [K]-leading
    one for a group (``step_many``'s output, ``groups`` = K). On the CPU the
    result is ready at once."""

    __slots__ = ("_host", "_event", "_rows", "_has_quality", "_groups")

    def __init__(self, host: torch.Tensor, event, rows: int, has_quality: bool,
                 groups: int = 0):
        self._host = host
        self._event = event
        self._rows = rows
        self._has_quality = has_quality
        self._groups = groups

    def done(self) -> bool:
        return self._event is None or self._event.query()

    def wait(self) -> None:
        if self._event is not None:
            self._event.synchronize()

    def result(self) -> StepOutput:
        v = self._host.numpy()
        b = self._rows
        if not self._groups:
            return StepOutput(
                predictions=v[:b], count=v[b], mse=v[b + 1], real_stdev=v[b + 2],
                pred_stdev=v[b + 3],
                quality=v[b + 4:].astype(np.float32) if self._has_quality else None,
            )
        k = self._groups
        stats = v[k * b:k * b + 4 * k].reshape(4, k)
        return StepOutput(
            predictions=v[:k * b].reshape(k, b), count=stats[0], mse=stats[1],
            real_stdev=stats[2], pred_stdev=stats[3],
            quality=(v[k * b + 4 * k:].reshape(k, -1).astype(np.float32)
                     if self._has_quality else None),
        )


def fetch_output(out: StepOutput) -> HostOutput:
    """Start the host fetch of a device StepOutput, one batch's or a
    group's ([K]-leading fields, from ``step_many``): one device-side
    concatenation, one non-blocking D2H copy into pinned memory and one
    event on the current stream, no host sync. Calling it again on the
    same output issues a fresh copy of the still-resident tensors."""
    groups = out.predictions.shape[0] if out.predictions.dim() == 2 else 0
    parts = [out.predictions.reshape(-1),
             torch.stack([out.count, out.mse, out.real_stdev, out.pred_stdev]).reshape(-1)]
    if out.quality is not None:
        parts.append(out.quality.reshape(-1))
    # float64 steps keep their stats in float64, as the JAX package's x64
    # step returns them; every other type fits float32 exactly
    kind = torch.float64 if out.predictions.dtype == torch.float64 else torch.float32
    vec = torch.cat([p.to(kind) for p in parts])
    rows = out.predictions.shape[-1]
    if vec.device.type != "cuda":
        return HostOutput(vec, None, rows, out.quality is not None, groups)
    host = torch.empty(vec.shape, dtype=kind, pin_memory=True)
    host.copy_(vec, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return HostOutput(host, event, rows, out.quality is not None, groups)


def _batch_at(stacked, i: int):
    """Batch ``i`` of a stacked batch ([K]-leading fields)."""
    if isinstance(stacked, RaggedUnitBatch):
        return RaggedUnitBatch(stacked.units[i], stacked.offsets[i], stacked.numeric[i],
                               stacked.label[i], stacked.mask[i], row_len=stacked.row_len)
    return type(stacked)(*(a[i] for a in stacked))


def _stack_outputs(outs: list) -> StepOutput:
    """K StepOutputs as one with [K]-leading fields."""
    return StepOutput(*(
        None if fields[0] is None else torch.stack(fields) for fields in zip(*outs)
    ))


def _wire_fields(batch) -> list:
    """The arrays (host) or tensors (device) a wire batch carries, in order."""
    if isinstance(batch, PackedBatch):
        return [batch.buffer]
    if isinstance(batch, RaggedUnitBatch):
        return [batch.units, batch.offsets, batch.numeric, batch.label, batch.mask]
    return list(batch)


def wire_signature(batch) -> tuple:
    """What fixes a step_many program: the wire's type, its layout or
    ragged row length, and every field's shape and dtype."""
    static = (batch.layout if isinstance(batch, PackedBatch)
              else batch.row_len if isinstance(batch, RaggedUnitBatch) else None)
    return (type(batch).__name__, static) + tuple(
        (tuple(a.shape), str(a.dtype)) for a in _wire_fields(batch))


def _kernel_counters() -> tuple:
    """The hand kernels' wrappers, whose counters a graph's replay advances:
    looked up on their modules at each call (a caller may have wrapped the
    names this module calls)."""
    return (fused_sgd.fused_dense_sgd, fused_gram.count_build, fused_gram.dual_sgd,
            fused_gram.dual_writeback_counts)


class _GroupGraph:
    """One captured step_many: the device buffers the graph reads (the
    wire's fields, the incoming weights) and writes (the new weights, the
    K outputs), each hand kernel's launches one replay makes
    (``_kernel_counters`` order), and what the graph reads that the model
    caches (the sampled route's masks)."""

    __slots__ = ("graph", "wire", "w_in", "w_out", "outs", "launches", "keep")

    def __init__(self, graph, wire, w_in, w_out, outs, launches, keep):
        self.graph = graph
        self.wire = wire
        self.w_in = w_in
        self.w_out = w_out
        self.outs = outs
        self.launches = launches
        self.keep = keep


class StreamingSGDModel:
    """Shared surface of the streaming SGD learners (linear, logistic):
    weights on the model's device (updated each step), the fused step, the
    K-step ``step_many``, conf plumbing. Subclasses set the three gradient
    knobs (``residual_fn``, ``prediction_fn``, ``round_predictions``) and
    ``default_step_size``; the constructor's arguments of the same names
    override the knobs (the data-parallel learner takes them so)."""

    residual_fn = None  # least squares when None
    prediction_fn = None  # identity when None
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
        use_sparse: "bool | None" = None,
        use_gram: "bool | None" = None,
        gram_int8: "bool | None" = None,
        group=None,
        residual_fn=None,
        prediction_fn=None,
        round_predictions: "bool | None" = None,
    ) -> None:
        self.num_text_features = num_text_features
        self.dtype = dtype
        self.device = resolve_device(device)
        self._train_step = self._make_step(
            num_text_features=num_text_features,
            num_iterations=num_iterations,
            step_size=self.default_step_size if step_size is None else step_size,
            mini_batch_fraction=mini_batch_fraction,
            l2_reg=l2_reg,
            convergence_tol=convergence_tol,
            # the class's knobs unless given (read off the class, unbound)
            residual_fn=residual_fn or type(self).residual_fn,
            prediction_fn=prediction_fn or type(self).prediction_fn,
            round_predictions=(self.round_predictions if round_predictions is None
                               else round_predictions),
            quality=quality,
            dtype=dtype,
            use_sparse=use_sparse,
            use_gram=use_gram,
            gram_int8=gram_int8,
            group=group,
        )
        self.route = self._train_step.route
        log.info("%s step route: %s (miniBatchFraction %s, %s weights, %s)",
                 "sparse" if self._train_step.sparse else "dense", self.route,
                 mini_batch_fraction, str(dtype).replace("torch.", ""), self.device)
        self._weights = self._zero_weights()
        # H2D copies queue without waiting (batch_to_device); False makes
        # each copy synchronous, the reference order for a pipelined run
        self.non_blocking = True
        # the stream the model runs on: the constructing thread's current
        # stream, which bind_thread makes current on another thread
        self.stream = (
            torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
        )
        # step_many's captured graphs by (wire signature, K), oldest first
        self._graphs: dict = {}

    def _make_step(self, **kwargs):
        """The train step (``make_sgd_train_step``'s arguments)."""
        return make_sgd_train_step(**kwargs)

    def _zero_weights(self):
        """MLlib's initial weights on the model's device."""
        return zero_weights(self.num_text_features, self.dtype, self.device)

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
            dtype=DTYPES[conf.dtype],
            device=conf.backend,
        )
        kwargs.update(overrides)
        return cls(**kwargs)

    def set_initial_weights(self, weights) -> "StreamingSGDModel":
        """Replace the weights with a FRESH tensor made on the model's
        stream: steps still queued there (a rollback while batches are in
        flight) run before the copy and keep writing their own outputs,
        never this tensor, and the next dispatch reads it after the copy.
        The copy from host memory waits for the stream, so the caller's
        array may be reused at once."""
        w = torch.as_tensor(weights, dtype=self.dtype)
        if tuple(w.shape) != tuple(self._weights.shape):
            raise ValueError(
                f"weights must have shape {tuple(self._weights.shape)}, "
                f"got {tuple(w.shape)}"
            )
        if self.stream is None:
            self._weights = w.to(self.device, copy=True)
            return self
        with torch.cuda.stream(self.stream):
            self._weights = w.to(self.device, copy=True)
        return self

    def reset(self) -> "StreamingSGDModel":
        """Back to MLlib's initial state: zero weights."""
        self._weights = self._zero_weights()
        return self

    @property
    def latest_weights(self) -> np.ndarray:
        """The weights on the host: a blocking copy that waits for every
        step queued before it. Read it only where nothing is in flight (the
        fetch pipeline's drained boundary), never inside a dispatch.
        bfloat16 weights come back as float32, which holds them exactly
        (numpy has no bfloat16; the checkpoint stores them so)."""
        w = self._weights.detach()
        if w.dtype == torch.bfloat16:
            w = w.float()
        return w.cpu().numpy().copy()

    def bind_thread(self) -> None:
        """Make the model's CUDA device and stream current on the calling
        thread (both are per thread in PyTorch): the streaming scheduler
        calls it where its thread starts. No-op on the CPU."""
        if self.stream is not None:
            torch.cuda.set_device(self.stream.device)
            torch.cuda.set_stream(self.stream)

    def planes(self, batch) -> tuple:
        """The Gram plane of each batch in a host batch (``host_planes``), or
        () on a route that builds no G."""
        if self.route != "gram":
            return ()
        return host_planes(batch, self._train_step.int8_plane)

    def step(self, batch) -> StepOutput:
        """Fused predict-then-train on one host micro-batch; advances the
        model and returns the device-side StepOutput, with nothing waited
        for on ``cuda``."""
        planes = self.planes(batch)
        self._weights, out = self._train_step(
            self._weights, batch_to_device(batch, self.device, self.non_blocking),
            plane=planes[0] if planes else None,
        )
        return out

    @staticmethod
    def fetch_output(out: StepOutput) -> HostOutput:
        """Start the host fetch of ``step``'s or ``step_many``'s output
        (``fetch_output``)."""
        return fetch_output(out)

    def _train_many(self, weights, wire, planes: tuple = ()):
        """The K steps of a device wire: a packed group or stack unpacks
        first (its [K]-leading fields), then batch k steps with the weights
        batch k - 1 left (in Gram plane ``planes[k]`` when given). Returns
        (new weights, [K]-leading StepOutput)."""
        if isinstance(wire, PackedBatch):
            wire = unpack_batch(wire.buffer, wire.layout)
        outs = []
        for i in range(wire.mask.shape[0]):
            weights, out = self._train_step(weights, _batch_at(wire, i),
                                            plane=planes[i] if planes else None)
            outs.append(out)
        return weights, _stack_outputs(outs)

    def step_many(self, stacked) -> StepOutput:
        """K micro-batch steps as ONE dispatch (the JAX package's
        ``step_many``): ``stacked`` is a host batch whose fields carry a
        leading [K] axis (``stack_batches``) or a packed group
        (``pack_ragged_group``). The weights chain through the K steps
        exactly as K ``step`` calls would: the final weights and every
        batch's outputs are bitwise theirs. Returns the StepOutput with a
        leading [K] axis, on the device, nothing waited for.

        On ``cuda`` the K steps of a (wire signature, K) are a CUDA graph:
        the first group of a signature runs eagerly and is then captured;
        each later one copies its bytes into the graph's own device buffers
        (one H2D copy for a packed group) and the incoming weights into its
        input, replays, and takes the new weights and outputs out of the
        graph's buffers (two device copies), so the next replay may
        overwrite them. The hand kernels' launches a replay makes are added
        to their wrappers' ``launches`` at each replay. On the Gram route
        the K batches' planes (``host_planes``) are part of the graph's key."""
        planes = self.planes(stacked)
        if self.device.type != "cuda":
            self._weights, out = self._train_many(
                self._weights, batch_to_device(stacked, self.device, self.non_blocking),
                planes)
            return out
        key = wire_signature(stacked) + (planes,)
        entry = self._graphs.get(key)
        if entry is None:
            self._weights, out = self._train_many(
                self._weights, batch_to_device(stacked, self.device, self.non_blocking),
                planes)
            self._capture(key, stacked, planes)
            return out
        entry.w_in.copy_(self._weights)
        for dst, src in zip(_wire_fields(entry.wire), _wire_fields(stacked)):
            dst.copy_(_host_tensor(src), non_blocking=self.non_blocking)
        entry.graph.replay()
        for counter, n in zip(_kernel_counters(), entry.launches):
            counter.launches += n
        self._weights = entry.w_out.clone()
        return StepOutput(*(None if t is None else t.clone() for t in entry.outs))

    def _capture(self, key, stacked, planes: tuple = ()) -> None:
        """Capture the K steps of ``stacked``'s signature into a CUDA graph
        on a side stream (the graph's intermediates in its own memory pool)
        and keep it; the oldest of ``_GRAPH_CACHE_SIZE`` graphs goes."""
        wire = batch_to_device(stacked, self.device, self.non_blocking)
        w_in = torch.empty_like(self._weights)
        graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        counters = _kernel_counters()
        captured = [c.captured for c in counters]
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                w_out, outs = self._train_many(w_in, wire, planes)
            finally:
                graph.capture_end()
        current.wait_stream(side)
        if len(self._graphs) >= _GRAPH_CACHE_SIZE:
            self._graphs.pop(next(iter(self._graphs)))
        self._graphs[key] = _GroupGraph(
            graph, wire, w_in, w_out, outs,
            tuple(c.captured - n for c, n in zip(counters, captured)),
            tuple(self._train_step.masks_by_rows.values()))
