"""The Gram-domain (dual) SGD loop's plain pieces (counterpart of
``twtml_tpu/ops/gram.py``), and the route of the sparse regime on the CPU.

Within one micro-batch the design matrix Z = [X_text | numeric] is fixed
across all iterations, and the loop only needs Z·W and Zᵀ·r. In the span
the updates live in, W_i = c_i·W_prev + Zᵀ·α_i (c_0 = 1, α_0 = 0); with
u = Z·W_prev ([B]) and G = Z·Zᵀ ([B, B]):

    Z·W_i      = c_i·u + G·α_i
    update     : c <- c·(1 − ηλ);  α <- α·(1 − ηλ) − η·(sel·r)/denom
    ||W_a − W_b||² = Δc²·||W_prev||² + 2·Δc·(u·Δα) + Δαᵀ·G·Δα

so MLlib's update rule runs on the small state {c, α} (``run_dual_loop`` in
models/sgd.py) and the 2^18 feature space is touched twice a batch: once to
build G, once to write W_new = c·W_prev + Zᵀα back (``dual_writeback``).

G's text block comes from integer counts C [B, F] and C·Cᵀ in one of three
planes, chosen by the batch's data as the JAX package chooses it
(``gram_plane``; the branch index of its ``lax.switch``):
  2, int8:  integral values, every row's absolute mass <= 127: every count
            and every partial sum of G is an integer, exact in int8 / s32;
  1, bf16:  integral bf16-exact values, row mass <= 255: exact in bf16 / f32;
  0, exact: anything else, f32 counts and a full-f32 product.
In the int8 and bf16 planes every count and every partial sum of G is an
integer below 2^24, so a product over the batch's occurring columns only,
in float64, gives G exactly: that is this module's ``text_gram``, which
never forms the dense [B, F] counts (2.2·10^12 integer operations at
B = 2048 and F = 2^18). The exact plane's f32 counts go through the same
float64 product, within rtol 1e-6 of the JAX package's full-f32 one. On
the card the route is the hand kernels of ops/fused_gram.py instead.
"""

from __future__ import annotations

import os

import torch

# The int8 plane is on by default; TWTML_GRAM_INT8=0 turns it off process
# wide (the JAX package's switch, for a bf16-only A/B run). Read once.
GRAM_INT8_PLANE = os.environ.get("TWTML_GRAM_INT8", "1").lower() not in ("0", "false")

# Above this dense-counts footprint (B·F·4 bytes) the learner runs the
# per-iteration gather/scatter loop instead of the Gram route. The JAX
# package's gate, kept as it is so that both packages route every batch
# the same way.
GRAM_DENSE_BYTES_LIMIT = 4 << 30

# Below this iteration count the Gram build costs about as much as the
# scatter loop (the JAX package's gate).
GRAM_MIN_ITERATIONS = 4

# the planes, as the JAX package's branch indices
PLANE_EXACT, PLANE_BF16, PLANE_INT8 = 0, 1, 2
PLANE_NAMES = {PLANE_EXACT: "exact", PLANE_BF16: "bf16", PLANE_INT8: "int8"}


def fits_gram(batch_rows: int, f_text: int, num_iterations: int) -> bool:
    """The static gate: the Gram route when the dense f32 counts fit the
    budget and there are enough iterations to amortize the build."""
    return (
        num_iterations >= GRAM_MIN_ITERATIONS
        and batch_rows * f_text * 4 <= GRAM_DENSE_BYTES_LIMIT
    )


def gram_plane(max_row_mass: float, integral: bool = True, bf16_exact: bool = True,
               int8_plane: "bool | None" = None) -> int:
    """The plane the JAX package's predicates pick, from a batch's largest
    row absolute mass and whether every token value is integral and
    bf16-exact. A NaN mass compares false, as on the device."""
    if int8_plane is None:
        int8_plane = GRAM_INT8_PLANE
    vals_ok = integral and bf16_exact and max_row_mass <= 255.0
    plane = int(vals_ok)
    if int8_plane:
        plane += int(integral and max_row_mass <= 127.0)
    return plane


def data_plane(token_val, int8_plane: "bool | None" = None) -> int:
    """``gram_plane`` from the token values themselves ([B, L]; reads them
    back to the host, so it syncs on a card: the card's route takes the
    plane from host metadata instead, models/sgd.py ``host_planes``)."""
    v = token_val.float()
    if v.numel() == 0:
        return gram_plane(0.0, int8_plane=int8_plane)
    integral = bool(torch.all(v == torch.round(v)))
    bf16_exact = bool(torch.all(v.to(torch.bfloat16).float() == v))
    mass = float(torch.max(torch.sum(torch.abs(v), dim=1)))
    return gram_plane(mass, integral, bf16_exact, int8_plane)


def _split_feature_index(token_idx, f_text: int):
    """The JAX package's two-level split f = hi·k_lo + lo of its one-hot
    count build: (hi, lo, k_hi, k_lo)."""
    lo_bits = (max(f_text - 1, 1).bit_length() + 1) // 2
    k_lo = 1 << lo_bits
    k_hi = -(-f_text // k_lo)
    return token_idx // k_lo, token_idx % k_lo, k_hi, k_lo


def _dense_counts(token_idx, values, f_text: int):
    """[B, L] (idx, val) -> [B, F] sums of ``values``' type, in token order."""
    b = token_idx.shape[0]
    out = torch.zeros((b, f_text), dtype=values.dtype, device=values.device)
    rows = torch.arange(b, device=token_idx.device)[:, None].expand_as(token_idx)
    return out.index_put_((rows.reshape(-1), token_idx.reshape(-1).long()),
                          values.reshape(-1), accumulate=True)


def onehot_counts(token_idx, token_val, f_text: int, dtype=torch.bfloat16):
    """[B, L] (idx, val) pairs -> dense [B, F] ``dtype`` counts, the counts of
    the JAX package's ``onehot_counts``: each value rounded to bf16, the
    sums in f32, then cast to ``dtype`` (a scatter here, not the TPU's
    one-hot matmul)."""
    vals = token_val.to(torch.bfloat16).float()
    return _dense_counts(token_idx, vals, f_text).to(dtype)


def onehot_counts_int8(token_idx, token_val, f_text: int):
    """The int8 twin of ``onehot_counts``: each value cast to int8, the sums
    in int32, narrowed to int8 (exact while the int8 plane's gate holds)."""
    vals = token_val.to(torch.int8).to(torch.int32)
    return _dense_counts(token_idx, vals, f_text).to(torch.int8)


def densify_counts(token_idx, token_val, f_text: int):
    """The exact plane's counts: [B, F] f32 sums of the f32 values, in token
    order (the JAX package's ``densify_text``)."""
    return _dense_counts(token_idx, token_val.float(), f_text)


def compact_counts(token_idx, token_val, plane: int):
    """The plane's counts over the batch's occurring columns only, as
    float64 [B, U]: column j holds the j-th smallest occurring feature's
    counts, the same sums in the same token order as the dense counts."""
    cols, inverse = torch.unique(token_idx.reshape(-1).long(), return_inverse=True)
    b = token_idx.shape[0]
    if plane == PLANE_INT8:
        vals = token_val.to(torch.int8).to(torch.int32)
    elif plane == PLANE_BF16:
        vals = token_val.to(torch.bfloat16).float()
    else:
        vals = token_val.float()
    counts = _dense_counts(inverse.view(b, -1), vals, cols.numel())
    if plane == PLANE_INT8:
        counts = counts.to(torch.int8)
    return counts.double()


def text_gram(token_idx, token_val, f_text: int, row_start: int = 0, rows: int = 0,
              int8_plane: "bool | None" = None, plane: "int | None" = None):
    """Text-feature Gram block X·Xᵀ ([B, B] f32), or the row panel
    ``X[row_start:row_start + rows]·Xᵀ`` ([rows, B]) when ``rows`` > 0, in
    the plane the data picks (``plane`` overrides: the caller's host
    metadata). A float64 product over the occurring columns: bitwise the
    JAX package's G in the int8 and bf16 planes, within rtol 1e-6 of it in
    the exact plane."""
    if plane is None:
        plane = data_plane(token_val, int8_plane)
    c = compact_counts(token_idx, token_val, plane)
    left = c[row_start:row_start + rows] if rows else c
    return (left @ c.T).float()


def add_numeric_block(g_text, numeric, dtype=torch.float32):
    """G = g_text + N·Nᵀ, cast to the dual loop's type: the one place the
    numeric features enter G."""
    num = numeric.float()
    return (g_text + num @ num.T).to(dtype)


def gram_matrix(token_idx, token_val, numeric, f_text: int, dtype=torch.float32,
                int8_plane: "bool | None" = None, plane: "int | None" = None):
    """G = Z·Zᵀ ([B, B] ``dtype``) for Z = [text counts | numeric features]."""
    return add_numeric_block(
        text_gram(token_idx, token_val, f_text, int8_plane=int8_plane, plane=plane),
        numeric, dtype,
    )


def dual_norm_sq(p_prev, u, g):
    """||W_a − W_b||² in the dual basis, the ``norm_sq`` hook of
    ``sgd_inner_loop``, given p_prev = ||W_prev||², u = Z·W_prev and G."""

    def norm_sq(a, b):
        dc = a["c"] - b["c"]
        da = a["alpha"] - b["alpha"]
        return dc * dc * p_prev + 2.0 * dc * torch.dot(u, da) + torch.dot(da, g @ da)

    return norm_sq


def dual_writeback(w_text, w_num, c, alpha, token_idx, token_val, numeric):
    """W_new = c·W_prev + Zᵀ·α: the one feature-space scatter of the batch.
    Duplicate (row, feature) occurrences add one by one, as the
    per-iteration scatter adds them."""
    contrib = (token_val * alpha[:, None]).reshape(-1)
    w_text_new = (w_text * c).index_add_(0, token_idx.reshape(-1), contrib)
    w_num_new = w_num * c + numeric.T @ alpha
    return w_text_new, w_num_new
