"""The port's Gram route of the sparse regime (``twtml_tpu_torch/ops/gram.py``,
the plain twins of ``ops/fused_gram.py``, ``models/sgd.py``'s routes and
``host_planes``) against the JAX package's ``twtml_tpu/ops/gram.py`` and
sparse steps, on the same numpy inputs.

Tolerances (the JAX package's own Gram-vs-scatter ones, tests/test_gram_sgd.py):
G in the int8 and bf16 planes bitwise (every count and partial sum is an
integer below 2^24), the exact plane within rtol 1e-6; weights within rtol
2e-4 and atol 2e-4·max(1, max|w|); predictions within rtol 1e-5, atol 1e-4;
MSE within rtol 1e-4. The counts themselves are bitwise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from twtml_tpu.features.batch import FeatureBatch as JaxFeatureBatch
from twtml_tpu.features.featurizer import Featurizer as JaxFeaturizer
from twtml_tpu.models.logistic import StreamingLogisticRegressionWithSGD as JaxLogistic
from twtml_tpu.models.sgd import make_sgd_train_step as jax_make_step
from twtml_tpu.ops import gram as jgram
from twtml_tpu.ops.text_hash import hash_bigrams_device as jax_hash
from twtml_tpu.streaming.sources import SyntheticSource as JaxSynthetic

from twtml_tpu_torch.features.batch import (
    NUM_NUMBER_FEATURES,
    FeatureBatch,
    PackedBatch,
    RaggedUnitBatch,
    UnitBatch,
    pack_batch,
    pack_ragged_group,
    ragged_wire_arrays,
    stack_batches,
)
from twtml_tpu_torch.features.featurizer import Featurizer
from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
from twtml_tpu_torch.models.logistic import threshold_prediction
from twtml_tpu_torch.models import sgd as sgd_module
from twtml_tpu_torch.models.sgd import host_planes, make_sgd_train_step, run_dual_loop
from twtml_tpu_torch.ops import fused_gram, gram
from twtml_tpu_torch.ops.fused_sgd import logistic_residual
from twtml_tpu_torch.streaming.sources import SyntheticSource

F_TEXT = 512  # forced sparse, as tests/test_gram_sgd.py does
NOW_MS = 1785320000000


def random_batch(rng, b=24, l=12, f_text=F_TEXT, label_scale=50.0):
    """tests/test_gram_sgd.py's batch: integral values 1-3, padded token
    slots (idx 0, val 0), 3 padding rows."""
    token_idx = rng.integers(0, f_text, size=(b, l)).astype(np.int32)
    token_val = rng.integers(1, 4, size=(b, l)).astype(np.float32)
    token_val[:, l - 2:] = 0.0
    token_idx[:, l - 2:] = 0
    numeric = rng.normal(size=(b, NUM_NUMBER_FEATURES)).astype(np.float32) * 0.1
    label = rng.uniform(0, label_scale, size=(b,)).astype(np.float32)
    mask = np.ones((b,), np.float32)
    mask[b - 3:] = 0.0
    token_val[b - 3:] = 0.0
    numeric[b - 3:] = 0.0
    label[b - 3:] = 0.0
    return FeatureBatch(token_idx, token_val, numeric, label, mask)


def to_torch(batch):
    return type(batch)(*(torch.from_numpy(np.ascontiguousarray(a)) for a in batch))


def to_jax(batch):
    return JaxFeatureBatch(*batch)


def jax_branch(token_val, int8_plane=True) -> int:
    """The branch index of the JAX package's ``text_gram`` ``lax.switch``:
    its predicates (twtml_tpu/ops/gram.py), evaluated on the same values."""
    val_f = jnp.asarray(token_val, jnp.float32)
    integral = jnp.all(val_f == jnp.round(val_f))
    row_mass = jnp.sum(jnp.abs(val_f), axis=1)
    vals_ok = (integral & jnp.all(val_f.astype(jnp.bfloat16).astype(jnp.float32) == val_f)
               & jnp.all(row_mass <= 255.0))
    i8 = integral & jnp.all(row_mass <= 127.0)
    return int(vals_ok) + (int(i8) if int8_plane else 0)


# ---------------------------------------------------------------- counts


@pytest.mark.parametrize("f_text", [F_TEXT, 2**18, 1000])
@pytest.mark.parametrize("seed", [0, 1])
def test_onehot_counts_equal_the_jax_packages_bitwise(f_text, seed):
    rng = np.random.default_rng(seed)
    b = random_batch(rng, f_text=f_text)
    idx, val = b.token_idx, b.token_val
    idx[0, :4] = 7  # duplicates within a row
    got_bf16 = gram.onehot_counts(torch.from_numpy(idx), torch.from_numpy(val), f_text)
    want_bf16 = jgram.onehot_counts(jnp.asarray(idx), jnp.asarray(val), f_text)
    assert got_bf16.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_bf16.float().numpy(),
                                  np.asarray(want_bf16, np.float32))
    got_i8 = gram.onehot_counts_int8(torch.from_numpy(idx), torch.from_numpy(val), f_text)
    want_i8 = jgram.onehot_counts_int8(jnp.asarray(idx), jnp.asarray(val), f_text)
    assert got_i8.dtype == torch.int8
    np.testing.assert_array_equal(got_i8.numpy(), np.asarray(want_i8))
    got_f32 = gram.onehot_counts(torch.from_numpy(idx), torch.from_numpy(val), f_text,
                                 torch.float32)
    want_f32 = jgram.onehot_counts(jnp.asarray(idx), jnp.asarray(val), f_text, jnp.float32)
    np.testing.assert_array_equal(got_f32.numpy(), np.asarray(want_f32))


def test_split_feature_index_is_the_jax_packages():
    idx = np.arange(0, 2**18, 997, dtype=np.int32)[None, :]
    for f_text in (512, 1000, 2**18):
        got = gram._split_feature_index(torch.from_numpy(idx % f_text), f_text)
        want = jgram._split_feature_index(jnp.asarray(idx % f_text), f_text)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got[2:] == want[2:]


def test_count_build_twin_pads_and_types():
    rng = np.random.default_rng(3)
    b = random_batch(rng)
    idx, val = torch.from_numpy(b.token_idx), torch.from_numpy(b.token_val)
    rows, cols = fused_gram.padded_rows(24), fused_gram.padded_columns(F_TEXT + 3)
    assert (rows, cols) == (24, 528)
    c8 = fused_gram.count_build(idx, val, F_TEXT, int8=True, rows_out=32, cols_out=528)
    assert c8.dtype == torch.int8 and c8.shape == (32, 528)
    np.testing.assert_array_equal(c8[:24, :F_TEXT].numpy(),
                                  gram.onehot_counts_int8(idx, val, F_TEXT).numpy())
    assert not c8[24:].any() and not c8[:, F_TEXT:].any()
    c32 = fused_gram.count_build(idx, val * 0.37, F_TEXT, int8=False)
    np.testing.assert_array_equal(c32.numpy(), gram.densify_counts(idx, val * 0.37, F_TEXT))
    assert fused_gram.count_build.launches == 0  # the twin launches nothing


# ---------------------------------------------------------------- planes

# (token_idx, token_val, the plane's name): every boundary of the JAX
# package's gate (tests/test_gram_sgd.py:93-200, :318)
BOUNDARIES = [
    ("mass 127 mixed sign", [[3, 3, 9, 11]], [[60.0, -60.0, 7.0, 0.0]]),
    ("mass 128 mixed sign", [[3, 3, 9, 11]], [[64.0, -57.0, 7.0, 0.0]]),
    ("count 127", [[7, 0], [7, 0]], [[127.0, 0.0], [1.0, 0.0]]),
    ("count 128", [[7, 0], [7, 0]], [[128.0, 0.0], [1.0, 0.0]]),
    ("mass 255", [[7, 9], [7, 0]], [[200.0, 55.0], [1.0, 0.0]]),
    ("mass 256", [[7, 9], [7, 0]], [[200.0, 56.0], [1.0, 0.0]]),
    ("integral, not bf16-exact", [[7, 0]], [[257.0, 0.0]]),
    ("fractional", [[7, 9]], [[0.5, 1.0]]),
    ("mixed sign count above 255", [[7, 7, 9, 0]], [[150.0, 151.0, -200.0, 0.0]]),
    ("all padding", [[0, 0]], [[0.0, 0.0]]),
    ("ones, 127 a row", [list(range(127))], [[1.0] * 127]),
    ("ones, 128 a row", [list(range(128))], [[1.0] * 128]),
    ("NaN", [[7, 0]], [[float("nan"), 0.0]]),
    ("Inf", [[7, 0]], [[float("inf"), 0.0]]),
]


@pytest.mark.parametrize("int8_plane", [True, False])
@pytest.mark.parametrize("name,idx,val", BOUNDARIES, ids=[b[0] for b in BOUNDARIES])
def test_plane_choice_equals_the_jax_predicates(name, idx, val, int8_plane):
    idx = np.asarray(idx, np.int32)
    val = np.asarray(val, np.float32)
    want = jax_branch(val, int8_plane)
    assert gram.data_plane(torch.from_numpy(val), int8_plane) == want
    batch = FeatureBatch(idx, val, np.zeros((len(idx), 4), np.float32),
                         np.zeros(len(idx), np.float32), np.ones(len(idx), np.float32))
    assert host_planes(batch, int8_plane) == (want,)
    if not np.all(np.isfinite(val)):
        return
    got = gram.text_gram(torch.from_numpy(idx), torch.from_numpy(val), F_TEXT,
                         int8_plane=int8_plane).numpy()
    ref = np.asarray(jgram.text_gram(jnp.asarray(idx), jnp.asarray(val), F_TEXT,
                                     int8_plane=int8_plane))
    if want > 0:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6)


def units_batch(lengths, row_len, seed=0):
    """A padded UnitBatch of ASCII rows of the given lengths."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    units = np.zeros((b, row_len), np.uint8)
    for i, n in enumerate(lengths):
        units[i, :n] = rng.integers(97, 123, size=n)
    length = np.asarray(lengths, np.int32)
    numeric = np.zeros((b, 4), np.float32)
    return UnitBatch(units, length, numeric, np.zeros(b, np.float32),
                     (length > 0).astype(np.float32))


@pytest.mark.parametrize("lengths", [
    [0, 1, 2], [128, 3, 0], [129, 1], [256, 40], [257, 1], [300, 300], [1, 1, 1],
])
def test_host_planes_of_the_units_wires_equal_the_jax_predicates(lengths):
    """The row mass the host reads from the unit counts (padded, ragged,
    packed, grouped) is the mass of the device-hashed tokens."""
    row_len = 304
    ub = units_batch(lengths, row_len)
    _, val = jax_hash(jnp.asarray(ub.units), jnp.asarray(ub.length), 2**18)
    want = jax_branch(np.asarray(val))
    assert host_planes(ub) == (want,)
    offsets = np.concatenate([[0], np.cumsum(ub.length)]).astype(np.int32)
    flat = np.concatenate([ub.units[i, :n] for i, n in enumerate(lengths)])
    units, offs = ragged_wire_arrays(flat, offsets, len(lengths), len(lengths), True)
    rb = RaggedUnitBatch(units, offs, ub.numeric, ub.label, ub.mask, row_len=row_len)
    assert host_planes(rb) == (want,)
    assert host_planes(pack_batch(rb)) == (want,)
    assert host_planes(stack_batches([rb, rb])) == (want, want)
    group = pack_ragged_group([rb, rb, rb])
    assert isinstance(group, PackedBatch) and host_planes(group) == (want,) * 3


def test_plane_of_a_stacked_feature_batch_is_per_batch():
    rng = np.random.default_rng(4)
    a, b = random_batch(rng), random_batch(rng)
    b.token_val[0, 0] = 0.5
    assert host_planes(stack_batches([a, b])) == (2, 0)


def test_model_planes_follow_its_route_and_int8_switch():
    rng = np.random.default_rng(5)
    b = random_batch(rng)
    kw = dict(device="cpu", num_text_features=F_TEXT, use_sparse=True)
    assert StreamingLinearRegressionWithSGD(**kw).planes(b) == (2,)
    assert StreamingLinearRegressionWithSGD(gram_int8=False, **kw).planes(b) == (1,)
    assert StreamingLinearRegressionWithSGD(use_gram=False, **kw).planes(b) == ()
    assert StreamingLinearRegressionWithSGD(device="cpu").planes(b) == ()


# ------------------------------------------------- numeric block, norms, write-back


def test_add_numeric_block_and_gram_matrix_equal_the_jax_packages():
    rng = np.random.default_rng(6)
    b = random_batch(rng)
    idx, val, num = b.token_idx, b.token_val, b.numeric
    g_text = rng.normal(size=(24, 24)).astype(np.float32)
    got = gram.add_numeric_block(torch.from_numpy(g_text), torch.from_numpy(num))
    want = jgram.add_numeric_block(jnp.asarray(g_text), jnp.asarray(num))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    got = gram.gram_matrix(torch.from_numpy(idx), torch.from_numpy(val),
                           torch.from_numpy(num), F_TEXT)
    want = jgram.gram_matrix(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(num), F_TEXT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", range(3))
def test_dual_norm_sq_and_writeback_equal_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    b = random_batch(rng)
    w = rng.normal(size=(F_TEXT + 4,)).astype(np.float32)
    u = rng.normal(size=(24,)).astype(np.float32)
    z = rng.normal(size=(24, 8)).astype(np.float32)
    g = z @ z.T
    a = {"c": np.float32(0.9), "alpha": rng.normal(size=24).astype(np.float32)}
    c = {"c": np.float32(0.7), "alpha": rng.normal(size=24).astype(np.float32)}
    p = np.float32(np.sum(w * w))
    got = gram.dual_norm_sq(torch.tensor(p), torch.from_numpy(u), torch.from_numpy(g))(
        {k: torch.as_tensor(v) for k, v in a.items()},
        {k: torch.as_tensor(v) for k, v in c.items()})
    want = jgram.dual_norm_sq(p, jnp.asarray(u), jnp.asarray(g))(
        {k: jnp.asarray(v) for k, v in a.items()}, {k: jnp.asarray(v) for k, v in c.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    alpha = a["alpha"]
    got = gram.dual_writeback(torch.from_numpy(w[:F_TEXT]), torch.from_numpy(w[F_TEXT:]),
                              torch.tensor(a["c"]), torch.from_numpy(alpha),
                              torch.from_numpy(b.token_idx), torch.from_numpy(b.token_val),
                              torch.from_numpy(b.numeric))
    want = jgram.dual_writeback(jnp.asarray(w[:F_TEXT]), jnp.asarray(w[F_TEXT:]), a["c"],
                                jnp.asarray(alpha), jnp.asarray(b.token_idx),
                                jnp.asarray(b.token_val), jnp.asarray(b.numeric))
    for gp, wp in zip(got, want):
        np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-6, atol=1e-6)
    # B8's plain version (the scatter over the batch's tokens) holds the JAX scatter
    wb = fused_gram.dual_writeback_counts(torch.from_numpy(w), torch.tensor(a["c"]),
                                          torch.from_numpy(alpha),
                                          torch.from_numpy(b.token_idx),
                                          torch.from_numpy(b.token_val),
                                          torch.from_numpy(b.numeric), F_TEXT)
    np.testing.assert_allclose(wb.numpy(), np.concatenate([np.asarray(x) for x in want]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b", [1, 24, 2048, 4096, 16384, 1 << 20])
@pytest.mark.parametrize("f", [F_TEXT, 8193, 2**18])
@pytest.mark.parametrize("n", [0, 3, 4, 50])
def test_fits_gram_is_the_jax_gate(b, f, n):
    assert gram.fits_gram(b, f, n) == jgram.fits_gram(b, f, n)
    assert (gram.GRAM_DENSE_BYTES_LIMIT, gram.GRAM_MIN_ITERATIONS) == (
        jgram.GRAM_DENSE_BYTES_LIMIT, jgram.GRAM_MIN_ITERATIONS)


def test_int8_switch_default_is_the_jax_packages():
    assert gram.GRAM_INT8_PLANE == jgram.GRAM_INT8_PLANE


# ---------------------------------------------------------------- B7's plan and twin


@pytest.mark.parametrize("rows", [1, 16, 2048, 3072, 4096])
def test_dual_plan_covers_every_row(rows):
    """B7's plan: its tenant table's plan at one tenant of B rows."""
    plan = fused_gram.dual_tenants_plan((rows,), sm_count=132, shared_limit=232_448)
    bp = -(-rows // 4) * 4
    assert plan.grid <= 132 and plan.bp_max == max(4, bp) and plan.first_cta == (0, plan.grid)
    assert sum(len(plan.cta_rows(0, c)) for c in range(plan.grid)) == rows
    assert max(len(plan.cta_rows(0, c)) for c in range(plan.grid)) <= plan.rows_cap[0]
    assert plan.shared_bytes <= 232_448
    assert plan.resident_rows + plan.spill_rows == rows
    # B = 2048 keeps G on chip; 3072 and 4096 spill to L2
    assert (plan.spill_rows > 0) == (rows >= 3072)
    # up to 2048 rows G lives in registers: at most DUAL_ROWS rows a CTA, a
    # thread's float4 columns of each; none of it in shared memory
    assert plan.in_registers == (rows <= 2048)
    if plan.in_registers:
        assert plan.rows_cap[0] <= fused_gram.DUAL_ROWS and plan.resident == plan.rows_cap
        assert 4 * fused_gram.DUAL_THREADS * fused_gram.DUAL_REG_COLUMNS >= bp
        assert plan.shared_bytes == plan.smem_layout[-1]
    offsets = (0, *plan.smem_layout)
    assert all(o % 16 == 0 for o in offsets) and list(offsets) == sorted(offsets)
    assert plan.scratch_floats == 2 * plan.abuf_floats + 16 * plan.grid
    assert plan.abuf_floats == max(4, bp)


def test_dual_plan_refuses_what_does_not_fit():
    fused_gram.dual_tenants_plan((4096,), sm_count=132, shared_limit=232_448)
    with pytest.raises(ValueError, match="shared memory"):
        fused_gram.dual_tenants_plan((40_000,), sm_count=132, shared_limit=232_448)


def gram_inputs(rng, b, f=64):
    z = rng.integers(0, 3, size=(b, f)).astype(np.float32)
    num = rng.normal(size=(b, 4)).astype(np.float32) * 0.1
    g = z @ z.T + num @ num.T
    u = rng.normal(size=b).astype(np.float32)
    y = rng.uniform(0, 5, size=b).astype(np.float32)
    mask = np.ones(b, np.float32)
    mask[-2:] = 0.0
    return [torch.from_numpy(a) for a in (g, u, y, mask)]


@pytest.mark.parametrize("tol", [0.0, 0.001, 0.05])
@pytest.mark.parametrize("logistic", [False, True])
def test_dual_twin_ignores_invalid_rows_and_counts_iterations(tol, logistic):
    """B7's twin on finite inputs is ``run_dual_loop``; NaN/Inf in invalid
    rows (u, y, their rows and columns of G) change nothing; it reports the
    iteration that converged."""
    rng = np.random.default_rng(7)
    g, u, y, mask = gram_inputs(rng, 24)
    if logistic:
        y = (y > 2.5).float()
    residual = logistic_residual if logistic else sgd_module.least_squares_residual
    kw = dict(num_iterations=30, step_size=0.05, l2_reg=0.01, convergence_tol=tol)
    p = torch.tensor(2.0)
    c, alpha, its = fused_gram.dual_sgd(g, u, y, mask, p_prev=p, residual_fn=residual, **kw)
    dual = run_dual_loop(u=u, g=g, labels=y, mask=mask, dtype=torch.float32,
                         residual_fn=residual, p_prev=p, **kw)
    np.testing.assert_array_equal(alpha.numpy(), dual["alpha"].numpy())
    assert float(c) == float(dual["c"])
    assert 1 <= int(its) <= 30 and (tol > 0 or int(its) == 30)
    g2, u2, y2 = g.clone(), u.clone(), y.clone()
    g2[-1, :] = float("nan")
    g2[:, -2] = float("inf")
    u2[-1], y2[-2] = float("nan"), float("inf")
    c2, alpha2, its2 = fused_gram.dual_sgd(g2, u2, y2, mask, p_prev=p,
                                           residual_fn=residual, **kw)
    np.testing.assert_array_equal(alpha2.numpy(), alpha.numpy())
    assert float(c2) == float(c) and int(its2) == int(its)


def test_dual_twin_with_sampling_masks_and_zero_count():
    rng = np.random.default_rng(8)
    g, u, y, mask = gram_inputs(rng, 16)
    masks = sgd_module.sampling_masks(16, 10, 0.5, torch.float32, "cpu")
    kw = dict(num_iterations=10, step_size=0.05, convergence_tol=0.0, p_prev=torch.tensor(1.0))
    c, alpha, its = fused_gram.dual_sgd(g, u, y, mask, masks=masks, **kw)
    dual = run_dual_loop(u=u, g=g, labels=y, mask=mask, dtype=torch.float32,
                         residual_fn=sgd_module.least_squares_residual, masks=masks,
                         l2_reg=0.0, **{k: v for k, v in kw.items()})
    np.testing.assert_array_equal(alpha.numpy(), dual["alpha"].numpy())
    fused_gram.dual_sgd.last_barriers = torch.tensor(3.0)  # as a card launch leaves it
    c0, alpha0, its0 = fused_gram.dual_sgd(g, u, y, torch.zeros(16), **kw)
    assert float(c0) == 1.0 and not alpha0.any() and int(its0) == 10
    assert fused_gram.dual_sgd.launches == 0
    assert fused_gram.dual_sgd.last_barriers is None  # a CPU call launches no barrier


# ---------------------------------------------------------------- trajectories


def port_chain(batches, w0, **kw):
    step = make_sgd_train_step(**kw)
    w = torch.from_numpy(np.array(w0, np.float32))
    outs = []
    for b in batches:
        w, out = step(w, to_torch(b))
        outs.append(out)
    return w.numpy(), outs


def jax_chain(batches, w0, **kw):
    step = jax_make_step(**kw)
    w = jnp.asarray(w0)
    outs = []
    for b in batches:
        w, out = step(w, to_jax(b))
        outs.append(out)
    return np.asarray(w), outs


def assert_matches(port, ref, rtol=2e-4, atol=2e-4):
    (w_p, out_p), (w_j, out_j) = port, ref
    scale = max(1.0, float(np.max(np.abs(w_j))))
    np.testing.assert_allclose(w_p, w_j, rtol=rtol, atol=atol * scale)
    for a, b in zip(out_p, out_j):
        np.testing.assert_allclose(a.predictions.numpy(), np.asarray(b.predictions),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(float(a.mse), float(b.mse), rtol=1e-4)
        assert float(a.count) == float(b.count)


def both(batches, w0, use_gram, jax_kw=None, **kw):
    kw = dict(dict(num_text_features=F_TEXT, use_sparse=True, num_iterations=25,
                   step_size=0.05), **kw)
    port = port_chain(batches, w0, use_gram=use_gram, **kw)
    jkw = {k: v for k, v in kw.items() if k not in ("residual_fn", "prediction_fn")}
    jkw.update(jax_kw or {})
    ref = jax_chain(batches, w0, use_gram=use_gram, **jkw)
    return port, ref


@pytest.mark.parametrize("use_gram", [True, False])
def test_multi_batch_trajectory_matches_the_jax_step(use_gram):
    rng = np.random.default_rng(3)
    batches = [random_batch(rng) for _ in range(4)]
    assert_matches(*both(batches, np.zeros(F_TEXT + 4, np.float32), use_gram))


@pytest.mark.parametrize("use_gram", [True, False])
def test_l2_scales_untouched_weights_as_the_jax_step(use_gram):
    rng = np.random.default_rng(4)
    batches = []
    for _ in range(3):
        b = random_batch(rng)
        batches.append(b._replace(token_idx=(b.token_idx % 64).astype(np.int32)))
    w0 = rng.normal(size=(F_TEXT + 4,)).astype(np.float32)
    port, ref = both(batches, w0, use_gram, l2_reg=0.05, convergence_tol=0.0)
    assert_matches(port, ref)
    ratio = port[0][64:F_TEXT] / w0[64:F_TEXT]
    np.testing.assert_allclose(ratio, ratio[0], rtol=1e-5)


@pytest.mark.parametrize("use_gram", [True, False])
def test_mini_batch_sampling_matches_the_jax_step(use_gram):
    rng = np.random.default_rng(5)
    batches = [random_batch(rng) for _ in range(3)]
    assert_matches(*both(batches, np.zeros(F_TEXT + 4, np.float32), use_gram,
                         mini_batch_fraction=0.5))


@pytest.mark.parametrize("use_gram", [True, False])
def test_convergence_freeze_matches_the_jax_step(use_gram):
    rng = np.random.default_rng(6)
    batches = [random_batch(rng, label_scale=1.0)]
    assert_matches(*both(batches, np.zeros(F_TEXT + 4, np.float32), use_gram,
                         convergence_tol=0.05, num_iterations=50))


@pytest.mark.parametrize("use_gram", [True, False])
def test_zero_valid_batch_is_identity(use_gram):
    rng = np.random.default_rng(7)
    b = random_batch(rng)
    empty = b._replace(mask=np.zeros_like(b.mask))
    w0 = rng.normal(size=(F_TEXT + 4,)).astype(np.float32)
    w1, _ = port_chain([empty], w0, num_text_features=F_TEXT, use_sparse=True,
                       use_gram=use_gram, num_iterations=10, step_size=0.05, l2_reg=0.1)
    np.testing.assert_allclose(w1, w0, rtol=1e-6, atol=0)


@pytest.mark.parametrize("use_gram", [True, False])
def test_logistic_residual_matches_the_jax_step(use_gram):
    rng = np.random.default_rng(8)
    batches = []
    for _ in range(3):
        b = random_batch(rng)
        batches.append(b._replace(label=(b.label > 25).astype(np.float32) * b.mask))
    cls = JaxLogistic
    port, ref = both(
        batches, np.zeros(F_TEXT + 4, np.float32), use_gram,
        jax_kw=dict(residual_fn=cls.residual_fn, prediction_fn=cls.prediction_fn),
        residual_fn=logistic_residual, prediction_fn=threshold_prediction,
        round_predictions=False, step_size=0.5,
    )
    assert_matches(port, ref)


@pytest.mark.parametrize("trial", range(6))
def test_randomized_config_sweep_matches_the_jax_step(trial):
    """tests/test_gram_sgd.py's seeded sweep, each trial on both routes."""
    rng = np.random.default_rng(2026 + trial)
    knobs = dict(
        num_iterations=int(rng.integers(4, 30)),
        step_size=float(rng.choice([0.005, 0.05, 0.2])),
        l2_reg=float(rng.choice([0.0, 0.01, 0.1])),
        mini_batch_fraction=float(rng.choice([1.0, 0.7, 0.4])),
        convergence_tol=float(rng.choice([0.0, 0.001, 0.05])),
    )
    b = int(rng.integers(8, 40))
    l = int(rng.integers(4, 20))
    batches = [random_batch(rng, b=b, l=l, label_scale=float(rng.choice([5.0, 500.0])))
               for _ in range(2)]
    w0 = (rng.normal(size=(F_TEXT + 4,)) * 0.1).astype(np.float32)
    for use_gram in (True, False):
        try:
            assert_matches(*both(batches, w0, use_gram, **knobs))
        except AssertionError as exc:
            raise AssertionError(f"use_gram={use_gram} knobs={knobs} b={b} l={l}: {exc}")


def test_bfloat16_weights_on_the_dual_loop_track_the_jax_step():
    """``use_gram=True`` with bf16 weights runs the dual loop as torch ops
    (tests/test_gram_sgd.py:337): the same ballpark as the JAX package's."""
    rng = np.random.default_rng(11)
    batches = [random_batch(rng) for _ in range(2)]
    kw = dict(num_text_features=F_TEXT, use_sparse=True, num_iterations=25,
              step_size=0.05, use_gram=True)
    step = make_sgd_train_step(dtype=torch.bfloat16, **kw)
    w = torch.zeros(F_TEXT + 4, dtype=torch.bfloat16)
    for b in batches:
        w, _ = step(w, to_torch(b))
    assert w.dtype == torch.bfloat16
    w_j, _ = jax_chain(batches, jnp.zeros(F_TEXT + 4, jnp.bfloat16), **kw)
    np.testing.assert_allclose(w.float().numpy(), np.asarray(w_j, np.float32),
                               rtol=0.1, atol=0.1)


def test_routes_by_configuration():
    route = sgd_module.dense_route
    assert route(1.0, torch.float32, sparse=True) == "gram"
    assert route(0.5, torch.float32, sparse=True) == "gram"
    assert route(1.0, torch.bfloat16, sparse=True) == "scatter"
    assert route(1.0, torch.float64, sparse=True) == "scatter"
    assert route(1.0, torch.float32, sparse=True, use_gram=False) == "scatter"
    assert route(1.0, torch.bfloat16, sparse=True, use_gram=True) == "gram"
    model = StreamingLinearRegressionWithSGD(device="cpu", num_text_features=2**18)
    assert model.route == "gram"


def test_gate_miss_runs_the_scatter_loop(monkeypatch):
    """A batch that misses ``fits_gram`` runs the scatter loop, as the JAX
    package's gate routes it; ``use_gram=True`` skips the gate."""
    calls = []
    real = sgd_module.sparse_sgd_loop
    monkeypatch.setattr(sgd_module, "sparse_sgd_loop",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(12)
    b = to_torch(random_batch(rng))
    w = torch.zeros(F_TEXT + 4)
    step = make_sgd_train_step(num_text_features=F_TEXT, use_sparse=True,
                               num_iterations=3, step_size=0.05)
    step(w, b)
    assert calls == [1]  # 3 iterations < GRAM_MIN_ITERATIONS
    step = make_sgd_train_step(num_text_features=F_TEXT, use_sparse=True, use_gram=True,
                               num_iterations=3, step_size=0.05)
    step(w, b)
    assert calls == [1]


def test_host_plane_equals_the_data_plane_in_the_step():
    """The plane the model takes from host metadata gives the same step as
    the one read from the tokens."""
    rng = np.random.default_rng(13)
    b = random_batch(rng)
    step = make_sgd_train_step(num_text_features=F_TEXT, use_sparse=True,
                               num_iterations=10, step_size=0.05)
    w = torch.zeros(F_TEXT + 4)
    (plane,) = host_planes(b)
    w1, o1 = step(w, to_torch(b), plane=plane)
    w2, o2 = step(w, to_torch(b))
    assert torch.equal(w1, w2) and torch.equal(o1.predictions, o2.predictions)


def test_step_many_on_the_gram_route_equals_k_steps():
    ours = list(SyntheticSource(total=3 * 16, seed=3, base_ms=NOW_MS).produce())
    f = Featurizer(num_text_features=2**18, now_ms=NOW_MS)
    bs = [f.featurize_batch_units(ours[i:i + 16], row_bucket=16) for i in range(0, 48, 16)]
    bs = [b._replace(units=np.pad(b.units, ((0, 0), (0, 96 - b.units.shape[1]))))
          for b in bs]
    kw = dict(device="cpu", num_text_features=2**18, l2_reg=0.1)
    one, many = StreamingLinearRegressionWithSGD(**kw), StreamingLinearRegressionWithSGD(**kw)
    outs = [one.step(b) for b in bs]
    group = many.step_many(stack_batches(bs))
    np.testing.assert_array_equal(many.latest_weights, one.latest_weights)
    for k, o in enumerate(outs):
        assert torch.equal(group.predictions[k], o.predictions)


# ------------------------------------------------------------ 2^18 through the wire


def test_full_width_2e18_unit_wire_matches_the_jax_gram_and_scatter_steps():
    """48 synthetic tweets at F = 2^18 through the units wire, both routes,
    against the JAX package's (tests/test_gram_sgd.py:416-437)."""
    ours = list(SyntheticSource(total=48, seed=3, base_ms=NOW_MS).produce())
    ref = list(JaxSynthetic(total=48, seed=3, base_ms=NOW_MS).produce())
    batch = Featurizer(num_text_features=2**18, now_ms=NOW_MS).featurize_batch_units(
        ours, row_bucket=48)
    jbatch = JaxFeaturizer(num_text_features=2**18, now_ms=NOW_MS).featurize_batch_units(
        ref, row_bucket=48)
    kw = dict(num_text_features=2**18, num_iterations=5, step_size=0.005, l2_reg=0.1)
    w0 = np.zeros(2**18 + 4, np.float32)
    for use_gram in (True, False):
        step = make_sgd_train_step(use_gram=use_gram, **kw)
        w, out = step(torch.from_numpy(w0.copy()), to_torch(batch),
                      plane=host_planes(batch)[0] if use_gram else None)
        w_j, out_j = jax.jit(jax_make_step(use_gram=use_gram, **kw))(jnp.asarray(w0), jbatch)
        assert_matches((w.numpy(), [out]), (np.asarray(w_j), [out_j]))
        assert float(out.mse) == pytest.approx(float(out_j.mse), rel=1e-6)
