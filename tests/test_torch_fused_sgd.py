"""The fused dense-SGD twin (the CPU path of ``ops/fused_sgd.py``) against the
JAX package's Pallas kernel, run in interpret mode on the CPU as
tests/test_pallas_sgd.py runs it, plus the hand-computed MLlib literals of
tests/test_sgd_literals.py through the port's dense step.

Tolerance 2e-3: the Pallas kernel's own documented envelope for bf16 storage
of X (it also rounds w and r to bf16 per product; the port keeps them f32).
The CUDA kernel itself is held against this twin on the card by
chip_smoke.py."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from twtml_tpu.models.sgd import zero_weights as jax_zero_weights
from twtml_tpu.ops import pallas_sgd

from twtml_tpu_torch.features.batch import NUM_NUMBER_FEATURES, FeatureBatch
from twtml_tpu_torch.models.sgd import make_sgd_train_step
from twtml_tpu_torch.ops import fused_sgd
from twtml_tpu_torch.ops.sparse import densify_text

RNG = np.random.default_rng(11)
F_TEXT = 60  # + 4 numeric = 64


def make_batch(n=14, pad_to=16, tokens=6):
    token_idx = RNG.integers(0, F_TEXT, size=(pad_to, tokens)).astype(np.int32)
    token_val = RNG.integers(1, 3, size=(pad_to, tokens)).astype(np.float32)
    numeric = (RNG.normal(size=(pad_to, 4)) * 0.1).astype(np.float32)
    label = RNG.uniform(50, 900, size=(pad_to,)).astype(np.float32)
    mask = np.zeros((pad_to,), dtype=np.float32)
    mask[:n] = 1.0
    token_idx[n:] = 0
    token_val[n:] = 0
    numeric[n:] = 0
    label[n:] = 0
    return FeatureBatch(token_idx, token_val, numeric, label, mask)


def dense_design(batch) -> np.ndarray:
    x_text = densify_text(
        torch.from_numpy(batch.token_idx), torch.from_numpy(batch.token_val), F_TEXT
    )
    return torch.cat([x_text, torch.from_numpy(batch.numeric)], dim=1).numpy()


def twin(x, label, mask, w0=None, **kw):
    w0 = np.zeros(x.shape[1], np.float32) if w0 is None else w0
    w, preds = fused_sgd.fused_dense_sgd(
        torch.from_numpy(x), torch.from_numpy(label), torch.from_numpy(mask),
        torch.from_numpy(w0), **kw,
    )
    return w.numpy(), preds.numpy()


def pallas(x, label, mask, **kw):
    w, preds = pallas_sgd.fused_dense_sgd(
        jnp.asarray(x), jnp.asarray(label), jnp.asarray(mask),
        jax_zero_weights(F_TEXT), interpret=True, **kw,
    )
    return np.asarray(w), np.asarray(preds)


@pytest.mark.parametrize("kw", [
    {},
    {"l2_reg": 0.1},
    {"num_iterations": 5},
    {"convergence_tol": 0.5},  # converges early; the freeze must match
])
def test_twin_matches_pallas_kernel(kw):
    batch = make_batch()
    x = dense_design(batch)
    args = dict(
        num_iterations=kw.get("num_iterations", 30), step_size=0.005,
        l2_reg=kw.get("l2_reg", 0.0),
        convergence_tol=kw.get("convergence_tol", 0.001),
    )
    w, preds = twin(x, batch.label, batch.mask, **args)
    w_ref, preds_ref = pallas(x, batch.label, batch.mask, **args)
    np.testing.assert_allclose(w, w_ref, rtol=2e-3, atol=2e-3)
    valid = batch.mask.astype(bool)
    np.testing.assert_allclose(preds[valid], preds_ref[valid], rtol=2e-3, atol=2e-3)


def test_padding_rows_do_not_leak():
    small = make_batch(n=14, pad_to=16)
    large = FeatureBatch(*(
        np.concatenate([f, np.zeros((16,) + f.shape[1:], f.dtype)]) for f in small
    ))
    kw = dict(num_iterations=10, step_size=0.005)
    w_a, _ = twin(dense_design(small), small.label, small.mask, **kw)
    w_b, _ = twin(dense_design(large), large.label, large.mask, **kw)
    np.testing.assert_allclose(w_a, w_b, rtol=1e-6, atol=1e-7)
    w_ref, _ = pallas(dense_design(large), large.label, large.mask, **kw)
    np.testing.assert_allclose(w_b, w_ref, rtol=2e-3, atol=2e-3)


def test_masked_rows_zeroed_defensively():
    batch = make_batch(n=14, pad_to=16)
    x = dense_design(batch)
    x_dirty = x.copy()
    x_dirty[14:] = np.nan  # multiply-masking would poison every weight
    label_dirty = batch.label.copy()
    label_dirty[14:] = np.inf
    kw = dict(num_iterations=10, step_size=0.005)
    w_clean, p_clean = twin(x, batch.label, batch.mask, **kw)
    w_dirty, p_dirty = twin(x_dirty, label_dirty, batch.mask, **kw)
    np.testing.assert_array_equal(w_clean, w_dirty)
    np.testing.assert_array_equal(p_clean, p_dirty)
    w_ref, _ = pallas(x_dirty, label_dirty, batch.mask, **kw)
    np.testing.assert_allclose(w_dirty, w_ref, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("poison", ["nan_label", "inf_feature"])
def test_nonfinite_valid_row_propagates_as_in_the_pallas_kernel(poison):
    """A NaN label or an Inf numeric feature in a VALID row must reach the
    weights (and an Inf feature its row's prediction) as in the JAX
    package's kernel: the same NaN/+Inf/-Inf pattern, the finite values
    within 2e-3 (the divergence sentinel relies on the stats turning
    non-finite)."""
    batch = make_batch()
    x = dense_design(batch)
    label = batch.label.copy()
    if poison == "nan_label":
        label[3] = np.nan
    else:
        x[5, -2] = np.inf
    kw = dict(num_iterations=10, step_size=0.005)
    w, preds = twin(x, label, batch.mask, **kw)
    w_ref, preds_ref = pallas(x, label, batch.mask, **kw)
    valid = batch.mask.astype(bool)
    for got, want in ((w, w_ref), (preds[valid], preds_ref[valid])):
        for test in (np.isnan, np.isposinf, np.isneginf):
            np.testing.assert_array_equal(test(got), test(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=2e-3, atol=2e-3)
    assert np.isnan(w).all()


def test_empty_batch_no_update():
    batch = make_batch(n=0)
    w0 = RNG.normal(size=(F_TEXT + 4,)).astype(np.float32)
    w, preds = twin(dense_design(batch), batch.label, batch.mask, w0=w0,
                    num_iterations=10, step_size=0.005, l2_reg=0.5)
    np.testing.assert_array_equal(w, w0)
    np.testing.assert_array_equal(preds, 0.0)


def test_cpu_tensors_never_launch_the_kernel():
    fused_sgd.fused_dense_sgd.launches = 0
    batch = make_batch()
    twin(dense_design(batch), batch.label, batch.mask,
         num_iterations=3, step_size=0.005)
    assert fused_sgd.fused_dense_sgd.launches == 0


def test_kernel_gate():
    assert fused_sgd.padded_columns(1004) == 1008
    assert fused_sgd.launches_per_call(50) == 1
    assert fused_sgd.supports(batch_rows=16384, num_features=1004)
    assert fused_sgd.supports(batch_rows=1, num_features=8196)
    assert not fused_sgd.supports(batch_rows=16, num_features=8197)
    assert not fused_sgd.supports(batch_rows=0, num_features=64)
    assert not fused_sgd.supports(batch_rows=16, num_features=64,
                                  dtype=torch.float64)


# ---- the kernel's launch plan (pure arithmetic, checked on the CPU) ---------

H100_SMS, H100_SHARED = 132, 232_448


@pytest.mark.parametrize("features", [64, 1004, 8196])
@pytest.mark.parametrize("rows", [1, 16, 16381, 16384])
def test_launch_plan_covers_every_row_once(rows, features):
    plan = fused_sgd.launch_plan(rows, features, sm_count=H100_SMS,
                                 shared_limit=H100_SHARED)
    assert 1 <= plan.grid <= H100_SMS
    owned = [r for c in range(plan.grid) for r in plan.cta_rows(c)]
    assert owned == list(range(rows))  # each row by exactly one CTA, in order
    assert max(len(plan.cta_rows(c)) for c in range(plan.grid)) == plan.rows_cap
    # one CTA an SM at most, and no more CTAs than give a warp a row each
    assert plan.grid == min(H100_SMS, -(-rows // fused_sgd.WARPS))
    assert plan.resident + plan.spill_per_cta == plan.rows_cap
    assert plan.resident_rows + plan.spill_rows == rows
    assert plan.resident_rows == sum(
        min(len(plan.cta_rows(c)), plan.resident) for c in range(plan.grid))
    assert plan.shared_bytes <= H100_SHARED
    # one more resident row would not fit (or every row already is)
    assert (plan.resident == plan.rows_cap
            or plan.shared_bytes + 2 * plan.row_columns > H100_SHARED)
    assert plan.row_columns >= plan.fpad and plan.row_columns % 8 == 0
    assert plan.spill_elements == plan.grid * plan.spill_per_cta * plan.row_columns


@pytest.mark.parametrize("features", [64, 1004, 8196])
@pytest.mark.parametrize("rows", [1, 16, 16381, 16384])
def test_launch_plan_layout_holds_what_the_kernel_touches(rows, features):
    """The plan's shared-memory layout, which the C entry holds equal to
    the kernel's: w [fpad] f32 at 0, reduction slots, y and r [rows_cap]
    f32, scratch, then the resident bf16 rows, each region 16-byte aligned
    and large enough, ending at shared_bytes."""
    plan = fused_sgd.launch_plan(rows, features, sm_count=H100_SMS,
                                 shared_limit=H100_SHARED)
    red, y, r, scratch, x_rows, stride = plan.smem_layout
    assert all(off % 16 == 0 for off in (red, y, r, scratch, x_rows))
    assert red >= 4 * plan.fpad
    assert y - red >= 4 * fused_sgd.REDUCE_SLOTS * fused_sgd.TILE_COLUMNS
    assert r - y >= 4 * plan.rows_cap and scratch - r >= 4 * plan.rows_cap
    assert x_rows - scratch >= 4 * fused_sgd.SCRATCH_FLOATS
    assert stride * fused_sgd.COLUMN_MULTIPLE == plan.row_columns
    assert plan.shared_bytes == x_rows + 16 * stride * plan.resident


def test_launch_plan_operating_point():
    """B = 16384, F = 1004 on an H100: 132 CTAs of 124-125 rows, 103 of
    them resident (rows stored 1024 columns wide), the rest spilled."""
    plan = fused_sgd.launch_plan(16384, 1004, sm_count=H100_SMS,
                                 shared_limit=H100_SHARED)
    assert (plan.grid, plan.rows_cap, plan.resident, plan.row_columns) == (132, 125, 103, 1024)
    assert (plan.resident_rows, plan.spill_rows) == (13596, 2788)
    assert plan.shared_bytes == 232_400
    assert plan.smem_layout == (4032, 20416, 20928, 21440, 21456, 128)


KERNEL_SOURCE = Path(fused_sgd.__file__).resolve().parents[1] / "csrc" / "fused_sgd.cu"


def test_kernel_build_passes_the_plan_constants():
    """The launch plan's constants reach nvcc, and the source checks its
    own against each of them at compile time."""
    from twtml_tpu_torch.ops import _build

    assert _build.SOURCES["fused_sgd"] == ("fused_sgd.cu", fused_sgd.NVCC_DEFINES)
    source = KERNEL_SOURCE.read_text()
    for define in fused_sgd.NVCC_DEFINES:
        name, value = define[len("-D"):].split("=")
        assert value == str(getattr(fused_sgd, name[len("TWTML_SGD_"):]))
        assert re.search(rf"static_assert\(\w+ == {name},", source), name


def test_kernel_entry_takes_the_wrapper_arguments():
    """The ctypes argument list has as many entries as the C entry's
    parameter list."""
    source = KERNEL_SOURCE.read_text()
    params = re.search(r'extern "C" int twtml_fused_dense_sgd\(([^)]*)\)', source).group(1)
    assert len(params.split(",")) == len(fused_sgd.KERNEL_ARGTYPES)


def test_predict_entry_takes_the_wrapper_arguments():
    """The predict kernel's C entry takes as many parameters as the
    wrapper's ctypes argument list, pointers where the wrapper passes
    pointers."""
    source = KERNEL_SOURCE.read_text()
    params = re.search(r'extern "C" int twtml_fused_dense_predict\(([^)]*)\)', source).group(1)
    params = [p.strip() for p in params.split(",")]
    assert len(params) == len(fused_sgd.PREDICT_ARGTYPES)
    for param, argtype in zip(params, fused_sgd.PREDICT_ARGTYPES):
        assert ("*" in param) == (argtype is ctypes.c_void_p), param


def test_launch_plan_refuses_what_cannot_fit():
    with pytest.raises(ValueError, match="shared memory"):
        fused_sgd.launch_plan(16384, 8196, sm_count=1, shared_limit=48 * 1024)


def test_zero_weights_default_to_the_card():
    """An entry point runs on the card unless the caller asks for the CPU:
    without a card the default raises rather than falling back."""
    from twtml_tpu_torch.models.sgd import zero_weights

    assert zero_weights(4, device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert zero_weights(4).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            zero_weights(4)


# ---- hand-computed MLlib literals (tests/test_sgd_literals.py) -------------

LIT_F_TEXT = 2
TOKEN_IDX = np.array([[0, 0], [1, 0]], np.int32)
TOKEN_VAL = np.array([[1.0, 0.0], [1.0, 0.0]], np.float32)


def two_row_batch(labels, mask=(1.0, 1.0)):
    return FeatureBatch(
        TOKEN_IDX, TOKEN_VAL, np.zeros((2, NUM_NUMBER_FEATURES), np.float32),
        np.asarray(labels, np.float32), np.asarray(mask, np.float32),
    )


def step_weights(w0, batch, **kw):
    kw.setdefault("num_text_features", LIT_F_TEXT)
    kw.setdefault("convergence_tol", 0.0)
    step = make_sgd_train_step(**kw)
    tensors = FeatureBatch(*(torch.from_numpy(np.asarray(a)) for a in batch))
    w1, _ = step(torch.tensor(w0, dtype=torch.float32), tensors)
    return w1.numpy()


LITERALS = {
    # stepSize/sqrt(i), 1-indexed, from w0 = 0; y = (2, 4), stepSize 1
    "sqrt_decay_two_iterations": (
        dict(num_iterations=2, step_size=1.0), np.zeros(6), ((2.0, 4.0),),
        [1.3535533905932737, 2.7071067811865475, 0, 0, 0, 0], 1e-6, 1e-6,
    ),
    # SquaredL2Updater pre-scale also hits the untouched numeric weights
    "l2_pre_scale_one_iteration": (
        dict(num_iterations=1, step_size=1.0, l2_reg=0.5), np.ones(6),
        ((2.0, 4.0),), [1.0, 2.0, 0.5, 0.5, 0.5, 0.5], 1e-6, 1e-6,
    ),
    # the L2 stationary point holds the touched weights exactly
    "l2_stationary_point_two_iterations": (
        dict(num_iterations=2, step_size=1.0, l2_reg=0.5), np.ones(6),
        ((2.0, 4.0),), [1.0, 2.0] + [0.32322330470336313] * 4, 1e-6, 1e-6,
    ),
    # a zero-sample iteration is an exact no-op, no L2 shrink
    "zero_sample_iteration_skips": (
        dict(num_iterations=3, step_size=1.0, l2_reg=0.5),
        np.array([1.0, -2.0, 3.0, 4.0, 0.25, -0.5]), ((2.0, 4.0), (0.0, 0.0)),
        [1.0, -2.0, 3.0, 4.0, 0.25, -0.5], 0, 0,
    ),
}


@pytest.mark.parametrize("name", sorted(LITERALS))
def test_sgd_literal(name):
    kw, w0, batch_args, expected, rtol, atol = LITERALS[name]
    got = step_weights(w0, two_row_batch(*batch_args), **kw)
    np.testing.assert_allclose(got, np.asarray(expected), rtol=rtol, atol=atol)


def test_convergence_freeze_literal():
    """One row (x = e0, y = 2), stepSize 0.5, tol 0.4: converged at it=2
    (the it=2 update still applies), frozen at it=3; tol 0 runs on."""
    batch = FeatureBatch(
        np.array([[0, 0]], np.int32), np.array([[1.0, 0.0]], np.float32),
        np.zeros((1, NUM_NUMBER_FEATURES), np.float32),
        np.array([2.0], np.float32), np.array([1.0], np.float32),
    )
    frozen = step_weights(np.zeros(6), batch, num_iterations=3, step_size=0.5,
                          convergence_tol=0.4)
    np.testing.assert_allclose(
        frozen, [1.3535533905932737, 0, 0, 0, 0, 0], rtol=1e-6, atol=1e-6
    )
    free = step_weights(np.zeros(6), batch, num_iterations=3, step_size=0.5)
    np.testing.assert_allclose(
        free, [1.5401664525721208, 0, 0, 0, 0, 0], rtol=1e-5, atol=1e-6
    )


# ---- the predict-only kernel (N = 0): its plan and the twin's predictions ----


@pytest.mark.parametrize("features", [1004, 2000, 8196])
@pytest.mark.parametrize("rows", [1, 255, 256, 16384])
def test_predict_plan_covers_every_row_once(rows, features):
    """Warp w of the grid takes rows w, w + warps, ...: every row exactly
    once, every warp the same number of rows give or take one, at most two
    CTAs an SM, and w0's shared memory within the 48 KiB a launch takes
    without opting in."""
    plan = fused_sgd.predict_plan(rows, features, sm_count=H100_SMS)
    assert 1 <= plan.grid <= fused_sgd.PREDICT_CTAS_PER_SM * H100_SMS
    owned = sorted(r for w in range(plan.warps) for r in plan.warp_rows(w))
    assert owned == list(range(rows))
    per_warp = [len(plan.warp_rows(w)) for w in range(plan.warps)]
    assert max(per_warp) - min(per_warp) <= 1
    # no CTA without a row, and no smaller grid gives each warp fewer rows
    assert (plan.grid - 1) * fused_sgd.PREDICT_WARPS < rows
    assert plan.fpad == fused_sgd.padded_columns(features)
    assert plan.shared_bytes == 4 * max(plan.fpad, fused_sgd.TILE_COLUMNS) <= 48 * 1024


def test_predict_plan_spreads_the_serve_batch():
    """B = 256 (the serve batch): a row a warp over 32 CTAs; B = 16384: 8
    rows a warp over 256 CTAs (two an SM at most on 132 SMs)."""
    assert fused_sgd.predict_plan(256, 1004, sm_count=H100_SMS).grid == 32
    plan = fused_sgd.predict_plan(16384, 1004, sm_count=H100_SMS)
    assert plan.grid == 256 and {len(plan.warp_rows(w)) for w in range(plan.warps)} == {8}
    with pytest.raises(ValueError, match="at least one row"):
        fused_sgd.predict_plan(0, 1004, sm_count=H100_SMS)


@pytest.mark.parametrize("n_valid", [14, 0])
def test_predict_only_matches_the_pallas_kernel(n_valid):
    """N = 0 (the serving path's predict-only call): the twin's predictions
    against the JAX package's kernel at num_iterations=0, the weights
    returned unchanged, masked rows predicting 0."""
    batch = make_batch(n=n_valid)
    x = dense_design(batch)
    w0 = RNG.normal(size=(F_TEXT + 4,)).astype(np.float32) * 0.1
    kw = dict(num_iterations=0, step_size=0.005)
    w, preds = twin(x, batch.label, batch.mask, w0=w0, **kw)
    w_ref, preds_ref = pallas_sgd.fused_dense_sgd(
        jnp.asarray(x), jnp.asarray(batch.label), jnp.asarray(batch.mask),
        jnp.asarray(w0), interpret=True, **kw)
    np.testing.assert_array_equal(w, w0)
    np.testing.assert_array_equal(np.asarray(w_ref), w0)
    valid = batch.mask.astype(bool)
    np.testing.assert_allclose(preds[valid], np.asarray(preds_ref)[valid], rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(preds[~valid], 0.0)
