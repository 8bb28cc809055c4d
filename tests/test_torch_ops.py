"""The port's device ops against the JAX package's on the same numpy inputs:
index outputs exact, float outputs within 1e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from twtml_tpu.ops import quality as jax_quality
from twtml_tpu.ops import sparse as jax_sparse
from twtml_tpu.ops import stats as jax_stats
from twtml_tpu.ops import text_hash as jax_text_hash
from twtml_tpu.utils import rounding as jax_rounding

from twtml_tpu_torch.models.sgd import batch_to_device
from twtml_tpu_torch.features.batch import UnitBatch
from twtml_tpu_torch.ops import quality, sparse, stats, text_hash
from twtml_tpu_torch.utils import rounding

RNG = np.random.default_rng(5)
F_TEXT = 1000


def random_units(b=12, lu=16, wide=False):
    high = 65536 if wide else 128
    units = RNG.integers(0, high, size=(b, lu)).astype(np.uint16 if wide else np.uint8)
    length = RNG.integers(0, lu + 1, size=(b,)).astype(np.int32)
    length[:3] = [0, 1, 2]  # the padding, single-unit and one-bigram rules
    for i, n in enumerate(length):
        units[i, n:] = 0
    return units, length


def port_units(units, length):
    """The units as the port's step moves them to its device."""
    dummy = np.zeros((units.shape[0],), np.float32)
    moved = batch_to_device(
        UnitBatch(units, length, np.zeros((units.shape[0], 4), np.float32), dummy, dummy),
        "cpu",
    )
    return moved.units, moved.length


@pytest.mark.parametrize("wide", [False, True])
def test_hash_bigrams_device_exact(wide):
    units, length = random_units(wide=wide)
    idx, val = text_hash.hash_bigrams_device(*port_units(units, length), F_TEXT)
    ref_idx, ref_val = jax_text_hash.hash_bigrams_device(
        jnp.asarray(units), jnp.asarray(length), F_TEXT
    )
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(val.numpy(), np.asarray(ref_val))


def test_densify_text_exact():
    units, length = random_units(b=20, lu=32)
    idx, val = text_hash.hash_bigrams_device(*port_units(units, length), 64)
    dense = sparse.densify_text(idx, val, 64)
    ref = jax_sparse.densify_text(jnp.asarray(idx.numpy()), jnp.asarray(val.numpy()), 64)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(ref))


@pytest.mark.parametrize("x", [0.5, -0.5, 2.5, -2.5, 1.49999, -1.5, 0.0, 7.2, -7.7])
def test_round_half_up(x):
    assert rounding.round_half_up(x) == jax_rounding.round_half_up(x)
    got = rounding.torch_round_half_up(torch.tensor([x], dtype=torch.float32))
    ref = jax_rounding.jnp_round_half_up(jnp.asarray([x], dtype=jnp.float32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_round_half_up_ties_away_from_zero():
    got = rounding.torch_round_half_up(torch.tensor([0.5, -0.5, 2.5, -2.5]))
    np.testing.assert_array_equal(got.numpy(), [1.0, -1.0, 3.0, -3.0])


def stats_inputs(b=64, n=50):
    labels = RNG.uniform(100, 1000, size=(b,)).astype(np.float32)
    preds = np.round(RNG.normal(400, 80, size=(b,))).astype(np.float32)
    mask = np.zeros((b,), np.float32)
    mask[:n] = 1.0
    return labels, preds, mask


@pytest.mark.parametrize("n", [0, 1, 50])
def test_batch_stats(n):
    labels, preds, mask = stats_inputs(n=n)
    got = stats.batch_stats(*map(torch.from_numpy, (labels, preds, mask)))
    ref = jax_stats.batch_stats(*map(jnp.asarray, (labels, preds, mask)))
    for k in ("count", "mse", "real_stdev", "pred_stdev"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_quality_vector():
    b = 32
    labels, preds, mask = stats_inputs(b=b, n=27)
    units, length = random_units(b=b, lu=24)
    length[27:] = 0
    t_units, t_length = port_units(units, length)
    idx, val = text_hash.hash_bigrams_device(t_units, t_length, F_TEXT)
    numeric = (RNG.normal(size=(b, 4)) * 1e-3).astype(np.float32)
    w_prev = RNG.normal(size=(F_TEXT + 4,)).astype(np.float32)
    w_new = (w_prev + RNG.normal(size=w_prev.shape) * 1e-2).astype(np.float32)
    raw = RNG.normal(400, 80, size=(b,)).astype(np.float32)
    residual = (raw - labels) * mask
    kw = dict(residual=residual, preds=preds, labels=labels, mask=mask,
              numeric=numeric)
    got = quality.quality_vector(
        torch.from_numpy(w_prev), torch.from_numpy(w_new),
        token_idx=idx, token_val=val,
        **{k: torch.from_numpy(v) for k, v in kw.items()},
    )
    ref = jax_quality.quality_vector(
        jnp.asarray(w_prev), jnp.asarray(w_new),
        token_idx=jnp.asarray(idx.numpy()), token_val=jnp.asarray(val.numpy()),
        **{k: jnp.asarray(v) for k, v in kw.items()},
    )
    assert quality.QUALITY_FIELDS == jax_quality.QUALITY_FIELDS
    assert got.shape == (quality.QUALITY_WIDTH,) and got.dtype == torch.float32
    # a variance is E[x^2] - E[x]^2, a difference of two f32 sums of order
    # E[x^2] whose summation order neither framework pins: its 1e-6 is
    # relative to E[x^2]; every other field is held at 1e-6 of itself
    got, ref = got.numpy(), np.asarray(ref)
    scale = np.abs(ref).astype(np.float64)
    for name, x in (("pred", preds), ("label", labels), ("resid", labels - preds)):
        i = quality.QUALITY_INDEX[f"{name}_var"]
        scale[i] = np.sum(x.astype(np.float64) ** 2 * mask) / mask.sum()
    for j in range(4):
        i = quality.QUALITY_INDEX[f"num_var_{j}"]
        scale[i] = np.sum(numeric[:, j].astype(np.float64) ** 2 * mask) / mask.sum()
    np.testing.assert_array_less(np.abs(got - ref), 1e-6 * scale + 1e-6)
