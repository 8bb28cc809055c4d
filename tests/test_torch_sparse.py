"""The port's sparse ops (``twtml_tpu_torch/ops/sparse.py``) and the 2^18
regime (BASELINE config #4) end to end on the CPU, against the JAX package:
the gather predict and the scatter gradient on the same numpy inputs, the
flagship app at ``--numTextFeatures 262144 --l2Reg 0.1`` printing the JAX
app's lines on the replay fixture, and 2^18 weights and checkpoints moved
between the packages.

Tolerances: the gather sums each row in a fixed order, the scatter adds
each occurrence; both within rtol 1e-6 of XLA's (summation order). Weights
after a step within rtol 2e-4 and atol 2e-4·max(1, max|w|), the JAX
package's Gram-vs-scatter tolerance."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from twtml_tpu.checkpoint import Checkpointer as JaxCheckpointer
from twtml_tpu.features.featurizer import Featurizer as JaxFeaturizer
from twtml_tpu.models.linear import StreamingLinearRegressionWithSGD as JaxLinear
from twtml_tpu.ops import sparse as jsparse
from twtml_tpu.streaming.sources import ReplayFileSource as JaxReplay
from twtml_tpu.streaming.sources import SyntheticSource as JaxSynthetic
from twtml_tpu.utils import round_half_up

from twtml_tpu_torch.checkpoint import Checkpointer
from twtml_tpu_torch.convert import weights_from_jax, weights_to_numpy
from twtml_tpu_torch.features.featurizer import Featurizer
from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
from twtml_tpu_torch.ops import sparse
from twtml_tpu_torch.streaming.sources import SyntheticSource

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = "tests/data/tweets.jsonl"
NOW_MS = 1_700_000_000_000
F = 2**18
CLOSED = "http://127.0.0.1:9"


def tokens(seed, b=32, l=20, f=F):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, f, size=(b, l)).astype(np.int32)
    idx[:, :3] = idx[:, 3:4]  # a feature repeated within each row
    idx[1::2, 5] = idx[0, 5]  # and shared across rows
    val = rng.integers(0, 3, size=(b, l)).astype(np.float32)
    val[:, -4:] = 0.0
    idx[:, -4:] = 0
    w = rng.normal(size=(f + 4,)).astype(np.float32)
    num = rng.normal(size=(b, 4)).astype(np.float32) * 0.1
    r = rng.normal(size=(b,)).astype(np.float32)
    return idx, val, w, num, r


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("f", [512, F])
def test_sparse_predict_equals_the_jax_packages(seed, f):
    idx, val, w, num, _ = tokens(seed, f=f)
    w = w[:f + 4]
    got = sparse.sparse_predict(torch.from_numpy(w[:f]), torch.from_numpy(w[f:]),
                                torch.from_numpy(idx), torch.from_numpy(val),
                                torch.from_numpy(num))
    want = jsparse.sparse_predict(jnp.asarray(w[:f]), jnp.asarray(w[f:]), jnp.asarray(idx),
                                  jnp.asarray(val), jnp.asarray(num))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    dot = sparse.sparse_text_dot(torch.from_numpy(w[:f]), torch.from_numpy(idx),
                                 torch.from_numpy(val))
    np.testing.assert_allclose(
        dot.numpy(), np.asarray(jsparse.sparse_text_dot(jnp.asarray(w[:f]), jnp.asarray(idx),
                                                        jnp.asarray(val))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("f", [512, F])
def test_sparse_grad_text_equals_the_jax_packages(seed, f):
    idx, val, _, _, r = tokens(seed, f=f)
    got = sparse.sparse_grad_text(torch.from_numpy(idx), torch.from_numpy(val),
                                  torch.from_numpy(r), f)
    want = jsparse.sparse_grad_text(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(r), f)
    assert got.shape == (f,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # sequential on the CPU: bitwise reproducible
    again = sparse.sparse_grad_text(torch.from_numpy(idx), torch.from_numpy(val),
                                    torch.from_numpy(r), f)
    assert torch.equal(got, again)


def test_densify_text_is_unchanged_by_the_sparse_ops():
    idx, val, _, _, _ = tokens(4, f=512)
    got = sparse.densify_text(torch.from_numpy(idx), torch.from_numpy(val), 512)
    want = jsparse.densify_text(jnp.asarray(idx), jnp.asarray(val), 512)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- the app at 2^18


def run_app(*extra):
    env = dict(os.environ, TWTML_NOW_MS=str(NOW_MS))
    return subprocess.run(
        [sys.executable, "-m", "twtml_tpu_torch.apps.linear_regression", *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )


def jax_lines(**model_kw):
    """The JAX app's ``handle`` line for each 4-tweet chunk of the fixture."""
    statuses = list(JaxReplay(os.path.join(REPO, FIXTURE)).produce())
    featurizer = JaxFeaturizer(now_ms=NOW_MS, num_text_features=F)
    model = JaxLinear(quality=True, num_text_features=F, **model_kw)
    total, lines = 0, []
    for lo in range(0, len(statuses), 4):
        out = model.step(featurizer.featurize_batch_units(statuses[lo:lo + 4], row_bucket=4))
        b = int(out.count)
        total += b
        mse = round_half_up(float(out.mse))
        real = round_half_up(float(out.real_stdev))
        pred = round_half_up(float(out.pred_stdev))
        lines.append(f"count: {total}  batch: {b}  mse: {mse}  "
                     f"stdev (real, pred): ({int(real)}, {int(pred)})")
    return lines


def test_config_4_app_on_the_fixture_prints_the_jax_apps_lines():
    proc = run_app("--backend", "cpu", "--source", "replay", "--replayFile", FIXTURE,
                   "--seconds", "0", "--batchBucket", "4", "--numTextFeatures", str(F),
                   "--l2Reg", "0.1", "--lightning", CLOSED, "--twtweb", CLOSED,
                   "--webTimeout", "0.2")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == jax_lines(l2_reg=0.1)
    assert "sparse step route: gram" in proc.stderr
    assert "done: 6 tweets in 3 batches" in proc.stderr


# ---------------------------------------------------------------- weights at 2^18

B = 64


def batches():
    ours = list(SyntheticSource(total=4 * B, seed=9, base_ms=NOW_MS).produce())
    ref = list(JaxSynthetic(total=4 * B, seed=9, base_ms=NOW_MS).produce())
    f = Featurizer(now_ms=NOW_MS, num_text_features=F)
    jf = JaxFeaturizer(now_ms=NOW_MS, num_text_features=F)
    return ([f.featurize_batch_units(ours[i:i + B], row_bucket=B) for i in range(0, 4 * B, B)],
            [jf.featurize_batch_units(ref[i:i + B], row_bucket=B) for i in range(0, 4 * B, B)])


def assert_weights_close(got, want):
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4 * scale)


def test_2e18_weights_move_between_the_packages():
    ours, ref = batches()
    jax_model = JaxLinear(num_text_features=F, l2_reg=0.1)
    for jb in ref[:2]:
        jax_model.step(jb)
    w = weights_from_jax(jax_model.latest_weights, num_text_features=F, device="cpu")
    assert w.shape == (F + 4,)
    np.testing.assert_array_equal(w.numpy(), jax_model.latest_weights)
    port = StreamingLinearRegressionWithSGD(device="cpu", num_text_features=F, l2_reg=0.1)
    port.set_initial_weights(w)
    jax_model.step(ref[2])
    port.step(ours[2])
    assert_weights_close(port.latest_weights, jax_model.latest_weights)
    back = weights_to_numpy(port._weights, num_text_features=F)
    jax_seeded = JaxLinear(num_text_features=F, l2_reg=0.1).set_initial_weights(back)
    jax_seeded.step(ref[3])
    port.step(ours[3])
    assert_weights_close(port.latest_weights, jax_seeded.latest_weights)


def test_jax_checkpoint_at_2e18_restores_into_the_port(tmp_path):
    ours, ref = batches()
    jax_model = JaxLinear(num_text_features=F, l2_reg=0.1)
    for jb in ref[:2]:
        jax_model.step(jb)
    JaxCheckpointer(str(tmp_path)).save(2, jax_model.latest_weights, {"count": 2 * B})
    state, meta = Checkpointer(str(tmp_path)).restore()
    assert meta["count"] == 2 * B and state.shape == (F + 4,)
    np.testing.assert_array_equal(state, jax_model.latest_weights)
    port = StreamingLinearRegressionWithSGD(device="cpu", num_text_features=F, l2_reg=0.1)
    port.set_initial_weights(state)
    out, jout = port.step(ours[2]), jax_model.step(ref[2])
    assert float(out.count) == float(jout.count)
    assert_weights_close(port.latest_weights, jax_model.latest_weights)
    # and back: the port's archive restores in the JAX package
    Checkpointer(str(tmp_path)).save(3, port.latest_weights, {"count": 3 * B})
    back, _ = JaxCheckpointer(str(tmp_path)).restore()
    np.testing.assert_array_equal(back, port.latest_weights)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_2e18_other_weight_types_run_the_scatter_loop(dtype):
    """The JAX package's auto gate is float32-only: bfloat16 and float64
    weights run the per-iteration loop, in their own type."""
    ours, ref = batches()
    port = StreamingLinearRegressionWithSGD(device="cpu", num_text_features=F, dtype=dtype)
    assert port.route == "scatter"
    out = port.step(ours[0])
    assert port._weights.dtype == dtype and torch.isfinite(out.predictions).all()
    if dtype == torch.float64:
        return
    jax_model = JaxLinear(num_text_features=F, dtype=jnp.bfloat16)
    jax_model.step(ref[0])
    np.testing.assert_allclose(port.latest_weights,
                               np.asarray(jax_model.latest_weights, np.float32),
                               rtol=0.1, atol=0.1)
