"""Bernoulli mini-batches and ``--dtype`` in the port, on the CPU, against the
JAX package on the same seeded inputs.

- ``ops/prng.py``: keys, ``fold_in``, raw bits, ``uniform`` and
  ``bernoulli`` bitwise equal to ``jax.random`` (threefry in its
  partitionable mode), in float32 and in jax's x64 mode (float64 draws);
- the sampled step (``miniBatchFraction < 1``, the torch loop) against the
  JAX step over 4 consecutive batches: weights within SAMPLED_RTOL of the
  largest weight, the 4 stats within SAMPLED_RTOL, the rounded predictions
  equal;
- ``--dtype bfloat16`` within BF16_RTOL, ``--dtype float64`` (the JAX
  package's x64 run) within F64_RTOL, at fraction 1 and 0.5;
- the route is chosen by configuration: fraction 1 in float32 runs
  ``fused_dense_sgd``, the rest the torch loop, which never calls it;
- float64 is refused off the CPU, as the JAX package refuses it.

x64 is turned on only inside ``jax.enable_x64(True)`` (a thread-local
context) or in a subprocess, never for the whole test worker.
"""

import contextlib
import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twtml_tpu.apps.common import select_backend as jax_select_backend
from twtml_tpu.config import ConfArguments as JaxConf
from twtml_tpu.features.featurizer import Featurizer as JaxFeaturizer
from twtml_tpu.models.linear import StreamingLinearRegressionWithSGD as JaxLinear
from twtml_tpu.models.sgd import MLLIB_SAMPLING_SEED as JAX_SEED
from twtml_tpu.streaming.sources import SyntheticSource as JaxSynthetic
from twtml_tpu_torch.apps import common
from twtml_tpu_torch.apps import linear_regression as app
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.features.featurizer import Featurizer
from twtml_tpu_torch.models import sgd as sgd_module
from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
from twtml_tpu_torch.ops import prng
from twtml_tpu_torch.streaming.sources import SyntheticSource

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data", "tweets.jsonl")
NOW_MS = 1_700_000_000_000
CLOSED = "http://127.0.0.1:9"
QUIET = ["--lightning", CLOSED, "--twtweb", CLOSED, "--webTimeout", "0.2"]
STATS = ("count", "mse", "real_stdev", "pred_stdev")

# tolerances, each relative to the largest |value| of the JAX package's
# array (weights) or to the value (stats): float32 sums in another order
# (the torch and XLA CPU matmuls); bfloat16 within 2**-7, two units of its
# 8-bit mantissa; float64 within 1e-12
SAMPLED_RTOL = 1e-4
BF16_RTOL = 2.0**-7
F64_RTOL = 1e-12
RTOL = {torch.float32: SAMPLED_RTOL, torch.bfloat16: BF16_RTOL, torch.float64: F64_RTOL}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
             torch.float64: jnp.float64}


def key_words(key) -> tuple:
    return tuple(int(v) for v in np.asarray(key))


def x64(on: bool):
    return jax.enable_x64(True) if on else contextlib.nullcontext()


# ---- threefry, bit for bit ---------------------------------------------------

def test_threefry_runs_in_the_partitionable_mode():
    """The port follows jax's partitionable threefry (the default of this
    jax); a flip of that default would change every mask, so it shows here."""
    assert jax.config.jax_threefry_partitionable is True
    assert JAX_SEED == sgd_module.MLLIB_SAMPLING_SEED == 42


@pytest.mark.parametrize("seed", [42, 0, 7, 2**31 - 1, 2**33 + 5])
@pytest.mark.parametrize("data", [1, 2, 50, 4096, 2**32 - 1])
def test_key_and_fold_in_match_jax(seed, data):
    with x64(seed >= 2**31):
        key = jax.random.PRNGKey(seed)
        assert key_words(key) == prng.prng_key(seed)
        want = key_words(jax.random.fold_in(key, data))
    got = prng.fold_in(prng.prng_key(seed), torch.tensor(data, dtype=torch.int64))
    assert tuple(int(v) for v in got) == want


@pytest.mark.parametrize("it", [1, 3, 50])
@pytest.mark.parametrize("shape", [(1,), (7,), (16384,), (3, 5), (2, 3, 4)])
def test_random_bits_match_jax(it, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(42), it)
    want = np.asarray(jax.random.bits(key, shape, dtype=jnp.uint32)).astype(np.int64)
    got = prng.random_bits(key_words(key), 32, shape)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("it", [1, 2, 50])
@pytest.mark.parametrize("shape", [(5,), (1000,), (4, 33)])
@pytest.mark.parametrize("p", [0.5, 0.3, 0.9])
def test_uniform_and_bernoulli_match_jax_f32(it, shape, p):
    key = jax.random.fold_in(jax.random.PRNGKey(42), it)
    words = key_words(key)
    np.testing.assert_array_equal(
        prng.uniform(words, shape).numpy(), np.asarray(jax.random.uniform(key, shape)))
    np.testing.assert_array_equal(
        prng.bernoulli(words, p, shape).numpy(),
        np.asarray(jax.random.bernoulli(key, p, shape)))


@pytest.mark.parametrize("it", [1, 2, 50])
@pytest.mark.parametrize("p", [0.5, 0.3])
def test_uniform_and_bernoulli_match_jax_f64(it, p):
    """Under x64 ``bernoulli``'s float follows ``p``: float64 draws from
    64-bit words, other masks than float32's."""
    with jax.enable_x64(True):
        key = jax.random.fold_in(jax.random.PRNGKey(42), it)
        u = np.asarray(jax.random.uniform(key, (2048,), dtype=jnp.float64))
        m = np.asarray(jax.random.bernoulli(key, p, (2048,)))
    words = key_words(key)
    got_u = prng.uniform(words, (2048,), torch.float64).numpy()
    assert got_u.dtype == np.float64
    np.testing.assert_array_equal(got_u, u)
    np.testing.assert_array_equal(prng.bernoulli(words, p, (2048,), torch.float64).numpy(), m)
    assert (m != prng.bernoulli(words, p, (2048,)).numpy()).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("fraction", [0.5, 0.3])
def test_sampling_masks_are_the_jax_loops_masks(dtype, fraction):
    """Row i of the batched [N, B] draw is the JAX loop's iteration-(i+1)
    mask ``bernoulli(fold_in(PRNGKey(42), i + 1), fraction, (B,))``; float64
    weights draw as the JAX package's x64 run does."""
    rows, iters = 97, 50
    masks = sgd_module.sampling_masks(rows, iters, fraction, dtype, "cpu")
    assert masks.shape == (iters, rows) and masks.dtype == dtype
    with x64(dtype == torch.float64):
        key = jax.random.PRNGKey(42)
        want = np.stack([np.asarray(jax.random.bernoulli(
            jax.random.fold_in(key, it), fraction, (rows,))) for it in range(1, iters + 1)])
    np.testing.assert_array_equal(masks.float().numpy(), want.astype(np.float32))


# ---- the steps against the JAX package's ---------------------------------------

def batches(size=256, n=4, seed=3):
    """(port, JAX) unit batches of n consecutive chunks of pinned synthetic
    tweets; the two featurizers are held equal elsewhere."""
    ours = list(SyntheticSource(total=n * size, seed=seed, base_ms=NOW_MS).produce())
    ref = list(JaxSynthetic(total=n * size, seed=seed, base_ms=NOW_MS).produce())
    f, jf = Featurizer(now_ms=NOW_MS), JaxFeaturizer(now_ms=NOW_MS)
    cut = lambda s, i: s[i * size:(i + 1) * size]  # noqa: E731
    return ([f.featurize_batch_units(cut(ours, i), row_bucket=size) for i in range(n)],
            [jf.featurize_batch_units(cut(ref, i), row_bucket=size) for i in range(n)])


def compare_steps(dtype, fraction, **kw):
    """4 batches through both learners; returns the port's model."""
    ours, ref = batches()
    rtol = RTOL[dtype]
    with x64(dtype == torch.float64):
        port = StreamingLinearRegressionWithSGD(
            device="cpu", quality=True, dtype=dtype, mini_batch_fraction=fraction, **kw)
        jax_model = JaxLinear(quality=True, dtype=JAX_DTYPE[dtype],
                              mini_batch_fraction=fraction, **kw)
        for i, (b, jb) in enumerate(zip(ours, ref)):
            out, jout = port.step(b), jax_model.step(jb)
            w, jw = port.latest_weights, np.asarray(jax_model.latest_weights, np.float64)
            np.testing.assert_allclose(w, jw, rtol=0, atol=rtol * np.abs(jw).max(),
                                       err_msg=f"weights after batch {i + 1}")
            for k in STATS:
                assert float(getattr(out, k)) == pytest.approx(
                    float(getattr(jout, k)), rel=rtol, abs=rtol), (i, k)
            valid = b.mask.astype(bool)
            got = out.predictions.double().numpy()[valid]
            want = np.asarray(jout.predictions, np.float64)[valid]
            if dtype == torch.bfloat16:
                np.testing.assert_allclose(got, want, rtol=rtol, atol=1.0)
            else:  # the rounded predictions are equal
                np.testing.assert_array_equal(got, want)
            assert np.isfinite(out.quality.numpy()).all()
    return port


@pytest.mark.parametrize("fraction", [0.5, 0.3])
def test_sampled_step_matches_jax(fraction):
    port = compare_steps(torch.float32, fraction)
    assert port.route == "torch_loop"


def test_sampled_step_with_l2_matches_jax():
    compare_steps(torch.float32, 0.5, l2_reg=0.01)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_dtype_steps_match_jax(dtype, fraction):
    port = compare_steps(dtype, fraction)
    assert port.route == "torch_loop"
    assert port.latest_weights.dtype == (np.float64 if dtype == torch.float64 else np.float32)


def test_zero_selected_rows_make_no_update():
    """A fraction that selects nothing (0) leaves the weights at zero: every
    iteration is a skip, and a skip is not convergence."""
    ours, _ = batches(n=1)
    port = StreamingLinearRegressionWithSGD(device="cpu", mini_batch_fraction=0.0)
    out = port.step(ours[0])
    assert not port.latest_weights.any() and float(out.count) == 256.0


def test_bfloat16_dtype_trains():
    """The JAX package's ``test_bfloat16_dtype_trains``: bfloat16 and float32
    both learn on the same stream (progressive-validation MSE falls)."""
    statuses = list(SyntheticSource(total=512, seed=9).produce())
    feat = Featurizer(now_ms=1785320000000)
    curves = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = StreamingLinearRegressionWithSGD(device="cpu", num_iterations=10, dtype=dtype)
        mses = []
        for i in range(0, 512, 128):
            batch = feat.featurize_batch_units(statuses[i:i + 128], row_bucket=128)
            mses.append(float(model.step(batch).mse))
        assert np.isfinite(mses).all()
        assert np.abs(model.latest_weights).sum() > 0
        curves[dtype] = mses
    assert curves[torch.bfloat16][-1] < curves[torch.bfloat16][0]
    assert curves[torch.float32][-1] < curves[torch.float32][0]


# ---- routing ------------------------------------------------------------------------

@pytest.mark.parametrize("fraction,dtype,route", [
    (1.0, torch.float32, "fused_dense_sgd"), (0.5, torch.float32, "torch_loop"),
    (1.0, torch.bfloat16, "torch_loop"), (1.0, torch.float64, "torch_loop"),
])
def test_the_route_follows_the_configuration(monkeypatch, fraction, dtype, route):
    calls = []
    real = sgd_module.fused_dense_sgd
    monkeypatch.setattr(sgd_module, "fused_dense_sgd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    assert sgd_module.dense_route(fraction, dtype) == route
    model = StreamingLinearRegressionWithSGD(device="cpu", mini_batch_fraction=fraction,
                                             dtype=dtype)
    assert model.route == route
    model.step(batches(size=16, n=1)[0][0])
    assert len(calls) == (route == "fused_dense_sgd")


def test_the_mask_set_is_drawn_once_a_row_count(monkeypatch):
    draws = []
    real = sgd_module.sampling_masks
    monkeypatch.setattr(sgd_module, "sampling_masks",
                        lambda *a, **k: draws.append(a[0]) or real(*a, **k))
    model = StreamingLinearRegressionWithSGD(device="cpu", mini_batch_fraction=0.5)
    for b in batches(size=32)[0]:
        model.step(b)
    assert draws == [32]


# ---- the app --------------------------------------------------------------------------

def run_port(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        totals = app.run(ConfArguments().parse(argv))
    return totals, [ln for ln in out.getvalue().splitlines() if ln.startswith("count:")]


FIXTURE = ["--source", "replay", "--replayFile", DATA, "--seconds", "0",
           "--batchBucket", "2", "--backend", "cpu", "--master", "local[1]", *QUIET]


def line_numbers(line):
    """(count, batch, mse, real stdev, pred stdev) of a printed line."""
    import re

    return [float(v) for v in re.findall(r"-?\d+(?:\.\d+)?", line)]


@pytest.mark.parametrize("extra", [["-b", "0.5"], ["-b", "0.3"], ["--dtype", "bfloat16"],
                                   ["--dtype", "bfloat16", "-b", "0.5"]])
def test_app_lines_equal_the_jax_apps(monkeypatch, capsys, extra):
    """float32 runs print the JAX app's lines; bfloat16 runs its counts, and
    its MSE and stdevs within BF16_RTOL (one bfloat16 unit of an MSE near
    7e5 is 4096, and XLA may keep bfloat16 intermediates in float32)."""
    from twtml_tpu.apps import linear_regression as jax_app

    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    totals, lines = run_port(FIXTURE + extra)
    jax.devices()
    jax_app.run(JaxConf().parse(FIXTURE + extra))
    jax_lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("count:")]
    assert len(lines) == len(jax_lines) == 5
    if "bfloat16" not in extra:
        assert lines == jax_lines
        return
    for got, want in zip(map(line_numbers, lines), map(line_numbers, jax_lines)):
        assert got[:2] == want[:2]
        np.testing.assert_allclose(got[2:], want[2:], rtol=BF16_RTOL, atol=1.0)


def test_float64_app_lines_equal_the_jax_x64_app(monkeypatch):
    """The JAX app turns x64 on for the whole process under --dtype
    float64, so it runs in a subprocess."""
    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    argv = FIXTURE + ["--dtype", "float64", "-b", "0.5"]
    _, lines = run_port(argv)
    env = dict(os.environ, JAX_PLATFORMS="cpu", TWTML_NOW_MS=str(NOW_MS))
    proc = subprocess.run([sys.executable, "-m", "twtml_tpu.apps.linear_regression", *argv],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert lines == [ln for ln in proc.stdout.splitlines() if ln.startswith("count:")]
    assert len(lines) == 5


def test_float64_is_refused_on_the_card_as_the_jax_package_refuses_it():
    conf = ConfArguments().parse(["--dtype", "float64", "--backend", "cuda"])
    with pytest.raises(SystemExit, match="float64.*CPU.*add --backend cpu"):
        common.select_backend(conf)
    with pytest.raises(SystemExit, match="float64.*CPU.*add --backend cpu"):
        jax_select_backend(JaxConf().parse(["--dtype", "float64", "--backend", "tpu"]))
    common.select_backend(ConfArguments().parse(["--dtype", "float64", "--backend", "cpu"]))


def test_bfloat16_checkpoint_round_trips_as_float32(tmp_path):
    """bfloat16 weights are checkpointed as float32 (exact; numpy has no
    bfloat16), and both packages restore the archive into a bfloat16
    model. The JAX package's own bfloat16 archive fails its restore's dtype
    check (a reference issue, ROADMAP C), so it is not the format here."""
    from twtml_tpu.checkpoint import Checkpointer as JaxCheckpointer
    from twtml_tpu_torch.checkpoint import Checkpointer

    port = StreamingLinearRegressionWithSGD(device="cpu", dtype=torch.bfloat16)
    port.step(batches(size=32, n=1)[0][0])
    w = port.latest_weights
    assert w.dtype == np.float32 and w.any()
    assert np.array_equal(w, port._weights.float().numpy())
    Checkpointer(str(tmp_path / "ck")).save(1, w, {"count": 32})
    for restored in (Checkpointer(str(tmp_path / "ck")).restore(),
                     JaxCheckpointer(str(tmp_path / "ck")).restore()):
        got = np.asarray(restored[0])
        fresh = StreamingLinearRegressionWithSGD(device="cpu", dtype=torch.bfloat16)
        assert np.array_equal(fresh.set_initial_weights(got).latest_weights, w)
        jax_model = JaxLinear(dtype=jnp.bfloat16).set_initial_weights(got)
        assert np.array_equal(np.asarray(jax_model.latest_weights, np.float32), w)
    jax_w = np.asarray(jnp.asarray(w, dtype=jnp.bfloat16))
    JaxCheckpointer(str(tmp_path / "jax")).save(1, jax_w, {"count": 32})
    assert JaxCheckpointer(str(tmp_path / "jax")).restore() is None
