"""The port's linear learner on the CPU against the JAX package's over 4
consecutive micro-batches of the padded units wire.

Tolerances: weights and raw predictions within rtol/atol 2e-3, since the
port stores X in bf16 (as the Pallas kernel does) and the JAX main path in
f32; batch 1 starts from zero weights, so its predictions are exactly 0 and
its count and reported stats must match exactly."""

import itertools

import numpy as np
import pytest
import torch

from twtml_tpu.features.featurizer import Featurizer as JaxFeaturizer
from twtml_tpu.models.linear import StreamingLinearRegressionWithSGD as JaxLinear
from twtml_tpu.models.sgd import StreamingSGDModel as JaxSGDModel
from twtml_tpu.streaming.sources import ReplayFileSource as JaxReplay
from twtml_tpu.streaming.sources import SyntheticSource as JaxSynthetic

from twtml_tpu_torch.features.featurizer import Featurizer
from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
from twtml_tpu_torch.models.sgd import StreamingSGDModel
from twtml_tpu_torch.ops.quality import QUALITY_WIDTH
from twtml_tpu_torch.streaming.sources import ReplayFileSource, SyntheticSource
from twtml_tpu_torch.utils.rounding import round_half_up

NOW_MS = 1_700_000_000_000
STATS = ("count", "mse", "real_stdev", "pred_stdev")


class JaxRaw(JaxSGDModel):
    """The linear learner with unrounded predictions: the raw X·w."""

    round_predictions = False
    default_step_size = 0.005


class PortRaw(StreamingSGDModel):
    round_predictions = False
    default_step_size = 0.005


def chunks(statuses, size, n=4):
    it = iter(statuses)
    return [list(itertools.islice(it, size)) for _ in range(n)]


def batches(source_name, size):
    """(port batches, JAX batches) of 4 consecutive chunks of ``size``
    source tweets; the two featurizers are held equal elsewhere."""
    if source_name == "synthetic":
        ours = list(SyntheticSource(total=4 * size, seed=3, base_ms=NOW_MS))
        ref = list(JaxSynthetic(total=4 * size, seed=3, base_ms=NOW_MS).produce())
    else:
        ours = list(itertools.islice(
            ReplayFileSource("tests/data/tweets.jsonl", loop=True), 40
        ))
        ref = list(itertools.islice(
            JaxReplay("tests/data/tweets.jsonl", loop=True).produce(), 40
        ))
    f, jf = Featurizer(now_ms=NOW_MS), JaxFeaturizer(now_ms=NOW_MS)
    return (
        [f.featurize_batch_units(c, row_bucket=size) for c in chunks(ours, size)],
        [jf.featurize_batch_units(c, row_bucket=size) for c in chunks(ref, size)],
    )


CASES = [("synthetic", 256), ("replay", 10)]


@pytest.mark.parametrize("source_name,size", CASES)
def test_four_batches_match_jax_model(source_name, size):
    ours, ref = batches(source_name, size)
    port = StreamingLinearRegressionWithSGD(device="cpu", quality=True)
    jax_model = JaxLinear(quality=True)
    for i, (b, jb) in enumerate(zip(ours, ref)):
        out = port.step(b)
        jout = jax_model.step(jb)
        if i == 0:
            # zero weights: predictions are exactly 0 in both, so the
            # reported (HALF_UP-rounded) stats are equal; the unrounded f32
            # stats differ only by how each framework orders and fuses the
            # sums (XLA may contract mean*mean into an FMA), within 1e-6
            np.testing.assert_array_equal(out.predictions.numpy(), 0.0)
            for k in STATS:
                got, want = float(getattr(out, k)), float(getattr(jout, k))
                assert round_half_up(got) == round_half_up(want), k
                assert got == pytest.approx(want, rel=1e-6), k
        assert float(out.count) == float(jout.count)
        assert out.quality.shape == (QUALITY_WIDTH,)
        assert torch.isfinite(out.quality).all()
        np.testing.assert_allclose(
            port.latest_weights, jax_model.latest_weights, rtol=2e-3, atol=2e-3,
            err_msg=f"weights after batch {i + 1}",
        )


@pytest.mark.parametrize("source_name,size", CASES)
def test_raw_predictions_match_jax_model(source_name, size):
    ours, ref = batches(source_name, size)
    port, jax_model = PortRaw(device="cpu"), JaxRaw()
    for i, (b, jb) in enumerate(zip(ours, ref)):
        got = port.step(b).predictions.numpy()
        want = np.asarray(jax_model.step(jb).predictions)
        valid = b.mask.astype(bool)
        np.testing.assert_allclose(
            got[valid], want[valid], rtol=2e-3, atol=2e-3,
            err_msg=f"raw predictions of batch {i + 1}",
        )


def test_set_initial_weights_and_reset():
    model = StreamingLinearRegressionWithSGD(device="cpu", num_text_features=8)
    w = np.arange(12, dtype=np.float32)
    np.testing.assert_array_equal(model.set_initial_weights(w).latest_weights, w)
    np.testing.assert_array_equal(model.reset().latest_weights, np.zeros(12))
    with pytest.raises(ValueError):
        model.set_initial_weights(np.zeros(11, np.float32))


@pytest.mark.parametrize("kw,item", [
    ({"num_text_features": 2**18}, "A6"),
    ({"mini_batch_fraction": 0.5}, "A2"),
    ({"dtype": torch.float64}, "float32"),
])
def test_out_of_slice_configurations_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        StreamingLinearRegressionWithSGD(device="cpu", **kw)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card error cannot occur")
    with pytest.raises(RuntimeError, match="backend cpu"):
        StreamingLinearRegressionWithSGD()
