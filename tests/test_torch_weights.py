"""Weights carried between the JAX package's linear learner and the port's
(``twtml_tpu_torch/convert.py``): a JAX-trained model seeds the port, both
step on the next batch and agree within 2e-3 (the port stores X in bf16);
the port's weights seed the JAX model the same way."""

import numpy as np
import pytest
import torch

from twtml_tpu.features.featurizer import Featurizer as JaxFeaturizer
from twtml_tpu.models.linear import StreamingLinearRegressionWithSGD as JaxLinear
from twtml_tpu.streaming.sources import SyntheticSource as JaxSynthetic

from twtml_tpu_torch.convert import weights_from_jax, weights_to_numpy
from twtml_tpu_torch.features.featurizer import Featurizer
from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
from twtml_tpu_torch.streaming.sources import SyntheticSource

NOW_MS = 1_700_000_000_000
B = 128


def five_batches():
    ours = list(SyntheticSource(total=5 * B, seed=9, base_ms=NOW_MS))
    ref = list(JaxSynthetic(total=5 * B, seed=9, base_ms=NOW_MS).produce())
    f, jf = Featurizer(now_ms=NOW_MS), JaxFeaturizer(now_ms=NOW_MS)
    return (
        [f.featurize_batch_units(ours[i:i + B], row_bucket=B)
         for i in range(0, 5 * B, B)],
        [jf.featurize_batch_units(ref[i:i + B], row_bucket=B)
         for i in range(0, 5 * B, B)],
    )


def test_jax_trained_weights_seed_the_port_and_back():
    ours, ref = five_batches()
    jax_model = JaxLinear()
    for jb in ref[:3]:
        jax_model.step(jb)

    w = weights_from_jax(jax_model.latest_weights, device="cpu")
    assert w.dtype == torch.float32 and w.device.type == "cpu"
    np.testing.assert_array_equal(w.numpy(), jax_model.latest_weights)
    port = StreamingLinearRegressionWithSGD(device="cpu").set_initial_weights(w)

    jout, out = jax_model.step(ref[3]), port.step(ours[3])
    np.testing.assert_array_equal(float(out.count), float(jout.count))
    np.testing.assert_allclose(
        port.latest_weights, jax_model.latest_weights, rtol=2e-3, atol=2e-3
    )

    # the port's weights back into a fresh JAX model; both step batch 5
    back = weights_to_numpy(port._weights)
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, port.latest_weights)
    jax_seeded = JaxLinear().set_initial_weights(back)
    jax_seeded.step(ref[4])
    port.step(ours[4])
    np.testing.assert_allclose(
        port.latest_weights, jax_seeded.latest_weights, rtol=2e-3, atol=2e-3
    )


@pytest.mark.parametrize("arr,err", [
    (np.zeros(1003, np.float32), ValueError),
    (np.zeros(1004, np.float64), TypeError),
])
def test_weights_from_jax_checks_shape_and_type(arr, err):
    with pytest.raises(err):
        weights_from_jax(arr, device="cpu")


def test_weights_to_numpy_checks_shape_and_type():
    with pytest.raises(ValueError):
        weights_to_numpy(torch.zeros(1005))
    with pytest.raises(TypeError):
        weights_to_numpy(torch.zeros(1004, dtype=torch.float64))
    np.testing.assert_array_equal(
        weights_to_numpy(torch.arange(12, dtype=torch.float32), num_text_features=8),
        np.arange(12, dtype=np.float32),
    )
