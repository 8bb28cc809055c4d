"""Data-parallel training over a process group on the CPU: the port's
``ParallelSGDModel`` at world size 2 (two spawned gloo processes, each
under its own timeout) against the JAX ``ParallelSGDModel`` on a 2-device
virtual CPU mesh, on the same global batch (each rank its contiguous half,
as the mesh shards rows), in both residual modes and on the Gram route;
B1's split twin at world size 1 against ``fused_dense_sgd_reference``;
the sharded sources against the JAX package's; the backend rule and the
data axis."""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_group import last_json, run_worker_group

from twtml_tpu.features.batch import FeatureBatch as JaxFeatureBatch
from twtml_tpu.models.linear import StreamingLinearRegressionWithSGD as JaxLinear
from twtml_tpu.models.logistic import StreamingLogisticRegressionWithSGD as JaxLogistic
from twtml_tpu.parallel import ParallelSGDModel as JaxParallel
from twtml_tpu.parallel import make_mesh as jax_make_mesh
from twtml_tpu.streaming.sources import IdShardedSource as JaxIdSharded
from twtml_tpu.streaming.sources import ShardedSource as JaxSharded
from twtml_tpu.streaming.sources import SyntheticSource as JaxSynthetic
from twtml_tpu_torch.ops import fused_sgd
from twtml_tpu_torch.parallel import distributed
from twtml_tpu_torch.parallel.mesh import make_mesh
from twtml_tpu_torch.streaming.sources import IdShardedSource, ShardedSource, SyntheticSource
from twtml_tpu_torch.utils import round_half_up

F_TEXT = 64
ROWS = 32  # global; 16 a rank


def global_batch(seed: int, binary: bool = False) -> dict:
    """Token counts and bf16-exact numeric features (multiples of 1/64, so
    B1's bf16 X holds them exactly and the port's step is the JAX step up
    to the order of its sums)."""
    rng = np.random.default_rng(seed)
    label = (rng.random(ROWS) < 0.5).astype(np.float32) if binary else \
        rng.normal(300, 40, ROWS).astype(np.float32)
    return {
        "token_idx": rng.integers(0, F_TEXT, (ROWS, 8)).astype(np.int32),
        "token_val": rng.integers(0, 3, (ROWS, 8)).astype(np.float32),
        "numeric": (rng.integers(-64, 64, (ROWS, 4)) / 64.0).astype(np.float32),
        "label": label,
        "mask": (rng.random(ROWS) < 0.9).astype(np.float32),
    }


CASES = {
    "least_squares": dict(residual="least_squares", step_size=0.002),
    "logistic": dict(residual="logistic", step_size=0.1),
    "gram": dict(residual="least_squares", step_size=0.002, use_sparse=True, use_gram=True,
                 l2_reg=0.1),
    # the JAX dual loop draws ONE mask over the global rows (the unfolded key)
    "gram_sampled": dict(residual="least_squares", step_size=0.002, use_sparse=True,
                         use_gram=True, l2_reg=0.1, mini_batch_fraction=0.5),
    # bfloat16 weights sent to the Gram route, as the JAX step sends them
    "gram_bfloat16": dict(residual="least_squares", step_size=0.002, use_sparse=True,
                          use_gram=True, l2_reg=0.1, dtype="bfloat16"),
}


@pytest.mark.parametrize("case", CASES)
def test_world_size_2_matches_the_jax_mesh_model(tmp_path, case):
    opts = dict(CASES[case])
    residual = opts.pop("residual")
    data = global_batch(7, binary=residual == "logistic")
    npz = tmp_path / "batch.npz"
    np.savez(npz, **data)
    kw = dict(num_text_features=F_TEXT, num_iterations=20, **opts)
    results = run_worker_group("parallel", [str(npz), json.dumps(
        dict(kw, wire="host", steps=2, residual=residual))], timeout=180)
    recs = []
    for rc, out, err in results:
        assert rc == 0, err[-3000:]
        recs.append(last_json(out))
    learner = JaxLogistic if residual == "logistic" else JaxLinear
    mesh = jax_make_mesh(num_data=2, devices=jax.devices()[:2])
    jax_kw = dict(kw, dtype=jnp.dtype(kw["dtype"])) if "dtype" in kw else kw
    ref = JaxParallel(mesh, residual_fn=learner.residual_fn, prediction_fn=learner.prediction_fn,
                      round_predictions=learner.round_predictions, **jax_kw)
    batch = JaxFeatureBatch(**data)
    for _ in range(2):
        out = ref.step(batch)
    assert recs[0]["weights"] == recs[1]["weights"]  # every rank the same bits
    # bfloat16 within 2**-7, two units of its 8-bit mantissa (the port's
    # bfloat16 tolerance, tests/test_torch_sampling.py BF16_RTOL)
    rtol = 2.0**-7 if kw.get("dtype") == "bfloat16" else 1e-5
    np.testing.assert_allclose(recs[0]["weights"], np.asarray(ref.latest_weights, np.float32),
                               rtol=rtol, atol=1e-7)
    for rec in recs:
        assert rec["count"] == float(out.count)
        for k in ("mse", "real_stdev", "pred_stdev"):
            scale = 100 if residual == "logistic" else 1  # the logistic app's percent
            assert round_half_up(rec[k] * scale) == round_half_up(float(getattr(out, k)) * scale)
    if case.startswith("gram"):
        assert recs[0]["route"] == "gram"


@pytest.mark.parametrize("residual", [fused_sgd.least_squares_residual,
                                      fused_sgd.logistic_residual])
def test_split_twin_at_world_size_1_is_the_fused_twin(residual):
    rng = torch.Generator().manual_seed(3)
    x = torch.randint(0, 3, (40, 20), generator=rng).float()
    y = torch.rand(40, generator=rng) * (1 if residual is fused_sgd.logistic_residual else 300)
    m = (torch.rand(40, generator=rng) < 0.8).float()
    w0 = torch.randn(20, generator=rng) * 1e-3
    kw = dict(num_iterations=30, step_size=0.001, l2_reg=0.01, residual_fn=residual)
    w, preds = fused_sgd.fused_dense_sgd_split(x, y, m, w0, allreduce=lambda t: t, **kw)
    w_ref, preds_ref = fused_sgd.fused_dense_sgd_reference(x, y, m, w0, **kw)
    np.testing.assert_allclose(w.numpy(), w_ref.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(preds.numpy(), preds_ref.numpy(), rtol=1e-6, atol=1e-6)


def test_split_twin_makes_no_update_at_count_0():
    x, y, m, w0 = torch.ones(8, 12), torch.ones(8), torch.zeros(8), torch.full((12,), 0.5)
    w, _ = fused_sgd.fused_dense_sgd_split(x, y, m, w0, allreduce=lambda t: t,
                                           num_iterations=10, step_size=0.1)
    assert torch.equal(w, w0)


@pytest.mark.parametrize("count", [2, 3])
def test_sharded_sources_give_the_jax_row_sets(count):
    def ids(source):
        return [s.id for s in source.produce()]

    for index in range(count):
        ours = ids(ShardedSource(SyntheticSource(total=50, seed=4, base_ms=1), index, count))
        theirs = ids(JaxSharded(JaxSynthetic(total=50, seed=4, base_ms=1), index, count))
        assert ours == theirs and ours
        ours = ids(IdShardedSource(SyntheticSource(total=50, seed=4, base_ms=1), index, count))
        theirs = ids(JaxIdSharded(JaxSynthetic(total=50, seed=4, base_ms=1), index, count))
        assert ours == theirs


@pytest.mark.parametrize("device,hosts,want", [
    ("cpu", [("a", 0), ("a", 0)], "gloo"),
    ("cuda", [("a", 1), ("a", 1)], "gloo"),  # two ranks share one card
    ("cuda", [("a", 2), ("a", 2)], "nccl"),
    ("cuda", [("a", 1), ("b", 1)], "nccl"),
    ("cuda", [("a", 4), ("a", 4), ("b", 1), ("b", 1)], "gloo"),
])
def test_the_backend_rule(device, hosts, want):
    assert distributed.choose_backend(device, hosts) == want


def test_the_data_axis_and_the_model_axis():
    m = make_mesh(num_processes=4, process_index=2)
    assert (m.num_data, m.process_index, m.axis_name) == (4, 2, "data")
    # the JAX layout arr.reshape(num_data, num_model) over process-major ranks
    m = make_mesh(num_data=2, num_model=2, num_processes=4, process_index=3)
    assert (m.num_data, m.num_model, m.data_index, m.model_index) == (2, 2, 1, 1)
    assert m.axis_names == ("data", "model")
    assert m.axis_ranks("model") == [2, 3] and m.axis_ranks("data") == [1, 3]
    grid = np.arange(6).reshape(3, 2)
    for r in range(6):
        m = make_mesh(num_model=2, num_processes=6, process_index=r)
        assert grid[m.data_index, m.model_index] == r
    with pytest.raises(ValueError):
        make_mesh(num_data=3, num_processes=2)
    with pytest.raises(ValueError):
        make_mesh(num_data=2, num_model=2, num_processes=6)
