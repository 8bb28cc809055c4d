"""The feature-sharded 2D layout on the CPU: the port's ``ParallelSGDModel``
on a ``('data', 'model')`` mesh of gloo processes (tests/torch_mesh_worker.py,
each rank on its data shard's rows and its slice of the text features)
against the JAX ``ParallelSGDModel`` on the same mesh of virtual CPU devices
(``make_mesh(num_data, num_model)``, as tests/test_parallel.py runs it), on
the same global batches: weights within rtol 1e-4 / atol 1e-6, the mse
within 1e-4 relative, predictions within 1e-4 (the JAX package's tolerances
against one device). The Gram and scatter routes, the logistic residual,
``-b 0.5`` on both routes, bfloat16 weights on the Gram route (within
2**-7), a 64-row 2^18 unit batch of ASCII text and one of mixed ASCII and
CJK text (whose bigrams reach both feature slices), the checkpoint round
trip (bitwise) and the indivisible-features ``ValueError``. One group run a
configuration (module-scoped)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_group import run_mesh_group

from twtml_tpu.features.batch import FeatureBatch as JaxFeatureBatch
from twtml_tpu.features.batch import UnitBatch as JaxUnitBatch
from twtml_tpu.models.logistic import StreamingLogisticRegressionWithSGD as JaxLogistic
from twtml_tpu.parallel import ParallelSGDModel as JaxParallel
from twtml_tpu.parallel import make_mesh as jax_make_mesh
from twtml_tpu_torch.parallel.mesh import make_mesh
from twtml_tpu_torch.parallel.sharding import ParallelSGDModel

F_TEXT = 64
ROWS = 32
STEPS = 3
NOW_MS = 1785320000000


def _batch(rng, binary: bool = False) -> dict:
    """The JAX test's batch (tests/test_parallel.py ``make_batch``): 30 valid
    rows of 32, 8 tokens a row."""
    idx = rng.integers(0, F_TEXT, (ROWS, 8)).astype(np.int32)
    val = rng.integers(1, 3, (ROWS, 8)).astype(np.float32)
    numeric = rng.normal(size=(ROWS, 4)).astype(np.float32) * 0.1
    label = rng.uniform(50, 900, ROWS).astype(np.float32)
    if binary:
        label = (label > 400).astype(np.float32)
    mask = (np.arange(ROWS) < 30).astype(np.float32)
    for a in (idx, val, numeric, label):
        a[30:] = 0
    return dict(token_idx=idx, token_val=val, numeric=numeric, label=label, mask=mask)


# configuration -> (mesh (num_data, num_model), the model's arguments, residual)
CONFIGS = {
    "gram_2x2": ((2, 2), dict(num_iterations=30, step_size=0.005), ""),
    "gram_1x2": ((1, 2), dict(num_iterations=30, step_size=0.005), ""),
    "scatter_2x2": ((2, 2), dict(num_iterations=30, step_size=0.005, use_gram=False), ""),
    "logistic_2x2": ((2, 2), dict(num_iterations=20, step_size=0.1), "logistic"),
    "gram_sampled_2x2": ((2, 2), dict(num_iterations=30, step_size=0.005,
                                      mini_batch_fraction=0.5), ""),
    "scatter_sampled_2x2": ((2, 2), dict(num_iterations=30, step_size=0.005,
                                         mini_batch_fraction=0.5, use_gram=False), ""),
    # bfloat16 weights sent to the Gram route, as the JAX step sends them
    "gram_bfloat16_2x2": ((2, 2), dict(num_iterations=30, step_size=0.005, use_gram=True,
                                       dtype="bfloat16"), ""),
}


_RUNS: dict = {}


def _config_run(name: str, tmp_path_factory):
    """One configuration's group run (once a module): the group's records
    and arrays, and the JAX model's weights, mse and predictions after each
    of the STEPS batches. ``gram_2x2`` also makes the checkpoint round
    trip."""
    if name in _RUNS:
        return _RUNS[name]
    (nd, nm), kw, residual = CONFIGS[name]
    kw = dict(kw, num_text_features=F_TEXT)
    rng = np.random.default_rng(21)
    batches = [_batch(rng, binary=residual == "logistic") for _ in range(STEPS)]
    out = tmp_path_factory.mktemp(name)
    np.savez(out / "batches.npz", **{k: np.stack([b[k] for b in batches]) for k in batches[0]})
    recs, arrays = run_mesh_group("sgd", dict(
        batches=str(out / "batches.npz"), out=str(out), num_data=nd, num_model=nm, model=kw,
        residual=residual, checkpoint=str(out / "ck") if name == "gram_2x2" else None),
        nd * nm)
    learner = dict(residual_fn=JaxLogistic.residual_fn, prediction_fn=JaxLogistic.prediction_fn,
                   round_predictions=JaxLogistic.round_predictions) if residual else {}
    jax_kw = dict(kw, dtype=jnp.dtype(kw["dtype"])) if "dtype" in kw else kw
    ref = JaxParallel(jax_make_mesh(num_data=nd, num_model=nm, devices=jax.devices()[:nd * nm]),
                      **jax_kw, **learner)
    want = []
    for b in batches:
        o = ref.step(JaxFeatureBatch(**b))
        want.append((np.asarray(ref.latest_weights, np.float32), float(o.mse),
                     np.asarray(o.predictions, np.float32)))
    _RUNS[name] = (name, (nd, nm), recs, arrays, want)
    return _RUNS[name]


@pytest.fixture(params=list(CONFIGS))
def run(request, tmp_path_factory):
    return _config_run(request.param, tmp_path_factory)


def test_the_mesh_step_matches_the_jax_mesh_model(run):
    name, (nd, nm), recs, arrays, want = run
    route = "scatter" if "scatter" in name else "gram"
    # bfloat16 within 2**-7, two units of its 8-bit mantissa (the port's
    # bfloat16 tolerance, tests/test_torch_sampling.py BF16_RTOL), of each
    # weight or of the weights' scale (a bfloat16 sum's rounding in the
    # write-back is the scale's)
    bf16 = "bfloat16" in name
    rtol = 2.0**-7 if bf16 else 1e-4
    for rank, (rec, arr) in enumerate(zip(recs, arrays)):
        assert rec["route"] == route
        assert (rec["data_index"], rec["model_index"]) == (rank // nm, rank % nm)
        # every rank gathers the same whole weights
        np.testing.assert_array_equal(arr["w"], arrays[0]["w"])
        for k, (w, mse, preds) in enumerate(want):
            d = rec["data_index"]
            rows = ROWS // nd
            atol = 2.0**-7 * float(np.max(np.abs(w))) if bf16 else 1e-6
            np.testing.assert_allclose(arr["w"][k], w, rtol=rtol, atol=atol)
            assert rec["stats"][k]["mse"] == pytest.approx(mse, rel=rtol)
            np.testing.assert_allclose(arr["preds"][k], preds[d * rows:(d + 1) * rows],
                                       atol=1e-4)


def test_each_axis_counts_its_own_collectives(run):
    """The Gram route: per step 2 data all-reduces (stats, write-back), 2
    data all-gathers (rows, G) and 3 model all-reduces (margins, panel,
    ||W||²); the scatter route 3 reductions an iteration (margins and norms
    over model, gradient and count over data). Axes of one rank issue
    none."""
    name, (nd, nm), recs, _arrays, _want = run
    n = CONFIGS[name][1]["num_iterations"]
    trip = name == "gram_2x2"  # the round trip: two steps, three gathers, one barrier
    steps = STEPS + 2 if trip else STEPS
    for rec in recs:
        c = rec["collectives"]
        assert c["allreduces"] == (1 if trip else 0)
        if "scatter" in name:
            want = {"data_allreduces": steps * (n + 1), "data_row_allgathers": 0,
                    "model_allreduces": steps * (2 * n + 1)}
        else:
            want = {"data_allreduces": steps * 2, "data_row_allgathers": steps * 2,
                    "model_allreduces": steps * 3}
        if nd == 1:
            want.update(data_allreduces=0, data_row_allgathers=0)
        assert {k: c[k] for k in want} == want
        assert c["model_row_allgathers"] == STEPS + (3 if trip else 0)


def test_a_checkpoint_round_trip_resumes_bitwise(tmp_path_factory):
    """On 2 x 2: the gathered weights saved by the lead and restored into a
    fresh model on every rank: its next step is bitwise the uninterrupted
    model's."""
    _name, _mesh, _recs, arrays, _want = _config_run("gram_2x2", tmp_path_factory)
    for arr in arrays:
        np.testing.assert_array_equal(arr["resumed"], arr["uninterrupted"])
        np.testing.assert_array_equal(arr["resumed"], arrays[0]["resumed"])


def test_the_2e18_unit_batch_matches_the_jax_mesh_model(tmp_path):
    """BASELINE config #4 at full width on a 2 x 2 mesh, fed the default wire's
    units (device hashing): the counterpart of the JAX package's
    ``test_feature_sharded_2e18_unit_batch``."""
    from twtml_tpu.features.featurizer import Featurizer
    from twtml_tpu.streaming.sources import SyntheticSource

    statuses = list(SyntheticSource(total=64, seed=3, base_ms=NOW_MS).produce())
    feat = Featurizer(num_text_features=2**18, now_ms=NOW_MS)
    batch = feat.featurize_batch_units(statuses, row_bucket=64, pre_filtered=True)
    np.savez(tmp_path / "batches.npz", **{f: np.asarray(getattr(batch, f))[None]
                                          for f in JaxUnitBatch._fields})
    kw = dict(num_text_features=2**18, num_iterations=5, step_size=0.005)
    recs, arrays = run_mesh_group("sgd", dict(batches=str(tmp_path / "batches.npz"),
                                              out=str(tmp_path), num_data=2, num_model=2,
                                              wire="unit", model=kw), 4)
    ref = JaxParallel(jax_make_mesh(num_data=2, num_model=2, devices=jax.devices()[:4]), **kw)
    out = ref.step(batch)
    for rec, arr in zip(recs, arrays):
        assert rec["route"] == "gram"
        assert rec["stats"][0]["mse"] == pytest.approx(float(out.mse), rel=1e-4)
        np.testing.assert_allclose(arr["w"][0], np.asarray(ref.latest_weights), rtol=1e-4,
                                   atol=1e-7)


def _mixed_statuses(rows: int, seed: int) -> list:
    """``rows`` retweets of ASCII and CJK words: the bigrams of an ASCII
    text all hash below 4,064 (``31·c₁ + c₂``), so at 2^18 only a text of
    wider code units reaches the second half of the features."""
    from twtml_tpu.features.featurizer import Status

    rng = np.random.default_rng(seed)
    ascii_ = list("abcdefghijklmnopqrstuvwxyz0123456789")
    out = []
    for i in range(rows):
        words = []
        for _ in range(int(rng.integers(3, 9))):
            n = int(rng.integers(2, 6))
            if rng.random() < 0.5:
                words.append("".join(rng.choice(ascii_, n)))
            else:
                words.append("".join(chr(int(c)) for c in rng.integers(0x4E00, 0xA000, n)))
        text = " ".join(words)
        original = Status(text=text, retweet_count=int(100 + 2 * len(text) + i),
                          followers_count=int(rng.integers(100, 2_000_000)),
                          created_at_ms=NOW_MS - int(rng.integers(0, 86_400_000)))
        out.append(Status(text="RT " + text, retweeted_status=original))
    return out


def test_a_2e18_batch_of_cjk_text_reaches_both_slices(tmp_path):
    """As above on text whose bigrams land in both halves of the 2^18
    features, so both model shards build a non-zero panel and G sums two."""
    from twtml_tpu.features.featurizer import Featurizer

    feat = Featurizer(num_text_features=2**18, now_ms=NOW_MS)
    batch = feat.featurize_batch_units(_mixed_statuses(64, 5), row_bucket=64,
                                       pre_filtered=True)
    units = np.asarray(batch.units).astype(np.int64) & 0xFFFF
    h = (31 * units[:, :-1] + units[:, 1:]) % 2**18
    valid = np.arange(h.shape[1])[None, :] < (np.asarray(batch.length)[:, None] - 1)
    assert np.sum(valid & (h >= 2**17)) > 0 and np.sum(valid & (h < 2**17)) > 0
    np.savez(tmp_path / "batches.npz", **{f: np.asarray(getattr(batch, f))[None]
                                          for f in JaxUnitBatch._fields})
    kw = dict(num_text_features=2**18, num_iterations=5, step_size=0.005)
    recs, arrays = run_mesh_group("sgd", dict(batches=str(tmp_path / "batches.npz"),
                                              out=str(tmp_path), num_data=2, num_model=2,
                                              wire="unit", model=kw), 4)
    ref = JaxParallel(jax_make_mesh(num_data=2, num_model=2, devices=jax.devices()[:4]), **kw)
    out = ref.step(batch)
    want = np.asarray(ref.latest_weights)
    assert np.any(want[2**17:2**18] != 0) and np.any(want[:2**17] != 0)
    for rec, arr in zip(recs, arrays):
        assert rec["route"] == "gram"
        assert rec["stats"][0]["mse"] == pytest.approx(float(out.mse), rel=1e-4)
        np.testing.assert_allclose(arr["w"][0], want, rtol=1e-4, atol=1e-7)


def test_indivisible_features_raise():
    with pytest.raises(ValueError, match="not divisible"):
        ParallelSGDModel(make_mesh(num_data=2, num_model=4, num_processes=8), None,
                         num_text_features=30, device="cpu")
