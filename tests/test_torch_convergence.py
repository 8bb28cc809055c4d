"""The port's learning-quality oracle on an analytically known stream
(``tests/test_convergence.py``'s first three tests, on the CPU), each also
held against the JAX package's curve on the same seeded tweets.

- The text-driven stream: labels ~ a + b*len(text), which the hashed
  bigram counts can express, so streaming SGD with progressive validation
  drives the per-batch RMSE from the label scale toward the noise floor.
- The featurization ceiling: follower-driven label variance is invisible
  through the reference's x1e-12 numeric features, so the RMSE plateaus
  at that component's scale.
- ``MultiSource``: four synthetic shards feed one stream, every tweet
  delivered once.

The port featurizes on the units wire (hashing on the device), which gives
the JAX package's host-hashed features bit for bit; the curves agree within
CURVE_RTOL (the port's default step stores X in bf16, the JAX package's in
f32). ``test_convergence.py``'s fourth test: the object and block ingest
modes give one curve from one file.
"""

import time

import numpy as np

from twtml_tpu.features.featurizer import Featurizer as JaxFeaturizer
from twtml_tpu.features.featurizer import Status as JaxStatus
from twtml_tpu.models import StreamingLinearRegressionWithSGD as JaxLinear
from twtml_tpu.streaming.sources import MultiSource as JaxMultiSource
from twtml_tpu.streaming.sources import SyntheticSource as JaxSynthetic
from twtml_tpu_torch.features.featurizer import Featurizer, Status
from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
from twtml_tpu_torch.streaming.sources import MultiSource, SyntheticSource

WORDS = "tpu stream learn fast jax mesh shard grad psum tweet".split()
NOW_MS = 1785320000000
# the per-batch RMSE curves of the two packages, relative
CURVE_RTOL = 1e-3


def text_only_statuses(status_cls, n_batches=24, batch=512, seed=5, noise=5.0):
    """The stream of tests/test_convergence.py: the same numpy draws, as
    ``status_cls`` objects."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        chunk = []
        for _ in range(batch):
            text = " ".join(rng.choice(WORDS, size=int(rng.integers(3, 12))))
            label = 100 + 2 * len(text) + rng.normal(0, noise)
            chunk.append(status_cls(
                text="RT " + text,
                retweeted_status=status_cls(text=text, retweet_count=int(max(label, 0))),
            ))
        out.append(chunk)
    return out


def port_curve(chunks, row_bucket):
    model = StreamingLinearRegressionWithSGD(device="cpu", step_size=0.1, num_iterations=50)
    feat = Featurizer(now_ms=NOW_MS)
    return [float(model.step(feat.featurize_batch_units(c, row_bucket=row_bucket)).mse) ** 0.5
            for c in chunks]


def jax_curve(chunks, row_bucket):
    model = JaxLinear(step_size=0.1, num_iterations=50)
    feat = JaxFeaturizer(now_ms=NOW_MS)
    return [float(model.step(feat.featurize_batch(c, row_bucket=row_bucket,
                                                  pre_filtered=True)).mse) ** 0.5
            for c in chunks]


def test_rmse_converges_toward_noise_floor():
    rmses = port_curve(text_only_statuses(Status), 512)
    # progressive validation: the first batch is scored with zero weights
    # (RMSE at the label scale), the last ones near the noise floor (5)
    assert rmses[0] > 150
    assert np.mean(rmses[-4:]) < 30
    assert np.mean(rmses[-4:]) < rmses[0] / 5
    np.testing.assert_allclose(rmses, jax_curve(text_only_statuses(JaxStatus), 512),
                               rtol=CURVE_RTOL)


def test_featurization_ceiling_is_faithful():
    """Follower-driven label variance cannot be learned through the
    x1e-12-scaled numeric features: the RMSE plateaus at that component's
    scale, far above the noise floor."""
    ours = list(SyntheticSource(total=8 * 512, seed=5, base_ms=NOW_MS).produce())
    ref = list(JaxSynthetic(total=8 * 512, seed=5, base_ms=NOW_MS).produce())
    rmses = port_curve([ours[k * 512:(k + 1) * 512] for k in range(8)], 512)
    assert 150 < rmses[-1] < 400
    np.testing.assert_allclose(
        rmses, jax_curve([ref[k * 512:(k + 1) * 512] for k in range(8)], 512), rtol=CURVE_RTOL)


def _drain(multi, timeout_s=10.0):
    got = []
    multi.start(got.append)
    deadline = time.time() + timeout_s
    while not multi.exhausted and time.time() < deadline:
        time.sleep(0.01)
    multi.stop()
    return got


def test_sharded_receivers_feed_one_stream():
    multi = MultiSource([SyntheticSource(total=25, seed=s, base_ms=NOW_MS) for s in range(4)])
    got = _drain(multi)
    assert multi.exhausted
    assert len(got) == 100  # 4 shards x 25 tweets, all delivered
    ref = _drain(JaxMultiSource([JaxSynthetic(total=25, seed=s, base_ms=NOW_MS)
                                 for s in range(4)]))
    key = lambda s: (s.id, s.text, s.retweeted_status.retweet_count)  # noqa: E731
    assert sorted(map(key, got)) == sorted(map(key, ref))
    assert [key(s) for s in multi.produce()] == [
        key(s) for src in multi.sources for s in src.produce()]


def test_rmse_curve_identical_across_ingest_modes(tmp_path):
    """Eight micro-batches from a FILE, weights carried across batches: the
    object path and the native block path give the SAME per-batch MSE curve
    (bitwise here: the same batches), and it is the JAX package's block
    curve within CURVE_RTOL."""
    import json

    from tools.bench_suite import _status_json
    from twtml_tpu.features.blocks import merge_blocks as jax_merge
    from twtml_tpu.streaming.sources import BlockReplayFileSource as JaxBlockReplay
    from twtml_tpu_torch.features.blocks import merge_blocks, slice_block
    from twtml_tpu_torch.streaming.sources import BlockReplayFileSource

    statuses = list(SyntheticSource(total=2048, seed=11, base_ms=NOW_MS).produce())
    path = tmp_path / "stream.jsonl"
    with open(path, "w") as fh:
        for s in statuses:
            fh.write(json.dumps(_status_json(s)) + "\n")
    feat, b = Featurizer(now_ms=NOW_MS), 256

    def curve(batches):
        model = StreamingLinearRegressionWithSGD(device="cpu", num_iterations=10)
        return [float(model.step(x).mse) for x in batches]

    curve_o = curve(feat.featurize_batch_units(statuses[i:i + b], row_bucket=b, unit_bucket=64)
                    for i in range(0, 2048, b))
    block = merge_blocks(list(BlockReplayFileSource(str(path), wire=True).produce()))
    assert block.rows == 2048
    curve_b = curve(feat.featurize_parsed_block(slice_block(block, i, i + b), row_bucket=b,
                                                unit_bucket=64) for i in range(0, 2048, b))
    assert len(curve_o) == 8
    np.testing.assert_array_equal(curve_o, curve_b)
    assert curve_o[-1] < curve_o[0]  # it learns along the curve
    jblock = jax_merge(list(JaxBlockReplay(str(path)).produce()))
    jfeat, jmodel = JaxFeaturizer(now_ms=NOW_MS), JaxLinear(num_iterations=10)
    jax_b = []
    for i in range(0, 2048, b):
        sub = type(jblock)(jblock.numeric[i:i + b],
                           jblock.units[jblock.offsets[i]:jblock.offsets[i + b]],
                           jblock.offsets[i:i + b + 1] - jblock.offsets[i], jblock.ascii[i:i + b])
        jax_b.append(float(jmodel.step(jfeat.featurize_parsed_block(
            sub, row_bucket=b, unit_bucket=64)).mse))
    np.testing.assert_allclose(curve_b, jax_b, rtol=CURVE_RTOL)
