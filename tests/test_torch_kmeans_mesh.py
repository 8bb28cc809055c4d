"""K-means across hosts on the CPU: the port's ``StreamingKMeans(mesh=,
group=)`` in two gloo processes (tests/torch_mesh_worker.py), each on its
shard of the global batches, against the JAX ``StreamingKMeans`` on
``make_mesh(num_data=2)``'s virtual CPU devices (tests/test_parallel.py's
``test_kmeans_mesh_matches_single_device`` data): assignments equal,
centers within rtol 1e-5 / atol 1e-7, cluster weights within rtol 1e-5;
indivisible rows raise as in the JAX package; and the k-means app in a
2-rank group against the JAX app's single-process lines on the same replay
(the JAX package's ``test_app_level_multihost_kmeans_lockstep``): count,
batch and sizes exact, the printed centers within its rule, the follower
silent; without ``--batchBucket`` the group exits with the JAX app's
message."""

from __future__ import annotations

import re

import jax
import numpy as np
import pytest
from torch_group import (
    common_args,
    run_jax_single,
    run_mesh_group,
    run_torch_group,
    stat_lines,
    write_replay,
)

from twtml_tpu.models.kmeans import StreamingKMeans as JaxKMeans
from twtml_tpu.parallel import make_mesh as jax_make_mesh
from twtml_tpu_torch.models.kmeans import StreamingKMeans
from twtml_tpu_torch.parallel.distributed import Collectives
from twtml_tpu_torch.parallel.mesh import make_mesh


def test_the_mesh_model_matches_the_jax_mesh_model(tmp_path):
    rng = np.random.default_rng(21)
    points = (rng.normal(size=(4, 64, 2)) * [1.0, 5.0]).astype(np.float32)
    mask = np.ones((4, 64), np.float32)
    mask[:, 60:] = 0.0
    np.savez(tmp_path / "points.npz", points=points, mask=mask)
    _recs, arrays = run_mesh_group("kmeans", dict(batches=str(tmp_path / "points.npz"),
                                                  out=str(tmp_path), num_data=2), 2)
    ref = (JaxKMeans(mesh=jax_make_mesh(num_data=2, devices=jax.devices()[:2])).set_k(3)
           .set_half_life(5, "batches").set_random_centers(2, 0.0))
    want = np.stack([ref.update(p, m) for p, m in zip(points, mask)])
    np.testing.assert_array_equal(np.concatenate([a["assign"] for a in arrays], axis=1), want)
    for a in arrays:
        np.testing.assert_allclose(a["centers"], ref.latest_centers, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(a["weights"], np.asarray(ref.cluster_weights), rtol=1e-5)


def test_indivisible_rows_raise():
    km = StreamingKMeans(mesh=make_mesh(num_processes=8), group=Collectives(),
                         device="cpu").set_k(2)
    km.set_random_centers(2, 0.0)
    with pytest.raises(ValueError, match="not divisible"):
        km.update(np.zeros((12, 2), np.float32))


def _numbers(line: str) -> list:
    return [float(x) for x in re.findall(r"-?\d+\.?\d*", line)]


def test_the_group_app_prints_the_jax_apps_lines(tmp_path):
    path = write_replay(tmp_path / "tweets.jsonl", 96, 6)
    common = common_args(path)
    ref = stat_lines(run_jax_single(common + ["--batchBucket", "32"], app="kmeans"))
    results = run_torch_group(common + ["--batchBucket", "16"], app="kmeans")
    for rc, _out, err in results:
        assert rc == 0, err[-3000:]
    lead, follower = (stat_lines(out) for _rc, out, _err in results)
    assert follower == [] and len(lead) == len(ref) >= 2
    for got, want in zip(lead, ref):
        g, w = _numbers(got), _numbers(want)
        assert g[:2] == w[:2] and g[-3:] == w[-3:], (got, want)  # count, batch, sizes
        assert len(g) == len(w)
        for a, b in zip(g[2:-3], w[2:-3]):
            assert abs(a - b) <= max(0.02, 0.02 * abs(b)), (got, want)


def test_the_group_app_needs_a_batch_bucket(tmp_path):
    results = run_torch_group(common_args(write_replay(tmp_path / "tweets.jsonl", 8, 6)),
                              app="kmeans", timeout=120)
    for rc, _out, err in results:
        assert rc != 0 and "multi-host k-means needs --batchBucket" in err, err[-2000:]
