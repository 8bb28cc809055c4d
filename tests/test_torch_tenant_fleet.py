"""The tenant fleet on the CPU: ``--tenants M`` in a lockstep group of two
gloo processes of the port's linear app (``MultiHostTenantModel``), held
against the JAX app's single-process tenant run of the same replay with the
rule of the JAX package's ``test_tenant_fleet_two_process_matches_single_
process``: as many lines, count and batch exact, the other integers within
2, the checkpointed [M, F+4] stacks within rtol 1e-4 / atol 1e-7. Each
rank fetches once a tick and agrees its tenant wire's bucket with one
all-gather. The tenant stack over a mesh at the library level
(tests/torch_mesh_worker.py): tenants on a (1, 2) model axis are the
one-process stack bit for bit, with no collective inside a tick; tenants on
a 2-rank data axis within rtol 1e-4. Under ``--elastic on`` a killed
follower shrinks the fleet and the survivor's stack continues bitwise as a
world-1 run from the archive it restored."""

from __future__ import annotations

import re

import numpy as np
import pytest
from test_torch_elastic import NOW_MS, RESYNC, _Keeper, _args, _group, _stat_lines, _statuses
from torch_group import (
    assert_lines_match,
    common_args,
    last_json,
    run_jax_single,
    run_mesh_group,
    run_worker_group,
    stat_lines,
    write_replay,
)

from twtml_tpu.checkpoint import Checkpointer as JaxCheckpointer
from twtml_tpu_torch.apps.common import state_checksum
from twtml_tpu_torch.checkpoint import Checkpointer
from twtml_tpu_torch.features.batch import FeatureBatch
from twtml_tpu_torch.features.featurizer import Featurizer
from twtml_tpu_torch.parallel.distributed import Collectives
from twtml_tpu_torch.parallel.mesh import make_mesh
from twtml_tpu_torch.parallel.tenants import MultiHostTenantModel, TenantStackModel

F_TEXT = 64
ROWS = 32


@pytest.mark.parametrize("wire", [["--wire", "padded"], []], ids=["padded", "ragged"])
def test_the_fleet_app_matches_the_jax_single_process_tenant_run(tmp_path, wire):
    path = write_replay(tmp_path / "tweets.jsonl", 128, 11)
    common = common_args(path, "--tenants", "2", *wire)
    env = {"TWTML_NOW_MS": str(NOW_MS)}
    d_jax, d_multi = str(tmp_path / "ck_jax"), str(tmp_path / "ck_multi")
    ref = stat_lines(run_jax_single(common + ["--batchBucket", "32", "--checkpointDir", d_jax],
                                    env=env))
    results = run_worker_group("app", common + ["--batchBucket", "16", "--checkpointDir",
                                                d_multi], env=env)
    recs = []
    for rc, out, err in results:
        assert rc == 0, err[-3000:]
        recs.append(last_json(out))
    lead, follower = (stat_lines(out) for _rc, out, _err in results)
    assert follower == [] and len(ref) >= 3
    assert_lines_match(lead, ref)
    w_multi, meta_m = Checkpointer(d_multi).restore()
    w_jax, meta_j = JaxCheckpointer(d_jax).restore()
    assert meta_m["count"] == meta_j["count"] == 128
    assert np.asarray(w_multi).shape == np.asarray(w_jax).shape == (2, 1004)
    np.testing.assert_allclose(np.asarray(w_multi), np.asarray(w_jax), rtol=1e-4, atol=1e-7)
    for rec in recs:
        ticks = rec["batches"]
        c = rec["collectives"]
        # one fetch a tick; on the ragged wire one bucket agreement a
        # dispatch (the warm-up's too)
        assert rec["counters"]["fetch.count"] == ticks
        assert c["align_allgathers"] == (0 if wire else ticks + 1)
        # each tenant's data-parallel step: 50 iterations, the stats, the quality
        assert c["allreduces"] == 2 * 52 * (ticks + 1)


def _batches(seed: int, k: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    out = {
        "token_idx": rng.integers(0, F_TEXT, (k, ROWS, 8)).astype(np.int32),
        "token_val": rng.integers(1, 3, (k, ROWS, 8)).astype(np.float32),
        "numeric": (rng.integers(-64, 64, (k, ROWS, 4)) / 64.0).astype(np.float32),
        "label": rng.uniform(50, 900, (k, ROWS)).astype(np.float32),
        "mask": (rng.random((k, ROWS)) < 0.9).astype(np.float32),
    }
    return out


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1)], ids=["model_axis", "data_axis"])
def test_tenants_over_a_mesh_match_the_one_process_stack(tmp_path, mesh):
    nd, nm = mesh
    data = _batches(5)
    np.savez(tmp_path / "batches.npz", **data)
    kw = dict(num_text_features=F_TEXT, num_iterations=30, step_size=0.005)
    recs, arrays = run_mesh_group("tenants", dict(
        batches=str(tmp_path / "batches.npz"), out=str(tmp_path), num_data=nd, num_model=nm,
        num_tenants=2, model=kw), nd * nm)
    single = TenantStackModel(2, device="cpu", **kw)
    counts = np.stack([
        single.step(FeatureBatch(*(data[f][i] for f in FeatureBatch._fields))).count.numpy()
        for i in range(3)])
    want = single.latest_weights
    for rank, (rec, arr) in enumerate(zip(recs, arrays)):
        c = rec["collectives"]
        if nm > 1:
            # rank m holds and trains tenant m; no collective inside a tick
            assert rec["tenants"] == [rank, 1]
            np.testing.assert_array_equal(arr["w"], want)
            np.testing.assert_array_equal(arr["counts"][:, 0], counts[:, rank])
            assert c["model_allreduces"] == c["data_allreduces"] == c["allreduces"] == 0
            assert c["model_row_allgathers"] == 1  # latest_weights
        else:
            assert rec["tenants"] == [0, 2]
            np.testing.assert_allclose(arr["w"], want, rtol=1e-4, atol=1e-7)
            # each tenant's data-parallel step: 30 iterations and the stats
            assert c["allreduces"] == 3 * 2 * 31


def test_an_elastic_fleet_survivor_continues_bitwise_from_its_archive(tmp_path):
    """``--elastic on --tenants 4``, ``peer.kill`` on uid 1 at tick 4: uid 0
    shrinks to epoch 1 alone, restores the step-3 stack (count 96) and trains
    its remaining rows; its final [4, F+4] stack is bitwise a world-1 fleet's
    from that archive over host 0's rows 48 on."""
    path = write_replay(tmp_path / "tweets.jsonl", 200, 5)
    ck = tmp_path / "ck"
    keeper = _Keeper(ck, tmp_path / "archives")
    args = _args(path, ck, "--checkpointEvery", "1", "--tenants", "4")
    try:
        (rc0, out0, err0), (rc1, _out1, err1) = _group(
            args, args + ["--chaos", "peer.kill:uid=1:tick=4"])
    finally:
        keeper.stop()
    assert rc1 == 77, err1[-2000:]
    assert rc0 == 0, err0[-4000:]
    assert "elastic epoch 1 formed: 1 host(s) [0]" in err0
    resync = re.search(RESYNC, err0)
    assert resync and (int(resync.group(1)), int(resync.group(2))) == (96, 3), err0[-3000:]
    state3, _meta = Checkpointer(str(tmp_path / "archives")).restore(step=3)
    assert resync.group(3) == state_checksum(state3)
    assert int(re.findall(r"count: (\d+)", _stat_lines(out0)[-1])[0]) == 148
    final, meta = Checkpointer(str(ck)).restore()
    assert meta["count"] == 148 and np.asarray(final).shape == (4, 1004)
    mesh = make_mesh(num_processes=1)
    clean = MultiHostTenantModel(TenantStackModel(4, mesh=mesh, group=Collectives(),
                                                  device="cpu", step_size=0.005), mesh)
    clean.set_initial_weights(state3)
    rows = _statuses(path)[0::2][48:]
    feat = Featurizer(now_ms=NOW_MS)
    for lo in range(0, len(rows), 16):
        batch = feat.featurize_batch_ragged(rows[lo:lo + 16], row_bucket=16, unit_bucket=64)
        clean.step(clean.pack_for_wire(batch))
    np.testing.assert_array_equal(np.asarray(final), clean.latest_weights)
    assert last_json(out0)["counters"]["elastic.hosts_departed"] == 1
