"""The tenant plane's vmap form on the 2^18 routes over a data axis
(``TenantStackModel(mapping="vmap", mesh=..., group=...)`` in the sparse
regime: ``models/sgd.gram_tenants_parallel`` and the batched scatter loop)
on the CPU, held against the JAX package's vmap inside ``shard_map`` on
``make_mesh(num_data=2)``.

- Two gloo ranks of ``tests/torch_mesh_worker.py`` (one group for every
  run) step the same numpy tenant parts from the same start weights
  (carried across by ``convert.weights_from_jax``) as the JAX vmap, each
  rank on its data shard's rows of every part: the Gram route with
  per-tenant step sizes and L2, logistic, ``-b 0.5``, the quality vector, a
  tenant dry on one rank and one dry on both, a tenant whose fractional row
  sits on one rank only (its gathered rows leave the int8 plane on both
  ranks), the scatter route (least squares and ``-b 0.5``) and one Gram
  case at 2^18 text features. Weights within rtol / atol 1e-3 (the vmap's
  tolerance), counts equal, mse within rtol 1e-6, rounded predictions
  equal on valid rows.
- The collectives a tick: on the Gram route 2 all-gathers (the rows with
  their header, the G panels) and 2 all-reduces (the write-backs, the
  stats; 3 with the quality vector) at M = 2 and M = 4, the scan form M
  times its one-tenant count; on the scatter route N + 1 all-reduces.
- A 2 x 2 mesh (tenants over the model axis, rows over the data axis)
  within 1e-3 of the one-process vmap.
- The plain pieces: the tenant-row all-gather's layout and header, the
  row table's segments and blocks, B4's segments bitwise B4 on the
  compacted rows, the ranks' G panels stacked bitwise one block's G, B8 at
  each rank's rows summed over the ranks the one-process write-back, B7
  with each tenant's own draws each tenant's loop alone.
"""

import datetime
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_group import run_mesh_runs

from twtml_tpu.features.batch import FeatureBatch as JaxFeatureBatch
from twtml_tpu.models.logistic import StreamingLogisticRegressionWithSGD as JaxLogistic
from twtml_tpu.parallel.mesh import make_mesh as jax_make_mesh
from twtml_tpu.parallel.tenants import TenantStackModel as JaxStack
from twtml_tpu_torch.convert import weights_from_jax
from twtml_tpu_torch.features.batch import FeatureBatch, tenant_valid_rows
from twtml_tpu_torch.models.sgd import TenantRowTable
from twtml_tpu_torch.ops import fused_gram
from twtml_tpu_torch.ops.fused_sgd import least_squares_residual
from twtml_tpu_torch.parallel.distributed import Collectives
from twtml_tpu_torch.parallel.tenants import TenantStackModel

F_SMALL = 60
ROWS = 32  # a part's global rows: 16 on each of two data ranks
HALF = ROWS // 2
TICKS = 3
M = 4
N = 12  # iterations a step
VMAP_RTOL = VMAP_ATOL = 1e-3  # the vmap's tolerance (tests/test_torch_tenants_vmap.py)
MSE_RTOL = 1e-6  # float32 sums in another order (tests/test_torch_tenants_vmap.py)
STEP_SIZES = (0.002, 0.004, 0.006, 0.008)
L2_REGS = (0.0, 0.01, 0.1, 0.0)
SPARSE = dict(num_iterations=N, use_sparse=True)

# case -> (the stacks' keywords, the learner, the parts' options)
CASES = {
    "gram_per_tenant_hyperparams": (dict(step_sizes=STEP_SIZES, l2_regs=L2_REGS), "", {}),
    "gram_logistic": (dict(step_size=0.5), "logistic", {}),
    "gram_sampled": (dict(step_size=0.005, mini_batch_fraction=0.5), "", {}),
    "gram_quality": (dict(step_size=0.005, quality=True), "", {}),
    # tenant 1 has rows on rank 0 only; tenant 3 has none on either rank
    "gram_dry_on_one_rank_and_on_both": (dict(step_size=0.005), "",
                                         {"dry": {1: "rank1", 3: "both"}}),
    # tenant 2's fractional row on rank 0: its gathered rows in the exact plane
    "gram_mixed_planes": (dict(step_size=0.005), "", {"fractional": 2}),
    "scatter_least_squares": (dict(step_sizes=STEP_SIZES, l2_regs=L2_REGS, use_gram=False), "",
                              {}),
    "scatter_sampled": (dict(step_size=0.005, mini_batch_fraction=0.5, use_gram=False), "", {}),
    "gram_2_18": (dict(step_size=0.005, l2_reg=0.1), "", {"f": 2**18}),
}


def tenant_parts(seed: int, logistic: bool = False, dry: "dict | None" = None,
                 fractional: "int | None" = None, f: int = F_SMALL) -> dict:
    """TICKS ticks of M tenant parts of ROWS rows each, FeatureBatch fields
    with a leading [TICKS, M]; rows masked at random, a ``dry`` tenant's
    second half (``rank1``) or all (``both``) masked, a ``fractional``
    tenant's row 1 (on rank 0) of values 1.5."""
    rng = np.random.default_rng(seed)
    shape = (TICKS, M, ROWS)
    labels = (rng.integers(0, 2, shape) if logistic else rng.uniform(50, 900, shape))
    mask = (rng.random(shape) < 0.85).astype(np.float32)
    for t, where in (dry or {}).items():
        mask[:, t, HALF if where == "rank1" else 0:] = 0.0
    val = rng.integers(1, 3, shape + (8,)).astype(np.float32)
    if fractional is not None:
        val[:, fractional, 1] = 1.5
        mask[:, fractional, 1] = 1.0
    return {
        "token_idx": rng.integers(0, f, shape + (8,)).astype(np.int32),
        "token_val": val,
        "numeric": (rng.integers(-64, 64, shape + (4,)) / 64.0).astype(np.float32),
        "label": labels.astype(np.float32),
        "mask": mask,
    }


def _parts_at(data: dict, k: int, cls) -> list:
    return [cls(*(data[f][k][t] for f in FeatureBatch._fields)) for t in range(M)]


def start_weights(seed: int, f: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(0, 0.01, (M, f + 4)).astype(np.float32)


def jax_vmap_run(data: dict, init: np.ndarray, kw: dict, logistic: bool, f: int) -> tuple:
    """The JAX vmap over make_mesh(num_data=2) on the parts: (its weights,
    each tick's StepOutput on the host)."""
    knobs = (dict(residual_fn=JaxLogistic.residual_fn, prediction_fn=JaxLogistic.prediction_fn,
                  round_predictions=JaxLogistic.round_predictions) if logistic else {})
    stack = JaxStack(M, mapping="vmap", mesh=jax_make_mesh(num_data=2), num_text_features=f,
                     **SPARSE, **kw, **knobs)
    stack.set_initial_weights(jnp.asarray(init))
    outs = [stack.step(stack.prepare_wire_from_parts(_parts_at(data, k, JaxFeatureBatch)))
            for k in range(TICKS)]
    return np.asarray(stack.latest_weights), [
        type(o)(*(None if x is None else np.asarray(x) for x in o)) for o in outs]


@pytest.fixture(scope="module")
def data_axis(tmp_path_factory):
    """Every data-axis run in ONE group of two gloo ranks: each case's vmap,
    and the counts' vmap and scan runs at M = 2 and 4 on both routes."""
    tmp = tmp_path_factory.mktemp("vmap_mesh_sparse")
    runs, inputs = [], {}
    for i, (case, (kw, residual, opts)) in enumerate(CASES.items()):
        f = opts.get("f", F_SMALL)
        data = tenant_parts(50 + i, residual == "logistic", opts.get("dry"),
                            opts.get("fractional"), f)
        np.savez(tmp / f"{case}.npz", **data)
        jax_init = start_weights(60 + i, f)
        init = weights_from_jax(jax_init, num_text_features=f, device="cpu").numpy()
        np.save(tmp / f"{case}-init.npy", init)
        inputs[case] = (data, jax_init, f)
        runs.append(dict(mode="tenants", name=case, mapping="vmap", num_tenants=M,
                         residual=residual, parts=str(tmp / f"{case}.npz"),
                         init=str(tmp / f"{case}-init.npy"),
                         model=dict(num_text_features=f, **SPARSE, **kw)))
    np.savez(tmp / "batches.npz", **{k: v[:, 0] for k, v in tenant_parts(49).items()})
    for route in ("gram", "scatter"):
        for mapping in ("vmap", "scan"):
            for m, quality in ((2, False), (4, True)):
                runs.append(dict(mode="tenants", name=f"{route}-{mapping}-{m}", mapping=mapping,
                                 num_tenants=m, batches=str(tmp / "batches.npz"), model=dict(
                                     num_text_features=F_SMALL, step_size=0.005, quality=quality,
                                     use_gram=route == "gram", **SPARSE)))
    return run_mesh_runs(dict(out=str(tmp), num_data=2, num_model=1), runs, 2), inputs


@pytest.mark.parametrize("case", list(CASES))
def test_the_2_18_vmap_on_a_data_axis_matches_the_jax_vmap_on_a_mesh(data_axis, case):
    results, inputs = data_axis
    kw, residual, opts = CASES[case]
    data, jax_init, f = inputs[case]
    jax_w, jax_outs = jax_vmap_run(data, jax_init, kw, residual == "logistic", f)
    recs, arrays = results[case]
    gram = case.startswith("gram")
    for rank, (rec, arr) in enumerate(zip(recs, arrays)):
        assert rec["route"] == ("gram" if gram else "scatter")
        assert rec["tenants"] == [0, M] and rec["batched"]
        np.testing.assert_allclose(arr["w"], jax_w, rtol=VMAP_RTOL, atol=VMAP_ATOL)
        # every rank holds the replicated stack and the global counts
        np.testing.assert_array_equal(arr["w"], arrays[0]["w"])
        np.testing.assert_array_equal(arr["counts"], np.stack([o.count for o in jax_outs]))
        np.testing.assert_allclose(arr["mse"], np.stack([o.mse for o in jax_outs]),
                                   rtol=MSE_RTOL)
        # this rank's rows of every part, the JAX vmap's data shard: equal
        # rounded predictions on the valid rows
        half = slice(rank * HALF, (rank + 1) * HALF)
        valid = data["mask"][:, :, half] > 0
        np.testing.assert_array_equal(
            arr["preds"][valid], np.stack([o.predictions[:, half] for o in jax_outs])[valid])
        # one batched step a tick, whatever M; on the CPU the plain
        # versions, which launch nothing
        quality = int(kw.get("quality", False))
        for tick in rec["tick_collectives"]:
            if gram:
                assert (tick["row_allgathers"], tick["allreduces"]) == (2, 2 + quality), tick
            else:
                assert (tick["row_allgathers"], tick["allreduces"]) == (0, N + 1 + quality)
        assert not any(rec["launches"].values())
    assert not np.array_equal(jax_w, jax_init)  # the tenants trained
    if "dry" in opts:
        counts = np.stack([o.count for o in jax_outs])
        assert (counts[:, 3] == 0).all() and (counts[:, 1] > 0).all()
        np.testing.assert_array_equal(arrays[0]["w"][3], jax_init[3])  # no update
        assert not np.array_equal(arrays[1]["w"][1], jax_init[1])  # rank 1 has no row of it
    if kw.get("quality"):
        want = np.stack([o.quality for o in jax_outs])
        for arr in arrays:
            assert arr["quality"].shape == want.shape == (TICKS, M, 19)
            np.testing.assert_allclose(arr["quality"], want, rtol=VMAP_RTOL, atol=VMAP_ATOL)


@pytest.mark.parametrize("route", ["gram", "scatter"])
def test_a_tick_makes_the_same_collectives_whatever_m(data_axis, route):
    """vmap: on the Gram route 2 all-gathers and 2 all-reduces a tick (+ 1
    with the quality vector), on the scatter route N + 1 all-reduces (+ 1),
    at M = 2 and M = 4; scan: M times its one-tenant count. The two forms'
    stacks within the vmap's tolerance, the counts equal."""
    results, _ = data_axis
    for m, quality in ((2, 0), (4, 1)):
        one = ((2, 2 + quality) if route == "gram" else (0, N + 1 + quality))
        for mapping, times in (("vmap", 1), ("scan", m)):
            recs, _ = results[f"{route}-{mapping}-{m}"]
            for rec in recs:
                assert len(rec["tick_collectives"]) == TICKS
                for tick in rec["tick_collectives"]:
                    assert (tick["row_allgathers"], tick["allreduces"]) == (
                        times * one[0], times * one[1]), (mapping, m, tick)
                    assert tick["staged_copies"] == 0  # CPU tensors go to gloo as they are
        (rv, av), (rs, as_) = results[f"{route}-vmap-{m}"], results[f"{route}-scan-{m}"]
        for a, b in zip(av, as_):
            np.testing.assert_allclose(a["w"], b["w"], rtol=VMAP_RTOL, atol=VMAP_ATOL)
            np.testing.assert_array_equal(a["counts"], b["counts"])


def test_a_2x2_meshs_tenants_are_the_one_process_vmaps(tmp_path):
    """Tenants over the model axis (2 a rank), rows over the data axis: each
    rank's batched Gram step over its own tenants, the gathered stack within
    1e-3 of the one-process vmap on the whole parts, the counts equal, no
    collective across the model axis inside a tick (the JAX 2D vmap has no
    oracle on this image)."""
    kw = dict(num_text_features=F_SMALL, step_sizes=STEP_SIZES, l2_regs=L2_REGS, **SPARSE)
    data = tenant_parts(71, dry={2: "rank1"}, fractional=0)
    np.savez(tmp_path / "parts.npz", **data)
    (recs, arrays), = run_mesh_runs(
        dict(out=str(tmp_path), num_data=2, num_model=2),
        [dict(mode="tenants", name="vmap", mapping="vmap", num_tenants=M,
              parts=str(tmp_path / "parts.npz"), model=kw)], 4).values()
    single = TenantStackModel(M, mapping="vmap", device="cpu", **kw)
    counts = np.stack([single.step(single.prepare_wire_from_parts(
        _parts_at(data, k, FeatureBatch))).count.numpy() for k in range(TICKS)])
    want = single.latest_weights
    for rec, arr in zip(recs, arrays):
        lo = rec["model_index"] * (M // 2)
        assert rec["tenants"] == [lo, M // 2] and rec["route"] == "gram" and rec["batched"]
        np.testing.assert_allclose(arr["w"], want, rtol=VMAP_RTOL, atol=VMAP_ATOL)
        np.testing.assert_array_equal(arr["counts"], counts[:, lo:lo + M // 2])
        for tick in rec["tick_collectives"]:
            assert tick["model_allreduces"] == tick["model_row_allgathers"] == 0
            assert (tick["data_row_allgathers"], tick["data_allreduces"]) == (2, 2)


# ---- the plain pieces, two ranks as two threads of one gloo group

def _two_ranks(fn):
    """``fn(collectives)`` on two ranks of a gloo group in this process (two
    threads over a HashStore); [rank 0's result, rank 1's]."""
    import torch.distributed as dist

    store, out, errs = dist.HashStore(), [None, None], []

    def rank(r):
        try:
            pg = dist.ProcessGroupGloo(store, r, 2, datetime.timedelta(seconds=60))
            out[r] = fn(Collectives(rank=r, world=2, group=pg))
        except BaseException as e:  # noqa: BLE001 - reported below
            errs.append(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return out


def test_the_tenant_row_all_gather_is_tenant_major_in_rank_order():
    """ONE all-gather a call: each field comes back [M, 2·B_local, ...]
    with tenant t's rows of rank 0 then rank 1 (the JAX package's tiled
    all-gather of the vmapped rows), every field in its dtype, and both
    ranks' headers on the host."""
    from twtml_tpu_torch.parallel import distributed

    rng = np.random.default_rng(3)
    idx = torch.from_numpy(rng.integers(0, 99, (2, M, 5, 3)).astype(np.int32))
    val = torch.from_numpy(rng.normal(size=(2, M, 5)).astype(np.float32))
    before = distributed.COUNTERS["row_allgathers"]
    got = _two_ranks(lambda g: g.all_gather_tenant_rows(
        np.arange(2 * M) + 100 * g.rank, idx[g.rank], val[g.rank]))
    assert distributed.COUNTERS["row_allgathers"] == before + 2  # one a rank
    for heads, (gi, gv) in got:
        np.testing.assert_array_equal(heads, [np.arange(2 * M), np.arange(2 * M) + 100])
        assert gi.dtype == torch.int32 and gi.shape == (M, 10, 3)
        assert torch.equal(gi, torch.cat([idx[0], idx[1]], dim=1))
        assert torch.equal(gv, torch.cat([val[0], val[1]], dim=1))
    heads, (one,) = Collectives().all_gather_tenant_rows([7, 8], val[0])
    assert heads.tolist() == [[7, 8]] and torch.equal(one, val[0])


VALID = ((5, 0, 16, 3), (9, 0, 0, 16))  # rank r's valid rows of each tenant
B_LOCAL, L_TOK, F_PLAIN = 16, 6, 200


def _gathered(seed=9):
    """Two ranks' [M, B_LOCAL] parts gathered ([M, 2·B_LOCAL], rank-major
    within a tenant), each rank's rows past its valid ones padding."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, F_PLAIN, (M, 2 * B_LOCAL, L_TOK)).astype(np.int32)
    val = rng.integers(1, 3, (M, 2 * B_LOCAL, L_TOK)).astype(np.float32)
    num = (rng.normal(size=(M, 2 * B_LOCAL, 4)) * 0.1).astype(np.float32)
    for r, valid in enumerate(VALID):
        for t, v in enumerate(valid):
            idx[t, r * B_LOCAL + v:(r + 1) * B_LOCAL] = 0
            val[t, r * B_LOCAL + v:(r + 1) * B_LOCAL] = 0.0
    return tuple(torch.from_numpy(a) for a in (idx, val, num))


def test_the_row_table_lays_each_tenants_block_in_rank_order():
    table = TenantRowTable(valid=VALID, rank=1, rows=B_LOCAL)
    assert table.totals == (14, 0, 16, 19)
    assert table.mine() == ((5, 9), (0, 0), (16, 0), (3, 16))
    assert table.segments()[0] == ((0, 5), (16, 9))
    index = table.index("cpu")
    assert index.shape == (M, 19)
    assert index[0, :14].tolist() == list(range(5)) + list(range(16, 25))
    assert index[3].tolist() == [0, 1, 2] + list(range(16, 32))


@pytest.mark.parametrize("int8", [True, False])
def test_b4s_segments_are_b4_on_each_tenants_gathered_valid_rows(int8):
    """B4's tenant form over the row table's segments (each rank's
    padding skipped) bitwise B4's tenant form on the compacted parts; its
    plan's entries one a (tenant, rank) segment."""
    idx, val, _ = _gathered()
    table = TenantRowTable(valid=VALID, rank=0, rows=B_LOCAL)
    totals, index = table.totals, table.index("cpu")
    tenants = (3, 1, 0, 2)
    counts, at = fused_gram.count_build_tenants(idx, val, F_PLAIN, valid_rows=totals, int8=int8,
                                                tenants=tenants, segments=table.segments())
    t_ = torch.arange(M)[:, None]
    want, want_at = fused_gram.count_build_tenants(idx[t_, index], val[t_, index], F_PLAIN,
                                                   valid_rows=totals, int8=int8, tenants=tenants)
    assert at == want_at and torch.equal(counts, want)
    plan = fused_gram.count_tenants_plan(totals, tenants, L_TOK, shared_limit=232_448,
                                         segments=table.segments())
    assert len(plan.entries) == 2 * M and plan.launches == ((0, 2 * M),)
    assert [e[2] for e in plan.entries[:2]] == [VALID[0][3], VALID[1][3]]
    with pytest.raises(ValueError, match="segments"):
        fused_gram.count_build_tenants(idx, val, F_PLAIN, valid_rows=(1, 0, 16, 19), int8=int8,
                                       segments=table.segments())


def test_the_ranks_panels_stack_into_each_blocks_g_and_b8_sums_to_the_write_back():
    """Each rank's row panel of each tenant's block (``tenant_gram_blocks``
    with rows), gathered (``gather_tenant_panels``), is the block's G bit
    for bit; B8's tenant form at each rank's rows on zero weights, summed
    over the ranks, plus c·W is the one-process write-back within float
    rounding."""
    from twtml_tpu_torch.models.sgd import gather_tenant_panels

    idx, val, num = _gathered()
    rng = np.random.default_rng(4)
    w = torch.from_numpy((rng.normal(size=(M, F_PLAIN + 4)) * 1e-2).astype(np.float32))
    c = torch.tensor([0.97, 1.0, 0.99, 0.95])
    tables = [TenantRowTable(valid=VALID, rank=r, rows=B_LOCAL) for r in range(2)]
    totals, index = tables[0].totals, tables[0].index("cpu")
    counts, at = fused_gram.count_build_tenants(idx, val, F_PLAIN, valid_rows=totals, int8=True,
                                                segments=tables[0].segments())
    alpha = torch.from_numpy((rng.normal(size=index.shape) * 1e-3).astype(np.float32))
    num_b = num[torch.arange(M)[:, None], index]
    full = fused_gram.tenant_gram_blocks(counts, at, totals)

    def rank(g):
        mine = tables[g.rank].mine()
        gs = gather_tenant_panels(fused_gram.tenant_gram_blocks(counts, at, totals, rows=mine),
                                  tables[g.rank], g, [False] * M, "cpu")
        # each rank's rows of each block: its rows of each gathered part
        delta = fused_gram.dual_writeback_tenants(
            torch.zeros_like(w), c, alpha, idx, val, num_b, F_PLAIN,
            valid_rows=[v for _, v in mine], tenants=range(M),
            first_rows=[o for o, _ in mine], token_rows=[g.rank * B_LOCAL] * M)
        return gs, g.allreduce_(delta)

    for gs, delta in _two_ranks(rank):
        for t, p in enumerate(totals):
            assert (gs[t] is None) == (p == 0)
            if p:
                assert torch.equal(gs[t], full[t][:p, :p])
        blocks = [x[torch.arange(M)[:, None], index] for x in (idx, val)]  # each tenant's block
        want = fused_gram.dual_writeback_tenants(w, c, alpha, *blocks, num_b, F_PLAIN,
                                                 valid_rows=totals, tenants=range(M))
        torch.testing.assert_close(w * c[:, None] + delta, want, rtol=1e-6, atol=1e-7)


def test_b7s_tenant_draws_are_each_tenants_loop_on_its_own_draws():
    """``dual_sgd_tenants`` with [N, M, B] draws: each tenant's results are
    its own call's on its row of them, bitwise (the plain version)."""
    from twtml_tpu_torch.models.sgd import sampling_masks

    idx, val, num = _gathered()
    table = TenantRowTable(valid=VALID, rank=0, rows=B_LOCAL)
    totals, index = table.totals, table.index("cpu")
    counts, at = fused_gram.count_build_tenants(idx, val, F_PLAIN, valid_rows=totals, int8=True,
                                                segments=table.segments())
    gs = fused_gram.tenant_gram_blocks(counts, at, totals)
    rng = np.random.default_rng(6)
    b = index.shape[1]
    u = torch.from_numpy((rng.normal(size=(M, b)) * 10).astype(np.float32))
    y = torch.from_numpy(rng.uniform(50, 900, (M, b)).astype(np.float32))
    mask = torch.from_numpy((rng.random((M, b)) < 0.9).astype(np.float32))
    draws = sampling_masks(2 * B_LOCAL, N, 0.5, torch.float32, "cpu")[:, index]
    assert draws.shape == (N, M, b)
    kw = dict(num_iterations=N, convergence_tol=0.001, residual_fn=least_squares_residual)
    p_prev = torch.tensor([3.0, 1.0, 0.5, 2.0])
    c, alpha, its = fused_gram.dual_sgd_tenants(gs, u, y, mask, num[:, :b], valid_rows=totals,
                                                masks=draws, p_prev=p_prev,
                                                step_sizes=STEP_SIZES, l2_regs=L2_REGS, **kw)
    for t, p in enumerate(totals):
        one = fused_gram.dual_sgd_tenants(
            gs[t:t + 1], u[t:t + 1], y[t:t + 1], mask[t:t + 1], num[t:t + 1, :b],
            valid_rows=[p], masks=draws[:, t], p_prev=p_prev[t:t + 1],
            step_sizes=STEP_SIZES[t:t + 1], l2_regs=L2_REGS[t:t + 1], **kw)
        assert torch.equal(c[t], one[0][0]) and torch.equal(alpha[t], one[1][0])
        assert torch.equal(its[t], one[2][0])


def test_the_gram_step_at_a_group_of_one_is_the_one_process_step():
    """Over a data axis of one rank the batched Gram step (its all-gathers
    of one, the panels the whole blocks) steps the one-process vmap's
    weights within float rounding, the outputs bitwise."""
    from twtml_tpu_torch.models.sgd import make_sgd_tenant_step

    data = tenant_parts(81, dry={1: "both"}, fractional=2)
    kw = dict(num_tenants=M, step_sizes=STEP_SIZES, l2_regs=L2_REGS,
              num_text_features=F_SMALL, **SPARSE)
    grouped = make_sgd_tenant_step(group=Collectives(), **kw)
    single = make_sgd_tenant_step(**kw)
    w = torch.from_numpy(start_weights(5, F_SMALL))
    for k in range(TICKS):
        parts = FeatureBatch(*(torch.from_numpy(data[f][k]) for f in FeatureBatch._fields))
        valid = tenant_valid_rows(data["mask"][k])
        wg, og = grouped(w, parts, valid)
        ws, os_ = single(w, parts, valid)
        torch.testing.assert_close(wg, ws, rtol=1e-6, atol=1e-7)
        assert torch.equal(og.predictions, os_.predictions) and torch.equal(og.count, os_.count)
        w = ws


def test_a_rank_with_no_row_steps_as_the_other_ranks_rows_alone():
    """Rank 1's parts all padding (no panel, no write-back of its own): both
    ranks step the stack that one process steps on rank 0's rows, within
    float rounding, and hold it bit for bit alike."""
    from twtml_tpu_torch.models.sgd import make_sgd_tenant_step

    data = tenant_parts(91, fractional=1)
    kw = dict(num_tenants=M, step_sizes=STEP_SIZES, l2_regs=L2_REGS,
              num_text_features=F_SMALL, **SPARSE)
    w = torch.from_numpy(start_weights(7, F_SMALL))
    rows = [{f: data[f][0][:, :HALF] for f in FeatureBatch._fields} for _ in range(2)]
    rows[1]["mask"] = np.zeros_like(rows[1]["mask"])

    def rank(g):
        part = FeatureBatch(*(torch.from_numpy(np.ascontiguousarray(rows[g.rank][f]))
                              for f in FeatureBatch._fields))
        step = make_sgd_tenant_step(group=g, **kw)
        return step(w, part, tenant_valid_rows(rows[g.rank]["mask"]))

    (w0, o0), (w1, o1) = _two_ranks(rank)
    one = FeatureBatch(*(torch.from_numpy(np.ascontiguousarray(rows[0][f]))
                         for f in FeatureBatch._fields))
    want, out = make_sgd_tenant_step(**kw)(w, one, tenant_valid_rows(rows[0]["mask"]))
    assert torch.equal(w0, w1) and torch.equal(o0.count, out.count)
    torch.testing.assert_close(w0, want, rtol=1e-6, atol=1e-7)
