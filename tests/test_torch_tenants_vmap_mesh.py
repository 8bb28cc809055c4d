"""The tenant plane's vmap form over a mesh (``TenantStackModel(mapping=
"vmap", mesh=..., group=...)``) on the CPU, held against the JAX package's
vmap inside ``shard_map`` on ``make_mesh(num_data=2)``.

- Two gloo ranks of ``tests/torch_mesh_worker.py`` on a data axis step the
  same numpy tenant parts from the same start weights (carried across by
  ``convert.weights_from_jax``) as the JAX vmap, each rank on its data
  shard's rows of every part: least squares, logistic, ``-b 0.5``, the
  quality vector, a tenant dry on one rank only and one dry on both. The
  weights and quality within rtol / atol 1e-3 (the vmap's tolerance,
  ``tests/test_torch_tenants_vmap.py``), the global counts equal.
- A tick makes N + 1 all-reduces (N + 2 with the quality vector) whatever
  M; the scan form on the same mesh makes M times that.
- On 1 x 2, 2 x 1 and 2 x 2 meshes every rank's tenants are the one-process
  vmap's within 1e-3, and no collective crosses the model axis in a tick.
- The split with a tenant grid: its plain version with an identity
  all-reduce is the tenant grid's plain version, and at M = 1 the split's,
  bit for bit; over two ranks, at each tenant count where the kernel's
  reduce changes layout, both ranks' stacks are alike bit for bit; its
  launch plan at an H100's numbers updates every tenant's every column,
  dry tenants' included.
"""

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
from twtml_tpu_torch.ops import fused_sgd
from twtml_tpu_torch.parallel.distributed import Collectives
from twtml_tpu_torch.parallel.mesh import make_mesh
from twtml_tpu_torch.parallel.tenants import TenantStackModel

F_TEXT = 64
ROWS = 32  # a part's global rows: 16 on each of two data ranks
TICKS = 3
M = 4
N = 20  # iterations a step
VMAP_RTOL = VMAP_ATOL = 1e-3  # the vmap's tolerance (tests/test_torch_tenants_vmap.py)
MSE_RTOL = 1e-6  # float32 sums in another order (tests/test_torch_tenants_vmap.py)
STEP_SIZES = (0.002, 0.004, 0.006, 0.008)
L2_REGS = (0.0, 0.01, 0.1, 0.0)

# case -> (the stacks' keywords, the worker's learner, what is dry)
CASES = {
    "least_squares": (dict(step_sizes=STEP_SIZES, l2_regs=L2_REGS), "", {}),
    "logistic": ({}, "logistic", {}),
    "sampled": (dict(step_size=0.005, mini_batch_fraction=0.5), "", {}),
    "quality": (dict(step_size=0.005, quality=True), "", {}),
    # tenant 1 has rows on rank 0 only; tenant 3 has none on either rank
    "dry_on_one_rank": (dict(step_size=0.005), "", {1: "rank1"}),
    "dry_on_both_ranks": (dict(step_size=0.005), "", {3: "both"}),
}


def tenant_parts(seed: int, logistic: bool = False, dry: "dict | None" = None) -> dict:
    """TICKS ticks of M tenant parts of ROWS rows each, FeatureBatch fields
    with a leading [TICKS, M]; rows masked at random, a ``dry`` tenant's
    second half (``rank1``) or all (``both``) masked."""
    rng = np.random.default_rng(seed)
    shape = (TICKS, M, ROWS)
    labels = (rng.integers(0, 2, shape) if logistic else rng.uniform(50, 900, shape))
    mask = (rng.random(shape) < 0.85).astype(np.float32)
    for t, where in (dry or {}).items():
        mask[:, t, ROWS // 2 if where == "rank1" else 0:] = 0.0
    return {
        "token_idx": rng.integers(0, F_TEXT, shape + (8,)).astype(np.int32),
        "token_val": rng.integers(1, 3, shape + (8,)).astype(np.float32),
        "numeric": (rng.integers(-64, 64, shape + (4,)) / 64.0).astype(np.float32),
        "label": labels.astype(np.float32),
        "mask": mask,
    }


def _parts_at(data: dict, k: int, cls) -> list:
    return [cls(*(data[f][k][t] for f in FeatureBatch._fields)) for t in range(M)]


def start_weights(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(0, 0.01, (M, F_TEXT + 4)).astype(np.float32)


def jax_vmap_run(data: dict, init: np.ndarray, kw: dict, logistic: bool) -> tuple:
    """The JAX vmap over make_mesh(num_data=2) on the parts: (its weights,
    each tick's StepOutput on the host)."""
    knobs = (dict(residual_fn=JaxLogistic.residual_fn, prediction_fn=JaxLogistic.prediction_fn,
                  round_predictions=JaxLogistic.round_predictions) if logistic else {})
    stack = JaxStack(M, mapping="vmap", mesh=jax_make_mesh(num_data=2),
                     num_text_features=F_TEXT, num_iterations=N, **kw, **knobs)
    stack.set_initial_weights(jnp.asarray(init))
    outs = [stack.step(stack.prepare_wire_from_parts(_parts_at(data, k, JaxFeatureBatch)))
            for k in range(TICKS)]
    return np.asarray(stack.latest_weights), [
        type(o)(*(None if f is None else np.asarray(f) for f in o)) for o in outs]


@pytest.fixture(scope="module")
def data_axis(tmp_path_factory):
    """Every data-axis run in ONE group of two gloo ranks: each case's vmap,
    and the counts' vmap and scan runs at M = 2 and 4."""
    tmp = tmp_path_factory.mktemp("vmap_mesh")
    runs, inputs = [], {}
    for i, (case, (kw, residual, dry)) in enumerate(CASES.items()):
        data = tenant_parts(10 + i, residual == "logistic", dry)
        np.savez(tmp / f"{case}.npz", **data)
        jax_init = start_weights(20 + i)
        # the start weights as the JAX stack holds them, carried across
        init = weights_from_jax(jax_init, num_text_features=F_TEXT, device="cpu").numpy()
        np.save(tmp / f"{case}-init.npy", init)
        inputs[case] = (data, jax_init)
        runs.append(dict(mode="tenants", name=case, mapping="vmap", num_tenants=M,
                         residual=residual, parts=str(tmp / f"{case}.npz"),
                         init=str(tmp / f"{case}-init.npy"), model=dict(
                             num_text_features=F_TEXT, num_iterations=N, **kw)))
    np.savez(tmp / "batches.npz", **{f: v[:, 0] for f, v in tenant_parts(9).items()})
    for mapping in ("vmap", "scan"):
        for m, quality in ((2, False), (4, True)):
            runs.append(dict(mode="tenants", name=f"{mapping}-{m}", mapping=mapping,
                             num_tenants=m, batches=str(tmp / "batches.npz"), model=dict(
                                 num_text_features=F_TEXT, num_iterations=N, step_size=0.005,
                                 quality=quality)))
    return run_mesh_runs(dict(out=str(tmp), num_data=2, num_model=1), runs, 2), inputs


@pytest.mark.parametrize("case", list(CASES))
def test_vmap_on_a_data_axis_matches_the_jax_vmap_on_a_mesh(data_axis, case):
    results, inputs = data_axis
    kw, residual, dry = CASES[case]
    data, jax_init = inputs[case]
    jax_w, jax_outs = jax_vmap_run(data, jax_init, kw, residual == "logistic")
    recs, arrays = results[case]
    for rank, (rec, arr) in enumerate(zip(recs, arrays)):
        assert rec["route"] == ("torch_loop" if case == "sampled" else "fused_dense_sgd")
        assert rec["tenants"] == [0, M]
        np.testing.assert_allclose(arr["w"], jax_w, rtol=VMAP_RTOL, atol=VMAP_ATOL)
        # every rank holds the replicated stack and the global counts
        np.testing.assert_array_equal(arr["w"], arrays[0]["w"])
        np.testing.assert_array_equal(arr["counts"], np.stack([o.count for o in jax_outs]))
        # the stats sum over both ranks' rows: the mse of equal rounded
        # predictions in another order of summation, float32 (MSE_RTOL)
        np.testing.assert_allclose(arr["mse"], np.stack([o.mse for o in jax_outs]),
                                   rtol=MSE_RTOL)
        # this rank's rows of every part, the JAX vmap's data shard: equal
        # rounded predictions on the valid rows (a masked row's margin is 0
        # in the port's fused route, x·w in the JAX step's)
        half = slice(rank * ROWS // 2, (rank + 1) * ROWS // 2)
        valid = data["mask"][:, :, half] > 0
        np.testing.assert_array_equal(
            arr["preds"][valid], np.stack([o.predictions[:, half] for o in jax_outs])[valid])
        # one batched step a tick: N + 1 all-reduces (+ 1 with quality), and
        # on the CPU the plain versions, which launch nothing
        extra = int(case == "quality")
        assert [t["allreduces"] for t in rec["tick_collectives"]] == [N + 1 + extra] * TICKS
        assert not any(rec["launches"].values())
    assert not np.array_equal(jax_w, jax_init)  # the tenants trained
    if dry:
        counts = np.stack([o.count for o in jax_outs])
        t, where = next(iter(dry.items()))
        assert (counts[:, t] == 0).all() == (where == "both")
        if where == "both":  # no update: the start weights stand
            np.testing.assert_array_equal(arrays[0]["w"][t], jax_init[t])
        else:  # rank 1 holds no row of tenant t, and updates it all the same
            assert not np.array_equal(arrays[1]["w"][t], jax_init[t])
    if case == "quality":
        want = np.stack([o.quality for o in jax_outs])
        for arr in arrays:
            assert arr["quality"].shape == want.shape == (TICKS, M, 19)
            np.testing.assert_allclose(arr["quality"], want, rtol=VMAP_RTOL, atol=VMAP_ATOL)


def test_a_tick_makes_n_plus_one_allreduces_whatever_m(data_axis):
    """vmap: N + 1 all-reduces a tick (the iterations' and the stats'), + 1
    with the quality vector, at M = 2 and M = 4; scan: M times that."""
    results, _ = data_axis
    for m, extra in ((2, 0), (4, 1)):
        for mapping, times in (("vmap", 1), ("scan", m)):
            recs, _ = results[f"{mapping}-{m}"]
            for rec in recs:
                assert len(rec["tick_collectives"]) == TICKS
                for tick in rec["tick_collectives"]:
                    assert tick["allreduces"] == times * (N + 1 + extra), (mapping, m, tick)
                    assert tick["staged_copies"] == 0  # CPU tensors go to gloo as they are
    for m in (2, 4):
        (rv, av), (rs, as_) = results[f"vmap-{m}"], results[f"scan-{m}"]
        for a, b in zip(av, as_):
            np.testing.assert_allclose(a["w"], b["w"], rtol=VMAP_RTOL, atol=VMAP_ATOL)
            np.testing.assert_array_equal(a["counts"], b["counts"])


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1), (2, 2)], ids=["1x2", "2x1", "2x2"])
def test_every_ranks_tenants_are_the_one_process_vmaps_on_a_mesh(tmp_path, mesh):
    """Each rank batches its own tenants (M / model of them) over its data
    shard's rows: the gathered stack within 1e-3 of the one-process vmap on
    the whole parts, the counts equal, and no collective crosses the model
    axis inside a tick (the data axis: N + 1 all-reduces a tick)."""
    nd, nm = mesh
    kw = dict(num_text_features=F_TEXT, num_iterations=N, step_sizes=STEP_SIZES,
              l2_regs=L2_REGS)
    data = tenant_parts(31, dry={2: "rank1"})
    np.savez(tmp_path / "parts.npz", **data)
    (recs, arrays), = run_mesh_runs(
        dict(out=str(tmp_path), num_data=nd, num_model=nm),
        [dict(mode="tenants", name="vmap", mapping="vmap", num_tenants=M,
              parts=str(tmp_path / "parts.npz"), model=kw)], nd * nm).values()
    single = TenantStackModel(M, mapping="vmap", device="cpu", **kw)
    counts = np.stack([single.step(single.prepare_wire_from_parts(
        _parts_at(data, k, FeatureBatch))).count.numpy() for k in range(TICKS)])
    want = single.latest_weights
    local = M // nm
    for rec, arr in zip(recs, arrays):
        lo = rec["model_index"] * local
        assert rec["tenants"] == [lo, local]
        np.testing.assert_allclose(arr["w"], want, rtol=VMAP_RTOL, atol=VMAP_ATOL)
        np.testing.assert_array_equal(arr["counts"], counts[:, lo:lo + local])
        for tick in rec["tick_collectives"]:
            assert tick["model_allreduces"] == tick["model_row_allgathers"] == 0
            data_allreduces = tick["data_allreduces"] + tick["allreduces"]
            assert data_allreduces == (N + 1 if nd > 1 else 0)


def _split_inputs(m: int, rows: int = 40, f: int = 1004, seed: int = 3) -> tuple:
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.poisson(0.05, (m, rows, f)).astype(np.float32))
    x[..., -4:] = torch.from_numpy(rng.normal(0, 1e-3, (m, rows, 4)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 20, (m, rows)).astype(np.float32))
    mask = torch.from_numpy((rng.random((m, rows)) < 0.7).astype(np.float32))
    w0 = torch.from_numpy(rng.normal(0, 0.1, (m, f)).astype(np.float32))
    return x, y, mask, w0


def _identity(t):
    return t


@pytest.mark.parametrize("residual", [fused_sgd.least_squares_residual,
                                      fused_sgd.logistic_residual], ids=["lsq", "logistic"])
def test_the_split_with_a_tenant_grids_plain_version_at_one_rank(residual):
    """With an identity all-reduce (one rank) the plain version is the
    tenant grid's plain version bit for bit (a dry tenant keeps its w0),
    and at M = 1 the split's plain version bit for bit; the wrapper takes
    it on the CPU, counting no launch."""
    x, y, mask, w0 = _split_inputs(M)
    mask[2] = 0.0  # a dry tenant
    kw = dict(num_iterations=N, step_sizes=STEP_SIZES, l2_regs=L2_REGS,
              convergence_tol=0.001, residual_fn=residual)
    w, preds = fused_sgd.fused_dense_sgd_tenants_split_reference(x, y, mask, w0,
                                                                 allreduce=_identity, **kw)
    want_w, want_p = fused_sgd.fused_dense_sgd_tenants_reference(x, y, mask, w0, **kw)
    assert torch.equal(w, want_w) and torch.equal(preds, want_p)
    assert torch.equal(w[2], w0[2]) and not torch.equal(w[0], w0[0])
    before = fused_sgd.fused_dense_sgd_tenants_split.launches
    got = fused_sgd.fused_dense_sgd_tenants_split(
        x, y, mask, w0, allreduce=_identity, valid_rows=tenant_valid_rows(mask.numpy()), **kw)
    assert torch.equal(got[0], w) and torch.equal(got[1], preds)
    assert fused_sgd.fused_dense_sgd_tenants_split.launches == before
    one = dict(kw, step_sizes=STEP_SIZES[:1], l2_regs=L2_REGS[:1])
    w1, p1 = fused_sgd.fused_dense_sgd_tenants_split_reference(
        x[:1], y[:1], mask[:1], w0[:1], allreduce=_identity, **one)
    ws, ps = fused_sgd.fused_dense_sgd_split(
        x[0], y[0], mask[0], w0[0], allreduce=_identity, num_iterations=N,
        step_size=STEP_SIZES[0], l2_reg=L2_REGS[0], convergence_tol=0.001,
        residual_fn=residual)
    assert torch.equal(w1[0], ws) and torch.equal(p1[0], ps)


def test_the_plain_version_reduces_every_tenant_in_one_call_an_iteration():
    """Two ranks' halves of the rows, two threads joined by a summing
    all-reduce that records its calls: N calls a rank, each of M x (F + 1)
    floats, both ranks with the same weights, those of the whole rows within
    float rounding (rtol / atol 1e-5: the sums split at the ranks)."""
    import threading

    x, y, mask, w0 = _split_inputs(M, rows=40)
    kw = dict(num_iterations=N, step_sizes=STEP_SIZES, l2_regs=L2_REGS,
              convergence_tol=0.001, residual_fn=fused_sgd.least_squares_residual)
    barrier, slots, calls, results = threading.Barrier(2), [None, None], [], [None, None]

    def rank(r):
        def allreduce(t):
            calls.append(tuple(t.shape))
            slots[r] = t.clone()
            barrier.wait()
            total = slots[0] + slots[1]
            barrier.wait()
            t.copy_(total)
            return t

        rows = slice(20 * r, 20 * (r + 1))
        results[r] = fused_sgd.fused_dense_sgd_tenants_split_reference(
            x[:, rows], y[:, rows], mask[:, rows], w0, allreduce=allreduce, **kw)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert calls == [(M * (x.shape[2] + 1),)] * (2 * N)
    (w, p0), (w1, p1) = results
    assert torch.equal(w, w1)
    want, want_p = fused_sgd.fused_dense_sgd_tenants_reference(x, y, mask, w0, **kw)
    torch.testing.assert_close(w, want, rtol=1e-5, atol=1e-5)
    # each row's margin, in another blocking of the product: 1e-6
    torch.testing.assert_close(torch.cat([p0, p1], dim=1), want_p, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("m", [1, 2, 3, 5, 6, 7, 8, 12, 13, 16, 32])
def test_the_plain_version_over_two_ranks_at_each_reduce_layout(m):
    """At each tenant count where the kernel's reduce and decisions change
    layout (the on-card checks' counts among them): two ranks' halves of the
    rows joined by a summing all-reduce, tenant 1 without rows on rank 1
    and tenant 2 without rows on either. Both ranks hold the same weights
    bit for bit, a tenant with no row keeps its w0, and the stack is the
    tenant grid's on the whole rows within float rounding (rtol / atol
    1e-5: the sums split at the ranks)."""
    import threading

    x, y, mask, w0 = _split_inputs(m, rows=24, f=68, seed=m)
    if m > 1:
        mask[1, 12:] = 0.0
    if m > 2:
        mask[2] = 0.0
    steps = [STEP_SIZES[t % 4] for t in range(m)]
    l2s = [L2_REGS[t % 4] for t in range(m)]
    kw = dict(num_iterations=N, step_sizes=steps, l2_regs=l2s, convergence_tol=0.001,
              residual_fn=fused_sgd.least_squares_residual)
    barrier, slots, results = threading.Barrier(2), [None, None], [None, None]

    def rank(r):
        def allreduce(t):
            slots[r] = t.clone()
            barrier.wait()
            total = slots[0] + slots[1]
            barrier.wait()
            t.copy_(total)
            return t

        rows = slice(12 * r, 12 * (r + 1))
        results[r] = fused_sgd.fused_dense_sgd_tenants_split_reference(
            x[:, rows], y[:, rows], mask[:, rows], w0, allreduce=allreduce, **kw)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    (w, _), (w1, _) = results
    assert torch.equal(w, w1)
    if m > 2:
        assert torch.equal(w[2], w0[2])
    if m > 1:
        assert not torch.equal(w[1], w0[1])  # updated on the rank without its rows too
    want, _ = fused_sgd.fused_dense_sgd_tenants_reference(x, y, mask, w0, **kw)
    torch.testing.assert_close(w, want, rtol=1e-5, atol=1e-5)


H100_SMS, H100_SHARED = 132, 232_448
SPLIT_PLAN_CASES = {
    "op_point_4_x_2048_of_8192": ([2048] * 4, 8192, 1004),
    "a_tenant_dry_on_this_rank": ([4096, 0, 4096, 2048], 8192, 1004),
    "all_dry_on_this_rank": ([0, 0, 0, 0], 8192, 1004),
    "one_tenant_every_row": ([8192], 8192, 1004),
    "small_parts": ([16, 0, 3, 16], 16, 68),
    "thirty_two_tenants": ([256] * 31 + [0], 8192, 1004),
    "wide_rows_f8196": ([1024, 0, 512, 512], 2048, 8196),
    # the tenant counts at which the kernel's reduce and decisions change
    # layout: 6, 4 and 2 warps a tenant (M = 2, 3, 5), one (M = 8, 12; the
    # decisions from a table above 6), a thread a (tenant, column) pair (13)
    "two_tenants": ([4096, 2048], 4096, 1004),
    "three_tenants": ([2730, 0, 1365], 2730, 1004),
    "five_tenants": ([1638, 1638, 0, 819, 1000], 1638, 1004),
    "eight_tenants": ([1024] * 7 + [0], 1024, 1004),
    "twelve_tenants": ([682, 341] * 6, 682, 1004),
    "thirteen_tenants": ([630] * 12 + [1], 630, 1004),
}


@pytest.mark.parametrize("case", list(SPLIT_PLAN_CASES))
def test_the_tenant_split_plan_updates_every_tenants_columns(case):
    """At an H100's numbers: every CTA's columns, whichever tenant's rows it
    owns, cover [0, fpad) once, so every tenant (dry ones on this rank
    included) is updated and reduced in full; the slices are B1's grid at
    the parts' rows, alike for any valid rows (every rank sums the norms in
    one order); the rows are staged, none resident; at one tenant with every
    row valid the plan is the split's."""
    valid, rows, f = SPLIT_PLAN_CASES[case]
    kw = dict(sm_count=H100_SMS, shared_limit=H100_SHARED)
    split = fused_sgd.tenant_split_plan(valid, rows, f, **kw)
    plan = split.tenants
    assert 1 <= plan.grid <= H100_SMS and plan.shared_bytes <= H100_SHARED
    assert plan.resident == 0 and plan.spill_per_cta == plan.rows_cap
    assert plan.shared_bytes == plan.smem_layout[4]
    columns = [c for cta in range(plan.grid) for r in split.cta_columns(cta) for c in r]
    assert sorted(columns) == list(range(plan.fpad))
    b1 = fused_sgd.split_plan(rows, f, **kw)
    assert split.slices == b1.grid
    other = fused_sgd.tenant_split_plan([rows] * len(valid), rows, f, **kw)
    assert other.slices == split.slices  # another rank's valid rows
    owned = [[0] * v for v in valid]
    for t, first, n in plan.entries():
        for r in range(first, first + n):
            owned[t][r] += 1
    assert all(n == 1 for rows_ in owned for n in rows_)
    assert split.scratch_floats == ((plan.grid + len(valid)) * plan.fpad + plan.grid
                                    + len(valid) + 2 * len(valid) * split.slices + len(valid))
    if case == "one_tenant_every_row":
        assert (plan.grid, plan.rows_cap, plan.shared_bytes) == (b1.grid, b1.rows_cap,
                                                                 b1.shared_bytes)
        assert [split.cta_columns(c) for c in range(plan.grid)] == [
            [range(min(c * 8, b1.fpad), min(c * 8 + 8, b1.fpad))] for c in range(b1.grid)]


def test_the_tenant_split_entry_takes_the_wrapper_arguments():
    """Each C entry of the split with a tenant grid (the handle prepared once
    a step, its launch, its release) takes as many parameters as the
    wrapper's ctypes list for it."""
    import pathlib
    import re

    source = (pathlib.Path(fused_sgd.__file__).parents[1] / "csrc" / "fused_sgd.cu").read_text()
    for name in ("twtml_tenant_split_prepare", "twtml_tenant_split_launch",
                 "twtml_tenant_split_release"):
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)', source)
        assert len(params.group(1).split(",")) == len(fused_sgd._ENTRIES[name]), name


def test_the_tenant_split_refuses_what_the_grid_cannot_take():
    x = torch.zeros((3, 4, 1004))
    kw = dict(valid_rows=[4, 5, 0], num_iterations=2, step_sizes=[0.1] * 3,
              l2_regs=[0.0] * 3, allreduce=_identity)
    with pytest.raises(ValueError, match=r"outside \[0, 4\]"):
        fused_sgd.fused_dense_sgd_tenants_split(x, torch.zeros((3, 4)), torch.ones((3, 4)),
                                                torch.zeros((3, 1004)), **kw)


def test_vmap_over_a_one_rank_mesh_is_the_one_process_vmap():
    """A group of one all-reduces nothing: the vmap form over a one-rank
    data axis steps the one-process vmap's weights and outputs bit for bit."""
    kw = dict(num_text_features=F_TEXT, num_iterations=N, step_sizes=STEP_SIZES,
              l2_regs=L2_REGS)
    meshed = TenantStackModel(M, mapping="vmap", device="cpu", mesh=make_mesh(num_processes=1),
                              group=Collectives(), **kw)
    single = TenantStackModel(M, mapping="vmap", device="cpu", **kw)
    data = tenant_parts(41, dry={1: "both"})
    for k in range(TICKS):
        parts = _parts_at(data, k, FeatureBatch)
        out = meshed.step(meshed.prepare_wire_from_parts(parts))
        ref = single.step(single.prepare_wire_from_parts(parts))
        for f in ("predictions", "count", "mse", "real_stdev", "pred_stdev"):
            assert torch.equal(getattr(out, f), getattr(ref, f)), f
    assert meshed.latest_weights.tobytes() == single.latest_weights.tobytes()


def test_the_stats_and_quality_reduce_m_tenants_in_one_call():
    """``batch_stats`` and ``quality_vector`` on [M, B] rows with a group's
    reduce: ONE call each of the M tenants' sums ([6, M] and [M, 48]), and
    at one rank (the reduce an identity) each tenant's single-batch values
    within float rounding (rtol 1e-6: the moments from sums)."""
    from twtml_tpu_torch.ops.quality import quality_vector
    from twtml_tpu_torch.ops.stats import batch_stats

    rng = np.random.default_rng(17)
    y = torch.from_numpy(rng.uniform(50, 900, (M, ROWS)).astype(np.float32))
    p = torch.from_numpy(rng.integers(50, 900, (M, ROWS)).astype(np.float32))
    mask = torch.from_numpy((rng.random((M, ROWS)) < 0.8).astype(np.float32))
    mask[2] = 0.0  # a dry tenant
    w0 = torch.from_numpy(rng.normal(size=(M, F_TEXT + 4)).astype(np.float32))
    w1 = w0 + 0.1
    num = torch.from_numpy(rng.normal(size=(M, ROWS, 4)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, F_TEXT, (M, ROWS, 8)).astype(np.int32))
    val = torch.from_numpy(rng.integers(1, 3, (M, ROWS, 8)).astype(np.float32))
    calls = []

    def reduce(t):
        calls.append(tuple(t.shape))
        return t

    stats = batch_stats(y, p, mask, reduce=reduce)
    q = quality_vector(w0, w1, residual=(y - p) * mask, preds=p, labels=y, mask=mask,
                       numeric=num, token_idx=idx, token_val=val, reduce=reduce)
    assert calls == [(6, M), (M, 48)]  # 8 sums, 4 + 4 numeric, 32 bins
    for m in range(M):
        one = batch_stats(y[m], p[m], mask[m])
        for k, v in one.items():
            torch.testing.assert_close(stats[k][m], v, rtol=1e-6, atol=1e-6)
        qm = quality_vector(w0[m], w1[m], residual=(y[m] - p[m]) * mask[m], preds=p[m],
                            labels=y[m], mask=mask[m], numeric=num[m], token_idx=idx[m],
                            token_val=val[m])
        torch.testing.assert_close(q[m], qm, rtol=1e-6, atol=1e-6)


def test_the_2_18_routes_run_their_tenants_in_turn_over_a_mesh(caplog):
    """The vmap form over a mesh on the 2^18 routes builds its batched step
    (B10 d: the Gram route and the scatter route, one step a tick for every
    tenant), and its construction log says so; no tenant steps in turn. (The
    name is the one this test had when it pinned the in-turn form; it is kept
    so the test stays the same test.)"""
    import logging

    for use_gram, route in ((None, "gram"), (False, "scatter")):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="twtml_tpu_torch.parallel.tenants"):
            model = TenantStackModel(M, mapping="vmap", device="cpu", num_text_features=2**18,
                                     use_gram=use_gram, mesh=make_mesh(num_processes=1),
                                     group=Collectives())
        assert model._batched is not None and model.route == route
        assert model._batched.route == route
        assert any("mapping vmap: one batched step" in r.getMessage() for r in caplog.records)
        assert not any("in turn" in r.getMessage() for r in caplog.records)
