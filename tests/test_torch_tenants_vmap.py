"""The tenant plane's vmap form in the port (``TenantStackModel(mapping=
"vmap")``, ``twtml_tpu_torch/parallel/tenants.py``) on the CPU, held against
the JAX package's ``TenantStackModel(mapping="vmap")`` on the same tweets.

- Every single-process route (dense least squares and logistic, the quality
  vector, bfloat16, ``-b 0.5``, per-tenant step sizes and L2, the skewed
  ``lang`` key with a dry tenant, the 2^18 scatter and Gram routes at B =
  256): the weights within VMAP_RTOL / VMAP_ATOL of the JAX vmap's, the
  rounded predictions and counts equal, the mse within MSE_RTOL.
- B1's tenant grid: its plain version is M calls of B1's, bitwise, and the
  wrapper takes it on the CPU; ``tenant_launch_plan`` at an H100's numbers.
- The wire carries each part's valid rows; over a one-rank mesh the vmap
  form is no longer refused (B10 b, tests/test_torch_tenants_vmap_mesh.py).
  The 2^18 routes' batched step (B10 c) has its own cases in
  tests/test_torch_tenants_vmap_sparse.py.
"""

import contextlib
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twtml_tpu.features.featurizer import Featurizer as JaxFeaturizer
from twtml_tpu.models.logistic import StreamingLogisticRegressionWithSGD as JaxLogistic
from twtml_tpu.parallel.tenants import TenantStackModel as JaxStack
from twtml_tpu.streaming.sources import SyntheticSource as JaxSynthetic

from twtml_tpu_torch.features.batch import PackedBatch, tenant_valid_rows
from twtml_tpu_torch.features.featurizer import Featurizer
from twtml_tpu_torch.models.logistic import StreamingLogisticRegressionWithSGD as Logistic
from twtml_tpu_torch.ops import fused_sgd
from twtml_tpu_torch.parallel.distributed import Collectives
from twtml_tpu_torch.parallel.mesh import make_mesh
from twtml_tpu_torch.parallel.tenants import TenantStackModel
from twtml_tpu_torch.streaming.sources import SyntheticSource

NOW_MS = 1785320000000
M = 4
ROWS = 256
STEP_SIZES = (0.05, 0.1, 0.2, 0.4)
L2_REGS = (0.0, 0.01, 0.1, 0.0)
# The JAX package's vmap is not its scan bitwise (XLA's batched products
# sum in another order, twtml_tpu/parallel/tenants.py:17-21): on these
# tweets its weights leave its scan form's by up to 3.8e-4 of a weight
# (+ 1e-3), 4.1e-3 at the most on weights up to 74.9 (the dense route;
# -b 0.5 2.7e-4, scatter 3.6e-4, Gram 7.2e-5; bfloat16 bitwise), which
# ``test_the_jax_vmap_is_its_scan_within_the_same_tolerance`` measures
# here. The port's vmap is held to the JAX vmap at that scale: its fused
# route stores X in bf16 and sums in torch's order.
VMAP_RTOL = 1e-3
VMAP_ATOL = 1e-3
# the mse of equal rounded predictions, summed in each package's order in
# the weights' type: float32 within 1e-6; bfloat16 within 2**-7, two units
# of its 8-bit mantissa (the port's bfloat16 tolerance,
# tests/test_torch_sampling.py BF16_RTOL)
MSE_RTOL = {torch.float32: 1e-6, torch.bfloat16: 2.0**-7, torch.float64: 1e-12}
LANG_TAILS = (" café 中文", " привет")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (restored after it): the tenant loops run
    thousands of small ops, each of which stalls at its threads' barrier
    when the parallel test workers oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def statuses(cls, n, seed, lang):
    sts = list(cls(total=n, seed=seed, base_ms=NOW_MS).produce())
    for i, s in enumerate(sts):
        if i % 3 == 0:
            o = s.retweeted_status
            tail = LANG_TAILS[(i // 3) % 2] if lang else " café 中文"
            sts[i] = dataclasses.replace(s, retweeted_status=dataclasses.replace(
                o, text=o.text + tail))
    return sts


def batches(jax, num_text_features=1000, n=2, seed=3, lang=False):
    """``n`` ragged host batches of ROWS tweets for the port (or with ``jax``
    the same tweets for the JAX package), a third carrying non-ASCII words."""
    feat = (JaxFeaturizer if jax else Featurizer)(num_text_features=num_text_features,
                                                 now_ms=NOW_MS)
    sts = statuses(JaxSynthetic if jax else SyntheticSource, n * ROWS, seed, lang)
    return [feat.featurize_batch_ragged(sts[i * ROWS:(i + 1) * ROWS], row_bucket=ROWS,
                                        pre_filtered=True) for i in range(n)]


def logistic_knobs(jax):
    cls = JaxLogistic if jax else Logistic
    return dict(step_size=cls.default_step_size, residual_fn=cls.residual_fn,
                prediction_fn=cls.prediction_fn, round_predictions=cls.round_predictions)


# case -> (the stacks' shared keywords, port-only, JAX-only, batches' keywords)
CASES = {
    "least_squares": (dict(step_size=0.1), {}, {}, {}),
    "logistic": ({}, logistic_knobs(False), logistic_knobs(True), {}),
    "quality": (dict(step_size=0.1, quality=True), {}, {}, {}),
    "bfloat16": (dict(step_size=0.1), dict(dtype=torch.bfloat16), dict(dtype=jnp.bfloat16),
                 {}),
    # the JAX package's --dtype float64 is its x64 mode, on only inside
    # jax.enable_x64 (thread-local) here
    "float64": (dict(step_size=0.1), dict(dtype=torch.float64), dict(dtype=jnp.float64), {}),
    "sampled": (dict(step_size=0.1, mini_batch_fraction=0.5), {}, {}, {}),
    "per_tenant_hyperparams": (dict(step_sizes=list(STEP_SIZES), l2_regs=list(L2_REGS)),
                               {}, {}, {}),
    "lang_key_dry_tenant": (dict(step_size=0.1, tenant_key="lang"), {}, {}, dict(lang=True)),
    "scatter_2_18": (dict(num_text_features=2**18, step_size=0.005, l2_reg=0.1,
                          use_gram=False), {}, {}, dict(num_text_features=2**18)),
    "gram_2_18": (dict(num_text_features=2**18, step_size=0.005, l2_reg=0.1), {}, {},
                  dict(num_text_features=2**18)),
}
ROUTES = {"scatter_2_18": "scatter", "gram_2_18": "gram", "bfloat16": "torch_loop",
          "float64": "torch_loop", "sampled": "torch_loop"}


def run_case(case, with_jax_scan=False):
    shared, port_kw, jax_kw, batch_kw = CASES[case]
    x64 = jax.enable_x64(True) if case == "float64" else contextlib.nullcontext()
    port = TenantStackModel(M, mapping="vmap", device="cpu", **shared, **port_kw)
    with x64:
        jax_vmap = JaxStack(M, mapping="vmap", **shared, **jax_kw)
        jax_scan = JaxStack(M, **shared, **jax_kw) if with_jax_scan else None
        outs, jax_outs = [], []
        for ours, theirs in zip(batches(False, **batch_kw), batches(True, **batch_kw)):
            outs.append(port.step(ours))
            jax_outs.append(jax.device_get(jax_vmap.step(theirs)))
            if jax_scan is not None:
                jax_scan.step(theirs)
        jax_weights = (np.asarray(jax_vmap.latest_weights),
                       None if jax_scan is None else np.asarray(jax_scan.latest_weights))
    return port, jax_weights, outs, jax_outs


def assert_weights_close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=VMAP_RTOL, atol=VMAP_ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_vmap_matches_the_jax_packages_vmap(case):
    port, (jax_weights, _), outs, jax_outs = run_case(case)
    assert port.mapping == "vmap"
    assert port.route == ROUTES.get(case, "fused_dense_sgd")
    assert port._batched is not None  # one batched step on every route, 2^18's too
    for out, jout in zip(outs, jax_outs):
        assert out.predictions.shape == (M, ROWS)
        np.testing.assert_array_equal(out.count.float().numpy(), np.asarray(jout.count))
        np.testing.assert_array_equal(out.predictions.double().numpy(),
                                      np.asarray(jout.predictions, np.float64))
        np.testing.assert_allclose(out.mse.double().numpy(), np.asarray(jout.mse, np.float64),
                                   rtol=MSE_RTOL[port.dtype])
        if case == "quality":
            assert out.quality.shape == np.asarray(jout.quality).shape
            np.testing.assert_allclose(out.quality.numpy(), np.asarray(jout.quality),
                                       rtol=VMAP_RTOL, atol=VMAP_ATOL)
    assert_weights_close(port.latest_weights, jax_weights)
    if case == "lang_key_dry_tenant":
        counts = np.sum([o.count.numpy() for o in outs], axis=0)
        dry = np.flatnonzero(counts == 0)
        assert dry.size and (counts > 0).sum() >= 2, counts
        assert not port.latest_weights[dry].any()
        for out in outs:
            for f in ("mse", "real_stdev", "pred_stdev"):
                assert torch.isfinite(getattr(out, f)).all(), f


@pytest.mark.parametrize("case", ["least_squares", "sampled", "scatter_2_18"])
def test_the_jax_vmap_is_its_scan_within_the_same_tolerance(case):
    """The scale of VMAP_RTOL / VMAP_ATOL: the JAX package's own vmap and
    scan forms of one stack, on one route of each kind."""
    _, (vmap_weights, scan_weights), _, _ = run_case(case, with_jax_scan=True)
    assert_weights_close(vmap_weights, scan_weights)


@pytest.mark.parametrize("case", ["least_squares", "per_tenant_hyperparams", "scatter_2_18"])
def test_vmap_steps_as_the_ports_scan_on_the_cpu(case):
    """On the CPU B1's tenant grid is its plain version (M calls of B1's),
    and the batched scatter loop's gather and ``index_add_`` sum each
    tenant's terms in its step's order: the vmap form is the scan form's
    weights and outputs bitwise there."""
    shared, port_kw, _, batch_kw = CASES[case]
    vmap = TenantStackModel(M, mapping="vmap", device="cpu", **shared, **port_kw)
    scan = TenantStackModel(M, device="cpu", **shared, **port_kw)
    for b in batches(False, **batch_kw):
        out, ref = vmap.step(b), scan.step(b)
        for f in ("predictions", "count", "mse", "real_stdev", "pred_stdev"):
            assert torch.equal(getattr(out, f), getattr(ref, f)), f
    assert vmap.latest_weights.tobytes() == scan.latest_weights.tobytes()


@pytest.mark.parametrize("wire_pack", ["stacked", "group"])
def test_the_wire_carries_each_parts_valid_rows(wire_pack):
    model = TenantStackModel(M, mapping="vmap", device="cpu", wire_pack=wire_pack)
    rb = batches(False, n=1, lang=True)[0]
    parts = model.split(rb)
    wire = model.prepare_wire(rb)
    assert isinstance(wire, PackedBatch) == (wire_pack == "group")
    want = [int(np.asarray(p.mask).sum()) for p in parts]
    assert wire.valid_rows == want == model.valid_rows(wire)
    assert sum(want) == int(np.asarray(rb.mask).sum())
    del wire.valid_rows  # a wire that carries none: its host mask gives them
    assert model.valid_rows(wire) == want


def test_valid_rows_end_at_each_parts_last_valid_row():
    mask = np.zeros((4, 8), np.float32)
    mask[0, :3] = 1.0
    mask[1, [1, 5]] = 1.0  # valid rows further back, a masked row between
    mask[3, 7] = 1.0
    assert tenant_valid_rows(mask) == [3, 6, 0, 8]


def test_a_part_with_masked_rows_before_its_last_valid_row_trains_as_scan():
    """A part whose valid rows are not all at the front: the batched step
    reads X to its last valid row and keeps the mask inside, as scan."""
    vmap = TenantStackModel(M, mapping="vmap", device="cpu", step_size=0.1)
    scan = TenantStackModel(M, device="cpu", step_size=0.1)
    rb = batches(False, n=1)[0]
    parts = vmap.split(rb)
    holes = np.asarray(parts[1].mask).copy()
    holes[: int(holes.sum()) // 2] = 0.0
    parts[1].mask = holes
    wire = vmap.prepare_wire_from_parts(parts)
    assert wire.valid_rows[1] == int(np.flatnonzero(holes)[-1]) + 1
    out, ref = vmap.step(wire), scan.step(scan.prepare_wire_from_parts(parts))
    for f in ("predictions", "count", "mse"):
        assert torch.equal(getattr(out, f), getattr(ref, f)), f
    assert vmap.latest_weights.tobytes() == scan.latest_weights.tobytes()


def test_the_tenant_grids_plain_version_is_m_calls_of_b1s():
    rng = np.random.default_rng(7)
    b, f = 48, 1004
    x = torch.from_numpy(rng.poisson(0.05, (M, b, f)).astype(np.float32))
    x[..., -4:] = torch.from_numpy(rng.normal(0, 1e-3, (M, b, 4)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 20, (M, b)).astype(np.float32))
    mask = torch.from_numpy((rng.random((M, b)) < 0.7).astype(np.float32))
    mask[2] = 0.0  # a dry tenant
    w0 = torch.from_numpy(rng.normal(0, 0.1, (M, f)).astype(np.float32))
    for residual in (fused_sgd.least_squares_residual, fused_sgd.logistic_residual):
        kw = dict(num_iterations=20, step_sizes=STEP_SIZES, l2_regs=L2_REGS,
                  convergence_tol=0.001, residual_fn=residual)
        w, preds = fused_sgd.fused_dense_sgd_tenants_reference(x, y, mask, w0, **kw)
        got = fused_sgd.fused_dense_sgd_tenants(x, y, mask, w0, **kw,
                                                valid_rows=tenant_valid_rows(mask.numpy()))
        assert torch.equal(got[0], w) and torch.equal(got[1], preds)
        for m in range(M):
            wm, pm = fused_sgd.fused_dense_sgd_reference(
                x[m], y[m], mask[m], w0[m], num_iterations=20, step_size=STEP_SIZES[m],
                l2_reg=L2_REGS[m], convergence_tol=0.001, residual_fn=residual)
            assert torch.equal(w[m], wm) and torch.equal(preds[m], pm)
        assert torch.equal(w[2], w0[2]) and not preds[2].any()


H100_SMS, H100_SHARED = 132, 232_448
PLAN_CASES = {
    "even_op_point": [4096] * 4,
    "skewed_1_3_0_12": [1024, 3072, 0, 12288],
    "one_tenant_holds_the_batch": [16384, 1, 0, 1],
    "all_dry": [0, 0, 0, 0],
    "tiny": [1, 3, 0, 12],
    "thirty_two_tenants": [16384 // 32] * 31 + [0],
    "wide_rows_f8196": [2048, 0, 1024, 1024],
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_tenant_launch_plan_at_an_h100s_numbers(case):
    valid = PLAN_CASES[case]
    f = 8196 if case.startswith("wide") else 1004
    plan = fused_sgd.tenant_launch_plan(valid, f, sm_count=H100_SMS, shared_limit=H100_SHARED)
    assert 1 <= plan.grid <= H100_SMS
    assert plan.shared_bytes <= H100_SHARED
    assert plan.resident + plan.spill_per_cta == plan.rows_cap
    owned = [[0] * v for v in valid]
    for t, first, rows in plan.entries():
        assert rows <= plan.rows_cap
        for r in range(first, first + rows):
            owned[t][r] += 1
    assert all(n == 1 for rows in owned for n in rows)  # every valid row, exactly once
    ctas = [plan.first_cta[t + 1] - plan.first_cta[t] for t in range(len(valid))]
    assert all(k >= 1 for v, k in zip(valid, ctas) if v > 0)
    assert all(k == 0 for v, k in zip(valid, ctas) if v == 0) or not any(valid)
    assert all(k <= -(-v // fused_sgd.WARPS) for v, k in zip(valid, ctas) if v > 0)
    if case == "skewed_1_3_0_12":  # CTAs in proportion to the rows
        assert ctas[0] < ctas[1] < ctas[3] and plan.grid == H100_SMS
    if case == "even_op_point":  # B1's rows a CTA on the same 16,384 valid rows
        b1 = fused_sgd.launch_plan(sum(valid), f, sm_count=H100_SMS, shared_limit=H100_SHARED)
        assert plan.grid == b1.grid and plan.rows_cap == b1.rows_cap
        assert plan.resident == b1.resident


def test_tenant_launch_plan_refuses_what_one_launch_cannot_hold():
    kw = dict(sm_count=H100_SMS, shared_limit=H100_SHARED)
    with pytest.raises(ValueError, match="1..32 tenants"):
        fused_sgd.tenant_launch_plan([1] * 33, 1004, **kw)
    with pytest.raises(ValueError, match="need a CTA each"):
        fused_sgd.tenant_launch_plan([1] * 8, 1004, sm_count=4, shared_limit=H100_SHARED)


def _stamps(ns_a_cycle, cycles, slots=3):
    """Made-up probe stamps: slot 1 unused (CTA 0 is its tenant's last
    CTA), the others from a cycle count a phase edge, the globaltimer at
    ``ns_a_cycle`` and a coarse 32 ns tick."""
    st = torch.zeros((slots, len(cycles), 2), dtype=torch.int64)
    c = torch.tensor(np.cumsum(cycles) + 1000, dtype=torch.int64)
    for s in (0, 2):
        st[s, :, 1] = c
        st[s, :, 0] = (c.double() * ns_a_cycle).long() // 32 * 32 + 10**12
    return st


def test_the_tenant_probe_split_times_each_phase_by_the_ctas_own_clock():
    """Each stamping CTA's phase lengths are its SM cycles at its own rate
    (globaltimer span over clock64 span); the prologue's three phases, then
    each iteration's six, the first iteration left out of their means;
    a slot that no CTA stamped is skipped."""
    its = 5
    pro = [0, 100, 200, 300]  # entry, staged, barrier 0, counts (cycles after the edge before)
    it = [700, 50, 60, 70, 80, 90]  # row pass ... decisions
    first = [1700, 150, 160, 170, 180, 190]  # the first iteration (preds), left out
    cycles = pro + first + it * (its - 1)
    st = _stamps(0.5, cycles)
    prologue, phases, stamped, span = fused_sgd.tenant_probe_split(st)
    assert stamped == its
    assert list(prologue) == list(fused_sgd.PROBE_PROLOGUE)
    assert list(phases) == list(fused_sgd.PROBE_PHASES)
    g, c = st[0, :, 0].double(), st[0, :, 1].double()
    ns_a_cycle = float((g[-1] - g[0]) / (c[-1] - c[0]))  # the coarse clock's, ~0.5
    assert ns_a_cycle == pytest.approx(0.5, rel=1e-2)
    for got, want in zip(list(prologue.values()) + list(phases.values()), pro[1:] + it):
        assert got == pytest.approx(want * ns_a_cycle / 1e3, rel=1e-9)
    assert span == float(g[-1] - g[0]) / 1e3
    # a launch cut short: the last iteration's edges past its row pass unstamped
    st = _stamps(0.5, cycles)
    st[:, -5:] = 0
    assert fused_sgd.tenant_probe_split(st)[2] == its - 1


REFUSED = {
    "two tenants' step sizes for three": (dict(step_sizes=[0.1, 0.1]), "3 tenants need"),
    "a part's valid rows past its rows": (dict(valid_rows=[4, 5, 0]), r"outside \[0, 4\]"),
    "negative iterations": (dict(num_iterations=-1), "num_iterations"),
    "a residual without a mode": (dict(residual_fn=torch.tanh), "no residual mode"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_the_tenant_wrapper_refuses_what_the_grid_cannot_take(case):
    kw = dict(valid_rows=[4, 4, 0], num_iterations=2, step_sizes=[0.1] * 3,
              l2_regs=[0.0] * 3)
    bad, match = REFUSED[case]
    x = torch.zeros((3, 4, 1004))
    with pytest.raises(ValueError, match=match):
        fused_sgd.fused_dense_sgd_tenants(x, torch.zeros((3, 4)), torch.ones((3, 4)),
                                          torch.zeros((3, 1004)), **dict(kw, **bad))


@pytest.mark.parametrize("shape", [(33, 4, 8), (4, 8)])
def test_the_probe_takes_one_launch_of_tenants(shape):
    """The timing instantiation stamps one launch: 1..TENANTS_PER_LAUNCH
    tenants of [B, F] rows, refused before any device work."""
    x = torch.zeros(shape)
    with pytest.raises(ValueError, match="1..32 tenants in one launch"):
        fused_sgd.tenant_grid_probe(x, None, None, None, probe_iterations=1, valid_rows=[1],
                                    num_iterations=1, step_sizes=[0.1], l2_regs=[0.0])


def test_the_tenant_entry_takes_the_wrapper_arguments():
    """The tenant grid's C entry takes as many parameters as the wrapper's
    ctypes argument list (the probe's buffer and edges among them)."""
    import pathlib
    import re

    source = (pathlib.Path(fused_sgd.__file__).parents[1] / "csrc" / "fused_sgd.cu").read_text()
    params = re.search(r'extern "C" int twtml_fused_dense_sgd_tenants\(([^)]*)\)', source)
    assert len(params.group(1).split(",")) == len(fused_sgd.TENANTS_ARGTYPES)


def test_vmap_over_a_mesh_is_refused_naming_b10_b():
    """B10 b is ported: the vmap form over a mesh is no longer refused. It
    builds one batched step over the group (logged as such), and on a
    one-rank mesh it steps as the one-process vmap, bit for bit
    (tests/test_torch_tenants_vmap_mesh.py holds it on two ranks)."""
    one = make_mesh(num_processes=1)
    meshed = TenantStackModel(2, mapping="vmap", device="cpu", mesh=one, group=Collectives(),
                              step_size=0.1)
    single = TenantStackModel(2, mapping="vmap", device="cpu", step_size=0.1)
    assert meshed._batched is not None
    for b in batches(False, n=1):
        meshed.step(b)
        single.step(b)
    assert meshed.latest_weights.tobytes() == single.latest_weights.tobytes()


@pytest.mark.parametrize("case,form", [("least_squares", "one batched step"),
                                       ("gram_2_18", "one batched step")])
def test_the_construction_log_names_the_form(case, form, caplog):
    shared, port_kw, _, _ = CASES[case]
    with caplog.at_level(logging.INFO, logger="twtml_tpu_torch.parallel.tenants"):
        TenantStackModel(M, mapping="vmap", device="cpu", **shared, **port_kw)
    assert any(f"mapping vmap: " in r.getMessage() and form in r.getMessage()
               for r in caplog.records)


def test_the_stack_in_and_out_are_the_jax_stacks_numpy_weights():
    """``set_initial_weights`` takes, and ``latest_weights`` gives, the JAX
    stack's [M, F+4] numpy weights in the vmap form too."""
    jax_vmap = JaxStack(M, mapping="vmap", step_size=0.1)
    jax_vmap.step(batches(True, n=1)[0])
    port = TenantStackModel(M, mapping="vmap", device="cpu", step_size=0.1)
    port.set_initial_weights(np.asarray(jax_vmap.latest_weights))
    assert port.latest_weights.tobytes() == np.asarray(jax_vmap.latest_weights).tobytes()
    ours, theirs = batches(False, n=2)[1], batches(True, n=2)[1]
    port.step(ours)
    jax_vmap.step(theirs)
    assert port.latest_weights.shape == (M, 1004)
    assert_weights_close(port.latest_weights, jax_vmap.latest_weights)
