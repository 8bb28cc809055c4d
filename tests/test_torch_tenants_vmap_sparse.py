"""The tenant plane's vmap form on the 2^18 routes (``TenantStackModel(
mapping="vmap", num_text_features=2**18)``: ``models/sgd.make_sgd_tenant_step``'s
sparse regime) on the CPU, held against the JAX package's vmap on the same
tweets, and the tenant forms of B4, B7 and B8 (``ops/fused_gram.py``): their
plain versions, plans and refusals.

- The Gram and scatter routes at M = 4, B = 256: per-tenant step sizes and
  L2, the logistic learner, ``-b 0.5``, the quality vector, the ``lang``
  key with a dry tenant, parts in different Gram planes (one tenant carries
  a row past 127 code units): weights within VMAP_RTOL / VMAP_ATOL of the
  JAX vmap's, the rounded predictions and counts equal, the mse within
  MSE_RTOL.
- Each tenant form's plain version is M calls of the single-tenant plain
  version on each tenant's valid rows, bitwise; the wrappers take them on
  the CPU. ``count_tenants_plan`` and ``dual_tenants_plan`` at an H100's
  numbers, and what one launch or wrapper cannot take.
- The sparse ops' tenant axis, the batched scatter loop and the batched
  Gram route's plain pieces, each against every tenant alone.
"""

import dataclasses
import logging
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from twtml_tpu.features.featurizer import Featurizer as JaxFeaturizer
from twtml_tpu.models.logistic import StreamingLogisticRegressionWithSGD as JaxLogistic
from twtml_tpu.parallel.tenants import TenantStackModel as JaxStack
from twtml_tpu.streaming.sources import SyntheticSource as JaxSynthetic

from twtml_tpu_torch.features.featurizer import Featurizer
from twtml_tpu_torch.models.logistic import StreamingLogisticRegressionWithSGD as Logistic
from twtml_tpu_torch.models.sgd import host_planes, make_sgd_tenant_step
from twtml_tpu_torch.ops import fused_gram
from twtml_tpu_torch.ops.fused_sgd import least_squares_residual, logistic_residual
from twtml_tpu_torch.ops.gram import PLANE_INT8
from twtml_tpu_torch.parallel.distributed import Collectives
from twtml_tpu_torch.parallel.mesh import make_mesh
from twtml_tpu_torch.parallel.tenants import TenantStackModel
from twtml_tpu_torch.streaming.sources import SyntheticSource

NOW_MS = 1785320000000
M = 4
ROWS = 256
F = 2**18
STEP_SIZES = (0.005, 0.002, 0.01, 0.005)
L2_REGS = (0.0, 0.1, 0.01, 0.0)
# tests/test_torch_tenants_vmap.py's tolerances: the JAX package's own vmap
# is that far from its scan form
VMAP_RTOL = 1e-3
VMAP_ATOL = 1e-3
MSE_RTOL = 1e-6
LANG_TAILS = (" café 中文", " привет")
# a tweet of more than 127 code units: its row mass passes the int8 plane's
# gate, so its tenant's part lands in another plane than the others'
LONG_TAIL = " " + "abcdefghij" * 20


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (restored after it), as in
    tests/test_torch_tenants_vmap.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def statuses(cls, n, seed, lang, long_row):
    sts = list(cls(total=n, seed=seed, base_ms=NOW_MS).produce())
    for i, s in enumerate(sts):
        tail = ""
        if i % 3 == 0:
            tail = LANG_TAILS[(i // 3) % 2] if lang else " café 中文"
        if long_row and i == 1:
            tail += LONG_TAIL
        if tail:
            o = s.retweeted_status
            sts[i] = dataclasses.replace(s, retweeted_status=dataclasses.replace(
                o, text=o.text + tail))
    return sts


def batches(jax_side, n=2, seed=3, lang=False, long_row=False):
    """``n`` ragged host batches of ROWS tweets at 2^18 for the port (or the
    same tweets for the JAX package)."""
    feat = (JaxFeaturizer if jax_side else Featurizer)(num_text_features=F, now_ms=NOW_MS)
    sts = statuses(JaxSynthetic if jax_side else SyntheticSource, n * ROWS, seed, lang,
                   long_row)
    return [feat.featurize_batch_ragged(sts[i * ROWS:(i + 1) * ROWS], row_bucket=ROWS,
                                        pre_filtered=True) for i in range(n)]


def logistic_knobs(jax_side):
    cls = JaxLogistic if jax_side else Logistic
    return dict(step_size=cls.default_step_size, residual_fn=cls.residual_fn,
                prediction_fn=cls.prediction_fn, round_predictions=cls.round_predictions)


BASE = dict(num_text_features=F, step_size=0.005, l2_reg=0.1)
# case -> (the stacks' shared keywords, port-only, JAX-only, batches' keywords)
CASES = {
    "gram_per_tenant_hyperparams": (dict(BASE, step_sizes=list(STEP_SIZES),
                                         l2_regs=list(L2_REGS)), {}, {}, {}),
    "gram_logistic": (dict(num_text_features=F, l2_reg=0.1), logistic_knobs(False),
                      logistic_knobs(True), {}),
    "gram_sampled": (dict(BASE, mini_batch_fraction=0.5), {}, {}, {}),
    "gram_quality": (dict(BASE, quality=True), {}, {}, {}),
    "gram_lang_key_dry_tenant": (dict(BASE, tenant_key="lang"), {}, {}, dict(lang=True)),
    "gram_mixed_planes": (BASE, {}, {}, dict(long_row=True)),
    "scatter_per_tenant_hyperparams": (dict(BASE, use_gram=False, step_sizes=list(STEP_SIZES),
                                            l2_regs=list(L2_REGS)), {}, {}, {}),
    "scatter_sampled": (dict(BASE, use_gram=False, mini_batch_fraction=0.5), {}, {}, {}),
    "scatter_lang_key_dry_tenant": (dict(BASE, use_gram=False, tenant_key="lang"), {}, {},
                                    dict(lang=True)),
}


def run_case(case):
    shared, port_kw, jax_kw, batch_kw = CASES[case]
    port = TenantStackModel(M, mapping="vmap", device="cpu", **shared, **port_kw)
    jax_vmap = JaxStack(M, mapping="vmap", **shared, **jax_kw)
    outs, jax_outs, planes = [], [], []
    for ours, theirs in zip(batches(False, **batch_kw), batches(True, **batch_kw)):
        planes.append(port.planes(port.prepare_wire(ours)))
        outs.append(port.step(ours))
        jax_outs.append(jax.device_get(jax_vmap.step(theirs)))
    return port, np.asarray(jax_vmap.latest_weights), outs, jax_outs, planes


@pytest.mark.parametrize("case", list(CASES))
def test_the_2_18_vmap_matches_the_jax_packages_vmap(case):
    port, jax_weights, outs, jax_outs, planes = run_case(case)
    assert port._batched is not None and port.mapping == "vmap"
    assert port.route == ("scatter" if case.startswith("scatter") else "gram")
    for out, jout in zip(outs, jax_outs):
        assert out.predictions.shape == (M, ROWS)
        np.testing.assert_array_equal(out.count.float().numpy(), np.asarray(jout.count))
        np.testing.assert_array_equal(out.predictions.double().numpy(),
                                      np.asarray(jout.predictions, np.float64))
        np.testing.assert_allclose(out.mse.double().numpy(), np.asarray(jout.mse, np.float64),
                                   rtol=MSE_RTOL)
        if case.endswith("quality"):
            assert out.quality.shape == np.asarray(jout.quality).shape
            np.testing.assert_allclose(out.quality.numpy(), np.asarray(jout.quality),
                                       rtol=VMAP_RTOL, atol=VMAP_ATOL)
    np.testing.assert_allclose(port.latest_weights.astype(np.float64),
                               jax_weights.astype(np.float64), rtol=VMAP_RTOL, atol=VMAP_ATOL)
    if case.endswith("dry_tenant"):
        counts = np.sum([o.count.numpy() for o in outs], axis=0)
        dry = np.flatnonzero(counts == 0)
        assert dry.size and (counts > 0).sum() >= 2, counts
        assert not port.latest_weights[dry].any()
    if case == "gram_mixed_planes":  # the long row's tenant in another plane
        assert any(len(set(p)) > 1 for p in planes), planes


def test_the_2_18_vmap_steps_as_scan_within_the_tolerance_on_the_cpu():
    """The Gram route's vmap form against the port's own scan form (each
    tenant's step in turn) on mixed planes: within VMAP_RTOL / VMAP_ATOL,
    the counts equal."""
    vmap = TenantStackModel(M, mapping="vmap", device="cpu", **BASE)
    scan = TenantStackModel(M, device="cpu", **BASE)
    for b in batches(False, long_row=True):
        out, ref = vmap.step(b), scan.step(b)
        assert torch.equal(out.count, ref.count)
    np.testing.assert_allclose(vmap.latest_weights, scan.latest_weights, rtol=VMAP_RTOL,
                               atol=VMAP_ATOL)


def test_a_groups_2_18_vmap_runs_in_turn_and_the_step_refuses_a_group(caplog):
    """Over a data axis the 2^18 routes batch too (B10 d): the plane builds
    its batched step and logs one batched step; the batched step takes a
    group and, over a group of one, steps as one process does (the counts
    and rounded predictions equal, the weights within float rounding). (The
    name is the one this test had when it pinned the in-turn form and the
    refusal; it is kept so the test stays the same test.)"""
    from twtml_tpu_torch.features.batch import FeatureBatch, tenant_valid_rows

    with caplog.at_level(logging.INFO, logger="twtml_tpu_torch.parallel.tenants"):
        model = TenantStackModel(M, mapping="vmap", device="cpu", mesh=make_mesh(
            num_processes=1), group=Collectives(), **BASE)
    assert model._batched is not None and model.route == "gram"
    assert any("one batched step" in r.getMessage() for r in caplog.records)
    assert not any("in turn" in r.getMessage() for r in caplog.records)
    kw = dict(num_tenants=2, step_sizes=[0.1] * 2, l2_regs=[0.0] * 2, num_text_features=F,
              num_iterations=5)
    grouped = make_sgd_tenant_step(group=Collectives(), **kw)
    single = make_sgd_tenant_step(**kw)
    assert grouped.route == single.route == "gram"
    idx, val, num, mask, y, _ = small_parts()
    wire = FeatureBatch(idx[:2] * 97, val[:2], num[:2], y[:2], mask[:2])
    w = torch.zeros((2, F + 4))
    valid = tenant_valid_rows(mask[:2].numpy())
    (wg, og), (ws, os_) = grouped(w, wire, valid), single(w, wire, valid)
    torch.testing.assert_close(wg, ws, rtol=1e-6, atol=1e-7)
    assert torch.equal(og.count, os_.count) and torch.equal(og.predictions, os_.predictions)


# ---- the tenant forms' plain versions and plans

SMALL_F = 300
VALID = (48, 0, 17, 33)  # tenant 1 dry


def small_parts(seed=11, b=48, l=12, peak=3):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, SMALL_F, size=(M, b, l)).astype(np.int32)
    val = rng.integers(1, peak, size=(M, b, l)).astype(np.float32)
    val[:, :, -3:] = 0.0  # padding slots
    idx[:, :, -3:] = 0
    for m, v in enumerate(VALID):  # rows past a part's valid ones are padding
        idx[m, v:] = 0
        val[m, v:] = 0.0
    num = (rng.normal(size=(M, b, 4)) * 0.1).astype(np.float32)
    mask = np.zeros((M, b), np.float32)
    for m, v in enumerate(VALID):
        mask[m, :v] = (rng.random(v) < 0.85).astype(np.float32)
        if v:
            mask[m, v - 1] = 1.0
    y = rng.uniform(50, 900, size=(M, b)).astype(np.float32)
    u = (rng.normal(size=(M, b)) * 10).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (idx, val, num, mask, y, u))


@pytest.mark.parametrize("int8", [True, False])
def test_the_count_builds_plain_version_is_m_calls_of_b4s(int8):
    idx, val, *_ = small_parts()
    tenants = (3, 1, 0)
    counts, at = fused_gram.count_build_tenants(idx, val, SMALL_F, valid_rows=VALID,
                                                int8=int8, tenants=tenants)
    assert counts.dtype == (torch.int8 if int8 else torch.float32)
    rows = [fused_gram.tenant_padded_rows(VALID[t]) for t in tenants]
    assert at == (0, rows[0], rows[0] + rows[1]) and counts.shape == (sum(rows), SMALL_F)
    for t, first, r in zip(tenants, at, rows):
        v = VALID[t]
        want = fused_gram.count_build_reference(idx[t, :v], val[t, :v], SMALL_F, int8=int8,
                                                rows_out=r, cols_out=SMALL_F)
        assert torch.equal(counts[first:first + r], want)
    plan = fused_gram.count_tenants_plan(VALID, tenants, idx.shape[2], shared_limit=232_448)
    assert plan.at == at and plan.rows == counts.shape[0]


@pytest.mark.parametrize("mode", ["least_squares", "logistic", "sampled", "tol_0"])
def test_the_dual_loops_plain_version_is_m_calls_of_b7s(mode):
    from twtml_tpu_torch.models.sgd import sampling_masks
    from twtml_tpu_torch.ops.gram import add_numeric_block

    idx, val, num, mask, y, u = small_parts()
    counts, at = fused_gram.count_build_tenants(idx, val, SMALL_F, valid_rows=VALID, int8=True)
    gs = fused_gram.tenant_gram_blocks(counts, at, VALID)
    assert gs[1] is None and all(g.shape[0] == fused_gram.tenant_padded_rows(v)
                                 for g, v in zip(gs, VALID) if v)
    residual = logistic_residual if mode == "logistic" else least_squares_residual
    labels = (y > 475).float() if mode == "logistic" else y
    masks = (sampling_masks(mask.shape[1], 20, 0.5, torch.float32, "cpu")
             if mode == "sampled" else None)
    kw = dict(num_iterations=20, convergence_tol=0.0 if mode == "tol_0" else 0.001,
              residual_fn=residual)
    p_prev = torch.tensor([3.0, 1.0, 0.5, 2.0])
    c, alpha, its = fused_gram.dual_sgd_tenants(
        gs, u, labels, mask, num, valid_rows=VALID, masks=masks, p_prev=p_prev,
        step_sizes=STEP_SIZES, l2_regs=L2_REGS, **kw)
    assert c.shape == its.shape == (M,) and alpha.shape == mask.shape
    for m, v in enumerate(VALID):
        if not v:  # dry: c = 1 with no update, N iterations
            assert float(c[m]) == 1.0 and not alpha[m].any() and float(its[m]) == 20
            continue
        g = add_numeric_block(gs[m][:v, :v].float(), num[m, :v])
        cm, am, im = fused_gram.dual_sgd_reference(
            g, u[m, :v], labels[m, :v], mask[m, :v],
            masks=None if masks is None else masks[:, :v], p_prev=p_prev[m],
            step_size=STEP_SIZES[m], l2_reg=L2_REGS[m], **kw)
        assert torch.equal(c[m], cm) and torch.equal(alpha[m, :v], am)
        assert float(its[m]) == int(im) and not alpha[m, v:].any()


def test_the_write_backs_plain_version_is_m_calls_of_b8s():
    idx, val, num, mask, y, u = small_parts()
    rng = np.random.default_rng(5)
    w = torch.from_numpy((rng.normal(size=(M, SMALL_F + 4)) * 1e-2).astype(np.float32))
    c = torch.tensor([0.97, 1.0, 0.99, 0.95])
    alpha = torch.from_numpy((rng.normal(size=mask.shape) * 1e-3).astype(np.float32))
    tenants = (0, 2, 1)
    out = torch.full_like(w, 7.0)
    got = fused_gram.dual_writeback_tenants(w, c, alpha, idx, val, num, SMALL_F,
                                            valid_rows=VALID, tenants=tenants, out=out)
    assert got is out and torch.equal(out[3], torch.full_like(w[3], 7.0))  # not a tenant here
    for t in tenants:
        v = VALID[t]
        want = fused_gram.dual_writeback_reference(w[t], c[t], alpha[t, :v], idx[t, :v],
                                                   val[t, :v], num[t, :v], SMALL_F)
        assert torch.equal(out[t], want)
    assert torch.equal(out[1], w[1] * c[1])  # the dry tenant: c·W_prev


H100_SMS, H100_SHARED = 132, 232_448
PLAN_CASES = {
    "config_4": [512, 530, 498, 508],
    "skewed_1_3_0_12": [100, 300, 0, 1200],
    "one_tenant_at_the_gate": [4096],
    "all_dry": [0, 0, 0, 0],
    "tiny": [1, 3, 0, 12],
    "sixteen": [128] * 15 + [0],
    "thirty_two": [64] * 32,
    "two": [700, 1300],
    "eight_uneven": [40 * (t + 1) for t in range(8)],
    "twelve_with_dry": [0, 300] * 6,
    "a_row_each_of_32": [1] * 32,
    "thirty_one_and_a_dry": [96] * 31 + [0],
    "one_big_one_tiny": [3000, 2],
    "the_gate_and_a_dry": [4096, 0],
    "three_of_1365": [1365, 1365, 1366],
    "b7_at_2048": [2048],
    "b7_at_3072": [3072],
    "past_the_register_width": [2052],
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_the_dual_tenants_plan_at_an_h100s_numbers(case):
    valid = PLAN_CASES[case]
    plan = fused_gram.dual_tenants_plan(valid, sm_count=H100_SMS, shared_limit=H100_SHARED)
    assert 1 <= plan.grid <= min(H100_SMS, fused_gram.DUAL_MAX_GRID)
    assert plan.shared_bytes <= H100_SHARED and plan.smem_layout[-1] <= plan.shared_bytes
    ctas = [plan.first_cta[t + 1] - plan.first_cta[t] for t in range(len(valid))]
    assert all(k >= 1 for v, k in zip(valid, ctas) if v)
    assert all(k == 0 for v, k in zip(valid, ctas) if not v) or not any(valid)
    assert all(k <= -(-v // fused_gram.DUAL_WARPS) for v, k in zip(valid, ctas) if v)
    spill = 0
    for t, v in enumerate(valid):
        owned = [0] * v
        for k in range(ctas[t] if v else 0):
            rows = plan.cta_rows(t, k)
            assert len(rows) <= plan.rows_cap[t] <= plan.rows_cap_max
            for r in rows:
                owned[r] += 1
        assert all(n == 1 for n in owned)  # every valid row, exactly once
        bp = -(-v // 4) * 4
        if plan.in_registers:  # every CTA's rows in registers, none in shared memory
            assert plan.resident[t] == plan.rows_cap[t] <= fused_gram.DUAL_ROWS
            assert bp <= 4 * fused_gram.DUAL_THREADS * fused_gram.DUAL_REG_COLUMNS
        else:
            assert plan.smem_layout[-1] + plan.resident[t] * 4 * bp <= plan.shared_bytes
        assert plan.spill_at[t] == spill
        spill += ctas[t] * (plan.rows_cap[t] - plan.resident[t]) * bp
    assert plan.spill_floats == spill
    assert plan.abuf_floats % 4 == 0 and plan.abuf_floats >= sum(-(-v // 4) * 4 for v in valid)
    # G in registers exactly where each tenant's CTAs hold at most DUAL_ROWS rows of at most
    # 4·DUAL_THREADS·DUAL_REG_COLUMNS columns; then nothing of G in shared memory
    assert plan.in_registers == (any(valid) and all(
        fused_gram.in_registers(plan.rows_cap[t], -(-v // 4) * 4) for t, v in enumerate(valid)
        if v))
    if plan.in_registers:
        assert plan.shared_bytes == plan.smem_layout[-1] and plan.spill_floats == 0
    assert plan.scratch_floats == 2 * plan.abuf_floats + 16 * plan.grid
    if case == "config_4":  # CTAs in proportion to v², 16 rows a CTA: G in registers
        assert plan.grid == H100_SMS and plan.spill_floats == 0 and plan.in_registers
    if case == "skewed_1_3_0_12":  # tenant 0's one CTA holds its 100 rows: shared memory
        assert ctas[0] < ctas[1] < ctas[3] and plan.grid == H100_SMS and not plan.in_registers
    if case == "b7_at_2048":  # B7's batch: 16 rows a CTA of 2048 columns, in registers
        assert plan.grid == H100_SMS and plan.rows_cap == (16,) and plan.in_registers
    if case in ("b7_at_3072", "past_the_register_width"):  # 24 rows a CTA; 2052 columns
        assert not plan.in_registers and plan.rows_cap[0] == -(-valid[0] // H100_SMS)
    if case == "one_tenant_at_the_gate":  # 4096 rows: G spills past shared memory
        # B7's own launch at B = 4096: 132 CTAs of 32 rows, 12 of them resident
        # in 232,448 B, the other 20 spilled
        assert plan.grid == 132 and plan.rows_cap_max == 32 and not plan.in_registers
        assert plan.resident == (12,) and plan.spill_floats == 132 * 20 * 4096


COUNT_PLAN_CASES = {
    "config_4_all": ((512, 530, 498, 508), (0, 1, 2, 3), 63),
    "a_subset_in_order": ((512, 0, 498, 9), (3, 0), 63),
    "dry_tenants_take_no_rows": ((0, 17, 0, 1), (0, 1, 2, 3), 48),
    "tweet_length_tokens": ((300, 200), (1, 0), 511),
    "one_token_a_row": ((8, 16, 24), (0, 1, 2), 1),
    "forty_tenants": (tuple(range(40)), tuple(range(40)), 63),
}


@pytest.mark.parametrize("case", list(COUNT_PLAN_CASES))
def test_the_count_tenants_plan_lays_each_tenants_block(case):
    valid, tenants, tokens = COUNT_PLAN_CASES[case]
    plan = fused_gram.count_tenants_plan(valid, tenants, tokens, shared_limit=H100_SHARED)
    blocks = [fused_gram.tenant_padded_rows(valid[t]) for t in tenants]
    assert plan.valid_rows == tuple(valid[t] for t in tenants)
    assert plan.at == tuple(sum(blocks[:i]) for i in range(len(blocks)))
    assert plan.rows == sum(blocks)
    assert all(b == 0 or (b % 8 == 0 and b >= max(24, v))
               for b, v in zip(blocks, plan.valid_rows))
    assert plan.shared_bytes == fused_gram.count_layout(tokens).shared_bytes
    covered = [i for lo, hi in plan.launches for i in range(lo, hi)]
    assert all(hi - lo <= fused_gram.TENANTS_PER_LAUNCH for lo, hi in plan.launches)
    # every tenant with rows is in one launch, and no launch is of dry tenants alone
    assert sorted(covered) == covered and len(set(covered)) == len(covered)
    assert {i for i, b in enumerate(blocks) if b} <= set(covered)
    assert all(any(blocks[lo:hi]) for lo, hi in plan.launches)


def test_the_tenant_plans_refuse_what_one_launch_cannot_take():
    kw = dict(sm_count=H100_SMS, shared_limit=H100_SHARED)
    with pytest.raises(ValueError, match="1..32 tenants"):
        fused_gram.dual_tenants_plan([8] * 33, **kw)
    with pytest.raises(ValueError, match="need a CTA each"):
        fused_gram.dual_tenants_plan([8] * 8, sm_count=4, shared_limit=H100_SHARED)
    with pytest.raises(ValueError, match="shared memory"):
        fused_gram.dual_tenants_plan([40_000], **kw)
    # the in-register instantiation's condition, as the C entry checks it: at
    # most DUAL_ROWS rows a CTA of at most 4·DUAL_THREADS·DUAL_REG_COLUMNS columns
    width = 4 * fused_gram.DUAL_THREADS * fused_gram.DUAL_REG_COLUMNS
    assert fused_gram.in_registers(fused_gram.DUAL_ROWS, width)
    assert not fused_gram.in_registers(fused_gram.DUAL_ROWS + 1, 4)
    assert not fused_gram.in_registers(1, width + 4)
    assert not fused_gram.dual_tenants_plan([0, 0], **kw).in_registers  # no row, no G
    with pytest.raises(ValueError, match="shared memory"):
        fused_gram.count_tenants_plan([4, 4], (0, 1), 40_000, shared_limit=H100_SHARED)
    # past 32 tenants the B4 plan splits into consecutive launches; a launch
    # of dry tenants alone is left out
    plan = fused_gram.count_tenants_plan([3] * 40 + [0] * 32, range(72), 63,
                                         shared_limit=H100_SHARED)
    assert plan.launches == ((0, 32), (32, 64))


REFUSED = {
    "valid rows past a part's rows": (dict(valid_rows=[49, 0, 0, 0]), r"in \[0, 48\]"),
    "a residual without a mode": (dict(residual_fn=torch.tanh), "no residual mode"),
    "three step sizes for four tenants": (dict(step_sizes=[0.1] * 3), "4 tenants need"),
    "negative iterations": (dict(num_iterations=-1), "num_iterations"),
}


@pytest.mark.parametrize("case", list(REFUSED) + ["the probe on the CPU",
                                                   "the probe past one launch"])
def test_the_dual_tenants_wrapper_refuses_what_it_cannot_take(case):
    """The tenant form's wrapper, and its timing probe (the card only, one
    launch of at most TENANTS_PER_LAUNCH tenants), refuse before any work."""
    idx, val, num, mask, y, u = small_parts()
    kw = dict(valid_rows=list(VALID), p_prev=torch.ones(M), num_iterations=2,
              step_sizes=list(STEP_SIZES), l2_regs=list(L2_REGS))
    if case == "the probe on the CPU":
        with pytest.raises(ValueError, match="on the card"):
            fused_gram.dual_tenants_probe([None] * M, u, y, mask, num, **kw)
        return
    if case == "the probe past one launch":
        many = fused_gram.TENANTS_PER_LAUNCH + 1
        with pytest.raises(ValueError, match="1..32 tenants in one launch"):
            fused_gram.dual_tenants_probe(
                [None] * many, torch.zeros(many, 4), torch.zeros(many, 4),
                torch.zeros(many, 4), torch.zeros(many, 4, 4), valid_rows=[0] * many,
                p_prev=torch.ones(many), num_iterations=2, step_sizes=[0.1] * many,
                l2_regs=[0.0] * many)
        return
    bad, match = REFUSED[case]
    with pytest.raises(ValueError, match=match):
        fused_gram.dual_sgd_tenants([None] * M, u, y, mask, num, **dict(kw, **bad))


WRAPPER_REFUSALS = {
    "count build: 2-D tokens": ("count", dict(token_idx=torch.zeros((4, 3), dtype=torch.int32)),
                                r"\[M, B, L\]"),
    "count build: a tenant past the stack": ("count", dict(tenants=(0, 4)), "outside"),
    "count build: valid rows past a part": ("count", dict(valid_rows=(49, 0, 0, 0)),
                                            r"in \[0, 48\]"),
    "write-back: first rows for another tenant count": ("writeback", dict(first_rows=(0,)),
                                                         "first rows"),
    "write-back: a tenant twice": ("writeback", dict(tenants=(0, 0)), "tenants"),
    "write-back: a tenant past the stack": ("writeback", dict(tenants=(5,)), "tenants"),
}


@pytest.mark.parametrize("case", list(WRAPPER_REFUSALS))
def test_the_count_and_write_back_wrappers_refuse_what_they_cannot_take(case):
    idx, val, num, mask, y, u = small_parts()
    which, bad, match = WRAPPER_REFUSALS[case]
    if which == "count":
        kw = dict(dict(token_idx=idx, valid_rows=VALID, tenants=None), **bad)
        with pytest.raises(ValueError, match=match):
            fused_gram.count_build_tenants(kw.pop("token_idx"), val, SMALL_F, int8=True, **kw)
        return
    kw = dict(dict(tenants=(0, 1, 2, 3)), **bad)
    with pytest.raises(ValueError, match=match):
        fused_gram.dual_writeback_tenants(torch.zeros((M, SMALL_F + 4)), torch.ones(M),
                                          torch.zeros(mask.shape), idx, val, num, SMALL_F,
                                          valid_rows=VALID, **kw)


# ---- the sparse regime's tenant axis and batched loops, against each tenant alone

AXIS_SHAPES = [(1, 5, 3), (3, 7, 11), (4, 16, 1), (16, 2, 4)]


@pytest.mark.parametrize("shape", AXIS_SHAPES)
@pytest.mark.parametrize("view", [True, False], ids=["stack_view", "contiguous"])
def test_the_sparse_ops_tenant_axis_is_each_tenant_alone(shape, view):
    """One gather and one ``index_add_`` for M tenants: tenant m's text dot
    and gradient are its own call's bitwise (on the CPU ``index_add_`` is
    sequential), whether the weights are the [M, F + 4] stack's text view
    or a contiguous [M, F]; the margins within float rounding (the numeric
    part is one batched product)."""
    from twtml_tpu_torch.ops.sparse import sparse_grad_text, sparse_predict, sparse_text_dot

    m, b, l = shape
    f = 50
    rng = np.random.default_rng(sum(shape))
    w = torch.from_numpy(rng.normal(size=(m, f + 4)).astype(np.float32))
    w_text = w[:, :f] if view else w[:, :f].contiguous()
    idx = torch.from_numpy(rng.integers(0, f, size=(m, b, l)).astype(np.int32))
    val = torch.from_numpy(rng.integers(0, 3, size=(m, b, l)).astype(np.float32))
    num = torch.from_numpy(rng.normal(size=(m, b, 4)).astype(np.float32))
    res = torch.from_numpy(rng.normal(size=(m, b)).astype(np.float32))
    dot, raw = sparse_text_dot(w_text, idx, val), sparse_predict(w_text, w[:, f:], idx, val, num)
    grad = sparse_grad_text(idx, val, res, f)
    assert grad.shape == (m, f) and raw.shape == (m, b)
    for t in range(m):
        assert torch.equal(dot[t], sparse_text_dot(w[t, :f], idx[t], val[t]))
        assert torch.equal(grad[t], sparse_grad_text(idx[t], val[t], res[t], f))
        torch.testing.assert_close(raw[t], sparse_predict(w[t, :f], w[t, f:], idx[t], val[t],
                                                          num[t]), rtol=1e-6, atol=1e-6)


LOOP_MODES = {
    "least_squares": {},
    "logistic": {"logistic": True},
    "sampled": {"sampled": True},
    "tol_0": {"tol": 0.0},
    "per_tenant_hyperparams": {"hyper": True},
}


def loop_inputs(mode, m=3, b=24, f=60, seed=4):
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, f, size=(m, b, 6)).astype(np.int32))
    val = torch.from_numpy(rng.integers(0, 3, size=(m, b, 6)).astype(np.float32))
    num = torch.from_numpy((rng.normal(size=(m, b, 4)) * 0.1).astype(np.float32))
    mask = torch.from_numpy((rng.random((m, b)) < 0.8).astype(np.float32))
    mask[1, 15:] = 0.0  # a part with padding at its end
    y = torch.from_numpy(rng.uniform(0, 5, size=(m, b)).astype(np.float32))
    if mode.get("logistic"):
        y = (y > 2.5).float()
    w = torch.from_numpy((rng.normal(size=(m, f + 4)) * 0.1).astype(np.float32))
    steps = [0.05, 0.1, 0.2][:m] if mode.get("hyper") else [0.1] * m
    l2s = [0.0, 0.01, 0.1][:m] if mode.get("hyper") else [0.01] * m
    return idx, val, num, mask, y, w, steps, l2s


@pytest.mark.parametrize("mode", list(LOOP_MODES))
def test_the_batched_scatter_loop_is_each_tenants_loop(mode):
    """``sparse_sgd_loop`` with a step table (the vmap form's scatter route)
    against the loop run tenant by tenant with each tenant's step size and
    L2, within float rounding: the same iterations, masks and freezes."""
    from twtml_tpu_torch.models.sgd import sampling_masks, sparse_sgd_loop, tenant_step_table

    opts = LOOP_MODES[mode]
    idx, val, num, mask, y, w, steps, l2s = loop_inputs(opts)
    m, b = mask.shape
    residual = logistic_residual if opts.get("logistic") else least_squares_residual
    masks = sampling_masks(b, 12, 0.5, torch.float32, "cpu") if opts.get("sampled") else None
    kw = dict(num_text_features=60, num_iterations=12, convergence_tol=opts.get("tol", 0.001),
              masks=masks, residual_fn=residual)
    table = tenant_step_table(steps, l2s, 12, torch.float32)
    got = sparse_sgd_loop(w, idx, val, num, y, mask, step_size=None,
                          step_table=(table[0], table[1]), **kw)
    for t in range(m):
        want = sparse_sgd_loop(w[t], idx[t], val[t], num[t], y[t], mask[t], step_size=steps[t],
                               l2_reg=l2s[t], **kw)
        torch.testing.assert_close(got[t], want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["least_squares", "logistic", "sampled", "per_tenant_hyperparams"])
def test_the_batched_gram_steps_plain_route_is_each_tenants_step(mode):
    """The vmap form's Gram route off the card (its plain pieces, tenant by
    tenant over each part's valid rows) against ``make_sgd_train_step``'s
    Gram route on each whole part: within float rounding, the rounded
    predictions and counts equal."""
    from twtml_tpu_torch.features.batch import FeatureBatch, tenant_valid_rows
    from twtml_tpu_torch.models.sgd import make_sgd_train_step

    opts = LOOP_MODES[mode]
    idx, val, num, mask, y, w, steps, l2s = loop_inputs(opts)
    m, b = mask.shape
    knobs = dict(num_text_features=60, num_iterations=12, use_sparse=True, use_gram=True,
                 mini_batch_fraction=0.5 if opts.get("sampled") else 1.0,
                 residual_fn=logistic_residual if opts.get("logistic") else None)
    step = make_sgd_tenant_step(num_tenants=m, step_sizes=steps, l2_regs=l2s, **knobs)
    assert step.route == "gram"
    wire = FeatureBatch(idx, val, num, y, mask)
    w_new, out = step(w, wire, tenant_valid_rows(mask.numpy()))
    for t in range(m):
        single = make_sgd_train_step(step_size=steps[t], l2_reg=l2s[t], **knobs)
        w_t, out_t = single(w[t], FeatureBatch(idx[t], val[t], num[t], y[t], mask[t]))
        torch.testing.assert_close(w_new[t], w_t, rtol=1e-5, atol=1e-6)
        assert torch.equal(out.predictions[t], out_t.predictions)
        assert torch.equal(out.count[t], out_t.count)


@pytest.mark.parametrize("entry", ["twtml_count_build", "twtml_dual_sgd_tenants",
                                   "twtml_dual_writeback"])
def test_each_tenant_entry_takes_the_wrapper_arguments(entry):
    """Each C entry a tenant form launches (B4's and B8's own, which a
    single batch calls as one tenant, and B7's tenant form) takes a tenant
    count and as many parameters as its ctypes argument list in
    ops/fused_gram.py."""
    source = (pathlib.Path(fused_gram.__file__).parents[1] / "csrc" / "gram.cu").read_text()
    params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', source).group(1).split(",")
    assert "int tenants" in [p.strip() for p in params]
    assert len(params) == len(fused_gram._ENTRIES[entry])


def test_each_parts_plane_comes_from_the_host_wire():
    """A mixed-plane tick: the long row's part leaves the int8 plane, the
    others stay in it (host metadata, one plane a part)."""
    model = TenantStackModel(M, mapping="vmap", device="cpu", **BASE)
    wire = model.prepare_wire(batches(False, n=1, long_row=True)[0])
    planes = host_planes(wire)
    assert len(planes) == M and model.planes(wire) == planes
    assert planes.count(PLANE_INT8) == M - 1
