"""B7's tenant form (``csrc/gram.cu`` ``dual_tenants_kernel``) modelled in f32
on the CPU, against its plain version (``ops/fused_gram.dual_sgd_tenants_
reference``) and the JAX package's ``run_dual_loop`` under ``jax.vmap``: the
same iterations run by each tenant, case by case.

The schedule modelled: one grid barrier an iteration. Each tenant's update
is published before it; past it the pending tests (the last iteration's)
are decided, while G·α of the new update is taken and its test's partials
are written. A tenant's CTAs read the decisions at the top of the next
iteration: where its test converged, the update made meanwhile (if any) is
dropped and the tested state is the result, and the tenant freezes; it
updates no more, but its CTAs still cross the barriers. The launch ends at
the top of the iteration after every tenant with rows froze, or at N; the
last update crosses a barrier only to decide a pending test. An iteration
whose draws select none of a tenant's rows leaves that tenant as it is and
is not its convergence. With one tenant with rows the loop is B7's: such an
iteration is skipped whole, no barrier.

The decisions' summation order, the same bits in every CTA, over the CTAs
of the plan (``dual_tenants_plan`` at an H100's 132 SMs): with one tenant
with rows B7's order exactly (CTA λ + 32·i on lane λ of the decider warp,
each lane's CTAs in i order, then the lanes' sums by a butterfly of offsets
16, 8, 4, 2, 1, as ``warp_sum`` does); with more, the lanes stage the loaded
partials in shared memory by CTA and L lanes take each tenant (L the
largest power of two with L·tenants <= 32): lane j sums the tenant's CTAs
first + j + L·i in order, then the L lanes' sums by a butterfly. A CTA's
partials are its rows' f32 sums; the model's G·α
is a torch f32 matmul (another order than the kernel's, with the same f32
rounding), so α is held within rtol 1e-5 of the plain version."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from twtml_tpu.models import sgd as jax_sgd

from twtml_tpu_torch.models.sgd import _step_scalars, sampling_masks
from twtml_tpu_torch.ops import fused_gram
from twtml_tpu_torch.ops.fused_sgd import least_squares_residual, logistic_residual
from twtml_tpu_torch.ops.gram import add_numeric_block

from test_torch_dual_form import dual_inputs, kernel_model

ITERATIONS = 50
SM_COUNT, SHARED = 132, 232_448  # an H100's: the plan's CTAs, hence the decisions' order


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The model's torch ops are small: one thread each runs them fastest,
    and keeps this module's pace beside other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
PART_ROWS = 256  # every case's parts: one compiled JAX loop a tolerance and mode
JAX_TENANTS = 16  # the JAX stack, padded with tenants of no valid row


def butterfly(x, width=32):
    """The sum of ``width`` lanes' f32 values by xor shuffles of offsets
    width/2, ..., 1 (``warp_sum`` at 32): the same bits in every lane."""
    x = np.asarray(x, np.float32)
    lanes = np.arange(width)
    off = width // 2
    while off:
        x = (x + x[lanes ^ off]).astype(np.float32)
        off //= 2
    return x[0]


def decide(plan, parts, meta, tol):
    """Every tenant's decision from the CTAs' partials ``parts`` [grid, 4]
    f32 and ``meta[t]`` = (tested, c_new, c_old, p) of its update: the
    set of tenants whose test converged. One tenant with rows: B7's order
    (lane λ sums CTAs λ + 32·i in i order, then the butterfly); more: L
    lanes a tenant (the largest power of two with L·tenants <= 32), lane j
    summing its CTAs first + j + L·i in order, then a butterfly of the L."""
    f = np.float32
    solo = sum(1 for v in plan.valid_rows if v) == 1
    conv = set()
    for t, (tested, c_new, c_old, p) in meta.items():
        if not tested:
            continue
        first, end = plan.first_cta[t], plan.first_cta[t + 1]
        if solo:
            padded = np.zeros((5 * 32, 4), np.float32)
            padded[:plan.grid] = parts
            lane_sums = np.zeros((32, 4), np.float32)
            for i in range(5):  # each lane's CTAs in i order
                lane_sums = (lane_sums + padded[32 * i:32 * (i + 1)]).astype(np.float32)
            q = [butterfly(lane_sums[:, j]) for j in range(4)]
        else:  # L lanes a tenant: lane j sums CTAs first + j + L·i in order, then a butterfly
            lanes = 32 >> (len(plan.valid_rows) - 1).bit_length()
            lane_sums = np.zeros((lanes, 4), np.float32)
            for j in range(lanes):
                for k in range(first + j, end, lanes):
                    lane_sums[j] = (lane_sums[j] + parts[k]).astype(np.float32)
            q = [butterfly(lane_sums[:, j], lanes) for j in range(4)]
        dc = f(c_new) - f(c_old)
        d2 = dc * dc * f(p) + f(2.0) * dc * q[2] + q[0]
        n2 = f(c_new) * f(c_new) * f(p) + f(2.0) * f(c_new) * q[3] + q[1]
        with np.errstate(invalid="ignore"):  # a d2 below 0 by cancellation: NaN, no stop
            if np.sqrt(d2) < f(tol) * max(np.sqrt(n2), f(1.0)):
                conv.add(t)
    return conv


def tenants_model(gs, u, y, mask, numeric, *, valid, masks, p_prev, num_iterations, step_sizes,
                  l2_regs, tol, residual_fn):
    """The tenant form's loop in f32: (c [M], α [M, B], iterations run [M],
    grid barriers crossed)."""
    m, b = mask.shape
    plan = fused_gram.dual_tenants_plan(valid, sm_count=SM_COUNT, shared_limit=SHARED)
    live = [t for t in range(m) if valid[t]]
    solo = len(live) == 1
    c_out = torch.ones(m)
    alpha_out = torch.zeros((m, b))
    ran = [num_iterations] * m
    st = {}
    for t in live:
        v = valid[t]
        keep = mask[t, :v] > 0
        g = add_numeric_block(gs[t][:v, :v].float(), numeric[t, :v])
        st[t] = dict(
            keep=keep, mask=mask[t, :v], g=torch.where(keep[:, None] & keep[None, :], g, 0.0),
            u=torch.where(keep, u[t, :v], 0.0), y=torch.where(keep, y[t, :v], 0.0),
            alpha=torch.zeros(v), s=torch.zeros(v), c=torch.tensor(1.0), frozen=False,
            ctas=[plan.cta_rows(t, k) for k in range(plan.first_cta[t + 1] - plan.first_cta[t])])
    barriers = 0
    pending = None  # (partials [grid, 4], meta by tenant, each tenant's tested iteration)
    decided = None  # (converged tenants, the tested state by tenant, whether each updated since)
    finished = not live
    for it in range(1, num_iterations + 1):
        if finished:
            break
        new = {}
        for t in live:
            z = st[t]
            sel = z["mask"] if masks is None else z["mask"] * masks[it - 1, :valid[t]]
            count = torch.sum(sel)
            if not z["frozen"] and count > 0:
                new[t] = (sel, count)
        if solo and not new:
            continue
        if decided is not None:
            conv, tested = decided
            decided = None
            for t in conv:
                if t in st and not st[t]["frozen"]:
                    ran[t], st[t]["alpha"], st[t]["s"], st[t]["c"] = tested[t]
                    st[t]["frozen"] = True
                    new.pop(t, None)
            if all(st[t]["frozen"] for t in live):
                finished = True
                break
        upd = {}
        for t, (sel, count) in new.items():
            z = st[t]
            eta, scale = _step_scalars(step_sizes[t], l2_regs[t], it, torch.float32)
            res = torch.where(z["keep"], residual_fn(z["c"] * z["u"] + z["s"], z["y"]) * sel, 0.0)
            upd[t] = (z["alpha"] * scale - eta * res / torch.clamp(count, min=1.0),
                      z["c"] * scale)
        last = it == num_iterations
        if last and pending is None:
            for t, (a_new, c_new) in upd.items():
                st[t]["alpha"], st[t]["c"] = a_new, c_new
            finished = True
            break
        barriers += 1
        if last:
            conv = decide(plan, *pending[:2], tol)
            for t in live:
                if not st[t]["frozen"] and t in conv:
                    ran[t] = pending[2][t]
                elif t in upd:
                    st[t]["alpha"], st[t]["c"] = upd[t]
            finished = True
            break
        s_new = {t: st[t]["g"] @ a_new for t, (a_new, _) in upd.items()}
        nxt = None
        if tol > 0:
            parts = np.zeros((plan.grid, 4), np.float32)
            meta, tested_it = {}, {}
            for t in live:
                z = st[t]
                meta[t] = (False, 0.0, 0.0, 0.0)
                tested_it[t] = 0
                if t not in upd:
                    continue
                a_new, c_new = upd[t]
                d = a_new - z["alpha"]
                terms = torch.stack([d * (s_new[t] - z["s"]), a_new * s_new[t], z["u"] * d,
                                     z["u"] * a_new])
                for k, rows in enumerate(z["ctas"]):
                    parts[plan.first_cta[t] + k] = torch.sum(
                        terms[:, rows.start:rows.stop], dim=1).numpy()
                meta[t] = (True, float(c_new), float(z["c"]), float(p_prev[t]))
                tested_it[t] = it
            nxt = (parts, meta, tested_it)
        if pending is not None:
            tested = {t: (pending[2][t], st[t]["alpha"], st[t]["s"], st[t]["c"]) for t in live}
            decided = (decide(plan, *pending[:2], tol), tested)
        pending = nxt
        for t, (a_new, c_new) in upd.items():
            st[t]["alpha"], st[t]["s"], st[t]["c"] = a_new, s_new[t], c_new
    else:
        if not finished and solo:  # the tail selected no row: one barrier decides the last test
            (t,) = live
            if decided is not None and t in decided[0]:
                ran[t], st[t]["alpha"], st[t]["s"], st[t]["c"] = decided[1][t]
            elif pending is not None:
                barriers += 1
                if t in decide(plan, *pending[:2], tol):
                    ran[t] = pending[2][t]
    for t in live:
        c_out[t] = st[t]["c"]
        alpha_out[t, :valid[t]] = st[t]["alpha"]
    return c_out, alpha_out, ran, barriers


# the cases' parts: valid rows of PART_ROWS, and the tenants whose labels
# sit near the margins (their tests converge early)
STRUCTURES = {
    "M=1": ((PART_ROWS,), (0,)),
    "M=2": ((100, PART_ROWS), ()),
    "M=4": ((180, 200, 170, PART_ROWS), ()),
    "M=16": (tuple(40 + 13 * t for t in range(16)), ()),
    "a dry tenant": ((150, 0, 220, 90), ()),
    "skew 1:3:0:12": ((16, 48, 0, 192), ()),
    "tenants 0 and 2 freeze early": ((180, 200, 170, PART_ROWS), (0, 2)),
}
NOISES = (None, 3, None, 30, 1, None, 10, 100, None, 0.3)  # label noise by tenant
P_PREVS = (3.0, 3000.0)


def tenant_inputs(valid, near, logistic, seed):
    """M parts of PART_ROWS rows: tenant t's first valid[t] rows from
    ``dual_inputs`` (~7 % masked, labels near the margins at a noise by
    tenant, or at 1 for the ``near`` ones), the rest padding, and numeric
    features whose N·Nᵀ the form adds. Returns numpy (text G [M, B, B], u,
    y, mask [M, B], numeric [M, B, 4], p_prev [M])."""
    rng = np.random.default_rng(seed)
    m, b = len(valid), PART_ROWS
    g = np.zeros((m, b, b), np.float32)
    num = np.zeros((m, b, 4), np.float32)
    u, y, mask = (np.zeros((m, b), np.float32) for _ in range(3))
    for t, v in enumerate(valid):
        if not v:
            continue
        noise = 1 if t in near else NOISES[t % len(NOISES)]
        gt, ut, yt, mt = dual_inputs(rng, v, v - v // 14, noise, logistic, cols=1024)
        nt = (rng.normal(size=(v, 4)) * 0.1).astype(np.float32)
        g[t, :v, :v] = gt  # the text G (dual_inputs' holds a numeric block of its own)
        num[t, :v] = nt
        u[t, :v], y[t, :v], mask[t, :v] = ut, yt, mt
    p_prev = np.array([P_PREVS[t % 2] for t in range(m)], np.float32)
    return g, u, y, mask, num, p_prev


def _jax_vmap_impl(u, g, y, mask, p_prev, step, l2, n, *, tol, fraction, logistic):
    residual = ((lambda raw, lab: jax.nn.sigmoid(raw) - lab) if logistic
                else (lambda raw, lab: raw - lab))

    def one(u, g, y, mask, p_prev, step, l2):
        return jax_sgd.run_dual_loop(
            u=u, g=g, labels=y, mask=mask, dtype=jnp.float32, residual_fn=residual,
            num_iterations=n, step_size=step, mini_batch_fraction=fraction, l2_reg=l2,
            convergence_tol=tol, p_prev=p_prev)

    return jax.vmap(one)(u, g, y, mask, p_prev, step, l2)


_jax_vmap = jax.jit(_jax_vmap_impl, static_argnames=("tol", "fraction", "logistic"))


def jax_vmap_states(g, u, y, mask, p_prev, steps, l2s, ns, **kw):
    """The JAX package's run_dual_loop under jax.vmap over the tenants (the
    stack padded to JAX_TENANTS tenants of no valid row), G with its
    numeric block, after each of ``ns`` iterations: {n: (c [M], α [M, B])}."""
    m = mask.shape[0]

    def pad(a):
        return np.concatenate([a, np.zeros((JAX_TENANTS - m,) + a.shape[1:], a.dtype)])

    args = [jnp.asarray(pad(a)) for a in (u, g, y, mask, p_prev,
                                          np.asarray(steps, np.float32),
                                          np.asarray(l2s, np.float32))]
    out = {}
    for n in sorted(set(ns)):
        dual = _jax_vmap(*args, jnp.int32(n), **kw)
        out[n] = (np.asarray(dual["c"])[:m], np.asarray(dual["alpha"])[:m])
    return out


def hyper(m, logistic):
    steps = [0.1 if logistic else 0.005 * (1 + t % 3) for t in range(m)]
    l2s = [0.001 if logistic else (0.1, 0.0, 0.01)[t % 3] for t in range(m)]
    return steps, l2s


def check_case(structure, tol, logistic, sampled):
    valid, near = STRUCTURES[structure]
    m = len(valid)
    seed = 2400 + list(STRUCTURES).index(structure)
    g, u, y, mask, num, p_prev = tenant_inputs(valid, near, logistic, seed)
    steps, l2s = hyper(m, logistic)
    residual = logistic_residual if logistic else least_squares_residual
    masks = (sampling_masks(PART_ROWS, ITERATIONS, 0.5, torch.float32, "cpu") if sampled
             else None)
    gt, ut, yt, mt, nt, pt = (torch.from_numpy(a) for a in (g, u, y, mask, num, p_prev))
    gs = [gt[t] if valid[t] else None for t in range(m)]
    kw = dict(valid_rows=list(valid), masks=masks, p_prev=pt, num_iterations=ITERATIONS,
              step_sizes=steps, l2_regs=l2s, residual_fn=residual)
    c_m, a_m, its_m, barriers = tenants_model(
        gs, ut, yt, mt, nt, valid=tuple(valid), masks=masks, p_prev=pt,
        num_iterations=ITERATIONS, step_sizes=steps, l2_regs=l2s, tol=tol, residual_fn=residual)
    c_r, a_r, its_r = fused_gram.dual_sgd_tenants_reference(gs, ut, yt, mt, nt,
                                                            convergence_tol=tol, **kw)
    case = f"{structure}, tol {tol}, {'logistic' if logistic else 'least squares'}"
    assert its_m == [int(i) for i in its_r], f"{case}: the model {its_m}, the plain version " \
        f"{its_r.tolist()}"
    # the JAX vmap stops where the model does: its state after its_m[t]
    # iterations is its final one, and (unless that is the first) after one fewer not
    g_full = np.stack([add_numeric_block(gt[t], nt[t]).numpy() for t in range(m)])
    states = jax_vmap_states(g_full, u, y, mask, p_prev, steps, l2s,
                             [ITERATIONS] + its_m + [max(i - 1, 1) for i in its_m], tol=tol,
                             fraction=0.5 if sampled else 1.0, logistic=logistic)
    final = states[ITERATIONS]
    for t in range(m):
        if not valid[t]:
            continue
        at = states[its_m[t]]
        assert np.array_equal(at[0][t], final[0][t]) and np.array_equal(at[1][t], final[1][t]), \
            f"{case}: tenant {t}'s JAX loop moves past iteration {its_m[t]}"
        if its_m[t] > 1 and tol > 0:
            before = states[its_m[t] - 1]
            assert not (np.array_equal(before[0][t], final[0][t])
                        and np.array_equal(before[1][t], final[1][t])), \
                f"{case}: tenant {t}'s JAX loop stopped before iteration {its_m[t]}"
    np.testing.assert_allclose(a_m.numpy(), a_r.numpy(), rtol=1e-5,
                               atol=1e-5 * float(a_r.abs().max()), err_msg=case)
    np.testing.assert_allclose(c_m.numpy(), c_r.numpy(), rtol=1e-6, err_msg=case)
    selects = "all"
    live = [t for t in range(m) if valid[t]]
    if len(live) == 1 and masks is not None:
        counts = (mt[live[0]] * masks).sum(1)
        selects = "all" if bool((counts > 0).all()) else "some" if bool(counts.any()) else "none"
    want = fused_gram.dual_tenants_barriers(valid, its_m, num_iterations=ITERATIONS,
                                            convergence_tol=tol, selects=selects)
    assert want is None or barriers == want, f"{case}: {barriers} barriers, want {want}"
    if len(live) == 1:  # B7's loop: its model's iterations and barriers
        t = live[0]
        v = valid[t]
        b7 = kernel_model(add_numeric_block(gt[t, :v, :v], nt[t, :v]), ut[t, :v], yt[t, :v],
                          mt[t, :v], masks=None if masks is None else masks[:, :v],
                          p_prev=pt[t], num_iterations=ITERATIONS, step_size=steps[t],
                          l2_reg=l2s[t], tol=tol, residual_fn=residual)
        assert (b7[2], b7[3]) == (its_m[t], barriers), case
    return its_m


@pytest.mark.parametrize("logistic", [False, True], ids=["least squares", "logistic"])
@pytest.mark.parametrize("tol", [1e-2, 1e-3, 1e-4, 0.0])
@pytest.mark.parametrize("structure", list(STRUCTURES))
def test_the_tenant_form_stops_each_tenant_where_the_jax_vmap_stops(structure, tol, logistic):
    """Every valid row each iteration: each tenant's iterations are the plain
    version's and the JAX vmap loop's, its α and c the plain version's
    within tolerance, and the barriers those of the schedule. Tenants whose
    labels sit near the margins freeze early; at tolerance 0 none does."""
    its = check_case(structure, tol, logistic, sampled=False)
    valid, near = STRUCTURES[structure]
    if tol == 0.0:
        assert all(i == ITERATIONS for i in its)
    elif near and tol >= 1e-3:
        assert all(its[t] < ITERATIONS for t in near), its


@pytest.mark.parametrize("logistic", [False, True], ids=["least squares", "logistic"])
@pytest.mark.parametrize("structure", list(STRUCTURES))
def test_the_tenant_form_under_shared_draws_stops_where_the_jax_vmap_stops(structure,
                                                                           logistic):
    """``-b 0.5``: every tenant on the same [N, B] Bernoulli draws (the JAX
    loop's bits), each sliced to its rows, at tolerance 0.001."""
    check_case(structure, 1e-3, logistic, sampled=True)


def test_the_sweep_has_tenants_that_stop_early_and_tenants_that_run_on():
    """The cases have teeth: at tolerance 0.001 some tenants stop mid-way and
    some run every iteration, and a launch ends before N."""
    stops = []
    for structure in ("M=4", "M=16", "tenants 0 and 2 freeze early"):
        stops += check_case(structure, 1e-3, False, sampled=False)
    assert any(1 < s < ITERATIONS for s in stops) and ITERATIONS in stops, stops


@pytest.mark.parametrize("case", ["all frozen early", "none frozen", "tolerance 0", "one tenant",
                                  "one tenant, draws selecting none", "no tenant with rows"])
def test_the_barrier_count_of_a_launch(case):
    """``dual_tenants_barriers``: one barrier an iteration (B7's count at one
    tenant), the last only for a pending test, and a launch that ends at the
    top of the iteration after the last freeze's decision."""
    n = ITERATIONS
    f = fused_gram.dual_tenants_barriers
    if case == "all frozen early":
        assert f([5, 0, 7], [12, n, 30], num_iterations=n, convergence_tol=1e-3) == 31
        assert f([5, 7], [12, n - 1], num_iterations=n, convergence_tol=1e-3) == n
    if case == "none frozen":
        assert f([5, 7], [12, n], num_iterations=n, convergence_tol=1e-3) == n
    if case == "tolerance 0":
        assert f([5, 7], [n, n], num_iterations=n, convergence_tol=0.0) == n - 1
    if case == "one tenant":
        assert f([0, 9], [n, 12], num_iterations=n, convergence_tol=1e-3) == 13
        assert f([9], [n], num_iterations=n, convergence_tol=1e-3) == n
        assert f([9], [n], num_iterations=n, convergence_tol=0.0) == n - 1
    if case == "one tenant, draws selecting none":
        assert f([9], [n], num_iterations=n, convergence_tol=1e-3, selects="some") is None
        assert f([9], [n], num_iterations=n, convergence_tol=1e-3, selects="none") == 0
    if case == "no tenant with rows":
        assert f([0, 0], [n, n], num_iterations=n, convergence_tol=1e-3) == 0


@pytest.mark.parametrize("stamped", [(0,), (0, 2, 4)], ids=["cta0_only", "cta0_and_two_tenants"])
def test_the_probe_split_times_each_phase_at_each_ctas_rate(stamped):
    """``dual_tenants_probe_split`` on made-up stamps: each stamping CTA's
    cycles between its edges at its own globaltimer rate over its span,
    averaged over the iterations after the first and over the CTAs; an
    iteration cut short (its later edges 0) ends the count; a slot no CTA
    stamped counts nothing."""
    n_pro, n_it = fused_gram.DUAL_PROBE_PROLOGUE_EDGES, fused_gram.DUAL_PROBE_ITERATION_EDGES
    iterations = 5
    phases = [100, 1200, 800, 300, 0, 400]  # cycles of each phase an iteration
    edges = n_pro + n_it * iterations
    st = torch.zeros((5, edges, 2), dtype=torch.int64)
    for slot in stamped:
        cycles = [0, 5000] + phases * iterations  # entry, the prologue, then the iterations
        c = torch.tensor(np.cumsum(cycles) * (slot + 1) + 10**6, dtype=torch.int64)
        st[slot, :, 1] = c
        st[slot, :, 0] = (c.double() * 0.5).long() + 10**12  # 0.5 ns a cycle
    st[stamped[-1], edges - 2:] = 0  # its last iteration cut short
    split = fused_gram.dual_tenants_probe_split(st)
    assert split["slots"] == len(stamped)
    assert split["iterations"] == (iterations if len(stamped) > 1 else iterations - 1)
    assert list(split["iteration_us"]) == list(fused_gram.DUAL_PROBE_PHASES)
    # slot s stamps s + 1 times the cycles; each CTA's iterations after its
    # first count once (the cut one has one fewer)
    counted = {s: iterations - (2 if s == stamped[-1] else 1) for s in stamped}
    scale = sum((s + 1) * n for s, n in counted.items()) / sum(counted.values())
    for got, want in zip(split["iteration_us"].values(), phases):
        assert got == pytest.approx(want * scale * 0.5 / 1e3, rel=1e-6)
    assert split["us_an_iteration"] == pytest.approx(sum(phases) * scale * 0.5 / 1e3, rel=1e-6)
    prologue = np.mean([s + 1 for s in stamped])
    assert split["prologue_us"] == pytest.approx(5000 * prologue * 0.5 / 1e3, rel=1e-6)
    empty = fused_gram.dual_tenants_probe_split(torch.zeros_like(st))
    assert empty["slots"] == 0 and empty["iteration_us"] == {} and empty["iterations"] == 0
