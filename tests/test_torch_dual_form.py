"""B7's arithmetic (``csrc/gram.cu`` ``dual_tenants_kernel`` at one tenant)
modelled in f32 on the CPU, against its twin (``ops/fused_gram.
dual_sgd_reference``) and the JAX package's ``run_dual_loop``: the same
iterations run, case by case.

The kernel takes one product an iteration, s = G·α. Its convergence test
reads Δαᵀ·G·Δα as Σ Δα_r·(s_new_r − s_old_r) over its rows, not from a
second product G·Δα, and the test of iteration i is summed after the grid
barrier of iteration i + 1 (a CTA's partials in row order, then the CTAs
in order). Near convergence s_new and s_old agree in their leading bits,
so the difference loses them: this model shows, before any card runs it,
whether that cancellation moves the iteration at which the loop stops.
The model's product is a torch f32 matmul (another summation order than
the kernel's, with the same f32 rounding); α is held within rtol 1e-5 of
the twin."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from twtml_tpu.models import sgd as jax_sgd

from twtml_tpu_torch.models.sgd import _step_scalars, sampling_masks
from twtml_tpu_torch.ops import fused_gram
from twtml_tpu_torch.ops.fused_sgd import least_squares_residual, logistic_residual

ITERATIONS = 50
SM_COUNT = 132  # an H100's: the plan's grid, hence the CTAs' partial sums


def kernel_model(g, u, y, mask, *, masks, p_prev, num_iterations, step_size, l2_reg,
                 tol, residual_fn):
    """The kernel's loop in f32: (c, α, iterations run, grid barriers crossed).

    Each update's α is published before a barrier; past it the pending test
    (the last update's) is decided, then G·α is taken and the new test's
    partials written. The last update crosses a barrier only to decide a
    pending test. Rows with mask <= 0 are zeroed as the kernel stages them."""
    b = mask.shape[0]
    keep = mask > 0
    g = torch.where(keep[:, None] & keep[None, :], g, 0.0)
    u = torch.where(keep, u, 0.0)
    y = torch.where(keep, y, 0.0)
    plan = fused_gram.dual_tenants_plan((b,), sm_count=SM_COUNT, shared_limit=232_448)
    ctas = [plan.cta_rows(0, c) for c in range(plan.grid)]
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    c = f32(1.0)
    alpha = torch.zeros(b)
    s = torch.zeros(b)
    pending = None  # (iteration, c before it, partials [grid, 4])
    ran, barriers = num_iterations, 0

    def converged(test):
        it, c_prev, c_new, parts = test
        q = [f32(0.0) for _ in range(4)]
        for cta in parts:  # the CTAs in order
            q = [qj + pj for qj, pj in zip(q, cta)]
        dc = c_new - c_prev
        d2 = dc * dc * p_prev + 2.0 * dc * q[2] + q[0]
        n2 = c_new * c_new * p_prev + 2.0 * c_new * q[3] + q[1]
        return bool(torch.sqrt(d2) < tol * torch.clamp(torch.sqrt(n2), min=1.0))

    for it in range(1, num_iterations + 1):
        sel = mask if masks is None else mask * masks[it - 1]
        count = torch.sum(sel)
        if not count > 0:
            continue
        eta, scale = _step_scalars(step_size, l2_reg, it, torch.float32)
        res = torch.where(keep, residual_fn(c * u + s, y) * sel, 0.0)
        a_new = alpha * scale - eta * res / torch.clamp(count, min=1.0)
        c_new = c * scale
        last = it == num_iterations
        if last and pending is None:
            alpha, c = a_new, c_new
            break
        barriers += 1
        if pending is not None:
            if converged(pending):
                ran = pending[0]
                break
            pending = None
        if last:
            alpha, c = a_new, c_new
            break
        s_new = g @ a_new
        if tol > 0:
            d = a_new - alpha
            parts = []
            for rows in ctas:
                r = slice(rows.start, rows.stop)
                parts.append([torch.sum(d[r] * (s_new[r] - s[r])), torch.sum(a_new[r] * s_new[r]),
                              torch.sum(u[r] * d[r]), torch.sum(u[r] * a_new[r])])
            pending = (it, c, c_new, parts)
        alpha, s, c = a_new, s_new, c_new
    else:
        if pending is not None:  # the tail selected no row: one barrier to decide it
            barriers += 1
            if converged(pending):
                ran = pending[0]
    return c, alpha, ran, barriers


def dual_inputs(rng, rows, n_valid, noise, logistic, terms=40, cols=4096):
    """chip_smoke.py's B7 inputs at a smaller B: G of 0/1 token counts plus
    the numeric block, u = Z·W_prev, ``n_valid`` valid rows. Labels near
    the margins, u + N(0, noise²) (chip_smoke's freeze case: noise 10; the
    smaller the noise, the earlier the loop freezes), or with ``noise``
    None far from them (U(50, 900): chip_smoke's other cases). Logistic
    labels are those thresholded (at 0, or 475 far from the margins)."""
    z = np.zeros((rows, cols), np.float32)
    np.add.at(z, (np.arange(rows)[:, None], rng.integers(0, cols, size=(rows, terms))), 1.0)
    num = (rng.normal(size=(rows, 4)) * 0.1).astype(np.float32)
    g = z @ z.T + num @ num.T
    u = (rng.normal(size=rows) * 10).astype(np.float32)
    if noise is None:
        y = rng.uniform(50, 900, size=rows).astype(np.float32)
    else:
        y = u + (rng.normal(size=rows) * noise).astype(np.float32)
    if logistic:
        y = (y > (475 if noise is None else 0)).astype(np.float32)
    mask = (rng.permutation(rows) < n_valid).astype(np.float32)
    return g, u, y, mask


def jax_state(g, u, y, mask, p_prev, n, **kw):
    """The JAX package's run_dual_loop for ``n`` iterations (a traced trip
    count, so every ``n`` runs one compiled loop): (c, α) as numpy."""
    dual = _jax_dual(jnp.asarray(u), jnp.asarray(g), jnp.asarray(y), jnp.asarray(mask),
                     jnp.float32(p_prev), jnp.int32(n), **kw)
    return np.asarray(dual["c"]), np.asarray(dual["alpha"])


def _jax_dual_impl(u, g, y, mask, p_prev, n, *, tol, step_size, l2_reg, fraction, logistic):
    residual = ((lambda raw, lab: jax.nn.sigmoid(raw) - lab) if logistic
                else (lambda raw, lab: raw - lab))
    return jax_sgd.run_dual_loop(
        u=u, g=g, labels=y, mask=mask, dtype=jnp.float32, residual_fn=residual,
        num_iterations=n, step_size=step_size, mini_batch_fraction=fraction, l2_reg=l2_reg,
        convergence_tol=tol, p_prev=p_prev)


_jax_dual = jax.jit(_jax_dual_impl,
                    static_argnames=("tol", "step_size", "l2_reg", "fraction", "logistic"))


def jax_iterations(g, u, y, mask, p_prev, its, **kw):
    """Where the JAX loop stopped, checked at ``its``: its state after ``its``
    iterations is its state after all of them, and (unless ``its`` is the
    first) after ``its`` − 1 it is not. A converged loop keeps its state."""
    final = jax_state(g, u, y, mask, p_prev, ITERATIONS, **kw)
    at = jax_state(g, u, y, mask, p_prev, its, **kw)
    stopped_at = all(np.array_equal(a, b) for a, b in zip(at, final))
    before = its == 1 or not all(
        np.array_equal(a, b)
        for a, b in zip(jax_state(g, u, y, mask, p_prev, its - 1, **kw), final))
    return stopped_at and before


# (label noise, p_prev = ||W_prev||²) of the sweep: each tolerance and mode
# has loops that stop at the first test, mid-way and not at all among them
SWEEP = [(noise, p) for p in (3.0, 3000.0) for noise in (0.3, 1, 3, 10, 30, 100, None)]


@pytest.mark.parametrize("sampled", [False, True], ids=["all rows", "-b 0.5"])
@pytest.mark.parametrize("logistic", [False, True], ids=["least squares", "logistic"])
@pytest.mark.parametrize("tol", [1e-2, 1e-3, 1e-4])
def test_one_product_form_stops_where_the_twin_and_jax_stop(tol, logistic, sampled):
    """Over a sweep of labels near the margins and norms of W_prev, the
    model stops at the twin's iteration and at the JAX loop's, crosses one
    barrier an update (plus the one that carries a stopping test), and its
    α and c agree with the twin's. Logistic runs at step 0.1 (chip_smoke's)
    with L2 0.001: at L2 0.1 its ηλ term alone keeps ||Δw|| above 1e-3·||w||."""
    rows = 384
    step, l2 = (0.1, 0.001) if logistic else (0.005, 0.1)
    residual = logistic_residual if logistic else least_squares_residual
    masks = sampling_masks(rows, ITERATIONS, 0.5, torch.float32, "cpu") if sampled else None
    kw = dict(num_iterations=ITERATIONS, step_size=step, l2_reg=l2)
    stops = []
    for k, (noise, p_prev) in enumerate(SWEEP):
        rng = np.random.default_rng(1200 + k)
        g, u, y, mask = dual_inputs(rng, rows, rows - 19, noise, logistic)
        gt, ut, yt, mt = (torch.from_numpy(a) for a in (g, u, y, mask))
        pt = torch.tensor(p_prev, dtype=torch.float32)
        c_m, a_m, its_m, barriers = kernel_model(gt, ut, yt, mt, masks=masks, p_prev=pt,
                                                 tol=tol, residual_fn=residual, **kw)
        c_t, a_t, its_t = fused_gram.dual_sgd_reference(
            gt, ut, yt, mt, masks=masks, p_prev=pt, convergence_tol=tol,
            residual_fn=residual, **kw)
        case = f"noise {noise}, p_prev {p_prev}"
        assert its_m == int(its_t), f"{case}: the model stops at {its_m}, the twin at {int(its_t)}"
        assert jax_iterations(g, u, y, mask, p_prev, its_m, tol=tol, step_size=step, l2_reg=l2,
                              fraction=0.5 if sampled else 1.0, logistic=logistic), case
        # one barrier an update; a loop that stops early crosses one more,
        # which carries the test that stopped it
        assert barriers == min(its_m + 1, ITERATIONS), case
        np.testing.assert_allclose(a_m.numpy(), a_t.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(a_t.abs().max()), err_msg=case)
        np.testing.assert_allclose(float(c_m), float(c_t), rtol=1e-6, err_msg=case)
        stops.append(its_m)
    assert sum(1 < s < ITERATIONS for s in stops) >= 2, stops  # the sweep has teeth


def test_model_counts_barriers_at_tolerance_0_and_count_0():
    rng = np.random.default_rng(5)
    g, u, y, mask = (torch.from_numpy(a) for a in dual_inputs(rng, 64, 60, None, False))
    kw = dict(masks=None, p_prev=torch.tensor(3.0), num_iterations=ITERATIONS,
              step_size=0.005, l2_reg=0.1, residual_fn=least_squares_residual)
    c, alpha, its, barriers = kernel_model(g, u, y, mask, tol=0.0, **kw)
    c_t, a_t, _ = fused_gram.dual_sgd_reference(g, u, y, mask, convergence_tol=0.0,
                                                **{k: v for k, v in kw.items() if k != "tol"})
    assert (its, barriers) == (ITERATIONS, ITERATIONS - 1)  # the last update needs none
    np.testing.assert_allclose(alpha.numpy(), a_t.numpy(), rtol=1e-5,
                               atol=1e-5 * float(a_t.abs().max()))
    c0, a0, its0, barriers0 = kernel_model(g, u, y, torch.zeros(64), tol=1e-3, **kw)
    assert (float(c0), its0, barriers0) == (1.0, ITERATIONS, 0) and not a0.any()
