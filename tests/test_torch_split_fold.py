"""B1's data-parallel split in its launch order (``ops/fused_sgd.py``
``split_schedule``: each iteration's launch folds in the update of the
iteration before, and one launch of the last update ends the step), driven
with the two launches' plain versions (``fused_dense_iteration_reference``,
``fused_dense_update_reference``) against the JAX ``sgd_inner_loop`` with
the JAX step's grad (``residual_fn(X·w, y)·sel``, then ``Xᵀ``) on the same
numpy-seeded rows: at one rank (the all-reduce an identity) and at two
ranks whose half batches' buffers are summed. Weights within rtol 1e-5 and
atol 1e-7 (tests/test_torch_parallel.py's rule: the sums run in another
order), iterations run equal. The CUDA kernel is held against these plain
versions, and bitwise against B1, on the card by chip_smoke.py."""

from __future__ import annotations

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twtml_tpu.models.logistic import StreamingLogisticRegressionWithSGD as JaxLogistic
from twtml_tpu.models.sgd import sgd_inner_loop as jax_sgd_inner_loop
from twtml_tpu_torch.ops import fused_sgd

ROWS, F = 48, 24
RTOL, ATOL = 1e-5, 1e-7

# name -> (seed, logistic, mask share, w0's distance from the planted
# weights, iterations, step size, tolerance); "converges" stops at 16 of 30
CASES = {
    "converges": (3, False, 0.85, 0.3, 30, 0.02, 0.001),
    "runs_to_n": (5, False, 0.85, 1.0, 12, 0.01, 0.0),
    "count_0": (7, False, 0.0, 0.3, 8, 0.02, 0.001),
    "logistic": (9, True, 0.85, 0.3, 20, 0.5, 0.001),
}


def batch(seed, logistic, valid, spread):
    """Counts 0-2 and numeric columns in 1/64 steps (bf16-exact, so B1's
    bf16 X holds them exactly), labels of a planted w (0/1 labels in the
    logistic mode), a mask, and w0 at ``spread`` from the planted w."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 3, (ROWS, F)).astype(np.float32)
    x[:, -4:] = rng.integers(-64, 64, (ROWS, 4)) / 64
    w_true = rng.normal(size=F).astype(np.float32)
    y = ((rng.random(ROWS) < 0.5) if logistic
         else x @ w_true + rng.normal(0, 0.1, ROWS)).astype(np.float32)
    m = (rng.random(ROWS) < valid).astype(np.float32)
    w0 = (w_true + rng.normal(size=F) * spread).astype(np.float32)
    return x, y, m, w0


def jax_weights(x, y, m, w0, n, *, logistic, step_size, tol):
    residual_fn = JaxLogistic.residual_fn if logistic else (lambda raw, label: raw - label)
    xj, yj = jnp.asarray(x), jnp.asarray(y)

    def grad_and_count(w, sel):
        residual = residual_fn(xj @ w, yj) * sel
        return xj.T @ residual, jnp.sum(sel)

    return np.asarray(jax_sgd_inner_loop(
        jnp.asarray(w0), num_iterations=n, step_size=step_size, mini_batch_fraction=1.0,
        l2_reg=0.01, convergence_tol=tol, mask=jnp.asarray(m),
        sample_key=jax.random.PRNGKey(42), grad_and_count=grad_and_count))


def run_schedule(parts, w0, n, *, residual_fn, step_size, tol):
    """``split_schedule(n)`` on each rank's rows (``parts``: its (x, y, m)
    tensors) with the plain versions; the all-reduce sums the ranks'
    buffers. A launch of a stopped step returns at entry, as the kernel's
    do. Returns each rank's (w, iterations run): an update with a global
    count above 0 records its iteration, as the kernel's CTA 0 does."""
    kw = dict(step_size=step_size, l2_reg=0.01, convergence_tol=tol)
    ranks = [{"w": torch.from_numpy(w0), "stop": False, "buf": None, "ran": 0} for _ in parts]
    for what, it in fused_sgd.split_schedule(n):
        if what == "allreduce":
            total = sum(r["buf"] for r in ranks)
            for r in ranks:
                r["buf"] = total.clone()
            continue
        for r, (x, y, m) in zip(ranks, parts):
            if r["stop"]:
                continue
            if what == "grad":
                w, stop, buf = fused_sgd.fused_dense_iteration_reference(
                    x, y, m, r["w"], r["buf"], it=it, residual_fn=residual_fn, **kw)
                done = it - 1
            else:
                w, stop = fused_sgd.fused_dense_update_reference(r["w"], r["buf"], F, it=it, **kw)
                buf, done = r["buf"], it
            if done and float(r["buf"][-1]) > 0:
                r["ran"] = done
            r.update(w=w, stop=bool(stop), buf=buf)
    return [(r["w"], r["ran"]) for r in ranks]


@pytest.mark.parametrize("ranks", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_folded_schedule_matches_the_jax_loop(case, ranks):
    seed, logistic, valid, spread, n, step_size, tol = CASES[case]
    x, y, m, w0 = batch(seed, logistic, valid, spread)
    half = ROWS // ranks
    parts = [tuple(torch.from_numpy(a[k * half:(k + 1) * half]) for a in (x, y, m))
             for k in range(ranks)]
    residual_fn = fused_sgd.logistic_residual if logistic else fused_sgd.least_squares_residual
    out = run_schedule(parts, w0, n, residual_fn=residual_fn, step_size=step_size, tol=tol)
    ran = out[0][1]
    for w, r in out[1:]:  # every rank applies the same update to the same sums
        assert torch.equal(w, out[0][0]) and r == ran
    kw = dict(logistic=logistic, step_size=step_size, tol=tol)
    want = jax_weights(x, y, m, w0, n, **kw)
    np.testing.assert_allclose(out[0][0].numpy(), want, rtol=RTOL, atol=ATOL)
    # the JAX loop freezes w once converged, so the iterations it ran are the
    # fewest whose loop ends at its N-iteration weights
    assert np.array_equal(jax_weights(x, y, m, w0, ran, **kw), want)
    if ran:
        assert not np.array_equal(jax_weights(x, y, m, w0, ran - 1, **kw), want)
    expect = {"converges": range(2, n), "runs_to_n": [n], "count_0": [0]}
    assert ran in expect.get(case, range(1, n + 1))
    if case == "count_0":
        assert np.array_equal(out[0][0].numpy(), w0)


@pytest.mark.parametrize("case", CASES)
def test_folded_schedule_is_the_cpu_split_bitwise(case):
    """The plain versions in the kernel's launch order against the CPU path
    of ``fused_dense_sgd_split`` (``sgd_inner_loop`` over
    ``fused_dense_grad_reference``): the same torch ops in the same order,
    so the same bits."""
    seed, logistic, valid, spread, n, step_size, tol = CASES[case]
    x, y, m, w0 = (torch.from_numpy(a) for a in batch(seed, logistic, valid, spread))
    residual_fn = fused_sgd.logistic_residual if logistic else fused_sgd.least_squares_residual
    (w, _ran), = run_schedule([(x, y, m)], w0.numpy(), n, residual_fn=residual_fn,
                              step_size=step_size, tol=tol)
    want, _ = fused_sgd.fused_dense_sgd_split(
        x, y, m, w0, allreduce=lambda t: t, num_iterations=n, step_size=step_size,
        l2_reg=0.01, convergence_tol=tol, residual_fn=residual_fn)
    assert torch.equal(w, want)


@pytest.mark.parametrize("n", [1, 2, 50])
def test_schedule_is_n_plus_1_launches_and_n_allreduces(n):
    schedule = fused_sgd.split_schedule(n)
    launches = [p for p in schedule if p[0] != "allreduce"]
    assert len(launches) == n + 1
    assert [it for what, it in schedule if what == "allreduce"] == list(range(1, n + 1))
    # each all-reduce follows its iteration's launch; the update of N ends the step
    assert schedule[:2] == (("grad", 1), ("allreduce", 1))
    assert schedule[-1] == ("update", n)
    for k in range(0, 2 * n, 2):
        assert schedule[k] == ("grad", k // 2 + 1)


def test_update_reference_stops_at_count_0_and_leaves_w():
    w = torch.tensor([0.5, -0.25, 1.0])
    gbuf = torch.tensor([3.0, 1.0, -2.0, 0.0])
    w_new, stop = fused_sgd.fused_dense_update_reference(
        w, gbuf, 3, it=4, step_size=0.1, l2_reg=0.01, convergence_tol=0.0)
    assert torch.equal(w_new, w) and bool(stop)


def test_update_reference_is_the_loops_update():
    """One update from a summed buffer: w·(1 − ηλ) − ηg/count with η =
    step/√it in f32, and the stop flag from the convergence test only."""
    w = torch.tensor([0.5, -0.25, 1.0])
    gbuf = torch.tensor([3.0, 1.0, -2.0, 4.0])
    w_new, stop = fused_sgd.fused_dense_update_reference(
        w, gbuf, 3, it=4, step_size=0.1, l2_reg=0.01, convergence_tol=0.001)
    eta = np.float32(0.1) / np.sqrt(np.float32(4))
    scale = np.float32(1) - eta * np.float32(0.01)
    want = w.numpy() * scale - eta * gbuf[:3].numpy() / np.float32(4)
    np.testing.assert_array_equal(w_new.numpy(), want.astype(np.float32))
    assert not bool(stop)


KERNEL_SOURCE = Path(fused_sgd.__file__).resolve().parents[1] / "csrc" / "fused_sgd.cu"


@pytest.mark.parametrize("entry, argtypes", [
    ("twtml_fused_dense_grad", fused_sgd.GRAD_ARGTYPES),
    ("twtml_fused_dense_update", fused_sgd.UPDATE_ARGTYPES),
])
def test_split_entries_take_the_wrappers_arguments(entry, argtypes):
    """Each split C entry's parameters against its ctypes list: pointers
    where the wrapper passes addresses, floats where it passes floats."""
    source = KERNEL_SOURCE.read_text()
    params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', source).group(1)
    params = [p.strip() for p in params.split(",")]
    assert len(params) == len(argtypes)
    for param, argtype in zip(params, argtypes):
        if "*" in param:
            assert argtype in (ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)), param
        else:
            want = ctypes.c_float if param.startswith("float") else ctypes.c_int
            assert argtype is want, param


def test_split_kernel_source_has_one_split_kernel():
    """The reduce and the update run inside the iteration's launch: the
    split has one kernel and two C entries, both cooperative launches."""
    source = KERNEL_SOURCE.read_text()
    kernels = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*(\w+)", source)
    assert "dense_iteration_kernel" in kernels
    assert not {"dense_grad_kernel", "dense_reduce_kernel", "dense_update_kernel"} & set(kernels)
    assert "twtml_fused_dense_grad_reduce" not in source
    body = source[source.index("int launch_iteration("):]
    assert "cudaLaunchCooperativeKernel" in body[:body.index("}  // namespace")]
