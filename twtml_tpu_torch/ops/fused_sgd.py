"""The fused dense streaming-SGD loop: a hand-written CUDA kernel for Hopper
and its plain PyTorch twin (counterpart of ``twtml_tpu/ops/pallas_sgd.py``).

``fused_dense_sgd`` replaces ``twtml_tpu/ops/pallas_sgd.py::_sgd_kernel``:
predict with the pre-update weights, then run MLlib's GradientDescent loop
(1-indexed stepSize/sqrt(i), L2 pre-scale, zero-count skip, converged
freeze) on a dense [B, F] batch. X is stored in bf16 (the bigram counts are
small integers, exact in bf16); w, r, g and every sum stay in f32. The
residual is a compile-time mode of the kernel: least squares (r = x·w − y)
or logistic (r = σ(x·w) − y, the logistic learner's); the predictions are
the raw margin X·w0 in both.

The kernels are ``csrc/fused_sgd.cu`` (its header gives both designs).
With iterations to run, ``fused_sgd_kernel``: one persistent cooperative
launch a call that reads the caller's f32 X from device memory once, keeps
it in shared memory as bf16 (rows that do not fit spill once to an
L2-resident buffer) and runs every iteration on chip, with grid barriers in
place of kernel boundaries. At ``num_iterations == 0`` (the serving path's
predict-only mode), ``fused_predict_kernel``: one plain launch that streams
each row of X once, a warp a row, with the training kernel's first-pass
arithmetic, so its predictions equal that pass's bitwise. No float atomics:
reruns are bitwise equal. ``launch_plan`` and ``predict_plan`` size the
launches; the wrapper only allocates outputs and scratch and launches.

The data-parallel split (``fused_dense_sgd_split``, N processes training
one model): the same loop cut at its one cross-rank point, the all-reduce
of the fpad + 1 floats of this rank's Xᵀr and count. Each iteration is one
cooperative launch (``fused_dense_grad``: the update of the iteration
before from the all-reduced buffer, B1's converged decision, this rank's
row pass and its Xᵀr and count), and the step ends with one launch of the
update alone (``fused_dense_update``): N + 1 launches and N all-reduces a
step (``split_schedule``). It uses B1's grid, row split, orders of
summation and update arithmetic, so at world size 1 it gives B1's weights
and predictions bit for bit. Its CPU twin is ``fused_dense_grad_reference``
in ``sgd_inner_loop``; ``fused_dense_iteration_reference`` and
``fused_dense_update_reference`` are the two launches' plain functions.
Each wrapper counts its launches in ``.launches``.

B1 with a tenant grid dimension (``fused_dense_sgd_tenants``, the tenant
plane's vmap form): M tenants' loops in one cooperative launch of
``tenant_sgd_kernel``, each tenant's CTAs (``tenant_launch_plan``: in
proportion to its valid rows, none for a dry tenant) reading only its
part's rows up to its last valid one, each tenant with its own step size,
L2, reduce, update and converged decision. Its plain version is M calls of
``fused_dense_sgd_reference`` (``fused_dense_sgd_tenants_reference``).
``tenant_grid_probe`` launches its timing instantiation, which stamps each
phase edge of the prologue and of every iteration, and
``tenant_probe_split`` turns the stamps into µs a phase.

The split with a tenant grid (``fused_dense_sgd_tenants_split``, the vmap
form over a data axis: M tenants' data-parallel steps at once): the
split's schedule (``split_schedule``) with the tenant grid's row layout,
one cooperative launch of ``tenant_iteration_kernel`` an iteration and ONE
all-reduce of every tenant's Xᵀr and count ([M, fpad + 1] floats) between
launches, the update spread over every tenant's columns grid-wide so that a
tenant dry on this rank is updated too (``tenant_split_plan``). Its plain
version is ``fused_dense_sgd_tenants_split_reference``. ``TenantSplitStep``
prepares the C entry's launch once a step (a handle), so a launch passes
only the handle, the iteration and the stream. ``tenant_split_probe``
launches its timing instantiation, which stamps 7 phase edges a launch,
and ``tenant_split_probe_split`` turns the stamps into µs a phase.

Routing: a CPU tensor goes to the twin ``fused_dense_sgd_reference``; a CUDA
tensor launches a kernel or raises. ``fused_dense_sgd.launches`` counts
the calls that launched either kernel, ``.predict_launches`` those that
launched the predict kernel; ``fused_dense_sgd.last_iterations`` is
a device scalar holding the iterations the last launch ran (read it only
when a sync is acceptable). A call made while the current stream is being
captured into a CUDA graph launches nothing then: it counts into
``fused_dense_sgd.captured`` instead, and whoever replays the graph adds
those to ``launches`` at each replay (models/sgd.py ``step_many``).
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple

import torch

# the kernel reads 8 bf16 (16 bytes) at a time along a row
COLUMN_MULTIPLE = 8
# the dense regime's widest design matrix: 8192 text + 4 numeric columns
MAX_FEATURES = 8192 + 4
# constants of csrc/fused_sgd.cu that size its shared memory; the build
# passes them to nvcc, and the source static_asserts its own against them
THREADS = 384
WARPS = THREADS // 32
TILE_COLUMNS = 1024  # columns whose w and Xᵀr a warp holds in registers
REDUCE_SLOTS = 4
SCRATCH_FLOATS = 4
PREDICT_THREADS = 256  # the predict kernel's CTA: 8 warps, a row each at a time
PREDICT_WARPS = PREDICT_THREADS // 32
PREDICT_CTAS_PER_SM = 2
TENANTS_PER_LAUNCH = 32  # the tenant grid's launch: one bit a tenant in its masks
# the phase edges the tenant grid's timing instantiation stamps: the
# prologue's, then each iteration's
PROBE_PROLOGUE_EDGES = 4
PROBE_ITERATION_EDGES = 6
# the phase edges the split with a tenant grid's timing instantiation stamps
# in a launch: entry, then the end of each of PROBE_SPLIT_PHASES
PROBE_SPLIT_EDGES = 7
NVCC_DEFINES = tuple(
    f"-DTWTML_SGD_{name}={value}" for name, value in (
        ("THREADS", THREADS), ("TILE_COLUMNS", TILE_COLUMNS),
        ("REDUCE_SLOTS", REDUCE_SLOTS), ("SCRATCH_FLOATS", SCRATCH_FLOATS),
        ("PREDICT_THREADS", PREDICT_THREADS), ("TENANTS_PER_LAUNCH", TENANTS_PER_LAUNCH),
        ("PROBE_PROLOGUE_EDGES", PROBE_PROLOGUE_EDGES),
        ("PROBE_ITERATION_EDGES", PROBE_ITERATION_EDGES),
        ("PROBE_SPLIT_EDGES", PROBE_SPLIT_EDGES),
    )
)


def least_squares_residual(raw, label):
    """MLlib's LeastSquaresGradient multiplier: x·w − y."""
    return raw - label


def logistic_residual(raw, label):
    """MLlib's LogisticGradient multiplier: σ(x·w) − y."""
    return torch.sigmoid(raw) - label


# the kernel's residual modes: the C entry's ``residual_mode`` of each
RESIDUAL_MODES = {least_squares_residual: 0, logistic_residual: 1}


def residual_mode(residual_fn) -> "int | None":
    """The kernel mode that computes ``residual_fn`` (None: least squares),
    or None when the kernel has no mode for it."""
    return RESIDUAL_MODES.get(residual_fn or least_squares_residual)


def padded_columns(num_features: int) -> int:
    return -(-num_features // COLUMN_MULTIPLE) * COLUMN_MULTIPLE


def launches_per_call(num_iterations: int) -> int:
    """Device kernel launches one call makes: one, whatever the iterations."""
    return 1


def supports(*, batch_rows: int, num_features: int, dtype=torch.float32) -> bool:
    """What the kernel takes: at least one row, 1..MAX_FEATURES columns,
    f32 weights. (Every iteration uses the whole batch: the kernel has no
    mini-batch sampling.)"""
    return (
        batch_rows >= 1
        and 1 <= num_features <= MAX_FEATURES
        and batch_rows * padded_columns(num_features) < 2**31
        and dtype == torch.float32
    )


def _align16(n: int) -> int:
    return -(-n // 16) * 16


class LaunchPlan(NamedTuple):
    """How one call lays the batch over the card. CTA c owns rows
    [c*B // grid, (c+1)*B // grid); its first ``resident`` local rows stay
    in shared memory, the rest go to the spill buffer."""

    rows: int
    fpad: int
    row_columns: int  # columns a stored bf16 row takes (narrow rows padded)
    grid: int
    rows_cap: int  # the most rows a CTA owns
    resident: int  # rows a CTA keeps in shared memory
    spill_per_cta: int
    shared_bytes: int
    # byte offsets of the reduction slots, y, r, scratch and the resident
    # rows in shared memory (w at 0), then the 16-byte groups a stored row
    # takes; the C entry refuses a plan whose layout differs from the
    # kernel's own layout() and row_groups()
    smem_layout: tuple[int, int, int, int, int, int]

    def cta_rows(self, cta: int) -> range:
        return range(cta * self.rows // self.grid, (cta + 1) * self.rows // self.grid)

    @property
    def resident_rows(self) -> int:
        return sum(min(len(self.cta_rows(c)), self.resident) for c in range(self.grid))

    @property
    def spill_rows(self) -> int:
        return self.rows - self.resident_rows

    @property
    def scratch_floats(self) -> int:
        """partials [grid, fpad], w [fpad], count [grid], norms [grid, 2],
        iterations run [1]."""
        return self.grid * self.fpad + self.fpad + 3 * self.grid + 1

    @property
    def spill_elements(self) -> int:
        return self.grid * self.spill_per_cta * self.row_columns


def _shared_split(fpad: int, rows_cap: int, shared_limit: int, what: str) -> tuple:
    """A CTA's shared memory for ``rows_cap`` rows: (row_columns, resident
    rows, shared bytes, smem_layout). w [fpad] f32, the reduction slots, y
    and r a row, a small scratch, then as many bf16 rows of X as fit in
    ``shared_limit`` (the card's opt-in limit a block: 232,448 B on an
    H100); a row up to TILE_COLUMNS wide is stored TILE_COLUMNS wide, so
    the narrow pass needs no bounds checks. The rest of the rows spill."""
    row_columns = max(fpad, TILE_COLUMNS)
    red = _align16(fpad * 4)
    y = red + REDUCE_SLOTS * TILE_COLUMNS * 4
    r = y + _align16(rows_cap * 4)
    scratch = r + _align16(rows_cap * 4)
    x_rows = scratch + SCRATCH_FLOATS * 4
    if x_rows > shared_limit:
        raise ValueError(f"{what} need {x_rows} B of shared memory before any row of X; "
                         f"the limit is {shared_limit} B")
    resident = min(rows_cap, (shared_limit - x_rows) // (2 * row_columns))
    return (row_columns, resident, x_rows + resident * 2 * row_columns,
            (red, y, r, scratch, x_rows, row_columns // COLUMN_MULTIPLE))


def launch_plan(batch_rows: int, num_features: int, *, sm_count: int,
                shared_limit: int) -> LaunchPlan:
    """The grid, rows a CTA, resident/spill split and shared-memory layout
    of one call (``_shared_split``). At most one CTA an SM, and no more CTAs
    than give each warp a row."""
    fpad = padded_columns(num_features)
    grid = max(1, min(sm_count, -(-batch_rows // WARPS)))
    rows_cap = -(-batch_rows // grid)
    row_columns, resident, shared_bytes, smem_layout = _shared_split(
        fpad, rows_cap, shared_limit, f"{batch_rows} rows x {num_features} columns")
    return LaunchPlan(
        rows=batch_rows, fpad=fpad, row_columns=row_columns, grid=grid,
        rows_cap=rows_cap, resident=resident, spill_per_cta=rows_cap - resident,
        shared_bytes=shared_bytes, smem_layout=smem_layout,
    )


class TenantPlan(NamedTuple):
    """How one tenant-grid launch lays M tenants over the card: tenant t
    owns CTAs [first_cta[t], first_cta[t+1]) and its rows [0,
    valid_rows[t]) split over them as ``LaunchPlan.cta_rows`` splits a
    batch; each CTA keeps its first ``resident`` rows in shared memory and
    spills the rest."""

    valid_rows: tuple
    fpad: int
    row_columns: int
    first_cta: tuple
    rows_cap: int
    resident: int
    spill_per_cta: int
    shared_bytes: int
    smem_layout: tuple

    @property
    def tenants(self) -> int:
        return len(self.valid_rows)

    @property
    def grid(self) -> int:
        return self.first_cta[-1]

    def entries(self) -> list:
        """Each CTA's (tenant, first row, rows), in CTA order."""
        out = []
        for t, valid in enumerate(self.valid_rows):
            k = self.first_cta[t + 1] - self.first_cta[t]
            out += [(t, j * valid // k, (j + 1) * valid // k - j * valid // k)
                    for j in range(k)]
        return out

    @property
    def scratch_floats(self) -> int:
        """partials [grid, fpad], each tenant's w [tenants, fpad], count
        [grid], norms [grid, 2], each tenant's iterations run [tenants]."""
        return (self.grid + self.tenants) * self.fpad + 3 * self.grid + self.tenants

    @property
    def spill_elements(self) -> int:
        return self.grid * self.spill_per_cta * self.row_columns


def tenant_launch_plan(valid_rows, num_features: int, *, sm_count: int,
                       shared_limit: int) -> TenantPlan:
    """The tenant grid's launch for tenants with ``valid_rows`` rows each
    (a part's rows up to its last valid one): at most ``sm_count`` CTAs,
    one an SM, and no more CTAs for a tenant than give each warp a row;
    every tenant with a row gets a CTA, a dry one none (all dry: tenant 0
    gets one, which writes the outputs); each tenant's share of the CTAs is
    in proportion to its valid rows (rounded down), and the CTAs left go one
    at a time to the tenant whose CTAs hold the most rows each (first of
    equals). Shared memory is sized for
    the CTA with the most rows (``_shared_split``). At most
    TENANTS_PER_LAUNCH tenants, and no more with rows than ``sm_count``."""
    valid = tuple(int(v) for v in valid_rows)
    if not 1 <= len(valid) <= TENANTS_PER_LAUNCH or min(valid) < 0:
        raise ValueError(f"a tenant-grid launch takes 1..{TENANTS_PER_LAUNCH} tenants with "
                         f"0 or more rows each, got {valid}")
    ctas = [1 if v > 0 else 0 for v in valid]
    if sum(ctas) > sm_count:
        raise ValueError(f"{sum(ctas)} tenants with rows need a CTA each; the card has "
                         f"{sm_count} SMs")
    if not any(ctas):
        ctas[0] = 1
    want = [-(-v // WARPS) for v in valid]
    budget = min(sm_count, sum(want))
    share = [min(w, max(1, budget * v // sum(valid))) if v else 0
             for v, w in zip(valid, want)]
    if sum(valid) and sum(share) <= budget:
        ctas = share
    for _ in range(budget - sum(ctas)):
        t = max((t for t in range(len(valid)) if ctas[t] < want[t]),
                key=lambda t: (-(-valid[t] // ctas[t]), -t))
        ctas[t] += 1
    first = [0]
    for k in ctas:
        first.append(first[-1] + k)
    fpad = padded_columns(num_features)
    rows_cap = max(1, max(-(-v // k) for v, k in zip(valid, ctas) if k))
    row_columns, resident, shared_bytes, smem_layout = _shared_split(
        fpad, rows_cap, shared_limit, f"{rows_cap} rows a CTA x {num_features} columns")
    return TenantPlan(
        valid_rows=valid, fpad=fpad, row_columns=row_columns, first_cta=tuple(first),
        rows_cap=rows_cap, resident=resident, spill_per_cta=rows_cap - resident,
        shared_bytes=shared_bytes, smem_layout=smem_layout,
    )


class PredictPlan(NamedTuple):
    """How one predict-only call lays the batch over the card: warp w of
    the grid (CTA w // PREDICT_WARPS) takes rows w, w + warps, ...; w0 [fpad
    columns, at least TILE_COLUMNS] in shared memory."""

    rows: int
    fpad: int
    grid: int
    shared_bytes: int

    @property
    def warps(self) -> int:
        return self.grid * PREDICT_WARPS

    def warp_rows(self, warp: int) -> range:
        return range(warp, self.rows, self.warps)


def predict_plan(batch_rows: int, num_features: int, *, sm_count: int) -> PredictPlan:
    """The grid of one predict-only launch: at most PREDICT_CTAS_PER_SM CTAs
    an SM, and just enough CTAs that every warp takes the same number of
    rows (``ceil(B / warps at most)``): at B = 256 a row a warp over 32
    CTAs, at B = 16384 on 132 SMs 8 rows a warp over 256 CTAs."""
    if batch_rows < 1:
        raise ValueError("the predict kernel needs at least one row")
    fpad = padded_columns(num_features)
    most = PREDICT_CTAS_PER_SM * sm_count * PREDICT_WARPS
    rows_per_warp = -(-batch_rows // most)
    grid = -(-batch_rows // (PREDICT_WARPS * rows_per_warp))
    return PredictPlan(rows=batch_rows, fpad=fpad, grid=grid,
                       shared_bytes=4 * max(fpad, TILE_COLUMNS))


def fused_dense_sgd_reference(
    x_dense, labels, mask, weights, *, num_iterations: int, step_size: float,
    l2_reg: float = 0.0, convergence_tol: float = 0.001,
    residual_fn=least_squares_residual,
):
    """The plain PyTorch twin: the kernel's function on the same
    bf16-rounded X in f32 arithmetic, summing in torch's order, with the
    residual ``residual_fn`` (a key of ``RESIDUAL_MODES``: the logistic
    one through ``torch.sigmoid``). Masked rows and labels are zeroed with
    ``where`` (NaN * 0 would poison the gradient); a zeroed row adds
    nothing to Xᵀr whatever its residual. Returns (new_weights [F],
    raw_predictions [B])."""
    from ..models.sgd import sgd_inner_loop  # the one home of the MLlib rule

    keep = mask > 0
    x = torch.where(keep[:, None], x_dense, 0.0).to(torch.bfloat16).float()
    y = torch.where(keep, labels.float(), 0.0)
    count = mask.float().sum()
    w0 = weights.float()
    preds = x @ w0

    residual = residual_fn or least_squares_residual

    def grad_and_count(w, _it):
        return x.T @ residual(x @ w, y), count

    w = sgd_inner_loop(
        w0,
        num_iterations=num_iterations,
        step_size=step_size,
        l2_reg=l2_reg,
        convergence_tol=convergence_tol,
        grad_and_count=grad_and_count,
    )
    return w, preds


def fused_dense_sgd_tenants_reference(
    x_dense, labels, mask, weights, *, num_iterations: int, step_sizes, l2_regs,
    convergence_tol: float = 0.001, residual_fn=least_squares_residual,
):
    """The plain version of the tenant grid: M calls of
    ``fused_dense_sgd_reference``, tenant m on ``x_dense[m]`` [B, F],
    ``labels[m]``, ``mask[m]`` and ``weights[m]`` with its own step size and
    L2 (each rounded to float32 where the loop forms η). Returns
    (new_weights [M, F], raw_predictions [M, B])."""
    outs = [fused_dense_sgd_reference(
        x_dense[m], labels[m], mask[m], weights[m], num_iterations=num_iterations,
        step_size=step_sizes[m], l2_reg=l2_regs[m], convergence_tol=convergence_tol,
        residual_fn=residual_fn) for m in range(x_dense.shape[0])]
    return torch.stack([w for w, _ in outs]), torch.stack([p for _, p in outs])


def fused_dense_grad_reference(x_dense, labels, mask, weights, *,
                               residual_fn=least_squares_residual):
    """The plain twin of one split iteration on this rank's rows, before the
    all-reduce: (Xᵀ residual(X·w, y) [F], the masked count, the margins X·w
    [B]) on B1's bf16-rounded X with masked rows and labels zeroed, as
    ``fused_dense_sgd_reference`` computes them."""
    keep = mask > 0
    x = torch.where(keep[:, None], x_dense, 0.0).to(torch.bfloat16).float()
    y = torch.where(keep, labels.float(), 0.0)
    raw = x @ weights.float()
    return x.T @ (residual_fn or least_squares_residual)(raw, y), mask.float().sum(), raw


def split_plan(batch_rows: int, num_features: int, *, sm_count: int,
               shared_limit: int) -> LaunchPlan:
    """The split's launch plan: B1's grid and rows a CTA (``launch_plan``),
    so its sums run in B1's order, with every row in the staged bf16 buffer
    (no resident rows; the buffer is laid out as B1's spill buffer) and
    shared memory up to the rows of X (w, reduction slots, y, r, scratch)."""
    plan = launch_plan(batch_rows, num_features, sm_count=sm_count,
                       shared_limit=shared_limit)
    return plan._replace(resident=0, spill_per_cta=plan.rows_cap,
                         shared_bytes=plan.smem_layout[4])


def fused_dense_update_reference(w, gbuf, features: int, *, it: int, step_size: float,
                                 l2_reg: float, convergence_tol: float):
    """The plain function of the split's update-only launch: B1's f32
    update of iteration ``it`` of the F columns of ``w`` with the
    all-reduced Xᵀr ``gbuf[:F]`` and count ``gbuf[-1]``, then ‖Δw‖², ‖w‖²
    and the converged test, as ``sgd_inner_loop`` computes them. Returns
    (w', stop): ``stop`` (a bool tensor) is the step's flag the kernel sets,
    true when the count is 0 (no update: w stands) or the update converged."""
    from ..models.sgd import _step_scalars

    eta, scale = _step_scalars(step_size, l2_reg, it, torch.float32)
    count = gbuf[-1]
    w_new = torch.where(count > 0, w * scale - eta * gbuf[:features] / count.clamp(min=1.0), w)
    d, n = ((w_new - w) ** 2).sum(), (w_new * w_new).sum()
    return w_new, ~(count > 0) | (
        (convergence_tol > 0) & (d.sqrt() < convergence_tol * n.sqrt().clamp(min=1.0)))


def fused_dense_iteration_reference(x_dense, labels, mask, w, gbuf, *, it: int,
                                    step_size: float, l2_reg: float, convergence_tol: float,
                                    residual_fn=least_squares_residual):
    """The plain function of the split's launch at iteration ``it``: for
    ``it`` >= 2 the update of ``it`` − 1 from the all-reduced ``gbuf`` [F +
    1] (``fused_dense_update_reference``), which ends the step when it
    stops; then this rank's Xᵀr and count at the new w. Returns (w, stop,
    buffer): the buffer is [F + 1] (Xᵀr, then the count) for the
    all-reduce, or ``gbuf`` untouched when the step stopped."""
    if it > 1:
        w, stop = fused_dense_update_reference(
            w, gbuf, x_dense.shape[1], it=it - 1, step_size=step_size, l2_reg=l2_reg,
            convergence_tol=convergence_tol)
        if bool(stop):
            return w, stop, gbuf
    g, count, _ = fused_dense_grad_reference(x_dense, labels, mask, w, residual_fn=residual_fn)
    return w, torch.zeros((), dtype=torch.bool, device=w.device), torch.cat([g, count[None]])


def split_schedule(num_iterations: int) -> tuple:
    """One split step of N >= 1 iterations as (what, it) pairs, in order:
    for it = 1..N the iteration's launch ("grad") and the all-reduce of its
    fpad + 1 floats ("allreduce"), then the update of N alone ("update"):
    N + 1 launches and N all-reduces."""
    return (*((what, it) for it in range(1, num_iterations + 1)
              for what in ("grad", "allreduce")), ("update", num_iterations))


class TenantSplitPlan(NamedTuple):
    """One rank's launch of the split with a tenant grid: ``tenants`` the
    tenant grid's CTAs over this rank's valid rows (``tenant_launch_plan``)
    with every row in the staged bf16 buffer (no resident rows, shared
    memory up to the rows of X, as ``split_plan``), and ``slices`` column
    slices of ceil(fpad / slices) columns, over which every CTA shares the
    update and the reduce of every tenant (CTA c takes slices c, c + grid,
    ...). ``slices`` is B1's grid at the part's padded rows, which every
    rank has alike, so every rank sums each tenant's ‖Δw‖² and ‖w‖² in one
    order and takes the same converged decisions."""

    tenants: TenantPlan
    slices: int

    def cta_columns(self, cta: int) -> list:
        """The columns of EVERY tenant that CTA ``cta`` updates and reduces,
        whichever tenant's rows it owns: slices cta, cta + grid, ... of
        ceil(fpad / slices) columns each (the kernel's own split)."""
        fpad, cols = self.tenants.fpad, -(-self.tenants.fpad // self.slices)
        return [range(min(q * cols, fpad), min(q * cols + cols, fpad))
                for q in range(cta, self.slices, self.tenants.grid)]

    @property
    def scratch_floats(self) -> int:
        """partials [grid, fpad], each tenant's w [tenants, fpad], the CTAs'
        counts [grid], each tenant's count on this rank [tenants], norms
        [tenants, slices, 2], iterations run [tenants]."""
        t = self.tenants
        return ((t.grid + t.tenants) * t.fpad + t.grid + t.tenants
                + 2 * t.tenants * self.slices + t.tenants)


def tenant_split_plan(valid_rows, batch_rows: int, num_features: int, *, sm_count: int,
                      shared_limit: int) -> TenantSplitPlan:
    """The tenant grid of ``tenant_launch_plan`` over this rank's
    ``valid_rows`` (a dry tenant gets no CTA), staged as the split stages
    (``split_plan``), and the update's ``slices``: B1's grid at the parts'
    ``batch_rows``. At one tenant with every row valid the grid, the rows a
    CTA and the slices are the split's."""
    plan = tenant_launch_plan(valid_rows, num_features, sm_count=sm_count,
                              shared_limit=shared_limit)
    slices = launch_plan(batch_rows, num_features, sm_count=sm_count,
                         shared_limit=shared_limit).grid
    return TenantSplitPlan(plan._replace(resident=0, spill_per_cta=plan.rows_cap,
                                         shared_bytes=plan.smem_layout[4]), slices)


def fused_dense_sgd_tenants_split_reference(
    x_dense, labels, mask, weights, *, allreduce, num_iterations: int, step_sizes, l2_regs,
    convergence_tol: float = 0.001, residual_fn=least_squares_residual,
):
    """The plain version of the split with a tenant grid: M tenants' loops
    on this rank's rows of their parts (``x_dense`` [M, B, F], ``labels`` and
    ``mask`` [M, B], ``weights`` [M, F]), B1's bf16-rounded X with masked
    rows and labels zeroed, each iteration's M Xᵀr and counts through ONE
    ``allreduce`` of one buffer ([M, F] then [M]), then each tenant's update
    with its own step size and L2, zero-count rule and converged freeze
    (``sgd_inner_loop`` with a step table). Returns (new_weights [M, F], this
    rank's raw predictions [M, B])."""
    from ..models.sgd import _reduced, sgd_inner_loop, tenant_step_table

    keep = mask > 0
    x = torch.where(keep[..., None], x_dense, 0.0).to(torch.bfloat16).float()
    y = torch.where(keep, labels.float(), 0.0)
    count = mask.float().sum(dim=-1)
    w0 = weights.float()
    tenants = range(x.shape[0])
    preds = torch.stack([x[m] @ w0[m] for m in tenants])
    residual = residual_fn or least_squares_residual

    def grad_and_count(w, _it):
        return torch.stack([x[m].T @ residual(x[m] @ w[m], y[m]) for m in tenants]), count

    table = tenant_step_table(step_sizes, l2_regs, num_iterations, torch.float32)
    w = sgd_inner_loop(w0, num_iterations=num_iterations, step_size=None, l2_reg=None,
                       convergence_tol=convergence_tol,
                       grad_and_count=_reduced(grad_and_count, allreduce),
                       step_table=(table[0].to(w0.device), table[1].to(w0.device)))
    return w, preds


class SplitBuffers(NamedTuple):
    """One split step's device buffers (``split_plan``'s sizes): the staged
    bf16 X, B1's scratch, the int32 [1] state (the step's flag: converged,
    or no row on any rank) and the [fpad + 1] all-reduce buffer (Xᵀr, then
    the count)."""

    staged: torch.Tensor
    scratch: torch.Tensor
    state: torch.Tensor
    gbuf: torch.Tensor


def split_buffers(plan: LaunchPlan, device) -> SplitBuffers:
    return SplitBuffers(
        torch.empty((plan.spill_elements,), dtype=torch.bfloat16, device=device),
        torch.empty((plan.scratch_floats,), dtype=torch.float32, device=device),
        torch.empty((1,), dtype=torch.int32, device=device),
        torch.empty((plan.fpad + 1,), dtype=torch.float32, device=device),
    )


def _plan_args(plan: LaunchPlan, features: int) -> tuple:
    return (plan.rows, features, plan.fpad, plan.grid, plan.rows_cap, plan.shared_bytes,
            _layout_arg(plan.smem_layout))


def _check_split(name: str, err: int, plan: LaunchPlan) -> None:
    if err == 1:  # cudaErrorInvalidValue: the entry's own checks
        raise RuntimeError(f"{name}: the kernel refused the split plan {plan}")
    if err != 0:  # a refused cooperative launch included
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def fused_dense_grad(plan: LaunchPlan, bufs: SplitBuffers, x_dense, labels, mask, weights,
                     w_out, preds, *, it: int, step_size: float, l2_reg: float,
                     convergence_tol: float, mode: int = 0) -> None:
    """One cooperative launch of the split's kernel at iteration ``it`` on
    the current stream: for ``it`` >= 2 the update of ``it`` − 1 from the
    all-reduced ``bufs.gbuf`` into ``w_out`` and the converged decision,
    then each CTA's Xᵀ residual(X·w, y), summed into ``bufs.gbuf`` (Xᵀr, the
    count last). At ``it`` 1 it also stages X, writes ``preds`` (X·w0) and
    the counts, and starts the step's state. Launches of a step that
    stopped return at once."""
    err = _entry("twtml_fused_dense_grad")(
        x_dense.data_ptr(), labels.data_ptr(), mask.data_ptr(), weights.data_ptr(),
        w_out.data_ptr(), preds.data_ptr(), bufs.staged.data_ptr(), bufs.scratch.data_ptr(),
        bufs.state.data_ptr(), bufs.gbuf.data_ptr(), *_plan_args(plan, x_dense.shape[1]),
        int(it), float(step_size), float(l2_reg), float(convergence_tol), int(mode),
        torch.cuda.current_stream().cuda_stream)
    _check_split("fused_dense_grad", err, plan)
    fused_dense_grad.launches += 1


def fused_dense_update(plan: LaunchPlan, bufs: SplitBuffers, w_out, features: int, *,
                       it: int, step_size: float, l2_reg: float,
                       convergence_tol: float) -> None:
    """One cooperative launch of the split's kernel in update-only mode:
    B1's update of iteration ``it`` with the all-reduced ``bufs.gbuf`` into
    ``w_out``, and the converged flag; no row pass."""
    err = _entry("twtml_fused_dense_update")(
        w_out.data_ptr(), bufs.scratch.data_ptr(), bufs.state.data_ptr(),
        bufs.gbuf.data_ptr(), *_plan_args(plan, features), int(it), float(step_size),
        float(l2_reg), float(convergence_tol), torch.cuda.current_stream().cuda_stream)
    _check_split("fused_dense_update", err, plan)
    fused_dense_update.launches += 1


fused_dense_grad.launches = 0
fused_dense_update.launches = 0


def fused_dense_sgd_split(
    x_dense, labels, mask, weights, *, allreduce, num_iterations: int, step_size: float,
    l2_reg: float = 0.0, convergence_tol: float = 0.001,
    residual_fn=least_squares_residual,
):
    """B1's loop on this rank's rows of a batch that N ranks train together:
    each iteration's Xᵀr and count go through ``allreduce(t)`` (an in-place
    SUM over the ranks of a float32 tensor on the batch's device). Returns
    (new weights [F], this rank's raw predictions [B]). On the card:
    ``split_schedule``'s N + 1 cooperative launches and N ``allreduce``
    calls of fpad + 1 floats, no host read of convergence; on the CPU the
    twin (``fused_dense_grad_reference`` in ``sgd_inner_loop``). At
    ``num_iterations == 0`` no rank exchanges anything: B1's predict mode."""
    mode = residual_mode(residual_fn)
    if mode is None:
        raise ValueError(f"fused_dense_sgd_split has no residual mode for {residual_fn!r}")
    if num_iterations == 0:
        return fused_dense_sgd(x_dense, labels, mask, weights, num_iterations=0,
                               step_size=step_size, residual_fn=residual_fn)
    dev = x_dense.device
    if dev.type == "cpu":
        from ..models.sgd import sgd_inner_loop  # the one home of the MLlib rule

        f = x_dense.shape[1]

        def grad_and_count(w, _it):
            g, count, _ = fused_dense_grad_reference(x_dense, labels, mask, w,
                                                     residual_fn=residual_fn)
            buf = torch.cat([g, count[None]])
            allreduce(buf)
            return buf[:f], buf[f]

        _, _, preds = fused_dense_grad_reference(x_dense, labels, mask, weights,
                                                 residual_fn=residual_fn)
        w = sgd_inner_loop(weights.float(), num_iterations=num_iterations,
                           step_size=step_size, l2_reg=l2_reg,
                           convergence_tol=convergence_tol, grad_and_count=grad_and_count)
        return w, preds
    if dev.type != "cuda":
        raise ValueError(f"fused_dense_sgd_split takes cpu or cuda tensors, got {dev}")
    b, f = x_dense.shape
    if not supports(batch_rows=b, num_features=f, dtype=weights.dtype):
        raise ValueError(f"fused_dense_sgd_split does not take X {tuple(x_dense.shape)} "
                         f"with {weights.dtype} weights (see supports())")
    for name, t, shape in (("x_dense", x_dense, (b, f)), ("labels", labels, (b,)),
                           ("mask", mask, (b,)), ("weights", weights, (f,))):
        if (t.device != dev or tuple(t.shape) != shape or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    with torch.cuda.device(dev):
        sm_count, shared_limit = device_limits(torch.cuda.current_device())
        plan = split_plan(b, f, sm_count=sm_count, shared_limit=shared_limit)
        bufs = split_buffers(plan, dev)
        w = torch.empty((f,), dtype=torch.float32, device=dev)
        preds = torch.empty((b,), dtype=torch.float32, device=dev)
        kw = dict(step_size=step_size, l2_reg=l2_reg, convergence_tol=convergence_tol)
        for what, it in split_schedule(num_iterations):
            if what == "grad":
                fused_dense_grad(plan, bufs, x_dense, labels, mask, weights, w, preds, it=it,
                                 mode=mode, **kw)
            elif what == "allreduce":
                allreduce(bufs.gbuf)
            else:
                fused_dense_update(plan, bufs, w, f, it=it, **kw)
    fused_dense_sgd.last_iterations = bufs.scratch[-1]
    return w, preds


# arguments of the C entry twtml_fused_dense_sgd (csrc/fused_sgd.cu)
KERNEL_ARGTYPES = (
    [ctypes.c_void_p] * 8  # x, labels, mask, w0, w_out, preds, spill, scratch
    + [ctypes.c_int] * 8  # rows, features, fpad, grid, rows_cap, resident,
    # spill_per_cta, shared_bytes
    + [ctypes.POINTER(ctypes.c_int)]  # the plan's smem_layout
    + [ctypes.c_int]  # iterations
    + [ctypes.c_float] * 3  # step_size, l2_reg, tol
    + [ctypes.c_int]  # residual_mode
    + [ctypes.c_void_p]  # stream
)


# arguments of the C entry twtml_fused_dense_predict (csrc/fused_sgd.cu)
PREDICT_ARGTYPES = (
    [ctypes.c_void_p] * 6  # x, mask, w0, w_out, preds, iterations
    + [ctypes.c_int] * 5  # rows, features, fpad, grid, shared_bytes
    + [ctypes.c_void_p]  # stream
)
# the split's C entries (csrc/fused_sgd.cu); each ends with the plan's
# rows, features, fpad, grid, rows_cap, shared_bytes and smem_layout
_PLAN_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
GRAD_ARGTYPES = (
    [ctypes.c_void_p] * 10  # x, labels, mask, w0, w_out, preds, staged, scratch, state, gbuf
    + _PLAN_ARGTYPES + [ctypes.c_int] + [ctypes.c_float] * 3  # it, step, l2, tol
    + [ctypes.c_int]  # residual_mode
    + [ctypes.c_void_p]  # stream
)
UPDATE_ARGTYPES = (
    [ctypes.c_void_p] * 4  # w_out, scratch, state, gbuf
    + _PLAN_ARGTYPES + [ctypes.c_int] + [ctypes.c_float] * 3  # it, step, l2, tol
    + [ctypes.c_void_p]
)
TENANTS_ARGTYPES = (
    [ctypes.c_void_p] * 8  # x, labels, mask, w0, w_out, preds, spill, scratch
    + [ctypes.c_int] * 9  # tenants, rows, features, fpad, grid, rows_cap, resident,
    # spill_per_cta, shared_bytes
    + [ctypes.POINTER(ctypes.c_int)] * 3  # smem_layout, first_cta, valid rows
    + [ctypes.POINTER(ctypes.c_float)] * 2  # step sizes, L2s
    + [ctypes.c_int, ctypes.c_float, ctypes.c_int]  # iterations, tol, residual_mode
    + [ctypes.c_void_p, ctypes.c_int]  # the timing probe's buffer (or null), its edges
    + [ctypes.c_void_p]  # stream
)
# the split with a tenant grid: a handle prepared once a step, then launched
TENANT_SPLIT_ARGTYPES = (
    [ctypes.c_void_p] * 10  # x, labels, mask, w0, w_out, preds, staged, scratch, state, gbuf
    + [ctypes.c_int] * 7  # tenants, rows, features, fpad, grid, rows_cap, shared_bytes
    + [ctypes.POINTER(ctypes.c_int)] * 3  # smem_layout, first_cta, valid rows
    + [ctypes.POINTER(ctypes.c_float)] * 2  # step sizes, L2s
    + [ctypes.c_int, ctypes.c_float, ctypes.c_int]  # slices, tol, residual_mode
    + [ctypes.c_void_p, ctypes.c_int]  # the timing probe's buffer (or null), its edges
    + [ctypes.POINTER(ctypes.c_void_p)]  # the handle (out)
)
TENANT_SPLIT_LAUNCH_ARGTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # handle, it, row_pass
                                ctypes.c_void_p)  # stream
_ENTRIES = {"twtml_fused_dense_sgd": KERNEL_ARGTYPES,
            "twtml_fused_dense_predict": PREDICT_ARGTYPES,
            "twtml_fused_dense_grad": GRAD_ARGTYPES,
            "twtml_fused_dense_update": UPDATE_ARGTYPES,
            "twtml_fused_dense_sgd_tenants": TENANTS_ARGTYPES,
            "twtml_tenant_split_prepare": TENANT_SPLIT_ARGTYPES,
            "twtml_tenant_split_launch": TENANT_SPLIT_LAUNCH_ARGTYPES,
            "twtml_tenant_split_release": (ctypes.c_void_p,)}


@functools.cache
def _entry(name: str = "twtml_fused_dense_sgd"):
    """A C entry of csrc/fused_sgd.cu, built at first use."""
    from ._build import load

    fn = getattr(load("fused_sgd"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = _ENTRIES[name]
    return fn


@functools.cache
def device_limits(index: int) -> tuple[int, int]:
    """(SM count, opt-in shared memory a block) of CUDA device ``index``.
    The first call for a device also raises the kernel's dynamic
    shared-memory limit there, which every launch on it needs."""
    from ._build import load

    fn = load("fused_sgd").twtml_fused_sgd_setup
    fn.restype = ctypes.c_int
    sms, shared = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(index, ctypes.byref(sms), ctypes.byref(shared))
    if err != 0:
        raise RuntimeError(f"fused_dense_sgd: device set-up failed: CUDA error {err}")
    return sms.value, shared.value


@functools.lru_cache(maxsize=64)
def _layout_arg(smem_layout: tuple[int, ...]):
    return (ctypes.c_int * len(smem_layout))(*smem_layout)


def kernel_args(plan: LaunchPlan, x_dense, labels, mask, weights, w_out, preds,
                spill, scratch, *, num_iterations: int, step_size: float,
                l2_reg: float, convergence_tol: float, mode: int = 0) -> tuple:
    """The C entry's arguments for one launch on the current stream, with
    the buffers ``plan`` asks for (``spill_elements`` bf16,
    ``scratch_floats`` f32) on the current device, in residual ``mode``
    (``RESIDUAL_MODES``)."""
    return (
        x_dense.data_ptr(), labels.data_ptr(), mask.data_ptr(), weights.data_ptr(),
        w_out.data_ptr(), preds.data_ptr(), spill.data_ptr(), scratch.data_ptr(),
        plan.rows, x_dense.shape[1], plan.fpad, plan.grid, plan.rows_cap, plan.resident,
        plan.spill_per_cta, plan.shared_bytes, _layout_arg(plan.smem_layout),
        int(num_iterations), float(step_size), float(l2_reg), float(convergence_tol),
        int(mode), torch.cuda.current_stream().cuda_stream,
    )


def call_predict(plan: PredictPlan, x_dense, mask, weights, w_out, preds,
                 iterations) -> None:
    """One launch of the predict kernel on the current stream (``iterations``
    a one-float buffer that receives 0). Raises when the launch is refused.
    Counts nothing: the wrapper does."""
    err = _entry("twtml_fused_dense_predict")(
        x_dense.data_ptr(), mask.data_ptr(), weights.data_ptr(), w_out.data_ptr(),
        preds.data_ptr(), iterations.data_ptr(), plan.rows, x_dense.shape[1], plan.fpad,
        plan.grid, plan.shared_bytes, torch.cuda.current_stream().cuda_stream)
    if err == 1:  # cudaErrorInvalidValue: the entry's own checks
        raise RuntimeError(f"fused_dense_sgd: the predict kernel refused the plan {plan}")
    if err != 0:
        raise RuntimeError(f"fused_dense_sgd predict kernel launch failed: CUDA error {err}")


def call_kernel(plan: LaunchPlan, args: tuple) -> None:
    """One cooperative launch with ``kernel_args``' arguments, after
    ``device_limits`` has run for the device. Raises when the launch is
    refused. Counts nothing: the wrapper does."""
    err = _entry()(*args)
    if err == 1:  # cudaErrorInvalidValue: the entry's own checks
        raise RuntimeError("fused_dense_sgd: the kernel refused the launch plan "
                           f"{plan} (sizes, or a layout that differs from "
                           "csrc/fused_sgd.cu's layout())")
    if err != 0:
        raise RuntimeError(f"fused_dense_sgd kernel launch failed: CUDA error {err}")


def fused_dense_sgd(
    x_dense, labels, mask, weights, *, num_iterations: int, step_size: float,
    l2_reg: float = 0.0, convergence_tol: float = 0.001,
    residual_fn=least_squares_residual,
):
    """Run the fused loop on a dense [B, F] batch; ``weights`` is the flat
    [F] vector; ``residual_fn`` picks the kernel's residual mode
    (``RESIDUAL_MODES``; None is least squares). Returns (new_weights [F],
    raw_predictions [B]), where the predictions use the pre-update weights.
    On CUDA every tensor must be contiguous float32 on one device."""
    mode = residual_mode(residual_fn)
    if mode is None:
        raise ValueError(f"fused_dense_sgd has no residual mode for {residual_fn!r}; "
                         f"it computes {[f.__name__ for f in RESIDUAL_MODES]}")
    dev = x_dense.device
    if dev.type == "cpu":
        return fused_dense_sgd_reference(
            x_dense, labels, mask, weights, num_iterations=num_iterations,
            step_size=step_size, l2_reg=l2_reg, convergence_tol=convergence_tol,
            residual_fn=residual_fn,
        )
    if dev.type != "cuda":
        raise ValueError(f"fused_dense_sgd takes cpu or cuda tensors, got {dev}")
    if x_dense.dim() != 2:
        raise ValueError(f"x_dense must be [B, F], got {tuple(x_dense.shape)}")
    b, f = x_dense.shape
    if not supports(batch_rows=b, num_features=f, dtype=weights.dtype):
        raise ValueError(
            f"fused_dense_sgd kernel does not take X {tuple(x_dense.shape)} "
            f"with {weights.dtype} weights (see supports())"
        )
    for name, t, shape in (
        ("x_dense", x_dense, (b, f)), ("labels", labels, (b,)), ("mask", mask, (b,)),
        ("weights", weights, (f,)),
    ):
        if (t.device != dev or tuple(t.shape) != shape or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if num_iterations < 0:
        raise ValueError("num_iterations must be >= 0")

    with torch.cuda.device(dev):
        sm_count, shared_limit = device_limits(torch.cuda.current_device())
        w = torch.empty((f,), dtype=torch.float32, device=dev)
        preds = torch.empty((b,), dtype=torch.float32, device=dev)
        if num_iterations == 0:  # predict only: no staging, no scratch, no barrier
            plan = predict_plan(b, f, sm_count=sm_count)
            iterations = torch.empty((1,), dtype=torch.float32, device=dev)
            call_predict(plan, x_dense, mask, weights, w, preds, iterations)
        else:
            plan = launch_plan(b, f, sm_count=sm_count, shared_limit=shared_limit)
            spill = torch.empty((plan.spill_elements,), dtype=torch.bfloat16, device=dev)
            scratch = torch.empty((plan.scratch_floats,), dtype=torch.float32, device=dev)
            call_kernel(plan, kernel_args(
                plan, x_dense, labels, mask, weights, w, preds, spill, scratch,
                num_iterations=num_iterations, step_size=step_size, l2_reg=l2_reg,
                convergence_tol=convergence_tol, mode=mode,
            ))
            iterations = scratch[-1:]
        if torch.cuda.is_current_stream_capturing():
            fused_dense_sgd.captured += 1  # launched by each replay of the graph
        else:
            fused_dense_sgd.launches += 1
            fused_dense_sgd.predict_launches += int(num_iterations == 0)
    fused_dense_sgd.last_iterations = iterations[0]
    return w, preds


fused_dense_sgd.launches = 0
fused_dense_sgd.predict_launches = 0
fused_dense_sgd.captured = 0
fused_dense_sgd.last_iterations = None


def fused_dense_sgd_tenants(
    x_dense, labels, mask, weights, *, valid_rows, num_iterations: int, step_sizes,
    l2_regs, convergence_tol: float = 0.001, residual_fn=least_squares_residual,
):
    """M tenants' fused loops (B1 with a tenant grid dimension):
    ``x_dense`` [M, B, F], ``labels`` and ``mask`` [M, B], ``weights`` [M,
    F], tenant m with its own ``step_sizes[m]`` and ``l2_regs[m]``; every
    tenant shares the iterations, tolerance and residual mode. Returns
    (new_weights [M, F], raw_predictions [M, B]). ``valid_rows`` (host
    ints, one a tenant) bounds the rows the kernel reads as X: tenant m's
    rows past ``valid_rows[m]`` must be masked (the host knows each part's
    last valid row before the copy; no count is read back). On the CPU the
    plain version; on CUDA one cooperative launch of ``tenant_sgd_kernel``
    (csrc/fused_sgd.cu) for each TENANTS_PER_LAUNCH tenants, counted in
    ``fused_dense_sgd_tenants.launches``, each tenant's iterations run in
    the device tensor ``fused_dense_sgd_tenants.last_iterations`` [M]."""
    kw = dict(valid_rows=valid_rows, num_iterations=num_iterations, step_sizes=step_sizes,
              l2_regs=l2_regs, convergence_tol=convergence_tol, residual_fn=residual_fn)
    if x_dense.device.type == "cpu":
        _check_tenants(x_dense, **kw)
        return fused_dense_sgd_tenants_reference(
            x_dense, labels, mask, weights, num_iterations=num_iterations,
            step_sizes=step_sizes, l2_regs=l2_regs, convergence_tol=convergence_tol,
            residual_fn=residual_fn)
    w, preds, launches = _tenant_launches(x_dense, labels, mask, weights, **kw)
    fused_dense_sgd_tenants.launches += len(launches)
    iterations = [scratch[-plan.tenants:] for plan, scratch in launches]
    fused_dense_sgd_tenants.last_iterations = (
        iterations[0] if len(iterations) == 1 else torch.cat(iterations))
    return w, preds


def tenant_grid_probe(x_dense, labels, mask, weights, *, probe_iterations: int, **kw):
    """One launch of the tenant grid's timing instantiation (at most
    TENANTS_PER_LAUNCH tenants, on CUDA; ``fused_dense_sgd_tenants``'
    keywords): CTA 0 and each tenant's last CTA stamp (%globaltimer,
    clock64) at the prologue's 4 phase edges and at 6 edges of each of the
    first ``probe_iterations`` iterations (csrc/fused_sgd.cu
    ``probe_stamp``; stamps never reached stay 0). Counts no launch.
    Returns (w, preds, iterations run [M], stamps int64 [1 + M, 4 + 6 x
    probe_iterations, 2] on the device, the plan)."""
    if x_dense.dim() != 3 or not 1 <= x_dense.shape[0] <= TENANTS_PER_LAUNCH:
        raise ValueError(f"the probe takes 1..{TENANTS_PER_LAUNCH} tenants in one launch")
    edges = PROBE_PROLOGUE_EDGES + PROBE_ITERATION_EDGES * int(probe_iterations)
    probe = torch.zeros((x_dense.shape[0] + 1, edges, 2), dtype=torch.int64,
                        device=x_dense.device)
    w, preds, launches = _tenant_launches(x_dense, labels, mask, weights, probe=probe, **kw)
    plan, scratch = launches[0]
    return w, preds, scratch[-plan.tenants:], probe, plan


def tenant_probe_split(stamps) -> tuple:
    """One probe launch's phase split from ``tenant_grid_probe``'s stamps
    (int64 [slots, edges, 2] of %globaltimer ns and clock64): each stamping
    CTA's phase lengths in SM cycles turned into ns at that CTA's own rate
    over its whole span (%globaltimer ticks coarsely), then the mean over
    the stamping CTAs of each prologue phase (PROBE_PROLOGUE) and, over the
    iterations after the first, of each iteration phase (PROBE_PHASES), in
    µs. Returns (prologue, iteration phases, iterations stamped, the median
    CTA's span in µs)."""
    st = stamps.detach().cpu().to(torch.float64)
    n_pro, n_it = PROBE_PROLOGUE_EDGES, PROBE_ITERATION_EDGES
    pro, its, spans, n_iters = [], [], [], 0
    for g, c in zip(st[..., 0], st[..., 1]):
        stamped = torch.nonzero(g).flatten()
        if g[0] == 0 or len(stamped) == 0 or int(stamped[-1]) < n_pro:
            continue  # a slot no CTA stamped
        last = int(stamped[-1])
        us_a_cycle = (g[last] - g[0]) / max(float(c[last] - c[0]), 1.0) / 1e3
        spans.append(float(g[last] - g[0]) / 1e3)
        pro.append(torch.diff(c[:n_pro]) * us_a_cycle)
        done = (last + 1 - n_pro) // n_it  # iterations with all their edges
        n_iters = max(n_iters, done)
        if done >= 2:
            edges = c[n_pro - 1:n_pro + n_it * done]
            its.append(torch.diff(edges).reshape(done, n_it)[1:] * us_a_cycle)
    prologue = dict(zip(PROBE_PROLOGUE, torch.stack(pro).mean(0).tolist())) if pro else {}
    phases = dict(zip(PROBE_PHASES, torch.cat(its).mean(0).tolist())) if its else {}
    return (prologue, phases, n_iters,
            float(torch.tensor(spans, dtype=torch.float64).median()) if spans else None)


# the phases between the probe's edges: the prologue's, then an iteration's
PROBE_PROLOGUE = ("staging", "barrier 0", "counts")
PROBE_PHASES = ("row pass", "CTA reduce", "barrier 1", "tenant reduce + update", "barrier 2",
                "w reload + decisions")


def _check_tenants(x_dense, *, valid_rows, num_iterations, step_sizes, l2_regs,
                   convergence_tol, residual_fn):
    """The tenant grid's arguments as both routes take them; returns the
    residual mode."""
    mode = residual_mode(residual_fn)
    if mode is None:
        raise ValueError(f"fused_dense_sgd_tenants has no residual mode for {residual_fn!r}")
    if x_dense.dim() != 3:
        raise ValueError(f"x_dense must be [M, B, F], got {tuple(x_dense.shape)}")
    m, b, _ = x_dense.shape
    if not len(valid_rows) == len(step_sizes) == len(l2_regs) == m:
        raise ValueError(f"{m} tenants need {m} valid row counts, step sizes and L2s")
    if any(not 0 <= int(v) <= b for v in valid_rows):
        raise ValueError(f"valid rows {list(valid_rows)} outside [0, {b}]")
    if num_iterations < 0:
        raise ValueError("num_iterations must be >= 0")
    return mode


def _check_tenants_cuda(name: str, x_dense, labels, mask, weights, **kw) -> int:
    """``_check_tenants`` and what a tenant launch takes on the card: CUDA
    tensors, contiguous float32 of the tenant shapes; returns the residual
    mode."""
    mode = _check_tenants(x_dense, **kw)
    m, b, f = x_dense.shape
    dev = x_dense.device
    if dev.type != "cuda":
        raise ValueError(f"{name} takes cpu or cuda tensors, got {dev}")
    if not supports(batch_rows=b, num_features=f, dtype=weights.dtype):
        raise ValueError(f"{name} does not take X {tuple(x_dense.shape)} "
                         f"with {weights.dtype} weights (see supports())")
    for arg, t, shape in (("x_dense", x_dense, (m, b, f)), ("labels", labels, (m, b)),
                          ("mask", mask, (m, b)), ("weights", weights, (m, f))):
        if (t.device != dev or tuple(t.shape) != shape or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"{arg} must be contiguous float32 {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return mode


def _tenant_launches(x_dense, labels, mask, weights, *, valid_rows, num_iterations,
                     step_sizes, l2_regs, convergence_tol=0.001,
                     residual_fn=least_squares_residual, probe=None):
    """The tenant grid's cooperative launches on CUDA tensors, one for each
    TENANTS_PER_LAUNCH tenants (the timing instantiation with ``probe``, a
    one-launch int64 buffer). Returns (w [M, F], preds [M, B], each
    launch's (plan, scratch))."""
    mode = _check_tenants_cuda("fused_dense_sgd_tenants", x_dense, labels, mask, weights,
                               valid_rows=valid_rows, num_iterations=num_iterations,
                               step_sizes=step_sizes, l2_regs=l2_regs,
                               convergence_tol=convergence_tol, residual_fn=residual_fn)
    m, b, f = x_dense.shape
    valid_rows = [int(v) for v in valid_rows]
    dev = x_dense.device
    launches = []
    with torch.cuda.device(dev):
        sm_count, shared_limit = device_limits(torch.cuda.current_device())
        w = torch.empty((m, f), dtype=torch.float32, device=dev)
        preds = torch.empty((m, b), dtype=torch.float32, device=dev)
        for lo in range(0, m, TENANTS_PER_LAUNCH):
            hi = min(m, lo + TENANTS_PER_LAUNCH)
            plan = tenant_launch_plan(valid_rows[lo:hi], f, sm_count=sm_count,
                                      shared_limit=shared_limit)
            spill = torch.empty((plan.spill_elements,), dtype=torch.bfloat16, device=dev)
            scratch = torch.empty((plan.scratch_floats,), dtype=torch.float32, device=dev)
            n = plan.tenants
            err = _entry("twtml_fused_dense_sgd_tenants")(
                x_dense[lo].data_ptr(), labels[lo].data_ptr(), mask[lo].data_ptr(),
                weights[lo].data_ptr(), w[lo].data_ptr(), preds[lo].data_ptr(),
                spill.data_ptr(), scratch.data_ptr(), n, b, f, plan.fpad, plan.grid,
                plan.rows_cap, plan.resident, plan.spill_per_cta, plan.shared_bytes,
                _layout_arg(plan.smem_layout), (ctypes.c_int * (n + 1))(*plan.first_cta),
                (ctypes.c_int * n)(*plan.valid_rows),
                (ctypes.c_float * n)(*(float(v) for v in step_sizes[lo:hi])),
                (ctypes.c_float * n)(*(float(v) for v in l2_regs[lo:hi])),
                int(num_iterations), float(convergence_tol), int(mode),
                None if probe is None else probe.data_ptr(),
                0 if probe is None else probe.shape[1],
                torch.cuda.current_stream().cuda_stream)
            if err == 1:  # cudaErrorInvalidValue: the entry's own checks
                raise RuntimeError(f"fused_dense_sgd_tenants: the kernel refused the plan {plan}")
            if err != 0:
                raise RuntimeError(f"fused_dense_sgd_tenants launch failed: CUDA error {err}")
            launches.append((plan, scratch))
    return w, preds, launches


fused_dense_sgd_tenants.launches = 0
fused_dense_sgd_tenants.last_iterations = None


def fused_dense_sgd_tenants_split(
    x_dense, labels, mask, weights, *, valid_rows, allreduce, num_iterations: int,
    step_sizes, l2_regs, convergence_tol: float = 0.001, residual_fn=least_squares_residual,
):
    """M tenants' data-parallel loops on this rank's rows of their parts, the
    M steps' all-reduces batched into one (the vmap form of a tenant stack
    over a data axis): ``fused_dense_sgd_tenants``' arguments, with
    ``valid_rows`` this rank's, and ``allreduce(t)`` an in-place SUM over the
    ranks of a float32 tensor on the batch's device. Returns (new weights [M,
    F], this rank's raw predictions [M, B]).

    On the card, for each TENANTS_PER_LAUNCH tenants, ``split_schedule``'s
    launches of ``tenant_iteration_kernel`` (csrc/fused_sgd.cu; its first
    stages X and writes the predictions, each later one updates every
    tenant from the all-reduced buffer before its row pass, the last
    updates alone), and between iterations ONE ``allreduce`` of every
    tenant's Xᵀr and count, [M, fpad + 1] floats: N + 1 launches a
    TENANTS_PER_LAUNCH tenants and N all-reduces a step, whatever M, no host
    read of convergence. Counted in ``fused_dense_sgd_tenants_split.launches``;
    each tenant's iterations run in the device tensor
    ``.last_iterations`` [M]. On the CPU the plain version,
    ``fused_dense_sgd_tenants_split_reference``. At ``num_iterations == 0``
    no rank exchanges anything: the tenant grid's predict mode."""
    kw = dict(valid_rows=valid_rows, num_iterations=num_iterations, step_sizes=step_sizes,
              l2_regs=l2_regs, convergence_tol=convergence_tol, residual_fn=residual_fn)
    if num_iterations == 0:
        return fused_dense_sgd_tenants(x_dense, labels, mask, weights, **kw)
    if x_dense.device.type == "cpu":
        _check_tenants(x_dense, **kw)
        return fused_dense_sgd_tenants_split_reference(
            x_dense, labels, mask, weights, allreduce=allreduce,
            num_iterations=num_iterations, step_sizes=step_sizes, l2_regs=l2_regs,
            convergence_tol=convergence_tol, residual_fn=residual_fn)
    mode = _check_tenants_cuda("fused_dense_sgd_tenants_split", x_dense, labels, mask,
                               weights, **kw)
    step = TenantSplitStep(x_dense, labels, mask, weights, valid_rows=valid_rows,
                           step_sizes=step_sizes, l2_regs=l2_regs,
                           convergence_tol=convergence_tol, mode=mode)
    for what, it in split_schedule(num_iterations):
        if what == "allreduce":
            allreduce(step.gbuf)
        else:
            step.launch(it, row_pass=what == "grad")
    fused_dense_sgd_tenants_split.last_iterations = step.iterations
    return step.w, step.preds


class TenantSplitStep:
    """One step of the split with a tenant grid on the card, set up on the
    batch's device: the outputs ``w`` [M, F] and ``preds`` [M, B], the
    all-reduce buffer ``gbuf`` [M, fpad + 1] and, for each TENANTS_PER_LAUNCH
    tenants, its ``tenant_split_plan``, staged X, scratch, state and the C
    entry's handle: Params, tenant table and state built once here, so
    that ``launch(it, row_pass)`` passes the kernel only the handle, ``it``,
    ``row_pass`` and the current stream. A plan the C entry refuses raises
    here. ``launch`` makes iteration ``it``'s launch of every such group of
    tenants (with ``row_pass`` False the update of ``it`` alone), each
    counted in ``fused_dense_sgd_tenants_split.launches``; the caller
    all-reduces ``gbuf`` between them (``fused_dense_sgd_tenants_split``).
    With ``probe`` (int64 [1 + M, PROBE_SPLIT_EDGES, 2], zeroed; one group
    of tenants) every launch runs the timing instantiation. The arguments
    are checked by the caller (``_check_tenants_cuda``)."""

    def __init__(self, x_dense, labels, mask, weights, *, valid_rows, step_sizes, l2_regs,
                 convergence_tol: float, mode: int, probe=None):
        m, b, f = x_dense.shape
        valid_rows = [int(v) for v in valid_rows]
        dev = x_dense.device
        self.device = dev
        self._launch = _entry("twtml_tenant_split_launch")
        prepare = _entry("twtml_tenant_split_prepare")
        self.groups = []  # (plan, handle, buffers), one a TENANTS_PER_LAUNCH tenants
        handles = []  # freed with the step
        weakref.finalize(self, _release_handles, handles)
        with torch.cuda.device(dev):
            sm_count, shared_limit = device_limits(torch.cuda.current_device())
            self.w = torch.empty((m, f), dtype=torch.float32, device=dev)
            self.preds = torch.empty((m, b), dtype=torch.float32, device=dev)
            self.gbuf = torch.empty((m, padded_columns(f) + 1), dtype=torch.float32,
                                    device=dev)
            for lo in range(0, m, TENANTS_PER_LAUNCH):
                hi = min(m, lo + TENANTS_PER_LAUNCH)
                split = tenant_split_plan(valid_rows[lo:hi], b, f, sm_count=sm_count,
                                          shared_limit=shared_limit)
                plan, n = split.tenants, hi - lo
                bufs = (torch.empty((plan.spill_elements,), dtype=torch.bfloat16, device=dev),
                        torch.empty((split.scratch_floats,), dtype=torch.float32, device=dev),
                        torch.empty((1,), dtype=torch.int32, device=dev))
                handle = ctypes.c_void_p()
                err = prepare(
                    x_dense[lo].data_ptr(), labels[lo].data_ptr(), mask[lo].data_ptr(),
                    weights[lo].data_ptr(), self.w[lo].data_ptr(), self.preds[lo].data_ptr(),
                    *(t.data_ptr() for t in bufs), self.gbuf[lo].data_ptr(), n, b, f,
                    plan.fpad, plan.grid, plan.rows_cap, plan.shared_bytes,
                    _layout_arg(plan.smem_layout), (ctypes.c_int * (n + 1))(*plan.first_cta),
                    (ctypes.c_int * n)(*plan.valid_rows),
                    (ctypes.c_float * n)(*(float(v) for v in step_sizes[lo:hi])),
                    (ctypes.c_float * n)(*(float(v) for v in l2_regs[lo:hi])),
                    split.slices, float(convergence_tol), int(mode),
                    None if probe is None else probe.data_ptr(),
                    0 if probe is None else probe.shape[1], ctypes.byref(handle))
                if err == 1:  # cudaErrorInvalidValue: the entry's own checks
                    raise RuntimeError("fused_dense_sgd_tenants_split: the kernel refused the "
                                       f"plan {split}")
                if err != 0:
                    raise RuntimeError("fused_dense_sgd_tenants_split set-up failed: CUDA "
                                       f"error {err}")
                handles.append(handle)
                self.groups.append((split, handle, bufs))

    def launch(self, it: int, row_pass: bool = True) -> None:
        stream = torch.cuda.current_stream(self.device).cuda_stream
        for split, handle, _ in self.groups:
            err = self._launch(handle, it, row_pass, stream)
            if err != 0:  # a refused cooperative launch included
                raise RuntimeError("fused_dense_sgd_tenants_split launch failed: CUDA error "
                                   f"{err} (plan {split})")
            fused_dense_sgd_tenants_split.launches += 1

    @property
    def iterations(self) -> torch.Tensor:
        """Each tenant's iterations run (a device tensor [M])."""
        its = [bufs[1][-split.tenants.tenants:] for split, _, bufs in self.groups]
        return its[0] if len(its) == 1 else torch.cat(its)


def _release_handles(handles) -> None:
    release = _entry("twtml_tenant_split_release")
    for handle in handles:
        release(handle)


def tenant_split_probe(x_dense, labels, mask, weights, *, valid_rows, step_sizes, l2_regs,
                       convergence_tol: float = 0.0, residual_fn=least_squares_residual,
                       launches: int = 5):
    """The split with a tenant grid's timing instantiation (at most
    TENANTS_PER_LAUNCH tenants, on CUDA; ``fused_dense_sgd_tenants_split``'s
    keywords, the all-reduce an identity): the first launch stages X, then
    ``launches`` launches at it = 2, each stamping (%globaltimer, clock64)
    in CTA 0 and each tenant's last CTA at the PROBE_SPLIT_EDGES phase edges
    of one iteration (csrc/fused_sgd.cu ``probe_stamp``; stamps never
    reached stay 0). Counts its launches as the step does. Returns (w,
    preds, the stamps int64 [launches, 1 + M, PROBE_SPLIT_EDGES, 2] on the
    device, the plan)."""
    if x_dense.dim() != 3 or not 1 <= x_dense.shape[0] <= TENANTS_PER_LAUNCH:
        raise ValueError(f"the probe takes 1..{TENANTS_PER_LAUNCH} tenants in one launch")
    if x_dense.device.type != "cuda":
        raise ValueError("tenant_split_probe times the kernel on the card; got "
                         f"{x_dense.device}")
    kw = dict(valid_rows=valid_rows, step_sizes=step_sizes, l2_regs=l2_regs,
              convergence_tol=convergence_tol)
    mode = _check_tenants_cuda("tenant_split_probe", x_dense, labels, mask, weights,
                               num_iterations=2, residual_fn=residual_fn, **kw)
    probe = torch.zeros((x_dense.shape[0] + 1, PROBE_SPLIT_EDGES, 2), dtype=torch.int64,
                        device=x_dense.device)
    step = TenantSplitStep(x_dense, labels, mask, weights, mode=mode, probe=probe, **kw)
    step.launch(1)
    stamps = []
    for _ in range(launches):
        probe.zero_()
        step.launch(2)
        stamps.append(probe.clone())
    return step.w, step.preds, torch.stack(stamps), step.groups[0][0]


# the phases between the split probe's edges, in order
PROBE_SPLIT_PHASES = ("update", "barrier 1", "decisions + reloads", "row pass", "barrier 2",
                      "reduce")


def tenant_split_probe_split(stamps) -> tuple:
    """The phase split of ``tenant_split_probe``'s stamps (int64 [launches,
    slots, PROBE_SPLIT_EDGES, 2] of %globaltimer ns and clock64): for each
    launch and stamping CTA with every edge stamped, its phase lengths in SM
    cycles, turned into ns at one rate pooled over all of them (their
    %globaltimer spans over their cycle spans: a launch is a few µs, and
    %globaltimer ticks coarsely), then the mean of each phase
    (PROBE_SPLIT_PHASES) in µs. Returns (phases, launches counted, the mean
    span from entry to the reduce's end in µs, each stamping slot's phases:
    slot 0 is CTA 0, slot 1 + m tenant m's last CTA)."""
    st = stamps.detach().cpu().to(torch.float64)
    whole = (st[..., 0] != 0).all(dim=-1)  # [launches, slots]
    if not whole.any():
        return {}, 0, None, {}
    g, c = st[whole][..., 0], st[whole][..., 1]
    us_a_cycle = float((g[:, -1] - g[:, 0]).sum() / (c[:, -1] - c[:, 0]).sum().clamp(min=1.0)) / 1e3
    phases = torch.diff(c, dim=1) * us_a_cycle
    slot_of = whole.nonzero()[:, 1]
    by_slot = {int(k): dict(zip(PROBE_SPLIT_PHASES, phases[slot_of == k].mean(0).tolist()))
               for k in slot_of.unique()}
    return (dict(zip(PROBE_SPLIT_PHASES, phases.mean(0).tolist())), int(whole.any(dim=1).sum()),
            float((c[:, -1] - c[:, 0]).mean()) * us_a_cycle, by_slot)


fused_dense_sgd_tenants_split.launches = 0
fused_dense_sgd_tenants_split.last_iterations = None
