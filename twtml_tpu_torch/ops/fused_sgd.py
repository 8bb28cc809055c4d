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
NVCC_DEFINES = tuple(
    f"-DTWTML_SGD_{name}={value}" for name, value in (
        ("THREADS", THREADS), ("TILE_COLUMNS", TILE_COLUMNS),
        ("REDUCE_SLOTS", REDUCE_SLOTS), ("SCRATCH_FLOATS", SCRATCH_FLOATS),
        ("PREDICT_THREADS", PREDICT_THREADS),
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


def launch_plan(batch_rows: int, num_features: int, *, sm_count: int,
                shared_limit: int) -> LaunchPlan:
    """The grid, rows a CTA, resident/spill split and shared-memory layout
    of one call. At most one CTA an SM, and no more CTAs than give each warp
    a row. Shared memory holds w [fpad] f32, the reduction slots, y and r a
    row, a small scratch, then as many bf16 rows of X as fit in
    ``shared_limit`` (the card's opt-in limit a block: 232,448 B on an
    H100); a row up to TILE_COLUMNS wide is stored TILE_COLUMNS wide, so
    the narrow pass needs no bounds checks."""
    fpad = padded_columns(num_features)
    row_columns = max(fpad, TILE_COLUMNS)
    grid = max(1, min(sm_count, -(-batch_rows // WARPS)))
    rows_cap = -(-batch_rows // grid)
    red = _align16(fpad * 4)
    y = red + REDUCE_SLOTS * TILE_COLUMNS * 4
    r = y + _align16(rows_cap * 4)
    scratch = r + _align16(rows_cap * 4)
    x_rows = scratch + SCRATCH_FLOATS * 4
    if x_rows > shared_limit:
        raise ValueError(f"{batch_rows} rows x {num_features} columns need {x_rows} B "
                         f"of shared memory before any row of X; the limit is "
                         f"{shared_limit} B")
    resident = min(rows_cap, (shared_limit - x_rows) // (2 * row_columns))
    return LaunchPlan(
        rows=batch_rows, fpad=fpad, row_columns=row_columns, grid=grid,
        rows_cap=rows_cap, resident=resident, spill_per_cta=rows_cap - resident,
        shared_bytes=x_rows + resident * 2 * row_columns,
        smem_layout=(red, y, r, scratch, x_rows, row_columns // COLUMN_MULTIPLE),
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
_ENTRIES = {"twtml_fused_dense_sgd": KERNEL_ARGTYPES,
            "twtml_fused_dense_predict": PREDICT_ARGTYPES}


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
