"""The fused dense streaming-SGD loop: a hand-written CUDA kernel for Hopper
and its plain PyTorch twin (counterpart of ``twtml_tpu/ops/pallas_sgd.py``).

``fused_dense_sgd`` replaces ``twtml_tpu/ops/pallas_sgd.py::_sgd_kernel``:
predict with the pre-update weights, then run MLlib's GradientDescent loop
(1-indexed stepSize/sqrt(i), L2 pre-scale, zero-count skip, converged
freeze) on a dense [B, F] batch. X is stored in bf16 (the bigram counts are
small integers, exact in bf16); w, r, g and every sum stay in f32.

On an H100 the loop is bound by bytes: every iteration reads X twice and
does 2 flops per element read. At the operating point (16384 x 1004) bf16 X
is 32.9 MB and fits the 50 MB L2, so the kernel (``csrc/fused_sgd.cu``,
whose header gives the design) re-reads it from L2 rather than from device
memory. The design is three launches per iteration with the loop state on
the device and no float atomics: 1 + 3*N launches per call, no host sync,
bitwise-equal reruns.

Routing: a CPU tensor goes to the twin ``fused_dense_sgd_reference``; a CUDA
tensor launches the kernel or raises. ``fused_dense_sgd.launches`` counts
the calls that launched the kernel.
"""

from __future__ import annotations

import ctypes

import torch

# rows of X each block of the Xᵀr pass reduces into one row of partials
ROWS_PER_CHUNK = 128
# the kernel reads 8 bf16 (16 bytes) at a time along a row
COLUMN_MULTIPLE = 8
# the dense regime's widest design matrix: 8192 text + 4 numeric columns
MAX_FEATURES = 8192 + 4


def padded_columns(num_features: int) -> int:
    return -(-num_features // COLUMN_MULTIPLE) * COLUMN_MULTIPLE


def launches_per_call(num_iterations: int) -> int:
    """Device kernel launches one call makes: preds, then 3 per iteration."""
    return 1 + 3 * num_iterations


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


def fused_dense_sgd_reference(
    x_dense, labels, mask, weights, *, num_iterations: int, step_size: float,
    l2_reg: float = 0.0, convergence_tol: float = 0.001,
):
    """The plain PyTorch twin: the kernel's function on the same
    bf16-rounded X in f32 arithmetic, summing in torch's order. Masked rows
    and labels are zeroed with ``where`` (NaN * 0 would poison the
    gradient). Returns (new_weights [F], raw_predictions [B])."""
    from ..models.sgd import sgd_inner_loop  # the one home of the MLlib rule

    keep = mask > 0
    x = torch.where(keep[:, None], x_dense, 0.0).to(torch.bfloat16).float()
    y = torch.where(keep, labels.float(), 0.0)
    count = mask.float().sum()
    w0 = weights.float()
    preds = x @ w0

    def grad_and_count(w):
        return x.T @ (x @ w - y), count

    w = sgd_inner_loop(
        w0,
        num_iterations=num_iterations,
        step_size=step_size,
        l2_reg=l2_reg,
        convergence_tol=convergence_tol,
        grad_and_count=grad_and_count,
    )
    return w, preds


def _library():
    from ._build import load

    fn = load("fused_sgd").twtml_fused_dense_sgd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 8  # x, y, count, w, preds, residual, partials, flag
        + [ctypes.c_int] * 5  # rows, features, fpad, rows_per_chunk, iterations
        + [ctypes.c_float] * 3  # step_size, l2_reg, tol
        + [ctypes.c_void_p]  # stream
    )
    return fn


def fused_dense_sgd(
    x_dense, labels, mask, weights, *, num_iterations: int, step_size: float,
    l2_reg: float = 0.0, convergence_tol: float = 0.001,
):
    """Run the fused loop on a dense [B, F] batch; ``weights`` is the flat
    [F] vector. Returns (new_weights [F], raw_predictions [B]), where the
    predictions use the pre-update weights."""
    dev = x_dense.device
    if dev.type == "cpu":
        return fused_dense_sgd_reference(
            x_dense, labels, mask, weights, num_iterations=num_iterations,
            step_size=step_size, l2_reg=l2_reg, convergence_tol=convergence_tol,
        )
    if dev.type != "cuda":
        raise ValueError(f"fused_dense_sgd takes cpu or cuda tensors, got {dev}")
    b, f = x_dense.shape
    if not supports(batch_rows=b, num_features=f, dtype=weights.dtype):
        raise ValueError(
            f"fused_dense_sgd kernel does not take X {tuple(x_dense.shape)} "
            f"with {weights.dtype} weights (see supports())"
        )
    for name, t, shape in (
        ("labels", labels, (b,)), ("mask", mask, (b,)), ("weights", weights, (f,)),
    ):
        if t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if num_iterations < 0:
        raise ValueError("num_iterations must be >= 0")

    fpad = padded_columns(f)
    keep = mask > 0
    x = torch.zeros((b, fpad), dtype=torch.bfloat16, device=dev)
    x[:, :f] = torch.where(keep[:, None], x_dense, 0.0)
    y = torch.where(keep, labels.float(), 0.0).contiguous()
    count = mask.float().sum().reshape(1)
    w = torch.zeros((fpad,), dtype=torch.float32, device=dev)
    w[:f] = weights
    preds = torch.empty((b,), dtype=torch.float32, device=dev)
    residual = torch.empty((b,), dtype=torch.float32, device=dev)
    chunks = -(-b // ROWS_PER_CHUNK)
    partials = torch.empty((chunks, fpad), dtype=torch.float32, device=dev)
    converged = torch.zeros((1,), dtype=torch.int32, device=dev)

    fn = _library()
    with torch.cuda.device(dev):
        err = fn(
            x.data_ptr(), y.data_ptr(), count.data_ptr(), w.data_ptr(),
            preds.data_ptr(), residual.data_ptr(), partials.data_ptr(),
            converged.data_ptr(), b, f, fpad, ROWS_PER_CHUNK,
            int(num_iterations), float(step_size), float(l2_reg),
            float(convergence_tol), torch.cuda.current_stream(dev).cuda_stream,
        )
        fused_dense_sgd.launches += 1
    if err != 0:
        raise RuntimeError(f"fused_dense_sgd kernel launch failed: CUDA error {err}")
    return w[:f], preds


fused_dense_sgd.launches = 0
