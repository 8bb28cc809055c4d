"""The sparse regime's Gram route on the card: three hand-written CUDA
kernels for Hopper and their plain PyTorch twins (counterparts of the XLA
fusions of ``twtml_tpu/ops/gram.py`` and ``twtml_tpu/models/sgd.py``
``run_dual_loop``; no TPU kernel stands behind them).

- B4 ``count_build``: [B, L] (idx, val) pairs -> the dense [rows_out,
  cols_out] counts C, int8 (the int8 plane) or f32 (the bf16 and exact
  planes), every byte of C written once (zeros included) after a sort of
  the row's tokens in shared memory (``count_layout`` sizes it). Twin:
  ``ops/gram.py`` ``onehot_counts_int8`` / ``onehot_counts`` /
  ``densify_counts``.
- the G product ``gram_from_counts``: C·Cᵀ, ``torch._int_mm`` (s8·s8 -> s32,
  then an exact f32 cast) in the int8 plane, an f32 ``torch.matmul`` (TF32
  off) in the others. A library GEMM, as the JAX package leaves it to XLA.
- B7 ``dual_sgd``: MLlib's loop on the dual state {c, α}, one persistent
  cooperative launch a batch, G's rows resident in shared memory. Twin:
  ``dual_sgd_reference`` (models/sgd.py ``run_dual_loop`` as torch ops).
- B8 ``dual_writeback_counts``: W_new = c·W_prev + Cᵀα (and the numeric
  columns' w_num·c + Nᵀα) in one fixed-order column pass over C. Twin:
  ``dual_writeback_reference``.

The kernels are ``csrc/gram.cu`` (its header gives each design). None uses
float atomics: reruns are bitwise equal. Routing as in ops/fused_sgd.py: a
CPU tensor goes to the twin; a CUDA tensor launches the kernel or raises.
Each wrapper counts the calls that launched its kernel in ``.launches``; a
call made while the current stream is captured into a CUDA graph counts
into ``.captured`` instead, and whoever replays the graph adds those to
``.launches`` at each replay (models/sgd.py ``step_many``).

Shapes the card's route pads to (``padded_rows``, ``padded_columns``): C's
rows to a multiple of 8 and at least 24, its columns to a multiple of 16,
which ``torch._int_mm`` needs (more than 16 rows; K and N multiples of 8)
and the count build's 16-byte stores take; the padding rows and columns
are zero, so G's padding is zero too.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .fused_sgd import least_squares_residual, residual_mode
from .gram import densify_counts, onehot_counts_int8

# constants of csrc/gram.cu that size its launches; the build passes them
# to nvcc, and the source static_asserts its own against them
COUNT_THREADS = 256
COUNT_KEY_BYTES = 8  # a count-build sort key: idx << ceil(log2 L) | j
DUAL_THREADS = 256
DUAL_WARPS = DUAL_THREADS // 32
DUAL_RED_FLOATS = 64  # the reduction scratch of a CTA
WRITEBACK_THREADS = 256
WRITEBACK_COLUMNS = 128  # text columns a block of B8 owns
NVCC_DEFINES = tuple(
    f"-DTWTML_GRAM_{name}={value}" for name, value in (
        ("COUNT_THREADS", COUNT_THREADS), ("COUNT_KEY_BYTES", COUNT_KEY_BYTES),
        ("DUAL_THREADS", DUAL_THREADS),
        ("DUAL_RED_FLOATS", DUAL_RED_FLOATS), ("WRITEBACK_THREADS", WRITEBACK_THREADS),
        ("WRITEBACK_COLUMNS", WRITEBACK_COLUMNS),
    )
)
COUNT_KINDS = {torch.int8: 0, torch.float32: 1}


def padded_rows(rows: int) -> int:
    """C's (and G's) row count on the card: a multiple of 8, at least 24."""
    return max(24, -(-rows // 8) * 8)


def padded_columns(features: int) -> int:
    """C's column count on the card: a multiple of 16."""
    return -(-features // 16) * 16


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def count_token_bits(tokens: int) -> int:
    """ceil(log2 L): the low bits of a count-build sort key, which hold the
    token's position j."""
    return (tokens - 1).bit_length()


class CountLayout(NamedTuple):
    """One count-build CTA's dynamic shared memory (csrc/gram.cu
    count_layout): the sort keys [width] at 0, the values [L] f32 at
    ``vals``, each 16-byte aligned, ``shared_bytes`` in all. It depends on
    L alone."""

    token_bits: int
    width: int  # keys sorted: the next power of two >= L
    vals: int
    shared_bytes: int


def count_layout(tokens: int) -> CountLayout:
    """The shared memory of one count-build CTA for L = ``tokens``."""
    bits = count_token_bits(tokens)
    vals = _align16((1 << bits) * COUNT_KEY_BYTES)
    return CountLayout(token_bits=bits, width=1 << bits, vals=vals,
                       shared_bytes=vals + _align16(4 * tokens))


def count_shared_bytes(tokens: int, *, shared_limit: int) -> int:
    """Dynamic shared memory of one count-build CTA (``count_layout``);
    raises when it exceeds ``shared_limit`` (232,448 B a block on an H100)."""
    shared = count_layout(tokens).shared_bytes
    if shared > shared_limit:
        raise ValueError(f"count_build: {tokens} tokens a row need {shared} B of shared "
                         f"memory; the limit is {shared_limit} B")
    return shared


class DualPlan(NamedTuple):
    """How one B7 launch lays G over the card. CTA c owns rows
    [c*B // grid, (c+1)*B // grid); the first ``resident`` of them stay in
    shared memory (``bp`` floats a row), the rest are staged once into the
    spill buffer and read through L2 each iteration."""

    rows: int
    bp: int  # floats a stored row of G takes (rows rounded up to 4)
    grid: int
    rows_cap: int
    resident: int
    spill_per_cta: int
    shared_bytes: int
    # byte offsets of dα, the mask, u, y, G·α, the reduction scratch and the
    # resident rows (α at 0); the C entry refuses a plan that differs from
    # the kernel's own dual_layout()
    smem_layout: tuple[int, int, int, int, int, int, int]

    def cta_rows(self, cta: int) -> range:
        return range(cta * self.rows // self.grid, (cta + 1) * self.rows // self.grid)

    @property
    def resident_rows(self) -> int:
        return sum(min(len(self.cta_rows(c)), self.resident) for c in range(self.grid))

    @property
    def spill_rows(self) -> int:
        return self.rows - self.resident_rows

    @property
    def spill_floats(self) -> int:
        return self.grid * self.spill_per_cta * self.bp

    @property
    def scratch_floats(self) -> int:
        """α and Δα twice (the double buffer), the convergence partials [grid,
        4], then c and the iterations run."""
        return 4 * self.bp + 4 * self.grid + 2


def dual_plan(rows: int, *, sm_count: int, shared_limit: int) -> DualPlan:
    """The grid, rows a CTA and resident/spill split of one B7 launch. Shared
    memory holds α, Δα and the validity mask of the whole batch ([bp] f32
    each), u, y and G·α of the CTA's rows, a small scratch, then as many
    f32 rows of G as fit in ``shared_limit`` (232,448 B on an H100). At most
    one CTA an SM, and no more CTAs than give each warp a row."""
    if rows < 1:
        raise ValueError("the dual loop needs at least one row")
    bp = -(-rows // 4) * 4
    grid = max(1, min(sm_count, -(-rows // DUAL_WARPS)))
    rows_cap = -(-rows // grid)
    vec = _align16(4 * bp)
    own = _align16(4 * rows_cap)
    dalpha, mask, u = vec, 2 * vec, 3 * vec
    y = u + own
    s = y + own
    red = s + own
    g = red + DUAL_RED_FLOATS * 4
    if g > shared_limit:
        raise ValueError(f"{rows} rows need {g} B of shared memory before any row of G; "
                         f"the limit is {shared_limit} B")
    resident = min(rows_cap, (shared_limit - g) // (4 * bp))
    return DualPlan(
        rows=rows, bp=bp, grid=grid, rows_cap=rows_cap, resident=resident,
        spill_per_cta=rows_cap - resident, shared_bytes=g + resident * 4 * bp,
        smem_layout=(dalpha, mask, u, y, s, red, g),
    )


# ---------------------------------------------------------------- plain twins


def count_build_reference(token_idx, token_val, f_text: int, *, int8: bool,
                          rows_out: "int | None" = None, cols_out: "int | None" = None):
    """B4's twin: the plane's dense counts (``onehot_counts_int8``, or the
    f32 ``densify_counts``), zero-padded to [rows_out, cols_out]."""
    b = token_idx.shape[0]
    rows_out = b if rows_out is None else rows_out
    cols_out = f_text if cols_out is None else cols_out
    if int8:
        c = onehot_counts_int8(token_idx, token_val, f_text)
    else:
        # f32 values summed in f32, in token order: the exact plane's counts,
        # and the bf16 plane's (its values are bf16-exact by its gate)
        c = densify_counts(token_idx, token_val, f_text)
    return torch.nn.functional.pad(c, (0, cols_out - f_text, 0, rows_out - b))


def gram_from_counts(counts):
    """G = C·Cᵀ ([rows, rows] f32) from the count build's padded C: on the
    card ``torch._int_mm`` for int8 counts (|G| < 2^24: the f32 cast is
    exact), an f32 matmul (TF32 off) for f32 counts; on the CPU a float64
    product (exact for the planes' integer counts) cast to f32."""
    if counts.device.type == "cuda":
        if counts.dtype == torch.int8:
            return torch._int_mm(counts, counts.t()).float()
        return counts @ counts.t()
    c = counts.double()
    return (c @ c.T).float()


def dual_sgd_reference(g, u, labels, mask, *, masks=None, p_prev, num_iterations: int,
                       step_size: float, l2_reg: float = 0.0,
                       convergence_tol: float = 0.001,
                       residual_fn=least_squares_residual):
    """B7's twin: ``run_dual_loop`` as torch ops in f32 on G[:B, :B], with the
    kernel's treatment of invalid rows (mask <= 0): their u, y and their rows
    and columns of G are zeroed with ``where`` (NaN * 0 would poison the
    loop), so whatever they hold is ignored. Returns (c [] f32, α [B] f32,
    iterations run [] int64: the iteration that converged, else N)."""
    from ..models.sgd import run_dual_loop  # the one home of the MLlib rule

    b = mask.shape[0]
    keep = mask > 0
    both = keep[:, None] & keep[None, :]
    gm = torch.where(both, g[:b, :b].float(), 0.0)
    um = torch.where(keep, u.float(), 0.0)
    ym = torch.where(keep, labels.float(), 0.0)
    dual, iterations = run_dual_loop(
        u=um, g=gm, labels=ym, mask=mask.float(), dtype=torch.float32,
        residual_fn=residual_fn or least_squares_residual,
        num_iterations=num_iterations, step_size=step_size, l2_reg=l2_reg,
        convergence_tol=convergence_tol, p_prev=p_prev.float(), masks=masks,
        with_iterations=True,
    )
    return dual["c"], dual["alpha"], iterations


def dual_writeback_reference(weights, c, alpha, counts, numeric, f_text: int):
    """B8's twin: W_new = c·W_prev + Cᵀα over the text columns, w_num·c + Nᵀα
    over the 4 numeric ones, from the count build's (padded) C."""
    b = alpha.shape[0]
    cf = counts[:b, :f_text].float()
    text = weights[:f_text] * c + cf.T @ alpha
    num = weights[f_text:] * c + numeric.float().T @ alpha
    return torch.cat([text, num])


# ---------------------------------------------------------------- the kernels

# the C entries of csrc/gram.cu: name -> argument types
_ENTRIES = {
    "twtml_count_build": (
        [ctypes.c_void_p] * 3  # idx, val, out
        + [ctypes.c_int] * 7  # rows, tokens, features, rows_out, cols, kind, shared_bytes
        + [ctypes.c_void_p]  # stream
    ),
    "twtml_dual_sgd": (
        [ctypes.c_void_p] + [ctypes.c_longlong]  # g, ldg
        + [ctypes.c_void_p] * 8  # u, y, mask, masks, p_prev, alpha_out, scratch, spill
        + [ctypes.c_int] * 7  # rows, bp, grid, rows_cap, resident, spill_per_cta, shared_bytes
        + [ctypes.POINTER(ctypes.c_int)]  # the plan's smem_layout
        + [ctypes.c_int]  # iterations
        + [ctypes.c_float] * 3  # step_size, l2_reg, tol
        + [ctypes.c_int]  # residual_mode
        + [ctypes.c_void_p]  # stream
    ),
    "twtml_dual_writeback": (
        [ctypes.c_void_p]  # counts
        + [ctypes.c_int] * 4  # kind, rows, cols, features
        + [ctypes.c_void_p] * 5  # alpha, c, w_prev, numeric, w_out
        + [ctypes.c_void_p]  # stream
    ),
}


@functools.cache
def _entry(name: str):
    """A C entry of csrc/gram.cu, built at first use."""
    from ._build import load

    fn = getattr(load("gram"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = _ENTRIES[name]
    return fn


@functools.cache
def device_limits(index: int) -> tuple[int, int]:
    """(SM count, opt-in shared memory a block) of CUDA device ``index``.
    The first call for a device also raises the kernels' dynamic
    shared-memory limit there, which their launches need."""
    from ._build import load

    fn = load("gram").twtml_gram_setup
    fn.restype = ctypes.c_int
    sms, shared = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(index, ctypes.byref(sms), ctypes.byref(shared))
    if err != 0:
        raise RuntimeError(f"fused_gram: device set-up failed: CUDA error {err}")
    return sms.value, shared.value


@functools.lru_cache(maxsize=64)
def _layout_arg(smem_layout: tuple[int, ...]):
    return (ctypes.c_int * len(smem_layout))(*smem_layout)


def _check(name, t, shape, dtype, dev):
    if (t.device != dev or tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be contiguous {dtype} {tuple(shape)} on {dev}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _raise_on(err: int, what: str) -> None:
    if err == 1:  # cudaErrorInvalidValue: the entry's own checks
        raise RuntimeError(f"{what}: the kernel refused its arguments (sizes, or a "
                           "launch plan whose layout differs from csrc/gram.cu's)")
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _count(fn) -> None:
    if torch.cuda.is_current_stream_capturing():
        fn.captured += 1  # launched by each replay of the graph
    else:
        fn.launches += 1


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def count_build(token_idx, token_val, f_text: int, *, int8: bool,
                rows_out: "int | None" = None, cols_out: "int | None" = None):
    """B4: [B, L] int32 indices and f32 values -> the dense counts
    [rows_out, cols_out] (int8 when ``int8``, else f32), zero past the
    batch's rows and the ``f_text`` features; the sums in token order.
    On the card indices outside [0, f_text) are ignored (the CPU route is
    the twin, which follows the JAX scatter). On the card ``rows_out``
    defaults to ``padded_rows(B)`` and ``cols_out`` to
    ``padded_columns(f_text)``, which must be a multiple of 16."""
    dev = token_idx.device
    b, l = token_idx.shape
    if dev.type == "cpu":
        return count_build_reference(token_idx, token_val, f_text, int8=int8,
                                     rows_out=rows_out, cols_out=cols_out)
    if dev.type != "cuda":
        raise ValueError(f"count_build takes cpu or cuda tensors, got {dev}")
    rows_out = padded_rows(b) if rows_out is None else rows_out
    cols_out = padded_columns(f_text) if cols_out is None else cols_out
    _check("token_idx", token_idx, (b, l), torch.int32, dev)
    _check("token_val", token_val, (b, l), torch.float32, dev)
    if rows_out < b or cols_out < f_text or cols_out % 16 or l < 1:
        raise ValueError(f"count_build: [{rows_out}, {cols_out}] cannot hold {b} rows x "
                         f"{f_text} features with 16-byte rows (and L >= 1)")
    dtype = torch.int8 if int8 else torch.float32
    with torch.cuda.device(dev):
        _, shared_limit = device_limits(torch.cuda.current_device())
        shared = count_shared_bytes(l, shared_limit=shared_limit)
        out = torch.empty((rows_out, cols_out), dtype=dtype, device=dev)
        _raise_on(_entry("twtml_count_build")(
            token_idx.data_ptr(), token_val.data_ptr(), out.data_ptr(), b, l, f_text,
            rows_out, cols_out, COUNT_KINDS[dtype], shared, _stream()), "count_build")
        _count(count_build)
    return out


def dual_sgd(g, u, labels, mask, *, masks=None, p_prev, num_iterations: int,
             step_size: float, l2_reg: float = 0.0, convergence_tol: float = 0.001,
             residual_fn=least_squares_residual):
    """B7: MLlib's loop on the dual state from G ([≥B, ≥B] f32, row stride
    ≥ B: the first B rows and columns are read), u = Z·W_prev, labels and
    the validity mask [B] f32, the [N, B] Bernoulli masks (None: every
    valid row each iteration) and p_prev = ||W_prev||² (a [] f32 tensor).
    Rows with mask <= 0 are ignored, whatever their u, y and G hold.
    Returns (c [] f32, α [B] f32, iterations run: the iteration that
    converged, else N; a [] tensor, read it only when a sync is fine)."""
    mode = residual_mode(residual_fn)
    if mode is None:
        raise ValueError(f"dual_sgd has no residual mode for {residual_fn!r}")
    dev = g.device
    kw = dict(masks=masks, p_prev=p_prev, num_iterations=num_iterations,
              step_size=step_size, l2_reg=l2_reg, convergence_tol=convergence_tol)
    if dev.type == "cpu":
        return dual_sgd_reference(g, u, labels, mask, residual_fn=residual_fn, **kw)
    if dev.type != "cuda":
        raise ValueError(f"dual_sgd takes cpu or cuda tensors, got {dev}")
    b = mask.shape[0]
    if (g.dim() != 2 or g.dtype != torch.float32 or g.device != dev or g.shape[0] < b
            or g.shape[1] < b or g.stride(1) != 1):
        raise ValueError(f"g must be float32 [>= {b}, >= {b}] with unit column stride on "
                         f"{dev}, got {g.dtype} {tuple(g.shape)} strides {g.stride()}")
    for name, t in (("u", u), ("labels", labels), ("mask", mask)):
        _check(name, t, (b,), torch.float32, dev)
    _check("p_prev", p_prev, (), torch.float32, dev)
    if masks is not None:
        _check("masks", masks, (num_iterations, b), torch.float32, dev)
    if num_iterations < 0:
        raise ValueError("num_iterations must be >= 0")
    with torch.cuda.device(dev):
        sm_count, shared_limit = device_limits(torch.cuda.current_device())
        plan = dual_plan(b, sm_count=sm_count, shared_limit=shared_limit)
        alpha = torch.empty((b,), dtype=torch.float32, device=dev)
        scratch = torch.empty((plan.scratch_floats,), dtype=torch.float32, device=dev)
        spill = torch.empty((max(plan.spill_floats, 1),), dtype=torch.float32, device=dev)
        _raise_on(_entry("twtml_dual_sgd")(
            g.data_ptr(), g.stride(0), u.data_ptr(), labels.data_ptr(), mask.data_ptr(),
            0 if masks is None else masks.data_ptr(), p_prev.data_ptr(), alpha.data_ptr(),
            scratch.data_ptr(), spill.data_ptr(), plan.rows, plan.bp, plan.grid,
            plan.rows_cap, plan.resident, plan.spill_per_cta, plan.shared_bytes,
            _layout_arg(plan.smem_layout), int(num_iterations), float(step_size),
            float(l2_reg), float(convergence_tol), mode, _stream()), "dual_sgd")
        _count(dual_sgd)
    return scratch[-2], alpha, scratch[-1]


def dual_writeback_counts(weights, c, alpha, counts, numeric, f_text: int):
    """B8: W_new [F+4] = c·W_prev + Cᵀα over the text columns (C the count
    build's [≥B, cols] int8 or f32 counts; rows past B are not read) and
    w_num·c + Nᵀα over the numeric ones, each column summed over the rows
    in a fixed order. ``c`` is a [] f32 tensor, ``alpha`` [B]."""
    dev = weights.device
    if dev.type == "cpu":
        return dual_writeback_reference(weights, c, alpha, counts, numeric, f_text)
    if dev.type != "cuda":
        raise ValueError(f"dual_writeback_counts takes cpu or cuda tensors, got {dev}")
    b = alpha.shape[0]
    rows, cols = counts.shape
    _check("weights", weights, (f_text + numeric.shape[1],), torch.float32, dev)
    _check("alpha", alpha, (b,), torch.float32, dev)
    _check("c", c, (), torch.float32, dev)
    _check("numeric", numeric, (b, 4), torch.float32, dev)
    if (counts.dtype not in COUNT_KINDS or counts.device != dev or not counts.is_contiguous()
            or rows < b or cols < f_text or cols % 16):
        raise ValueError(f"counts must be contiguous int8 or float32 [>= {b}, >= {f_text}] "
                         f"(columns a multiple of 16) on {dev}, got {counts.dtype} "
                         f"{tuple(counts.shape)}")
    with torch.cuda.device(dev):
        w_out = torch.empty_like(weights)
        _raise_on(_entry("twtml_dual_writeback")(
            counts.data_ptr(), COUNT_KINDS[counts.dtype], b, cols, f_text,
            alpha.data_ptr(), c.data_ptr(), weights.data_ptr(), numeric.data_ptr(),
            w_out.data_ptr(), _stream()), "dual_writeback_counts")
        _count(dual_writeback_counts)
    return w_out


# the counted wrappers of this module, in the order the route calls them
KERNELS = (count_build, dual_sgd, dual_writeback_counts)
for _fn in KERNELS:
    _fn.launches = 0
    _fn.captured = 0
