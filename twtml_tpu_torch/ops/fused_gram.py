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
  cooperative launch a batch (B7's tenant table of one tenant), one grid
  barrier and one pass over G an iteration, G's rows in registers (or
  shared memory) across the loop. Twin: ``dual_sgd_reference``
  (models/sgd.py ``run_dual_loop`` as torch ops).
- B8 ``dual_writeback_counts``: W_new = c·W_prev + Zᵀα from the batch's
  [B, L] tokens, α and numeric rows (it reads no C): one cooperative launch
  that sorts tiles of WRITEBACK_TILE occurrences by column in shared memory
  and sums each column's run pairwise, then, after one grid barrier, each
  bucket of 256 columns (32 lines of 8, interleaved over the buckets)
  gathers its tile sums in tile order and adds them in the same pairwise
  tree (``writeback_plan`` sizes its scratch). Plain
  version: ``dual_writeback_reference``, the scatter write-back of
  ``ops/gram.py``; the kernel's own order on the host:
  ``dual_writeback_in_order``.

The tenant forms (the vmap form of a tenant stack, ``jax.vmap`` of the
step in the JAX package) take M parts of B rows and each part's valid rows:
``count_build_tenants`` (B4's, one launch for the tenants of one Gram
plane, every block bitwise B4's), ``tenant_gram_blocks`` (one library
product a tenant over its valid rows), ``dual_sgd_tenants`` (B7's, M dual
loops in one cooperative launch, ``dual_tenants_plan``; its timing
instantiation ``dual_tenants_probe``, read by ``dual_tenants_probe_split``)
and ``dual_writeback_tenants`` (B8's, every row bitwise B8's on the same
rows, every tenant in one launch whatever its plane); each plain version is
M calls of the single-tenant one. B4, B7 and
B8 each have one kernel and one C entry: a single batch is their tenant
table of one tenant. Over a data axis (``models/sgd.py``
``gram_tenants_parallel``) the same forms take a rank's share: B4's each
tenant's rows of every rank as segments of the gathered parts,
``tenant_gram_blocks(rows=)`` the rank's row panels, B7's each tenant's own
draws ([N, M, B] masks), B8's the rank's rows of each block
(``first_rows``) and of each gathered part of the tokens (``token_rows``).

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
from .gram import add_numeric_block, densify_counts, onehot_counts_int8

# constants of csrc/gram.cu that size its launches; the build passes them
# to nvcc, and the source static_asserts its own against them
COUNT_THREADS = 256
COUNT_KEY_BYTES = 8  # a count-build sort key: idx << ceil(log2 L) | j
DUAL_THREADS = 256
DUAL_WARPS = DUAL_THREADS // 32
DUAL_ROWS = 16  # rows of G a product pass sums at once
DUAL_REG_COLUMNS = 2  # float4 columns of each row of G a thread holds in registers
DUAL_MAX_GRID = 160  # CTAs a launch (the decider warp reads 5 CTAs' partials a lane)
# the reduction scratch of a CTA: row partials [warps][rows], block_sum's
# [warps], the converged flag; a multiple of 16 bytes
DUAL_RED_FLOATS = (DUAL_WARPS * DUAL_ROWS + DUAL_WARPS + 4) & ~3
WRITEBACK_THREADS = 256
WRITEBACK_COLUMNS = 256  # columns of a B8 bucket: a thread each in its bucket pass
WRITEBACK_TILE = 512  # occurrences a tile of B8's tile pass sorts
WRITEBACK_WINDOW = 2048  # tile sums B8's bucket pass sorts at once
WRITEBACK_GROUP = 2048  # tiles B8's bucket pass reads the table of at once
WRITEBACK_CTAS_PER_SM = 4  # B8's grid: at most this many CTAs an SM
TENANTS_PER_LAUNCH = 32  # tenants a tenant-form launch (B7's: a lane of its decider warp each)
# B7's tenant form's timing probe: the phase edges it stamps in the prologue
# (entry, G staged), then in each iteration (the ends of DUAL_PROBE_PHASES)
DUAL_PROBE_PROLOGUE_EDGES = 2
DUAL_PROBE_ITERATION_EDGES = 6
DUAL_PROBE_PHASES = ("update", "barrier 1", "product", "partials", "barrier 2", "decision")
NVCC_DEFINES = tuple(
    f"-DTWTML_GRAM_{name}={value}" for name, value in (
        ("COUNT_THREADS", COUNT_THREADS), ("COUNT_KEY_BYTES", COUNT_KEY_BYTES),
        ("DUAL_THREADS", DUAL_THREADS), ("DUAL_ROWS", DUAL_ROWS),
        ("DUAL_REG_COLUMNS", DUAL_REG_COLUMNS), ("DUAL_MAX_GRID", DUAL_MAX_GRID),
        ("DUAL_RED_FLOATS", DUAL_RED_FLOATS), ("WRITEBACK_THREADS", WRITEBACK_THREADS),
        ("WRITEBACK_COLUMNS", WRITEBACK_COLUMNS), ("WRITEBACK_TILE", WRITEBACK_TILE),
        ("WRITEBACK_WINDOW", WRITEBACK_WINDOW), ("WRITEBACK_GROUP", WRITEBACK_GROUP),
        ("TENANTS_PER_LAUNCH", TENANTS_PER_LAUNCH),
        ("DUAL_PROBE_PROLOGUE_EDGES", DUAL_PROBE_PROLOGUE_EDGES),
        ("DUAL_PROBE_ITERATION_EDGES", DUAL_PROBE_ITERATION_EDGES),
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


def _dual_layout(bp: int, rows_cap: int, stage: int = 0) -> tuple[int, ...]:
    """csrc/gram.cu dual_layout: byte offsets of the mask, u, y, α, G·α, the
    reduction scratch, the decisions' staging (``stage`` float4s) and the
    resident rows of G, for [bp]-float vectors of the batch and
    [rows_cap]-float vectors of a CTA's rows."""
    vec = _align16(4 * bp)
    own = _align16(4 * rows_cap)
    mask, u = vec, 2 * vec
    y = u + own
    a = y + own  # α [2][rows_cap] by the parity of the update that made it
    s = a + 2 * own  # G·α [2][rows_cap]
    red = s + 2 * own
    staged = red + DUAL_RED_FLOATS * 4
    return (mask, u, y, a, s, red, staged, staged + 16 * stage)


def tenant_padded_rows(valid: int) -> int:
    """A tenant's block of C (and of its G) in the tenant forms on the card:
    ``padded_rows`` of its valid rows, none for a dry tenant."""
    return padded_rows(valid) if valid > 0 else 0


class CountTenantsPlan(NamedTuple):
    """B4's tenant form over some tenants of a stack (their valid rows
    ``valid_rows``): tenant i's block of C starts at row ``at[i]`` and has
    ``tenant_padded_rows`` rows, ``rows`` in all. The row table's
    ``entries`` are (position in ``tenants``, first row in the tenant's
    part, rows, first row of C), one a segment of a tenant's rows (one a
    tenant unless the caller gives segments), each owning C's rows up to
    the next entry's first; ``launches`` are (first, end) positions in
    ``entries``, at most TENANTS_PER_LAUNCH a launch, a CTA a row of their
    blocks (a launch that owns no row is left out); ``shared_bytes`` a
    CTA's (``count_layout``)."""

    valid_rows: tuple
    at: tuple
    rows: int
    launches: tuple
    shared_bytes: int
    entries: tuple


def _tenant_runs(tenants, valid, segments) -> list:
    """Each tenant's (first row, rows) runs: its first v rows, or its
    ``segments``, checked to sum to its valid rows v."""
    runs = [((0, v),) if segments is None else tuple((int(a), int(n)) for a, n in segments[t])
            for t, v in zip(tenants, valid)]
    if any(sum(n for _, n in r) != v or any(a < 0 or n < 0 for a, n in r)
           for r, v in zip(runs, valid)):
        raise ValueError(f"count_build_tenants: segments {runs} do not sum to the valid rows "
                         f"{list(valid)}")
    return runs


def count_tenants_plan(valid_rows, tenants, tokens: int, *, shared_limit: int,
                       segments=None) -> CountTenantsPlan:
    """B4's tenant form for the tenants ``tenants`` (indices into the
    stack's ``valid_rows``) at L = ``tokens``. ``segments`` (indexed like
    ``valid_rows``; default: each tenant's first ``valid_rows[t]`` rows)
    gives each tenant's rows as (first row in its part, rows) runs in
    order, which sum to its valid rows: a data axis's gathered part holds
    every rank's rows, and a tenant's block its valid rows of each rank."""
    tenants = tuple(int(t) for t in tenants)
    valid = tuple(int(valid_rows[t]) for t in tenants)
    if not tenants or min(valid) < 0:
        raise ValueError(f"count_build_tenants takes 1 or more tenants with 0 or more rows, "
                         f"got {valid}")
    runs = _tenant_runs(tenants, valid, segments)
    at, rows, entries = [], 0, []
    for i, (v, r) in enumerate(zip(valid, runs)):
        at.append(rows)
        first = rows
        for a, n in r:
            entries.append((i, a, n, first))
            first += n
        rows += tenant_padded_rows(v)
    ends = [e[3] for e in entries[1:]] + [rows]
    launches = tuple(
        (lo, min(len(entries), lo + TENANTS_PER_LAUNCH))
        for lo in range(0, len(entries), TENANTS_PER_LAUNCH)
        if ends[min(len(entries), lo + TENANTS_PER_LAUNCH) - 1] > entries[lo][3])
    return CountTenantsPlan(valid_rows=valid, at=tuple(at), rows=rows, launches=launches,
                            shared_bytes=count_shared_bytes(tokens, shared_limit=shared_limit),
                            entries=tuple(entries))


class DualTenantsPlan(NamedTuple):
    """How one launch of B7's tenant form lays M tenants' G over the card:
    CTAs [first_cta[t], first_cta[t + 1]) run tenant t's loop, CTA k of
    them its rows ``cta_rows(t, k)``. With ``in_registers`` every CTA's rows
    (at most ``DUAL_ROWS``) live in registers, ``DUAL_REG_COLUMNS`` float4
    columns of each a thread; else the first ``resident[t]`` of a CTA's rows
    live in shared memory (``bp`` floats a row: the tenant's rows rounded up
    to 4), the rest in the spill buffer from float ``spill_at[t]`` on, a
    CTA's rows_cap − resident after the one before's. Its α at float
    ``abuf_at[t]`` of each half of α's double buffer. One layout
    (``smem_layout``, ``dual_layout`` at ``bp_max`` and ``rows_cap_max``,
    with a staging of ``grid`` float4s for the decisions where more than one
    tenant has rows) for every CTA."""

    valid_rows: tuple
    first_cta: tuple
    rows_cap: tuple
    resident: tuple
    spill_at: tuple
    abuf_at: tuple
    bp_max: int
    rows_cap_max: int
    shared_bytes: int
    smem_layout: tuple
    abuf_floats: int
    spill_floats: int
    in_registers: bool

    @property
    def grid(self) -> int:
        return self.first_cta[-1]

    def cta_rows(self, tenant: int, k: int) -> range:
        v = self.valid_rows[tenant]
        ctas = self.first_cta[tenant + 1] - self.first_cta[tenant]
        return range(k * v // ctas, (k + 1) * v // ctas)

    @property
    def resident_rows(self) -> int:
        """Rows of G kept on chip (registers or shared memory), every tenant's."""
        return sum(min(len(self.cta_rows(t, k)), self.resident[t])
                   for t in range(len(self.valid_rows))
                   for k in range(self.first_cta[t + 1] - self.first_cta[t]))

    @property
    def spill_rows(self) -> int:
        return sum(self.valid_rows) - self.resident_rows

    @property
    def scratch_floats(self) -> int:
        """α's double buffer, then each CTA's test partials and its tenant's
        (tested, c_new, c_old, p), double-buffered by parity: [2, grid, 8]."""
        return 2 * self.abuf_floats + 16 * self.grid


def in_registers(rows_cap: int, bp: int) -> bool:
    """Whether a CTA's rows of G fit in registers: at most DUAL_ROWS rows of
    at most 4·DUAL_THREADS·DUAL_REG_COLUMNS columns (B = 2048 over an
    H100's 132 CTAs)."""
    return rows_cap <= DUAL_ROWS and bp <= 4 * DUAL_THREADS * DUAL_REG_COLUMNS


def dual_tenants_plan(valid_rows, *, sm_count: int, shared_limit: int) -> DualTenantsPlan:
    """One launch of B7's tenant form for tenants of ``valid_rows`` rows
    each (B7 itself: one tenant of B rows): at most min(``sm_count``,
    DUAL_MAX_GRID) CTAs, one an SM (a cooperative launch), no more for a
    tenant than give each warp a row; every tenant with a row gets a CTA, a
    dry one none (all dry: tenant 0 gets one, which writes the results);
    each tenant's share in proportion to its rows of G, v² (rounded down),
    the CTAs left one at a time to the tenant whose CTAs hold the most of G
    each (first of equals). G lives in registers when every tenant's CTAs
    hold at most DUAL_ROWS rows of at most 4·DUAL_THREADS·DUAL_REG_COLUMNS
    columns (``in_registers``; config #4's 4 parts of ~515 rows, 16 rows a
    CTA, and B7's B = 2048); else shared memory holds the vectors at the
    widest tenant's width and as many rows of G as fit, up to
    ``shared_limit`` (232,448 B on an H100), the rest spilled to L2. The
    kernel crosses one grid barrier an iteration (none after the last
    update unless a test is pending, as B7), so every CTA of the launch must
    be resident at once. At most TENANTS_PER_LAUNCH tenants, and no more
    with rows than CTAs."""
    return _dual_tenants_plan(tuple(int(v) for v in valid_rows), sm_count, shared_limit)


@functools.lru_cache(maxsize=256)
def _dual_tenants_plan(valid: tuple, sm_count: int, shared_limit: int) -> DualTenantsPlan:
    if not 1 <= len(valid) <= TENANTS_PER_LAUNCH or min(valid) < 0:
        raise ValueError(f"a B7 tenant launch takes 1..{TENANTS_PER_LAUNCH} tenants with 0 or "
                         f"more rows each, got {valid}")
    most = min(sm_count, DUAL_MAX_GRID)
    live = [t for t, v in enumerate(valid) if v]
    if len(live) > most:
        raise ValueError(f"{len(live)} tenants with rows need a CTA each; a launch has {most}")
    want = [-(-v // DUAL_WARPS) for v in valid]
    budget = min(most, sum(want))
    area = sum(v * v for v in valid)
    ctas = [1 if v else 0 for v in valid]
    if area:
        share = [min(w, max(1, budget * v * v // area)) if v else 0 for v, w in zip(valid, want)]
        if sum(share) <= budget:
            ctas = share
        for _ in range(budget - sum(ctas)):
            t = max((t for t in live if ctas[t] < want[t]),
                    key=lambda t: (-(-valid[t] // ctas[t]) * valid[t], -t))
            ctas[t] += 1
    else:
        ctas[0] = 1
    first = [0]
    for k in ctas:
        first.append(first[-1] + k)
    bp = [-(-v // 4) * 4 for v in valid]
    rows_cap = [-(-v // k) if v else 0 for v, k in zip(valid, ctas)]
    bp_max, rows_cap_max = max(4, max(bp)), max(1, max(rows_cap))
    # more than one tenant with rows: every CTA's test partials staged for the decisions
    layout = _dual_layout(bp_max, rows_cap_max, first[-1] if len(live) > 1 else 0)
    g = layout[-1]
    if g > shared_limit:
        raise ValueError(f"tenants of {max(valid)} rows need {g} B of shared memory before any "
                         f"row of G; the limit is {shared_limit} B")
    regs = bool(live) and all(in_registers(rows_cap[t], bp[t]) for t in live)
    if regs:
        shared, resident = g, list(rows_cap)
    else:
        shared = min(shared_limit, max(g + rc * 4 * b for rc, b in zip(rows_cap, bp)))
        resident = [min(rc, (shared - g) // (4 * b)) if b else 0 for rc, b in zip(rows_cap, bp)]
    spill_at, abuf_at, spill, abuf = [], [], 0, 0
    for k, rc, res, b in zip(ctas, rows_cap, resident, bp):
        spill_at.append(spill)
        abuf_at.append(abuf)
        spill += k * (rc - res) * b
        abuf += b
    return DualTenantsPlan(
        valid_rows=valid, first_cta=tuple(first), rows_cap=tuple(rows_cap),
        resident=tuple(resident), spill_at=tuple(spill_at), abuf_at=tuple(abuf_at),
        bp_max=bp_max, rows_cap_max=rows_cap_max, shared_bytes=shared, smem_layout=layout,
        abuf_floats=max(4, abuf), spill_floats=spill, in_registers=regs)


def dual_tenants_barriers(valid_rows, iterations, *, num_iterations: int,
                          convergence_tol: float, selects: str = "all"):
    """The grid barriers one launch of B7's tenant form crosses, from each
    tenant's iterations run. One tenant with rows (B7): one an update, less
    the last update's when no test is pending (tolerance 0), plus one that
    carries the test that stopped the loop early; ``selects`` says whether
    every iteration's draws select a row of it ("all"), some do not
    ("some": None, not counted) or none does ("none": 0). More tenants with
    rows: one an iteration, the last's only to decide the pending tests
    (tolerance > 0); the launch ends at the top of the iteration after the
    barrier that decided the last tenant's freeze. No tenant with rows: 0."""
    live = [t for t, v in enumerate(valid_rows) if v]
    n, test = int(num_iterations), convergence_tol > 0
    if not live or n == 0:
        return 0
    if len(live) == 1:
        if selects != "all":
            return 0 if selects == "none" else None
        return min(int(iterations[live[0]]) + 1, n) if test else n - 1
    if not test:
        return n - 1
    stops = [int(iterations[t]) for t in live]
    return min(max(stops) + 1, n) if max(stops) < n else n


class WritebackPlan(NamedTuple):
    """One launch of B8 over some tenants' rows (a single batch: one
    tenant), at L tokens a row and F columns: tenant i's occurrences
    (its v rows' L tokens in (row, j) order) are its tiles [first_tile[i],
    first_tile[i + 1]) of the launch's, WRITEBACK_TILE occurrences each (a
    tenant's last one shorter); ``buckets`` = ceil(F / WRITEBACK_COLUMNS)
    (bucket b: the 32 lines of 8 columns b, b + buckets, ...). The scratch
    holds every tile's runs (a column's slot and a sum, WRITEBACK_TILE of
    each) and the bucket table [tiles, buckets + 1]: ``scratch_ints``
    4-byte words. The bucket pass's items are each
    tenant's buckets and its numeric columns."""

    first_tile: tuple
    buckets: int
    scratch_ints: int

    @property
    def tiles(self) -> int:
        return self.first_tile[-1]

    @property
    def items(self) -> int:
        return (len(self.first_tile) - 1) * (self.buckets + 1)

    def grid(self, sm_count: int, ctas_per_sm: int) -> int:
        """The cooperative launch's CTAs: one a tile or item, at most
        ``ctas_per_sm`` an SM (every CTA resident at once)."""
        return max(1, min(sm_count * ctas_per_sm, max(self.tiles, self.items)))


def writeback_plan(valid_rows, tokens: int, f_text: int) -> WritebackPlan:
    """B8's launch over tenants of ``valid_rows`` rows each (csrc/gram.cu
    twtml_dual_writeback computes the same tiles and checks the scratch)."""
    first = [0]
    for v in valid_rows:
        first.append(first[-1] + -(-int(v) * tokens // WRITEBACK_TILE))
    buckets = -(-f_text // WRITEBACK_COLUMNS)
    tiles = first[-1]
    return WritebackPlan(first_tile=tuple(first), buckets=buckets,
                         scratch_ints=2 * tiles * WRITEBACK_TILE + (buckets + 1) * tiles)


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


def _counts_product(left, counts):
    """left·Cᵀ: on the card ``torch._int_mm`` for int8 counts (s32) or an
    f32 matmul (TF32 off); on the CPU a float64 product (exact for the
    planes' integer counts) cast to f32."""
    if counts.device.type == "cuda":
        if counts.dtype == torch.int8:
            return torch._int_mm(left, counts.t())
        return left @ counts.t()
    return (left.double() @ counts.double().T).float()


def gram_from_counts(counts, rows: "tuple[int, int] | None" = None):
    """G = C·Cᵀ ([rows, rows] f32) from the count build's padded C, or with
    ``rows`` = (start, n) the row panel C[start:start + n]·Cᵀ ([n, rows]: a
    data-parallel rank's share): on the card ``torch._int_mm`` for int8
    counts (|G| < 2^24: the f32 cast is exact), an f32 matmul (TF32 off)
    for f32 counts; on the CPU a float64 product (exact for the planes'
    integer counts) cast to f32."""
    left = counts if rows is None else counts[rows[0]:rows[0] + rows[1]]
    return _counts_product(left, counts).float()


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


def dual_writeback_reference(weights, c, alpha, token_idx, token_val, numeric, f_text: int):
    """B8's plain version: the scatter write-back of ``ops/gram.py``
    ``dual_writeback`` (W_new = c·W_prev + Zᵀα, each occurrence's val·α
    added on its own, and w_num·c + Nᵀα) over the [B, L] tokens whose index
    lies in [0, f_text): the others count nothing, as in the kernel."""
    keep = (token_idx >= 0) & (token_idx < f_text)
    contrib = (token_val.float() * alpha[:, None])[keep]
    text = (weights[:f_text] * c).index_add_(0, token_idx[keep].long(), contrib)
    num = weights[f_text:] * c + numeric.float().T @ alpha
    return torch.cat([text, num])


def _runs_pairwise(keys, vals):
    """Each run of equal ``keys`` (sorted) summed pairwise over its ``vals``
    (f32, in order), as B8's tile pass sums a column's run: position r of a
    run adds r + d for r = 0, 2d, 4d, ... and d = 1, 2, 4, ... Returns (the
    runs' keys, their sums)."""
    n = keys.numel()
    if n == 0:
        return keys, vals
    starts = torch.nonzero(torch.cat([torch.ones(1, dtype=torch.bool),
                                      keys[1:] != keys[:-1]])).flatten()
    lengths = torch.diff(torch.cat([starts, torch.tensor([n])]))
    r = torch.arange(n) - torch.repeat_interleave(starts, lengths)
    length = torch.repeat_interleave(lengths, lengths)
    sums = vals.clone()
    d = 1
    while d < int(lengths.max()):
        i = torch.nonzero(((r & (2 * d - 1)) == 0) & (r + d < length)).flatten()
        sums[i] = sums[i] + sums[i + d]
        d *= 2
    return keys[starts], sums[starts]


def dual_writeback_in_order(weights, c, alpha, token_idx, token_val, numeric, f_text: int):
    """B8's result with its text columns summed in the kernel's own order,
    on the host: each column's contributions val·α (f32) summed pairwise
    within each WRITEBACK_TILE occurrences of the [B, L] tokens in (row, j)
    order, those tile sums pairwise in tile order (the bucket pass's running
    sum forms the same tree), then c·W_prev + that sum (exactly c·W_prev
    where no token lands; an index outside [0, f_text) counts nothing). The
    numeric columns are w_num·c + Nᵀα in torch's order, not the kernel's.
    chip_smoke.py holds the kernel's text columns bitwise against it;
    tests/test_torch_writeback_form.py holds it against a step-by-step
    numpy model of the kernel. Returns a tensor on ``weights``' device."""
    w, c, a, idx, val, num = (t.detach().cpu() for t in
                              (weights, c, alpha, token_idx, token_val, numeric))
    f = idx.reshape(-1).long()
    contrib = (val.float() * a[:, None]).reshape(-1)
    keep = (f >= 0) & (f < f_text)
    tile = torch.arange(f.numel()) // WRITEBACK_TILE
    key = (tile * f_text + f)[keep]  # positions ascending: a stable sort keeps them so
    order = torch.sort(key, stable=True).indices
    tile_keys, tile_sums = _runs_pairwise(key[order], contrib[keep][order])
    cols = tile_keys % f_text  # in (tile, column) order: a stable sort by column keeps tile order
    order = torch.sort(cols, stable=True).indices
    col_keys, col_sums = _runs_pairwise(cols[order], tile_sums[order])
    text = w[:f_text] * c
    text[col_keys] = text[col_keys] + col_sums
    return torch.cat([text, w[f_text:] * c + num.float().T @ a]).to(weights.device)


def _segment_rows(t, m: int, v: int, segments):
    """Tenant m's rows of the [M, B, ...] ``t``: its first ``v``, or its
    ``segments[m]`` runs in order."""
    if segments is None:
        return t[m, :v]
    return torch.cat([t[m, a:a + n] for a, n in segments[m]])


def count_build_tenants_reference(token_idx, token_val, f_text: int, *, valid_rows, int8: bool,
                                  tenants=None, cols_out: "int | None" = None, segments=None):
    """B4's tenant form's plain version: for each tenant m of ``tenants``
    (default every part of the [M, B, L] tokens) B4's twin on its first
    ``valid_rows[m]`` rows (or its ``segments[m]`` runs of rows, in order),
    at ``tenant_padded_rows`` rows and ``cols_out`` columns (default
    ``f_text``), stacked. Returns (C, each tenant's first row of C)."""
    tenants = range(token_idx.shape[0]) if tenants is None else tenants
    cols = f_text if cols_out is None else cols_out
    blocks, at, rows = [], [], 0
    for m in tenants:
        v = int(valid_rows[m])
        at.append(rows)
        rows += tenant_padded_rows(v)
        if v:
            blocks.append(count_build_reference(
                _segment_rows(token_idx, m, v, segments), _segment_rows(token_val, m, v, segments),
                f_text, int8=int8, rows_out=tenant_padded_rows(v), cols_out=cols))
    dtype = torch.int8 if int8 else torch.float32
    counts = (torch.cat(blocks) if blocks
              else torch.zeros((0, cols), dtype=dtype, device=token_idx.device))
    return counts, tuple(at)


def dual_sgd_tenants_reference(gs, u, labels, mask, numeric, *, valid_rows, masks=None, p_prev,
                               num_iterations: int, step_sizes, l2_regs,
                               convergence_tol: float = 0.001,
                               residual_fn=least_squares_residual):
    """B7's tenant form's plain version: for each tenant m with rows, B7's
    twin on its first v = ``valid_rows[m]`` rows, G the text G ``gs[m]``
    plus N·Nᵀ of its rows (``add_numeric_block``), its own step size, L2
    and p_prev, every tenant on the same [N, B] ``masks`` sliced to its
    rows; a dry tenant c = 1, α = 0, N iterations. Returns (c [M], α [M, B]
    (zero past each tenant's rows), iterations run [M]), all float32.
    ``masks`` [N, M, B] gives each tenant its own draws."""
    m_all, b = mask.shape
    c = torch.ones((m_all,), dtype=torch.float32, device=mask.device)
    its = torch.full((m_all,), float(num_iterations), dtype=torch.float32, device=mask.device)
    alpha = torch.zeros((m_all, b), dtype=torch.float32, device=mask.device)
    for m in range(m_all):
        v = int(valid_rows[m])
        if not v:
            continue
        g = add_numeric_block(gs[m][:v, :v].float(), numeric[m, :v])
        c[m], alpha[m, :v], its[m] = dual_sgd_reference(
            g, u[m, :v], labels[m, :v], mask[m, :v],
            masks=_tenant_draws(masks, m, v), p_prev=p_prev[m],
            num_iterations=num_iterations, step_size=step_sizes[m], l2_reg=l2_regs[m],
            convergence_tol=convergence_tol, residual_fn=residual_fn)
    return c, alpha, its


def _tenant_draws(masks, m: int, v: int):
    """Tenant m's [N, v] draws: of the [N, B] every tenant shares, or of its
    own row of [N, M, B]."""
    if masks is None:
        return None
    return (masks[:, m] if masks.dim() == 3 else masks)[:, :v]


def dual_writeback_tenants_reference(weights, c, alpha, token_idx, token_val, numeric,
                                     f_text: int, *, valid_rows, tenants=None, out=None,
                                     first_rows=None, token_rows=None):
    """B8's tenant form's plain version: for each tenant m of ``tenants``
    (default every part), B8's plain version on its ``valid_rows[m]`` rows:
    α and numeric rows from row ``first_rows[i]`` of its part (default 0),
    tokens from row ``token_rows[i]`` of its part of the [M, B', L] tokens
    (default ``first_rows[i]``), into row m of ``out`` (default zeros like
    ``weights``)."""
    tenants = range(alpha.shape[0]) if tenants is None else tenants
    out = torch.zeros_like(weights) if out is None else out
    first_rows = (0,) * len(tenants) if first_rows is None else first_rows
    token_rows = first_rows if token_rows is None else token_rows
    for m, r0, k0 in zip(tenants, first_rows, token_rows):
        v = int(valid_rows[m])
        out[m] = dual_writeback_reference(weights[m], c[m], alpha[m, r0:r0 + v],
                                          token_idx[m, k0:k0 + v], token_val[m, k0:k0 + v],
                                          numeric[m, r0:r0 + v], f_text)
    return out


def tenant_gram_blocks(counts, at, valid_rows, rows=None):
    """Each tenant's text G from its block of the tenant count build's C
    (from row ``at[i]``, ``valid_rows[i]`` rows): the padded block's C·Cᵀ,
    [p, p] for p = ``tenant_padded_rows``, one library product a tenant
    with rows (None for a dry one; the JAX package leaves the product to
    XLA outside any kernel), as ``gram_from_counts`` but left s32 for int8
    counts on the card (B7's tenant form reads it as f32, exactly). With
    ``rows`` = each tenant's (start, n), the row panel of its block
    C[start:start + n]·Cᵀ, [n, p] (a data-parallel rank's share, as
    ``gram_from_counts(rows=)``; None where n or the block is 0): on the
    card the int8 product's left operand is a window of more than 16 rows
    inside the block (``torch._int_mm``'s rule), its extra rows dropped.
    Counted in ``tenant_gram_blocks.products``."""
    out = []
    for i, (first, v) in enumerate(zip(at, valid_rows)):
        start, n = (0, None) if rows is None else (int(rows[i][0]), int(rows[i][1]))
        if not v or n == 0:
            out.append(None)
            continue
        block = counts[first:first + tenant_padded_rows(v)]
        tenant_gram_blocks.products += 1
        if n is None:
            out.append(_counts_product(block, block))
            continue
        if start < 0 or start + n > v:
            raise ValueError(f"tenant_gram_blocks: rows {rows[i]} outside the block's {v}")
        h = max(n, 17) if block.is_cuda and block.dtype == torch.int8 else n
        lo = min(start, block.shape[0] - h)  # a block has 24 rows or more
        out.append(_counts_product(block[lo:lo + h], block)[start - lo:start - lo + n])
    return out


tenant_gram_blocks.products = 0


# ---------------------------------------------------------------- the kernels

# the C entries of csrc/gram.cu: name -> argument types
_ENTRIES = {
    "twtml_dual_barrier_probe": [ctypes.c_int] * 2 + [ctypes.c_void_p],  # grid, crossings
    "twtml_count_build": (
        [ctypes.c_void_p] * 3  # idx, val, out
        + [ctypes.c_int] * 6  # tenants, tokens, features, cols, kind, shared_bytes
        + [ctypes.POINTER(ctypes.c_int)] * 3  # src_row, valid, out_row
        + [ctypes.c_void_p]  # stream
    ),
    "twtml_dual_sgd_tenants": (
        [ctypes.c_void_p] * 5  # u, y, mask, numeric, masks
        + [ctypes.c_int]  # masks_tenants
        + [ctypes.c_void_p] * 8  # p_prev, alpha_out, c_out, iterations, barriers, abuf,
        #                          partials, spill
        + [ctypes.c_longlong]  # abuf_floats
        + [ctypes.c_int] * 7  # tenants, batch_rows, grid, bp_max, rows_cap_max, shared_bytes,
        #                       in_registers
        + [ctypes.POINTER(ctypes.c_int)] * 6  # plan_layout, first_cta, valid, slot, rows_cap,
        #                                      resident
        + [ctypes.POINTER(ctypes.c_longlong)] * 2  # spill_at, abuf_at
        + [ctypes.POINTER(ctypes.c_void_p)]  # g
        + [ctypes.POINTER(ctypes.c_longlong)]  # ldg
        + [ctypes.POINTER(ctypes.c_int)]  # g_int32
        + [ctypes.POINTER(ctypes.c_float)] * 2  # step_sizes, l2_regs
        + [ctypes.c_int, ctypes.c_float, ctypes.c_int]  # iterations, tol, residual_mode
        + [ctypes.c_void_p, ctypes.c_int]  # the timing probe's buffer (or null), its edges
        + [ctypes.c_void_p]  # stream
    ),
    "twtml_dual_writeback": (
        [ctypes.c_void_p] * 2  # idx, val
        + [ctypes.c_int] * 2  # tokens, features
        + [ctypes.c_void_p] * 6  # alpha, c, w_prev, numeric, w_out, scratch
        + [ctypes.c_longlong]  # scratch_ints
        + [ctypes.c_int] * 2  # grid, tenants
        + [ctypes.POINTER(ctypes.c_int)] * 4  # slot, token_row, valid, src_row
        + [ctypes.c_void_p]  # stream
    ),
    "twtml_writeback_blocks_per_sm": [ctypes.POINTER(ctypes.c_int)],
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


def _ints(values, kind=ctypes.c_int):
    values = list(values)
    return (kind * max(len(values), 1))(*values)


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
        # the batch as the row table's one tenant
        _raise_on(_entry("twtml_count_build")(
            token_idx.data_ptr(), token_val.data_ptr(), out.data_ptr(), 1, l, f_text, cols_out,
            COUNT_KINDS[dtype], shared, _ints([0]), _ints([b]), _ints([0, rows_out]),
            _stream()), "count_build")
        _count(count_build)
    return out


def dual_sgd(g, u, labels, mask, *, masks=None, p_prev, num_iterations: int,
             step_size: float, l2_reg: float = 0.0, convergence_tol: float = 0.001,
             residual_fn=least_squares_residual):
    """B7: MLlib's loop on the dual state from G ([≥B, ≥B] f32, row stride
    ≥ B: the first B rows and columns are read, N·Nᵀ included), u =
    Z·W_prev, labels and the validity mask [B] f32, the [N, B] Bernoulli
    masks (None: every valid row each iteration) and p_prev = ||W_prev||² (a
    [] f32 tensor). Rows with mask <= 0 are ignored, whatever their u, y and
    G hold. Returns (c [] f32, α [B] f32, iterations run: the iteration that
    converged, else N; a [] tensor, read it only when a sync is fine).
    ``dual_sgd.last_barriers`` is then the [] slot beside them that
    receives the grid barriers the launch crossed, None after a CPU call.
    On the card one cooperative launch of B7's tenant form over a table of
    one tenant (``dual_tenants_kernel``, G read whole: no numeric block),
    counted in ``dual_sgd.launches``; its scratch's last three floats are c,
    the iterations run and the barriers crossed."""
    mode = residual_mode(residual_fn)
    if mode is None:
        raise ValueError(f"dual_sgd has no residual mode for {residual_fn!r}")
    dev = g.device
    kw = dict(masks=masks, p_prev=p_prev, num_iterations=num_iterations,
              step_size=step_size, l2_reg=l2_reg, convergence_tol=convergence_tol)
    if dev.type == "cpu":
        dual_sgd.last_barriers = None
        return dual_sgd_reference(g, u, labels, mask, residual_fn=residual_fn, **kw)
    if dev.type != "cuda":
        raise ValueError(f"dual_sgd takes cpu or cuda tensors, got {dev}")
    b = mask.shape[0]
    if b < 1:
        raise ValueError("the dual loop needs at least one row")
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
        plan = dual_tenants_plan((b,), sm_count=sm_count, shared_limit=shared_limit)
        alpha = torch.empty((1, b), dtype=torch.float32, device=dev)
        scratch = torch.empty((plan.scratch_floats + 3,), dtype=torch.float32, device=dev)
        # the batch as the tenant table's one tenant
        _launch_dual(plan, gs=(g,), slots=(0,), u=u, labels=labels, mask=mask, numeric=None,
                     masks=masks, p_prev=p_prev, alpha=alpha, c_out=scratch[-3],
                     iterations=scratch[-2], scratch=scratch, batch_rows=b,
                     num_iterations=num_iterations, step_sizes=(step_size,),
                     l2_regs=(l2_reg,), convergence_tol=convergence_tol, mode=mode, probe=None,
                     what="dual_sgd")
        _count(dual_sgd)
    dual_sgd.last_barriers = scratch[-1]
    return scratch[-3], alpha[0], scratch[-2]


dual_sgd.last_barriers = None


def dual_barrier_probe(grid: int, crossings: int) -> None:
    """``crossings`` of B7's grid barrier on ``grid`` CTAs of its block size,
    nothing else, on the current CUDA device and stream: what chip_smoke.py
    times one crossing by. Not a kernel of the route (no count)."""
    _raise_on(_entry("twtml_dual_barrier_probe")(grid, crossings, _stream()),
              "dual_barrier_probe")


@functools.cache
def writeback_ctas_per_sm(index: int) -> int:
    """B8's CTAs an SM on CUDA device ``index``: its occupancy at its block
    size, at most WRITEBACK_CTAS_PER_SM."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        _raise_on(_entry("twtml_writeback_blocks_per_sm")(ctypes.byref(blocks)),
                  "B8's occupancy")
    return max(1, min(blocks.value, WRITEBACK_CTAS_PER_SM))


def _check_writeback(weights, c, alpha, token_idx, token_val, numeric, f_text, lead):
    """B8's arguments on the card: ``lead`` is () for a single batch, (M,)
    for a tenant stack."""
    dev = weights.device
    l = token_idx.shape[-1]
    b = alpha.shape[-1]
    _check("weights", weights, (*lead, f_text + 4), torch.float32, dev)
    _check("c", c, lead, torch.float32, dev)
    _check("alpha", alpha, (*lead, b), torch.float32, dev)
    _check("numeric", numeric, (*lead, b, 4), torch.float32, dev)
    _check("token_idx", token_idx, (*lead, token_idx.shape[-2], l), torch.int32, dev)
    _check("token_val", token_val, tuple(token_idx.shape), torch.float32, dev)
    if l < 1:
        raise ValueError("dual_writeback: rows of L >= 1 tokens")


def _launch_writeback(weights, c, alpha, token_idx, token_val, numeric, w_out, f_text, *,
                      slots, token_rows, valid, src_rows, what):
    """One cooperative launch of ``writeback_kernel`` over the tenants
    ``slots`` (at most TENANTS_PER_LAUNCH; rows as twtml_dual_writeback
    takes them) on the current device and stream."""
    if w_out.data_ptr() == weights.data_ptr():
        raise ValueError(f"{what}: the output must not be the weights it reads")
    l = token_idx.shape[-1]
    sm_count, _ = device_limits(torch.cuda.current_device())
    plan = writeback_plan(valid, l, f_text)
    scratch = torch.empty((max(plan.scratch_ints, 1),), dtype=torch.int32, device=w_out.device)
    _raise_on(_entry("twtml_dual_writeback")(
        token_idx.data_ptr(), token_val.data_ptr(), l, f_text, alpha.data_ptr(), c.data_ptr(),
        weights.data_ptr(), numeric.data_ptr(), w_out.data_ptr(), scratch.data_ptr(),
        scratch.numel(), plan.grid(sm_count, writeback_ctas_per_sm(torch.cuda.current_device())),
        len(slots), _ints(slots), _ints(token_rows), _ints(valid), _ints(src_rows), _stream()),
        what)


def dual_writeback_counts(weights, c, alpha, token_idx, token_val, numeric, f_text: int):
    """B8: W_new [F+4] = c·W_prev + Zᵀα from the batch's tokens (``token_idx``
    int32 and ``token_val`` f32 [B, L], as B4 takes them; an index outside
    [0, f_text) counts nothing) and w_num·c + Nᵀα over the numeric ones,
    each column summed in a fixed tree. ``c`` is a [] f32 tensor, ``alpha``
    [B], ``numeric`` [B, 4]. On the card one cooperative launch of
    ``writeback_kernel`` (the batch as its tenant table's one tenant),
    counted in ``dual_writeback_counts.launches``; on the CPU the plain
    version. (The name is the route's counter's: B8 read the count build's
    C before it read the tokens.)"""
    dev = weights.device
    if dev.type == "cpu":
        return dual_writeback_reference(weights, c, alpha, token_idx, token_val, numeric, f_text)
    if dev.type != "cuda":
        raise ValueError(f"dual_writeback_counts takes cpu or cuda tensors, got {dev}")
    if token_idx.dim() != 2 or token_idx.shape[0] != alpha.shape[0]:
        raise ValueError(f"token_idx must be [B, L] for alpha [{alpha.shape[0]}], got "
                         f"{tuple(token_idx.shape)}")
    _check_writeback(weights, c, alpha, token_idx, token_val, numeric, f_text, ())
    with torch.cuda.device(dev):
        w_out = torch.empty_like(weights)
        _launch_writeback(weights, c, alpha, token_idx, token_val, numeric, w_out, f_text,
                          slots=(0,), token_rows=(0,), valid=(alpha.shape[0],), src_rows=(0,),
                          what="dual_writeback_counts")
        _count(dual_writeback_counts)
    return w_out


def _check_tenant_rows(name, valid_rows, m, b):
    if len(valid_rows) != m or any(not 0 <= int(v) <= b for v in valid_rows):
        raise ValueError(f"{name}: {m} parts of {b} rows need {m} valid row counts in "
                         f"[0, {b}], got {list(valid_rows)}")


def count_build_tenants(token_idx, token_val, f_text: int, *, valid_rows, int8: bool,
                        tenants=None, segments=None):
    """B4's tenant form: [M, B, L] int32 indices and f32 values (M parts of
    B rows), each part's valid rows (``valid_rows``, host ints: its rows up
    to its last valid one) -> (C, at): one counts buffer (int8 when
    ``int8``, else f32) holding, for each tenant of ``tenants`` (default
    every part) in order, its block from row ``at[i]``: its first v rows'
    counts, bitwise B4's on those rows, then zeros to ``tenant_padded_rows``
    (v). On the card C's columns are ``padded_columns(f_text)``: one launch
    of B4's ``count_build_kernel`` for each TENANTS_PER_LAUNCH tenants
    (``count_tenants_plan``; none for a launch of dry tenants alone),
    counted in ``count_build_tenants.launches``; on the CPU the plain
    version, at ``f_text`` columns. ``segments`` (``count_tenants_plan``'s)
    makes a tenant's block its runs of rows in order: a data axis's
    gathered parts, each tenant's valid rows of every rank, the ranks'
    padding skipped."""
    dev = token_idx.device
    if token_idx.dim() != 3:
        raise ValueError(f"token_idx must be [M, B, L], got {tuple(token_idx.shape)}")
    m, b, l = token_idx.shape
    _check_tenant_rows("count_build_tenants", valid_rows, m, b)
    tenants = tuple(range(m)) if tenants is None else tuple(int(t) for t in tenants)
    if not tenants or any(not 0 <= t < m for t in tenants):
        raise ValueError(f"count_build_tenants: tenants {tenants} outside [0, {m})")
    if segments is not None and any(a + n > b for t in tenants for a, n in segments[t]):
        raise ValueError(f"count_build_tenants: segments past a part's {b} rows")
    if dev.type == "cpu":
        _tenant_runs(tenants, [int(valid_rows[t]) for t in tenants], segments)
        return count_build_tenants_reference(token_idx, token_val, f_text,
                                             valid_rows=valid_rows, int8=int8, tenants=tenants,
                                             segments=segments)
    if dev.type != "cuda":
        raise ValueError(f"count_build_tenants takes cpu or cuda tensors, got {dev}")
    _check("token_idx", token_idx, (m, b, l), torch.int32, dev)
    _check("token_val", token_val, (m, b, l), torch.float32, dev)
    if l < 1:
        raise ValueError("count_build_tenants: rows of L >= 1 tokens")
    cols = padded_columns(f_text)
    dtype = torch.int8 if int8 else torch.float32
    with torch.cuda.device(dev):
        _, shared_limit = device_limits(torch.cuda.current_device())
        plan = count_tenants_plan(valid_rows, tenants, l, shared_limit=shared_limit,
                                  segments=segments)
        out = torch.empty((plan.rows, cols), dtype=dtype, device=dev)
        ents = plan.entries
        for lo, hi in plan.launches:
            first = ents[lo][3]
            rel = [e[3] - first for e in ents[lo:hi]] + [
                (ents[hi][3] if hi < len(ents) else plan.rows) - first]
            _raise_on(_entry("twtml_count_build")(
                token_idx.data_ptr(), token_val.data_ptr(), out[first].data_ptr(), hi - lo, l,
                f_text, cols, COUNT_KINDS[dtype], plan.shared_bytes,
                _ints(tenants[e[0]] * b + e[1] for e in ents[lo:hi]),
                _ints(e[2] for e in ents[lo:hi]), _ints(rel), _stream()), "count_build_tenants")
            _count(count_build_tenants)
    return out, plan.at


def _check_tenant_gs(gs, valid_rows, dev):
    for m, (g, v) in enumerate(zip(gs, valid_rows)):
        if not v:
            continue
        if (g is None or g.dim() != 2 or g.dtype not in (torch.float32, torch.int32)
                or g.device != dev or g.shape[0] < v or g.shape[1] < v or g.stride(1) != 1):
            raise ValueError(f"tenant {m}'s G must be float32 or int32 [>= {v}, >= {v}] with "
                             f"unit column stride on {dev}, got "
                             f"{None if g is None else (g.dtype, tuple(g.shape), g.stride())}")


def _check_dual_tenants(name, gs, mask, *, valid_rows, num_iterations, step_sizes, l2_regs,
                        residual_fn):
    """The tenant form's arguments, checked before any work; returns (the
    residual mode, M, B, the valid rows as ints)."""
    mode = residual_mode(residual_fn)
    if mode is None:
        raise ValueError(f"{name} has no residual mode for {residual_fn!r}")
    if mask.dim() != 2:
        raise ValueError(f"mask must be [M, B], got {tuple(mask.shape)}")
    m, b = mask.shape
    _check_tenant_rows(name, valid_rows, m, b)
    if not len(gs) == len(step_sizes) == len(l2_regs) == m:
        raise ValueError(f"{m} tenants need {m} G, step sizes and L2s")
    if num_iterations < 0:
        raise ValueError("num_iterations must be >= 0")
    return mode, m, b, [int(v) for v in valid_rows]


def _launch_dual(plan, *, gs, slots, u, labels, mask, numeric, masks, p_prev, alpha, c_out,
                 iterations, scratch, batch_rows, num_iterations, step_sizes, l2_regs,
                 convergence_tol, mode, probe, what):
    """One cooperative launch of ``dual_tenants_kernel`` for ``plan``'s
    tenants (their rows ``slots`` of the [M·B] inputs, their text G ``gs``;
    ``numeric`` None: each G holds N·Nᵀ already); ``scratch`` holds α's
    double buffer and the partials (``plan.scratch_floats``), then the grid
    barriers crossed (its last float)."""
    spill = torch.empty((max(plan.spill_floats, 1),), dtype=torch.float32, device=mask.device)
    _raise_on(_entry("twtml_dual_sgd_tenants")(
        u.data_ptr(), labels.data_ptr(), mask.data_ptr(),
        0 if numeric is None else numeric.data_ptr(), 0 if masks is None else masks.data_ptr(),
        masks.shape[1] if masks is not None and masks.dim() == 3 else 0, p_prev.data_ptr(),
        alpha.data_ptr(), c_out.data_ptr(), iterations.data_ptr(),
        scratch[-1].data_ptr(), scratch.data_ptr(), scratch[2 * plan.abuf_floats:].data_ptr(),
        spill.data_ptr(), plan.abuf_floats, len(plan.valid_rows), batch_rows, plan.grid,
        plan.bp_max, plan.rows_cap_max, plan.shared_bytes, int(plan.in_registers),
        _layout_arg(plan.smem_layout), _ints(plan.first_cta), _ints(plan.valid_rows),
        _ints(slots), _ints(plan.rows_cap), _ints(plan.resident),
        _ints(plan.spill_at, ctypes.c_longlong), _ints(plan.abuf_at, ctypes.c_longlong),
        _ints((0 if g is None else g.data_ptr() for g in gs), ctypes.c_void_p),
        _ints((0 if g is None else g.stride(0) for g in gs), ctypes.c_longlong),
        _ints(int(g is not None and g.dtype == torch.int32) for g in gs),
        _ints((float(v) for v in step_sizes), ctypes.c_float),
        _ints((float(v) for v in l2_regs), ctypes.c_float),
        int(num_iterations), float(convergence_tol), mode,
        None if probe is None else probe.data_ptr(), 0 if probe is None else probe.shape[1],
        _stream()), what)


def _dual_tenant_launches(gs, u, labels, mask, numeric, *, valid, masks, p_prev, num_iterations,
                          step_sizes, l2_regs, convergence_tol, mode, probe=None):
    """The tenant form's launches on the card, TENANTS_PER_LAUNCH tenants
    each (the timing instantiation with ``probe``, int64 [1 + M, edges, 2],
    one launch). Returns (c [M], α [M, B], iterations run [M], each launch's
    grid barriers crossed: [] tensors)."""
    m, b = mask.shape
    dev = mask.device
    for name, t in (("u", u), ("labels", labels), ("mask", mask)):
        _check(name, t, (m, b), torch.float32, dev)
    if numeric is not None:  # None (the probe only): each G holds N·Nᵀ, as B7's
        _check("numeric", numeric, (m, b, 4), torch.float32, dev)
    _check("p_prev", p_prev, (m,), torch.float32, dev)
    if masks is not None:  # shared, or each tenant's own
        _check("masks", masks, (num_iterations, b) if masks.dim() == 2 else (num_iterations, m, b),
               torch.float32, dev)
    _check_tenant_gs(gs, valid, dev)
    with torch.cuda.device(dev):
        sm_count, shared_limit = device_limits(torch.cuda.current_device())
        res = torch.empty((2, m), dtype=torch.float32, device=dev)
        alpha = torch.empty((m, b), dtype=torch.float32, device=dev)
        barriers = []
        for lo in range(0, m, TENANTS_PER_LAUNCH):
            hi = min(m, lo + TENANTS_PER_LAUNCH)
            plan = dual_tenants_plan(valid[lo:hi], sm_count=sm_count, shared_limit=shared_limit)
            scratch = torch.empty((plan.scratch_floats + 1,), dtype=torch.float32, device=dev)
            _launch_dual(plan, gs=gs[lo:hi], slots=range(lo, hi), u=u, labels=labels, mask=mask,
                         numeric=numeric, masks=masks, p_prev=p_prev, alpha=alpha, c_out=res[0],
                         iterations=res[1], scratch=scratch, batch_rows=b,
                         num_iterations=num_iterations, step_sizes=step_sizes[lo:hi],
                         l2_regs=l2_regs[lo:hi], convergence_tol=convergence_tol, mode=mode,
                         probe=probe,
                         what="dual_sgd_tenants" if probe is None else "dual_tenants_probe")
            barriers.append(scratch[-1])
            if probe is None:
                _count(dual_sgd_tenants)
    return res[0], alpha, res[1], tuple(barriers)


def dual_sgd_tenants(gs, u, labels, mask, numeric, *, valid_rows, masks=None, p_prev,
                     num_iterations: int, step_sizes, l2_regs, convergence_tol: float = 0.001,
                     residual_fn=least_squares_residual):
    """B7's tenant form: M tenants' dual loops at once. ``gs`` are the
    tenants' text G (``tenant_gram_blocks``: f32 or int32, [>= v, >= v],
    unit column stride; None for a dry tenant), to which N·Nᵀ of the
    tenant's rows is added; u = Z·W_prev, the labels and the validity mask
    [M, B] f32, ``numeric`` [M, B, 4] f32, the [N, B] Bernoulli masks every
    tenant shares or each tenant's own [N, M, B] (a data axis's gathered
    blocks: each row keeps its global position's draw; None: every valid
    row each iteration), p_prev [M] f32;
    tenant m reads its first ``valid_rows[m]`` rows (rows past them must be
    masked) with ``step_sizes[m]`` and ``l2_regs[m]``, and freezes where
    its test converges. Returns (c [M], α [M, B] (zero past each tenant's
    rows), iterations run [M]), float32 device tensors. On the card one
    cooperative launch of ``dual_tenants_kernel`` for each
    TENANTS_PER_LAUNCH tenants (``dual_tenants_plan``), counted in
    ``dual_sgd_tenants.launches``, each launch's grid barriers crossed then in
    ``dual_sgd_tenants.last_barriers`` ([] tensors; empty after a CPU call);
    on the CPU the plain version."""
    mode, m, b, valid = _check_dual_tenants(
        "dual_sgd_tenants", gs, mask, valid_rows=valid_rows, num_iterations=num_iterations,
        step_sizes=step_sizes, l2_regs=l2_regs, residual_fn=residual_fn)
    dev = mask.device
    if dev.type == "cpu":
        dual_sgd_tenants.last_barriers = ()
        return dual_sgd_tenants_reference(
            gs, u, labels, mask, numeric, valid_rows=valid, masks=masks, p_prev=p_prev,
            num_iterations=num_iterations, step_sizes=step_sizes, l2_regs=l2_regs,
            convergence_tol=convergence_tol, residual_fn=residual_fn)
    if dev.type != "cuda":
        raise ValueError(f"dual_sgd_tenants takes cpu or cuda tensors, got {dev}")
    c, alpha, its, dual_sgd_tenants.last_barriers = _dual_tenant_launches(
        gs, u, labels, mask, numeric, valid=valid, masks=masks, p_prev=p_prev,
        num_iterations=num_iterations, step_sizes=step_sizes, l2_regs=l2_regs,
        convergence_tol=convergence_tol, mode=mode)
    return c, alpha, its


dual_sgd_tenants.last_barriers = ()


def dual_tenants_probe(gs, u, labels, mask, numeric, *, valid_rows, masks=None, p_prev,
                       num_iterations: int, step_sizes, l2_regs, convergence_tol: float = 0.001,
                       residual_fn=least_squares_residual):
    """One launch of B7's tenant form's timing instantiation (at most
    TENANTS_PER_LAUNCH tenants, on the card; ``dual_sgd_tenants``'
    arguments): CTA 0 and each tenant's last CTA stamp (%globaltimer,
    clock64) at the DUAL_PROBE_PROLOGUE_EDGES edges of the prologue and at
    DUAL_PROBE_ITERATION_EDGES edges of each iteration (csrc/gram.cu
    ``dual_stamp``; stamps never reached stay 0). ``numeric`` None reads
    each G whole, as B7's launch does. Counts no launch. Returns (c, α,
    iterations run, stamps int64 [1 + M, edges, 2] on the card)."""
    if mask.dim() != 2 or not 1 <= mask.shape[0] <= TENANTS_PER_LAUNCH:
        raise ValueError(f"the probe takes 1..{TENANTS_PER_LAUNCH} tenants in one launch")
    if mask.device.type != "cuda":
        raise ValueError(f"dual_tenants_probe times the kernel on the card; got {mask.device}")
    mode, m, _, valid = _check_dual_tenants(
        "dual_tenants_probe", gs, mask, valid_rows=valid_rows, num_iterations=num_iterations,
        step_sizes=step_sizes, l2_regs=l2_regs, residual_fn=residual_fn)
    edges = DUAL_PROBE_PROLOGUE_EDGES + DUAL_PROBE_ITERATION_EDGES * num_iterations
    probe = torch.zeros((m + 1, edges, 2), dtype=torch.int64, device=mask.device)
    c, alpha, its, _ = _dual_tenant_launches(
        gs, u, labels, mask, numeric, valid=valid, masks=masks, p_prev=p_prev,
        num_iterations=num_iterations, step_sizes=step_sizes, l2_regs=l2_regs,
        convergence_tol=convergence_tol, mode=mode, probe=probe)
    return c, alpha, its, probe


def dual_tenants_probe_split(stamps) -> dict:
    """The phase split of ``dual_tenants_probe``'s stamps (int64 [slots,
    edges, 2] of %globaltimer ns and clock64): each stamping CTA's phase
    lengths in SM cycles, turned into ns at that CTA's own rate over its
    whole span (%globaltimer ticks coarsely), then the mean over the
    stamping CTAs and the iterations after the first with every edge
    stamped. Returns {"prologue_us", "iteration_us" (DUAL_PROBE_PHASES),
    "us_an_iteration", "iterations", "span_us" (the median CTA's), "slots"}
    (empty phases where no iteration after the first was stamped whole)."""
    st = stamps.detach().cpu().to(torch.float64)
    n_pro, n_it = DUAL_PROBE_PROLOGUE_EDGES, DUAL_PROBE_ITERATION_EDGES
    pro, its, spans, n_iters, slots = [], [], [], 0, 0
    for g, c in zip(st[..., 0], st[..., 1]):
        stamped = torch.nonzero(g).flatten()
        if len(stamped) == 0 or g[0] == 0 or int(stamped[-1]) < n_pro - 1:
            continue  # a slot no CTA stamped
        slots += 1
        last = int(stamped[-1])
        us_a_cycle = float(g[last] - g[0]) / max(float(c[last] - c[0]), 1.0) / 1e3
        spans.append(float(g[last] - g[0]) / 1e3)
        pro.append(float(c[n_pro - 1] - c[0]) * us_a_cycle)
        done = 0  # iterations whose edges are all stamped, in a row from the first
        while done < (st.shape[1] - n_pro) // n_it and bool(
                (g[n_pro + n_it * done:n_pro + n_it * (done + 1)] != 0).all()):
            done += 1
        n_iters = max(n_iters, done)
        if done >= 2:
            edges = c[n_pro - 1:n_pro + n_it * done]
            its.append(torch.diff(edges).reshape(done, n_it)[1:] * us_a_cycle)
    phases = (dict(zip(DUAL_PROBE_PHASES, torch.cat(its).mean(0).tolist())) if its else {})
    return {"prologue_us": sum(pro) / len(pro) if pro else None, "iteration_us": phases,
            "us_an_iteration": sum(phases.values()) if phases else None,
            "iterations": n_iters, "slots": slots,
            "span_us": float(torch.tensor(spans, dtype=torch.float64).median()) if spans else None}


def dual_writeback_tenants(weights, c, alpha, token_idx, token_val, numeric, f_text: int, *,
                           valid_rows, tenants=None, out=None, first_rows=None,
                           token_rows=None):
    """B8's tenant form: for each tenant m of ``tenants`` (default every
    part), row m of ``out`` = c[m]·W_prev[m] + Zᵀα over its
    ``valid_rows[m]`` rows (and the numeric columns' w_num·c + Nᵀα),
    bitwise B8 on those rows. ``weights`` [M, F+4], ``c`` [M], ``alpha``
    [M, B], ``numeric`` [M, B, 4] f32, the tokens [M, B', L] (int32
    indices, f32 values, as B4's tenant form takes them); ``out`` (default
    zeros like ``weights``, never ``weights`` itself) keeps its other rows.
    ``first_rows`` (default 0s) starts tenant i's α and numeric rows at row
    ``first_rows[i]`` of its part, ``token_rows`` (default ``first_rows``)
    its token rows: a data axis's rank writes back its own rows of each
    block, from its rows of each gathered part. On the card one cooperative
    launch of ``writeback_kernel`` for each TENANTS_PER_LAUNCH tenants,
    whatever their Gram planes, counted in
    ``dual_writeback_tenants.launches``; on the CPU the plain version."""
    m, b = alpha.shape
    _check_tenant_rows("dual_writeback_tenants", valid_rows, m, b)
    if token_idx.dim() != 3 or token_idx.shape[0] != m:
        raise ValueError(f"dual_writeback_tenants: token_idx must be [{m}, B', L], got "
                         f"{tuple(token_idx.shape)}")
    bt = token_idx.shape[1]
    tenants = tuple(range(m)) if tenants is None else tuple(int(t) for t in tenants)
    if (not tenants or len(set(tenants)) != len(tenants)
            or any(not 0 <= t < m for t in tenants)):
        raise ValueError(f"dual_writeback_tenants: tenants {tenants} of {m}")
    first_rows = (0,) * len(tenants) if first_rows is None else tuple(int(r) for r in first_rows)
    token_rows = first_rows if token_rows is None else tuple(int(r) for r in token_rows)
    for name, rows, cap in (("first rows", first_rows, b), ("token rows", token_rows, bt)):
        if len(rows) != len(tenants) or any(
                r < 0 or r + int(valid_rows[t]) > cap for t, r in zip(tenants, rows)):
            raise ValueError(f"dual_writeback_tenants: {name} {rows} of {cap}")
    dev = weights.device
    kw = dict(valid_rows=valid_rows, tenants=tenants, first_rows=first_rows,
              token_rows=token_rows)
    if dev.type == "cpu":
        return dual_writeback_tenants_reference(weights, c, alpha, token_idx, token_val, numeric,
                                                f_text, out=out, **kw)
    if dev.type != "cuda":
        raise ValueError(f"dual_writeback_tenants takes cpu or cuda tensors, got {dev}")
    _check_writeback(weights, c, alpha, token_idx, token_val, numeric, f_text, (m,))
    with torch.cuda.device(dev):
        if out is None:
            out = torch.zeros_like(weights)
        _check("out", out, (m, f_text + 4), torch.float32, dev)
        for lo in range(0, len(tenants), TENANTS_PER_LAUNCH):
            part = tenants[lo:lo + TENANTS_PER_LAUNCH]
            _launch_writeback(
                weights, c, alpha, token_idx, token_val, numeric, out, f_text, slots=part,
                token_rows=[t * bt + r for t, r in zip(part, token_rows[lo:])],
                valid=[int(valid_rows[t]) for t in part],
                src_rows=[t * b + r for t, r in zip(part, first_rows[lo:])],
                what="dual_writeback_tenants")
            _count(dual_writeback_tenants)
    return out


# the counted wrappers of this module, in the order the route calls them
KERNELS = (count_build, dual_sgd, dual_writeback_counts, count_build_tenants, dual_sgd_tenants,
           dual_writeback_tenants)
for _fn in KERNELS:
    _fn.launches = 0
    _fn.captured = 0
