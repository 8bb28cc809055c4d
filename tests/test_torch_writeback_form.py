"""B8's write-back as its CUDA kernel computes it (``csrc/gram.cu``
``writeback_kernel``): a numpy model of its order, held against the JAX
package's scatter write-back (``twtml_tpu/ops/gram.py`` ``dual_writeback``,
and ``twtml_tpu/ops/sparse.py`` ``sparse_grad_text`` for a data axis's
rank's rows) and against the port's plain version
(``fused_gram.dual_writeback_reference``), on the same numpy inputs, within
rtol 2e-4 (atol 2e-4·max(1, max|w|)): the tolerance chip_smoke.py holds the
kernel to.

The model follows the kernel step by step. The tile pass: tile k of a
tenant is its occurrences [T·k, T·k + T) in (row, j) order (T =
WRITEBACK_TILE); each contribution val·α rounded to f32; the keys sorted by
(idx, position) (an index outside [0, F) counts nothing); each column's run
summed by the parallel pairwise steps (position r of the run adds r + d for
r = 0, 2d, 4d, ..., d = 1, 2, 4, ...); the runs written in column order.
The bucket pass: for each bucket (its 256 columns the 32 lines of 8
columns b, b + buckets, b + 2·buckets, ...: ``slot_of``), the tenant's
tiles WRITEBACK_GROUP at a time, their runs in the bucket gathered in tile order,
WRITEBACK_WINDOW at a time, sorted by (column, gathered position), each
added to its column's binary counter of partial sums (the kernel adds
aligned blocks of them at once: the same tree); w = c·w_prev + the
counter's sum, or exactly c·w_prev where no token lands. The numeric columns: each
thread's rows in order (fma), the warp's butterfly, the warps in order.
The port's ``fused_gram.dual_writeback_in_order`` (the same order as torch
ops, on the host) is held bitwise against the model's text columns; on the
card chip_smoke.py holds the CUDA kernel's text columns bitwise against
it, and the whole result against the plain version within tolerance."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from twtml_tpu.ops import gram as jgram
from twtml_tpu.ops.sparse import sparse_grad_text

from twtml_tpu_torch.ops import fused_gram

GRAM_SOURCE = Path(fused_gram.__file__).resolve().parents[1] / "csrc" / "gram.cu"
TILE = fused_gram.WRITEBACK_TILE
COLS = fused_gram.WRITEBACK_COLUMNS
WINDOW = fused_gram.WRITEBACK_WINDOW
GROUP = fused_gram.WRITEBACK_GROUP
THREADS = fused_gram.WRITEBACK_THREADS
RTOL = 2e-4
F32 = np.float32


def pairwise(xs):
    """The pairwise tree over xs in order: x[r] += x[r + d] for r = 0, 2d,
    4d, ... and d = 1, 2, 4, ...; returns x[0]."""
    x = [F32(v) for v in xs]
    d = 1
    while d < len(x):
        for r in range(0, len(x) - d, 2 * d):
            x[r] = F32(x[r] + x[r + d])
        d *= 2
    return x[0]


class PairSum:
    """The kernel's running pairwise sum: level l holds 2^l values."""

    def __init__(self):
        self.level, self.count = [F32(0)] * 32, 0

    def push(self, v):
        v, n, lev = F32(v), self.count, 0
        while n & 1:
            v = F32(self.level[lev] + v)
            n >>= 1
            lev += 1
        self.level[lev] = v
        self.count += 1

    def total(self):
        acc = None
        for lev in range(32):
            if (self.count >> lev) & 1:
                acc = self.level[lev] if acc is None else F32(self.level[lev] + acc)
        return acc


def tile_pass(f, contrib, features):
    """One tile: its runs (columns ascending, their pairwise sums), by the
    kernel's parallel steps over the sorted positions."""
    n = len(f)
    width = 1 << max(n - 1, 0).bit_length()
    keep = (f >= 0) & (f < features)
    pos = np.arange(n)
    order = np.lexsort((pos[keep], f[keep]))  # the sorted keys: (column, position)
    cols, at = f[keep][order], pos[keep][order]
    sums = contrib[at].astype(F32)
    starts = np.flatnonzero(np.r_[True, cols[1:] != cols[:-1]]) if len(cols) else np.zeros(0, int)
    head = np.repeat(starts, np.diff(np.r_[starts, len(cols)]))
    length = np.repeat(np.diff(np.r_[starts, len(cols)]), np.diff(np.r_[starts, len(cols)]))
    r = np.arange(len(cols)) - head
    d = 1
    while d < width:
        step = ((r & (2 * d - 1)) == 0) & (r + d < length)
        i = np.flatnonzero(step)
        sums[i] = (sums[i] + sums[i + d]).astype(F32)
        d *= 2
    return cols[starts], sums[starts]


def warp_butterfly(lanes):
    v = np.asarray(lanes, F32)
    for off in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ off]).astype(F32)
    return v[0]


def fma(a, b, c):
    return F32(np.float64(a) * np.float64(b) + np.float64(c))


def slot_of(f, buckets):
    """A column's slot: bucket b holds the 32 lines of 8 columns b, b +
    buckets, b + 2·buckets, ...; slots [256·b, 256·b + 256)."""
    line = f >> 3
    return (line % buckets) * COLS + (line // buckets) * 8 + (f & 7)


def column_of(slot, buckets):
    local = slot % COLS
    return ((local >> 3) * buckets + slot // COLS) * 8 + (local & 7)


def writeback_model(w, c, alpha, idx, val, num, features):
    """The kernel on one tenant (a single batch): w [F + 4], c scalar,
    alpha [v], idx / val [v, L], num [v, 4] -> W_new [F + 4] f32."""
    v, tokens = idx.shape
    f = idx.reshape(-1).astype(np.int64)
    with np.errstate(invalid="ignore"):  # 0·inf where a non-finite α meets padding
        contrib = (val.astype(F32) * alpha.astype(F32)[:, None]).astype(F32).reshape(-1)
    tiles = [tile_pass(f[k:k + TILE], contrib[k:k + TILE], features)
             for k in range(0, v * tokens, TILE)]
    c = F32(c)
    out = (w.astype(F32) * c).astype(F32)
    buckets = -(-features // COLS)
    # each tile's runs in slot order, as the kernel writes them
    tiles = [(slot_of(cols, buckets), sums) for cols, sums in tiles]
    tiles = [(slots[np.argsort(slots)], sums[np.argsort(slots)]) for slots, sums in tiles]
    for b in range(buckets):
        b0 = b * COLS
        counters = [PairSum() for _ in range(COLS)]
        for g0 in range(0, len(tiles), GROUP):  # a group of tiles
            gathered = []  # the group's runs in the bucket, in tile order
            for slots, sums in tiles[g0:g0 + GROUP]:
                inside = (slots >= b0) & (slots < b0 + COLS)
                gathered += list(zip(slots[inside] - b0, sums[inside]))
            for w0 in range(0, len(gathered), WINDOW):
                window = gathered[w0:w0 + WINDOW]
                for i in sorted(range(len(window)), key=lambda i: (window[i][0], i)):
                    counters[window[i][0]].push(window[i][1])
        for k, counter in enumerate(counters):
            col = column_of(b0 + k, buckets)
            if counter.count and col < features:
                out[col] = F32(out[col] + counter.total())
    acc = np.zeros((THREADS, 4), F32)
    for r in range(v):
        for j in range(4):
            acc[r % THREADS, j] = fma(num[r, j], alpha[r], acc[r % THREADS, j])
    for j in range(4):
        if v:
            s = F32(0)
            for warp in range(THREADS // 32):
                s = F32(s + warp_butterfly(acc[32 * warp:32 * warp + 32, j]))
            out[features + j] = F32(out[features + j] + s)
    return out


def jax_writeback(w, c, alpha, idx, val, num, features):
    text, numw = jgram.dual_writeback(jnp.asarray(w[:features]), jnp.asarray(w[features:]),
                                      jnp.float32(c), jnp.asarray(alpha), jnp.asarray(idx),
                                      jnp.asarray(val), jnp.asarray(num))
    return np.concatenate([np.asarray(text), np.asarray(numw)])


def plain(w, c, alpha, idx, val, num, features):
    return fused_gram.dual_writeback_reference(
        torch.from_numpy(w), torch.tensor(c, dtype=torch.float32), torch.from_numpy(alpha),
        torch.from_numpy(idx), torch.from_numpy(val), torch.from_numpy(num), features).numpy()


def assert_within(got, want, what):
    atol = RTOL * max(1.0, float(np.abs(want).max()))
    err = np.abs(got.astype(np.float64) - want)
    assert np.all(err <= atol + RTOL * np.abs(want)), f"{what}: max abs err {err.max():.3e}"


F = 2048  # eight buckets


def _rows(rng, rows, tokens, case):
    """[rows, tokens] idx int32, val f32 for a skew case."""
    idx = rng.integers(0, F, (rows, tokens))
    val = rng.integers(1, 3, (rows, tokens)).astype(F32)
    if case == "synthetic":  # every token in a few hot columns, ~150 occurrences each
        hot = rng.choice(F, 40, replace=False)
        idx = hot[rng.integers(0, 40, (rows, tokens))]
    elif case == "one column":  # the worst skew: every token in one column
        idx = np.full((rows, tokens), 1234)
    elif case == "padding":  # tweet-length rows, value-0 slots in column 0
        n = rng.integers(3, tokens, rows)
        pad = np.arange(tokens)[None, :] >= n[:, None]
        idx[pad], val[pad] = 0, 0.0
    elif case == "slice":  # a model axis's slice: the tokens outside clamped, value 0
        rel = idx - F // 2
        val = val * ((rel >= 0) & (rel < F // 2))
        idx = np.clip(rel, 0, F // 2 - 1) * 2  # (the model runs at F; only 0 and F - 2 are hot)
    elif case == "exact plane":  # f32 values, tweet-length rows of L = 511
        val = rng.normal(size=(rows, tokens)).astype(F32)
    elif case == "out of range":
        idx[:, ::7] = F + 3
        idx[:, 1::9] = -2
    return idx.astype(np.int32), val.astype(F32)


CASES = {  # name -> rows, tokens
    "synthetic": (64, 63),
    "one column": (48, 63),
    "padding": (40, 63),
    "slice": (40, 63),
    "exact plane": (9, 511),
    "one tile": (4, 7),
    "out of range": (24, 63),
}


def _inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    rows, tokens = CASES[case]
    idx, val = _rows(rng, rows, tokens, case)
    w = (rng.normal(size=F + 4) * 1e-2).astype(F32)
    alpha = (rng.normal(size=rows) * 1e-3).astype(F32)
    num = (rng.normal(size=(rows, 4)) * 0.1).astype(F32)
    return w, F32(0.97), alpha, idx, val, num


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_kernels_order_holds_the_jax_scatter_and_the_plain_version(case):
    w, c, alpha, idx, val, num = _inputs(case)
    got = writeback_model(w, c, alpha, idx, val, num, F)
    keep = (idx >= 0) & (idx < F)  # the JAX scatter drops what lies past F but wraps negatives
    jax_idx, jax_val = np.where(keep, idx, 0).astype(np.int32), np.where(keep, val, 0).astype(F32)
    assert_within(got, jax_writeback(w, c, alpha, jax_idx, jax_val, num, F), "against JAX")
    assert_within(got, plain(w, c, alpha, idx, val, num, F), "against the plain version")
    untouched = np.setdiff1d(np.arange(F), idx[keep])
    assert np.array_equal(got[untouched], (w[untouched] * c).astype(F32))  # c·w_prev exactly


def in_order(w, c, alpha, idx, val, num, features):
    return fused_gram.dual_writeback_in_order(
        torch.from_numpy(w), torch.tensor(c, dtype=torch.float32), torch.from_numpy(alpha),
        torch.from_numpy(idx), torch.from_numpy(val), torch.from_numpy(num), features).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_ports_in_order_version_is_the_models_text_columns_bitwise(case):
    w, c, alpha, idx, val, num = _inputs(case, seed=1)
    got = in_order(w, c, alpha, idx, val, num, F)
    want = writeback_model(w, c, alpha, idx, val, num, F)
    assert np.array_equal(got[:F].view(np.uint32), want[:F].view(np.uint32))
    assert_within(got, want, "the numeric columns")


def test_a_hot_columns_sum_is_a_tree_not_a_chain():
    """One column of 160·63 occurrences: 1.0, then 0.9·2^-24 each. A chain
    from the first drops every later one (each under half an ulp of 1.0);
    the kernel's tree sums them among themselves first and keeps the sum
    within a few roundings of the exact one."""
    rows, tokens = 160, 63
    idx = np.full((rows, tokens), 5, np.int32)
    val = np.full((rows, tokens), F32(0.9 * 2.0**-24), F32)
    val[0, 0] = 1.0
    alpha = np.ones(rows, F32)
    w = np.zeros(F + 4, F32)
    got = writeback_model(w, F32(1.0), alpha, idx, val, np.zeros((rows, 4), F32), F)
    exact = float(np.sum(val.astype(np.float64)))
    chain = F32(0)
    for x in val.reshape(-1):
        chain = F32(chain + x)
    assert abs(float(chain) - exact) > RTOL * exact  # what a chain would give
    assert abs(float(got[5]) - exact) <= 2e-6 * exact


@pytest.mark.parametrize("n", list(range(1, 70)) + [255, 256, 257, 1023, 1025])
def test_the_running_pairwise_sum_is_the_pairwise_tree(n):
    xs = np.random.default_rng(n).normal(size=n).astype(F32) * F32(1e3)
    counter = PairSum()
    for x in xs:
        counter.push(x)
    assert counter.total() == pairwise(xs)


@pytest.mark.parametrize("run", [1, 2, 3, 7, 64, 100, TILE])
def test_the_tile_passs_steps_sum_each_run_pairwise(run):
    rng = np.random.default_rng(run)
    f = np.sort(rng.integers(0, 40, TILE - run))
    f = np.r_[np.full(run, 17), f]
    rng.shuffle(f)
    contrib = rng.normal(size=len(f)).astype(F32)
    cols, sums = tile_pass(f, contrib, 64)
    for col, s in zip(cols, sums):
        assert s == pairwise(contrib[f == col])


def test_a_tenant_stack_is_each_tenant_alone_and_a_dry_one_is_c_w():
    """The tenant form's plain version (every part, the CPU route) holds
    the model on each tenant's own rows; a dry tenant is c·w exactly."""
    m, rows, tokens = 4, 40, 63
    rng = np.random.default_rng(3)
    idx = rng.integers(0, F, (m, rows, tokens)).astype(np.int32)
    val = rng.integers(1, 4, (m, rows, tokens)).astype(F32)
    valid = (40, 0, 17, 33)
    w = (rng.normal(size=(m, F + 4)) * 1e-2).astype(F32)
    c = np.array([0.97, 0.5, 0.99, 0.95], F32)
    alpha = (rng.normal(size=(m, rows)) * 1e-3).astype(F32)
    num = (rng.normal(size=(m, rows, 4)) * 0.1).astype(F32)
    got = fused_gram.dual_writeback_tenants(
        torch.from_numpy(w), torch.from_numpy(c), torch.from_numpy(alpha), torch.from_numpy(idx),
        torch.from_numpy(val), torch.from_numpy(num), F, valid_rows=valid).numpy()
    for t, v in enumerate(valid):
        want = writeback_model(w[t], c[t], alpha[t, :v], idx[t, :v], val[t, :v], num[t, :v], F)
        assert_within(got[t], want, f"tenant {t}")
        if not v:
            assert np.array_equal(want, (w[t] * c[t]).astype(F32))


def test_a_ranks_rows_sum_to_the_data_axis_write_back():
    """Over a data axis each rank writes back its own rows on zero weights
    (first_rows into α, token_rows into its gathered part); the ranks' sums
    plus c·W hold the JAX data-axis form: c·W + psum of sparse_grad_text and
    Nᵀα over each rank's rows."""
    rows, tokens, ranks = 24, 63, 2
    rng = np.random.default_rng(8)
    idx = rng.integers(0, F, (ranks * rows, tokens)).astype(np.int32)
    val = rng.integers(1, 3, (ranks * rows, tokens)).astype(F32)
    alpha = (rng.normal(size=ranks * rows) * 1e-3).astype(F32)
    num = (rng.normal(size=(ranks * rows, 4)) * 0.1).astype(F32)
    w = (rng.normal(size=F + 4) * 1e-2).astype(F32)
    c = F32(0.9)
    zeros = np.zeros_like(w)
    delta = sum(writeback_model(zeros, c, alpha[r * rows:(r + 1) * rows],
                                idx[r * rows:(r + 1) * rows], val[r * rows:(r + 1) * rows],
                                num[r * rows:(r + 1) * rows], F) for r in range(ranks))
    got = (w * c).astype(F32) + delta
    text = sum(np.asarray(sparse_grad_text(jnp.asarray(idx[r * rows:(r + 1) * rows]),
                                           jnp.asarray(val[r * rows:(r + 1) * rows]),
                                           jnp.asarray(alpha[r * rows:(r + 1) * rows]), F))
               for r in range(ranks))
    numw = sum(num[r * rows:(r + 1) * rows].T @ alpha[r * rows:(r + 1) * rows]
               for r in range(ranks))
    want = np.concatenate([w[:F] * c + text, w[F:] * c + numw])
    assert_within(got, want, "against the JAX data-axis form")
    # the tenant form at a rank's rows: its token rows in the gathered part
    for r in range(ranks):
        one = fused_gram.dual_writeback_tenants(
            torch.zeros((1, F + 4)), torch.tensor([c]), torch.from_numpy(alpha[None]),
            torch.from_numpy(idx[None]), torch.from_numpy(val[None]), torch.from_numpy(num[None]),
            F, valid_rows=[rows], first_rows=[r * rows], token_rows=[r * rows]).numpy()[0]
        want = writeback_model(zeros, c, alpha[r * rows:(r + 1) * rows],
                               idx[r * rows:(r + 1) * rows], val[r * rows:(r + 1) * rows],
                               num[r * rows:(r + 1) * rows], F)
        assert_within(one, want, f"rank {r}")


@pytest.mark.parametrize("poison", ["nan", "inf"])
def test_a_non_finite_alpha_poisons_the_scatters_columns(poison):
    """A non-finite α reaches every column its row's tokens hit (value-0
    padding included: 0·NaN is NaN), as in the scatter, and no other."""
    w, c, alpha, idx, val, num = _inputs("padding")
    alpha[3] = np.nan if poison == "nan" else np.inf
    got = writeback_model(w, c, alpha, idx, val, num, F)
    want = plain(w, c, alpha, idx, val, num, F)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert_within(got[fin], want[fin], "finite columns")
    assert np.isnan(got[0]) == bool((val[3] == 0).any())  # padding in column 0: 0·α is NaN


@pytest.mark.parametrize("valid,tokens", [
    ((2048,), 63),  # a synthetic batch: 129,024 occurrences
    ((2048,), 511),  # the exact plane's tweet-length rows
    ((512, 530, 498, 508), 63),  # config #4's four parts
    ((0, 0), 63),
])
def test_the_plan_at_the_operating_points(valid, tokens):
    plan = fused_gram.writeback_plan(valid, tokens, 2**18)
    tiles = sum(math.ceil(v * tokens / TILE) for v in valid)
    assert plan.tiles == tiles and plan.buckets == 2**18 // COLS
    assert plan.first_tile == tuple(np.cumsum([0] + [math.ceil(v * tokens / TILE)
                                                     for v in valid]))
    assert plan.scratch_ints == 2 * tiles * TILE + (plan.buckets + 1) * tiles
    assert plan.items == len(valid) * (plan.buckets + 1)
    assert plan.grid(132, 4) == min(528, max(tiles, plan.items))


@pytest.mark.parametrize("features", [8, 100, 2048, 2**18, 2**18 + 5])
def test_the_slots_are_a_bijection_onto_whole_lines(features):
    buckets = -(-features // COLS)
    f = np.arange(features)
    slots = slot_of(f, buckets)
    assert len(np.unique(slots)) == features and slots.max() < buckets * COLS
    assert np.array_equal(column_of(slots, buckets), f)
    assert np.array_equal(slots[::8] % 8, np.zeros(-(-features // 8)))  # lines stay whole


def test_the_entry_takes_the_wrapper_arguments():
    source = GRAM_SOURCE.read_text()
    for entry in ("twtml_dual_writeback", "twtml_writeback_blocks_per_sm"):
        params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', source).group(1)
        assert len(params.split(",")) == len(fused_gram._ENTRIES[entry])


def test_b8_reads_no_counts():
    """The kernel's inputs are the tokens: no C argument, no int8 kind."""
    source = GRAM_SOURCE.read_text()
    params = re.search(r'extern "C" int twtml_dual_writeback\(([^)]*)\)', source).group(1)
    assert "idx" in params and "val" in params
    assert "counts" not in params and "kind" not in params
