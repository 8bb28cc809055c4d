"""B4's count build as its CUDA kernel computes it (``csrc/gram.cu``
``count_build_kernel``): a numpy model of the sorted token pass, held
bitwise against the port's twin ``fused_gram.count_build_reference`` and,
through it, against the JAX package's counts (``twtml_tpu/ops/sparse.py``
``densify_text``, the exact plane's f32 sums in token order, and
``twtml_tpu/ops/gram.py`` ``onehot_counts_int8``), on the same numpy inputs.

The model follows the kernel step by step: one 64-bit key a token, idx <<
ceil(log2 L) | j (the all-ones key for an index outside [0, F)); the keys
sorted; each warp's run of steps (32 16-byte chunks each) in order, with
its cursor, the first key not yet counted: a step that ends at or before
the cursor key's feature is zeros; the step's keys, when the 32 keys from
the cursor on hold them all, are added in sorted order, else each chunk's
keys from its first found by binary search; each value added in f32 from
0 into its feature's count. The kernel ignores
an index outside [0, F) (hashed indices lie in [0, F)); the twin is held
against it on the tokens it counts. Every comparison is bitwise (the f32
counts as their bit patterns). The CUDA kernel itself is held against the
twin on the card by chip_smoke.py."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from twtml_tpu.ops import gram as jgram
from twtml_tpu.ops.sparse import densify_text as jax_densify_text

from twtml_tpu_torch.ops import fused_gram

H100_SHARED = 232_448
GRAM_F = 2**18
GRAM_SOURCE = Path(fused_gram.__file__).resolve().parents[1] / "csrc" / "gram.cu"


def sorted_count_model(idx, val, features, cols, int8):
    """The kernel's algorithm in numpy: [B, L] int32 idx and f32 val ->
    [B, cols] counts (int8 truncated toward zero from the f32 sums, or
    f32)."""
    b, tokens = idx.shape
    lay = fused_gram.count_layout(tokens)
    bits, width = np.uint64(lay.token_bits), lay.width
    no_key = np.iinfo(np.uint64).max
    per = 16 // (1 if int8 else 4)  # features a 16-byte chunk holds
    chunks = cols // per
    warps = fused_gram.COUNT_THREADS // 32
    out = np.zeros((b, cols), np.int8 if int8 else np.float32)
    for r in range(b):
        keys = np.full(width + 32, no_key, np.uint64)  # past width: the lanes' kNoKey
        f = idx[r].astype(np.int64)
        valid = (f >= 0) & (f < features)
        j = np.arange(tokens, dtype=np.int64)
        keys[:tokens][valid] = ((f[valid] << int(bits)) | j[valid]).astype(np.uint64)
        keys[:width].sort()
        acc = np.zeros(cols, np.float32)

        def add(key):
            acc[int(key >> bits)] = np.float32(acc[int(key >> bits)]
                                               + val[r, int(key) & (width - 1)])

        steps = -(-chunks // 32)
        run = -(-steps // warps)
        for warp in range(warps):
            s0, s1 = warp * run, min(warp * run + run, steps)
            if s0 >= s1:
                continue
            # the warp's cursor: its first key at or past its run's first feature
            q = int(np.searchsorted(keys[:width], np.uint64(s0 * 32 * per) << bits))
            for step in range(s0, s1):
                end = np.uint64((step + 1) * 32 * per) << bits
                if keys[q] >= end:
                    continue  # the step is zeros
                window = keys[q:q + 32]
                n = int((window < end).sum())
                if n < 32:  # the step's keys, shuffled in sorted order
                    for key in window[:n]:
                        add(key)
                    q += n
                    continue
                for chunk in range(32 * step, min(32 * step + 32, chunks)):
                    c0 = chunk * per  # its first key by binary search from the cursor
                    k = q + int(np.searchsorted(keys[q:width], np.uint64(c0) << bits))
                    while k < width and keys[k] != no_key and int(keys[k] >> bits) < c0 + per:
                        add(keys[k])
                        k += 1
                q += int(np.searchsorted(keys[q:width], end))
        out[r] = np.trunc(acc).astype(np.int8) if int8 else acc
    return out


def twin(idx, val, features, cols, int8):
    """The twin on the tokens the kernel counts: a row's tokens whose index
    lies outside [0, F) are left out of its input."""
    valid = (idx >= 0) & (idx < features)
    if valid.all():
        return fused_gram.count_build_reference(
            torch.from_numpy(idx), torch.from_numpy(val), features, int8=int8,
            rows_out=idx.shape[0], cols_out=cols).numpy()
    out = np.zeros((idx.shape[0], cols), np.int8 if int8 else np.float32)
    for r in range(idx.shape[0]):
        if valid[r].any():
            out[r] = twin(idx[r, valid[r]][None], val[r, valid[r]][None], features, cols,
                          int8)[0]
    return out


def assert_bitwise(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want)


def tweet_rows(rng, rows, tokens, features, terms):
    """Tweet-like token rows: ``terms`` hashed bigrams of value 1 or 2 a row
    (duplicates drawn from a small pool), the rest padding (idx 0, val 0)."""
    idx = np.zeros((rows, tokens), np.int32)
    val = np.zeros((rows, tokens), np.float32)
    pool = rng.integers(0, features, size=(rows, max(terms // 3, 1)))
    pick = rng.integers(0, pool.shape[1], size=(rows, terms))
    idx[:, :terms] = np.take_along_axis(pool, pick, axis=1)
    val[:, :terms] = rng.integers(1, 3, size=(rows, terms))
    return idx, val


def cases():
    rng = np.random.default_rng(11)
    out = {}
    f = 64
    idx = rng.integers(0, f, size=(6, 12)).astype(np.int32)
    idx[0, :5] = 0  # duplicates at the first column
    idx[1, 3:9] = f - 1  # and at the last
    idx[2, ::2] = (0, f - 1, 0, f - 1, 0, f - 1)
    out["first and last columns"] = (idx, rng.integers(1, 4, size=idx.shape).astype(np.float32),
                                     f, 64)
    idx = rng.integers(-20, f + 20, size=(5, 9)).astype(np.int32)
    idx[0, :3] = (-1, f, 2**31 - 1)
    out["out of range and negative"] = (idx, rng.integers(1, 4, size=idx.shape)
                                        .astype(np.float32), f, 80)
    out["L = 1"] = (np.array([[3], [0], [f - 1], [f]], np.int32),
                    np.array([[2.0], [1.0], [5.0], [7.0]], np.float32), f, 64)
    for tokens in (5, 33, 100):
        idx, val = tweet_rows(rng, 4, tokens, f, min(tokens, 30))
        out[f"L = {tokens} (not a power of two)"] = (idx, val, f, 64)
    idx, val = tweet_rows(rng, 3, 511, GRAM_F, 279)
    out["L = 511, 2^18 features"] = (idx, val, GRAM_F, GRAM_F)
    # steps (32 chunks: 128 f32 or 512 int8 features) that hold more keys
    # than a warp's window of 32, and steps just under it
    idx = rng.integers(0, 256, size=(3, 100)).astype(np.int32)
    idx[2, :31], idx[2, 31:] = rng.integers(0, 128, size=31), rng.integers(128, 256, size=69)
    out["more than 32 keys a step"] = (idx, rng.integers(1, 4, size=idx.shape)
                                       .astype(np.float32), 256, 256)
    # the same feature three times in token order: (1e8 + -1e8) + 1 = 1, but
    # (1 + 1e8) + -1e8 = 0 in f32; and interleaved features of one chunk
    idx = np.array([[9, 9, 9, 4, 5, 4, 7, 5], [9, 9, 9, 9, 0, 0, 0, 0]], np.int32)
    val = np.array([[1e8, -1e8, 1.0, 0.5, 0.25, 3.0, 1e-8, 1e8],
                    [1.0, 1e8, -1e8, 3.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    out["order-dependent sums"] = (idx, val, 16, 16)
    return out


CASES = cases()


# non-integral values have no int8 plane (the plane's gate)
PLANES = [(name, int8) for name in sorted(CASES) for int8 in (False, True)
          if not (int8 and name == "order-dependent sums")]


@pytest.mark.parametrize("name,int8", PLANES,
                         ids=[f"{n}-{'int8' if i else 'f32'}" for n, i in PLANES])
def test_sorted_model_equals_the_twin_bitwise(name, int8):
    idx, val, features, cols = CASES[name]
    assert_bitwise(sorted_count_model(idx, val, features, cols, int8),
                   twin(idx, val, features, cols, int8))


@pytest.mark.parametrize("name", sorted(n for n in CASES if n != "out of range and negative"))
def test_twin_equals_the_jax_packages_counts(name):
    """Valid indices only: the JAX scatter wraps a negative index where the
    port's kernel (and its twin) ignore it; hashed indices are never
    negative."""
    idx, val, features, cols = CASES[name]
    got = twin(idx, val, features, cols, int8=False)[:, :features]
    want = np.asarray(jax_densify_text(jnp.asarray(idx), jnp.asarray(val), features))
    assert_bitwise(got, want)
    if name != "order-dependent sums":
        got8 = twin(idx, val, features, cols, int8=True)[:, :features]
        assert_bitwise(got8, np.asarray(jgram.onehot_counts_int8(
            jnp.asarray(idx), jnp.asarray(val), features)))


def test_order_dependent_sums_follow_token_order():
    idx, val, features, cols = CASES["order-dependent sums"]
    counts = sorted_count_model(idx, val, features, cols, int8=False)
    assert counts[0, 9] == 1.0 and counts[1, 9] == 3.0  # (1e8 - 1e8) + 1; (1 + 1e8) - 1e8 + 3
    assert counts[0, 4] == 3.5 and counts[0, 5] == np.float32(0.25) + np.float32(1e8)


def test_out_of_range_indices_count_nothing():
    idx, val, features, cols = CASES["out of range and negative"]
    counts = sorted_count_model(idx, val, features, cols, False)
    valid = (idx >= 0) & (idx < features)
    moved = np.where(valid, idx, 0)  # the out-of-range tokens' values at column 0
    assert not counts[:, features:].any()
    assert_bitwise(np.delete(counts, 0, axis=1),
                   np.delete(twin(moved, val, features, cols, False), 0, axis=1))


@pytest.mark.parametrize("tokens,features", [
    (511, GRAM_F),  # the operating point: 9 + 18 = 27 bits
    (2**13 + 1, 2**17 + 5),  # 14 + 18 = 32 bits: past a 32-bit key
    (2**14, 2**31 - 1),  # the widest L that fits an H100, the widest int32 index
])
def test_keys_fit_below_the_all_ones_key(tokens, features):
    bits = fused_gram.count_token_bits(tokens)
    assert (1 << bits) >= tokens > (1 << bits) // 2 or tokens == 1
    top = ((features - 1) << bits) | (tokens - 1)  # the largest valid key
    assert top < 2**(8 * fused_gram.COUNT_KEY_BYTES) - 1


def test_sixty_four_bit_keys_equal_the_twin_bitwise():
    """Keys wider than 31 bits: an index of 18 bits above 14 bits of
    position."""
    rng = np.random.default_rng(5)
    features, tokens = 2**17 + 5, 2**13 + 1
    idx, val = tweet_rows(rng, 2, tokens, features, 3000)
    idx[0, -3:] = (features - 1, features - 1, 0)
    val[0, -3:] = (2.0, 3.0, 4.0)
    assert (features - 1).bit_length() + fused_gram.count_token_bits(tokens) > 31
    cols = fused_gram.padded_columns(features)
    for int8 in (False, True):
        assert_bitwise(sorted_count_model(idx, val, features, cols, int8),
                       twin(idx, val, features, cols, int8))


def test_count_layout_at_the_operating_point():
    """L = 511: 4 KiB of 64-bit keys (the sort's width 512) and the 511
    values; L = 63 (the int8 plane's): 512 B and 256 B. Neither depends on
    the row's columns; both are within the H100's 232,448 B a block."""
    f32 = fused_gram.count_layout(511)
    assert (f32.token_bits, f32.width, f32.vals, f32.shared_bytes) == (9, 512, 4096, 6144)
    i8 = fused_gram.count_layout(63)
    assert (i8.width, i8.vals, i8.shared_bytes) == (64, 512, 768)
    for tokens in (511, 63):
        assert fused_gram.count_shared_bytes(tokens, shared_limit=H100_SHARED) <= H100_SHARED


@pytest.mark.parametrize("tokens", [1, 3, 63, 511, 2**13 + 1])
def test_count_layout_holds_what_the_kernel_touches(tokens):
    lay = fused_gram.count_layout(tokens)
    assert lay.vals % 16 == 0 and lay.shared_bytes % 16 == 0
    assert lay.width >= tokens and lay.width == 1 << lay.token_bits
    assert lay.vals >= lay.width * fused_gram.COUNT_KEY_BYTES
    assert lay.shared_bytes - lay.vals >= 4 * tokens


def test_count_shared_bytes_refuses_what_does_not_fit():
    assert fused_gram.count_shared_bytes(2**14, shared_limit=H100_SHARED) == 2**17 + 2**16
    for tokens in (2**14 + 1, 40_000):
        with pytest.raises(ValueError, match="shared memory"):
            fused_gram.count_shared_bytes(tokens, shared_limit=H100_SHARED)


def test_gram_build_passes_the_plan_constants():
    """The launch plan's constants reach nvcc, and gram.cu checks its own
    against each of them at compile time."""
    from twtml_tpu_torch.ops import _build

    assert _build.SOURCES["gram"] == ("gram.cu", fused_gram.NVCC_DEFINES)
    source = GRAM_SOURCE.read_text()
    for define in fused_gram.NVCC_DEFINES:
        name, value = define[len("-D"):].split("=")
        assert value == str(getattr(fused_gram, name[len("TWTML_GRAM_"):]))
        assert re.search(rf"static_assert\(\w+ == {name},", source), name


def test_count_entry_takes_the_wrapper_arguments():
    source = GRAM_SOURCE.read_text()
    params = re.search(r'extern "C" int twtml_count_build\(([^)]*)\)', source).group(1)
    assert len(params.split(",")) == len(fused_gram._ENTRIES["twtml_count_build"])


@pytest.mark.parametrize("entry", ["twtml_dual_sgd_tenants", "twtml_dual_barrier_probe",
                                   "twtml_dual_writeback"])
def test_gram_entries_take_the_wrapper_arguments(entry):
    """Every other C entry of gram.cu takes as many arguments as its ctypes
    binding passes."""
    source = GRAM_SOURCE.read_text()
    params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', source).group(1)
    assert len(params.split(",")) == len(fused_gram._ENTRIES[entry])
