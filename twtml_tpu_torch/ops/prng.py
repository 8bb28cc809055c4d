"""Threefry-2x32 random bits as torch integer ops: the JAX package's
``jax.random`` draws (``PRNGKey``, ``fold_in``, ``random_bits``, ``uniform``,
``bernoulli``), bit for bit, on the CPU and on the card.

The JAX package samples MLlib's mini-batches with ``jax.random`` (seed 42,
``twtml_tpu/models/sgd.py`` ``MLLIB_SAMPLING_SEED``), so there is no module of
its own to mirror: this follows jax's threefry implementation in its
partitionable mode (``jax_threefry_partitionable``, on by default): the
counters of a draw of shape S are the row-major flat index of each element
as a 64-bit (hi, lo) pair, and a 32-bit draw is the xor of the two output
words, a 64-bit one their concatenation.

Every 32-bit word is held in an int64 tensor and masked with ``0xFFFFFFFF``
after each add and rotate (torch's uint32 lacks ops on some devices), so
the same code gives the same bits on every device. A key is a pair of
Python ints or of int64 tensors (a batch of keys broadcasts).
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of counter words (x0, x1) under
    key (k0, k1); every argument an int64 tensor or int holding a uint32
    value, broadcast together. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**63: the seed's high
    and low 32-bit words."""
    if not 0 <= seed < 2**63:
        raise ValueError(f"seed must be in [0, 2**63), got {seed}")
    return seed >> 32, seed & MASK32


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: the hash of the counter pair
    (0, data) under ``key``. ``data`` may be an int64 tensor of uint32
    values, giving one key per element."""
    return threefry2x32(key[0], key[1], data * 0, data)


def _counters(shape, device):
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & MASK32


def random_bits(key, bit_width: int, shape, device="cpu"):
    """``jax.random.bits``-style raw draws of ``shape`` (partitionable
    threefry): 32-bit values, or the 64-bit ones as (hi, lo) word pairs.
    A batched key [K] gives [K, *shape]."""
    hi, lo = _counters(tuple(shape), device)
    k0, k1 = key
    if isinstance(k0, torch.Tensor) and k0.dim():
        view = (-1,) + (1,) * len(shape)
        k0, k1 = k0.reshape(view), k1.reshape(view)
    b1, b2 = threefry2x32(k0, k1, hi, lo)
    if bit_width == 32:
        return b1 ^ b2
    if bit_width == 64:
        return b1, b2
    raise ValueError("bit_width must be 32 or 64")


def uniform(key, shape, dtype=torch.float32, device="cpu"):
    """``jax.random.uniform(key, shape, dtype)`` on [0, 1) for float32 or
    float64: the top mantissa bits of a 32- or 64-bit draw over 2**-23 or
    2**-52, which is exactly jax's ``bitcast(bits >> s | one) - 1``."""
    if dtype == torch.float32:
        mant = random_bits(key, 32, shape, device) >> 9
        return mant.to(torch.float32) * 2.0**-23
    if dtype == torch.float64:
        b1, b2 = random_bits(key, 64, shape, device)
        mant = (b1 << 20) | (b2 >> 12)
        return mant.to(torch.float64) * 2.0**-52
    raise ValueError(f"uniform takes float32 or float64, got {dtype}")


def bernoulli(key, p: float, shape, dtype=torch.float32, device="cpu"):
    """``jax.random.bernoulli(key, p, shape)`` (mode 'low'): ``uniform < p``
    in the float type of ``p``, float32 for a Python float, float64 under
    jax's x64 mode. A batched key [K] gives [K, *shape]."""
    p = float(torch.tensor(p, dtype=dtype))  # p in the draw's float type
    return uniform(key, shape, dtype, device) < p
