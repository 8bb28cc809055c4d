"""Threefry-2x32 random bits as torch integer ops: the JAX package's
``jax.random`` draws (``PRNGKey``, ``fold_in``, ``random_bits``, ``uniform``,
``bernoulli``), bit for bit, on the CPU and on the card, and ``normal``.

The JAX package samples MLlib's mini-batches with ``jax.random`` (seed 42,
``twtml_tpu/models/sgd.py`` ``MLLIB_SAMPLING_SEED``) and draws the k-means
app's random centers with ``jax.random.normal`` (``twtml_tpu/models/
kmeans.py``), so there is no module of its own to mirror: this follows jax's threefry implementation in its
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

import numpy as np
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


# XLA's single-precision erf_inv (Giles' polynomial, XLA's ``ErfInv32``):
# coefficients for w = -log1p(-x²) < 5 (in w - 2.5) and >= 5 (in √w - 3)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x):
    """erf⁻¹ of a float32 tensor as XLA computes ``lax.erf_inv``: Giles'
    single-precision polynomial, each multiply-add done as one float64
    ``c + p·w`` rounded once to float32 (XLA fuses them into FMAs), and
    log1p in float64 rounded to float32. ±1 give ±inf. On jax's
    ``normal(PRNGKey(0), (3, 2))`` this is bitwise jax's; over 65,536 draws
    about 1 in 100 differs, by at most 3 ulp."""
    f32 = lambda t: t.to(torch.float32)  # noqa: E731
    w = f32(-torch.log1p(-(x * x).double()))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()

    def coef(i):
        return torch.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i]).to(torch.float32).double()

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = f32(coef(i) + p * w).double()
    return torch.where(x.abs() == 1, x * math.inf, f32(p) * x)


def normal(key, shape, device):
    """``jax.random.normal(key, shape)`` in float32 on ``device``: u uniform
    on (nextafter(-1, 0), 1) (jax's ``uniform`` with those bounds: the
    [1, 2) mantissa draw minus 1, scaled and shifted, clamped below), then
    √2·erf⁻¹(u) (``erf_inv``)."""
    bits = random_bits(key, 32, shape, device)
    unit = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    hi_minus_lo = float(np.float32(1.0) - np.float32(lo))
    u = torch.clamp(unit * hi_minus_lo + lo, min=lo)
    return erf_inv(u) * float(np.float32(math.sqrt(2.0)))
