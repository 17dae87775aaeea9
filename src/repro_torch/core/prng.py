"""Threefry-2x32 counter-based PRNG, bit-compatible with ``jax.random``.

The trainer's key chain (per-iteration ``split``, the per-group pre-sample
``permutation``) and the CNN initialiser (``normal``) must draw the same
bits as the JAX reference so that both CLIs print the same lines from the
same ``--seed``. This module reproduces those calls in numpy, following the
``jax_threefry_partitionable=True`` mode (every output element hashes its
own 64-bit counter ``(hi, lo)`` and ``split`` is fold-like).

Keys are numpy ``uint32`` arrays of shape ``(..., 2)``.
"""
from __future__ import annotations

import math

import numpy as np

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: int) -> np.ndarray:
    """Key from a non-negative integer seed: the 64-bit seed split into
    (high word, low word)."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be >= 0, got {seed}")
    return np.array([(seed >> 32) & _MASK, seed & _MASK], np.uint32)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of counter words (x0, x1)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        a = x0.astype(np.uint32) + ks[0]
        b = x1.astype(np.uint32) + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                a = a + b
                b = _rotl(b, r) ^ a
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def _counters(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(hi, lo) words of a 64-bit iota of length n."""
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), \
        (i & np.uint64(_MASK)).astype(np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split``: (num, 2) new keys."""
    hi, lo = _counters(num)
    b1, b2 = threefry2x32(key, hi, lo)
    return np.stack([b1, b2], axis=-1)


def random_bits(key: np.ndarray, shape: tuple) -> np.ndarray:
    """32 random bits per element: ``jax.random.bits(key, shape, uint32)``."""
    n = math.prod(shape)
    hi, lo = _counters(n)
    b1, b2 = threefry2x32(key, hi, lo)
    return (b1 ^ b2).reshape(shape)


def permutation(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)``: sort-by-random-bits shuffle of
    ``arange(n)``, repeated for ``ceil(3·ln n / ln(2³²−1))`` rounds (one
    round for n ≤ 1625); a stable sort keeps colliding keys in order."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = np.arange(n)
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits(sub, (n,)), kind="stable")]
    return x


def uniform(key: np.ndarray, shape: tuple, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, then scaled into [minval, maxval)."""
    bits = random_bits(key, shape)
    fbits = (bits >> np.uint32(9)) | np.float32(1.0).view(np.uint32)
    floats = fbits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo).astype(np.float32)


# Giles' single-precision erfinv polynomial (the one XLA evaluates), w < 5
# and w >= 5 branches, highest degree first.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: np.ndarray) -> np.ndarray:
    """float32 inverse error function, Giles' polynomial with each Horner
    step fused (one rounding), as XLA computes ``lax.erf_inv``."""
    x = np.asarray(x, np.float32)
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    w64 = w.astype(np.float64)
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = np.where(lt, np.float32(a), np.float32(b)).astype(np.float64)
        p = (c + p.astype(np.float64) * w64).astype(np.float32)
    out = p * x
    return np.where(np.abs(x) == np.float32(1.0), x * np.float32(np.inf), out)


def normal(key: np.ndarray, shape: tuple) -> np.ndarray:
    """``jax.random.normal`` in float32: √2·erfinv(u), u uniform on
    (nextafter(−1, 0), 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * erfinv(u)).astype(np.float32)
