"""Threefry-2x32 counter-based PRNG, bit-compatible with ``jax.random``.

The trainer's key chain (per-iteration ``split``, the per-group pre-sample
``permutation``), the CNN initialiser (``normal``), the fault trace of
DESIGN.md §15 (``fold_in``, ``bernoulli``, ``randint``, per-member
``normal`` noise) and the drift schedules of §13 (the same hashes, and
``loggamma``/``dirichlet`` by JAX's rejection loops) must draw the same
bits as the JAX reference so that both CLIs print the same lines from the
same ``--seed``. This module
reproduces those calls in numpy (keys, bits) and PyTorch (the float
transforms, and the ``*_t`` tensor forms, which draw on the run's
device), following the ``jax_threefry_partitionable=True`` mode (every
output element hashes its own 64-bit counter ``(hi, lo)`` and ``split``
is fold-like).

Keys are numpy ``uint32`` arrays of shape ``(..., 2)``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

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
    """The Threefry-2x32 hash (20 rounds) of counter words (x0, x1). A
    batch of keys (..., 2) broadcasts against the counters."""
    key = np.asarray(key, np.uint32)
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        a = np.asarray(x0, np.uint32) + ks[0]
        b = np.asarray(x1, np.uint32) + ks[1]
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
    """``jax.random.split``: (..., num, 2) new keys of a key (..., 2)."""
    hi, lo = _counters(num)
    b1, b2 = threefry2x32(np.asarray(key)[..., None, :], hi, lo)
    return np.stack([b1, b2], axis=-1)


def fold_in(key: np.ndarray, data) -> np.ndarray:
    """``jax.random.fold_in``: the hash of the counter words (0, data) under
    ``key``. ``key`` (..., 2) and integer ``data`` broadcast."""
    d = np.asarray(data).astype(np.int64) & _MASK
    b1, b2 = threefry2x32(key, np.zeros_like(d), d)
    return np.stack([b1, b2], axis=-1)


def random_bits(key: np.ndarray, shape: tuple) -> np.ndarray:
    """32 random bits per element: ``jax.random.bits(key, shape, uint32)``;
    a batch of keys (..., 2) gives (..., *shape)."""
    key = np.asarray(key, np.uint32)
    hi, lo = _counters(math.prod(shape))
    b1, b2 = threefry2x32(key[..., None, :], hi, lo)
    return (b1 ^ b2).reshape(key.shape[:-1] + tuple(shape))


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


def bernoulli(key: np.ndarray, p: float, shape: tuple = ()) -> np.ndarray:
    """``jax.random.bernoulli``: ``uniform(key, shape) < p`` in float32."""
    return uniform(key, shape) < np.float32(p)


def randint(key: np.ndarray, shape: tuple, minval: int, maxval: int
            ) -> np.ndarray:
    """``jax.random.randint`` for int32: 64 random bits per element from two
    split keys, reduced modulo the span in uint32 arithmetic (jax's
    higher/lower-bits scheme, biased when the span is not a power of 2)."""
    s = split(key)
    higher = random_bits(s[..., 0, :], shape).astype(np.uint64)
    lower = random_bits(s[..., 1, :], shape).astype(np.uint64)
    span = np.uint64(maxval - minval if maxval > minval else 1)
    mult = np.uint64(2 ** 16) % span
    mult = (mult * mult & np.uint64(_MASK)) % span
    off = ((higher % span) * mult & np.uint64(_MASK)) + lower % span
    off = (off & np.uint64(_MASK)) % span
    return (minval + off.astype(np.int64)).astype(np.int32)


# Giles' single-precision erfinv polynomial (the one XLA evaluates), w < 5
# and w >= 5 branches, highest degree first.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, Giles' polynomial with each Horner
    step fused (one rounding), as XLA computes ``lax.erf_inv``."""
    x = x.float()
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w64 = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).float()
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, float(np.float32(a)), float(np.float32(b)))
        p = (c.double() + p.double() * w64).float()
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_NORMAL_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))


def _uniform_from_bits(bits: torch.Tensor, minval: float, maxval: float
                       ) -> torch.Tensor:
    """:func:`uniform`'s float transform of 32-bit words held in int64:
    23 mantissa bits under 1.0's exponent, minus 1, scaled in float32."""
    lo, hi = np.float32(minval), np.float32(maxval)
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(u * float(hi - lo) + float(lo), float(lo))


def _normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """√2·erfinv(u), u uniform on (nextafter(−1, 0), 1) — ``jax.random.
    normal``."""
    return float(np.float32(np.sqrt(2))) * erfinv(
        _uniform_from_bits(bits, _NORMAL_LO, 1.0))


def normal(key: np.ndarray, shape: tuple) -> np.ndarray:
    """``jax.random.normal`` in float32 (host form)."""
    bits = torch.from_numpy(random_bits(key, shape).astype(np.int64))
    return _normal_from_bits(bits).numpy()


def threefry2x32_t(key, x0, x1: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`threefry2x32` on tensors: uint32 words held in int64 tensors
    (masked to 32 bits after every add and shift), on their device. A
    numpy batch of keys (..., 2) hashes the counters (n,) under each key:
    (..., n); an int64 tensor of keys (..., 2) gives each counter its own
    key, broadcasting."""
    if not isinstance(key, torch.Tensor):
        key = torch.as_tensor(np.asarray(key, np.int64)[..., None, :],
                              device=x1.device)
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    a = (x0 + ks[0]) & _MASK
    b = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & _MASK
            b = (((b << r) & _MASK) | (b >> (32 - r))) ^ a
        a = (a + ks[(i + 1) % 3]) & _MASK
        b = (b + ks[(i + 2) % 3] + i + 1) & _MASK
    return a, b


def random_bits_t(key, shape: tuple, device=None) -> torch.Tensor:
    """:func:`random_bits` drawn on the device (the words in int64): the
    counters and the threefry rounds run there, so a draw of millions of
    numbers never passes through the host. ``key`` is a numpy key (drawn on
    ``device``) or an int64 tensor of keys (drawn on its device, with no
    copy from the host: the form a CUDA graph captures); a batch of keys
    (..., 2) draws (..., *shape) in one pass."""
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise ValueError(f"random_bits_t: {n} elements need 64-bit counters")
    if isinstance(key, torch.Tensor):
        device, lead, key = key.device, tuple(key.shape[:-1]), key[..., None, :]
    else:
        lead = np.shape(key)[:-1]
    b1, b2 = threefry2x32_t(key, 0, torch.arange(n, dtype=torch.int64,
                                                 device=device))
    return (b1 ^ b2).reshape(lead + tuple(shape))


def fold_in_t(key, data) -> torch.Tensor:
    """:func:`fold_in` on the device: ``key`` an int64 tensor of keys
    (..., 2) or a numpy key (moved to ``data``'s device), ``data`` an
    integer tensor (or int) broadcasting against the keys → (..., 2)."""
    if not isinstance(key, torch.Tensor):
        key = torch.as_tensor(np.asarray(key, np.int64), device=data.device)
    b1, b2 = threefry2x32_t(key, 0, data & _MASK)
    return torch.stack([b1, b2], dim=-1)


def split_t(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """:func:`split` of an int64 tensor of keys (..., 2) on its device:
    (..., num, 2)."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32_t(key[..., None, :], 0, lo)
    return torch.stack([b1, b2], dim=-1)


def uniform_t(key, shape: tuple, device=None, minval: float = 0.0,
              maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` drawn on the device (a numpy key on
    ``device``, a key tensor on its own); same numbers as :func:`uniform`."""
    return _uniform_from_bits(random_bits_t(key, shape, device), minval,
                              maxval)


def normal_t(key, shape: tuple, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` drawn on the device (a numpy key
    on ``device``, a key tensor on its own); same numbers as
    :func:`normal`."""
    return _normal_from_bits(random_bits_t(key, shape, device))


def _scalar_t(draw, keys: torch.Tensor) -> torch.Tensor:
    """One ``shape=()`` draw per key of an int64 key tensor (..., 2)."""
    return draw(random_bits_t(keys, ()))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a·b + c with one rounding (the product and the sum in
    float64, which holds the product exactly)."""
    return (a.double() * b + c).float()


def exponential_t(keys: torch.Tensor) -> torch.Tensor:
    """``jax.random.exponential(key, ())`` per key of an int64 key tensor
    (..., 2): −log1p(−u)."""
    u = _scalar_t(lambda b: _uniform_from_bits(b, 0.0, 1.0), keys)
    return -torch.log1p(-u)


_THIRD = float(np.float32(1.0 / 3.0))
_SQUEEZE = float(np.float32(0.0331))


def loggamma_t(keys: torch.Tensor, alpha: torch.Tensor,
               stats: dict | None = None) -> torch.Tensor:
    """``jax.random.loggamma`` of one element per key: keys (N, 2) int64
    words (each element's own key, as ``_gamma_impl`` splits them), alpha
    (N,) float32 → (N,) float32 log Gamma(α) samples.

    Marsaglia–Tsang in log space as ``jax._src.random._gamma_one`` runs
    it: ``key, subkey = split(key)``; while the (X, V, U) state rejects,
    ``key, x_key, U_key = split(key, 3)`` and the inner loop redraws
    ``normal`` (``x_key, sub = split(x_key)``) until v = 1 + x·c > 0; then
    log d + log V plus, for α < 1, the boost log1p(−u)·(1/α) from
    ``subkey``'s exponential. The loops run vectorised over the elements,
    each while any element is active (one host read per pass: this form
    is the plain version, the card runs ``kernels.dirichlet``). The
    multiply-adds are single roundings, as XLA on the CPU contracts them;
    ``log`` and ``log1p`` are PyTorch's, so a result can differ from JAX's
    in its last bits (tests/test_torch_drift.py states by how much).
    ``stats``, if given, accumulates the work the draw took: ``elements``,
    outer ``passes`` and inner normal ``draws``, summed over elements."""
    alpha = alpha.float()
    n = alpha.shape[0]
    boost = alpha >= 1.0
    a = torch.where(boost, alpha, alpha + 1.0)
    d = a - _THIRD
    c = torch.full_like(d, _THIRD) / torch.sqrt(d)
    ks = split_t(keys)
    key, sub = ks[:, 0].clone(), ks[:, 1]
    X = torch.zeros(n, device=alpha.device)
    V = torch.ones(n, device=alpha.device)
    U = torch.full((n,), 2.0, device=alpha.device)
    one = torch.ones((), dtype=torch.float64, device=alpha.device)

    def rejects(X, V, U, d):
        return (U >= _fma(X * X, -_SQUEEZE, one)) & (
            torch.log(U) >= _fma(X, 0.5, (d * ((1.0 - V) + torch.log(V)))
                                 .double()))

    active = rejects(X, V, U, d)
    work = {"elements": n, "passes": 0, "draws": 0}
    while bool(active.any()):
        idx = torch.nonzero(active).flatten()
        work["passes"] += idx.numel()
        k3 = split_t(key[idx], 3)
        key[idx] = k3[:, 0]
        x_key, u_key = k3[:, 1].clone(), k3[:, 2]
        ci = c[idx].double()
        x = torch.zeros(idx.numel(), device=alpha.device)
        v = torch.full((idx.numel(),), -1.0, device=alpha.device)
        redraw = v <= 0
        while bool(redraw.any()):
            j = torch.nonzero(redraw).flatten()
            work["draws"] += j.numel()
            k2 = split_t(x_key[j])
            x_key[j] = k2[:, 0]
            xj = _scalar_t(_normal_from_bits, k2[:, 1])
            x[j] = xj
            v[j] = _fma(xj, ci[j], one)
            redraw = v <= 0
        X[idx] = x * x
        V[idx] = (v * v) * v
        U[idx] = _scalar_t(lambda b: _uniform_from_bits(b, 0.0, 1.0), u_key)
        active = torch.zeros_like(active)
        active[idx] = rejects(X[idx], V[idx], U[idx], d[idx])
    if stats is not None:
        for name, v in work.items():
            stats[name] = stats.get(name, 0) + v
    log_u = -exponential_t(sub)
    log_boost = torch.where(boost | (log_u == 0), 0.0,
                            log_u * (torch.ones_like(alpha) / alpha))
    return torch.log(d) + torch.log(V) + log_boost


def softmax_rows(x: torch.Tensor) -> torch.Tensor:
    """Row softmax of (R, F), F <= 64, in the order the ``dirichlet_rows``
    kernel sums: exp(x − max), the row padded to 64 with zeros and its
    halves added until one column is left (a warp's butterfly), then each
    element divided by that sum."""
    r, f = x.shape
    if f > 64:
        raise ValueError(f"softmax_rows: {f} > 64 columns")
    e = torch.exp(x - x.max(dim=1, keepdim=True).values)
    s = torch.nn.functional.pad(e, (0, 64 - f))
    while s.shape[1] > 1:
        h = s.shape[1] // 2
        s = s[:, :h] + s[:, h:]
    return e / s


def dirichlet_t(keys: torch.Tensor, alpha, f: int,
                stats: dict | None = None) -> torch.Tensor:
    """``jax.random.dirichlet(key, alpha)`` per row key: keys (R, 2) int64
    words → (R, f) float32 rows, the row softmax (:func:`softmax_rows`)
    of ``loggamma_t`` (and its ``stats``) over each row's ``split(key,
    f)``. ``alpha`` is a float (``full((f,), alpha)`` for every row) or an
    (R, f) float32 tensor, each row's own concentrations."""
    ek = split_t(keys, f).reshape(-1, 2)
    if isinstance(alpha, torch.Tensor):
        a = alpha.float().reshape(-1)
    else:
        a = torch.full((ek.shape[0],), float(np.float32(alpha)),
                       device=keys.device)
    return softmax_rows(loggamma_t(ek, a, stats).reshape(-1, f))


def normal_segments_t(keys, sizes: list[int], device) -> torch.Tensor:
    """Rows of concatenated draws in one pass on ``device``: keys (R, S, 2)
    (numpy uint32 words, or an int64 tensor of them on ``device``) →
    (R, Σ sizes), row r being ``normal(keys[r, s], (sizes[s],))`` for
    s = 0, 1, … side by side — one draw per (member, leaf) of a gradient
    stack without a pass per leaf."""
    n = torch.as_tensor(sizes, device=device)
    seg = torch.repeat_interleave(torch.arange(len(sizes), device=device), n)
    counters = torch.arange(seg.numel(), device=device) - \
        (torch.cumsum(n, 0) - n)[seg]
    if not isinstance(keys, torch.Tensor):
        keys = torch.as_tensor(np.asarray(keys, np.int64), device=device)
    key = keys[:, seg]
    b1, b2 = threefry2x32_t(key, 0, counters)
    return _normal_from_bits(b1 ^ b2)
