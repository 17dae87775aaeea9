"""Stochastic int8 quantization of the rows of a flat (M, P) buffer, each
row under its own threefry key (DESIGN.md §18.1).

:func:`quantize` is the CUDA kernel ``csrc/int8_quant.cu`` (one launch
that reads x once: each row's NaN-propagating max-abs scale behind a grid
barrier, then threefry-2x32 of the counters of the coordinates whose draw
can change their output, and the stochastic rounding) for CUDA tensors and
:func:`quantize_plain` for CPU tensors. Both give, bit for bit, what the
JAX package's ``core.compress.int8_quantize(row, key)`` computes on each
row under ``jit``, as every JAX path calls it: XLA turns its division by
the constant 127 into a multiply by the float32 reciprocal 1/127, and so
does the port (op by op, un-jitted, JAX divides instead, and the scale
then differs by an ulp in a few rows in a hundred). There is no Pallas
kernel behind it: the kernel is the port's own.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import prng
from . import build

NAME = "int8_quant"
SOURCE = "src/repro_torch/csrc/int8_quant.cu"
REPLACES = ("none: jnp src/repro/core/compress.py:131 (int8_quantize) and "
            "its jax.random.bernoulli draw")
LAUNCHES = 0

INV_127 = float(np.float32(1.0) / np.float32(127.0))   # 0x3c010204


def _key_tensor(keys, m: int, device) -> torch.Tensor:
    """Keys (M, 2) as an int64 tensor of uint32 words on ``device``: a
    tensor is taken as it is (no host copy, so a CUDA graph can capture the
    call), a numpy array is copied once."""
    if not isinstance(keys, torch.Tensor):
        keys = torch.as_tensor(np.asarray(keys, np.uint32).astype(np.int64),
                               device=device)
    if tuple(keys.shape) != (m, 2):
        raise ValueError(f"int8_quant: keys of shape {tuple(keys.shape)}, "
                         f"expected ({m}, 2)")
    return keys


def quantize_plain(x: torch.Tensor, keys) -> torch.Tensor:
    """Plain version of the kernel: x (M, P), keys (M, 2) uint32 words
    (numpy, or an int64 tensor on x's device) → (M, P) = clamp(floor(x/s) +
    (u < x/s − floor(x/s)), −127, 127)·s per row, s = max(max|x|·(1/127),
    1e-30), u the row key's ``uniform`` draw."""
    keys = _key_tensor(keys, x.shape[0], x.device)
    return round_rows(x, prng.uniform_t(keys, (x.shape[1],)))


def round_rows(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """:func:`quantize_plain`'s arithmetic on given uniforms u (M, P) in
    [0, 1). A coordinate with ``!(y − floor(y) > 0)`` (a zero, an integer
    y, a NaN y) comes out the same whatever its u: the kernel skips its
    hash."""
    scale = torch.clamp_min(x.abs().amax(dim=1, keepdim=True) * INV_127,
                            1e-30)
    y = x / scale
    lo = torch.floor(y)
    q = lo + (u < y - lo).float()
    return torch.clamp(q, -127.0, 127.0) * scale


def quantize(x: torch.Tensor, keys) -> torch.Tensor:
    """Stochastic int8 of each row of x (M, P) under keys (M, 2) uint32
    words — numpy, or an int64 tensor on x's device, which the call reads
    in place — dequantized: kernel on the card (P % 4 == 0), plain on
    CPU."""
    m, p = x.shape
    keys = _key_tensor(keys, m, x.device)
    build.refuse_grad(NAME, x)
    if x.device.type == "cpu":
        return quantize_plain(x, keys)
    lib = build.library()
    if p % 4 or p == 0 or p >= 2 ** 32 or m > 65535:
        raise ValueError(f"int8_quant: unsupported M={m}, P={p} (need "
                         "P % 4 == 0, 0 < P < 2^32, M <= 65535)")
    build.require(x, "x", (m, p), torch.float32, align=16)
    kt = keys.to(torch.int32).contiguous()   # the words' bits, wrapped
    out = torch.empty_like(x)
    # each row's max bits, then the kernel's row barrier (zeroed there)
    rowmax = torch.empty(m + 1, dtype=torch.int32, device=x.device)
    err = lib.int8_quant_f32(x.data_ptr(), kt.data_ptr(), out.data_ptr(),
                             rowmax.data_ptr(), m, p, build.stream(x))
    build.check(err, NAME)
    global LAUNCHES
    LAUNCHES += 1
    return out
