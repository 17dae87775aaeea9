"""Mamba2 chunked SSD scan with a zero initial state (y only).

:func:`ssd_scan` takes x (Bt, S, H, P), dt (Bt, S, H), A (H,), B and C
(Bt, S, N) and returns y (Bt, S, H, P) — the JAX package's
``kernels/ssd_scan/ops.py:ssd_scan``, a drop-in for
``models.ssm.ssd_chunked(...)[0]``. ``chunk = min(chunk, S)`` and S must be
a multiple of it. For CUDA tensors it launches ``csrc/ssd_scan.cu``: C·Bᵀ
once per (batch, block of at most 64 steps of a chunk) into a scratch
buffer, then one CTA per (batch, head, 32 columns of P) walking the blocks
with its slice of the state in shared memory, in f32 FMAs (the same
function as the chunked scan up to rounding). For CPU tensors it runs
:func:`ssd_scan_plain`, the port's ``ssd_chunked``. x, B and C may be
strided views (the model passes slices of one projection) as long as
their last axis has unit stride.
"""
from __future__ import annotations

import torch

from . import build

NAME = "ssd_scan"
SOURCE = "src/repro_torch/csrc/ssd_scan.cu"
REPLACES = "src/repro/kernels/ssd_scan/kernel.py:62 (ssd_scan_kernel)"
LAUNCHES = 0

MAX_CHUNK = 128
BLOCK = 64                      # the kernel walks a chunk in blocks of 64
P_BLOCK = 32                    # P must be a multiple of the CTA's columns
MAX_STATE = 256                 # N: the state must fit in shared memory

# The shapes the kernel is held to its plain version at, (Bt, S, H, P, N,
# chunk): chunk 64 and 128, N in {16, 64, 100, 128}, P in {32, 64}, one
# chunk (S = Q), chunks shorter than a 64-row block (S = 96, 64, 8) and
# several chunks of 128
SWEEP = [(1, 128, 2, 32, 16, 64), (2, 256, 4, 64, 32, 128),
         (1, 512, 8, 32, 64, 128), (2, 256, 3, 64, 128, 64),
         (1, 128, 4, 64, 128, 128), (2, 96, 2, 32, 16, 128),
         (1, 64, 4, 32, 64, 64), (1, 8, 2, 64, 64, 128),
         (1, 1024, 2, 64, 100, 128)]


def example_inputs(gen: torch.Generator, bt: int, s: int, h: int, p: int,
                   n: int, A: torch.Tensor | None = None):
    """(x, dt, A, B, C) on ``gen``'s device in the model's layout: x, B and
    C column slices of one projection (strided views), dt a softplus, and A
    by default -exp(A_log) = -(1, ..., H) as ``init_mamba_block`` sets it."""
    dev = gen.device
    proj = torch.randn(bt, s, h * p + 2 * n, generator=gen, device=dev)
    x = proj[..., :h * p].reshape(bt, s, h, p)
    B, C = proj[..., h * p:h * p + n], proj[..., h * p + n:]
    dt = torch.nn.functional.softplus(
        torch.randn(bt, s, h, generator=gen, device=dev))
    if A is None:
        A = -torch.arange(1, h + 1, dtype=torch.float32, device=dev)
    return x, dt, A, B, C


def ssd_scan_plain(x, dt, A, B, C, *, chunk: int = 128) -> torch.Tensor:
    """Plain version: ``models.ssm.ssd_chunked(x, dt, A, B, C,
    min(chunk, S))[0]``."""
    from ..models.ssm import ssd_chunked
    return ssd_chunked(x, dt, A, B, C, min(chunk, x.shape[1]))[0]


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128
             ) -> torch.Tensor:
    """y (Bt, S, H, P) of the SSD scan from a zero state: the kernel for
    CUDA tensors, :func:`ssd_scan_plain` for CPU tensors."""
    s = x.shape[1]
    chunk = min(chunk, s)
    if chunk < 1 or s % chunk:
        raise ValueError(f"ssd_scan: S={s} must be a multiple of "
                         f"chunk={chunk}")
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    return _launch(x, dt, A, B, C, chunk)


def _launch(x, dt, A, B, C, chunk: int) -> torch.Tensor:
    lib = build.library()
    bt, s, h, p = x.shape
    n = B.shape[-1]
    if p % P_BLOCK or p == 0 or n > MAX_STATE or chunk > MAX_CHUNK:
        raise ValueError(f"ssd_scan: P={p}, N={n}, chunk={chunk} "
                         f"unsupported (need P a multiple of {P_BLOCK}, "
                         f"N <= {MAX_STATE}, chunk <= {MAX_CHUNK})")
    shapes = {"x": (x, (bt, s, h, p)), "dt": (dt, (bt, s, h)),
              "A": (A, (h,)), "B": (B, (bt, s, n)), "C": (C, (bt, s, n))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != x.device:
            raise ValueError(f"ssd_scan: {name} is {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}; want {shape} "
                             f"float32 on {x.device}")
    if x.stride(3) != 1 or B.stride(2) != 1 or C.stride(2) != 1 \
            or not A.is_contiguous():
        raise ValueError("ssd_scan: x, B and C need unit stride in their "
                         "last axis, A a contiguous tensor")
    blocks = s // chunk * -(-chunk // BLOCK)
    gram = torch.empty(bt * blocks * BLOCK * BLOCK, dtype=torch.float32,
                       device=x.device)
    y = torch.empty(bt, s, h, p, dtype=torch.float32, device=x.device)
    err = lib.ssd_scan_f32(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), gram.data_ptr(), y.data_ptr(), bt, s, h, p, n, chunk,
        *x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2],
        build.stream(x))
    build.check(err, NAME)
    global LAUNCHES
    LAUNCHES += 1
    return y
