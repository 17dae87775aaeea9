"""Mamba2 chunked SSD scan with a zero initial state (y only).

:func:`ssd_scan` takes x (Bt, S, H, P), dt (Bt, S, H), A (H,), B and C
(Bt, S, N) and returns y (Bt, S, H, P) — the JAX package's
``kernels/ssd_scan/ops.py:ssd_scan``, a drop-in for
``models.ssm.ssd_chunked(...)[0]``. ``chunk = min(chunk, S)`` and S must be
a multiple of it. For CUDA tensors it launches ``csrc/ssd_scan.cu``, the
chunked algorithm with the chunk axis parallel: C·Bᵀ per (batch, chunk),
each chunk's own state per (batch, chunk, head), a pass that carries the
states across chunks, and each chunk's output per (batch, chunk, head), in
f32 FMAs (the same function as the chunked scan up to rounding). For CPU
tensors it runs :func:`ssd_scan_plain`, the port's ``ssd_chunked``. x, B
and C may be strided views (the model passes slices of one projection) as
long as their last axis has unit stride; the wrapper copies one whose
strides the kernel's 16-byte copies cannot take, and pads N to a multiple
of 4 with zero columns.
"""
from __future__ import annotations

import torch

from . import build

NAME = "ssd_scan"
SOURCE = "src/repro_torch/csrc/ssd_scan.cu"
REPLACES = "src/repro/kernels/ssd_scan/kernel.py:62 (ssd_scan_kernel)"
LAUNCHES = 0

MAX_CHUNK = 128                 # the kernel pads every chunk to 128 rows
P_BLOCK = 32                    # P must be a multiple of the CTA's columns
MAX_STATE = 256                 # N: at most 4 row tiles of the state kernel
PARTS = ("gram", "state", "pass", "scan")   # the launches, in order
ALL_PARTS = (1 << len(PARTS)) - 1

# The shapes the kernel is held to its plain version at, (Bt, S, H, P, N,
# chunk): chunk 64 and 128, N in {16, 64, 100, 128, 256}, P in {32, 64},
# one chunk (S = Q), chunks shorter than the kernel's 128 rows (S = 96, 64,
# 8), several chunks of 128, many chunks (S = 4096: 32 chunks), Bt > 1 with
# an odd H, N = MAX_STATE, and chunk 64 with S not a multiple of 128
# (A near 0, states that barely decay, is the gpu test's extra case)
SWEEP = [(1, 128, 2, 32, 16, 64), (2, 256, 4, 64, 32, 128),
         (1, 512, 8, 32, 64, 128), (2, 256, 3, 64, 128, 64),
         (1, 128, 4, 64, 128, 128), (2, 96, 2, 32, 16, 128),
         (1, 64, 4, 32, 64, 64), (1, 8, 2, 64, 64, 128),
         (1, 1024, 2, 64, 100, 128), (1, 4096, 2, 64, 64, 128),
         (3, 512, 5, 64, 32, 128), (2, 384, 2, 32, 256, 128),
         (1, 320, 3, 64, 128, 64)]


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
    build.library()
    call = prepare(x, dt, A, B, C, chunk)
    run(call)
    global LAUNCHES
    LAUNCHES += 1
    return call["y"]


def plan(bt: int, s: int, h: int, p: int, n: int, chunk: int) -> dict:
    """The kernel's layout for one call: the state width it runs at (N
    padded to 4), the chunk count, the scratch buffers' sizes in floats
    (G per (batch, chunk) of 128 x 128, the states per (batch, chunk,
    head), the chunk decays) and each launch's CTAs (``csrc/ssd_scan.cu``
    computes the same grids; the state and pass launches are skipped for
    one chunk)."""
    n4 = -(-n // 4) * 4
    nc = s // chunk
    pt = 64 if p % 64 == 0 else 32
    rows = 128 if n4 > 64 else 64
    return {"n": n4, "chunks": nc,
            "gram": bt * nc * MAX_CHUNK * MAX_CHUNK,
            "states": bt * nc * h * n4 * p, "decay": bt * nc * h,
            "ctas": {"gram": bt * nc * (3 if chunk > 64 else 1),
                     "state": bt * (nc - 1) * h * -(-n4 // rows) * (p // pt),
                     "pass": bt * h * -(-(n4 * p // 4) // 256)
                     if nc > 1 else 0,
                     "scan": bt * nc * h * (p // pt)}}


def check_inputs(x, dt, A, B, C, chunk: int) -> None:
    """Raise ValueError on what the kernel does not take: a shape or type
    other than the plain version's, P not a multiple of 32, N above 256, a
    chunk above 128 or not dividing S, or a last axis of x, B, C without
    unit stride."""
    bt, s, h, p = x.shape
    n = B.shape[-1]
    if p % P_BLOCK or p == 0 or n > MAX_STATE or chunk > MAX_CHUNK \
            or s % chunk:
        raise ValueError(f"ssd_scan: P={p}, N={n}, chunk={chunk} "
                         f"unsupported (need P a multiple of {P_BLOCK}, "
                         f"N <= {MAX_STATE}, chunk <= {MAX_CHUNK} dividing "
                         f"S={s})")
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


def vector_ready(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` (..., n) as the kernel's 16-byte copies read it: the last axis
    zero-padded to ``width`` (a multiple of 4), the other strides multiples
    of 4 elements and the data 16-byte aligned; a copy only where ``t``
    is not so already."""
    if t.shape[-1] != width:
        return torch.nn.functional.pad(t, (0, width - t.shape[-1]))
    if t.data_ptr() % 16 or any(st % 4 for st in t.stride()[:-1]):
        return t.clone(memory_format=torch.contiguous_format)
    return t


def prepare(x, dt, A, B, C, chunk: int) -> dict:
    """Check the inputs and allocate y and the scratch of one call: the
    arguments of :func:`run`."""
    check_inputs(x, dt, A, B, C, chunk)
    bt, s, h, p = x.shape
    lay = plan(bt, s, h, p, B.shape[-1], chunk)
    x = vector_ready(x, p)
    B, C = vector_ready(B, lay["n"]), vector_ready(C, lay["n"])
    scratch = {k: torch.empty(lay[k], dtype=torch.float32, device=x.device)
               for k in ("gram", "states", "decay")}
    y = torch.empty(bt, s, h, p, dtype=torch.float32, device=x.device)
    return dict(x=x, dt=dt, A=A, B=B, C=C, y=y, chunk=chunk, n=lay["n"],
                **scratch)


def run(call: dict, parts: int = ALL_PARTS) -> None:
    """Launch ``csrc/ssd_scan.cu`` on a :func:`prepare`d call: every launch
    (the scan), or the launches whose bits are set in ``parts`` (bit i:
    ``PARTS[i]``; one alone times that launch, on buffers an earlier full
    run left)."""
    x, dt, B, C = call["x"], call["dt"], call["B"], call["C"]
    bt, s, h, p = x.shape
    err = build.library().ssd_scan_f32(
        x.data_ptr(), dt.data_ptr(), call["A"].data_ptr(), B.data_ptr(),
        C.data_ptr(), call["gram"].data_ptr(), call["states"].data_ptr(),
        call["decay"].data_ptr(), call["y"].data_ptr(), bt, s, h, p,
        call["n"], call["chunk"], parts, *x.stride()[:3], *dt.stride(),
        *B.stride()[:2], *C.stride()[:2], build.stream(x))
    build.check(err, NAME)
