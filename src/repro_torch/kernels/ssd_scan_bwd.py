"""The gradient of the SSD scan: ``csrc/ssd_scan_bwd.cu`` behind
``kernels.ssd_scan.ssd_scan``'s autograd function.

:func:`backward` takes what the forward launch left (the prepared x, dt, A,
B, C with N padded to a multiple of 4, and the states buffer whose slot c
holds the state entering chunk c) and dy, and returns (dx, ddt, dA, dB, dC),
dB and dC at the padded width. It replaces no TPU kernel: the JAX package
differentiates the jnp ``ssd_chunked`` with XLA, and this is the VJP of the
kernel that the port runs in its place. :func:`backward_plain` is autograd
through ``ssd_scan_plain``, the version the kernel is held to on the card;
on the CPU the wrapper's autograd runs through the plain forward itself, so
nothing here is called there.
"""
from __future__ import annotations

import torch

from . import build

NAME = "ssd_scan_bwd"
SOURCE = "src/repro_torch/csrc/ssd_scan_bwd.cu"
REPLACES = ("none: the VJP that XLA derives for the jnp ssd_chunked "
            "(src/repro/models/ssm.py:57), which the JAX package trains "
            "through")
LAUNCHES = 0

TILE = 64                       # output tile of the product launches
PASS_THREADS = 256              # float4s of the state per reverse-pass CTA


SCRATCH = ("gm", "eb", "gs", "dec", "trp", "trow", "tcol", "xdd", "xin",
           "yo", "dap")           # in the C entry point's order
F64 = ("trow", "tcol")           # f64 buffers; the rest are f32


def plan(bt: int, s: int, h: int, p: int, n4: int, chunk: int) -> dict:
    """Elements of each scratch buffer of one call (``csrc/ssd_scan_bwd.cu``
    sizes them the same way): the Gram matrix and E per (batch, chunk) of
    128 x 128, the state gradients per (batch, chunk, head), the chunk
    decays, the trace shares per reverse-pass CTA, each row's and column's
    sums of the causal term per 64 rows or columns of the chunk, each
    row's x . dxd, x . dxd' and dy . y_inter per 64 columns of P, and each
    chunk's share of dA."""
    nc = s // chunk
    nblk = -(-(n4 * p // 4) // PASS_THREADS)
    rows = bt * s * h
    return {"gm": bt * nc * 128 * 128, "eb": bt * nc * 128 * 128,
            "gs": bt * nc * h * n4 * p, "dec": bt * nc * h,
            "trp": bt * nc * h * nblk,
            **{k: rows * -(-chunk // TILE) for k in F64},
            **{k: rows * -(-p // TILE) for k in ("xdd", "xin", "yo")},
            "dap": bt * nc * h}


def backward(x, dt, A, B, C, states, dy, chunk: int):
    """(dx, ddt, dA, dB, dC) of the scan from dy, by the kernel: x, dt, A,
    B, C and states as the forward launch left them (B and C N-padded, the
    strides the forward took), dy of y's shape."""
    bt, s, h, p = x.shape
    n4 = B.shape[-1]
    dy = dy.contiguous()
    if tuple(dy.shape) != (bt, s, h, p) or dy.dtype != torch.float32 \
            or dy.device != x.device:
        raise ValueError(f"ssd_scan backward: dy {tuple(dy.shape)} "
                         f"{dy.dtype} on {dy.device}; want {(bt, s, h, p)} "
                         f"float32 on {x.device}")
    dev = x.device
    scratch = {k: torch.empty(v, dtype=torch.float64 if k in F64
                              else torch.float32, device=dev)
               for k, v in plan(bt, s, h, p, n4, chunk).items()}
    dx = torch.empty(bt, s, h, p, dtype=torch.float32, device=dev)
    ddt = torch.empty(bt, s, h, dtype=torch.float32, device=dev)
    dA = torch.empty(h, dtype=torch.float32, device=dev)
    dB = torch.empty(bt, s, n4, dtype=torch.float32, device=dev)
    dC = torch.empty(bt, s, n4, dtype=torch.float32, device=dev)
    err = build.library().ssd_scan_bwd_f32(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), states.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        *(scratch[k].data_ptr() for k in SCRATCH),
        bt, s, h, p, n4, chunk, *x.stride()[:3], *dt.stride(),
        *B.stride()[:2], *C.stride()[:2], build.stream(x))
    build.check(err, NAME)
    global LAUNCHES
    LAUNCHES += 1
    return dx, ddt, dA, dB, dC


def backward_plain(x, dt, A, B, C, dy, *, chunk: int = 128):
    """Plain version: (dx, ddt, dA, dB, dC) by autograd through
    ``ssd_scan_plain`` (the port's ``ssd_chunked``) on the same inputs."""
    from .ssd_scan import ssd_scan_plain
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, dt, A, B, C)]
        out = ssd_scan_plain(*ins, chunk=chunk)
        return torch.autograd.grad(out, ins, dy)
