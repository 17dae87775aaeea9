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

:func:`plan` is the call's layout on the host: how many heads each CTA of
the Gram launch and of the dB/dC launch takes (so that each grid has about
``TARGET_CTAS`` CTAs), the scratch buffers' sizes and each launch's grid;
the C entry point computes the same grids from the two group sizes it is
given.
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

ROWS = 128                      # rows of a chunk, padded
TILE = 64                       # output tile of the product launches
PASS_THREADS = 256              # float4s of the state per reverse-pass CTA
PASS_WARPS = PASS_THREADS // 32
SMS = 132                       # the H100's streaming multiprocessors
TARGET_CTAS = 4 * SMS           # the head groups fill the card this far

# Backward shapes (Bt, S, H, P, N, chunk) beside ``ssd_scan.SWEEP``: head
# groups that do not divide H in both grouped launches (H = 7: Gram groups
# of 3, 3, 1 and dB/dC groups of 2, 2, 2, 1; H = 11 at P = 32: 4, 4, 3 in
# both)
EDGES = [(1, 4096, 7, 64, 64, 128), (2, 2048, 11, 32, 128, 128)]

PARTS = ("prep", "gram", "dstate", "yinter", "pass", "dxd", "dbc", "dt",
         "intra")
ALL_PARTS = (1 << len(PARTS)) - 1
# scratch buffers in the C entry point's order; f64 where named in F64
SCRATCH = ("cum", "ein", "eo", "dtp", "dec", "gm", "eg", "gs", "trp",
           "trow", "tcol", "xdd", "xin", "yo", "dap", "part")
F64 = ("cum", "trow", "tcol")


def head_group(h: int, ctas: int) -> int:
    """Heads per CTA of a launch whose grid has ``ctas`` CTAs with every
    head in one: the most that still give about ``TARGET_CTAS`` CTAs (one
    head each where even that falls short; all of them where ``ctas``
    reaches it alone)."""
    groups = min(h, max(1, -(-TARGET_CTAS // ctas)))
    return -(-h // groups)


def plan(bt: int, s: int, h: int, p: int, n4: int, chunk: int) -> dict:
    """The layout of one call: ``hg`` and ``hk``, the heads per CTA of the
    Gram launch (``groups_gram`` groups) and of the dB/dC launch
    (``groups_dbc``); ``scratch``, elements of each buffer (the f64
    cumsums and the f32 factor tables per (batch, chunk, head) row of 128,
    the chunk decays, C·Bᵀ and each Gram group's E per (batch, chunk) of
    128 x 128, the state gradients per (batch, chunk, head), the trace
    shares per reverse-pass warp, each row's and column's sums of the
    causal term per 32 columns or 64 rows of the chunk, each row's x·dxd,
    x·dxd' and dy·y_inter per 64 columns of P, each chunk's share of dA,
    and each dB/dC head group's inter part);
    ``ctas``, each launch's grid."""
    nc = s // chunk
    qt, pt, nt = -(-chunk // TILE), -(-p // TILE), -(-n4 // TILE)
    tiles = 6 if chunk > TILE else 2     # Gram tiles: 64 rows x 32 columns
    rows = bt * nc * h
    hg = head_group(h, bt * nc * tiles)
    hk = head_group(h, bt * nc * 2 * qt * nt)
    ng, ks = -(-h // hg), -(-h // hk)
    nblk = -(-(n4 * p // 4) // PASS_THREADS)
    scratch = {"cum": rows * ROWS, "ein": rows * ROWS, "eo": rows * ROWS,
               "dtp": rows * ROWS, "dec": rows,
               "gm": bt * nc * ROWS * ROWS, "eg": bt * nc * ng * ROWS * ROWS,
               "gs": rows * n4 * p, "trp": rows * PASS_WARPS * nblk,
               "trow": bt * s * h * 2 * qt, "tcol": bt * s * h * qt,
               "xdd": bt * s * h * pt, "xin": bt * s * h * pt,
               "yo": bt * s * h * pt, "dap": rows,
               "part": ks * 2 * bt * s * n4}
    ctas = {"prep": -(-rows // 4), "gram": bt * nc * tiles * ng,
            "dstate": bt * (nc - 1) * h * nt * pt,
            "yinter": bt * (nc - 1) * h * qt * pt,
            "pass": bt * h * nblk if nc > 1 else 0,
            "dxd": rows * qt * pt, "dbc": bt * nc * 2 * qt * nt * ks,
            "dt": rows, "intra": (bt * nc + 1) * 2 * qt * nt}
    return {"hg": hg, "hk": hk, "groups_gram": ng, "groups_dbc": ks,
            "scratch": scratch, "ctas": ctas}


def work(bt: int, s: int, h: int, p: int, n4: int, chunk: int) -> dict:
    """Each launch's work as the kernel does it, ("flop", n) or ("bytes",
    n): the products' FMAs at 2 FLOP over their tiled extents (the Gram
    launch's C·Bᵀ once per head group, the causal triangles in 64-row
    tiles), the passes' bytes each read and written once."""
    lay = plan(bt, s, h, p, n4, chunk)
    nc, q = s // chunk, chunk
    qt, pt = -(-q // TILE), -(-p // TILE)
    tiles = 6 if q > TILE else 2
    causal = sum(TILE * (q - TILE * j) for j in range(qt))
    rows = bt * nc * h
    ks = lay["groups_dbc"]
    return {"prep": ("bytes", 4 * bt * s * h + rows * (20 * ROWS + 4)),
            "gram": ("flop", 2 * bt * nc * tiles * TILE * TILE // 2
                     * (lay["groups_gram"] * n4 + h * p)),
            "dstate": ("flop", 2 * bt * (nc - 1) * h * n4 * p * q),
            "yinter": ("flop", 2 * bt * (nc - 1) * h * q * n4 * p),
            "pass": ("bytes", 4 * bt * h * n4 * p * (3 * nc - 4)),
            "dxd": ("flop", 2 * bt * h * p * (nc * causal
                                              + (nc - 1) * q * n4)),
            "dbc": ("flop", 4 * bt * (nc - 1) * q * n4 * h * p),
            "dt": ("bytes", 4 * bt * s * h * (2 + 3 * pt)
                   + 24 * bt * s * h * qt),
            "intra": ("flop", 2 * bt * nc * TILE * TILE * -(-n4 // TILE)
                      * sum(min(q, TILE * (r + 1)) + q - TILE * r
                            for r in range(qt)))}


def prepare(x, dt, A, B, C, states, dy, chunk: int) -> dict:
    """Check dy and allocate the outputs and scratch of one call: the
    arguments of :func:`run`."""
    bt, s, h, p = x.shape
    n4 = B.shape[-1]
    dy = dy.contiguous()
    if tuple(dy.shape) != (bt, s, h, p) or dy.dtype != torch.float32 \
            or dy.device != x.device:
        raise ValueError(f"ssd_scan backward: dy {tuple(dy.shape)} "
                         f"{dy.dtype} on {dy.device}; want {(bt, s, h, p)} "
                         f"float32 on {x.device}")
    dev = x.device
    lay = plan(bt, s, h, p, n4, chunk)
    scratch = {k: torch.empty(v, dtype=torch.float64 if k in F64
                              else torch.float32, device=dev)
               for k, v in lay["scratch"].items()}
    out = dict(dx=torch.empty(bt, s, h, p, dtype=torch.float32, device=dev),
               ddt=torch.empty(bt, s, h, dtype=torch.float32, device=dev),
               dA=torch.empty(h, dtype=torch.float32, device=dev),
               dB=torch.empty(bt, s, n4, dtype=torch.float32, device=dev),
               dC=torch.empty(bt, s, n4, dtype=torch.float32, device=dev))
    return dict(x=x, dt=dt, A=A, B=B, C=C, states=states, dy=dy,
                chunk=chunk, hg=lay["hg"], hk=lay["hk"], scratch=scratch,
                **out)


def run(call: dict, parts: int = ALL_PARTS) -> None:
    """Launch ``csrc/ssd_scan_bwd.cu`` on a :func:`prepare`d call: every
    launch, or those whose bits are set in ``parts`` (bit i: ``PARTS[i]``;
    one alone times that launch on the buffers an earlier full run left)."""
    x, dt, B, C = call["x"], call["dt"], call["B"], call["C"]
    bt, s, h, p = x.shape
    err = build.library().ssd_scan_bwd_f32(
        x.data_ptr(), dt.data_ptr(), call["A"].data_ptr(), B.data_ptr(),
        C.data_ptr(), call["states"].data_ptr(), call["dy"].data_ptr(),
        *(call[k].data_ptr() for k in ("dx", "ddt", "dA", "dB", "dC")),
        *(call["scratch"][k].data_ptr() for k in SCRATCH),
        bt, s, h, p, B.shape[-1], call["chunk"], call["hg"], call["hk"],
        parts, *x.stride()[:3], *dt.stride(), *B.stride()[:2],
        *C.stride()[:2], build.stream(x))
    build.check(err, NAME)


def backward(x, dt, A, B, C, states, dy, chunk: int):
    """(dx, ddt, dA, dB, dC) of the scan from dy, by the kernel: x, dt, A,
    B, C and states as the forward launch left them (B and C N-padded, the
    strides the forward took), dy of y's shape."""
    call = prepare(x, dt, A, B, C, states, dy, chunk)
    run(call)
    global LAUNCHES
    LAUNCHES += 1
    return tuple(call[k] for k in ("dx", "ddt", "dA", "dB", "dC"))


def backward_plain(x, dt, A, B, C, dy, *, chunk: int = 128):
    """Plain version: (dx, ddt, dA, dB, dC) by autograd through
    ``ssd_scan_plain`` (the port's ``ssd_chunked``) on the same inputs."""
    from .ssd_scan import ssd_scan_plain
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, dt, A, B, C)]
        out = ssd_scan_plain(*ins, chunk=chunk)
        return torch.autograd.grad(out, ins, dy)
