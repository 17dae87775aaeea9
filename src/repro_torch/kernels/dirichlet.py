"""The drifted class distributions of the dynamic environments (DESIGN.md
§13), one row per device: each base row rolled by its class shift, or
replaced by a Dirichlet(α) draw where the drift trace says so (the
``redraw`` and ``churn`` schedules).

:func:`drift_rows` is the CUDA kernel ``csrc/dirichlet_rows.cu`` (one warp
per row: each lane runs Marsaglia–Tsang's two rejection loops for its
elements in registers, threefry and the normal's erfinv included, then a
warp softmax) for CUDA tensors and :func:`drift_rows_plain` for CPU
tensors. Both take the trace as an (R, 4) int64 tensor on the rows'
device — class shift, drawn flag, the row's two key words
(``data.streaming.DriftFn.trace``) — so nothing is read back to the host
and a CUDA graph captures the call. There is no Pallas kernel behind it:
the JAX package draws the rows with ``jax.random.dirichlet`` under
``vmap`` in ``make_drift_fn``; the kernel is the port's own.
"""
from __future__ import annotations

import torch

from ..core import prng
from . import build

NAME = "dirichlet_rows"
SOURCE = "src/repro_torch/csrc/dirichlet_rows.cu"
REPLACES = ("none: jax.random.dirichlet in src/repro/data/streaming.py:"
            "216-238 (make_drift_fn's redraw and churn)")
LAUNCHES = 0

MAX_CLASSES = 64          # two elements per lane of the row's warp


def _check(base: torch.Tensor, trace: torch.Tensor) -> None:
    r, f = base.shape
    if tuple(trace.shape) != (r, 4):
        raise ValueError(f"dirichlet_rows: trace of shape "
                         f"{tuple(trace.shape)}, expected ({r}, 4)")
    if not 1 <= f <= MAX_CLASSES:
        raise ValueError(f"dirichlet_rows: {f} classes, need 1 to "
                         f"{MAX_CLASSES}")


def roll_rows(base: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Row r of base (R, F) rolled right by shift[r]: out[r, j] =
    base[r, (j − shift[r]) mod F] (``take_along_axis`` of the JAX
    schedules)."""
    f = base.shape[1]
    cols = torch.remainder(torch.arange(f, device=base.device)[None, :]
                           - shift[:, None], f)
    return base.gather(1, cols)


def drift_rows_plain(base: torch.Tensor, trace: torch.Tensor,
                     alpha: float) -> torch.Tensor:
    """Plain version of the kernel: base (R, F) float32, trace (R, 4)
    int64 → (R, F): :func:`roll_rows` by trace[:, 0], and the rows with
    trace[:, 1] ≠ 0 replaced by ``prng.dirichlet_t`` under their keys
    trace[:, 2:] (only those rows are drawn)."""
    _check(base, trace)
    out = roll_rows(base.float(), trace[:, 0])
    rows = torch.nonzero(trace[:, 1] != 0).flatten()
    if rows.numel():
        out[rows] = prng.dirichlet_t(trace[rows, 2:], alpha, base.shape[1])
    return out


def drift_rows(base: torch.Tensor, trace: torch.Tensor,
               alpha: float) -> torch.Tensor:
    """The drifted rows of base (R, F) under an (R, 4) int64 trace on its
    device and the Dirichlet concentration ``alpha``: kernel on the card,
    plain on CPU."""
    if base.device.type == "cpu":
        return drift_rows_plain(base, trace, alpha)
    _check(base, trace)
    lib = build.library()
    r, f = base.shape
    base, trace = base.contiguous(), trace.contiguous()
    build.require(base, "base", (r, f), torch.float32)
    build.require(trace, "trace", (r, 4), torch.int64, align=8)
    out = torch.empty_like(base)
    err = lib.dirichlet_rows_f32(base.data_ptr(), trace.data_ptr(),
                                 out.data_ptr(), r, f, float(alpha),
                                 build.stream(base))
    build.check(err, NAME)
    global LAUNCHES
    LAUNCHES += 1
    return out
