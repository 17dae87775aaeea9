"""Per-device Dirichlet rows, one per device: the drifted class
distributions of the dynamic environments (DESIGN.md §13) — each base row
rolled by its class shift, or replaced by a Dirichlet(α) draw where the
drift trace says so (the ``redraw`` and ``churn`` schedules) — and the
class distributions of the lazy population's resident devices (DESIGN.md
§17), every row a draw around its factory's concentration.

:func:`drift_rows` and :func:`draw_rows` are the CUDA kernel
``csrc/dirichlet_rows.cu`` (one 64-thread block per row: each thread runs
Marsaglia–Tsang's two rejection loops for its element in registers,
threefry and the normal's erfinv included, a step's hashes side by side,
then the row's softmax) for CUDA tensors and :func:`drift_rows_plain` for
CPU tensors. They take the trace as an (R, 4) int64 tensor on the rows'
device — class shift, drawn flag, the row's two key words
(``data.streaming.DriftFn.trace``; the population's staged words,
``data.population.LazyPopulation.stage``, whose key words sit in the same
place) — and the concentration as one scalar α (the drift) or an (R, F)
float32 tensor, one α per element (the population), so nothing is read
back to the host and a CUDA graph captures the call. There is no Pallas
kernel behind it: the JAX package draws the rows with
``jax.random.dirichlet`` under ``vmap`` in ``make_drift_fn`` and
``LazyPopulation.probs_for``; the kernel is the port's own.
"""
from __future__ import annotations

import math

import torch

from ..core import prng
from . import build

NAME = "dirichlet_rows"
SOURCE = "src/repro_torch/csrc/dirichlet_rows.cu"
REPLACES = ("none: jax.random.dirichlet in src/repro/data/streaming.py:"
            "216-238 (make_drift_fn's redraw and churn) and "
            "src/repro/data/population.py:139,155 (LazyPopulation)")
LAUNCHES = 0

MAX_CLASSES = 64          # one element per thread of the row's block


def _check(base: torch.Tensor | None, trace: torch.Tensor, alpha) -> None:
    """Shapes and dtypes; a scalar α finite and > 0. A tensor α's values
    are checked on the CPU only (on the card that would read them back)."""
    if isinstance(alpha, torch.Tensor):
        r, f = alpha.shape if alpha.dim() == 2 else (-1, -1)
        if alpha.dtype != torch.float32 or alpha.dim() != 2:
            raise ValueError(f"dirichlet_rows: alpha of dtype {alpha.dtype} "
                             f"and shape {tuple(alpha.shape)}, expected an "
                             "(R, F) float32 tensor")
        if base is not None and tuple(base.shape) != (r, f):
            raise ValueError(f"dirichlet_rows: alpha of shape {(r, f)}, "
                             f"base {tuple(base.shape)}")
        if alpha.device.type == "cpu" and not bool(
                (torch.isfinite(alpha) & (alpha > 0)).all()):
            raise ValueError("dirichlet_rows: alpha must be finite and > 0")
    else:
        if base is None:
            raise ValueError("dirichlet_rows: drawing every row needs an "
                             "(R, F) alpha tensor")
        r, f = base.shape
        if not (math.isfinite(alpha) and alpha > 0):
            raise ValueError(f"dirichlet_rows: alpha must be finite and > 0, "
                             f"got {alpha}")
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


def drift_rows_plain(base: torch.Tensor | None, trace: torch.Tensor,
                     alpha) -> torch.Tensor:
    """Plain version of the kernel: base (R, F) float32, trace (R, 4)
    int64 → (R, F): :func:`roll_rows` by trace[:, 0], and the rows with
    trace[:, 1] ≠ 0 replaced by ``prng.dirichlet_t`` under their keys
    trace[:, 2:] (only those rows are drawn); ``alpha`` a float or an (R,
    F) float32 tensor (each drawn row its own row of it). With ``base``
    None every row is drawn and trace[:, :2] is not read."""
    _check(base, trace, alpha)
    if base is None:
        return prng.dirichlet_t(trace[:, 2:], alpha, alpha.shape[1])
    out = roll_rows(base.float(), trace[:, 0])
    rows = torch.nonzero(trace[:, 1] != 0).flatten()
    if rows.numel():
        a = alpha[rows] if isinstance(alpha, torch.Tensor) else alpha
        out[rows] = prng.dirichlet_t(trace[rows, 2:], a, base.shape[1])
    return out


def drift_rows(base: torch.Tensor | None, trace: torch.Tensor,
               alpha) -> torch.Tensor:
    """The drifted rows of base (R, F) under an (R, 4) int64 trace on its
    device and the Dirichlet concentration ``alpha`` (a float, or an (R,
    F) float32 tensor on that device); ``base`` None draws every row:
    kernel on the card, plain on CPU."""
    build.refuse_grad(NAME, base, alpha)
    if trace.device.type == "cpu":
        return drift_rows_plain(base, trace, alpha)
    _check(base, trace, alpha)
    lib = build.library()
    r = trace.shape[0]
    f = (alpha if base is None else base).shape[1]
    trace = trace.contiguous()
    build.require(trace, "trace", (r, 4), torch.int64, align=8)
    base_ptr = alpha_ptr = None
    if base is not None:
        base = base.contiguous()
        build.require(base, "base", (r, f), torch.float32)
        base_ptr = base.data_ptr()
    if isinstance(alpha, torch.Tensor):
        alpha = alpha.contiguous()
        build.require(alpha, "alpha", (r, f), torch.float32)
        alpha_ptr, alpha = alpha.data_ptr(), 0.0
    out = torch.empty(r, f, dtype=torch.float32, device=trace.device)
    err = lib.dirichlet_rows_f32(base_ptr, trace.data_ptr(), alpha_ptr,
                                 out.data_ptr(), r, f, float(alpha),
                                 build.stream(trace))
    build.check(err, NAME)
    global LAUNCHES
    LAUNCHES += 1
    return out


def draw_rows(trace: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Every row drawn: row r ~ Dirichlet(alpha[r]) under the key words
    trace[r, 2:] (``jax.random.dirichlet(key, alpha[r])``), alpha an (R,
    F) float32 tensor on the trace's device — the lazy population's
    resident rows (:func:`drift_rows` with no base)."""
    return drift_rows(None, trace, alpha)
