"""GBP-CS permutation loop (paper Alg. 2 lines 2-10), batched over groups.

``minimize(A, y, x0, max_iters)`` runs the bounded loop of
``core.gbp_cs.gbp_cs_minimize`` from a given start ``x0`` for every group at
once: the CUDA kernel (``csrc/gbp_cs.cu``, one warp per group, the whole
loop in one launch, A·x carried by column updates) for CUDA tensors,
:func:`minimize_plain` for CPU tensors. The step math (:func:`objective`,
:func:`gradient`, :func:`select_swap_pair`, :func:`permute`) is the plain
version of what the kernel computes, and is shared with ``core.gbp_cs``.

The kernel's masks and trip counts equal the plain version's when A holds
integer counts and x0 is 0/1 (A·x is then exact in any order); its
distances agree to rounding.

Shapes: A (G, F, K), y (G, F), x (G, K) — any leading batch dims for the
step math; the kernel takes any F, K whose A (F·K floats) fits in one
block's shared memory, with register-resident fast paths for F, K <= 128.
"""
from __future__ import annotations

import torch

from . import build

NAME = "gbp_cs"
SOURCE = "src/repro_torch/csrc/gbp_cs.cu"
REPLACES = ("src/repro/kernels/gbp_cs/kernel.py:88 (residual) + "
            "src/repro/kernels/gbp_cs/kernel.py:115 (select_swap)")
LAUNCHES = 0

_BIG = torch.finfo(torch.float32).max


def _residual(A: torch.Tensor, x: torch.Tensor, y: torch.Tensor
              ) -> torch.Tensor:
    return (A @ x.unsqueeze(-1)).squeeze(-1) - y


def objective(A: torch.Tensor, x: torch.Tensor, y: torch.Tensor
              ) -> torch.Tensor:
    """d = ||A x − y||₂ (Eq. 10)."""
    r = _residual(A, x, y)
    return torch.sqrt(torch.clamp_min(torch.sum(r * r, -1), 0.0))


def gradient(A: torch.Tensor, x: torch.Tensor, y: torch.Tensor
             ) -> torch.Tensor:
    """g = Aᵀ r / ||r|| (Alg. 2 line 5)."""
    r = _residual(A, x, y)
    d = torch.sqrt(torch.clamp_min(torch.sum(r * r, -1), 1e-12))
    return (A.transpose(-1, -2) @ r.unsqueeze(-1)).squeeze(-1) / d[..., None]


def select_swap_pair(g: torch.Tensor, x: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eqs. (15)-(16): masked argmin over x=0, masked argmax over x=1; the
    first index wins a tie."""
    is_one = x > 0.5
    i_0to1 = torch.where(is_one, _BIG, g).argmin(-1)
    i_1to0 = torch.where(is_one, g, -_BIG).argmax(-1)
    return i_0to1, i_1to0


def permute(x: torch.Tensor, i_0to1: torch.Tensor, i_1to0: torch.Tensor
            ) -> torch.Tensor:
    """Eq. (17): x[i_0to1]=1, then x[i_1to0]=0."""
    return x.scatter(-1, i_0to1.unsqueeze(-1), 1.0) \
        .scatter(-1, i_1to0.unsqueeze(-1), 0.0)


def step(A: torch.Tensor, x: torch.Tensor, y: torch.Tensor
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """One permutation step: (x_next, d_next)."""
    i01, i10 = select_swap_pair(gradient(A, x, y), x)
    x_next = permute(x, i01, i10)
    return x_next, objective(A, x_next, y)


def minimize_plain(A: torch.Tensor, y: torch.Tensor, x0: torch.Tensor,
                   max_iters: int):
    """Plain PyTorch version of the kernel: every group steps until its
    distance stops decreasing (the non-improving step is counted and
    rejected) or ``max_iters``. Returns (x, d, iterations int32, trace
    (G, max_iters + 1) padded with the final distance)."""
    x = x0.clone()
    d = objective(A, x, y)
    g = A.shape[0]
    trace = d[:, None].repeat(1, max_iters + 1)
    iters = torch.zeros(g, dtype=torch.int32, device=A.device)
    active = torch.ones(g, dtype=torch.bool, device=A.device)
    for s in range(max_iters):
        if not bool(active.any()):
            break
        x_next, d_next = step(A, x, y)
        improved = d_next < d
        take = active & improved
        x = torch.where(take[:, None], x_next, x)
        d = torch.where(take, d_next, d)
        trace[:, s + 1] = torch.where(active, d, trace[:, s + 1])
        iters += active.to(torch.int32)
        active = take
    idx = torch.arange(max_iters + 1, device=A.device)
    trace = torch.where(idx[None, :] <= iters[:, None], trace, d[:, None])
    return x, d, iters, trace


def minimize(A: torch.Tensor, y: torch.Tensor, x0: torch.Tensor,
             max_iters: int):
    """The GBP-CS loop for all groups: kernel on the card, plain on CPU.
    The card's outputs are four allocations, which cost the host less than
    one buffer cut into four views (PERF.md, the ``gbp_cs`` row)."""
    if A.device.type == "cpu":
        return minimize_plain(A, y, x0, max_iters)
    g, f, k = A.shape
    if not (A.dtype == y.dtype == x0.dtype == torch.float32
            and A.is_contiguous() and y.is_contiguous()
            and x0.is_contiguous() and y.shape == (g, f)
            and x0.shape == (g, k) and f >= 1 and k >= 1
            and max_iters >= 0 and y.device == x0.device == A.device):
        raise ValueError(
            f"gbp_cs: needs contiguous f32 A (G, F, K), y (G, F), x0 (G, K) "
            f"on one card; got {tuple(A.shape)} {tuple(y.shape)} "
            f"{tuple(x0.shape)}")
    lib = build.library()
    x = torch.empty_like(x0)
    d = torch.empty(g, dtype=torch.float32, device=A.device)
    iters = torch.empty(g, dtype=torch.int32, device=A.device)
    trace = torch.empty(g, max_iters + 1, dtype=torch.float32,
                        device=A.device)
    err = lib.gbp_cs_minimize_f32(A.data_ptr(), y.data_ptr(), x0.data_ptr(),
                                  x.data_ptr(), d.data_ptr(),
                                  iters.data_ptr(), trace.data_ptr(), g, f,
                                  k, max_iters, build.stream(A))
    build.check(err, NAME)
    global LAUNCHES
    LAUNCHES += 1
    return x, d, iters, trace

