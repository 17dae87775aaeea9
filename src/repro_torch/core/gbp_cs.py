"""GBP-CS: Gradient-based Binary Permutation Client Selection (paper §V,
Alg. 2), batched over a leading group axis (or one instance, as the JAX
package's ``gbp_cs_minimize`` takes it).

    min_x || A x - y ||_2    s.t.  x(i) in {0,1},  sum_i x(i) = L_sel .

The core move permutes the (0,1) pair with the steepest opposite gradients
(Eqs. 15–17) until the distance stops decreasing. The initialisers
(:func:`init_mpinv`, :func:`init_zero`, :func:`init_random`) and
:func:`top_lsel` are PyTorch;
the loop itself is ``kernels.gbp_cs.minimize`` — one CUDA launch for all
groups on the card, the plain step loop on CPU.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels.gbp_cs import (gradient, objective, permute,  # noqa: F401
                              select_swap_pair)
from . import dispatch, prng

RANDOM = "random"
ZERO = "zero"
MPINV = "mpinv"
INITIALIZERS = (RANDOM, ZERO, MPINV)


class GBPCSResult(NamedTuple):
    x: torch.Tensor           # (G, K) float32 0/1 solution
    distance: torch.Tensor    # (G,) || A x - y ||_2
    iterations: torch.Tensor  # (G,) int32 permutation steps taken
    trace: torch.Tensor       # (G, max_iters + 1) distance per step


def top_lsel(scores: torch.Tensor, l_sel: int) -> torch.Tensor:
    """T_{L_sel}: 1 on the L_sel largest entries of ``scores`` (last axis),
    else 0. The sort is stable, so equal scores go to the lower index, as
    ``jnp.argsort`` does."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    return torch.zeros_like(scores, dtype=torch.float32).scatter(
        -1, order[..., :l_sel], 1.0)


def init_random(keys, A: torch.Tensor, l_sel: int) -> torch.Tensor:
    """Random initializer: L_sel ones at the largest of one threefry
    ``uniform`` draw per instance (``keys`` (G, 2), the selection's
    ``key_opt``: numpy, or an int64 tensor on A's device)."""
    if not isinstance(keys, torch.Tensor):
        keys = torch.as_tensor(np.asarray(keys, np.uint32).astype(np.int64),
                               device=A.device)
    return top_lsel(prng.uniform_t(keys, (A.shape[-1],)), l_sel)


def pinv(A: torch.Tensor) -> torch.Tensor:
    """A⁺ with ``jnp.linalg.pinv``'s singular-value cutoff, 10·max(F, K)·eps
    (``torch.linalg.pinv`` defaults to max(F, K)·eps); A is
    rank-deficient, so the cutoff decides which directions survive. Its SVD
    reads a status back to the host, so a CUDA graph cannot capture it."""
    f, k = A.shape[-2:]
    rtol = 10.0 * max(f, k) * torch.finfo(torch.float32).eps
    return torch.linalg.pinv(A.float(), rtol=rtol)


def init_mpinv(A: torch.Tensor, y: torch.Tensor, l_sel: int,
               pinv_fn=None) -> torch.Tensor:
    """Moore-Penrose Inverse initializer (Eq. 14): x̃ = A⁺ y, top-L_sel → 1.
    ``pinv_fn`` (default :func:`pinv`) computes A⁺; a captured round
    passes one that runs :func:`pinv` between two graph segments."""
    a_pinv = (pinv_fn or pinv)(A)
    x_tilde = (a_pinv @ y.float().unsqueeze(-1)).squeeze(-1)
    return top_lsel(x_tilde, l_sel)


def init_zero(A: torch.Tensor, y: torch.Tensor, l_sel: int) -> torch.Tensor:
    """Zero initializer with warm-up: greedily set the smallest-gradient
    entry to 1, L_sel times (paper §VII.A)."""
    x = torch.zeros(A.shape[:-2] + A.shape[-1:], dtype=torch.float32,
                    device=A.device)
    big = torch.finfo(torch.float32).max
    for _ in range(l_sel):
        g = gradient(A, x, y)
        i = torch.where(x > 0.5, big, g).argmin(-1)
        x = x.scatter(-1, i.unsqueeze(-1), 1.0)
    return x


def gbp_cs_minimize(A: torch.Tensor, y: torch.Tensor, l_sel: int, *,
                    init: str = MPINV, max_iters: int = 64,
                    keys=None, key=None, pinv_fn=None) -> GBPCSResult:
    """Run GBP-CS (Alg. 2 lines 2–10) on G instances: A (G, F, K) candidate
    class counts, y (G, F) targets (Eq. 11); ``keys`` (G, 2) feed only the
    random initializer, ``pinv_fn`` only the mpinv one.

    A 2-D A (F, K) with y (F,) is the JAX package's one-instance call:
    ``key`` (default ``prng.PRNGKey(0)``) feeds the random initializer, the
    instance runs as a group of one, and the result drops the group axis
    (x (K,), 0-d distance and iterations, trace (max_iters + 1,))."""
    if A.dim() == 2:
        if keys is not None:
            raise ValueError("a single GBP-CS instance takes key=, not keys=")
        key = prng.PRNGKey(0) if key is None else key
        res = gbp_cs_minimize(A[None], y[None], l_sel, init=init,
                              max_iters=max_iters,
                              keys=np.asarray(key, np.uint32)[None],
                              pinv_fn=pinv_fn)
        return GBPCSResult(*(v[0] for v in res))
    if init not in INITIALIZERS:
        raise ValueError(f"unknown GBP-CS initializer {init!r} "
                         f"(expected one of {INITIALIZERS})")
    A = A.float().contiguous()
    y = y.float().contiguous()
    if init == RANDOM:
        if keys is None:
            raise ValueError("the random GBP-CS initializer needs keys")
        x0 = init_random(keys, A, l_sel)
    elif init == MPINV:
        x0 = init_mpinv(A, y, l_sel, pinv_fn)
    else:
        x0 = init_zero(A, y, l_sel)
    x, d, iters, trace = dispatch.gbp_cs_loop(A, y, x0.contiguous(),
                                              max_iters)
    return GBPCSResult(x=x, distance=d, iterations=iters, trace=trace)


def gbp_cs_minimize_batched(A: torch.Tensor, y: torch.Tensor, l_sel: int, *,
                            keys=None, **kw) -> GBPCSResult:
    """A (M, F, K), y (M, F): the JAX package's vmap over instances, with
    its default keys ``split(PRNGKey(0), M)``; one kernel launch on the
    card."""
    if keys is None:
        keys = prng.split(prng.PRNGKey(0), A.shape[0])
    return gbp_cs_minimize(A, y, l_sel, keys=keys, **kw)
