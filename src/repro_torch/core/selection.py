"""Select-Clients-Via-GBP-CS (paper Alg. 2 line 1 + Alg. 1 line 4).

Per group m: pre-sample L_rnd devices uniformly (keeps every device's
selection probability nonzero — paper §V.A), build b from the pre-sampled
devices' next-batch counts and A from the remaining candidates, then run
GBP-CS for the remaining L_sel slots. The group axis is a batch dimension:
the permutations come from the threefry key chain on the host, everything
else runs on the counts' device, and GBP-CS runs for all groups at once.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import gbp_cs, prng
from .distributions import mask_divergence


class SelectionResult(NamedTuple):
    mask: torch.Tensor        # (M, K) 0/1 over ALL devices of each group
    divergence: torch.Tensor  # (M,) || P_t^m - P_real ||_2 of the super node
    distance: torch.Tensor    # (M,) GBP-CS objective || A x - y ||_2
    iterations: torch.Tensor  # (M,) GBP-CS permutation steps taken


def _scatter_rows(idx: torch.Tensor, values, k: int) -> torch.Tensor:
    out = torch.zeros(idx.shape[0], k, dtype=torch.float32, device=idx.device)
    return out.scatter(1, idx, values)


def gbp_cs_instances(keys: np.ndarray, counts: torch.Tensor,
                     p_real: torch.Tensor, l: int, l_rnd: int):
    """Per group: pre-sample L_rnd devices with the key's permutation and
    build the GBP-CS instance of the rest. Returns (pre-sample mask (M, K),
    candidate indices (M, K−L_rnd), A (M, F, K−L_rnd), y (M, F))."""
    m, k_total, _ = counts.shape
    counts = counts.float()
    dev = counts.device
    # key_pre, key_opt = split(key); key_opt feeds only the random init
    perm = torch.as_tensor(
        np.stack([prng.permutation(prng.split(key)[0], k_total)
                  for key in keys]), device=dev)
    pre_idx, cand_idx = perm[:, :l_rnd], perm[:, l_rnd:]    # C_rnd, rest
    rows = torch.arange(m, device=dev)[:, None]
    b = counts[rows, pre_idx].sum(dim=1)                     # (M, F)  b_t^m
    A = counts[rows, cand_idx].transpose(1, 2).contiguous()  # (M, F, K-L_rnd)
    n_total = counts.sum(dim=(1, 2)) / k_total * l           # nL
    y = n_total[:, None] * p_real.float() - b                # Eq. (11)
    return _scatter_rows(pre_idx, 1.0, k_total), cand_idx, A, y


def select_for_groups(keys: np.ndarray, counts: torch.Tensor,
                      p_real: torch.Tensor, l: int, l_rnd: int, *,
                      method: str = "gbp_cs", init: str = gbp_cs.MPINV,
                      max_iters: int = 64) -> SelectionResult:
    """keys (M, 2) threefry keys, counts (M, K, F) → one selection per
    group."""
    m, k_total, _ = counts.shape
    counts = counts.float()
    p_real = p_real.float()
    dev = counts.device
    if method == "random":
        perm = torch.as_tensor(
            np.stack([prng.permutation(key, k_total) for key in keys]),
            device=dev)
        mask = _scatter_rows(perm[:, :l], 1.0, k_total)
        div = mask_divergence(counts, mask, p_real)
        return SelectionResult(mask=mask, divergence=div, distance=div,
                               iterations=torch.zeros(m, dtype=torch.int32,
                                                      device=dev))
    if method != "gbp_cs":
        raise ValueError(f"unknown selection method: {method!r}")
    pre_mask, cand_idx, A, y = gbp_cs_instances(keys, counts, p_real, l, l_rnd)
    res = gbp_cs.gbp_cs_minimize(A, y, l - l_rnd, init=init,
                                 max_iters=max_iters)
    mask = pre_mask + _scatter_rows(cand_idx, res.x, k_total)  # Eq. (18)
    return SelectionResult(mask=mask,
                           divergence=mask_divergence(counts, mask, p_real),
                           distance=res.distance, iterations=res.iterations)


def select_clients_via_gbp_cs(key: np.ndarray, counts: torch.Tensor,
                              p_real: torch.Tensor, l: int, l_rnd: int, *,
                              init: str = gbp_cs.MPINV, max_iters: int = 64
                              ) -> SelectionResult:
    """One group's client selection: counts (K, F) → mask (K,) etc."""
    res = select_for_groups(np.asarray(key)[None], counts[None], p_real, l,
                            l_rnd, init=init, max_iters=max_iters)
    return SelectionResult(*(t[0] for t in res))


def select_clients_random(key: np.ndarray, counts: torch.Tensor,
                          p_real: torch.Tensor, l: int) -> SelectionResult:
    """FedAvg's random selection in the same interface (one group)."""
    res = select_for_groups(np.asarray(key)[None], counts[None], p_real, l,
                            0, method="random")
    return SelectionResult(*(t[0] for t in res))


def reselect_predicate(t: int, reselect_every: int) -> bool:
    """Does iteration ``t`` rebuild the super nodes? ``N >= 1`` → every N
    internal iterations; ``0`` → once, at t = 0 (static super nodes)."""
    if reselect_every == 0:
        return t == 0
    return t % reselect_every == 0
