"""Select-Clients-Via-GBP-CS (paper Alg. 2 line 1 + Alg. 1 line 4).

Per group m: pre-sample L_rnd devices uniformly (keeps every device's
selection probability nonzero — paper §V.A), build b from the pre-sampled
devices' next-batch counts and A from the remaining candidates, then run
GBP-CS for the remaining L_sel slots. The group axis is a batch dimension:
the permutations come from the threefry key chain on the host
(:func:`presample_keys`), everything else runs on the counts' device
(:func:`select_presampled`), and GBP-CS runs for all groups at once.
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


def presample_keys(keys: np.ndarray, k_total: int,
                   method: str = "gbp_cs") -> tuple[np.ndarray, np.ndarray]:
    """The host half of one selection: from the groups' keys (M, 2), the
    pre-sample permutations of the K devices (M, K) and the random
    initializer's keys (M, 2). GBP-CS splits each key into (key_pre,
    key_opt) and permutes with key_pre; random selection permutes with the
    key itself (its initializer keys are unused zeros). Everything after
    this runs on the counts' device."""
    keys = np.asarray(keys, np.uint32)
    if method == "random":
        return (np.stack([prng.permutation(key, k_total) for key in keys]),
                np.zeros_like(keys))
    pre_opt = prng.split(keys)                                # (M, 2, 2)
    return (np.stack([prng.permutation(key, k_total)
                      for key in pre_opt[:, 0]]), pre_opt[:, 1])


def _partition_avail(perm: torch.Tensor, avail) -> torch.Tensor:
    """With ``avail`` (M, K), the permutations stably partitioned so that
    available devices come first, permutation order kept within each class
    (an identity at avail ≡ 1)."""
    if avail is None:
        return perm
    order = torch.argsort(1.0 - avail.gather(1, perm), dim=1, stable=True)
    return perm.gather(1, order)


def _instances(perm: torch.Tensor, counts: torch.Tensor, p_real, l: int,
               l_rnd: int, avail):
    """Per group, pre-sample the first L_rnd devices of ``perm`` and build
    the GBP-CS instance of the rest: (pre-sample mask (M, K), candidate
    indices (M, K−L_rnd), A (M, F, K−L_rnd), y (M, F))."""
    m, k_total, _ = counts.shape
    counts = counts.float()
    if avail is not None:
        counts = counts * avail[..., None]      # dark devices report nothing
    perm = _partition_avail(perm, avail)
    pre_idx, cand_idx = perm[:, :l_rnd], perm[:, l_rnd:]    # C_rnd, rest
    rows = torch.arange(m, device=counts.device)[:, None]
    b = counts[rows, pre_idx].sum(dim=1)                     # (M, F)  b_t^m
    A = counts[rows, cand_idx].transpose(1, 2).contiguous()  # (M, F, K-L_rnd)
    n_total = counts.sum(dim=(1, 2)) / k_total * l           # nL
    y = n_total[:, None] * p_real.float() - b                # Eq. (11)
    return _scatter_rows(pre_idx, 1.0, k_total), cand_idx, A, y


def gbp_cs_instances(keys: np.ndarray, counts: torch.Tensor,
                     p_real: torch.Tensor, l: int, l_rnd: int,
                     avail: torch.Tensor | None = None):
    """Per group: pre-sample L_rnd devices with the key's permutation and
    build the GBP-CS instance of the rest. Returns (pre-sample mask (M, K),
    candidate indices (M, K−L_rnd), A (M, F, K−L_rnd), y (M, F)). With
    ``avail`` the counts are those of available devices only."""
    perm, _ = presample_keys(keys, counts.shape[1])
    return _instances(torch.as_tensor(perm, device=counts.device), counts,
                      p_real, l, l_rnd,
                      None if avail is None else avail.float())


def select_for_groups(keys: np.ndarray, counts: torch.Tensor,
                      p_real: torch.Tensor, l: int, l_rnd: int, *,
                      avail: torch.Tensor | None = None,
                      method: str = "gbp_cs", init: str = gbp_cs.MPINV,
                      max_iters: int = 64) -> SelectionResult:
    """keys (M, 2) threefry keys, counts (M, K, F) → one selection per
    group: :func:`presample_keys` on the host, then
    :func:`select_presampled` on the counts' device."""
    if method not in ("gbp_cs", "random"):
        raise ValueError(f"unknown selection method: {method!r}")
    perm, opt = presample_keys(keys, counts.shape[1], method)
    dev = counts.device
    return select_presampled(
        torch.as_tensor(perm, device=dev),
        torch.as_tensor(opt.astype(np.int64), device=dev), counts, p_real, l,
        l_rnd, avail=avail, method=method, init=init, max_iters=max_iters)


def select_presampled(perm: torch.Tensor, opt_keys: torch.Tensor,
                      counts: torch.Tensor, p_real: torch.Tensor, l: int,
                      l_rnd: int, *, avail: torch.Tensor | None = None,
                      method: str = "gbp_cs", init: str = gbp_cs.MPINV,
                      max_iters: int = 64, pinv_fn=None) -> SelectionResult:
    """One selection per group from :func:`presample_keys`' material on
    the counts' device: ``perm`` (M, K) int64, ``opt_keys`` (M, 2) int64
    words. No host copy and no host sync, so a CUDA graph captures it
    (``pinv_fn``, the mpinv initializer's pseudo-inverse, is where a
    captured round breaks: see ``core.gbp_cs.init_mpinv``).

    With ``avail`` (M, K) 0/1, devices at 0 are never selected (DESIGN.md
    §14.2; quarantine folds into it, §15.4): their counts are zeroed, the
    pre-sample permutation puts available devices first, a repair step
    swaps any unavailable GBP-CS pick for the best-ranked available
    candidate (``top_lsel(2·avail + x)``, re-scored), and the mask is
    intersected with ``avail``. Every step is an identity at avail ≡ 1."""
    m, k_total, _ = counts.shape
    counts = counts.float()
    p_real = p_real.float()
    if avail is not None:
        avail = avail.float()
    if method == "random":
        perm = _partition_avail(perm, avail)
        mask = _scatter_rows(perm[:, :l], 1.0, k_total)
        if avail is not None:
            counts = counts * avail[..., None]
            mask = mask * avail
        div = mask_divergence(counts, mask, p_real)
        return SelectionResult(mask=mask, divergence=div, distance=div,
                               iterations=torch.zeros(m, dtype=torch.int32,
                                                      device=counts.device))
    if method != "gbp_cs":
        raise ValueError(f"unknown selection method: {method!r}")
    pre_mask, cand_idx, A, y = _instances(perm, counts, p_real, l, l_rnd,
                                          avail)
    res = gbp_cs.gbp_cs_minimize(A, y, l - l_rnd, init=init,
                                 max_iters=max_iters, keys=opt_keys,
                                 pinv_fn=pinv_fn)
    x, distance = res.x, res.distance
    if avail is not None:
        # availability dominates the solver's choice: chosen-and-up scores
        # 3, up 2, chosen-but-dark 1; the stable top-L_sel is res.x when
        # every chosen candidate is up
        x = gbp_cs.top_lsel(2.0 * avail.gather(1, cand_idx) + x, l - l_rnd)
        distance = gbp_cs.objective(A, x, y)
    mask = pre_mask + _scatter_rows(cand_idx, x, k_total)      # Eq. (18)
    if avail is not None:
        counts = counts * avail[..., None]
        mask = mask * avail
    return SelectionResult(mask=mask,
                           divergence=mask_divergence(counts, mask, p_real),
                           distance=distance, iterations=res.iterations)


def select_clients_via_gbp_cs(key: np.ndarray, counts: torch.Tensor,
                              p_real: torch.Tensor, l: int, l_rnd: int, *,
                              avail: torch.Tensor | None = None,
                              init: str = gbp_cs.MPINV, max_iters: int = 64
                              ) -> SelectionResult:
    """One group's client selection: counts (K, F), avail (K,) → mask (K,)
    etc."""
    res = select_for_groups(np.asarray(key)[None], counts[None], p_real, l,
                            l_rnd, avail=None if avail is None
                            else avail[None], init=init, max_iters=max_iters)
    return SelectionResult(*(t[0] for t in res))


def select_clients_random(key: np.ndarray, counts: torch.Tensor,
                          p_real: torch.Tensor, l: int) -> SelectionResult:
    """FedAvg's random selection in the same interface (one group)."""
    res = select_for_groups(np.asarray(key)[None], counts[None], p_real, l,
                            0, method="random")
    return SelectionResult(*(t[0] for t in res))


def quarantine_mask(quarantine: torch.Tensor, limit: int) -> torch.Tensor:
    """Selection eligibility from per-device quarantine counters
    (DESIGN.md §15.4): a device flagged ``limit`` or more times is barred
    from selection like an unavailable device — callers pass the mask as
    ``avail``. ``limit <= 0`` disables quarantine (all ones)."""
    q = quarantine.float()
    if limit <= 0:
        return torch.ones_like(q)
    return (q < limit).float()


def reselect_trigger(do_reselect, mask: torch.Tensor, avail: torch.Tensor,
                     l: int):
    """Force a rebuild when a carried committee member became ineligible,
    or a committee is under-strength (fewer than ``l`` members). A Python
    ``do_reselect`` gives a bool (one read back); a 0-d bool tensor gives
    the predicate as a 0-d tensor on the device, read by nothing (the
    fused round's form)."""
    dark = torch.sum(mask * (1.0 - avail))
    under = torch.sum(torch.clamp_min(l - mask.sum(-1), 0.0))
    if isinstance(do_reselect, torch.Tensor):
        return do_reselect | ((dark + under) > 0)
    return bool(do_reselect or (dark + under) > 0)


def reselect_predicate(t: int, reselect_every: int) -> bool:
    """Does iteration ``t`` rebuild the super nodes? ``N >= 1`` → every N
    internal iterations; ``0`` → once, at t = 0 (static super nodes)."""
    if reselect_every == 0:
        return t == 0
    return t % reselect_every == 0


def select_or_keep(do_reselect, keys, counts: torch.Tensor,
                   p_real: torch.Tensor, l: int, l_rnd: int, *,
                   prev_mask: torch.Tensor, prev_distance: torch.Tensor,
                   avail: torch.Tensor | None = None,
                   method: str = "gbp_cs", init: str = gbp_cs.MPINV,
                   max_iters: int = 64, pinv_fn=None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Periodic reselection (DESIGN.md §13): run GBP-CS for all M groups
    (fresh), or keep the carried masks and re-score them against the
    current counts (``mask_divergence``; with ``avail``, against the
    availability-masked counts), carrying the distance of the last
    rebuild. Returns (mask (M, K), divergence (M,), distance (M,)).

    ``keys`` are the groups' threefry keys (M, 2) (pre-sampled on the host,
    :func:`select_for_groups`) or the staged ``(perm, opt_keys)`` tensors
    of :func:`select_presampled`. A Python ``do_reselect`` runs one branch;
    a 0-d bool tensor runs both and picks with ``torch.where`` on the
    device, which is what ``lax.cond`` returns, with no read-back."""
    def fresh():
        kw = dict(avail=avail, method=method, init=init,
                  max_iters=max_iters)
        if isinstance(keys, tuple):
            sel = select_presampled(*keys, counts, p_real, l, l_rnd,
                                    pinv_fn=pinv_fn, **kw)
        else:
            sel = select_for_groups(keys, counts, p_real, l, l_rnd, **kw)
        return sel.mask, sel.divergence, sel.distance

    def keep():
        c = counts if avail is None else counts * avail[..., None]
        return prev_mask, mask_divergence(c, prev_mask, p_real), \
            prev_distance

    if not isinstance(do_reselect, torch.Tensor):
        return fresh() if do_reselect else keep()
    return tuple(torch.where(do_reselect, a, b)
                 for a, b in zip(fresh(), keep()))
