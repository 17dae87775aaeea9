"""Robust Eq. (4) aggregation of stacked member gradients (DESIGN.md §15.2).

The per-coordinate order statistics — ``trimmed_mean`` and
``coord_median`` over the K members of each of M groups — are the CUDA
kernel ``csrc/robust_agg.cu`` (:func:`aggregate`, one launch for all
groups) for CUDA tensors and :func:`aggregate_plain` for CPU tensors.

:func:`aggregate_flat` is the whole robust Eq. 4 on one flattened (M, K, P4)
buffer, as the JAX package's ``kernels/robust_agg/ops.py`` routes it:

* ``mean`` — the ``agg_weighted`` kernel per group at the normalised
  weights, NOT fault-masked (NaN members propagate, by design);
* ``clip_norm`` — the finite mask and the per-member clip factors in
  PyTorch, then ``agg_weighted`` at the effective weights
  ``w·finite·min(1, clip/‖g‖) / Σ(w·finite)`` on the sanitised stack;
* ``trimmed_mean`` / ``coord_median`` — :func:`aggregate` over the members
  with positive weight and finite values.

:func:`robust_aggregate_tree` wraps it for member trees (flatten, pad,
unflatten), the contract of ``core.sync.robust_aggregate`` with a leading
group axis.
"""
from __future__ import annotations

import torch

from . import agg_weighted, build

NAME = "robust_agg"
SOURCE = "src/repro_torch/csrc/robust_agg.cu"
REPLACES = "src/repro/kernels/robust_agg/kernel.py:68 (robust_agg_kernel)"
LAUNCHES = 0

K_MAX = 64                     # members per group the kernel takes
METHODS = ("trimmed_mean", "coord_median")
EPS = agg_weighted.EPS
_BIG = torch.finfo(torch.float32).max


def aggregate_plain(stacked: torch.Tensor, active: torch.Tensor,
                    method: str, trim: int = 1) -> torch.Tensor:
    """Plain version of the kernel, SORT-based like the JAX package's
    ``core.sync`` and ``kernels/robust_agg/ref.py``: stacked (M, K, P),
    active (M, K) 0/1 → (M, P). Inactive members go to +max and sort last;
    the trimmed sum runs in ascending order."""
    if method not in METHODS:
        raise ValueError(f"robust_agg: unknown method {method!r}")
    act = active > 0
    k = stacked.shape[1]
    asc = torch.sort(torch.where(act[..., None], stacked.float(), _BIG),
                     dim=1).values
    n = act.sum(1)                                          # (M,)
    if method == "trimmed_mean":
        t_eff = torch.clamp(torch.clamp_min((n - 1) // 2, 0), max=trim)
        idx = torch.arange(k, device=stacked.device)[None, :, None]
        inc = (idx >= t_eff[:, None, None]) & \
            (idx < (n - t_eff)[:, None, None])
        cnt = torch.clamp_min(n - 2 * t_eff, 1).float()
        out = torch.where(inc, asc, 0.0).sum(1) / cnt[:, None]
    else:
        lo = torch.clamp_min((n - 1) // 2, 0)
        hi = torch.clamp_max(n // 2, k - 1)
        pick = lambda r: asc.gather(1, r[:, None, None].expand(
            -1, 1, asc.shape[2]))[:, 0]
        out = (pick(lo) + pick(hi)) * 0.5
    return torch.where(n[:, None] > 0, out, 0.0)


def aggregate(stacked: torch.Tensor, active: torch.Tensor, method: str,
              trim: int = 1) -> torch.Tensor:
    """Per-coordinate trimmed mean / median of (M, K, P) over the active
    members of each group → (M, P): kernel on the card (K <= 64), plain on
    CPU."""
    if stacked.device.type == "cpu":
        return aggregate_plain(stacked, active, method, trim)
    if method not in METHODS:
        raise ValueError(f"robust_agg: unknown method {method!r}")
    lib = build.library()
    m, k, p = stacked.shape
    if not 1 <= k <= K_MAX or p == 0 or m > 65535 or trim < 0:
        raise ValueError(f"robust_agg: unsupported M={m}, K={k}, P={p}, "
                         f"trim={trim} (need 1 <= K <= {K_MAX}, P > 0, "
                         "M <= 65535, trim >= 0)")
    build.require(stacked, "stacked", (m, k, p), torch.float32)
    build.require(active, "active", (m, k), torch.float32)
    out = torch.empty(m, p, dtype=torch.float32, device=stacked.device)
    err = lib.robust_agg_f32(stacked.data_ptr(), active.data_ptr(),
                             out.data_ptr(), m, k, p, METHODS.index(method),
                             trim, build.stream(stacked))
    build.check(err, NAME)
    global LAUNCHES
    LAUNCHES += 1
    return out


def member_stats(flat: torch.Tensor):
    """(finite (M, K) bool, norms (M, K), clean (M, K, P4)) of a member
    stack: a member is finite where every coordinate is; ``clean`` zeroes
    the non-finite coordinates, and the norms are taken over it (as
    ``core.sync.member_norms``)."""
    ok = torch.isfinite(flat)
    clean = torch.where(ok, flat, 0.0)
    return ok.all(-1), torch.sqrt(torch.sum(clean * clean, dim=-1)), clean


def aggregate_flat(flat: torch.Tensor, weights: torch.Tensor, method: str,
                   clip: float = 10.0, trim: int = 1,
                   stats=None) -> torch.Tensor:
    """Robust Eq. 4 of every group: flat (M, K, P4), weights (M, K) →
    (M, P4). ``clip = inf`` makes ``clip_norm`` the finite-masked mean.
    ``stats`` is :func:`member_stats` of ``flat`` where the caller already
    has it."""
    w = weights.float()
    if method == "mean":
        return agg_weighted.agg_groups(
            flat, w / torch.clamp_min(w.sum(-1, keepdim=True), EPS))
    finite, norms, clean = member_stats(flat) if stats is None else stats
    if method == "clip_norm":
        # min(1, clip/‖g‖), written so that clip = inf gives exactly 1
        factor = torch.where(norms > clip, clip / norms, 1.0)
        wf = w * finite
        eff = wf * factor / torch.clamp_min(wf.sum(-1, keepdim=True), EPS)
        return agg_weighted.agg_groups(clean, eff.contiguous())
    return aggregate(flat, ((w > 0) & finite).float(), method, trim)


def robust_aggregate_tree(grads, weights: torch.Tensor, method: str,
                          clip: float = 10.0, trim: int = 1):
    """Member tree (leaves (M, K, ...)), weights (M, K) → the robust
    aggregate of every group (leaves (M, ...))."""
    m, k = weights.shape
    flat = agg_weighted.flatten(grads, m * k).view(m, k, -1)
    return agg_weighted.unflatten(
        aggregate_flat(flat, weights, method, clip, trim), grads, 2)
