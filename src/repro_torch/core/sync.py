"""Aggregation primitives of Alg. 1 (Eqs. 3–5) on parameter dicts, the
staleness helpers of the bounded-async sync (DESIGN.md §14.3), the plain
robust aggregators of DESIGN.md §15.2, and the collective forms of Eqs. 4
and 5 over ``torch.distributed`` ranks (the sharded engine, DESIGN.md §8).

The functions here are the plain PyTorch forms of the JAX package's
``core/sync.py`` on one group's stacked (K, ...) member tree. The engine
reaches the kernels through ``core.dispatch`` (``weighted_average_tree``,
``robust_agg_fn``); the robust family below is what those kernels are held
to, and sorts like the JAX reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from .. import tree
from ..kernels import agg_weighted
from . import dispatch

EPS = 1e-12


def apply_sgd(params, grads, lr: float):
    """The SGD update of Eq. (3), applied once to an averaged gradient."""
    return tree.map(lambda p, g: p - lr * g, params, grads)


def local_grads(params, batch, loss_fn):
    """Eq. (3) split at the gradient: (mean loss, ∇L(w, D_t)) of one
    device's batch; ``loss_fn(params, batch)`` returns the mean loss."""
    leaves = [leaf.detach().requires_grad_(True)
              for leaf in tree.leaves(params)]
    loss = loss_fn(tree.unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree.unflatten(params, list(grads))


def local_step(params, batch, loss_fn, lr: float):
    """Eq. (3): w ← w − η ∇L(w, D_t); returns (params', mean loss)."""
    loss, grads = local_grads(params, batch, loss_fn)
    with torch.no_grad():
        return apply_sgd(params, grads, lr), loss


def weighted_average(trees, weights: torch.Tensor):
    """Weighted average over a leading client axis, leaf by leaf (the plain
    form of Eq. 4); an all-zero weight vector gives the zero tree."""
    w = weights.float()
    wn = w / torch.clamp_min(w.sum(), EPS)
    return tree.map(
        lambda leaf: torch.sum(
            leaf.float() * _bcast(wn, leaf), dim=0).to(leaf.dtype), trees)


def internal_sync(client_params, mask: torch.Tensor, batch_sizes=None):
    """Eq. (4): ω_t^m = Σ_{k∈C_t^m} (n^{m,k}/n^m) ω_t^{m,k} over the (K,)
    0/1 selection ``mask`` (uniform batch sizes if None)."""
    w = mask.float()
    if batch_sizes is not None:
        w = w * batch_sizes.float()
    return weighted_average(client_params, w)


def grad_internal_sync(grads, mask: torch.Tensor, batch_sizes=None):
    """Gradient-space Eq. (4): for one SGD step from a common ω, averaging
    the one-step models equals averaging the gradients and stepping once."""
    return internal_sync(grads, mask, batch_sizes)


def external_sync(group_params):
    """Eq. (5): ω_t = (1/M) Σ_m ω_t^m over a leading group axis (plain)."""
    return tree.map(lambda leaf: leaf.float().mean(dim=0).to(leaf.dtype),
                    group_params)


def external_average(group_params):
    """Eq. (5) through the aggregation kernel (uniform weights)."""
    m = tree.leaves(group_params)[0].shape[0]
    w = torch.ones(m, dtype=torch.float32,
                   device=tree.leaves(group_params)[0].device)
    return dispatch.weighted_average_tree(group_params, w)


# ---------------------------------------------------------------------------
# Distributed (collective) forms over torch.distributed ranks (DESIGN.md §8).
# Only all_reduce (SUM, MAX) is issued: with broadcast, the ops that gloo
# also runs on CUDA tensors. ``eager`` (``fn, x -> fn(x)``) runs a
# collective as a break between CUDA graph segments
# (``engine.SegmentedGraph.eager``): a collective is never captured.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GroupMesh:
    """The 'groups' axis of the sharded engine (DESIGN.md §8): ``size``
    shards, one a rank, over the ranks [0, size) of the ``world``; this
    process is ``rank``. ``group`` is their process group (None: the
    default group, which is all of them). A rank at or past ``size`` sits
    out (:attr:`active`). ``GroupMesh()`` is the one-shard fallback: no
    collective at all."""
    size: int = 1
    rank: int = 0
    world: int = 1
    group: Any = None

    @property
    def active(self) -> bool:
        return self.rank < self.size

    def rows(self, m: int) -> slice:
        """This shard's rows of the M groups: [rank·M/n, (rank+1)·M/n)."""
        if m % self.size:
            raise ValueError(f"num_groups={m} must divide over {self.size} "
                             "'groups' shards")
        ml = m // self.size
        return slice(self.rank * ml, (self.rank + 1) * ml)


def all_reduce(x: torch.Tensor, op: str = "sum", group=None, *,
               eager: Callable | None = None) -> torch.Tensor:
    """``x`` reduced over the ranks of ``group`` (None: the default group)
    into a new tensor, ``op`` 'sum' or 'max'; ``x`` is left as it was."""
    def reduce(v: torch.Tensor) -> torch.Tensor:
        out = v.clone()
        dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                                 "max": dist.ReduceOp.MAX}[op], group=group)
        return out
    return reduce(x) if eager is None else eager(reduce, x)


def internal_sync_collective(params, weight, group=None, *,
                             eager: Callable | None = None):
    """Eq. (4) as a weighted sum over the ranks of ``group`` (the JAX
    package's psum over 'data'): Σ_r w_r ω_r / max(Σ_r w_r, EPS), with
    ``weight`` this rank's n^{m,k} (0 if its device was not selected). The
    weight rides in the same buffer: one collective."""
    dev = tree.leaves(params)[0].device
    w = torch.as_tensor(weight, dtype=torch.float32, device=dev).reshape(1)
    flat = agg_weighted.flatten(params, 1)[0]
    s = all_reduce(torch.cat([flat * w, w]), "sum", group, eager=eager)
    return agg_weighted.unflatten(s[:-1] / torch.clamp_min(s[-1], EPS),
                                  params, 0)


def grad_internal_sync_collective(grads, weight, group=None, *,
                                  eager: Callable | None = None):
    """Gradient-space Eq. (4) over the ranks: one SGD step from a common
    ω, so averaging gradients is averaging the one-step models."""
    return internal_sync_collective(grads, weight, group, eager=eager)


def external_sync_collective(params, group=None, *,
                             eager: Callable | None = None):
    """Eq. (5) as the mean over the ranks of ``group`` (the JAX package's
    pmean over 'pod'): one summed buffer, divided by the rank count."""
    n = dist.get_world_size(group)
    s = all_reduce(agg_weighted.flatten(params, 1)[0], "sum", group,
                   eager=eager)
    return agg_weighted.unflatten(s / n, params, 0)


def external_sync_grouped(group_params, mesh: GroupMesh | None = None, *,
                          eager: Callable | None = None):
    """Eq. (5) of the sharded engine (DESIGN.md §8): the mean over the
    local leading group axis through :func:`external_average` (the
    ``agg_weighted`` kernel on the card), then, over a mesh of more than
    one shard, the mean over its ranks. With equal groups per shard the
    mean of the local means is the global mean (to f32 rounding). Without
    a mesh, or with one shard, no collective is issued."""
    g = external_average(group_params)
    if mesh is None or mesh.size == 1:
        return g
    return external_sync_collective(g, mesh.group, eager=eager)


# ---------------------------------------------------------------------------
# Staleness-bounded asynchronous aggregation (DESIGN.md §14.3): a committee
# member that misses an iteration contributes the group's carried blended
# gradient at weight γ^s, s its staleness clock, saturated at max_staleness.
# ---------------------------------------------------------------------------

def staleness_weights(staleness: torch.Tensor, gamma: float) -> torch.Tensor:
    """γ^s for the staleness clocks ``staleness``, in float32 (γ as
    float32, each clock clamped to s ≥ 0 first: a negative clock would
    amplify the stale gradient)."""
    s = torch.clamp_min(staleness.float(), 0.0)
    return torch.pow(torch.full_like(s, float(np.float32(gamma))), s)


def update_staleness(staleness: torch.Tensor, contributed: torch.Tensor,
                     max_staleness: int) -> torch.Tensor:
    """Advance the int32 staleness clock one iteration: 0 where the device
    delivered a fresh gradient (``contributed > 0``), else +1, saturating
    at ``max_staleness``."""
    s = staleness.to(torch.int32)
    return torch.where(contributed > 0, torch.zeros_like(s),
                       torch.clamp_max(s + 1, max_staleness))


def bounded_async_sync(grads, fresh_w: torch.Tensor, g_prev,
                       stale_w: torch.Tensor):
    """The staleness-bounded Eq. (4) written out (the test oracle):

        g = (Σ_k fresh_w_k g_k + (Σ_j stale_w_j) ḡ) / (Σ fresh_w + Σ stale_w)

    over one group's stacked (K, ...) gradient tree ``grads``, the group's
    carried gradient ``g_prev`` (unstacked) and the (K,) weights of the
    fresh and the stale members."""
    fw = fresh_w.float()
    sw_total = torch.sum(stale_w.float())
    denom = torch.clamp_min(torch.sum(fw) + sw_total, EPS)
    return tree.map(
        lambda g, p: ((torch.sum(g.float() * _bcast(fw, g), dim=0)
                       + sw_total * p.float()) / denom).to(p.dtype),
        grads, g_prev)


# ---------------------------------------------------------------------------
# Robust aggregation (DESIGN.md §15.2). A *member* is one row of the stacked
# (K, ...) gradient tree; members with any non-finite value are excluded
# before arithmetic, and an empty surviving set aggregates to the zero tree.
# ---------------------------------------------------------------------------

ROBUST_AGGREGATORS = ("mean", "clip_norm", "trimmed_mean", "coord_median")


def check_robust_agg(method: str) -> str:
    if method not in ROBUST_AGGREGATORS:
        raise ValueError(f"unknown robust_agg: {method!r} "
                         f"(expected one of {ROBUST_AGGREGATORS})")
    return method


def _bcast(v: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Broadcast a (K,) member vector against a (K, ...) leaf."""
    return v.reshape((-1,) + (1,) * (leaf.dim() - 1))


def member_finite(grads) -> torch.Tensor:
    """(K,) bool — True where EVERY coordinate of the member is finite."""
    ok = None
    for leaf in tree.leaves(grads):
        f = torch.isfinite(leaf.reshape(leaf.shape[0], -1).float()).all(1)
        ok = f if ok is None else ok & f
    return ok


def member_norms(grads) -> torch.Tensor:
    """(K,) global L2 norm per member; non-finite coordinates count as 0."""
    sq = None
    for leaf in tree.leaves(grads):
        x = leaf.reshape(leaf.shape[0], -1).float()
        x = torch.where(torch.isfinite(x), x, 0.0)
        s = torch.sum(x * x, dim=1)
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


def member_outlier_flags(grads, clip: float) -> torch.Tensor:
    """(K,) 0/1 — the observable per-member fault signal fed into
    quarantine (DESIGN.md §15.4): non-finite, or global norm above
    ``clip``."""
    bad = ~member_finite(grads) | (member_norms(grads) > clip)
    return bad.float()


def _sanitize(grads, finite: torch.Tensor):
    """Zero out every coordinate of non-finite members (f32 leaves)."""
    return tree.map(
        lambda g: torch.where(_bcast(finite, g), g.float(), 0.0), grads)


def clip_norm_agg(grads, weights: torch.Tensor, clip: float):
    """Weighted mean with per-member global-norm clipping: member k enters
    at ``g_k · min(1, clip/‖g_k‖)`` and weight ``w_k·[finite_k]``."""
    finite = member_finite(grads)
    factor = torch.clamp_max(clip / torch.clamp_min(member_norms(grads), EPS),
                             1.0)
    clean = tree.map(lambda g: g * _bcast(factor, g),
                     _sanitize(grads, finite))
    return weighted_average(clean, weights.float() * finite.float())


def _order_stats(grads, weights: torch.Tensor, reduce_fn):
    """Active members (positive weight AND finite) sorted ascending per
    coordinate, inactive ones pushed to +max so they rank last; each
    coordinate reduced by ``reduce_fn(sorted, n_active)``."""
    active = (weights.float() > 0) & member_finite(grads)
    n = int(active.sum())
    big = torch.finfo(torch.float32).max

    def per_leaf(leaf):
        v = torch.where(_bcast(active, leaf), leaf.float(), big)
        out = reduce_fn(torch.sort(v, dim=0).values, n)
        return (out if n > 0 else torch.zeros_like(out)).to(leaf.dtype)

    return tree.map(per_leaf, grads)


def trimmed_mean_agg(grads, weights: torch.Tensor, trim: int):
    """Coordinate-wise trimmed mean: drop the ``trim`` smallest and largest
    active values per coordinate (saturating at ⌊(n−1)/2⌋), average the
    rest."""

    def reduce_fn(asc, n):
        t_eff = min(trim, max((n - 1) // 2, 0))
        return asc[t_eff:n - t_eff].sum(0) / max(n - 2 * t_eff, 1)

    return _order_stats(grads, weights, reduce_fn)


def coord_median_agg(grads, weights: torch.Tensor):
    """Coordinate-wise median over the active members (mean of the two
    middle order statistics for even n)."""

    def reduce_fn(asc, n):
        lo, hi = max((n - 1) // 2, 0), min(n // 2, asc.shape[0] - 1)
        return (asc[lo] + asc[hi]) * 0.5

    return _order_stats(grads, weights, reduce_fn)


def robust_aggregate(grads, weights: torch.Tensor, method: str, *,
                     clip: float = 10.0, trim: int = 1):
    """Robust Eq. (4) over one group's stacked (K, ...) gradient tree:
    ``mean`` (NOT fault-masked: NaN members propagate, by design),
    ``clip_norm``, ``trimmed_mean`` or ``coord_median``. For the
    order-statistics methods ``weights`` only gate membership (w > 0)."""
    check_robust_agg(method)
    if method == "mean":
        return weighted_average(grads, weights)
    if method == "clip_norm":
        return clip_norm_agg(grads, weights, clip)
    if method == "trimmed_mean":
        return trimmed_mean_agg(grads, weights, trim)
    return coord_median_agg(grads, weights)
