"""FEDGS: Federated Group Synchronization — paper Alg. 1, host engine.

Groups (factories) are a leading axis of size M on every parameter leaf.
One *internal iteration* (Alg. 1 lines 3–8) is: devices report next-batch
class counts; the BS runs GBP-CS for every group (one kernel launch);
ONLY the selected devices generate data; one backward over the all-groups
superbatch gives every group's Eq. (4) gradient, and one SGD step per group
follows (``train_step='grad_avg'`` of the JAX package: FEDGS == FedAvg over
M super nodes with batch nL). Every T iterations comes the Eq. (5) external
average and broadcast, then test-set eval.

Beside that default arm (``grad_avg``, mean aggregation), the loop runs
the JAX package's ``run_fedgs`` host-engine arms for ``train_step=
'model_avg'`` (the paper's literal L one-step models, averaged per group)
and for the corruption-robust layer of DESIGN.md §15: per-member gradients
from one backward at G = M·L, fault injection, a robust Eq. 4
(``dispatch.robust_agg_fn``), the NaN-guard rollback and selection
quarantine; and the §18 compressed sync (DESIGN.md §18.1): with
``compress_int`` each group's aggregated gradient, and with
``compress_ext`` each group's round delta, is top-k sparsified and/or
stochastically int8-quantized under a per-group error-feedback residual
(``core.compress.ef_compress_rows`` over the flat (M, P4) rows, the
``topk_compress`` and ``int8_quant`` kernels on the card), with the
analytic byte ledger in every round record.

The device-resident engine (DESIGN.md §7, §12) follows the host loop:
:func:`make_round_body` runs one round — T iterations of counts, GBP-CS,
image generation and the train step, all drawn on the device from a
round's staged keys, then the Eq. 5 sync and broadcast — with no host copy
and no host read inside; :func:`make_fedgs_experiment` and
:func:`run_fedgs_fused` drive it through ``engine.run_experiment``, on the
card as a CUDA graph per round, the robust layer of §15 included (the
fault trace staged with the keys, applied by the ``corrupt_rows`` kernel).
Both engines take the dynamic environments of §13: a drifting sampler
(its drift trace staged with the keys in the fused round) and the GBP-CS
cadence ``reselect_every`` (:func:`selection.select_or_keep`; in the fused
round one CUDA graph per pattern of rebuild and keep iterations); and the
availability layer of §14: an ``avail_fn`` (``data.AvailFn``, the
``avail_rows`` kernel on the card, t staged with the keys in the fused
round) makes devices drop out and straggle, selection sees the up-mask
(``avail_selection='aware'``), and ``sync`` drops missed committee members
(``'sync'``, with the churn trigger of a cadence) or keeps them at weight
γ^staleness through each group's carried gradient ḡ (``'bounded_async'``,
:func:`_avail_weights`), composed with the robust layer and the
compression as in the JAX package (:func:`_train_iteration`, shared by
both engines). The group-sharded engine (DESIGN.md §8) runs the same
round on each ``torch.distributed`` rank for its M/n groups
(:func:`make_group_mesh`, ``mesh=``): the keys fanned out over all M and
sliced, the shards meeting only in collectives (the re-trigger of a
cadence, the round's metrics and the Eq. 5 average), each an eager break
between CUDA graph segments.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .. import tree
from ..kernels import agg_weighted, robust_agg
from . import (compress, dispatch, distributions, engine, gbp_cs, prng,
               selection, sync)

RoundRecord = engine.RoundRecord

# Span tracing of the host loop: None = off; a dict turns it on and
# collects name -> seconds (chip_smoke.py's profile phase reads it).
SPANS: dict[str, float] | None = None


@contextlib.contextmanager
def span(name: str):
    """Wall time of one step of the loop, summed per name into ``SPANS``
    while tracing is on. The device is synchronised at both ends, so its
    work counts in the span that queued it."""
    if SPANS is None:
        yield
        return
    sync = torch.cuda.synchronize if torch.cuda.is_initialized() else \
        (lambda: None)
    sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sync()
        SPANS[name] = SPANS.get(name, 0.0) + time.perf_counter() - t0


@dataclasses.dataclass(frozen=True)
class FedGSConfig:
    num_groups: int = 10          # M
    devices_per_group: int = 35   # K^m
    num_selected: int = 10        # L
    num_presampled: int = 2       # L_rnd
    iters_per_round: int = 50     # T
    rounds: int = 500             # R
    lr: float = 0.01              # η
    init: str = gbp_cs.MPINV
    gbp_max_iters: int = 64
    selection: str = "gbp_cs"     # 'gbp_cs' | 'random'
    reselect_every: int = 1       # GBP-CS cadence in internal iterations
    sync: str = "sync"            # availability handling of Eq. 4 (§14.3):
    #                               'sync' drops missed devices (weight 0),
    #                               'bounded_async' keeps them at γ^s weight
    #                               through the carried group gradient
    gamma: float = 0.5            # bounded_async staleness decay γ ∈ (0, 1]
    max_staleness: int = 4        # bounded_async staleness cap (≥ 1)
    avail_selection: str = "aware"  # 'aware': GBP-CS never selects dark
    #                               devices; 'blind': selection ignores
    #                               availability (the ablation)
    seed: int = 0
    train_step: str = "grad_avg"  # 'grad_avg' (Eq. 4 in gradient space) |
    #                               'model_avg' (oracle: L one-step models)
    robust_agg: str = "mean"      # Eq. 4 internal aggregation (§15.2)
    robust_clip: float = 10.0     # clip_norm threshold; outlier-flag norm
    robust_trim: int = 1          # trimmed_mean: members trimmed per side
    quarantine_limit: int = 3     # outlier flags before a device is barred
    #                               from selection (§15.4); 0 = off
    nan_guard: bool = True        # isfinite audit + rollback of poisoned
    #                               groups when corruption is injected
    compress_int: str = "none"    # Eq. 4 compression (DESIGN.md §18):
    #                               'none' | 'topk:FRAC' | 'int8' |
    #                               'topk:FRAC+int8' of each group's
    #                               aggregated gradient, per-group EF
    compress_ext: str = "none"    # Eq. 5 compression (same grammar) of
    #                               each group's round delta, per-group EF

    def __post_init__(self):
        if self.selection not in ("gbp_cs", "random"):
            raise ValueError(f"unknown selection: {self.selection!r}")
        if self.init not in gbp_cs.INITIALIZERS:
            raise ValueError(f"unknown init: {self.init!r}")
        if self.reselect_every < 0:
            raise ValueError("reselect_every must be >= 0 (0 = static), got "
                             f"{self.reselect_every}")
        if self.train_step not in ("grad_avg", "model_avg"):
            raise ValueError(f"unknown train_step: {self.train_step!r} "
                             "(expected 'grad_avg' or 'model_avg')")
        if self.sync not in ("sync", "bounded_async"):
            raise ValueError(f"unknown sync mode: {self.sync!r} "
                             "(expected 'sync' or 'bounded_async')")
        if self.sync == "bounded_async":
            if not 0.0 < self.gamma <= 1.0:
                raise ValueError(f"gamma must be in (0, 1], got {self.gamma}")
            if self.max_staleness < 1:
                raise ValueError("max_staleness must be >= 1, got "
                                 f"{self.max_staleness}")
            if self.train_step == "model_avg":
                raise ValueError(
                    "sync='bounded_async' blends gradients and requires "
                    "train_step='grad_avg' (model_avg has no per-group "
                    "gradient to carry)")
        if self.avail_selection not in ("aware", "blind"):
            raise ValueError(
                f"unknown avail_selection: {self.avail_selection!r} "
                "(expected 'aware' or 'blind')")
        sync.check_robust_agg(self.robust_agg)
        if self.robust_agg != "mean" and self.train_step == "model_avg":
            raise ValueError(
                "robust_agg aggregates the per-member gradient stack and "
                "requires train_step='grad_avg' (model_avg averages models)")
        if self.robust_clip <= 0:
            raise ValueError(f"robust_clip must be > 0, "
                             f"got {self.robust_clip}")
        if self.robust_trim < 0:
            raise ValueError(f"robust_trim must be >= 0, "
                             f"got {self.robust_trim}")
        if self.quarantine_limit < 0:
            raise ValueError("quarantine_limit must be >= 0 (0 = off), got "
                             f"{self.quarantine_limit}")
        ci = compress.parse_compress(self.compress_int)  # raises on bad spec
        compress.parse_compress(self.compress_ext)
        if ci is not None and self.train_step != "grad_avg":
            raise ValueError(
                "compress_int compresses the per-group aggregated gradient "
                "and requires train_step='grad_avg' (model_avg averages "
                "models, not gradients)")

    @property
    def l_sel(self) -> int:
        return self.num_selected - self.num_presampled


def replicate_for_groups(params, m: int):
    """Copy a model into every group: leaves (...) → (M, ...)."""
    return tree.map(lambda leaf: leaf.unsqueeze(0).repeat(
        (m,) + (1,) * leaf.dim()), params)


def global_params(group_params):
    return sync.external_sync(group_params)


class Compressor(NamedTuple):
    """The Eq. 4 link's §18 compression for one train step: the parsed
    spec, the (M, P4) EF residual before the step, the iteration's (M, 2)
    keys (numpy, or an int64 tensor on the device) and |θ|."""
    spec: compress.CompressSpec
    e: torch.Tensor
    keys: np.ndarray | torch.Tensor
    n: int

    def __call__(self, g: torch.Tensor):
        """EF-compress the (M, P4) rows g → (y, e', (M,) ‖e'‖₂)."""
        with span("fedgs.train.compress"):
            return compress.ef_compress_rows(g, self.e, self.n, self.spec,
                                             self.keys)


def _train_all_groups(gp, batches, group_loss_fn, cfg: FedGSConfig,
                      tx: Compressor | None = None, weights=None,
                      stale_sum=None, g_prev=None):
    """All-groups superbatch ``grad_avg`` step: ONE backward over the loss
    summed across every group. Group g's loss terms depend only on gp[g],
    so the gradient of the summed weighted loss w.r.t. the stacked params
    IS the stack of per-group Eq. (4) gradients. Returns (gp', (M,) mean
    loss).

    ``weights`` (M, L) are the seats' Eq. 4 weights (1/L each if None);
    the loss weights are ``weights / max(Σ weights + S, 1e-12)``. With the
    §14.3 stale mass ``stale_sum`` S (M,) and the groups' carried gradient
    ``g_prev`` ḡ (M, P4) the step is along g + (S/D)·ḡ (D that
    denominator), and the blend (the transmitted gradient under ``tx``)
    is returned as the next ḡ after the loss. With ``tx`` the gradients
    are flattened once, EF-compressed, and the step applies the
    transmitted y; (e', (M,) err) are appended."""
    leaves = [leaf.detach().requires_grad_(True) for leaf in tree.leaves(gp)]
    params = tree.unflatten(gp, leaves)
    losses = group_loss_fn(params, batches)               # (M, L)
    if weights is None:
        wn = 1.0 / cfg.num_selected
    else:
        denom = weights.sum(-1)
        if stale_sum is not None:
            denom = denom + stale_sum
        denom = torch.clamp_min(denom, 1e-12)
        wn = weights / denom[:, None]
    grads = torch.autograd.grad(torch.sum(losses * wn), leaves)
    with torch.no_grad():
        g = tree.unflatten(gp, list(grads))
        loss = losses.detach().mean(dim=-1)
        if tx is None and stale_sum is None:
            return sync.apply_sgd(params, g, cfg.lr), loss
        flat = agg_weighted.flatten(g, len(losses))
        if stale_sum is not None:
            flat = flat + (stale_sum / denom)[:, None] * g_prev
        out = ()
        if tx is not None:
            flat, e, err = tx(flat)
            out = (e, err)
        new = sync.apply_sgd(params, agg_weighted.unflatten(flat, gp, 1),
                             cfg.lr)
    return (new, loss) + ((flat,) if stale_sum is not None else ()) + out


def member_grads(gp, batches, group_loss_fn):
    """Per-member gradients of every group from ONE backward: each group's
    params are replicated to its L members (G = M·L leaves that require
    grad) and the grouped loss runs on batches reshaped to (M·L, 1, n, ...),
    so each conv layer is one grouped launch over all members. Member
    (m, j) is row m·L + j. Returns ((M, L) mean losses, grads with leaves
    (M·L, ...))."""
    x, y = batches
    m, l = y.shape[:2]
    leaves = [leaf.detach().repeat_interleave(l, dim=0).requires_grad_(True)
              for leaf in tree.leaves(gp)]
    params = tree.unflatten(gp, leaves)
    losses = group_loss_fn(params, (x.reshape((m * l, 1) + x.shape[2:]),
                                    y.reshape(m * l, 1, -1)))   # (M·L, 1)
    grads = torch.autograd.grad(losses.sum(), leaves)
    return losses.detach().reshape(m, l), tree.unflatten(gp, list(grads))


def _train_model_avg(gp, batches, group_loss_fn, cfg: FedGSConfig,
                     weights=None):
    """``train_step='model_avg'``: one SGD step on each of the L members,
    then the Eq. 4 average of the L one-step models per group through the
    aggregation kernel, at the seats' ``weights`` (M, L) (uniform if
    None); a group whose weights are all 0 (its committee went dark)
    keeps its params."""
    losses, grads = member_grads(gp, batches, group_loss_fn)
    m, l = losses.shape
    with torch.no_grad():
        models = tree.map(
            lambda p, g: (p.repeat_interleave(l, dim=0) - cfg.lr * g)
            .reshape((m, l) + g.shape[1:]), gp, grads)
        if weights is None:
            return dispatch.weighted_average_groups(
                models, torch.ones(m, l, device=losses.device)), \
                losses.mean(dim=-1)
        synced = _where_groups(weights.sum(-1) > 0,
                               dispatch.weighted_average_groups(
                                   models, weights), gp)
    return synced, losses.mean(dim=-1)


class RobustStep(NamedTuple):
    """Per-member outputs of the corruption-exposed train step (DESIGN.md
    §15); member axes follow the seating order."""
    hit: torch.Tensor       # (M, L) injected-corruption ground truth
    flags: torch.Tensor     # (M, L) observable outliers: non-finite or
    #                         over-norm
    residual: torch.Tensor  # (M,) ‖robust aggregate − finite-masked mean‖


def _train_robust(gp, batches, fresh_w, trace, group_loss_fn,
                  cfg: FedGSConfig, corrupt_fn, agg_fn,
                  tx: Compressor | None = None, stale_sum=None,
                  g_prev=None):
    """Corruption-exposed Eq. (4) for all groups (DESIGN.md §15): the
    per-member gradients are materialised (fault injection and the order
    statistics need the stack), flattened ONCE into an (M·L, P4) buffer,
    corrupted there in place by the seated members' fault ``trace`` (one
    ``corrupt_fn.apply``: the ``corrupt_rows`` kernel on the card),
    aggregated by ``agg_fn`` at the ``fresh_w`` weights, and applied.
    ``trace`` is (code (M, L), noise keys (M, L, S, 2) or None) on the
    device, ``CorruptionFn.device_trace``'s form, or None without
    corruption. The member stacks are freed before the step returns.
    Returns (gp', (M,) mean loss, RobustStep). With the §14.3 stale mass
    ``stale_sum`` S (M,) and carried gradient ``g_prev`` ḡ (M, P4) the
    robust estimate ĝ, of surviving fresh mass W = Σ fresh_w·[finite],
    is blended as (W·ĝ + S·ḡ)/max(W + S, EPS) and the blend is appended
    (the next ḡ). With ``tx`` the (M, P4) aggregate (the blend) is
    EF-compressed after robust aggregation (the compressor never sees raw
    corrupted members), the transmitted gradient is the one appended, and
    (e', (M,) err) follow."""
    with span("fedgs.train.member_backward"):
        losses, grads = member_grads(gp, batches, group_loss_fn)
    m, l = losses.shape
    with torch.no_grad():
        with span("fedgs.train.corrupt"):
            flat = agg_weighted.flatten(grads, m * l)
            del grads
            if trace is not None:
                code, keys = trace
                corrupt_fn.apply(
                    flat, code.reshape(-1),
                    None if keys is None else keys.reshape(
                        (m * l,) + keys.shape[-2:]),
                    [leaf[0].numel() for leaf in tree.leaves(gp)])
                hit = (code > 0).float()
            else:
                hit = torch.zeros(m, l, device=losses.device)
            flat = flat.view(m, l, -1)
        with span("fedgs.train.aggregate"):
            stats = robust_agg.member_stats(flat)
            finite, norms, clean = stats
            flags = (~finite | (norms > cfg.robust_clip)).float()
            g = agg_fn(flat, fresh_w, stats=stats)
            if cfg.robust_agg == "mean":
                residual = torch.zeros(m, device=losses.device)
            else:
                wf = fresh_w * finite
                gm = agg_weighted.agg_groups(
                    clean, wf / torch.clamp_min(wf.sum(-1, keepdim=True),
                                                sync.EPS))
                residual = torch.sqrt(torch.sum((g - gm) ** 2, dim=-1))
            if stale_sum is not None:
                w_fresh = torch.sum(fresh_w * finite, dim=-1)[:, None]
                s = stale_sum[:, None]
                g = (w_fresh * g + s * g_prev) / torch.clamp_min(
                    w_fresh + s, sync.EPS)
            del flat, clean, stats
        out = ()
        if tx is not None:
            g, e, err = tx(g)
            out = (e, err)
        new = sync.apply_sgd(gp, agg_weighted.unflatten(g, gp, 1), cfg.lr)
    step = RobustStep(hit, flags, residual)
    return (new, losses.mean(dim=-1), step) + (
        (g,) if stale_sum is not None else ()) + out


def _group_finite(group_tree) -> torch.Tensor:
    """(M,) bool — True where every coordinate of the group is finite."""
    ok = None
    for leaf in tree.leaves(group_tree):
        f = torch.isfinite(leaf.reshape(leaf.shape[0], -1)).all(dim=1)
        ok = f if ok is None else ok & f
    return ok


def _where_groups(pred: torch.Tensor, new, old):
    """Per-group select between two trees with a leading group axis;
    ``torch.where(True, new, old)`` returns ``new`` exactly, so the
    all-finite case is bit-identical to no guard at all (DESIGN.md
    §15.3)."""
    return tree.map(lambda n, o: torch.where(
        pred.reshape((-1,) + (1,) * (n.dim() - 1)), n, o), new, old)


def _seats(mask: torch.Tensor, l: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The L seats of each group in fetch order, ``argsort(-mask, stable)``
    (``lax.top_k``'s order; never ``torch.topk`` on a 0/1 mask), and the
    mask values there: ((M, L) indices, (M, L) weights)."""
    idx = torch.argsort(-mask, dim=1, stable=True)[:, :l]
    return idx, mask.gather(1, idx)


class AvailStep(NamedTuple):
    """One iteration's availability bookkeeping (DESIGN.md §14.3), per
    group."""
    fresh_w: torch.Tensor     # (M, L) Eq. 4 weights of the fresh seats
    stale_sum: torch.Tensor   # (M,) S = Σ γ^s over the stale members
    staleness: torch.Tensor   # (M, K) int32 clock after the iteration
    dark: torch.Tensor        # (M,) selected-but-dark count
    stale_mean: torch.Tensor  # (M,) mean staleness of the stale members
    stale_max: torch.Tensor   # (M,) max staleness of the stale members


def _avail_weights(mask: torch.Tensor, avail: torch.Tensor,
                   staleness: torch.Tensor, cfg: FedGSConfig) -> AvailStep:
    """Split the committee ``mask`` (M, K) into fresh and stale members
    under ``avail`` (M, K): ``fresh_w`` at the seats in :func:`_seats`'
    order (the mask's value times the seat's availability), the γ^s mass
    and telemetry from the clock ``staleness`` before the iteration, and
    the clock advanced."""
    idx, vals = _seats(mask, cfg.num_selected)
    stale = mask * (1.0 - avail)
    s_f = staleness.float()
    n_stale = stale.sum(-1)
    return AvailStep(
        fresh_w=vals * avail.gather(1, idx),
        stale_sum=torch.sum(
            stale * sync.staleness_weights(staleness, cfg.gamma), dim=-1),
        staleness=sync.update_staleness(staleness, mask * avail,
                                        cfg.max_staleness),
        dark=n_stale,
        stale_mean=torch.sum(stale * s_f, dim=-1)
        / torch.clamp_min(n_stale, 1.0),
        stale_max=torch.amax(stale * s_f, dim=-1))


class Carry(NamedTuple):
    """What the internal iterations carry beside the models, None where a
    run has none: the quarantine counters (M, K) int32 (§15.4), the Eq. 4
    EF residual (M, P4) (§18.1), and under ``bounded_async`` the staleness
    clock (M, K) int32 and the groups' carried gradient ḡ (M, P4)
    (§14.3)."""
    quar: torch.Tensor | None = None
    e_int: torch.Tensor | None = None
    staleness: torch.Tensor | None = None
    g_prev: torch.Tensor | None = None


ROBUST_METRICS = ("corrupted_selected", "clipped_fraction", "rollbacks",
                  "agg_residual")
AVAIL_METRICS = ("participation", "dark_selected", "staleness_mean",
                 "staleness_max")


def _train_iteration(gp, batches, mask, avail, carry: Carry, trace_fn, tx,
                     group_loss_fn, cfg: FedGSConfig, corrupt_fn, agg_fn):
    """Lines 5–8 of one internal iteration, after selection: the same code
    in the host loop and the fused round, on the device, reading nothing
    back. ``mask`` (M, K) is the committee, ``avail`` (M, K) the up-mask
    (None without an availability schedule), ``tx`` the Eq. 4 compressor
    (its residual is ``carry.e_int``).

    The seats' weights: the mask at the seats (:func:`_seats`) on the
    robust layer, times each seat's availability under ``sync='sync'``
    (a missed member has weight 0), :func:`_avail_weights`' ``fresh_w``
    under ``bounded_async`` with its stale mass S and ``carry.g_prev``.
    Then the train step: with ``agg_fn`` (the robust layer, DESIGN.md
    §15) :func:`_train_robust` with the fault trace ``trace_fn(seats)``,
    the NaN-guard rollback of non-finite groups (their ḡ, staleness clock
    and EF residual roll back with them; a non-finite ḡ or residual marks
    its group too) and the quarantine counters' update; otherwise
    :func:`_train_all_groups` (``grad_avg``) or :func:`_train_model_avg`.
    Returns (gp', (M,) loss, carry', (M,) compression error or None,
    metrics): ``uploads`` (seats of positive weight; a float where every
    seat counts), on the robust layer :data:`ROBUST_METRICS` and with
    ``avail`` the :data:`AVAIL_METRICS` of the iteration (the staleness
    ones under ``bounded_async``), as 0-d tensors."""
    m, l = mask.shape[0], cfg.num_selected
    robust = agg_fn is not None
    quar, e_int, staleness, g_prev = carry
    errs, st, fresh_w, stale = None, None, None, {}
    if avail is not None or robust:
        idx, vals = _seats(mask, l)
        fresh_w = vals
        if avail is not None and carry.staleness is not None:
            st = _avail_weights(mask, avail, carry.staleness, cfg)
            fresh_w = st.fresh_w
            stale = dict(stale_sum=st.stale_sum, g_prev=carry.g_prev)
        elif avail is not None:
            fresh_w = vals * avail.gather(1, idx)
    mets = {}
    if robust:
        out = _train_robust(gp, batches, fresh_w, trace_fn(idx),
                            group_loss_fn, cfg, corrupt_fn, agg_fn, tx,
                            **stale)
        gp_new, loss, rs = out[:3]
    elif cfg.train_step == "model_avg":
        out = _train_model_avg(gp, batches, group_loss_fn, cfg, fresh_w)
        gp_new, loss = out
    else:
        out = _train_all_groups(gp, batches, group_loss_fn, cfg, tx,
                                fresh_w, **stale)
        gp_new, loss = out[:2]
    rest = out[3:] if robust else out[2:]
    if st is not None:
        g_prev, staleness, rest = rest[0], st.staleness, rest[1:]
    if tx is not None:
        e_int, errs = rest
    if robust:
        rb = torch.zeros((), device=mask.device)
        if corrupt_fn is not None and cfg.nan_guard:
            finite_m = _group_finite(gp_new)
            if st is not None:
                finite_m &= torch.isfinite(g_prev).all(dim=1)
            if tx is not None:
                finite_m &= torch.isfinite(e_int).all(dim=1)
                e_int = torch.where(finite_m[:, None], e_int, carry.e_int)
            gp_new = _where_groups(finite_m, gp_new, gp)
            if st is not None:
                g_prev = torch.where(finite_m[:, None], g_prev,
                                     carry.g_prev)
                staleness = torch.where(finite_m[:, None], staleness,
                                        carry.staleness)
            rb = torch.sum(~finite_m).float()
        if quar is not None:
            quar = quar.scatter_add(1, idx, (rs.flags * vals).int())
        mets.update(corrupted_selected=torch.sum(rs.hit * vals),
                    clipped_fraction=torch.sum(rs.flags * vals)
                    / torch.clamp_min(vals.sum(), 1.0),
                    rollbacks=rb, agg_residual=rs.residual.mean())
    mets["uploads"] = float(m * l) if fresh_w is None else \
        torch.sum((fresh_w > 0).float())
    if avail is not None:
        mets["participation"] = avail.mean()
        if st is None:
            mets["dark_selected"] = torch.sum(mask * (1.0 - avail))
        else:
            mets.update(dark_selected=st.dark.sum(),
                        staleness_mean=st.stale_mean.mean(),
                        staleness_max=st.stale_max.max())
    return gp_new, loss, Carry(quar, e_int, staleness, g_prev), errs, mets


def make_group_train_step(group_loss_fn, cfg: FedGSConfig):
    """The non-robust train step: ``step(gp, batches) -> (gp', (M,) loss)``
    — the all-groups superbatch backward for ``grad_avg``, the per-group
    average of one-step models for ``model_avg``."""

    def step(group_params, batches):
        if cfg.train_step == "model_avg":
            return _train_model_avg(group_params, batches, group_loss_fn,
                                    cfg)
        return _train_all_groups(group_params, batches, group_loss_fn, cfg)

    return step


def _external_compress(gp_round0, gp, e_ext, keys, spec, n_par: int):
    """§18 Eq. 5 compression: each group transmits the EF-compressed round
    delta ω_t^m − ω_{t−1} (``gp_round0``, the round-entry broadcast model)
    and the BS applies it. Returns (gp', e_ext', (M,) ‖e'‖₂)."""
    m = e_ext.shape[0]
    base = agg_weighted.flatten(gp_round0, m)
    y, e_ext, err = compress.ef_compress_rows(
        agg_weighted.flatten(gp, m) - base, e_ext, n_par, spec, keys)
    return agg_weighted.unflatten(base + y, gp, 1), e_ext, err


def external_sync_and_broadcast(group_params):
    """Alg. 1 line 10 (Eq. 5): ω_t = mean_m ω_t^m, then ω_t^m ← ω_t."""
    m = tree.leaves(group_params)[0].shape[0]
    return replicate_for_groups(sync.external_average(group_params), m)


def _unpack_state(sel: tuple, cfg: FedGSConfig, quarantined: bool):
    """(mask, distance, :class:`Carry`, Eq. 5 EF residual or None) of a
    carried selection state in :func:`init_selection_state`'s layout."""
    bounded = cfg.sync == "bounded_async"
    i_eint = 4 if bounded else 2
    on_int = compress.parse_compress(cfg.compress_int) is not None
    on_ext = compress.parse_compress(cfg.compress_ext) is not None
    carry = Carry(quar=sel[-1] if quarantined else None,
                  e_int=sel[i_eint] if on_int else None,
                  staleness=sel[2] if bounded else None,
                  g_prev=sel[3] if bounded else None)
    return sel[0], sel[1], carry, sel[i_eint + on_int] if on_ext else None


def _check_run(cfg: FedGSConfig, avail_fn, corrupt_fn) -> bool:
    """Raise on the combinations the engines refuse; True when the run
    takes the robust layer."""
    if cfg.sync == "bounded_async" and avail_fn is None:
        raise ValueError("sync='bounded_async' requires an availability "
                         "schedule (avail_fn)")
    robust = corrupt_fn is not None or cfg.robust_agg != "mean"
    if robust and cfg.train_step != "grad_avg":
        raise ValueError("corruption injection and robust_agg require "
                         "train_step='grad_avg' (the per-member gradient "
                         "stack)")
    return robust


def _avail_fields(rows: list, bounded: bool) -> dict:
    """A round's :data:`AVAIL_METRICS` from its iterations' rows (stacked
    tensors, read back once): participation and staleness averaged, dark
    members summed, the staleness maximum taken."""
    a = torch.stack(rows).cpu().numpy().astype(np.float64)
    out = dict(participation=float(np.mean(a[:, 0])),
               dark_selected=float(np.sum(a[:, 1])))
    if bounded:
        out.update(staleness_mean=float(np.mean(a[:, 2])),
                   staleness_max=float(np.max(a[:, 3])))
    return out


def run_fedgs(params, streams, p_real, cfg: FedGSConfig, *,
              group_loss_fn, avail_fn=None, corrupt_fn=None,
              eval_fn: Callable | None = None, eval_every: int = 10,
              log_fn: Callable[[RoundRecord], None] | None = None):
    """Alg. 1 end to end — the two-phase host loop.

    Per iteration: (1) devices report next-batch class counts; (2) the BS
    runs GBP-CS to pick C_t^m (every ``cfg.reselect_every`` iterations;
    between rebuilds the carried masks are re-scored against the fresh
    counts); (3) ONLY the selected devices generate data and train;
    (4) internal sync. External sync every T iterations. ``params`` and
    ``p_real`` live on the device the run uses.

    ``avail_fn`` (``data.make_availability_fn``, DESIGN.md §14) gives each
    iteration's up-mask of the devices (their flat population ids: the
    streams' ``device_ids(t, gids)`` where they have them, DESIGN.md §17,
    else the dense ids gid·K + slot; the fault trace is hashed on the same):
    GBP-CS sees it under ``avail_selection='aware'``; under ``sync``
    missed committee members train at weight 0 and, with a cadence N ≠ 1,
    a dark or under-strength committee forces a rebuild
    (``reselect_trigger``); under ``bounded_async`` they stay in Eq. 4 at
    γ^staleness through each group's carried gradient. The availability
    telemetry (participation, dark members, staleness) joins the records.

    ``corrupt_fn`` (``data.make_corruption_fn``) injects gradient faults
    and, with ``cfg.robust_agg != 'mean'`` alone too, switches to the
    robust layer (DESIGN.md §15): members seated in ``argsort(-mask)``
    order, per-member gradients, robust Eq. 4 at weights ``fresh_w`` (the
    mask values at the seats, times their availability: 0 where
    quarantine left a group fewer than L eligible devices or a member
    missed the iteration), the NaN-guard rollback of non-finite groups,
    and quarantine counters folded into selection.

    ``cfg.compress_int`` / ``compress_ext`` (DESIGN.md §18.1) compress the
    Eq. 4 gradient (after robust aggregation and the stale blend) and the
    Eq. 5 round delta ω_t^m − ω_{t−1}, each with a per-group (M, P4) EF
    residual; the uploads of the byte ledger are the seats of positive
    weight. The int keys fold 909 off the iteration key and leave the key
    chain alone; the external keys take one ``split`` of it per round. The
    NaN guard also rolls back a non-finite internal residual. With both
    specs ``'none'`` none of this runs. Returns (global params,
    [RoundRecord]).
    """
    dev = tree.leaves(params)[0].device
    m, k, l = cfg.num_groups, cfg.devices_per_group, cfg.num_selected
    robust = _check_run(cfg, avail_fn, corrupt_fn)
    bounded = cfg.sync == "bounded_async"
    quarantined = corrupt_fn is not None and cfg.quarantine_limit > 0
    agg_fn = dispatch.robust_agg_fn(cfg.robust_agg, clip=cfg.robust_clip,
                                    trim=cfg.robust_trim) if robust else None
    gp = replicate_for_groups(params, m)
    key = prng.PRNGKey(cfg.seed)
    p_real = torch.as_tensor(np.asarray(p_real), dtype=torch.float32,
                             device=dev)
    mask_c, dist_c, carry, e_ext = _unpack_state(init_selection_state(
        cfg, params, quarantine=quarantined), cfg, quarantined)
    # resident population ids (DESIGN.md §17): the streams' device_ids of
    # iteration t where they have them (DeviceBackedStreams over a lazy or
    # candidate sampler), else the dense grid gid·K + slot
    ids_fn = getattr(streams, "device_ids", None)
    dense_ids = np.arange(m * k).reshape(m, k)
    flat_ids = torch.arange(m * k, device=dev)
    n_leaves = len(tree.leaves(params))
    # §18 compression: parsed specs, EF residuals, the Eq. 4/5 byte ledger
    # (one-direction payload of |θ| parameters, 4|θ| when dense)
    spec_int = compress.parse_compress(cfg.compress_int)
    spec_ext = compress.parse_compress(cfg.compress_ext)
    n_par = sum(leaf.numel() for leaf in tree.leaves(params))
    payload_int = compress.payload_bytes(n_par, spec_int)
    payload_ext = compress.payload_bytes(n_par, spec_ext)
    logs: list[RoundRecord] = []
    t = 0
    for r in range(cfg.rounds):
        stats, rstats, astats, ups, cerrs = [], [], [], [], []
        resel, uploads = 0, 0.0
        gp_round0 = gp          # round-entry broadcast model (Eq. 5 Δ base)
        for _ in range(cfg.iters_per_round):
            with span("fedgs.select"):
                key, sub = prng.split(key)
                counts = torch.as_tensor(streams.next_counts(), device=dev)
                keys = prng.split(sub, m)
                tx = None if spec_int is None else Compressor(
                    spec_int, carry.e_int, prng.split(prng.fold_in(
                        sub, compress.FOLD_COMPRESS), m), n_par)
                disc = distributions.group_discrepancy(counts, p_real).mean()
                ids = dense_ids if ids_fn is None else ids_fn(t, np.arange(m))
                avail = None if avail_fn is None else avail_fn(
                    t, flat_ids if ids_fn is None else torch.as_tensor(
                        ids.reshape(-1), device=dev))[0].view(m, k)
                sel_avail = avail if cfg.avail_selection == "aware" else None
                if quarantined:
                    ok = selection.quarantine_mask(carry.quar,
                                                   cfg.quarantine_limit)
                    sel_avail = ok if sel_avail is None else sel_avail * ok
                do = selection.reselect_predicate(t, cfg.reselect_every)
                if sel_avail is not None and not bounded \
                        and cfg.reselect_every != 1:
                    do = selection.reselect_trigger(do, mask_c, sel_avail, l)
                mask_c, div, dist_c = selection.select_or_keep(
                    do, keys, counts, p_real, l, cfg.num_presampled,
                    prev_mask=mask_c, prev_distance=dist_c, avail=sel_avail,
                    method=cfg.selection, init=cfg.init,
                    max_iters=cfg.gbp_max_iters)
                resel += int(do)
                host_mask = mask_c.cpu().numpy()
            with span("fedgs.fetch"):
                imgs, labs = streams.fetch_selected(host_mask, l)
                batches = (torch.as_tensor(imgs, device=dev),
                           torch.as_tensor(labs, device=dev).long())
            with span("fedgs.train"):
                # the fault trace of the seated devices, hashed on the host
                # from their ids (seats as _seats orders them)
                trace = None if corrupt_fn is None else \
                    corrupt_fn.device_trace(t, np.take_along_axis(
                        ids, np.argsort(-host_mask, axis=1,
                                        kind="stable")[:, :l], axis=1),
                        n_leaves, dev)
                gp, loss, carry, errs, mets = _train_iteration(
                    gp, batches, mask_c, avail, carry, lambda idx: trace,
                    tx, group_loss_fn, cfg, corrupt_fn, agg_fn)
                if robust:
                    rstats.append(torch.stack([mets[name] for name in
                                               ROBUST_METRICS]))
                if avail is not None:
                    astats.append(torch.stack([mets[name] for name in
                                               AVAIL_METRICS if name in mets]))
                if isinstance(mets["uploads"], float):
                    uploads += mets["uploads"]
                else:
                    ups.append(mets["uploads"])
                if tx is not None:
                    cerrs.append(errs.mean())
            stats.append(torch.stack([loss.mean(), div.mean(), disc,
                                      dist_c.mean()]))
            t += 1
        with span("fedgs.external_sync"):
            if spec_ext is not None:
                with span("fedgs.external_sync.compress"):
                    key, esub = prng.split(key)
                    gp, e_ext, err = _external_compress(
                        gp_round0, gp, e_ext, prng.split(esub, m), spec_ext,
                        n_par)
                    cerrs.append(err.mean())
            gp = external_sync_and_broadcast(gp)
        tl = ta = None
        if eval_fn is not None and (r + 1) % eval_every == 0:
            with span("fedgs.eval"):
                tl, ta = (float(v) for v in eval_fn(global_params(gp)))
        loss, div, disc, dist = np.mean(
            torch.stack(stats).cpu().numpy().astype(np.float64), axis=0)
        if ups:
            uploads += float(torch.stack(ups).sum())
        fields = _avail_fields(astats, bounded) if astats else {}
        if rstats:
            rs_np = torch.stack(rstats).cpu().numpy().astype(np.float64)
            fields.update(
                corrupted_selected=float(np.sum(rs_np[:, 0])),
                clipped_fraction=float(np.mean(rs_np[:, 1])),
                rollbacks=float(np.sum(rs_np[:, 2])),
                agg_residual=float(np.mean(rs_np[:, 3])))
        if cerrs:
            fields["compress_error"] = float(np.sum(
                torch.stack(cerrs).cpu().numpy().astype(np.float64))
                / len(cerrs))
        log = RoundRecord(
            round=r, loss=float(loss), divergence=float(div),
            test_loss=tl, test_accuracy=ta, strategy="fedgs",
            group_discrepancy=float(disc), selection_distance=float(dist),
            reselections=float(resel),
            bytes_int=2.0 * payload_int * uploads,
            bytes_ext=2.0 * payload_ext * m, **fields)
        logs.append(log)
        if log_fn is not None:
            log_fn(log)
    return global_params(gp), logs


# ---------------------------------------------------------------------------
# The device-resident engine (DESIGN.md §7, §12).
#
# The whole key chain of a round depends on nothing the device computes:
# the iteration sub-keys, the groups' keys and pre-sample permutations, the
# stream's label and image keys and the compression keys. The host derives
# them with the same numpy split/fold_in as the host loop (RoundKeys) and
# one copy puts them into a static device buffer before each round; the
# round itself (make_round_body) then runs with no host copy and no host
# read, so on the card it is captured once as a CUDA graph and replayed.
# ---------------------------------------------------------------------------

def make_group_mesh(num_groups: int | None = None) -> sync.GroupMesh:
    """The 'groups' mesh of the sharded engine (DESIGN.md §8) over the
    ranks of the initialised ``torch.distributed`` world: each shard
    simulates M/n super nodes, n the world size when ``num_groups`` divides
    over it, else its largest divisor below the world size, as the JAX
    package picks it. Ranks at or past n sit out (``GroupMesh.active``):
    their ``run_fedgs_fused`` returns at once, before any collective. All
    ranks must call it (a mesh smaller than the world is a new process
    group). Without an initialised process group it is the one-shard mesh:
    the transparent fallback, with no collective at all."""
    if not (dist.is_available() and dist.is_initialized()):
        return sync.GroupMesh()
    world, n = dist.get_world_size(), dist.get_world_size()
    if num_groups is not None:
        while num_groups % n:
            n -= 1
    group = None if n in (1, world) else dist.new_group(ranks=list(range(n)))
    return sync.GroupMesh(size=n, rank=dist.get_rank(), world=world,
                          group=group)


def init_selection_state(cfg: FedGSConfig, params, *,
                         quarantine: bool = False) -> tuple:
    """Initial carried selection state of the round body, on the params'
    device, as the JAX package lays the carry out: ``(mask (M, K),
    distance (M,))``, all zero (iteration 0 always selects); under
    ``sync='bounded_async'`` the (M, K) int32 staleness clock at
    ``max_staleness`` and the groups' carried gradient ḡ, an (M, P4) zero
    buffer (§14.3); then the §18 error-feedback residuals — ``e_int`` then
    ``e_ext``, each an (M, P4) zero buffer — where compression is on, and
    with ``quarantine`` (corruption injection and ``quarantine_limit`` >
    0, DESIGN.md §15.4) the (M, K) int32 outlier-flag counters LAST."""
    m, k = cfg.num_groups, cfg.devices_per_group
    dev = tree.leaves(params)[0].device
    sel = (torch.zeros(m, k, device=dev), torch.zeros(m, device=dev))
    on = [compress.parse_compress(spec) is not None
          for spec in (cfg.compress_int, cfg.compress_ext)]
    bounded = cfg.sync == "bounded_async"
    if bounded or any(on):
        p4 = compress.zero_residual(
            tree.map(lambda v: v[None], params)).shape[1]
    if bounded:
        sel += (torch.full((m, k), cfg.max_staleness, dtype=torch.int32,
                           device=dev), torch.zeros(m, p4, device=dev))
    sel += tuple(torch.zeros(m, p4, device=dev) for _ in range(sum(on)))
    if quarantine:
        sel += (torch.zeros(m, k, dtype=torch.int32, device=dev),)
    return sel


class RoundKeys:
    """One round's key material, derived on the host and packed into one
    int64 buffer of uint32 words: per iteration the pre-sample
    permutations (T, M, K), the random initializer's keys (T, M, 2), the
    stream's label and image keys (T, M, 2, 2), with ``compress_int`` the
    Eq. 4 keys (T, M, 2), the staged words of the devices seated in the
    M·K slots (T, M, K, W) (``sampler.seats``: their flat population ids,
    DESIGN.md §17, then what the population view stages for them), with a
    corruption schedule (``corrupt_fn``, a ``data.CorruptionFn``) the
    fault trace of all M·K seated devices — codes (T, M, K) and, when the
    mix draws noise, each leaf's noise keys (T, M, K, S, 2) for the
    model's S = ``num_leaves`` leaves; with a drifting sampler
    (``sampler.drift``, DESIGN.md §13) the drift trace of all M·K seated
    devices (T, M, K, 4); with
    an availability schedule (``avail``, DESIGN.md §14) each iteration's
    t (T,), which the trace's kernel reads on the device; with
    ``compress_ext`` the round's Eq. 5 keys (M, 2). :meth:`host` advances
    the key chain exactly as the host loop does (the traces hash their own
    keys and leave the chain alone); :meth:`views` names the parts of a
    buffer.

    ``rows`` (a slice of the M groups; all of them by default) stages one
    shard's rows only (DESIGN.md §8): the fan-outs over groups are split
    over all M and sliced, and the sampler's keys and seats and the traces
    are taken at the shard's global group ids, so a group's material does
    not depend on the shard count."""

    def __init__(self, cfg: FedGSConfig, sampler, corrupt_fn=None,
                 num_leaves: int = 0, avail: bool = False,
                 rows: slice | None = None):
        t, k = cfg.iters_per_round, cfg.devices_per_group
        self.gids = np.arange(cfg.num_groups)[rows or slice(None)]
        m = len(self.gids)
        self.cfg, self.sampler = cfg, sampler
        self.corrupt_fn, self.num_leaves = corrupt_fn, num_leaves
        self.spec_int = compress.parse_compress(cfg.compress_int)
        self.spec_ext = compress.parse_compress(cfg.compress_ext)
        self.shapes = {"perm": (t, m, k), "opt": (t, m, 2),
                       "data": (t, m, 2, 2),
                       "seats": (t, m, k, sampler.stream.staged_words)}
        if self.spec_int is not None:
            self.shapes["cint"] = (t, m, 2)
        if corrupt_fn is not None:
            self.shapes["ccode"] = (t, m, k)
            if corrupt_fn.noisy:
                self.shapes["cnoise"] = (t, m, k, num_leaves, 2)
        if sampler.drift is not None:
            self.shapes["drift"] = (t, m, k, 4)
        if avail:
            self.shapes["t"] = (t,)
        if self.spec_ext is not None:
            self.shapes["cext"] = (m, 2)
        self.size = sum(math.prod(s) for s in self.shapes.values())

    def host(self, key: np.ndarray, t0: int) -> tuple[np.ndarray, np.ndarray]:
        """(key', flat int64 material) of the round whose first iteration
        is ``t0``."""
        cfg, gids = self.cfg, self.gids
        m, k = cfg.num_groups, cfg.devices_per_group
        parts = {name: [] for name in self.shapes}
        for i in range(cfg.iters_per_round):
            key, sub = prng.split(key)
            perm, opt = selection.presample_keys(prng.split(sub, m)[gids], k,
                                                 cfg.selection)
            parts["perm"].append(perm)
            parts["opt"].append(opt)
            parts["data"].append(self.sampler.keys(t0 + i, gids))
            ids = self.sampler.device_ids(t0 + i, gids)
            parts["seats"].append(self.sampler.stream.stage(ids))
            if self.spec_int is not None:
                parts["cint"].append(prng.split(prng.fold_in(
                    sub, compress.FOLD_COMPRESS), m)[gids])
            if self.corrupt_fn is not None:
                code, noise = self.corrupt_fn.trace(t0 + i, ids,
                                                    self.num_leaves)
                parts["ccode"].append(code)
                if noise is not None:
                    parts["cnoise"].append(noise)
            if "drift" in parts:
                parts["drift"].append(self.sampler.drift.trace(t0 + i, ids))
            if "t" in parts:
                parts["t"].append(t0 + i)
        if self.spec_ext is not None:
            key, esub = prng.split(key)
            parts["cext"] = prng.split(esub, m)[gids]
        flat = np.concatenate([np.asarray(parts[name], np.int64).reshape(-1)
                               for name in self.shapes])
        return key, flat

    def views(self, buf: torch.Tensor) -> dict[str, torch.Tensor]:
        out, off = {}, 0
        for name, shape in self.shapes.items():
            n = math.prod(shape)
            out[name] = buf[off:off + n].view(shape)
            off += n
        return out


def round_pattern(cfg: FedGSConfig, r: int) -> tuple[bool, ...]:
    """Round r's iterations that rebuild the super nodes on the cadence
    alone (``reselect_predicate(r·T + i, N)``): all of them at N = 1."""
    t0 = r * cfg.iters_per_round
    return tuple(selection.reselect_predicate(t0 + i, cfg.reselect_every)
                 for i in range(cfg.iters_per_round))


def make_round_body(group_loss_fn, cfg: FedGSConfig, sampler, *,
                    avail_fn=None, corrupt_fn=None,
                    mesh: sync.GroupMesh | None = None):
    """The one-round body of the device-resident engine:
    ``body(gp, sel, keys, p_real, pinv_fn=None, pattern=None, eager=None)
    -> (gp', sel', metrics)``.

    ``keys`` are :meth:`RoundKeys.views` of the round's staged material and
    ``sel`` the carried state of :func:`init_selection_state`. Each of the
    T iterations draws the seated devices' labels, counts and (for the
    selected devices only) images on the device (``sampler``, a
    ``data.DeviceSampler`` over a dense or lazy population, from the
    iteration's staged seats, DESIGN.md §17; drifting under the staged
    drift trace when it drifts), runs GBP-CS for all groups from the
    staged permutations, and
    takes the train step of :func:`_train_iteration`, the host loop's: the
    all-groups superbatch step (or the ``model_avg`` step), with the §18
    Eq. 4 compression and its EF residual in the carry; the round ends with
    the Eq. 5 compression of the round delta, the Eq. 5 average and the
    broadcast. With ``corrupt_fn`` (a ``data.CorruptionFn``) or
    ``cfg.robust_agg != 'mean'`` each iteration runs the robust layer
    instead (DESIGN.md §15): the quarantine counters (the carry's last
    leaf) bar repeat offenders from selection, the seated members' fault
    trace is gathered from the staged trace of all devices, and the
    per-member step, the NaN guard and the counters' update follow, as in
    the host loop. With ``avail_fn`` (a ``data.AvailFn``, DESIGN.md §14)
    each iteration's up-mask of the M·K seated devices (their population
    ids) is drawn on the device at the staged t (the ``avail_rows`` kernel
    reads it there) and enters
    selection and Eq. 4 as in the host loop; under ``bounded_async`` the
    staleness clock and ḡ ride in the carry.

    ``pattern`` (:func:`round_pattern`; None = every iteration) says which
    iterations rebuild on the cadence (DESIGN.md §13): the others keep the
    carried masks and only re-score them (``selection.select_or_keep``),
    unless quarantine or (under ``sync``) availability can force a rebuild
    (``reselect_trigger``, read from the device): then they run GBP-CS
    too, and ``torch.where`` on the device predicate picks the branch —
    ``lax.cond``'s results, with no read-back, at the cost of a solve (and
    its pinv) on every iteration.

    ``metrics`` holds (T,) tensors ``loss``, ``divergence``,
    ``group_discrepancy``, ``selection_distance``, ``reselected``,
    ``bytes_int`` (and ``compress_error_int``; on the robust layer also
    :data:`ROBUST_METRICS`, with availability its :data:`AVAIL_METRICS`),
    and the round's ``bytes_ext`` (and ``compress_error_ext``). Nothing
    reads back to the host or copies from it; ``pinv_fn`` is handed to the
    mpinv initializer (a captured round breaks its graph there).

    With a ``mesh`` of n > 1 shards (:func:`make_group_mesh`, DESIGN.md
    §8) the body is one rank's part of the round: ``gp`` and ``sel`` hold
    its M/n rows and ``keys`` its rows of the staged material
    (:class:`RoundKeys` ``rows``), and the shards meet in three
    collectives, each through ``eager`` (``fn, x -> fn(x)``: a break
    between graph segments in a captured round): a keep iteration's
    re-trigger is OR-ed over the shards (a MAX), so that every shard takes
    the same branch; the (T,) metrics are combined once a round as the JAX
    package combines them per iteration (:func:`_combine_shards`); and the
    Eq. 5 epilogue is the mean of the local means
    (``sync.external_sync_grouped``), broadcast to the M/n rows. Without a
    mesh, or with one shard, no collective is issued."""
    m, k, l = cfg.num_groups, cfg.devices_per_group, cfg.num_selected
    rows = slice(0, m) if mesh is None else mesh.rows(m)   # "must divide"
    m_local = rows.stop - rows.start
    shards = None if mesh is None or mesh.size == 1 else mesh
    robust = _check_run(cfg, avail_fn, corrupt_fn)
    bounded = cfg.sync == "bounded_async"
    quarantined = corrupt_fn is not None and cfg.quarantine_limit > 0
    agg_fn = dispatch.robust_agg_fn(cfg.robust_agg, clip=cfg.robust_clip,
                                    trim=cfg.robust_trim) if robust else None
    spec_int = compress.parse_compress(cfg.compress_int)
    spec_ext = compress.parse_compress(cfg.compress_ext)
    gids = torch.arange(rows.start, rows.stop, device=sampler.device)
    names = ("loss", "divergence", "group_discrepancy",
             "selection_distance") + (ROBUST_METRICS if robust else ()) + (
        AVAIL_METRICS[:4 if bounded else 2] if avail_fn is not None
        else ())
    per_seat = robust or avail_fn is not None   # uploads vary by iteration

    def seated_trace(keys, i, idx):
        """The staged trace of iteration i gathered at the seats idx."""
        if corrupt_fn is None:
            return None
        code = keys["ccode"][i].gather(1, idx)
        noise = keys.get("cnoise")
        if noise is not None:
            s = noise.shape[-2]
            noise = noise[i].gather(1, idx[..., None, None].expand(
                m_local, l, s, 2))
        return code, noise

    def body(gp, sel, keys, p_real, pinv_fn=None, pattern=None, eager=None):
        pattern = pattern or (True,) * cfg.iters_per_round
        reduce = None if shards is None else lambda x, op: sync.all_reduce(
            x, op, shards.group, eager=eager)
        n_par = sum(leaf[0].numel() for leaf in tree.leaves(gp))
        payload_int = compress.payload_bytes(n_par, spec_int)
        gp_round0 = gp
        mask, dist, carry, e_ext = _unpack_state(sel, cfg, quarantined)
        rows = {name: [] for name in names}
        uploads = []
        cerrs, resel = [], []
        for i in range(cfg.iters_per_round):
            seats = keys["seats"][i]
            labels = sampler.labels(keys["data"][i], gids,
                                    keys["drift"][i] if "drift" in keys
                                    else None, seats)
            counts = sampler.counts(labels)
            avail = None if avail_fn is None else avail_fn(
                keys["t"][i], seats[..., 0].reshape(-1))[0].view(m_local, k)
            sel_avail = avail if cfg.avail_selection == "aware" else None
            if quarantined:
                ok = selection.quarantine_mask(carry.quar,
                                               cfg.quarantine_limit)
                sel_avail = ok if sel_avail is None else sel_avail * ok
            do = pattern[i]
            if not do and sel_avail is not None and not bounded:
                do = selection.reselect_trigger(
                    torch.zeros((), dtype=torch.bool, device=gids.device),
                    mask, sel_avail, l)
                if reduce is not None:   # one shard's dark seat: all rebuild
                    do = reduce(do.float().reshape(1), "max")[0] > 0
            mask, div, dist = selection.select_or_keep(
                do, (keys["perm"][i], keys["opt"][i]), counts, p_real, l,
                cfg.num_presampled, prev_mask=mask, prev_distance=dist,
                avail=sel_avail, method=cfg.selection, init=cfg.init,
                max_iters=cfg.gbp_max_iters, pinv_fn=pinv_fn)
            resel.append(do)
            batches = sampler.selected_batch(labels, keys["data"][i], gids,
                                             mask, l, seats)
            tx = None if spec_int is None else Compressor(
                spec_int, carry.e_int, keys["cint"][i], n_par)
            gp, loss, carry, errs, im = _train_iteration(
                gp, batches, mask, avail, carry,
                lambda idx: seated_trace(keys, i, idx), tx, group_loss_fn,
                cfg, corrupt_fn, agg_fn)
            for name in names[4:]:
                rows[name].append(im[name])
            if per_seat:
                uploads.append(im["uploads"])
            if tx is not None:
                cerrs.append(errs.mean())
            rows["loss"].append(loss.mean())
            rows["divergence"].append(div.mean())
            rows["group_discrepancy"].append(
                distributions.group_discrepancy(counts, p_real).mean())
            rows["selection_distance"].append(dist.mean())
        t = cfg.iters_per_round
        mets = {name: torch.stack(v) for name, v in rows.items()}
        if per_seat:
            mets["uploads"] = torch.stack(uploads)
        mets["reselected"] = torch.ones(t, device=gids.device)
        for i, do in enumerate(resel):      # device ops only (a capture)
            if isinstance(do, torch.Tensor):
                mets["reselected"][i].copy_(do)
            elif not do:
                mets["reselected"][i].fill_(0.0)
        new_sel = (mask, dist)
        if bounded:
            new_sel += (carry.staleness, carry.g_prev)
        if spec_int is not None:
            new_sel += (carry.e_int,)
            mets["compress_error_int"] = torch.stack(cerrs)
        if spec_ext is not None:
            gp, e_ext, err = _external_compress(
                gp_round0, gp, e_ext, keys["cext"], spec_ext, n_par)
            new_sel += (e_ext,)
            mets["compress_error_ext"] = err.mean()
        if quarantined:
            new_sel += (carry.quar,)
        if reduce is not None:
            mets = _combine_shards(mets, reduce, shards.size)
        # the byte ledger counts all M·L seats: the summed uploads, or the
        # constant global m·l
        mets["bytes_int"] = 2.0 * payload_int * mets.pop("uploads") \
            if per_seat else torch.full((t,), 2.0 * payload_int * m * l,
                                        device=gids.device)
        mets["bytes_ext"] = torch.full(
            (), 2.0 * compress.payload_bytes(n_par, spec_ext) * m,
            device=gids.device)
        g = sync.external_sync_grouped(gp, shards, eager=eager)
        return replicate_for_groups(g, m_local), new_sel, mets

    return body


SUMMED = ("dark_selected", "corrupted_selected", "rollbacks", "uploads")
MAXED = ("staleness_max",)


def _combine_shards(mets: dict, reduce: Callable, n: int) -> dict:
    """One round's shard-local metrics → the mesh's, as the JAX package
    combines each iteration's (its ``psum``/``pmean``/``pmax`` over
    'groups'): :data:`SUMMED` summed over the shards, :data:`MAXED` maxed,
    the rest (loss, divergence, discrepancy, distance, participation, mean
    staleness, clipped fraction, residual, both compression errors)
    averaged; ``reselected`` is the same on every shard and stays. One
    packed SUM and, under ``bounded_async``, one MAX ``reduce(x, op)``."""
    summed = [name for name in mets if name not in MAXED + ("reselected",)]
    total = reduce(torch.cat([mets[name].reshape(-1) for name in summed]),
                   "sum")
    out, off = dict(mets), 0
    for name in summed:
        v = total[off:off + mets[name].numel()].view(mets[name].shape)
        out[name] = v if name in SUMMED else v / n
        off += mets[name].numel()
    for name in MAXED:
        if name in mets:
            out[name] = reduce(mets[name], "max")
    return out


def _round_record_metrics(mets: dict, cfg: FedGSConfig) -> dict:
    """A round's (T,) metrics → the round's scalars, on the device."""
    out = {"loss": mets["loss"].mean(),
           "divergence": mets["divergence"].mean(),
           "group_discrepancy": mets["group_discrepancy"].mean(),
           "selection_distance": mets["selection_distance"].mean(),
           "reselections": mets["reselected"].sum(),
           "bytes_int": mets["bytes_int"].sum(),
           "bytes_ext": mets["bytes_ext"]}
    if "participation" in mets:
        out["participation"] = mets["participation"].mean()
        out["dark_selected"] = mets["dark_selected"].sum()
    if "staleness_mean" in mets:
        out["staleness_mean"] = mets["staleness_mean"].mean()
        out["staleness_max"] = mets["staleness_max"].max()
    if "corrupted_selected" in mets:
        out["corrupted_selected"] = mets["corrupted_selected"].sum()
        out["clipped_fraction"] = mets["clipped_fraction"].mean()
        out["rollbacks"] = mets["rollbacks"].sum()
        out["agg_residual"] = mets["agg_residual"].mean()
    errs = []
    if "compress_error_int" in mets:
        errs.append(mets["compress_error_int"].sum())
    if "compress_error_ext" in mets:
        errs.append(mets["compress_error_ext"])
    if errs:
        n_ev = (cfg.iters_per_round if "compress_error_int" in mets else 0) \
            + ("compress_error_ext" in mets)
        out["compress_error"] = sum(errs) / n_ev
    return out


class FusedRound(engine.GraphedRound):
    """``round_fn(state, r)`` of the fused experiment. State is (group
    params, carried selection state, the host's threefry key). Each call
    derives the round's keys on the host (:class:`RoundKeys`), stages them
    in the static key buffer (:attr:`keys` names its parts), and runs the
    body through ``engine.GraphedRound``: eagerly, or as a CUDA graph
    captured after one eager warm-up round and replayed, group params,
    selection state and EF residuals in static tensors. The round breaks
    around ``torch.linalg.pinv``, whose SVD reads a status back to the host
    and cannot be captured (``engine.SegmentedGraph``): one eager pinv per
    iteration between two graph segments. Each round's
    :func:`round_pattern` is its variant: one capture per pattern of
    rebuild and keep iterations, at its first use (a keep iteration has no
    pinv, so no break). On a mesh of more than one shard each collective
    of the body is such a break too: NCCL's and gloo's, never captured."""

    def __init__(self, body, layout: RoundKeys, cfg: FedGSConfig, p_real,
                 device, graph: bool):
        super().__init__(layout.size, device, graph)
        self.body, self.layout, self.cfg = body, layout, cfg
        self.p_real = p_real
        self.keys = layout.views(self.inputs)

    def step(self, carry, inputs, segs, variant):
        pinv_fn = eager = None
        if segs is not None:
            pinv_fn = lambda A: segs.eager(
                gbp_cs.pinv, A, A.shape[:-2] + (A.shape[-1], A.shape[-2]))
            eager = lambda fn, x: segs.eager(fn, x, x.shape)
        gp, sel, mets = self.body(*carry, self.keys, self.p_real, pinv_fn,
                                  variant, eager)
        return (gp, sel), _round_record_metrics(mets, self.cfg)

    def __call__(self, state, r: int):
        gp, sel, key = state
        key, material = self.layout.host(key, r * self.cfg.iters_per_round)
        (gp, sel), mets = self.run((gp, sel), material,
                                   round_pattern(self.cfg, r))
        return (gp, sel, key), mets


def make_fedgs_experiment(params, sampler, p_real, cfg: FedGSConfig, *,
                          group_loss_fn, avail_fn=None, corrupt_fn=None,
                          mesh: sync.GroupMesh | None = None,
                          eval_fn: Callable | None = None,
                          graph: bool | None = None):
    """FEDGS as an ``engine.Experiment`` (DESIGN.md §12): state is (group
    params (M, ...), carried selection state, threefry key); one round is
    :func:`make_round_body` at ``t0 = r·T`` through a :class:`FusedRound`.
    ``graph`` (default: whether the params lie on a card) captures the
    round as a CUDA graph; the CPU always runs it eagerly. On a ``mesh``
    (DESIGN.md §8) the state holds this rank's M/n rows of the full-M
    carry (:func:`init_selection_state`'s rows [rank·M/n, (rank+1)·M/n),
    as the JAX package shards every leaf), the key chain whole; every rank
    ends a round with the same global params, so ``params_fn`` (row 0)
    and the eval agree on every rank. A rank outside the mesh raises."""
    if mesh is not None and not mesh.active:
        raise ValueError(f"rank {mesh.rank} sits outside the {mesh.size}-"
                         "shard 'groups' mesh")
    body = make_round_body(group_loss_fn, cfg, sampler, avail_fn=avail_fn,
                           corrupt_fn=corrupt_fn, mesh=mesh)
    rows = slice(None) if mesh is None else mesh.rows(cfg.num_groups)
    dev = tree.leaves(params)[0].device
    quarantine = corrupt_fn is not None and cfg.quarantine_limit > 0
    if graph is None:
        graph = dev.type == "cuda"
    if graph and dev.type != "cuda":
        raise ValueError("a CUDA graph needs the params on a card")
    p_real = torch.as_tensor(np.asarray(p_real), dtype=torch.float32,
                             device=dev)
    layout = RoundKeys(cfg, sampler, corrupt_fn, len(tree.leaves(params)),
                       avail=avail_fn is not None, rows=rows)
    round_fn = FusedRound(body, layout, cfg, p_real, dev, graph)
    sel = init_selection_state(cfg, params, quarantine=quarantine)
    state = (replicate_for_groups(params, len(layout.gids)),
             tuple(leaf[rows].contiguous() for leaf in sel),
             prng.PRNGKey(cfg.seed))
    # every group row holds the broadcast global model: row 0 is ω_t
    params_fn = lambda st: tree.map(lambda leaf: leaf[0], st[0])
    return engine.Experiment(
        name="fedgs" if cfg.selection == "gbp_cs" else "fedgs_random_sel",
        init_state=state, round_fn=round_fn, params_fn=params_fn,
        eval_fn=eval_fn)


def run_fedgs_fused(params, sampler, p_real, cfg: FedGSConfig, *,
                    group_loss_fn, avail_fn=None, corrupt_fn=None, mesh=None,
                    eval_fn: Callable | None = None, eval_every: int = 10,
                    log_fn: Callable[[RoundRecord], None] | None = None,
                    chunk: int = 1, graph: bool | None = None):
    """Alg. 1 end to end on the device-resident engine (DESIGN.md §7, §12):
    the same selections, images and steps as :func:`run_fedgs` over a
    ``data.DeviceBackedStreams`` of the same sampler, with ``chunk``
    rounds per host read-back (0 = ``engine.default_chunk``) and eval on
    the device every ``eval_every`` rounds, ``avail_fn`` and
    ``corrupt_fn`` as there. ``graph=False`` is the eager form (the
    CPU's); on the card a CUDA graph per round is the default. With a
    ``mesh`` (:func:`make_group_mesh`) it is the group-sharded engine
    (DESIGN.md §8): every rank of the mesh returns the same records and
    global params; a rank that sits out returns (None, []) at once.
    Returns (global params, [RoundRecord])."""
    if mesh is not None and not mesh.active:
        return None, []
    exp = make_fedgs_experiment(params, sampler, p_real, cfg,
                                group_loss_fn=group_loss_fn,
                                avail_fn=avail_fn, corrupt_fn=corrupt_fn,
                                mesh=mesh, eval_fn=eval_fn, graph=graph)
    state, logs = engine.run_experiment(
        exp, cfg.rounds, eval_every=eval_every if eval_fn is not None else 0,
        chunk=chunk, log_fn=log_fn)
    return exp.params_fn(state), logs
