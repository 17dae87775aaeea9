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
analytic byte ledger in every round record. Availability (§14), drift
(§13) and the fused/sharded engines are not part of the port yet.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

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
    keys and |θ|."""
    spec: compress.CompressSpec
    e: torch.Tensor
    keys: np.ndarray
    n: int

    def __call__(self, g: torch.Tensor):
        """EF-compress the (M, P4) rows g → (y, e', (M,) ‖e'‖₂)."""
        with span("fedgs.train.compress"):
            return compress.ef_compress_rows(g, self.e, self.n, self.spec,
                                             self.keys)


def _train_all_groups(gp, batches, group_loss_fn, cfg: FedGSConfig,
                      tx: Compressor | None = None):
    """All-groups superbatch ``grad_avg`` step: ONE backward over the loss
    summed across every group. Group g's loss terms depend only on gp[g],
    so the gradient of the summed (1/L-weighted) loss w.r.t. the stacked
    params IS the stack of per-group Eq. (4) gradients. Returns
    (gp', (M,) mean loss); with ``tx`` the gradients are flattened once,
    EF-compressed, and the step applies the transmitted y, returning
    (gp', loss, e', (M,) err)."""
    leaves = [leaf.detach().requires_grad_(True) for leaf in tree.leaves(gp)]
    params = tree.unflatten(gp, leaves)
    losses = group_loss_fn(params, batches)               # (M, L)
    wn = 1.0 / cfg.num_selected
    grads = torch.autograd.grad(torch.sum(losses * wn), leaves)
    with torch.no_grad():
        g = tree.unflatten(gp, list(grads))
        if tx is None:
            return (sync.apply_sgd(params, g, cfg.lr),
                    losses.detach().mean(dim=-1))
        y, e, err = tx(agg_weighted.flatten(g, len(losses)))
        new = sync.apply_sgd(params, agg_weighted.unflatten(y, gp, 1),
                             cfg.lr)
    return new, losses.detach().mean(dim=-1), e, err


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


def _train_model_avg(gp, batches, group_loss_fn, cfg: FedGSConfig):
    """``train_step='model_avg'``: one SGD step on each of the L members,
    then the uniform Eq. 4 average of the L one-step models per group
    through the aggregation kernel."""
    losses, grads = member_grads(gp, batches, group_loss_fn)
    m, l = losses.shape
    with torch.no_grad():
        models = tree.map(
            lambda p, g: (p.repeat_interleave(l, dim=0) - cfg.lr * g)
            .reshape((m, l) + g.shape[1:]), gp, grads)
        synced = dispatch.weighted_average_groups(
            models, torch.ones(m, l, device=losses.device))
    return synced, losses.mean(dim=-1)


class RobustStep(NamedTuple):
    """Per-member outputs of the corruption-exposed train step (DESIGN.md
    §15); member axes follow the seating order."""
    hit: torch.Tensor       # (M, L) injected-corruption ground truth
    flags: torch.Tensor     # (M, L) observable outliers: non-finite or
    #                         over-norm
    residual: torch.Tensor  # (M,) ‖robust aggregate − finite-masked mean‖


def _train_robust(gp, batches, fresh_w, t: int, dev_ids, group_loss_fn,
                  cfg: FedGSConfig, corrupt_fn, agg_fn,
                  tx: Compressor | None = None):
    """Corruption-exposed Eq. (4) for all groups (DESIGN.md §15): the
    per-member gradients are materialised (fault injection and the order
    statistics need the stack), corrupted, flattened ONCE into an
    (M, L, P4) buffer, aggregated by ``agg_fn`` at the ``fresh_w`` weights,
    and applied. The member stacks are freed before the step returns.
    Returns (gp', (M,) mean loss, RobustStep); with ``tx`` the (M, P4)
    aggregate is EF-compressed after robust aggregation (the compressor
    never sees raw corrupted members) and (e', (M,) err) are appended."""
    with span("fedgs.train.member_backward"):
        losses, grads = member_grads(gp, batches, group_loss_fn)
    m, l = losses.shape
    with torch.no_grad():
        with span("fedgs.train.corrupt"):
            if corrupt_fn is not None:
                grads, hit = corrupt_fn(grads, t, dev_ids.reshape(-1))
            else:
                hit = torch.zeros(m * l, device=losses.device)
            flat = agg_weighted.flatten(grads, m * l).view(m, l, -1)
            del grads
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
            del flat, clean, stats
        if tx is not None:
            g, e, err = tx(g)
        new = sync.apply_sgd(gp, agg_weighted.unflatten(g, gp, 1), cfg.lr)
    step = RobustStep(hit.reshape(m, l), flags, residual)
    if tx is None:
        return new, losses.mean(dim=-1), step
    return new, losses.mean(dim=-1), step, e, err


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


def external_sync_and_broadcast(group_params):
    """Alg. 1 line 10 (Eq. 5): ω_t = mean_m ω_t^m, then ω_t^m ← ω_t."""
    m = tree.leaves(group_params)[0].shape[0]
    return replicate_for_groups(sync.external_average(group_params), m)


def run_fedgs(params, streams, p_real, cfg: FedGSConfig, *,
              group_loss_fn, corrupt_fn=None,
              eval_fn: Callable | None = None, eval_every: int = 10,
              log_fn: Callable[[RoundRecord], None] | None = None):
    """Alg. 1 end to end — the two-phase host loop.

    Per iteration: (1) devices report next-batch class counts; (2) the BS
    runs GBP-CS to pick C_t^m (every ``cfg.reselect_every`` iterations;
    between rebuilds the carried masks are re-scored against the fresh
    counts); (3) ONLY the selected devices generate data and train;
    (4) internal sync. External sync every T iterations. ``params`` and
    ``p_real`` live on the device the run uses.

    ``corrupt_fn`` (``data.make_corruption_fn``) injects gradient faults
    and, with ``cfg.robust_agg != 'mean'`` alone too, switches to the
    robust layer (DESIGN.md §15): members seated in ``argsort(-mask)``
    order, per-member gradients, robust Eq. 4 at weights ``fresh_w`` (the
    mask values at the seats: 0 where quarantine left a group fewer than L
    eligible devices), the NaN-guard rollback of non-finite groups, and
    quarantine counters folded into selection.

    ``cfg.compress_int`` / ``compress_ext`` (DESIGN.md §18.1) compress the
    Eq. 4 gradient (after robust aggregation on the robust path) and the
    Eq. 5 round delta ω_t^m − ω_{t−1}, each with a per-group (M, P4) EF
    residual. The int keys fold 909 off the iteration key and leave the
    key chain alone; the external keys take one ``split`` of it per
    round. The NaN guard also rolls back a non-finite internal residual.
    With both specs ``'none'`` none of this runs. Returns (global params,
    [RoundRecord]).
    """
    dev = tree.leaves(params)[0].device
    m, k, l = cfg.num_groups, cfg.devices_per_group, cfg.num_selected
    robust = corrupt_fn is not None or cfg.robust_agg != "mean"
    if robust and cfg.train_step != "grad_avg":
        raise ValueError("corruption injection and robust_agg require "
                         "train_step='grad_avg' (the per-member gradient "
                         "stack)")
    quarantined = corrupt_fn is not None and cfg.quarantine_limit > 0
    guard = corrupt_fn is not None and cfg.nan_guard
    agg_fn = dispatch.robust_agg_fn(cfg.robust_agg, clip=cfg.robust_clip,
                                    trim=cfg.robust_trim)
    train_step = make_group_train_step(group_loss_fn, cfg)
    gp = replicate_for_groups(params, m)
    key = prng.PRNGKey(cfg.seed)
    p_real = torch.as_tensor(np.asarray(p_real), dtype=torch.float32,
                             device=dev)
    mask_c = torch.zeros(m, k, dtype=torch.float32, device=dev)
    dist_c = torch.zeros(m, dtype=torch.float32, device=dev)
    quar = torch.zeros(m, k, dtype=torch.int32, device=dev)
    gids = np.arange(m)[:, None]
    # §18 compression: parsed specs, EF residuals, the Eq. 4/5 byte ledger
    # (one-direction payload of |θ| parameters, 4|θ| when dense)
    spec_int = compress.parse_compress(cfg.compress_int)
    spec_ext = compress.parse_compress(cfg.compress_ext)
    n_par = sum(leaf.numel() for leaf in tree.leaves(params))
    payload_int = compress.payload_bytes(n_par, spec_int)
    payload_ext = compress.payload_bytes(n_par, spec_ext)
    e_int = compress.zero_residual(gp) if spec_int is not None else None
    e_ext = compress.zero_residual(gp) if spec_ext is not None else None
    logs: list[RoundRecord] = []
    t = 0
    for r in range(cfg.rounds):
        stats, rstats, cerrs, resel, uploads = [], [], [], 0, 0.0
        gp_round0 = gp          # round-entry broadcast model (Eq. 5 Δ base)
        for _ in range(cfg.iters_per_round):
            with span("fedgs.select"):
                key, sub = prng.split(key)
                counts = torch.as_tensor(streams.next_counts(), device=dev)
                keys = prng.split(sub, m)
                tx = None if spec_int is None else Compressor(
                    spec_int, e_int, prng.split(prng.fold_in(
                        sub, compress.FOLD_COMPRESS), m), n_par)
                disc = distributions.group_discrepancy(counts, p_real).mean()
                avail = selection.quarantine_mask(
                    quar, cfg.quarantine_limit) if quarantined else None
                do = selection.reselect_predicate(t, cfg.reselect_every)
                if avail is not None and cfg.reselect_every != 1:
                    do = selection.reselect_trigger(do, mask_c, avail, l)
                if do:
                    sel = selection.select_for_groups(
                        keys, counts, p_real, l, cfg.num_presampled,
                        avail=avail, method=cfg.selection, init=cfg.init,
                        max_iters=cfg.gbp_max_iters)
                    mask_c, dist_c = sel.mask, sel.distance
                    div = sel.divergence
                    resel += 1
                else:
                    ce = counts if avail is None else counts * avail[..., None]
                    div = distributions.mask_divergence(ce, mask_c, p_real)
                host_mask = mask_c.cpu().numpy()
            with span("fedgs.fetch"):
                imgs, labs = streams.fetch_selected(host_mask, l)
                batches = (torch.as_tensor(imgs, device=dev),
                           torch.as_tensor(labs, device=dev).long())
            with span("fedgs.train"):
                if robust:
                    # seats in fetch order: ties to the lower index, as
                    # lax.top_k seats them (never torch.topk on a 0/1 mask)
                    idx = np.argsort(-host_mask, axis=1, kind="stable")[:, :l]
                    vals = np.take_along_axis(host_mask, idx, axis=1)
                    fresh_w = torch.as_tensor(vals, device=dev)
                    gp_old = gp
                    out = _train_robust(
                        gp, batches, fresh_w, t, gids * k + idx,
                        group_loss_fn, cfg, corrupt_fn, agg_fn, tx)
                    gp, loss, rs = out[:3]
                    if tx is not None:
                        e_int, errs = out[3:]
                    rb = torch.zeros((), device=dev)
                    if guard:
                        finite_m = _group_finite(gp)
                        if tx is not None:
                            finite_m &= torch.isfinite(e_int).all(dim=1)
                            e_int = torch.where(finite_m[:, None], e_int,
                                                tx.e)
                        gp = _where_groups(finite_m, gp, gp_old)
                        rb = torch.sum(~finite_m).float()
                    if quarantined:
                        quar.scatter_add_(
                            1, torch.as_tensor(idx, device=dev),
                            (rs.flags * fresh_w).int())
                    seated = max(float(vals.sum()), 1.0)
                    rstats.append(torch.stack([
                        torch.sum(rs.hit * fresh_w),
                        torch.sum(rs.flags * fresh_w) / seated, rb,
                        rs.residual.mean()]))
                    uploads += float((vals > 0).sum())
                elif tx is not None:
                    gp, loss, e_int, errs = _train_all_groups(
                        gp, batches, group_loss_fn, cfg, tx)
                    uploads += float(m * l)
                else:
                    gp, loss = train_step(gp, batches)
                    uploads += float(m * l)
                if tx is not None:
                    cerrs.append(errs.mean())
            stats.append(torch.stack([loss.mean(), div.mean(), disc,
                                      dist_c.mean()]))
            t += 1
        with span("fedgs.external_sync"):
            if spec_ext is not None:
                with span("fedgs.external_sync.compress"):
                    key, esub = prng.split(key)
                    base = agg_weighted.flatten(gp_round0, m)
                    y, e_ext, err = compress.ef_compress_rows(
                        agg_weighted.flatten(gp, m) - base, e_ext, n_par,
                        spec_ext, prng.split(esub, m))
                    gp = agg_weighted.unflatten(base + y, gp, 1)
                    cerrs.append(err.mean())
                    del base, y
            gp = external_sync_and_broadcast(gp)
        tl = ta = None
        if eval_fn is not None and (r + 1) % eval_every == 0:
            with span("fedgs.eval"):
                tl, ta = (float(v) for v in eval_fn(global_params(gp)))
        loss, div, disc, dist = np.mean(
            torch.stack(stats).cpu().numpy().astype(np.float64), axis=0)
        fields = {}
        if rstats:
            rs_np = torch.stack(rstats).cpu().numpy().astype(np.float64)
            fields = dict(
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
