"""FEDGS: Federated Group Synchronization — paper Alg. 1, host engine.

Groups (factories) are a leading axis of size M on every parameter leaf.
One *internal iteration* (Alg. 1 lines 3–8) is: devices report next-batch
class counts; the BS runs GBP-CS for every group (one kernel launch);
ONLY the selected devices generate data; one backward over the all-groups
superbatch gives every group's Eq. (4) gradient, and one SGD step per group
follows (``train_step='grad_avg'`` of the JAX package: FEDGS == FedAvg over
M super nodes with batch nL). Every T iterations comes the Eq. (5) external
average and broadcast, then test-set eval.

This is the default arm of the JAX package's ``run_fedgs``: host engine,
no availability schedule, no corruption, mean aggregation, no compression.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from .. import tree
from . import distributions, engine, gbp_cs, prng, selection, sync

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

    def __post_init__(self):
        if self.selection not in ("gbp_cs", "random"):
            raise ValueError(f"unknown selection: {self.selection!r}")
        if self.init not in gbp_cs.INITIALIZERS:
            raise ValueError(f"unknown init: {self.init!r}")
        if self.reselect_every < 0:
            raise ValueError("reselect_every must be >= 0 (0 = static), got "
                             f"{self.reselect_every}")

    @property
    def l_sel(self) -> int:
        return self.num_selected - self.num_presampled


def replicate_for_groups(params, m: int):
    """Copy a model into every group: leaves (...) → (M, ...)."""
    return tree.map(lambda leaf: leaf.unsqueeze(0).repeat(
        (m,) + (1,) * leaf.dim()), params)


def global_params(group_params):
    return sync.external_sync(group_params)


def _train_all_groups(gp, batches, group_loss_fn, cfg: FedGSConfig):
    """All-groups superbatch ``grad_avg`` step: ONE backward over the loss
    summed across every group. Group g's loss terms depend only on gp[g],
    so the gradient of the summed (1/L-weighted) loss w.r.t. the stacked
    params IS the stack of per-group Eq. (4) gradients. Returns
    (gp', (M,) mean loss)."""
    leaves = [leaf.detach().requires_grad_(True) for leaf in tree.leaves(gp)]
    params = tree.unflatten(gp, leaves)
    losses = group_loss_fn(params, batches)               # (M, L)
    wn = 1.0 / cfg.num_selected
    grads = torch.autograd.grad(torch.sum(losses * wn), leaves)
    with torch.no_grad():
        new = sync.apply_sgd(params, tree.unflatten(gp, list(grads)), cfg.lr)
    return new, losses.detach().mean(dim=-1)


def make_group_train_step(group_loss_fn, cfg: FedGSConfig):
    """The plain train step: ``step(gp, batches) -> (gp', (M,) loss)``."""

    def step(group_params, batches):
        return _train_all_groups(group_params, batches, group_loss_fn, cfg)

    return step


def external_sync_and_broadcast(group_params):
    """Alg. 1 line 10 (Eq. 5): ω_t = mean_m ω_t^m, then ω_t^m ← ω_t."""
    m = tree.leaves(group_params)[0].shape[0]
    return replicate_for_groups(sync.external_average(group_params), m)


def run_fedgs(params, streams, p_real, cfg: FedGSConfig, *,
              group_loss_fn,
              eval_fn: Callable | None = None, eval_every: int = 10,
              log_fn: Callable[[RoundRecord], None] | None = None):
    """Alg. 1 end to end — the two-phase host loop.

    Per iteration: (1) devices report next-batch class counts; (2) the BS
    runs GBP-CS to pick C_t^m (every ``cfg.reselect_every`` iterations;
    between rebuilds the carried masks are re-scored against the fresh
    counts); (3) ONLY the selected devices generate data and train;
    (4) internal sync. External sync every T iterations. ``params`` and
    ``p_real`` live on the device the run uses. Returns
    (global params, [RoundRecord]).
    """
    dev = tree.leaves(params)[0].device
    m, k = cfg.num_groups, cfg.devices_per_group
    train_step = make_group_train_step(group_loss_fn, cfg)
    gp = replicate_for_groups(params, m)
    key = prng.PRNGKey(cfg.seed)
    p_real = torch.as_tensor(np.asarray(p_real), dtype=torch.float32,
                             device=dev)
    mask_c = torch.zeros(m, k, dtype=torch.float32, device=dev)
    dist_c = torch.zeros(m, dtype=torch.float32, device=dev)
    # Eq. 4/5 byte ledger: dense f32 payload of |θ| parameters
    payload = 4.0 * sum(leaf.numel() for leaf in tree.leaves(params))
    logs: list[RoundRecord] = []
    t = 0
    for r in range(cfg.rounds):
        stats, resel = [], 0
        for _ in range(cfg.iters_per_round):
            with span("fedgs.select"):
                key, sub = prng.split(key)
                counts = torch.as_tensor(streams.next_counts(), device=dev)
                keys = prng.split(sub, m)
                disc = distributions.group_discrepancy(counts, p_real).mean()
                if selection.reselect_predicate(t, cfg.reselect_every):
                    sel = selection.select_for_groups(
                        keys, counts, p_real, cfg.num_selected,
                        cfg.num_presampled, method=cfg.selection,
                        init=cfg.init, max_iters=cfg.gbp_max_iters)
                    mask_c, dist_c = sel.mask, sel.distance
                    div = sel.divergence
                    resel += 1
                else:
                    div = distributions.mask_divergence(counts, mask_c,
                                                        p_real)
                host_mask = mask_c.cpu().numpy()
            with span("fedgs.fetch"):
                imgs, labs = streams.fetch_selected(host_mask,
                                                    cfg.num_selected)
                batches = (torch.as_tensor(imgs, device=dev),
                           torch.as_tensor(labs, device=dev).long())
            with span("fedgs.train"):
                gp, loss = train_step(gp, batches)
            stats.append(torch.stack([loss.mean(), div.mean(), disc,
                                      dist_c.mean()]))
            t += 1
        with span("fedgs.external_sync"):
            gp = external_sync_and_broadcast(gp)
        tl = ta = None
        if eval_fn is not None and (r + 1) % eval_every == 0:
            with span("fedgs.eval"):
                tl, ta = (float(v) for v in eval_fn(global_params(gp)))
        loss, div, disc, dist = np.mean(
            torch.stack(stats).cpu().numpy().astype(np.float64), axis=0)
        log = RoundRecord(
            round=r, loss=float(loss), divergence=float(div),
            test_loss=tl, test_accuracy=ta, strategy="fedgs",
            group_discrepancy=float(disc), selection_distance=float(dist),
            reselections=float(resel),
            bytes_int=2.0 * payload * m * cfg.num_selected
            * cfg.iters_per_round,
            bytes_ext=2.0 * payload * m)
        logs.append(log)
        if log_fn is not None:
            log_fn(log)
    return global_params(gp), logs
