"""Train and serve steps with FEDGS compound-step semantics: the ports of
``make_loss_fn``, ``make_train_step``, ``external_sync_step``,
``make_serve_step`` and ``make_select_step`` in the JAX package's
``launch/steps.py``.

Training layout: parameters carry a leading *pod* axis (one model copy per
FL super node). One ``train_step`` is the FEDGS internal iteration on every
pod: per pod the gradient of its batch's loss, one SGD update (Eq. 3), and
no traffic between pods. ``external_sync_step`` is Eq. 5, the mean over the
pod axis, called every T steps by the training loop. The SPMD knobs of the
JAX step (``grad_pspecs``, ``mesh``, ``act_sharding``, ``spmd_pod``) are
ROADMAP item 19 and are refused.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import tree
from ..core import gbp_cs, selection, sync
from ..models import build
from ..models.transformer import refuse_sharding

ACCUM_MODES = ("grad_each", "loss_scan")
GATHER_DTYPES = ("fp32", "bf16")


def make_loss_fn(cfg, *, window=None, attn_impl: str = "auto",
                 remat: bool = True, act_sharding=None):
    """``loss_fn(params, batch)``: ``build(cfg).loss`` with these options."""
    fns = build(cfg)

    def loss_fn(params, batch):
        return fns.loss(params, batch, window=window, attn_impl=attn_impl,
                        remat=remat, act_sharding=act_sharding)

    return loss_fn


def make_train_step(cfg, *, lr: float = 1e-3, grad_accum: int = 1,
                    window=None, attn_impl: str = "auto", remat: bool = True,
                    accum_mode: str = "grad_each",
                    gather_dtype: str = "fp32", grad_pspecs=None, mesh=None,
                    act_sharding=None, spmd_pod: bool = False):
    """Returns ``train_step(stacked_params, stacked_batch) -> (params',
    loss)``: leaves (n_pods, ...) and (n_pods, B, ...). Per pod, one
    ``torch.autograd.grad`` of the loss over the pod's leaves (as
    ``core.sync.local_grads``), then ``(p - lr * g.float()).to(p.dtype)``
    into a new stacked tree; the loss returned is the mean over the pods.

    ``grad_accum`` splits each pod's batch into that many microbatches:
    ``accum_mode="grad_each"`` takes one gradient per microbatch and
    accumulates them in f32; ``"loss_scan"`` sums the microbatch losses,
    each under a checkpoint, and differentiates once. Both scale by
    1/grad_accum. ``gather_dtype="bf16"`` casts every f32 leaf of two or
    more axes of the pod's tree to bf16 inside the differentiated function
    (the layer-stacked norm scales, ``A_log`` and ``D`` too), so the loss
    sees bf16-rounded weights and the gradient is rounded to bf16 on its
    way back."""
    refuse_sharding(grad_pspecs=grad_pspecs, mesh=mesh,
                    act_sharding=act_sharding, spmd_pod=spmd_pod)
    if accum_mode not in ACCUM_MODES:
        raise ValueError(f"accum_mode={accum_mode!r}: one of {ACCUM_MODES}")
    if gather_dtype not in GATHER_DTYPES:
        raise ValueError(f"gather_dtype={gather_dtype!r}: one of "
                         f"{GATHER_DTYPES}")
    if grad_accum < 1:
        raise ValueError(f"grad_accum={grad_accum} must be >= 1")
    loss_fn = make_loss_fn(cfg, window=window, attn_impl=attn_impl,
                           remat=remat)

    def cast(p):
        if gather_dtype == "bf16" and p.dtype == torch.float32 \
                and p.ndim >= 2:
            return p.to(torch.bfloat16)
        return p

    def micro(batch) -> list[dict]:
        b = tree.leaves(batch)[0].shape[0]
        if b % grad_accum:
            raise ValueError(f"batch of {b} does not split into "
                             f"grad_accum={grad_accum} microbatches")
        m = b // grad_accum
        return [tree.map(lambda leaf: leaf[i * m:(i + 1) * m], batch)
                for i in range(grad_accum)]

    def pod_grads(params, batch):
        """One pod's gradient and loss (both scaled by 1/grad_accum)."""
        leaves = [leaf.detach().requires_grad_(True)
                  for leaf in tree.leaves(params)]
        p = tree.unflatten(params, leaves)

        def loss_of(mb):
            return loss_fn(tree.map(cast, p), mb)

        if grad_accum == 1:
            loss = loss_of(batch)
            return torch.autograd.grad(loss, leaves), loss.detach()
        if accum_mode == "loss_scan":
            total = torch.zeros((), device=leaves[0].device)
            for mb in micro(batch):
                total = total + checkpoint(loss_of, mb, use_reentrant=False)
            total = total / grad_accum
            return torch.autograd.grad(total, leaves), total.detach()
        grads = [torch.zeros(leaf.shape, dtype=torch.float32,
                             device=leaf.device) for leaf in leaves]
        loss_sum = torch.zeros((), device=leaves[0].device)
        for mb in micro(batch):
            loss = loss_of(mb)
            for acc, g in zip(grads, torch.autograd.grad(loss, leaves)):
                acc += g
            loss_sum = loss_sum + loss.detach()
        scale = 1.0 / grad_accum
        return [g * scale for g in grads], loss_sum * scale

    def train_step(stacked_params, stacked_batch):
        n_pods = tree.leaves(stacked_params)[0].shape[0]
        new = tree.map(torch.empty_like, stacked_params)
        new_leaves = tree.leaves(new)
        losses = []
        for i in range(n_pods):
            pod = tree.map(lambda leaf: leaf[i], stacked_params)
            grads, loss = pod_grads(
                pod, tree.map(lambda leaf: leaf[i], stacked_batch))
            with torch.no_grad():
                for out, p, g in zip(new_leaves, tree.leaves(pod), grads):
                    out[i] = (p - lr * g.float()).to(p.dtype)
            losses.append(loss)
            del grads             # before the next pod's are allocated
        return new, torch.mean(torch.stack(losses))

    return train_step


def external_sync_step(stacked_params):
    """Eq. 5: ω ← (1/M) Σ_m ω^m across the leading pod axis, broadcast back
    to every pod. The pod average runs through the ``agg_weighted`` kernel
    on a card (``sync.external_average``), its plain version on the CPU."""
    mean = sync.external_average(stacked_params)
    return tree.map(lambda g, p: g[None].expand(p.shape).to(p.dtype)
                    .contiguous(), mean, stacked_params)


def make_select_step(num_selected: int, num_presampled: int, *,
                     init: str = gbp_cs.MPINV, max_iters: int = 64):
    """The GBP-CS client-selection step (counts → masks): ``select_step(
    keys (M, 2), counts (M, K, F), p_real (F,)) -> SelectionResult`` of
    every group, the batch of groups in one ``gbp_cs`` launch on the
    card."""

    def select_step(keys, counts, p_real):
        return selection.select_for_groups(
            np.asarray(keys), counts, p_real, num_selected, num_presampled,
            init=init, max_iters=max_iters)

    return select_step


def make_serve_step(cfg, *, windowed: bool = False):
    """Returns serve_step(params, cache, tokens, pos) -> (next_tokens, cache):
    one-token batched decode, then the argmax over the unpadded vocabulary
    (the first maximal id on ties, as in JAX) as int32."""
    fns = build(cfg)

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        logits, cache = fns.decode_step(params, cache, tokens, pos,
                                        windowed=windowed)
        next_tokens = torch.argmax(logits[..., :cfg.vocab_size], dim=-1)
        return next_tokens.to(torch.int32), cache

    return serve_step
