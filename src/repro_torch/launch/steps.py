"""Train and serve steps with FEDGS compound-step semantics: the ports of
``make_loss_fn``, ``make_train_step``, ``external_sync_step``,
``make_serve_step`` and ``make_select_step`` in the JAX package's
``launch/steps.py``.

Training layout: parameters carry a leading *pod* axis (one model copy per
FL super node). One ``train_step`` is the FEDGS internal iteration on every
pod: per pod the gradient of its batch's loss, one SGD update (Eq. 3), and
no traffic between pods. ``external_sync_step`` is Eq. 5, the mean over the
pod axis, called every T steps by the training loop.

The step runs on plain tensors or on DTensors laid out by
``launch.sharding`` (``distribute(stacked, stack_pspecs_for_pods(
param_pspecs(...)))``), where DTensor inserts the collectives that XLA's
SPMD partitioner inserts in the JAX step; each microbatch holds the
global rows JAX's holds. The SPMD knobs keep JAX's meaning, and none
changes a number: ``grad_pspecs`` with ``mesh``
redistributes each microbatch's gradients to those specs (the FSDP
layout: a reduce-scatter, ZeRO-2); ``act_sharding`` pins the residual
stream (``transformer.pinner``); ``spmd_pod`` maps the pods onto the
mesh's 'pod' axis, each rank stepping its own pods on the (data, model)
submesh, as ``vmap(spmd_axis_name='pod')`` does.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import tree
from ..core import gbp_cs, selection, sync
from ..kernels import agg_weighted, shards
from ..models import build
from . import sharding

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
    way back.

    The SPMD knobs (module docstring) need DTensor params and batches on
    ``mesh``: ``grad_pspecs`` (a ``launch.sharding.param_pspecs`` tree,
    no pod axis) with ``mesh``, ``act_sharding`` (a
    ``launch.sharding.NamedSharding``) and ``spmd_pod``. Without
    ``spmd_pod`` the stacked pod axis must not be sharded."""
    if accum_mode not in ACCUM_MODES:
        raise ValueError(f"accum_mode={accum_mode!r}: one of {ACCUM_MODES}")
    if gather_dtype not in GATHER_DTYPES:
        raise ValueError(f"gather_dtype={gather_dtype!r}: one of "
                         f"{GATHER_DTYPES}")
    if grad_accum < 1:
        raise ValueError(f"grad_accum={grad_accum} must be >= 1")
    loss_fn = make_loss_fn(cfg, window=window, attn_impl=attn_impl,
                           remat=remat, act_sharding=act_sharding)
    knobs = {"grad_pspecs": grad_pspecs is not None and mesh is not None,
             "act_sharding": act_sharding is not None,
             "spmd_pod": spmd_pod}
    grad_specs = None if grad_pspecs is None or mesh is None else \
        sharding.spec_leaves(grad_pspecs)

    def cast(p):
        if gather_dtype == "bf16" and p.dtype == torch.float32 \
                and p.ndim >= 2:
            return p.to(torch.bfloat16)
        return p

    def constrain(grads):
        """Each gradient redistributed to its ``grad_pspecs`` spec on its
        own (the pod's) mesh."""
        if grad_specs is None:
            return grads
        return [g.redistribute(g.device_mesh,
                               sharding.placements(s, g.device_mesh))
                for g, s in zip(grads, grad_specs)]

    def micro(batch) -> list[dict]:
        """Microbatch i holds rows [i·m, (i+1)·m) of the pod's batch, as
        JAX's reshape cuts it; a DTensor's slice is laid out again as the
        batch was (DTensor reshards it, as SPMD does), or replicated over
        the batch's row dims where m rows do not split evenly over them."""
        first = tree.leaves(batch)[0]
        b = first.shape[0]
        if b % grad_accum:
            raise ValueError(f"batch of {b} does not split into "
                             f"grad_accum={grad_accum} microbatches")
        m = b // grad_accum
        if shards.is_dtensor(first):
            return [tree.map(lambda leaf: leaf[i * m:(i + 1) * m]
                             .redistribute(leaf.device_mesh,
                                           microbatch_layout(leaf, m)),
                             batch) for i in range(grad_accum)]
        return [tree.map(lambda leaf: leaf[i * m:(i + 1) * m], batch)
                for i in range(grad_accum)]

    def pod_grads(params, batch):
        """One pod's gradient and loss (both scaled by 1/grad_accum)."""
        leaves = [leaf.detach().requires_grad_(True)
                  for leaf in tree.leaves(params)]
        p = tree.unflatten(params, leaves)

        def loss_of(mb):
            return loss_fn(tree.map(cast, p), mb)

        with shards.replicate_constants(params, batch):
            if grad_accum == 1:
                loss = loss_of(batch)
                return constrain(torch.autograd.grad(loss, leaves)), \
                    loss.detach()
            if accum_mode == "loss_scan":
                total = torch.zeros((), device=leaves[0].device)
                for mb in micro(batch):
                    total = total + checkpoint(loss_of, mb,
                                               use_reentrant=False)
                total = total / grad_accum
                # one gradient a step: JAX constrains none here either
                return torch.autograd.grad(total, leaves), total.detach()
            grads = [torch.zeros_like(leaf, dtype=torch.float32)
                     for leaf in leaves]
            loss_sum = torch.zeros((), device=leaves[0].device)
            for mb in micro(batch):
                loss = loss_of(mb)
                for acc, g in zip(grads, constrain(
                        torch.autograd.grad(loss, leaves))):
                    acc += relayout(g, acc)
                loss_sum = loss_sum + loss.detach()
            scale = 1.0 / grad_accum
            return [g * scale for g in grads], loss_sum * scale

    def train_step(stacked_params, stacked_batch):
        if shards.any_dtensor(stacked_params):
            return _spmd_step(stacked_params, stacked_batch, pod_grads, lr,
                              mesh, spmd_pod)
        for name, on in knobs.items():
            if on:
                raise ValueError(
                    f"{name}: the SPMD knobs need DTensor params and "
                    "batches (launch.sharding.distribute)")
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


def row_shards(leaf, dim: int = 0) -> int:
    """The number of shards a DTensor ``leaf``'s rows (its ``dim``) split
    into: the product of the mesh dims that shard it."""
    return int(np.prod([leaf.device_mesh.size(i)
                        for i, pl in enumerate(leaf.placements)
                        if pl.is_shard(dim)]))


def microbatch_layout(leaf, rows: int) -> list:
    """The placements of a microbatch of ``rows`` rows cut from the DTensor
    batch ``leaf``: the batch's, or, where the rows do not split evenly
    over the mesh dims that shard them (DTensor cannot lay out the uneven
    shard, ``aten._unsafe_view``), the rows replicated there; every rank
    then computes the whole microbatch, with the same numbers."""
    from torch.distributed.tensor import Replicate
    if rows % row_shards(leaf):
        return [Replicate() if pl.is_shard(0) else pl
                for pl in leaf.placements]
    return list(leaf.placements)


def relayout(x, like):
    """``x`` redistributed to ``like``'s placements where both are DTensors
    and differ; else ``x``."""
    if shards.is_dtensor(x) and tuple(x.placements) != tuple(like.placements):
        return x.redistribute(like.device_mesh, like.placements)
    return x


def _pod_layout(leaf, spmd_pod: bool) -> tuple:
    """(the mesh dim that shards the stacked pod axis or None, the per-pod
    placements on the pod's mesh) of a stacked DTensor leaf."""
    from torch.distributed.tensor import Shard
    names = leaf.device_mesh.mesh_dim_names
    pod_dim = names.index("pod") if spmd_pod else None
    inner = []
    for i, pl in enumerate(leaf.placements):
        if i == pod_dim:
            if not pl.is_shard(0):
                raise ValueError("spmd_pod=True: the stacked pod axis must "
                                 f"be sharded over 'pod', not {pl}")
            continue
        if pl.is_shard(0):
            raise ValueError(
                f"the stacked pod axis is sharded over mesh dim "
                f"{names[i]!r}; pods map onto the 'pod' axis only, with "
                "spmd_pod=True")
        inner.append(Shard(pl.dim - 1) if pl.is_shard() else pl)
    return pod_dim, inner


def _spmd_step(stacked_params, stacked_batch, pod_grads, lr, mesh,
               spmd_pod: bool):
    """The train step on DTensors: each rank steps its local pods, each
    pod's leaves DTensors on the pod's mesh (the (data, model) submesh
    under ``spmd_pod``, else the whole mesh), and writes the updates into
    its local shards; the pods' mean loss is summed over 'pod'."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor
    first = tree.leaves(stacked_params)[0]
    full_mesh = first.device_mesh
    if mesh is not None and mesh != full_mesh:
        raise ValueError("the stacked params live on another mesh than "
                         "the train step's")
    names = full_mesh.mesh_dim_names or ()
    if spmd_pod and "pod" not in names:
        raise ValueError(f"spmd_pod=True needs a 'pod' mesh axis, not "
                         f"{names}")
    pod_mesh = full_mesh
    if spmd_pod:
        rest = tuple(n for n in names if n != "pod")
        pod_mesh = full_mesh[rest] if rest else None

    def split(stacked):
        leaves, locals_, inners = tree.leaves(stacked), [], []
        for leaf in leaves:
            pod_dim, inner = _pod_layout(leaf, spmd_pod)
            locals_.append(leaf.to_local())
            inners.append(inner)
        return leaves, locals_, inners, pod_dim

    def pod_tree(like, locals_, inners, j):
        one = [x[j] if pod_mesh is None else
               DTensor.from_local(x[j], pod_mesh, inner, run_check=False)
               for x, inner in zip(locals_, inners)]
        return tree.unflatten(like, one)

    p_leaves, p_local, p_inner, pod_dim = split(stacked_params)
    b_leaves, b_local, b_inner, _ = split(stacked_batch)
    out_local = [torch.empty_like(x) for x in p_local]
    loss_sum = torch.zeros((), dtype=torch.float32, device=p_local[0].device)
    for j in range(p_local[0].shape[0]):
        pod = pod_tree(stacked_params, p_local, p_inner, j)
        grads, loss = pod_grads(pod, pod_tree(stacked_batch, b_local,
                                              b_inner, j))
        with torch.no_grad(), shards.replicate_constants(pod):
            for out, p, g in zip(out_local, tree.leaves(pod), grads):
                new = relayout((p - lr * g.float()).to(p.dtype), p)
                out[j] = new.to_local() if shards.is_dtensor(new) else new
        loss_sum = loss_sum + (loss.full_tensor()
                               if shards.is_dtensor(loss) else loss)
        del grads                 # before the next pod's are allocated
    if pod_dim is not None:
        loss_sum = funcol.wait_tensor(
            funcol.all_reduce(loss_sum, "sum", (full_mesh, pod_dim)))
    new = [DTensor.from_local(x, full_mesh, leaf.placements, run_check=False)
           for x, leaf in zip(out_local, p_leaves)]
    return tree.unflatten(stacked_params, new), \
        loss_sum / first.shape[0]


def external_sync_step(stacked_params):
    """Eq. 5: ω ← (1/M) Σ_m ω^m across the leading pod axis, broadcast back
    to every pod. The pod average runs through the ``agg_weighted`` kernel
    on a card (``sync.external_average``), its plain version on the CPU.
    DTensor leaves are averaged over their local pods in one flat buffer
    (the kernel, weights 1/n_pods) and summed over the 'pod' mesh dim by
    one all-reduce, where the stacked axis is sharded; each leaf keeps its
    layout."""
    if shards.any_dtensor(stacked_params):
        return _external_sync_sharded(stacked_params)
    mean = sync.external_average(stacked_params)
    return tree.map(lambda g, p: g[None].expand(p.shape).to(p.dtype)
                    .contiguous(), mean, stacked_params)


def _external_sync_sharded(stacked_params):
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor
    leaves = tree.leaves(stacked_params)
    mesh = leaves[0].device_mesh
    pod_dims = {i for leaf in leaves for i, pl in enumerate(leaf.placements)
                if pl.is_shard(0)}
    if len(pod_dims) > 1:
        raise ValueError(f"the stacked pod axis is sharded over mesh dims "
                         f"{sorted(pod_dims)}; one at most")
    local = [leaf.to_local() for leaf in leaves]
    k = local[0].shape[0]
    w = torch.full((k,), 1.0 / leaves[0].shape[0], dtype=torch.float32,
                   device=local[0].device)
    mean = agg_weighted.agg(agg_weighted.flatten(local, k), w)
    if pod_dims:
        mean = funcol.wait_tensor(
            funcol.all_reduce(mean, "sum", (mesh, pod_dims.pop())))
    parts = tree.leaves(agg_weighted.unflatten(mean, local, 1))
    new = [DTensor.from_local(m[None].expand(x.shape).to(x.dtype)
                              .contiguous(), mesh, leaf.placements,
                              run_check=False)
           for m, x, leaf in zip(parts, local, leaves)]
    return tree.unflatten(stacked_params, new)


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
        if shards.is_dtensor(logits):
            # the argmax reads whole vocab rows: gather a sharded vocab
            from torch.distributed.tensor import Replicate
            logits = logits.redistribute(logits.device_mesh, [
                Replicate() if pl.is_partial() or pl.is_shard(
                    logits.ndim - 1) else pl for pl in logits.placements])
        next_tokens = torch.argmax(logits[..., :cfg.vocab_size], dim=-1)
        return next_tokens.to(torch.int32), cache

    return serve_step
