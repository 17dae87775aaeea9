"""Kernel calls on the local shards of DTensors (the port's ``local_map``).

A model run on ``torch.distributed.tensor.DTensor`` params and batches (the
SPMD knobs of ``launch.steps.make_train_step``, the meta-device dry run of
``launch.dryrun``) reaches the attention core and the SSD scan with DTensor
operands. Those are computed shard by shard, as XLA's SPMD partitioner
computes them inside a TPU program. The model first lays the leading
operand out for the kernel (:func:`settle`: a pending ``Partial`` sum
all-reduced, a shard of the sequence or the features gathered), then
:func:`layout` reads which mesh dims
shard the batch or the heads of the leading operand, :func:`call`
redistributes every operand to that layout (the companions' batch and head
dims sharded alike, everything else replicated), runs the wrapper on the
local tensors and wraps its output back. An operand left replicated on a
sharded mesh dim gets its gradient as a ``Partial`` sum there: each shard
contributes only its part. Any other placement of the leading operand (a
``Partial``, a shard of the sequence or of the feature dim) raises, and the
message names it.

GQA attention whose KV heads do not divide over the heads' mesh dim (8 KV
heads on a 16-way 'model' axis) keeps K/V replicated there and gives each
shard the KV heads its query heads read (:func:`attention`).

:func:`replicate_constants` lets a model's plain constant tensors (RoPE
angles, masks, iotas, zeros) meet DTensor activations as replicated
DTensors (``implicit_replication``), on for as long as a forward or a
backward over DTensors runs.
"""
from __future__ import annotations

import contextlib

import torch


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def any_dtensor(*trees) -> bool:
    from .. import tree
    return any(is_dtensor(leaf) for t in trees for leaf in tree.leaves(t)
               if isinstance(leaf, torch.Tensor))


@contextlib.contextmanager
def _implicit_replication():
    """``torch.distributed.tensor.experimental.implicit_replication``, but
    nestable: it restores the flag it found (the library's version clears
    it on exit, which would end an enclosing one)."""
    from torch.distributed.tensor import DTensor
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def replicate_constants(*trees):
    """Plain tensors taken as replicated DTensors (implicit replication)
    when a leaf of ``trees`` is a DTensor, a null context otherwise."""
    if any_dtensor(*trees):
        return _implicit_replication()
    return contextlib.nullcontext()


def reduce_partial(x):
    """A DTensor's pending (``Partial``) sums all-reduced; anything else as
    it is."""
    if is_dtensor(x) and any(pl.is_partial() for pl in x.placements):
        from torch.distributed.tensor import Replicate
        return x.redistribute(x.device_mesh, [
            Replicate() if pl.is_partial() else pl for pl in x.placements])
    return x


def settle(x, dims: tuple):
    """``x`` laid out for a kernel that takes shards of ``dims`` (the batch
    and the heads) only: a DTensor's other placements redistributed to
    ``Replicate`` (a pending ``Partial`` sum all-reduced, a shard of the
    sequence or the features all-gathered, as SPMD reshards an operand
    before such a kernel); anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    want = [pl if pl.is_shard() and pl.dim in dims else Replicate()
            for pl in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def split_heads(t, n: int, d: int):
    """``t`` (..., n·d) as (..., n, d). A DTensor whose last dim is sharded
    over a mesh dim that does not divide the n heads (8 KV heads, or 20
    query heads, on a 16-way 'model' axis) is gathered there first: a
    shard holds whole heads, as SPMD reshards such a reshape."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate
        mesh = t.device_mesh
        want = [Replicate() if pl.is_shard(t.ndim - 1) and n % mesh.size(i)
                else pl for i, pl in enumerate(t.placements)]
        if want != list(t.placements):
            t = t.redistribute(mesh, want)
    return t.reshape(*t.shape[:-1], n, d)


def merge_heads(t):
    """(..., n, d) → (..., n·d). A DTensor replicated over a mesh dim that
    does not divide its n heads is then sharded there over n·d (a local
    slice, no traffic): the gradient, which arrives sharded over n·d, is
    gathered on its way back before autograd splits it into heads again
    (a shard must hold whole heads)."""
    n, d = t.shape[-2], t.shape[-1]
    out = t.reshape(*t.shape[:-2], n * d)
    if is_dtensor(out):
        from torch.distributed.tensor import Shard
        mesh = out.device_mesh
        want = [Shard(out.ndim - 1) if pl.is_replicate() and
                n % mesh.size(i) and (n * d) % mesh.size(i) == 0 else pl
                for i, pl in enumerate(out.placements)]
        if want != list(out.placements):
            out = out.redistribute(mesh, want)
    return out


def layout(name: str, lead, batch_dim: int, head_dim: int | None) -> list:
    """Per mesh dim of ``lead``'s mesh: None (replicated), 'batch' or
    'heads'; ``ValueError`` for any other placement."""
    out = []
    names = lead.device_mesh.mesh_dim_names
    for i, pl in enumerate(lead.placements):
        if pl.is_replicate():
            out.append(None)
        elif pl.is_shard(batch_dim):
            out.append("batch")
        elif head_dim is not None and pl.is_shard(head_dim):
            out.append("heads")
        else:
            axis = names[i] if names else i
            raise ValueError(
                f"{name}: placement {pl} on mesh dim {axis!r} of "
                f"{tuple(lead.placements)}: the kernel takes local shards "
                f"of the batch (dim {batch_dim}) or the heads (dim "
                f"{head_dim}) only")
    return out


def _local(mesh, x, target: list, kinds: list):
    """``x`` (a DTensor, or a plain tensor taken as replicated)
    redistributed to ``target`` and its local tensor; a gradient arriving
    there is Partial on the sharded mesh dims where ``x`` stays
    replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    x = x.redistribute(mesh, target)
    grads = [Partial() if kind is not None and pl.is_replicate() else pl
             for kind, pl in zip(kinds, target)]
    return x.to_local(grad_placements=grads)


def _target(kinds: list, batch_dim, head_dim) -> list:
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for kind in kinds:
        d = batch_dim if kind == "batch" else \
            head_dim if kind == "heads" else None
        out.append(Replicate() if d is None else Shard(d))
    return out


def _wrap(mesh, out, kinds: list, batch_dim: int, head_dim: int):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(out, mesh, _target(kinds, batch_dim, head_dim),
                              run_check=False)


def call(name: str, fn, args: tuple, dims: tuple, out_dims: tuple):
    """``fn`` on the local shards of ``args``: ``dims[i]`` = (batch dim,
    head dim) of ``args[i]`` (None where it has none), ``out_dims`` those
    of the output; the layout is the first operand's."""
    lead = args[0]
    mesh = lead.device_mesh
    kinds = layout(name, lead, *dims[0])
    local = [_local(mesh, a, _target(kinds, *d), kinds)
             for a, d in zip(args, dims)]
    return _wrap(mesh, fn(*local), kinds, *out_dims)


def attention(name: str, fn, q, k, v):
    """``fn(q, k, v)`` (model layout (B, S, H, D), K/V (B, Sk, KV, D)) on
    local shards of the batch and the heads. KV heads that do not divide
    over the heads' mesh dim stay replicated, and each shard slices the KV
    heads of its query heads."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    kinds = layout(name, q, 0, 2)
    h, kvh = q.shape[2], k.shape[2]
    kv_target, lo, hi = [], 0, kvh
    for i, kind in enumerate(kinds):
        if kind == "batch":
            kv_target.append(Shard(0))
        elif kind == "heads" and kvh % mesh.size(i) == 0:
            kv_target.append(Shard(2))
        elif kind == "heads":
            # the query heads of this shard and the KV heads they read
            hl, g = h // mesh.size(i), h // kvh
            first = mesh.get_coordinate()[i] * hl
            lo, hi = first // g, -(-(first + hl) // g)
            if hi - lo > 1 and (first % g or hl % g):
                raise ValueError(
                    f"{name}: {h} query heads over {mesh.size(i)} shards "
                    f"do not map onto whole groups of the {kvh} KV heads")
            kv_target.append(Replicate())
        else:
            kv_target.append(Replicate())
    ql = _local(mesh, q, _target(kinds, 0, 2), kinds)
    kl = _local(mesh, k, kv_target, kinds)[:, :, lo:hi]
    vl = _local(mesh, v, kv_target, kinds)[:, :, lo:hi]
    return _wrap(mesh, fn(ql, kl, vl), kinds, 0, 2)
