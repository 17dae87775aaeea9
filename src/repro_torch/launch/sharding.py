"""Per-architecture partition rules (DESIGN.md §4): the port of the JAX
package's ``launch/sharding.py``.

A spec is the tuple of mesh axis names that JAX's ``PartitionSpec`` holds,
one entry per tensor dim: ``None`` (replicated), an axis name, or a tuple
of names (the dim split over several axes, the first the major one);
``()`` replicates every dim. The rules read only the mesh's axis names and
sizes (``mesh_dim_names`` and ``shape``, which a ``DeviceMesh`` and a
:class:`MeshShape` both carry), so they can be held spec for spec against
the JAX package's on meshes no host has. :func:`placements` turns a spec
into the ``Shard``/``Replicate`` placements of a ``DTensor``, and
:func:`distribute` lays a tree out on a ``DeviceMesh``.

Conventions on the production mesh:
  * 'model' — tensor parallelism: flattened head×head_dim / ff / expert
    dims;
  * 'data'  — hierarchical data parallel (within a super node) and the
    FSDP axis of the parameters;
  * 'pod'   — FL super nodes: parameters get a leading stacked pod axis, so
    each pod holds its own model copy between external syncs.

Every rule checks divisibility against the mesh and falls back to
replication, so the same rules serve the 256-rank production mesh and the
small meshes of the tests.
"""
from __future__ import annotations

from typing import Any, NamedTuple

from .. import tree as tree_lib
from ..kernels import shards
from .mesh import dp_axes

Spec = tuple
Tree = Any
SPEC_NONE: Spec = ()


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, without devices or ranks (what the
    rules read of a ``DeviceMesh``)."""
    mesh_dim_names: tuple
    shape: tuple


class NamedSharding(NamedTuple):
    """A spec on a mesh: the port's ``jax.sharding.NamedSharding``, the
    form ``act_sharding`` takes."""
    mesh: Any
    spec: Spec


def P(*entries) -> Spec:
    """A spec from its entries, normalised as JAX's ``PartitionSpec``
    normalises them: a tuple of one axis is that axis, an empty tuple is
    None."""
    def entry(e):
        if isinstance(e, tuple):
            return None if not e else e[0] if len(e) == 1 else e
        return e
    return tuple(entry(e) for e in entries)


def axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def _maybe(axis: str | None, dim: int, mesh) -> str | None:
    """Use ``axis`` for a dim only if the dim divides by the axis size."""
    if axis is None or axis not in mesh.mesh_dim_names:
        return None
    return axis if dim % _axis_size(mesh, axis) == 0 else None


def _spec(mesh, dims: tuple, axes: tuple) -> Spec:
    assert len(dims) == len(axes)
    return P(*(_maybe(a, d, mesh) for d, a in zip(dims, axes)))


# --- per-leaf rules, matched by path suffix ---------------------------------

def _rule(path: str, shape: tuple, mesh, *, embed_mode: str = "fsdp",
          param_mode: str = "fsdp", moe_mode: str = "ep_fsdp") -> Spec:
    nd = len(shape)

    def pad(axes):  # right-align axes against the trailing dims (stacked L)
        axes = tuple(axes)
        if param_mode == "tp_only":
            # models that fit replicated over 'data' skip FSDP entirely
            axes = tuple(a if a == "model" else None for a in axes)
        return _spec(mesh, shape, (None,) * (nd - len(axes)) + axes)

    # lm_head over ('model' vocab, 'data' d), so logits shard on vocab
    if path.endswith("lm_head/table"):
        return pad(("model", "data"))
    if path.endswith("embed/table"):
        if embed_mode == "replicated_vocab":
            return pad((None, "model"))
        if embed_mode == "vocab_model":
            return pad(("model", None))
        return pad(("data", "model"))  # baseline: FSDP over vocab

    # attention projections
    if path.endswith(("attn/wq/w", "attn/wk/w", "attn/wv/w",
                      "xattn/wq/w", "xattn/wk/w", "xattn/wv/w")):
        return pad(("data", "model"))
    if path.endswith(("attn/wo/w", "xattn/wo/w")):
        return pad(("model", "data"))
    if path.endswith(("wq/b", "wk/b", "wv/b")):
        return pad(("model",))
    if path.endswith("wo/b"):
        return pad(("data",))

    # MLA
    if path.endswith(("w_dkv/w", "w_kr/w")):
        return pad(("data", None))
    if path.endswith(("w_uk/w", "w_uv/w")):
        return pad((None, "model"))

    # dense MLP / shared expert
    if path.endswith(("gate/w", "up/w")):
        return pad(("data", "model"))
    if path.endswith("down/w"):
        return pad(("model", "data"))

    # MoE experts: expert-parallel over 'model'; 'ep_fsdp' also shards d
    # over 'data', 'ep_only' keeps d replicated
    if path.endswith(("moe/w_gate", "moe/w_up", "moe/w_down")):
        if moe_mode == "ep_only":
            return pad(("model", None, None))
        return pad(("model", "data", None))
    if path.endswith("router/w"):
        return pad((None, None))

    # Mamba2
    if path.endswith("in_proj/w"):
        return pad(("data", "model"))
    if path.endswith("dt_proj/w"):
        return pad(("data", "model"))
    if path.endswith("out_proj/w"):
        return pad(("model", "data"))
    if path.endswith("conv_w"):
        return pad((None, "model"))
    if path.endswith("conv_b"):
        return pad(("model",))
    if path.endswith(("A_log", "D", "dt_proj/bias")):
        return pad((None,))

    # norms and everything else small: replicated
    return SPEC_NONE


def map_with_path(fn, tree: Tree, prefix: str = "") -> Tree:
    """``fn(path, leaf)`` over a nested dict, the path the keys joined by
    '/' (the JAX package's ``_path_str``)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return fn(prefix, tree)


def spec_leaves(specs: Tree) -> list:
    """A spec tree's specs in ``tree.leaves`` order (sorted keys)."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    return [specs]


def map_specs(fn, specs: Tree) -> Tree:
    """``fn(spec)`` over a spec tree: nested dicts whose leaves are spec
    tuples."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    return fn(specs)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape)


def param_pspecs(params: Tree, mesh, *, embed_mode: str = "fsdp",
                 param_mode: str = "fsdp", moe_mode: str = "ep_fsdp"
                 ) -> Tree:
    """The spec tree of a model's params (no pod axis)."""
    return map_with_path(
        lambda path, leaf: _rule(path, _shape(leaf), mesh,
                                 embed_mode=embed_mode,
                                 param_mode=param_mode, moe_mode=moe_mode),
        params)


def stack_pspecs_for_pods(pspecs: Tree, mesh) -> Tree:
    """Prepend the 'pod' axis for the stacked-per-pod training layout."""
    pod = "pod" if "pod" in mesh.mesh_dim_names else None
    return map_specs(lambda s: P(pod, *s), pspecs)


# --- FEDGS group-axis specs (DESIGN.md §8) ----------------------------------

def group_pspecs(tree: Tree) -> Tree:
    """('groups',) on every leaf's leading (M) axis: the stacked-per-group
    layout of the sharded engine, trailing dims replicated."""
    return tree_lib.map(lambda _: ("groups",), tree)


# --- batch / cache specs ----------------------------------------------------

def batch_pspecs(cfg, shape, mesh, *, pod_stacked: bool = True) -> dict:
    """Specs of the training/prefill batch, stacked (n_pods, B/n_pods, ...)
    when ``pod_stacked``."""
    from ..configs import input_specs
    pod = "pod" if ("pod" in mesh.mesh_dim_names and pod_stacked) else None
    specs = {}
    for name, sds in input_specs(cfg, shape).items():
        trailing = (None,) * (len(sds.shape) - 1)
        specs[name] = P(pod, "data", *trailing) if pod_stacked \
            else P("data", *trailing)
    return specs


def stacked_batch_sds(cfg, shape, mesh) -> dict:
    """``configs.TensorSpec``s with the leading pod axis folded out of B."""
    from ..configs import TensorSpec, input_specs
    n_pods = max(_axis_size(mesh, "pod"), 1)
    out = {}
    for name, sds in input_specs(cfg, shape).items():
        b = sds.shape[0]
        assert b % n_pods == 0, (name, b, n_pods)
        out[name] = TensorSpec((n_pods, b // n_pods) + tuple(sds.shape[1:]),
                               sds.dtype)
    return out


def dp_spec_axes(mesh) -> tuple:
    return dp_axes(mesh)


def decode_cache_pspecs(cfg, cache: Tree, mesh, *, batch: int,
                        cross_mode: str = "head_sharded") -> Tree:
    """The spec tree of an ``init_decode_cache`` tree.

    batch > 1: the cache's batch dim over ('pod', 'data'), heads/head_dim
    over 'model'. batch == 1 (long_500k): the cache *sequence* (ring
    capacity) or the SSM heads over 'data' instead. ``cross_mode``: the
    enc-dec cross K/V sharded on head_dim ('head_sharded') or on the
    encoder sequence ('seq_sharded', the flash-decoding layout)."""
    dp = dp_spec_axes(mesh)
    n_dp = 1
    for a in dp:
        n_dp *= _axis_size(mesh, a)
    dp_ax = dp if batch % n_dp == 0 and batch > 1 else None

    def leaf_spec(p, leaf) -> Spec:
        shape = _shape(leaf)
        nd = len(shape)
        if "cross_" in p and cross_mode == "seq_sharded":
            lead = (None,) * (nd - 4)
            return P(*lead, dp_ax, _maybe("model", shape[-3], mesh),
                    None, None)
        if p.endswith("/k") or p.endswith("/v") or "cross_" in p:
            # (L, B, C, KV, hd) or (B, C, KV, hd)
            lead = (None,) * (nd - 4)
            if cross_mode == "seq_sharded":
                return P(*lead, dp_ax, _maybe("model", shape[-3], mesh),
                        None, None)
            if dp_ax:
                return P(*lead, dp_ax, None, None,
                         _maybe("model", shape[-1], mesh))
            return P(*lead, None, _maybe("data", shape[-3], mesh), None,
                     _maybe("model", shape[-1], mesh))
        if p.endswith("/c") or p.endswith("/kr"):
            # MLA compressed cache (L, B, C, r)
            lead = (None,) * (nd - 3)
            if dp_ax:
                return P(*lead, dp_ax, None, None)
            return P(*lead, None, _maybe("data", shape[-2], mesh), None)
        if p.endswith("/h"):
            # SSM state (L, B, H, N, P)
            lead = (None,) * (nd - 4)
            if dp_ax:
                return P(*lead, dp_ax, _maybe("model", shape[-3], mesh),
                        None, None)
            return P(*lead, None, _maybe("data", shape[-3], mesh), None,
                    _maybe("model", shape[-1], mesh))
        if p.endswith("/conv"):
            # conv state (L, B, W-1, C)
            lead = (None,) * (nd - 3)
            if dp_ax:
                return P(*lead, dp_ax, None, _maybe("model", shape[-1], mesh))
            return P(*lead, None, None, _maybe("model", shape[-1], mesh))
        return SPEC_NONE

    return map_with_path(leaf_spec, cache)


# --- DTensor layout ---------------------------------------------------------

def placements(spec: Spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where tensor dim d names the axis, else ``Replicate()``.
    A dim split over several axes must name them in the mesh's order (the
    major axis first), which is the order DTensor shards in."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        idx = [names.index(a) for a in axes if a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {dim} splits over {axes}, "
                             f"not in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def distribute(tree: Tree, specs: Tree, mesh) -> Tree:
    """Every leaf of ``tree`` as a DTensor on ``mesh`` laid out by its spec
    (``torch.distributed.tensor.distribute_tensor``: each rank keeps its
    shard of the same global tensor)."""
    from torch.distributed.tensor import distribute_tensor
    return tree_lib.map(
        lambda leaf, spec: distribute_tensor(leaf, mesh,
                                             placements(spec, mesh)),
        tree, specs)


def local_bytes(tree: Tree) -> int:
    """Bytes of this rank's shards of a tree (of a plain tensor, all of
    it)."""
    total = 0
    for leaf in tree_lib.leaves(tree):
        t = leaf.to_local() if shards.is_dtensor(leaf) else leaf
        total += t.numel() * t.element_size()
    return total


def full(tree: Tree) -> Tree:
    """A tree's leaves as whole plain tensors (DTensors gathered)."""
    return tree_lib.map(
        lambda x: x.full_tensor() if shards.is_dtensor(x) else x, tree)

