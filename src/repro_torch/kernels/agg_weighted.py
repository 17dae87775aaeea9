"""Weighted aggregation of stacked models (paper Eqs. 4/5).

``weighted_average_tree(trees, weights)`` — leaves (K, ...), weights (K,) —
normalises the weights by ``max(Σw, 1e-12)``, flattens every leaf into ONE
(K, P) buffer with a single ``torch.cat`` (its zero tail pads P to a
multiple of 4 for the kernel's 16-byte loads), reduces it with :func:`agg`,
and unflattens: the layout of the JAX package's
``kernels/agg_weighted/ops.py:weighted_average_tree``.

:func:`agg` is the CUDA kernel (``csrc/agg_weighted.cu``) for CUDA tensors
and :func:`agg_plain` for CPU tensors.
"""
from __future__ import annotations

import torch

from .. import tree
from . import build

NAME = "agg_weighted"
SOURCE = "src/repro_torch/csrc/agg_weighted.cu"
REPLACES = "src/repro/kernels/agg_weighted/kernel.py:28 (agg_weighted_kernel)"
LAUNCHES = 0

EPS = 1e-12


def agg_plain(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: (K, P), (K,) → (P,) = Σ_k w_k X_k."""
    return torch.sum(weights[:, None] * stacked, dim=0)


def agg(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Σ_k w_k X_k: kernel on the card (P % 4 == 0), plain on CPU; on
    meta tensors the plain version's shape arithmetic (the dry run's
    Eq. 5)."""
    build.refuse_grad(NAME, stacked, weights)
    if stacked.device.type in ("cpu", "meta"):
        return agg_plain(stacked, weights)
    if stacked.device.type != "cuda":
        raise ValueError(f"agg_weighted: tensors on {stacked.device}; the "
                         "kernel takes CUDA tensors, the plain version CPU "
                         "ones")
    lib = build.library()
    k, p = stacked.shape
    if p % 4 or p == 0:
        raise ValueError(f"agg_weighted: P={p} must be a positive multiple "
                         "of 4")
    build.require(stacked, "stacked", (k, p), torch.float32, align=16)
    build.require(weights, "weights", (k,), torch.float32)
    out = torch.empty(p, dtype=torch.float32, device=stacked.device)
    err = lib.agg_weighted_f32(stacked.data_ptr(), weights.data_ptr(),
                               out.data_ptr(), k, p, build.stream(stacked))
    build.check(err, NAME)
    global LAUNCHES
    LAUNCHES += 1
    return out


def agg_groups(flat: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Σ_k w_gk X_gk for every group g: flat (G, K, P4), weights (G, K)
    already normalised → (G, P4), one :func:`agg` per group."""
    return torch.stack([agg(flat[g], weights[g]) for g in range(len(flat))])


def flatten(trees, k: int) -> torch.Tensor:
    """Leaves (K, ...) → one (K, P4) f32 buffer, P4 = P rounded up to 4."""
    parts = [leaf.reshape(k, -1).float() for leaf in tree.leaves(trees)]
    p = sum(part.shape[1] for part in parts)
    if p % 4:
        parts.append(parts[0].new_zeros((k, 4 - p % 4)))
    return torch.cat(parts, dim=1)


def unflatten(out: torch.Tensor, trees, lead: int):
    """A reduced (..., P4) buffer → a tree shaped like ``trees`` whose
    leaves lose their ``lead`` leading axes and take ``out``'s."""
    parts, off = [], 0
    for leaf in tree.leaves(trees):
        shape = leaf.shape[lead:]
        size = shape.numel()
        parts.append(out[..., off:off + size]
                     .reshape(out.shape[:-1] + shape).to(leaf.dtype))
        off += size
    return tree.unflatten(trees, parts)


def weighted_average_tree(trees, weights: torch.Tensor):
    """Same contract as ``core.sync.weighted_average`` (leaves (K, ...))."""
    w = weights.float()
    wn = (w / torch.clamp_min(w.sum(), EPS)).contiguous()
    return unflatten(agg(flatten(trees, len(w)), wn), trees, 1)


def weighted_average_groups(trees, weights: torch.Tensor):
    """Per-group weighted average: leaves (G, K, ...), weights (G, K) →
    leaves (G, ...); the stack is flattened once."""
    g, k = weights.shape
    w = weights.float()
    wn = (w / torch.clamp_min(w.sum(-1, keepdim=True), EPS)).contiguous()
    flat = flatten(trees, g * k).view(g, k, -1)
    return unflatten(agg_groups(flat, wn), trees, 2)
