"""Aggregation primitives of Alg. 1 (Eqs. 3–5) on parameter dicts."""
from __future__ import annotations

import torch

from .. import tree
from . import dispatch

EPS = 1e-12


def apply_sgd(params, grads, lr: float):
    """The SGD update of Eq. (3), applied once to an averaged gradient."""
    return tree.map(lambda p, g: p - lr * g, params, grads)


def weighted_average(trees, weights: torch.Tensor):
    """Weighted average over a leading client axis, leaf by leaf (the plain
    form of Eq. 4); an all-zero weight vector gives the zero tree."""
    w = weights.float()
    wn = w / torch.clamp_min(w.sum(), EPS)
    return tree.map(
        lambda leaf: torch.sum(
            leaf.float() * wn.reshape((-1,) + (1,) * (leaf.dim() - 1)),
            dim=0).to(leaf.dtype), trees)


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
