"""Nested parameter dicts (``{"conv1": {"w", "b"}, ...}``) as pytrees: the
few traversals the port needs, in a fixed (sorted-key) leaf order."""
from __future__ import annotations

from typing import Any, Callable

import torch

Tree = Any


def leaves(tree: Tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in leaves(tree[key])]
    return [tree]


def unflatten(like: Tree, flat: list) -> Tree:
    """A tree shaped like ``like`` holding ``flat`` (in :func:`leaves` order)."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        return next(it)

    return build(like)


def map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:  # noqa: A001
    if isinstance(tree, dict):
        return {key: map(fn, tree[key], *(r[key] for r in rest))
                for key in sorted(tree)}
    return fn(tree, *rest)
