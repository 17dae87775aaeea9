"""Nested parameter dicts (``{"conv1": {"w", "b"}, ...}``), tuples and lists
as pytrees: the few traversals the port needs, in the JAX package's leaf
order (dict keys sorted, sequences in order; ``()`` has no leaves)."""
from __future__ import annotations

from typing import Any, Callable

import torch

Tree = Any


def leaves(tree: Tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [leaf for node in tree for leaf in leaves(node)]
    return [tree]


def _build(node: Tree, it) -> Tree:
    if isinstance(node, dict):
        return {key: _build(node[key], it) for key in sorted(node)}
    if isinstance(node, (tuple, list)):
        return type(node)(_build(child, it) for child in node)
    return next(it)


def unflatten(like: Tree, flat: list) -> Tree:
    """A tree shaped like ``like`` holding ``flat`` (in :func:`leaves` order).
    A module-level recursion: a nested one would close over itself, and
    that cycle would keep ``flat``'s tensors alive until the garbage
    collector ran (the robust step's member stacks, gigabytes on the
    card)."""
    return _build(like, iter(flat))


def map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:  # noqa: A001
    if isinstance(tree, dict):
        return {key: map(fn, tree[key], *(r[key] for r in rest))
                for key in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map(fn, node, *(r[i] for r in rest))
                          for i, node in enumerate(tree))
    return fn(tree, *rest)
