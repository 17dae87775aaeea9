"""Pytree checkpointing: .npz leaves + JSON manifest, in the JAX package's
on-disk format, so that a checkpoint written by either package restores in
the other bit for bit.

A step directory ``step_N`` holds ``arrays.npz`` (``leaf_i`` in
``tree.leaves`` order: dict keys sorted, the JAX package's leaf order) and
``manifest.json`` (``treedef``, ``num_leaves``, ``step``, ``metadata``,
``dtypes`` as numpy names, ``shapes``). It is written under a ``.tmp_``
directory and renamed into place, so a reader never sees half of it.
``treedef`` is this package's own structural string; restoring reads the
structure from the template, as the JAX package's does.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

from .. import tree

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"


def _treedef(node: Any) -> str:
    """The tree's structure with ``*`` for each leaf."""
    if isinstance(node, dict):
        return "{" + ", ".join(f"{key!r}: {_treedef(node[key])}"
                               for key in sorted(node)) + "}"
    if isinstance(node, (tuple, list)):
        inner = ", ".join(_treedef(child) for child in node)
        return f"({inner})" if isinstance(node, tuple) else f"[{inner}]"
    return "*"


def save(path: str, tree_: Any, *, step: int | None = None,
         metadata: dict | None = None) -> str:
    """Save a pytree of tensors to ``path`` (a directory), atomically.
    Returns the step directory."""
    leaves = [leaf.detach().cpu().numpy() for leaf in tree.leaves(tree_)]
    os.makedirs(path, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=path, prefix=".tmp_")
    np.savez(os.path.join(tmp, _ARRAYS),
             **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)})
    manifest = {
        "treedef": _treedef(tree_),
        "num_leaves": len(leaves),
        "step": step,
        "metadata": metadata or {},
        "dtypes": [str(leaf.dtype) for leaf in leaves],
        "shapes": [list(leaf.shape) for leaf in leaves],
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    final = os.path.join(path, f"step_{step if step is not None else 0}")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def load(ckpt_dir: str) -> tuple[list[np.ndarray], dict]:
    """Raw leaves (numpy) and the manifest of one step directory."""
    with open(os.path.join(ckpt_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    with np.load(os.path.join(ckpt_dir, _ARRAYS)) as data:
        leaves = [data[f"leaf_{i}"] for i in range(manifest["num_leaves"])]
    return leaves, manifest


def restore(ckpt_dir: str, like: Any) -> Any:
    """Restore into the structure of ``like``: the leaf count and each
    leaf's shape are checked, and each leaf comes back as a tensor with the
    dtype and device of ``like``'s leaf."""
    leaves, _ = load(ckpt_dir)
    like_leaves = tree.leaves(like)
    if len(leaves) != len(like_leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, template has "
            f"{len(like_leaves)}")
    for i, (got, want) in enumerate(zip(leaves, like_leaves)):
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"leaf {i}: shape {got.shape} != "
                             f"{tuple(want.shape)}")
    return tree.unflatten(like, [
        torch.from_numpy(got).to(device=want.device, dtype=want.dtype)
        for got, want in zip(leaves, like_leaves)])


def latest_step(path: str) -> str | None:
    """Most recent step directory under ``path`` (or None)."""
    if not os.path.isdir(path):
        return None
    steps = [(int(d.split("_", 1)[1]), d) for d in os.listdir(path)
             if d.startswith("step_") and d.split("_", 1)[1].isdigit()]
    if not steps:
        return None
    return os.path.join(path, max(steps)[1])
