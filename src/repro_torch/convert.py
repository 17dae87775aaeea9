"""Carry parameters between the JAX package and the port.

The JAX package's parameter trees are nested dicts of arrays; as numpy
arrays they cross into the port unchanged (same layouts, HWIO conv
weights), so both packages compute the same function on the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree_of_numpy, device: str | torch.device = "cuda"):
    """Nested dict of array-likes (e.g. ``jax.tree.map(np.asarray, p)``) →
    the same dict of float32 torch tensors on ``device``."""
    if isinstance(tree_of_numpy, dict):
        return {k: params_from_jax(v, device) for k, v in tree_of_numpy.items()}
    return torch.as_tensor(np.array(tree_of_numpy, np.float32),
                           device=device)


def params_to_numpy(params):
    """Inverse of :func:`params_from_jax`: tensors → numpy arrays."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().cpu().numpy()
