"""Carry parameters and trainer state between the JAX package and the port.

The JAX package's trees are nested dicts, tuples and lists of arrays (a
baseline's (params, extras, server state): dicts, ``()``, Adam's
``(m, v, t)`` with an int32 step count); as numpy arrays they cross into
the port unchanged (same layouts, HWIO conv weights), so both packages
compute the same function on the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree_of_numpy, device: str | torch.device = "cuda"):
    """Tree of array-likes (e.g. ``jax.tree.map(np.asarray, p)``) → the same
    tree of tensors on ``device``: floats as float32, integers as int32."""
    if isinstance(tree_of_numpy, dict):
        return {k: params_from_jax(v, device) for k, v in tree_of_numpy.items()}
    if isinstance(tree_of_numpy, (tuple, list)):
        return type(tree_of_numpy)(params_from_jax(v, device)
                                   for v in tree_of_numpy)
    arr = np.asarray(tree_of_numpy)
    dtype = np.int32 if np.issubdtype(arr.dtype, np.integer) else np.float32
    return torch.as_tensor(np.array(arr, dtype), device=device)


def params_to_numpy(params):
    """Inverse of :func:`params_from_jax`: tensors → numpy arrays."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (tuple, list)):
        return type(params)(params_to_numpy(v) for v in params)
    return params.detach().cpu().numpy()
