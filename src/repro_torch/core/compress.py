"""Gradient compression for the Eq. 4 / Eq. 5 sync links (DESIGN.md §18).

The port's copy of the JAX package's ``core/compress.py``: top-k magnitude
sparsification and stochastic int8 quantization, composable as
``'topk:FRAC'``, ``'int8'``, ``'topk:FRAC+int8'`` (top-k first), applied
at the internal (``FedGSConfig.compress_int``) and external
(``compress_ext``) sync links with per-group error feedback (EF, DESIGN.md
§18.1): ``y = C(g + e)`` is transmitted and ``e' = (g + e) − y`` carried to
the next sync event, so that the compression error telescopes.

The loop works on flat row buffers: every group's tree flattened into one
row of an (M, P4) f32 buffer (``kernels.agg_weighted.flatten``, P4 = |θ|
rounded up to 4 by a zero tail). :func:`ef_compress_rows` compresses all
rows in one call of each kernel (``kernels.topk_compress``,
``kernels.int8_quant``). ``k`` comes from the true |θ| = n, never from P4:
the ≤ 3 zero pad columns sit at the highest indices, so under the
lower-index tie rule every real coordinate (real zeros included) is seated
before them and a pad is never kept; the int8 draw hashes counter i for
coordinate i, so the real coordinates draw what a (n,) vector draws, and a
zero pad quantizes to zero. :func:`ef_compress` is the tree form of one
group, for holding the port against the JAX package leaf for leaf.

Byte accounting is analytic (DESIGN.md §18.3): :func:`payload_bytes` is the
one-direction wire size of one payload.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import tree
from ..kernels import agg_weighted, int8_quant, topk_compress

# PRNG domain of the compression keys (corruption = 606, DESIGN.md §15.1)
FOLD_COMPRESS = 909


@dataclasses.dataclass(frozen=True)
class CompressSpec:
    """One parsed compression operator: optional top-k sparsification
    (fraction of coordinates kept) followed by optional stochastic int8
    quantization of the survivors."""
    topk_frac: float | None = None
    int8: bool = False


def parse_compress(spec: str) -> CompressSpec | None:
    """Parse a ``compress_int``/``compress_ext`` string: ``'none'`` → None,
    ``'topk:FRAC'``, ``'int8'`` and their '+'-composition. Raises
    ValueError on anything else, as the JAX package does."""
    if spec is None or spec == "none":
        return None
    topk_frac, int8 = None, False
    for part in str(spec).split("+"):
        part = part.strip()
        if part.startswith("topk:"):
            if topk_frac is not None:
                raise ValueError(f"duplicate topk term in {spec!r}")
            try:
                topk_frac = float(part[len("topk:"):])
            except ValueError:
                raise ValueError(
                    f"bad topk fraction in {spec!r} (expected 'topk:FRAC')")
            if not 0.0 < topk_frac <= 1.0:
                raise ValueError(
                    f"topk fraction must be in (0, 1], got {topk_frac}")
        elif part == "int8":
            if int8:
                raise ValueError(f"duplicate int8 term in {spec!r}")
            int8 = True
        else:
            raise ValueError(
                f"unknown compression term {part!r} in {spec!r} "
                "(expected 'none', 'topk:FRAC', 'int8', or a '+' mix)")
    return CompressSpec(topk_frac=topk_frac, int8=int8)


def topk_count(n_params: int, frac: float) -> int:
    """Coordinates kept by ``topk:frac`` on an |θ| = n_params vector:
    ⌈frac·n⌉ clamped to [1, n]."""
    return max(1, min(n_params, int(math.ceil(frac * n_params))))


def payload_bytes(n_params: int, spec: CompressSpec | None) -> float:
    """One-direction wire size in bytes of one |θ| = n_params payload
    (DESIGN.md §18.3): 4|θ| dense; k (value, int32 index) pairs for top-k,
    1-byte values plus one f32 scale when int8-quantized; |θ| bytes plus
    the scale for dense int8."""
    if spec is None:
        return 4.0 * n_params
    if spec.topk_frac is not None:
        k = topk_count(n_params, spec.topk_frac)
        value_bytes = 1.0 if spec.int8 else 4.0
        scale = 4.0 if spec.int8 else 0.0
        return k * (value_bytes + 4.0) + scale
    return float(n_params) + 4.0


# ------------------------------------------------------ flat row forms

def topk_rows(x: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """Keep the k largest-|x| of the first n coordinates of each row of
    x (M, P4), ties to the lower index; k >= n keeps every row whole."""
    if k <= 0:
        return torch.zeros_like(x)
    if k >= n:
        return x
    return topk_compress.select(x, k)


def int8_rows(x: torch.Tensor, keys) -> torch.Tensor:
    """Stochastic int8 of each row of x (M, P4) under keys (M, 2) uint32,
    returned dequantized."""
    return int8_quant.quantize(x, keys)


def compress_rows(x: torch.Tensor, n: int, spec: CompressSpec,
                  keys) -> torch.Tensor:
    """One parsed spec on every row: top-k (k from |θ| = n), then int8."""
    if spec.topk_frac is not None:
        x = topk_rows(x, n, topk_count(n, spec.topk_frac))
    if spec.int8:
        x = int8_rows(x, keys)
    return x


def ef_compress_rows(g: torch.Tensor, e: torch.Tensor, n: int,
                     spec: CompressSpec, keys):
    """One error-feedback event on every row (DESIGN.md §18.1):
    x = g + e, y = C(x), e' = x − y. g, e (M, P4) f32 → (y, e', (M,)
    ‖e'‖₂)."""
    x = g + e
    y = compress_rows(x, n, spec, keys)
    e_new = x - y
    return y, e_new, torch.sqrt(torch.sum(e_new * e_new, dim=1))


def zero_residual(group_params) -> torch.Tensor:
    """The (M, P4) f32 zero residual of a group-stacked tree (leaves
    (M, ...))."""
    return torch.zeros_like(agg_weighted.flatten(
        group_params, tree.leaves(group_params)[0].shape[0]))


def ef_compress(params_tree, residual, spec: CompressSpec, key):
    """Tree form of one group's EF event (the JAX package's
    ``ef_compress``): top-k is global over the tree flattened to one
    vector. Returns (y in the tree's structure, e' as a tree, ‖e'‖₂)."""
    one = lambda t: agg_weighted.flatten(tree.map(lambda v: v[None], t), 1)
    n = sum(leaf.numel() for leaf in tree.leaves(params_tree))
    y, e_new, err = ef_compress_rows(
        one(params_tree), one(residual), n, spec,
        np.asarray(key, np.uint32)[None])
    return (agg_weighted.unflatten(y[0], params_tree, 0),
            agg_weighted.unflatten(e_new[0], residual, 0), err[0])
