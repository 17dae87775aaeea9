"""Which implementation each kernel op runs (the port's counterpart of the
JAX package's ``core.dispatch`` / ``op_modes()``).

The tensor's device decides: a CPU tensor runs the op's plain PyTorch
version, a CUDA tensor runs the hand-written kernel (or the wrapper raises).
A meta tensor (the dry run's) takes the plain version's shape arithmetic
in the wrappers that a model or the train step reaches. There is no
backend switch and no fallback.

| op | kernel (CUDA tensors) | plain version (CPU tensors) |
|---|---|---|
| GBP-CS loop (Alg. 2) | ``kernels.gbp_cs.minimize`` | ``kernels.gbp_cs.minimize_plain`` |
| conv superbatch block | ``kernels.conv_fused.fused`` | ``kernels.conv_fused.fused_plain`` |
| weighted average (Eqs. 4/5) | ``kernels.agg_weighted.agg`` | ``kernels.agg_weighted.agg_plain`` |
| order statistics of robust Eq. 4 | ``kernels.robust_agg.aggregate`` | ``kernels.robust_agg.aggregate_plain`` |
| top-k of §18 compression | ``kernels.topk_compress.select`` | ``kernels.topk_compress.select_plain`` |
| stochastic int8 of §18 compression | ``kernels.int8_quant.quantize`` | ``kernels.int8_quant.quantize_plain`` |
| §15 fault injection (the fault trace applied) | ``kernels.corrupt.corrupt_rows`` | ``kernels.corrupt.corrupt_rows_plain`` |
| §13 drifted class distributions (Dirichlet redraw), §17 resident devices' rows | ``kernels.dirichlet.drift_rows`` / ``draw_rows`` | ``kernels.dirichlet.drift_rows_plain`` |
| §14 availability trace (up-mask and latency) | ``kernels.avail.avail_rows`` | ``kernels.avail.avail_rows_plain`` |
| LM attention (``attend(impl="pallas")``) | ``kernels.flash_attention.flash_attention`` | ``kernels.flash_attention.attention_plain`` |
| Mamba2 SSD scan (``models.ssm.mamba_forward``) | ``kernels.ssd_scan.ssd_scan`` | ``kernels.ssd_scan.ssd_scan_plain`` |
| its gradient (autograd through ``ssd_scan``) | ``kernels.ssd_scan_bwd.backward`` | autograd through ``ssd_scan_plain`` |

:func:`launch_counts` reports how many times each kernel was launched since
:func:`reset_launch_counts`; a run whose counts stay 0 did not go through
the kernels.
"""
from __future__ import annotations

import functools

from ..kernels import (agg_weighted, avail, conv_fused, corrupt, dirichlet,
                       flash_attention, gbp_cs, int8_quant, robust_agg,
                       ssd_scan, ssd_scan_bwd, topk_compress)

KERNELS = {mod.NAME: mod for mod in (gbp_cs, conv_fused, agg_weighted,
                                     robust_agg, topk_compress, int8_quant,
                                     flash_attention, ssd_scan, ssd_scan_bwd,
                                     corrupt, dirichlet, avail)}

gbp_cs_loop = gbp_cs.minimize
conv_block_grouped = conv_fused.conv_block_grouped
weighted_average_tree = agg_weighted.weighted_average_tree
weighted_average_groups = agg_weighted.weighted_average_groups


def robust_agg_fn(method: str, *, clip: float = 10.0, trim: int = 1):
    """Robust Eq. 4 (DESIGN.md §15.2) over the flattened member stacks of
    all groups: ``fn(flat (M, K, P4), weights (M, K)[, stats=]) -> (M, P4)``
    (``stats``: ``kernels.robust_agg.member_stats(flat)``, if at hand).
    ``mean`` and ``clip_norm`` run the ``agg_weighted`` kernel per group
    (``mean`` unmasked, so NaN members propagate as in the JAX package);
    ``trimmed_mean`` and ``coord_median`` run the ``robust_agg`` kernel
    once for all groups."""
    return functools.partial(robust_agg.aggregate_flat, method=method,
                             clip=clip, trim=trim)


def launch_counts() -> dict[str, int]:
    return {name: mod.LAUNCHES for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.LAUNCHES = 0
