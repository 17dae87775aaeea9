"""Which implementation each kernel op runs (the port's counterpart of the
JAX package's ``core.dispatch`` / ``op_modes()``).

The tensor's device decides: a CPU tensor runs the op's plain PyTorch
version, a CUDA tensor runs the hand-written kernel (or the wrapper raises).
There is no backend switch and no fallback.

| op | kernel (CUDA tensors) | plain version (CPU tensors) |
|---|---|---|
| GBP-CS loop (Alg. 2) | ``kernels.gbp_cs.minimize`` | ``kernels.gbp_cs.minimize_plain`` |
| conv superbatch block | ``kernels.conv_fused.fused`` | ``kernels.conv_fused.fused_plain`` |
| weighted average (Eqs. 4/5) | ``kernels.agg_weighted.agg`` | ``kernels.agg_weighted.agg_plain`` |

:func:`launch_counts` reports how many times each kernel was launched since
:func:`reset_launch_counts`; a run whose counts stay 0 did not go through
the kernels.
"""
from __future__ import annotations

from ..kernels import agg_weighted, conv_fused, gbp_cs

KERNELS = {mod.NAME: mod for mod in (gbp_cs, conv_fused, agg_weighted)}

gbp_cs_loop = gbp_cs.minimize
conv_block_grouped = conv_fused.conv_block_grouped
weighted_average_tree = agg_weighted.weighted_average_tree


def launch_counts() -> dict[str, int]:
    return {name: mod.LAUNCHES for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.LAUNCHES = 0
