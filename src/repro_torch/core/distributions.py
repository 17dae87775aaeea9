"""Class-distribution utilities for FEDGS (paper §III–§V).

All distributions are length-F vectors (any leading batch dims). Devices
report only integer class-count vectors ``a^{m,k} = n^{m,k} * P^{m,k}``.
"""
from __future__ import annotations

import torch


def norm(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Probability normalization ``norm(.)`` used in Eq. (2)."""
    v = v.float()
    return v / torch.clamp_min(torch.sum(v, dim=dim, keepdim=True), eps)


def distribution_divergence(p: torch.Tensor, p_real: torch.Tensor
                            ) -> torch.Tensor:
    """Eq. (6): L2 divergence || P - P_real ||_2 (leading batch axes)."""
    return torch.linalg.vector_norm(p.float() - p_real, dim=-1)


def mask_divergence(counts: torch.Tensor, mask: torch.Tensor,
                    p_real: torch.Tensor) -> torch.Tensor:
    """Eq. (6) for a selection mask: divergence of the super node the mask
    pools out of the counts. counts (..., K, F), mask (..., K) → (...)."""
    pooled = torch.sum(counts.float() * mask.float()[..., None], dim=-2)
    return distribution_divergence(norm(pooled), p_real)


def group_discrepancy(counts: torch.Tensor, p_real: torch.Tensor
                      ) -> torch.Tensor:
    """|| norm(Σ_k a^{m,k}) − P_real ||_2 over ALL K devices of each group:
    counts (..., K, F) → (...)."""
    return distribution_divergence(norm(torch.sum(counts.float(), dim=-2)),
                                   p_real)
