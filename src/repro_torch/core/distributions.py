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


def estimate_p_real(counts: torch.Tensor) -> torch.Tensor:
    """Eq. (2): P_real = norm(Σ_{m,k} N^{m,k} P^{m,k}), the normalized
    global count histogram of integer class counts (..., F)."""
    c = counts.float()
    return norm(torch.sum(c.reshape(-1, c.shape[-1]), dim=0))


def supernode_distribution(counts: torch.Tensor,
                           mask: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Mean class distribution P_t^m of a selected device set: counts (K,
    F), an optional (K,) 0/1 mask (all devices if None) → (F,)."""
    c = counts.float()
    if mask is not None:
        c = c * mask.float()[:, None]
    return norm(torch.sum(c, dim=0))


def selection_objective(A: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                        ) -> torch.Tensor:
    """Eq. (10): || A x - y ||_2 with A (F, K), x (K,), y (F,)."""
    return torch.linalg.vector_norm(A.float() @ x.float() - y.float())


def selection_divergence(A: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                         p_real: torch.Tensor) -> torch.Tensor:
    """Eq. (7): divergence of the full super node (pre-sampled b plus the
    selected A x)."""
    pooled = A.float() @ x.float() + b.float()
    return distribution_divergence(norm(pooled), p_real)


def _bincount(idx: torch.Tensor, length: int) -> torch.Tensor:
    """``jnp.bincount(idx, length=length)``: negative values count in bin
    0, values ≥ ``length`` are dropped; int32."""
    idx = idx.reshape(-1).to(torch.int64).clamp_min(0)
    keep = idx < length
    out = torch.zeros(length, dtype=torch.int64, device=idx.device)
    out.scatter_add_(0, torch.where(keep, idx, 0), keep.to(torch.int64))
    return out.to(torch.int32)


def class_counts(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Per-class count vector a = n * P of a label batch. Shape (F,), int32.
    Labels are taken as int32 first, as the JAX package takes them."""
    return _bincount(labels.to(torch.int32), num_classes)


_KNUTH = 2654435761     # Knuth's multiplicative hash constant, < 2³²
_LOW32 = 0xFFFFFFFF


def token_bucket_counts(tokens: torch.Tensor, num_buckets: int
                        ) -> torch.Tensor:
    """LM-arch label statistics: token ids hashed into F coarse buckets
    (DESIGN.md §6) by ``uint32(t · 2654435761) % F``. The wrapping uint32
    product is formed in int64 from the constant's two 16-bit halves, so
    no intermediate leaves int64's range."""
    t = tokens.reshape(-1).to(torch.int64) & _LOW32
    lo = t * (_KNUTH & 0xFFFF)
    hi = ((t * (_KNUTH >> 16)) & 0xFFFF) << 16
    return _bincount(((lo + hi) & _LOW32) % num_buckets, num_buckets)
