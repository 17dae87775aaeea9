"""Non-i.i.d. partitioning: writers -> devices -> factories (paper §III).

Each device is a virtual writer with a Dirichlet(α) class distribution
(α controls skew; LEAF-FEMNIST-like at α≈0.3) and a log-normal data rate.
Factories group K^m geographically-adjacent devices; the factory assignment
can optionally be *location-biased* (devices in the same factory share a
class-prior tilt) which makes inter-factory divergence worse — the regime
FEDGS targets.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .femnist import NUM_CLASSES


@dataclasses.dataclass(frozen=True)
class PartitionConfig:
    num_factories: int = 10           # M
    devices_per_factory: int = 35     # K^m
    alpha: float = 0.3                # Dirichlet skew (smaller = more skewed)
    factory_bias: float = 0.5         # 0 = iid factories, 1 = strongly biased
    num_classes: int = NUM_CLASSES
    seed: int = 0

    @property
    def total_devices(self) -> int:
        return self.num_factories * self.devices_per_factory


@dataclasses.dataclass
class Partition:
    class_probs: np.ndarray   # (M, K, F) per-device class distributions
    writer_ids: np.ndarray    # (M, K)
    data_rates: np.ndarray    # (M, K) relative stream rates (unused sizes)
    p_real: np.ndarray        # (F,) global class distribution


def make_partition(cfg: PartitionConfig) -> Partition:
    rng = np.random.default_rng(cfg.seed)
    m, k, f = cfg.num_factories, cfg.devices_per_factory, cfg.num_classes
    # factory-level prior tilt (geographic clustering of usage patterns)
    factory_prior = rng.dirichlet(np.full(f, 1.0), size=m)      # (M, F)
    base = np.full(f, 1.0 / f)
    probs = np.empty((m, k, f), np.float64)
    for mi in range(m):
        prior = (1 - cfg.factory_bias) * base + cfg.factory_bias * factory_prior[mi]
        # per-device Dirichlet centred on the factory prior
        probs[mi] = rng.dirichlet(np.maximum(prior * f * cfg.alpha, 1e-3),
                                  size=k)
    writer_ids = rng.integers(0, 3550, size=(m, k))
    rates = np.exp(rng.normal(0.0, 0.5, size=(m, k)))
    # global distribution = rate-weighted device mixture (Eq. 2 analogue)
    w = rates / rates.sum()
    p_real = np.einsum("mk,mkf->f", w, probs)
    p_real = p_real / p_real.sum()
    return Partition(class_probs=probs.astype(np.float32),
                     writer_ids=writer_ids,
                     data_rates=rates.astype(np.float32),
                     p_real=p_real.astype(np.float32))
