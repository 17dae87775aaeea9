"""Lazy million-device population (DESIGN.md §17), the port of the JAX
package's ``data/population.py``.

The dense partition holds every device's class distribution and writer as
a resident row, so host and device memory cap the population. Here the
population is a pure function of the flat device id: a device's class
distribution is a Dirichlet draw keyed ``fold_in(809, id)`` around its
factory's concentration (a Dirichlet(1) prior keyed ``fold_in(808,
factory)``, blended and scaled), and its writer style is a row of the
fixed 3550-writer style bank picked by ``randint(fold_in(810, id))``. Any
subset of devices costs O(|subset|), the global class marginal ``p_real``
is analytic (the Dirichlet mean), and :meth:`LazyPopulation.materialize`
is bit-identical to the lazy gathers.

The split follows the port's schedules (``data.DriftFn``,
``data.AvailFn``): the host hashes an array of ids into staged words
(:meth:`LazyPopulation.stage`: the id, its factory, its writer and its
Dirichlet key, numpy ``prng``), and the device turns staged words into
rows (``kernels.dirichlet.draw_rows``, the ``dirichlet_rows`` kernel on
the card, each element's concentration its factory's row of the (M, F)
table built once on the device) and styles (a gather from the resident
bank), reading nothing back. :class:`LazyPopulation` has the dense
``data.DeviceStream``'s population-view interface, so the device sampler
and the client pool take either.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core import prng
from ..kernels import dirichlet
from . import femnist
from .streaming import DeviceStream, xla_cumsum

# the writer-id universe the dense partition draws from
NUM_WRITERS = 3550

# the concentration table and p_real are built in slices of this many
# factories
_CHUNK = 4096


@functools.lru_cache(maxsize=1)
def _style_bank() -> np.ndarray:
    """(3550, 6) float32: every writer's persistent style row, computed on
    the host once (the port's own ``femnist.writer_style_table``)."""
    return femnist.writer_style_table(
        np.arange(NUM_WRITERS)).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class PopulationConfig:
    """Shape and skew of a lazy device universe (the JAX package's
    ``PopulationConfig``: the dense partition's α skew and factory-bias
    blend, drawn in ``jax.random`` fold_in space, so that
    ``devices_per_factory`` can be far larger)."""
    num_factories: int = 10            # M
    devices_per_factory: int = 35      # K_pop (physical, not engine slots)
    alpha: float = 0.3                 # Dirichlet skew
    factory_bias: float = 0.5          # 0 = iid factories, 1 = strongly biased
    num_classes: int = femnist.NUM_CLASSES
    batch_size: int = 32               # n
    seed: int = 0

    def __post_init__(self):
        if self.num_factories < 1:
            raise ValueError(f"num_factories must be >= 1, "
                             f"got {self.num_factories}")
        if self.devices_per_factory < 1:
            raise ValueError(f"devices_per_factory must be >= 1, "
                             f"got {self.devices_per_factory}")
        if self.alpha <= 0:
            raise ValueError(f"alpha must be > 0, got {self.alpha}")
        if not 0.0 <= self.factory_bias <= 1.0:
            raise ValueError(f"factory_bias must be in [0, 1], "
                             f"got {self.factory_bias}")

    @property
    def total_devices(self) -> int:
        return self.num_factories * self.devices_per_factory


class LazyPopulation:
    """A device universe over a :class:`PopulationConfig`, pure in (id,
    seed), on ``device``: the (M, F) factory concentration table and the
    style bank are its only resident state, whatever the number of
    devices. Key chains under ``PRNGKey(seed)``: 808 the factory prior,
    809 the device's Dirichlet, 810 its writer."""

    staged_words = 5            # id, factory, writer, two key words

    def __init__(self, config: PopulationConfig, device="cuda"):
        self.config = config
        self.device = torch.device(device)
        base = prng.PRNGKey(config.seed)
        self._k_prior, self._k_dev, self._k_writer = (
            prng.fold_in(base, tag) for tag in (808, 809, 810))
        self.bank = torch.as_tensor(_style_bank(), device=self.device)
        m, f = config.num_factories, config.num_classes
        self.table = torch.empty(m, f, device=self.device)
        for lo in range(0, m, _CHUNK):
            hi = min(lo + _CHUNK, m)
            self.table[lo:hi] = self.factory_concentration(np.arange(lo, hi))
        self._p_real = None

    # -- the population-view interface (shared with DeviceStream) ---------
    @property
    def num_factories(self) -> int:
        return self.config.num_factories

    @property
    def devices_per_factory(self) -> int:
        return self.config.devices_per_factory

    @property
    def num_classes(self) -> int:
        return self.config.num_classes

    @property
    def batch_size(self) -> int:
        return self.config.batch_size

    @property
    def seed(self) -> int:
        return self.config.seed

    @property
    def total_devices(self) -> int:
        return self.config.total_devices

    def factory_concentration(self, mids) -> torch.Tensor:
        """(G,) factory ids → (G, F) Dirichlet concentrations on the
        device: a prior ~ Dirichlet(1) keyed ``fold_in(808, factory)``
        (the kernel at α = 1), blended with uniform by ``factory_bias`` and
        scaled by F·α, floored at 1e-3 — the JAX package's
        ``factory_concentration`` as its engines compute it under ``jit``:
        the blend one rounding (XLA contracts it) and F·α one float32
        constant (XLA folds the two products)."""
        c = self.config
        f = c.num_classes
        keys = prng.fold_in(self._k_prior, np.asarray(mids, np.int64))
        trace = np.zeros(keys.shape[:-1] + (4,), np.int64)
        trace[:, 2:] = keys
        return self.blend(dirichlet.draw_rows(
            torch.as_tensor(trace, device=self.device),
            torch.ones(len(trace), f, device=self.device)))

    def blend(self, prior: torch.Tensor) -> torch.Tensor:
        """(G, F) factory priors → their concentrations:
        max(((1 − b)/F + b·prior)·(F·α), 1e-3), the float32 arithmetic of
        the JAX package's ``factory_concentration`` under ``jit``."""
        c = self.config
        f = c.num_classes
        blended = prng._fma(prior, float(np.float32(c.factory_bias)),
                            float(np.float32((1.0 - c.factory_bias) / f)))
        scale = np.float32(f) * np.float32(c.alpha)
        return torch.clamp_min(blended * float(scale),
                               float(np.float32(1e-3)))

    def stage(self, ids) -> np.ndarray:
        """(...,) flat device ids → (..., 5) int64 staged words, hashed on
        the host: the id, its factory ``id // K_pop``, its writer
        ``randint(fold_in(810, id), 0, 3550)`` and its Dirichlet key
        ``fold_in(809, id)``."""
        ids = np.asarray(ids, np.int64)
        out = np.empty(ids.shape + (self.staged_words,), np.int64)
        out[..., 0] = ids
        out[..., 1] = ids // self.config.devices_per_factory
        out[..., 2] = prng.randint(prng.fold_in(self._k_writer, ids), (), 0,
                                   NUM_WRITERS)
        out[..., 3:] = prng.fold_in(self._k_dev, ids)
        return out

    def rows(self, staged: torch.Tensor) -> torch.Tensor:
        """(..., 5) staged words on the device → (..., F) class
        distributions: one ``dirichlet_rows`` launch, each row around its
        factory's row of the table."""
        flat = staged.reshape(-1, self.staged_words)
        probs = dirichlet.draw_rows(flat[:, 1:], self.table[flat[:, 1]])
        return probs.reshape(staged.shape[:-1] + (self.num_classes,))

    def styles(self, staged: torch.Tensor) -> torch.Tensor:
        """(..., 5) staged words → (..., 6) writer styles from the bank."""
        return self.bank[staged[..., 2]]

    def cdf_of(self, staged: torch.Tensor, drift=None, trace=None
               ) -> torch.Tensor:
        """(..., F) cumulative distributions of the staged devices, drifted
        under ``trace`` when ``drift`` is given: ``xla_cumsum_t`` of the
        drawn (and drifted) rows."""
        return DeviceStream.cumulative(self.rows(staged), drift, trace)

    def probs_for(self, ids) -> torch.Tensor:
        """(...,) flat device ids → (..., F) class distributions."""
        return self.rows(self._staged(ids))

    def styles_for(self, ids) -> torch.Tensor:
        """(...,) flat device ids → (..., 6) writer-style rows."""
        return self.styles(self._staged(ids))

    def _staged(self, ids) -> torch.Tensor:
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        return torch.as_tensor(self.stage(ids), device=self.device)

    @property
    def p_real(self) -> np.ndarray:
        """(F,) analytic global class marginal: the factory mean of the
        normalized concentrations (E[Dirichlet(a)] = a / Σa), summed over
        :data:`_CHUNK`-factory slices of the table in float64."""
        if self._p_real is None:
            c = self.config
            total = np.zeros((c.num_classes,), np.float64)
            for lo in range(0, c.num_factories, _CHUNK):
                conc = self.table[lo:lo + _CHUNK]
                total += (conc / conc.sum(-1, keepdim=True)).sum(0).cpu(
                ).numpy().astype(np.float64)
            p = total / c.num_factories
            self._p_real = (p / p.sum()).astype(np.float32)
        return self._p_real

    def materialize(self) -> DeviceStream:
        """The WHOLE population as a dense :class:`DeviceStream` (small
        M·K_pop only: the array the lazy view exists to avoid), its cdf
        ``xla_cumsum`` on the host as the dense stream's. Bit-identical to
        the lazy gathers."""
        c = self.config
        staged = torch.as_tensor(self.stage(np.arange(c.total_devices)),
                                 device=self.device)
        shape = (c.num_factories, c.devices_per_factory)
        probs = self.rows(staged).reshape(shape + (c.num_classes,))
        return DeviceStream(
            class_probs=probs,
            cdf=torch.as_tensor(xla_cumsum(probs.cpu().numpy()),
                                device=self.device),
            styles_table=self.styles(staged).reshape(shape + (6,)),
            batch_size=c.batch_size, seed=c.seed)
