"""FIFO streaming device data (paper §I: rapidly changing streaming data),
and the gradient-corruption schedule of the robustness layer (DESIGN.md
§15).

Every device holds only its *next* mini-batch (labels pre-drawn so the
class-count vector a_t^{m,k} is reportable to the BS before selection);
images are generated lazily ONLY for the devices that are actually selected.
After each iteration all devices advance. Pure numpy, so counts and images
are bit-equal to the JAX package's ``FactoryStreams`` for the same seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import tree
from ..core import prng
from . import femnist
from .partition import Partition


class FactoryStreams:
    """Vectorized streams for all M×K devices."""

    def __init__(self, part: Partition, batch_size: int = 32, seed: int = 0):
        self.part = part
        self.n = batch_size
        self.m, self.k, self.f = part.class_probs.shape
        self._rng = np.random.default_rng(seed + 7)
        self._t = 0
        self._next_labels = None
        self._draw_next()

    def _draw_next(self) -> None:
        """Draw next-batch labels for every device: (M, K, n)."""
        probs = self.part.class_probs                     # (M,K,F)
        u = self._rng.random((self.m, self.k, self.n, 1))
        cdf = np.cumsum(probs, axis=-1)[:, :, None, :]    # (M,K,1,F)
        self._next_labels = (u > cdf).sum(axis=-1).astype(np.int32)
        self._t += 1

    def next_counts(self) -> np.ndarray:
        """a_t^{m,k} for all devices: (M, K, F) int32."""
        onehot = (self._next_labels[..., None]
                  == np.arange(self.f)[None, None, None, :])
        return onehot.sum(axis=2).astype(np.int32)

    def fetch_selected(self, masks: np.ndarray, l: int
                       ) -> tuple[np.ndarray, np.ndarray]:
        """Generate images for the selected devices only.

        Args:
          masks: (M, K) 0/1 selection; exactly ``l`` ones per group.
        Returns:
          images (M, L, n, 28, 28), labels (M, L, n) — device order matches
          ``argsort(-mask, kind="stable")[:L]``, i.e. ascending device index
          (the gather order the trainer relies on).
        """
        imgs = np.zeros((self.m, l, self.n, femnist.IMAGE_SIZE,
                         femnist.IMAGE_SIZE), np.float32)
        labs = np.zeros((self.m, l, self.n), np.int32)
        for mi in range(self.m):
            sel = np.argsort(-masks[mi], kind="stable")[:l]
            for j, ki in enumerate(sel):
                labels = self._next_labels[mi, ki]
                wid = int(self.part.writer_ids[mi, ki])
                sample_ids = (self._t * 1_000_000
                              + (mi * self.k + ki) * self.n
                              + np.arange(self.n))
                imgs[mi, j] = femnist.generate_images(
                    labels, np.full(self.n, wid), sample_ids)
                labs[mi, j] = labels
        self._draw_next()  # streaming: every device's buffer rolls over
        return imgs, labs


# ---------------------------------------------------------------------------
# Gradient corruption (DESIGN.md §15.1): a deterministic subset of devices
# emits a poisoned/faulty *update* (sensor fault, firmware bug, adversary).
# ---------------------------------------------------------------------------

CORRUPTION_MODES = ("nan_burst", "inf_spike", "scale", "sign_flip",
                    "gauss_noise")


@dataclasses.dataclass(frozen=True)
class CorruptionConfig:
    """Parameterized gradient corruption (DESIGN.md §15.1).

    ``mode`` is one of :data:`CORRUPTION_MODES`, or a ``'+'``-joined mix
    (e.g. ``'scale+nan_burst'``): each faulty device is assigned ONE mode
    from the mix by a per-device hash.

      * ``nan_burst``   — the whole gradient becomes NaN.
      * ``inf_spike``   — the whole gradient becomes +Inf.
      * ``scale``       — the gradient is multiplied by ``scale``.
      * ``sign_flip``   — the gradient is negated.
      * ``gauss_noise`` — i.i.d. N(0, ``sigma``²) noise is added.

    A fixed ``frac`` fraction of devices is faulty (hashed membership);
    each faulty device fires i.i.d. with probability ``prob`` per
    iteration, starting at iteration ``t0``.
    """
    mode: str = "nan_burst"
    frac: float = 0.2          # fraction of devices that are faulty
    prob: float = 0.5          # per-iteration firing probability
    t0: int = 0                # first iteration at which faults can fire
    scale: float = 25.0        # 'scale' mode multiplier
    sigma: float = 1.0         # 'gauss_noise' mode std deviation

    @property
    def modes(self) -> tuple:
        return tuple(s.strip() for s in self.mode.split("+"))

    def __post_init__(self):
        for m in self.modes:
            if m not in CORRUPTION_MODES:
                raise ValueError(
                    f"unknown corruption mode: {m!r} (expected '+'-joined "
                    f"names from {CORRUPTION_MODES})")
        if not 0.0 <= self.frac <= 1.0:
            raise ValueError(f"frac must be a probability in [0, 1], "
                             f"got {self.frac}")
        if not 0.0 < self.prob <= 1.0:
            raise ValueError(f"prob must be in (0, 1], got {self.prob}")
        if self.t0 < 0:
            raise ValueError(f"t0 must be >= 0, got {self.t0}")
        if self.scale <= 0:
            raise ValueError(f"scale must be > 0, got {self.scale}")
        if self.sigma <= 0:
            raise ValueError(f"sigma must be > 0, got {self.sigma}")


def make_corruption_fn(corrupt: CorruptionConfig | None, seed: int):
    """Build ``corrupt_fn(grads, t, ids) -> (grads', hit)`` for one schedule.

    ``grads`` is a stacked per-member gradient tree (leaves (D, ...)),
    ``ids`` the (D,) flat device ids of those members (gid·K + k), ``t``
    the iteration index. Returns the corrupted stack and the (D,) float32
    ground-truth hit mask on the leaves' device. The fault trace — faulty
    membership, firing, the per-device mode and the noise keys — hashes the
    JAX package's ``fold_in`` keys (606 off the seed), so both packages
    corrupt the same members the same way; the trace is drawn on the host
    from the (D,) ids alone.

    Only the rows of hit members are touched, and they are overwritten IN
    PLACE (one indexed write per mode and leaf, no candidate tensor per
    mode): the caller hands over gradient buffers it owns. Gaussian noise is
    drawn on the leaves' device, only for the members that need it, every
    leaf of every such member in one pass (``prng.normal_segments_t``).
    ``corrupt=None`` returns None.
    """
    if corrupt is None:
        return None
    modes = corrupt.modes
    base_key = prng.fold_in(prng.PRNGKey(seed), 606)
    k_faulty, k_mode, k_fire, k_noise = (prng.fold_in(base_key, i)
                                         for i in (1, 2, 3, 4))

    def corrupt_fn(grads, t: int, ids):
        ids = np.asarray(torch.as_tensor(ids).cpu(), np.int64)
        faulty = prng.bernoulli(prng.fold_in(k_faulty, ids), corrupt.frac)
        fire = prng.bernoulli(prng.fold_in(prng.fold_in(k_fire, ids), t),
                              corrupt.prob)
        hit = faulty & fire & (t >= corrupt.t0)
        midx = prng.randint(prng.fold_in(k_mode, ids), (), 0, len(modes))
        leaves = tree.leaves(grads)
        dev = leaves[0].device
        for j, mode in enumerate(modes):
            rows = np.flatnonzero(hit & (midx == j))
            if rows.size == 0:
                continue
            r = torch.as_tensor(rows, device=dev)
            if mode == "gauss_noise":   # per (device, t, leaf) keys
                nkeys = prng.fold_in(prng.fold_in(k_noise, ids[rows]), t)
                sizes = [x[0].numel() for x in leaves]
                noise = prng.normal_segments_t(
                    prng.fold_in(nkeys[:, None], np.arange(len(leaves))),
                    sizes, dev).split(sizes, dim=1)
            for li, x in enumerate(leaves):
                if mode == "nan_burst":
                    x[r] = float("nan")
                elif mode == "inf_spike":
                    x[r] = float("inf")
                elif mode == "scale":
                    x[r] = x[r] * corrupt.scale
                elif mode == "sign_flip":
                    x[r] = -x[r]
                else:
                    x[r] = x[r] + corrupt.sigma * noise[li].reshape(
                        (len(rows),) + x.shape[1:])
        return grads, torch.as_tensor(hit, dtype=torch.float32, device=dev)

    return corrupt_fn
