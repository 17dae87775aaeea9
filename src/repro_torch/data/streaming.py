"""FIFO streaming device data (paper §I: rapidly changing streaming data).

Every device holds only its *next* mini-batch (labels pre-drawn so the
class-count vector a_t^{m,k} is reportable to the BS before selection);
images are generated lazily ONLY for the devices that are actually selected.
After each iteration all devices advance. Pure numpy, so counts and images
are bit-equal to the JAX package's ``FactoryStreams`` for the same seed.
"""
from __future__ import annotations

import numpy as np

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
