"""Synthetic token stream for the LM architectures (numpy, host).

The port's copy of the JAX package's ``data/lm_data.py``: an order-1
Markov chain over the vocabulary with skewed transitions, drawn by
``np.random.default_rng(seed)``, so the same seed gives the same tokens
bit for bit.
"""
from __future__ import annotations

import numpy as np


class MarkovLMStream:
    """Order-1 Markov token generator over a small vocab."""

    def __init__(self, vocab: int, seed: int = 0, skew: float = 2.0):
        rng = np.random.default_rng(seed)
        logits = rng.normal(0, skew, size=(vocab, vocab))
        self.trans = np.exp(logits)
        self.trans /= self.trans.sum(axis=1, keepdims=True)
        self.vocab = vocab
        self._rng = rng

    def sample(self, batch: int, seq_len: int) -> np.ndarray:
        out = np.empty((batch, seq_len), np.int32)
        state = self._rng.integers(0, self.vocab, size=batch)
        for t in range(seq_len):
            out[:, t] = state
            u = self._rng.random((batch, 1))
            cdf = np.cumsum(self.trans[state], axis=1)
            state = (u > cdf).sum(axis=1)
        return out

    def batch(self, batch: int, seq_len: int) -> dict:
        toks = self.sample(batch, seq_len)
        return {"tokens": toks, "labels": toks}
