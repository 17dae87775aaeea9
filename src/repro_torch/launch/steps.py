"""The serve step of the LM path (the port of ``make_serve_step`` in the
JAX package's ``launch/steps.py``; the train steps wait for LM training,
ROADMAP item 18)."""
from __future__ import annotations

import torch

from ..models import build


def make_serve_step(cfg, *, windowed: bool = False):
    """Returns serve_step(params, cache, tokens, pos) -> (next_tokens, cache):
    one-token batched decode, then the argmax over the unpadded vocabulary
    (the first maximal id on ties, as in JAX) as int32."""
    fns = build(cfg)

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        logits, cache = fns.decode_step(params, cache, tokens, pos,
                                        windowed=windowed)
        next_tokens = torch.argmax(logits[..., :cfg.vocab_size], dim=-1)
        return next_tokens.to(torch.int32), cache

    return serve_step
