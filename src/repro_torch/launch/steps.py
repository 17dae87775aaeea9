"""The serve step of the LM path and the FEDGS selection and Eq. 5 steps
(the ports of ``make_serve_step``, ``make_select_step`` and
``external_sync_step`` in the JAX package's ``launch/steps.py``; the train
steps wait for LM training, ROADMAP item 18.4)."""
from __future__ import annotations

import numpy as np
import torch

from .. import tree
from ..core import gbp_cs, selection, sync
from ..models import build


def external_sync_step(stacked_params):
    """Eq. 5: ω ← (1/M) Σ_m ω^m across the leading pod axis, broadcast back
    to every pod. The pod average runs through the ``agg_weighted`` kernel
    on a card (``sync.external_average``), its plain version on the CPU."""
    mean = sync.external_average(stacked_params)
    return tree.map(lambda g, p: g[None].expand(p.shape).to(p.dtype)
                    .contiguous(), mean, stacked_params)


def make_select_step(num_selected: int, num_presampled: int, *,
                     init: str = gbp_cs.MPINV, max_iters: int = 64):
    """The GBP-CS client-selection step (counts → masks): ``select_step(
    keys (M, 2), counts (M, K, F), p_real (F,)) -> SelectionResult`` of
    every group, the batch of groups in one ``gbp_cs`` launch on the
    card."""

    def select_step(keys, counts, p_real):
        return selection.select_for_groups(
            np.asarray(keys), counts, p_real, num_selected, num_presampled,
            init=init, max_iters=max_iters)

    return select_step


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
