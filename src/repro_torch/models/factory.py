"""Model factory: ArchConfig -> (init, loss, forward, decode) functions.

The port of the JAX package's ``models/factory.py``: dispatches on
``cfg.is_encoder_decoder`` (whisper: ``models/encdec``) and otherwise
builds the decoder-only stack (``models/transformer``: dense, MoE, SSM,
hybrid and VLM). ``loss`` is the training loss (``transformer.lm_loss``,
``encdec.encdec_loss``), taking ``window``, ``attn_impl``, ``remat`` and
``act_sharding``. :func:`make_dummy_batch` draws a batch of
``configs.input_specs`` from a threefry key.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core import prng
from . import encdec, transformer


class ModelFns(NamedTuple):
    init: Callable[..., dict]                  # (key, device="cuda")
    loss: Callable[..., object]                # (params, batch, **kw)
    forward: Callable[..., object]             # (params, batch, **kw)
    init_decode_cache: Callable[..., dict]     # (batch, seq_len, **kw)
    decode_step: Callable[..., tuple]          # (params, cache, tokens, pos)


def build(cfg) -> ModelFns:
    if cfg.is_encoder_decoder:
        return ModelFns(
            init=lambda key, device="cuda": encdec.init_encdec(cfg, key,
                                                               device),
            loss=lambda params, batch, **kw: encdec.encdec_loss(
                cfg, params, batch, **kw),
            forward=lambda params, batch, **kw: encdec.forward(
                cfg, params, batch, **kw),
            init_decode_cache=lambda batch, seq_len, **kw:
                encdec.init_decode_cache(cfg, batch, seq_len, **kw),
            decode_step=lambda params, cache, tokens, pos, **kw:
                encdec.decode_step(cfg, params, cache, tokens, pos, **kw),
        )
    if cfg.arch_type not in transformer.ARCH_TYPES:
        raise ValueError(cfg.arch_type)

    def fwd(params, batch, **kw):
        logits, _ = transformer.forward(
            cfg, params, batch["tokens"],
            prefix_embeds=batch.get("vision_embeds"), **kw)
        return logits

    return ModelFns(
        init=lambda key, device="cuda": transformer.init_lm(cfg, key, device),
        loss=lambda params, batch, **kw: transformer.lm_loss(
            cfg, params, batch, **kw),
        forward=fwd,
        init_decode_cache=lambda batch, seq_len, **kw:
            transformer.init_decode_cache(cfg, batch, seq_len, **kw),
        decode_step=lambda params, cache, tokens, pos, **kw:
            transformer.decode_step(cfg, params, cache, tokens, pos, **kw),
    )


def make_dummy_batch(cfg, shape, key=None, device="cuda") -> dict:
    """A random batch of ``configs.input_specs(cfg, shape)`` on ``device``:
    per spec, in order, ``key, sub = split(key)`` (from ``PRNGKey(0)`` by
    default); integer inputs ``randint(sub, shape, 0, vocab_size)``, float
    inputs ``normal(sub, shape) · 0.02`` — the JAX package's numbers."""
    from ..configs import input_specs
    key = np.asarray(key if key is not None else prng.PRNGKey(0), np.uint32)
    batch = {}
    for name, spec in input_specs(cfg, shape).items():
        key, sub = prng.split(key)
        if spec.dtype.is_floating_point:
            x = prng.normal_t(sub, spec.shape, device) * 0.02
        else:
            x = torch.as_tensor(prng.randint(sub, spec.shape, 0,
                                             cfg.vocab_size), device=device)
        batch[name] = x.to(spec.dtype)
    return batch
