"""Model factory: ArchConfig -> (init, loss, forward, decode) functions.

The port of the JAX package's ``models/factory.py`` for the arch types the
port runs: dense decoder-only LMs with GQA attention, Mamba2 SSMs and the
Zamba2 hybrid. The others raise ``NotImplementedError`` naming their
ROADMAP item.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from . import transformer


class ModelFns(NamedTuple):
    init: Callable[..., dict]                  # (key, device="cuda")
    loss: Callable[..., object]                # (params, batch, **kw)
    forward: Callable[..., object]             # (params, batch, **kw)
    init_decode_cache: Callable[..., dict]     # (batch, seq_len, **kw)
    decode_step: Callable[..., tuple]          # (params, cache, tokens, pos)


def _not_ported(cfg) -> str | None:
    if cfg.is_encoder_decoder or cfg.arch_type == "audio":
        return "encoder-decoder (audio) models"
    if cfg.arch_type in ("moe", "vlm"):
        return f"{cfg.arch_type} models"
    if cfg.kv_lora_rank > 0:
        return "MLA attention (kv_lora_rank > 0)"
    if cfg.arch_type not in transformer.ARCH_TYPES:
        return f"arch_type {cfg.arch_type!r}"
    return None


def build(cfg) -> ModelFns:
    what = _not_ported(cfg)
    if what is not None:
        raise NotImplementedError(f"{cfg.name}: {what} are not ported to "
                                  "PyTorch yet (ROADMAP item 18)")

    def loss(params, batch, **kw):
        raise NotImplementedError("LM training (lm_loss) is not ported yet "
                                  "(ROADMAP item 18)")

    def fwd(params, batch, **kw):
        logits, _ = transformer.forward(cfg, params, batch["tokens"], **kw)
        return logits

    return ModelFns(
        init=lambda key, device="cuda": transformer.init_lm(cfg, key, device),
        loss=loss,
        forward=fwd,
        init_decode_cache=lambda batch, seq_len, **kw:
            transformer.init_decode_cache(cfg, batch, seq_len, **kw),
        decode_step=lambda params, cache, tokens, pos, **kw:
            transformer.decode_step(cfg, params, cache, tokens, pos, **kw),
    )
