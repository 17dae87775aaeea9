"""Whisper-style encoder-decoder backbone (audio arch): init, forward and
cached decode.

The port of the JAX package's ``models/encdec.py``. The mel-spectrogram +
conv feature extractor is a stub: the model consumes precomputed frame
embeddings (``encoder_frames`` of shape (B, S_enc, d_model), as
``configs.input_specs`` gives them).

Encoder: bidirectional self-attention layers, rotated at ``arange(S_enc)``.
Decoder: causal self-attention, cross-attention over the encoder output
(``attention.gqa_forward(kv_override=)``: q is not rotated), MLP. With
``attn_impl="pallas"`` all three run the flash kernel: the encoder and the
cross-attention non-causal, the cross-attention at Sq = S_dec over
Sk = S_enc. Decode caches the self-attention K/V (written in place, a ring
buffer if windowed) and each layer's cross K/V, projected once from the
encoder output (:func:`prefill_cross_cache`); a step attends over the
whole cross cache with unrotated q (``naive_attention``).

The parameter tree is the JAX package's: ``encoder`` and ``decoder``
stacks with a leading L axis, ``embed``, ``enc_norm``, ``final_norm`` and
an ``lm_head`` of its own.
"""
from __future__ import annotations

import torch

from ..kernels import shards
from . import attention as attn
from .layers import (cross_entropy_loss, embed, init_embedding, init_mlp,
                     init_rmsnorm, linear, mlp, rmsnorm, split, unembed)
from .transformer import _index, _init_stack, layer_call, pinner, unstack


def init_encdec(cfg, key, device="cuda") -> dict:
    """Parameters from a threefry key (the JAX package's exact numbers) or
    a ``torch.Generator``: ``split(key, 4)`` as (encoder, decoder, embed,
    head), an order of its own; an encoder layer splits its key in 2
    (attention, MLP), a decoder layer in 3 (self, cross, MLP)."""
    dtype = cfg.param_dtype

    def enc_layer(k):
        k1, k2 = split(k, 2)
        return {"ln1": init_rmsnorm(cfg.d_model, device, dtype),
                "attn": attn.init_attention(k1, cfg, device, dtype=dtype),
                "ln2": init_rmsnorm(cfg.d_model, device, dtype),
                "mlp": init_mlp(k2, cfg.d_model, cfg.d_ff, device,
                                gated=cfg.gated_mlp, dtype=dtype)}

    def dec_layer(k):
        k1, k2, k3 = split(k, 3)
        return {"ln1": init_rmsnorm(cfg.d_model, device, dtype),
                "attn": attn.init_attention(k1, cfg, device, dtype=dtype),
                "ln_x": init_rmsnorm(cfg.d_model, device, dtype),
                "xattn": attn.init_cross_attention(k2, cfg, device,
                                                   dtype=dtype),
                "ln2": init_rmsnorm(cfg.d_model, device, dtype),
                "mlp": init_mlp(k3, cfg.d_model, cfg.d_ff, device,
                                gated=cfg.gated_mlp, dtype=dtype)}

    k_enc, k_dec, k_emb, k_head = split(key, 4)
    return {
        "embed": init_embedding(k_emb, cfg.padded_vocab, cfg.d_model, device,
                                dtype),
        "encoder": _init_stack(k_enc, cfg.num_layers, enc_layer),
        "decoder": _init_stack(k_dec, cfg.num_layers, dec_layer),
        "enc_norm": init_rmsnorm(cfg.d_model, device, dtype),
        "final_norm": init_rmsnorm(cfg.d_model, device, dtype),
        "lm_head": init_embedding(k_head, cfg.padded_vocab, cfg.d_model,
                                  device, dtype),
    }


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device).expand(b, s)


def encode(cfg, params: dict, frames: torch.Tensor, *,
           attn_impl: str = "auto", remat: bool = False,
           act_sharding=None) -> torch.Tensor:
    """Bidirectional encoder over precomputed frame embeddings (B, S_enc,
    d) -> the normed encoder output (B, S_enc, d). ``remat``: each layer
    under a checkpoint; ``act_sharding`` pins the residual stream at every
    layer boundary (``transformer.pinner``)."""
    pin = pinner(act_sharding)
    with shards.replicate_constants(params, frames):
        x = pin(frames.to(cfg.compute_dtype))
        positions = _positions(x)

        def layer(p, h):
            h = pin(h)
            h = h + attn.attention_forward(
                p["attn"], rmsnorm(p["ln1"], h, cfg.norm_eps), positions,
                cfg, causal=False, impl=attn_impl)
            return pin(h + mlp(p["mlp"], rmsnorm(p["ln2"], h, cfg.norm_eps)))

        for p in unstack(params["encoder"], cfg.num_layers):
            x = layer_call(remat, layer, p, x)
        return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _cross_kv(cfg, p: dict, enc_out: torch.Tensor):
    """One decoder layer's cross K/V (B, S_enc, KV, hd) of the encoder
    output, unrotated."""
    b, s, _ = enc_out.shape
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    return (shards.split_heads(linear(p["wk"], enc_out), KV, hd),
            shards.split_heads(linear(p["wv"], enc_out), KV, hd))


def decode_train(cfg, params: dict, tokens: torch.Tensor,
                 enc_out: torch.Tensor, *, window: int | None = None,
                 attn_impl: str = "auto", remat: bool = False,
                 act_sharding=None) -> torch.Tensor:
    """Teacher-forced decoder forward: tokens (B, S_dec) over the encoder
    output -> logits (B, S_dec, padded_vocab). ``remat``: each layer under
    a checkpoint; ``act_sharding`` pins the residual stream at every layer
    boundary (``transformer.pinner``)."""
    pin = pinner(act_sharding)
    with shards.replicate_constants(params, tokens, enc_out):
        x = pin(embed(params["embed"], tokens, cfg.compute_dtype))
        positions = _positions(x)

        def layer(p, h):
            h = pin(h)
            h = h + attn.attention_forward(
                p["attn"], rmsnorm(p["ln1"], h, cfg.norm_eps), positions,
                cfg, causal=True, window=window, impl=attn_impl)
            h = h + attn.gqa_forward(
                p["xattn"], rmsnorm(p["ln_x"], h, cfg.norm_eps), positions,
                cfg, causal=False, impl=attn_impl,
                kv_override=_cross_kv(cfg, p["xattn"], enc_out))
            return pin(h + mlp(p["mlp"], rmsnorm(p["ln2"], h, cfg.norm_eps)))

        for p in unstack(params["decoder"], cfg.num_layers):
            x = layer_call(remat, layer, p, x)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return unembed(params["lm_head"], x)


def forward(cfg, params: dict, batch: dict, *, window: int | None = None,
            attn_impl: str = "auto", remat: bool = False,
            act_sharding=None) -> torch.Tensor:
    """``batch["encoder_frames"]`` and ``batch["tokens"]`` -> the decoder's
    logits (B, S_dec, padded_vocab)."""
    enc_out = encode(cfg, params, batch["encoder_frames"],
                     attn_impl=attn_impl, remat=remat,
                     act_sharding=act_sharding)
    return decode_train(cfg, params, batch["tokens"], enc_out,
                        window=window, attn_impl=attn_impl, remat=remat,
                        act_sharding=act_sharding)


def encdec_loss(cfg, params: dict, batch: dict, **kw) -> torch.Tensor:
    """Mean next-token cross-entropy of the decoder's logits (positions
    :-1 against ``batch["labels"]`` at 1:, the padded vocab masked)."""
    with shards.replicate_constants(params, batch):
        logits = forward(cfg, params, batch, **kw)
        return cross_entropy_loss(logits[:, :-1], batch["labels"][:, 1:],
                                  valid_vocab=cfg.vocab_size)


def init_decode_cache(cfg, batch: int, seq_len: int, *,
                      enc_len: int | None = None, windowed: bool = False,
                      dtype=None, device="cuda") -> dict:
    """Zeros: the stacked self-attention KV cache (capacity min(seq_len,
    window) when windowed, a ring buffer) and each layer's cross K/V
    ``cross_k``/``cross_v`` (L, B, enc_len, KV, hd); ``enc_len`` defaults
    to ``seq_len``."""
    dtype = dtype or cfg.compute_dtype
    cap = min(seq_len, cfg.sliding_window) if windowed else seq_len
    enc_len = enc_len if enc_len is not None else seq_len
    L, KV, hd = cfg.num_layers, cfg.n_kv_heads, cfg.head_dim
    one = attn.init_kv_cache(cfg, batch, cap, device, dtype)
    cross = (L, batch, enc_len, KV, hd)
    return {"layers": {k: torch.stack([v] * L) for k, v in one.items()},
            "cross_k": torch.zeros(cross, dtype=dtype, device=device),
            "cross_v": torch.zeros(cross, dtype=dtype, device=device)}


def prefill_cross_cache(cfg, params: dict, cache: dict,
                        enc_out: torch.Tensor) -> dict:
    """The cache with each decoder layer's cross K/V projected from the
    encoder output (once): a new dict whose ``cross_k``/``cross_v`` are
    (L, B, S_enc, KV, hd), the self-attention cache shared."""
    b, s, _ = enc_out.shape
    shape = (cfg.num_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
    ks = enc_out.new_empty(shape)
    vs = enc_out.new_empty(shape)
    for i in range(cfg.num_layers):
        ks[i], vs[i] = _cross_kv(cfg, _index(params["decoder"], i)["xattn"],
                                 enc_out)
    return {**cache, "cross_k": ks, "cross_v": vs}


def decode_step(cfg, params: dict, cache: dict, tokens: torch.Tensor,
                pos: int, *, windowed: bool = False
                ) -> tuple[torch.Tensor, dict]:
    """One-token decode: tokens (B, 1) at position ``pos`` -> (logits
    (B, 1, padded_vocab), the cache, its self-attention K/V updated in
    place)."""
    with shards.replicate_constants(params, cache, tokens):
        return _decode_step(cfg, params, cache, tokens, pos, windowed)


def _decode_step(cfg, params, cache, tokens, pos, windowed):
    x = embed(params["embed"], tokens, cfg.compute_dtype)
    b = x.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim
    for i in range(cfg.num_layers):
        p = _index(params["decoder"], i)
        a_out, _ = attn.attention_decode(
            p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps),
            _index(cache["layers"], i), pos, cfg, windowed=windowed)
        x = x + a_out
        # cross attention: one unrotated query over the cached encoder K/V
        q = linear(p["xattn"]["wq"],
                   rmsnorm(p["ln_x"], x, cfg.norm_eps))
        q = shards.split_heads(q, H, hd)
        out = attn.attend(q, cache["cross_k"][i], cache["cross_v"][i],
                          causal=False, impl="naive")
        x = x + linear(p["xattn"]["wo"], out.reshape(b, 1, H * hd))
        x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["lm_head"], x), cache
