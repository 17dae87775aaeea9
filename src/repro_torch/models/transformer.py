"""Decoder-only LM stack, dense / ssm / hybrid: init, forward (prefill) and
cached decode.

The port of the JAX package's ``models/transformer.py`` for those three
arch types. The parameter tree is the JAX package's: the layers are
stacked with a leading L axis (``params["layers"]["attn"]["wq"]["w"]`` is
(L, d, H·hd)), and the forward pass loops over them in Python where the
JAX package runs a ``lax.scan``.

Hybrid (Zamba2): stacked Mamba2 layers with ONE shared attention+MLP block
(weight sharing) applied after every segment of ``attn_every`` layers;
decode keeps one KV cache per segment call site (the weights are shared,
the caches are not).

``remat`` and ``act_sharding`` have no meaning in eager PyTorch and are
not taken; ``prefix_embeds`` (VLM) and MoE layers are not ported.
"""
from __future__ import annotations

import torch

from . import attention as attn
from . import ssm as ssm_lib
from .layers import (embed, init_embedding, init_mlp, init_rmsnorm, mlp,
                     rmsnorm, split, unembed)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _empty_stack(tree, n: int):
    if isinstance(tree, dict):
        return {k: _empty_stack(v, n) for k, v in tree.items()}
    return tree.new_empty((n,) + tuple(tree.shape))


def _set(stacked, i: int, tree) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _set(stacked[k], i, v)
    else:
        stacked[i] = tree


def _init_stack(key, n: int, init_one):
    """``n`` layers, one key each, into one tree with a leading axis,
    filled layer by layer (never two copies of the stack at once)."""
    out = None
    for i, k in enumerate(split(key, n)):
        one = init_one(k)
        if out is None:
            out = _empty_stack(one, n)
        _set(out, i, one)
    return out


def _init_attn_layer(cfg, device, dtype):
    def init_one(k):
        k1, k2 = split(k, 2)
        return {"ln1": init_rmsnorm(cfg.d_model, device, dtype),
                "attn": attn.init_attention(k1, cfg, device, dtype=dtype),
                "ln2": init_rmsnorm(cfg.d_model, device, dtype),
                "mlp": init_mlp(k2, cfg.d_model, cfg.d_ff, device,
                                gated=cfg.gated_mlp, dtype=dtype)}
    return init_one


def _init_mamba_layer(cfg, device, dtype):
    def init_one(k):
        return {"ln1": init_rmsnorm(cfg.d_model, device, dtype),
                "mamba": ssm_lib.init_mamba_block(k, cfg, device,
                                                  dtype=dtype)}
    return init_one


ARCH_TYPES = ("dense", "ssm", "hybrid")


def init_lm(cfg, key, device="cuda") -> dict:
    """Parameters of a dense, SSM or hybrid LM. ``key`` is a threefry key
    (``core.prng.PRNGKey``), which draws the JAX package's exact numbers,
    or a ``torch.Generator``."""
    if cfg.arch_type not in ARCH_TYPES:
        raise NotImplementedError(f"init_lm: arch_type {cfg.arch_type!r} "
                                  "is not ported yet (ROADMAP item 18)")
    dtype = cfg.param_dtype
    k_emb, k_layers, k_shared, k_head = split(key, 4)
    params: dict = {
        "embed": init_embedding(k_emb, cfg.padded_vocab, cfg.d_model, device,
                                dtype),
        "final_norm": init_rmsnorm(cfg.d_model, device, dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embedding(k_head, cfg.padded_vocab,
                                           cfg.d_model, device, dtype)
    if cfg.arch_type == "dense":
        params["layers"] = _init_stack(k_layers, cfg.num_layers,
                                       _init_attn_layer(cfg, device, dtype))
        return params
    params["layers"] = _init_stack(k_layers, cfg.num_layers,
                                   _init_mamba_layer(cfg, device, dtype))
    if cfg.arch_type == "hybrid":
        # ONE shared attention+MLP block, reused every attn_every layers
        params["shared_attn"] = _init_attn_layer(
            cfg.with_(arch_type="dense"), device, dtype)(k_shared)
    return params


def _attn_layer_fwd(cfg, p, x, positions, *, window, impl):
    h = x + attn.attention_forward(
        p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), positions, cfg,
        causal=True, window=window, impl=impl)
    return h + mlp(p["mlp"], rmsnorm(p["ln2"], h, cfg.norm_eps))


def _mamba_layer_fwd(cfg, p, x):
    out = ssm_lib.mamba_forward(p["mamba"],
                                rmsnorm(p["ln1"], x, cfg.norm_eps), cfg)
    return x + out.to(x.dtype)


def _segments(cfg) -> list[range]:
    """The hybrid's runs of Mamba2 layers, each followed by the shared
    attention block: ceil(L / attn_every) of them."""
    k = cfg.attn_every
    return [range(start, min(start + k, cfg.num_layers))
            for start in range(0, cfg.num_layers, k)]


def forward(cfg, params: dict, tokens: torch.Tensor, *,
            window: int | None = None, attn_impl: str = "auto"
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Token ids (B, S) -> (logits (B, S, padded_vocab), aux_loss = 0)."""
    x = embed(params["embed"], tokens, cfg.compute_dtype)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    if cfg.arch_type == "dense":
        for i in range(cfg.num_layers):
            x = _attn_layer_fwd(cfg, _index(params["layers"], i), x,
                                positions, window=window, impl=attn_impl)
    elif cfg.arch_type == "ssm":
        for i in range(cfg.num_layers):
            x = _mamba_layer_fwd(cfg, _index(params["layers"], i), x)
    elif cfg.arch_type == "hybrid":
        for seg in _segments(cfg):
            for i in seg:
                x = _mamba_layer_fwd(cfg, _index(params["layers"], i), x)
            x = _attn_layer_fwd(cfg, params["shared_attn"], x, positions,
                                window=window, impl=attn_impl)
    else:
        raise ValueError(cfg.arch_type)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params.get("lm_head", params["embed"])
    return unembed(head, x), torch.zeros((), device=x.device)


def init_decode_cache(cfg, batch: int, seq_len: int, *, windowed=False,
                      dtype=None, device="cuda") -> dict:
    """Stacked per-layer cache. Attention: a KV cache of capacity
    min(seq_len, window) when windowed (a ring buffer), else seq_len. SSM:
    the O(1) state. Hybrid: the SSM states plus one KV cache per segment
    (``shared_segments``)."""
    cap = min(seq_len, cfg.sliding_window) if windowed else seq_len

    def stack(one: dict, n: int) -> dict:
        return {k: torch.stack([v] * n) for k, v in one.items()}

    if cfg.arch_type == "dense":
        return {"layers": stack(attn.init_kv_cache(cfg, batch, cap, device,
                                                   dtype), cfg.num_layers)}
    if cfg.arch_type not in ("ssm", "hybrid"):
        raise ValueError(cfg.arch_type)
    cache = {"layers": stack(ssm_lib.init_ssm_state(cfg, batch, device,
                                                    dtype), cfg.num_layers)}
    if cfg.arch_type == "hybrid":
        cache["shared_segments"] = stack(
            attn.init_kv_cache(cfg, batch, cap, device, dtype),
            len(_segments(cfg)))
    return cache


def _attn_layer_decode(cfg, p, x, cache, pos, windowed):
    a_out, _ = attn.attention_decode(p["attn"],
                                     rmsnorm(p["ln1"], x, cfg.norm_eps),
                                     cache, pos, cfg, windowed=windowed)
    x = x + a_out
    return x + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps))


def _mamba_layer_decode(cfg, p, x, states: dict, i: int):
    """Layer i's recurrent step; its state in ``states`` (the stacked
    cache) is overwritten in place."""
    out, new = ssm_lib.mamba_decode(p["mamba"],
                                    rmsnorm(p["ln1"], x, cfg.norm_eps),
                                    _index(states, i), cfg)
    for k, v in new.items():
        states[k][i].copy_(v)
    return x + out


def decode_step(cfg, params: dict, cache: dict, tokens: torch.Tensor,
                pos: int, *, windowed: bool = False
                ) -> tuple[torch.Tensor, dict]:
    """One-token decode. tokens (B, 1); pos the current position. The
    cache is updated in place and returned."""
    x = embed(params["embed"], tokens, cfg.compute_dtype)
    if cfg.arch_type == "dense":
        for i in range(cfg.num_layers):
            x = _attn_layer_decode(cfg, _index(params["layers"], i), x,
                                   _index(cache["layers"], i), pos, windowed)
    elif cfg.arch_type == "ssm":
        for i in range(cfg.num_layers):
            x = _mamba_layer_decode(cfg, _index(params["layers"], i), x,
                                    cache["layers"], i)
    elif cfg.arch_type == "hybrid":
        for seg_i, seg in enumerate(_segments(cfg)):
            for i in seg:
                x = _mamba_layer_decode(cfg, _index(params["layers"], i), x,
                                        cache["layers"], i)
            x = _attn_layer_decode(cfg, params["shared_attn"], x,
                                   _index(cache["shared_segments"], seg_i),
                                   pos, windowed)
    else:
        raise ValueError(cfg.arch_type)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params.get("lm_head", params["embed"])
    return unembed(head, x), cache
