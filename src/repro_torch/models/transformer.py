"""Decoder-only transformer, dense branch: init, forward (prefill) and
KV-cache decode.

The port of the dense part of the JAX package's ``models/transformer.py``.
The parameter tree is the JAX package's: the layers are stacked with a
leading L axis (``params["layers"]["attn"]["wq"]["w"]`` is (L, d, H·hd)),
and the forward pass loops over them in Python where the JAX package runs
a ``lax.scan``. ``remat`` and ``act_sharding`` have no meaning in eager
PyTorch and are not taken; ``prefix_embeds`` (VLM) is not ported.
"""
from __future__ import annotations

import torch

from . import attention as attn
from .layers import (embed, init_embedding, init_mlp, init_rmsnorm, mlp,
                     rmsnorm, split, unembed)


def _stack(trees: list):
    """A list of equal trees -> one tree with a leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _init_stack(key, n: int, init_one):
    return _stack([init_one(k) for k in split(key, n)])


def _init_attn_layer(cfg, device, dtype):
    def init_one(k):
        k1, k2 = split(k, 2)
        return {"ln1": init_rmsnorm(cfg.d_model, device, dtype),
                "attn": attn.init_attention(k1, cfg, device, dtype=dtype),
                "ln2": init_rmsnorm(cfg.d_model, device, dtype),
                "mlp": init_mlp(k2, cfg.d_model, cfg.d_ff, device,
                                gated=cfg.gated_mlp, dtype=dtype)}
    return init_one


def init_lm(cfg, key, device="cuda") -> dict:
    """Parameters of a dense LM. ``key`` is a threefry key
    (``core.prng.PRNGKey``), which draws the JAX package's exact numbers,
    or a ``torch.Generator``."""
    if cfg.arch_type != "dense":
        raise NotImplementedError(f"init_lm: arch_type {cfg.arch_type!r} "
                                  "is not ported yet (ROADMAP item 18)")
    dtype = cfg.param_dtype
    k_emb, k_layers, _k_shared, k_head = split(key, 4)
    params: dict = {
        "embed": init_embedding(k_emb, cfg.padded_vocab, cfg.d_model, device,
                                dtype),
        "final_norm": init_rmsnorm(cfg.d_model, device, dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embedding(k_head, cfg.padded_vocab,
                                           cfg.d_model, device, dtype)
    params["layers"] = _init_stack(k_layers, cfg.num_layers,
                                   _init_attn_layer(cfg, device, dtype))
    return params


def _attn_layer_fwd(cfg, p, x, positions, *, window, impl):
    h = x + attn.attention_forward(
        p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), positions, cfg,
        causal=True, window=window, impl=impl)
    return h + mlp(p["mlp"], rmsnorm(p["ln2"], h, cfg.norm_eps))


def forward(cfg, params: dict, tokens: torch.Tensor, *,
            window: int | None = None, attn_impl: str = "auto"
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Token ids (B, S) -> (logits (B, S, padded_vocab), aux_loss = 0)."""
    x = embed(params["embed"], tokens, cfg.compute_dtype)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    for i in range(cfg.num_layers):
        x = _attn_layer_fwd(cfg, _index(params["layers"], i), x, positions,
                            window=window, impl=attn_impl)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params.get("lm_head", params["embed"])
    return unembed(head, x), torch.zeros((), device=x.device)


def init_decode_cache(cfg, batch: int, seq_len: int, *, windowed=False,
                      dtype=None, device="cuda") -> dict:
    """Stacked per-layer KV cache of capacity min(seq_len, window) when
    windowed (a ring buffer), else seq_len."""
    cap = min(seq_len, cfg.sliding_window) if windowed else seq_len
    one = attn.init_kv_cache(cfg, batch, cap, device, dtype)
    return {"layers": {k: torch.stack([v] * cfg.num_layers)
                       for k, v in one.items()}}


def decode_step(cfg, params: dict, cache: dict, tokens: torch.Tensor,
                pos: int, *, windowed: bool = False
                ) -> tuple[torch.Tensor, dict]:
    """One-token decode. tokens (B, 1); pos the current position. The
    cache is updated in place and returned."""
    x = embed(params["embed"], tokens, cfg.compute_dtype)
    for i in range(cfg.num_layers):
        lp = _index(params["layers"], i)
        a_out, _ = attn.attention_decode(
            lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps),
            _index(cache["layers"], i), pos, cfg, windowed=windowed)
        x = x + a_out
        x = x + mlp(lp["mlp"], rmsnorm(lp["ln2"], x, cfg.norm_eps))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params.get("lm_head", params["embed"])
    return unembed(head, x), cache
