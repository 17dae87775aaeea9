"""Decoder-only LM stack, dense / moe / ssm / hybrid / vlm: init, forward
(prefill) and cached decode.

The port of the JAX package's ``models/transformer.py``. The parameter
tree is the JAX package's: the layers are stacked with a leading L axis
(``params["layers"]["attn"]["wq"]["w"]`` is (L, d, H·hd)), and the
forward pass loops over them in Python where the JAX package runs a
``lax.scan``.

Hybrid (Zamba2): stacked Mamba2 layers with ONE shared attention+MLP block
(weight sharing) applied after every segment of ``attn_every`` layers;
decode keeps one KV cache per segment call site (the weights are shared,
the caches are not).

MoE (dbrx, deepseek-v2 with MLA attention): the attention layers with a
``moe`` block in place of the MLP; ``forward`` returns the load-balance
aux loss summed over the layers.

VLM (internvl2): the dense stack; ``forward(prefix_embeds=)`` puts the
precomputed ViT patch embeddings (stub frontend) in front of the token
embeddings, and the logits cover the text part only. Decode takes no
prefix, as in the JAX package.

``forward(remat=True)`` runs each layer (each Mamba2 layer of the hybrid,
whose shared attention block runs as it is, as in the JAX package) under
``torch.utils.checkpoint`` (non-reentrant): its activations are dropped
and recomputed in the backward, the same numbers as without remat.
The forward runs on DTensor params and batches too (the SPMD layout of
``launch.sharding``): plain constants (positions, masks, zeros) meet the
DTensors as replicated ones (``kernels.shards.replicate_constants``), and
the attention core and the SSD scan run shard by shard.
``act_sharding`` (a ``launch.sharding.NamedSharding``) pins the residual
stream at every layer boundary (:func:`pinner`), where the JAX package
calls ``with_sharding_constraint``. :func:`lm_loss` is the training loss
(next-token cross-entropy plus the MoE aux loss).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import shards
from . import attention as attn
from . import moe as moe_lib
from . import ssm as ssm_lib
from .layers import (cross_entropy_loss, embed, init_embedding, init_mlp,
                     init_rmsnorm, mlp, rmsnorm, split, unembed)


def pinner(act_sharding):
    """The layout constraint of the residual stream: ``h`` redistributed
    to ``act_sharding`` (a ``launch.sharding.NamedSharding``; its spec read
    on ``h``'s own mesh, where an axis that mesh lacks is dropped), where
    the JAX package calls ``with_sharding_constraint``; the identity
    without one. Redistribution moves shards and changes no number."""
    if act_sharding is None:
        return lambda h: h

    def pin(h):
        from ..launch.sharding import placements
        if not shards.is_dtensor(h):
            raise ValueError(
                "act_sharding pins a DTensor activation; lay the params "
                "and the batch out on the mesh first "
                "(launch.sharding.distribute)")
        return h.redistribute(h.device_mesh,
                              placements(act_sharding.spec, h.device_mesh))
    return pin


def layer_call(remat: bool, fn, *args):
    """``fn(*args)``, under a non-reentrant checkpoint when ``remat``."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree, each leaf a view from one
    ``unbind``: under autograd their gradients are stacked once, where
    ``_index`` per layer would add ``n`` full-size zero-padded gradients
    into each stacked leaf."""
    if isinstance(tree, dict):
        per = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


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
    filled layer by layer: the stack and one layer at a time (a layer is
    dropped before the next one is drawn)."""
    out = None
    for i, k in enumerate(split(key, n)):
        one = init_one(k)
        if out is None:
            out = _empty_stack(one, n)
        _set(out, i, one)
        del one
    return out


def _init_attn_layer(cfg, device, dtype):
    def init_one(k):
        k1, k2 = split(k, 2)
        p = {"ln1": init_rmsnorm(cfg.d_model, device, dtype),
             "attn": attn.init_attention(k1, cfg, device, dtype=dtype),
             "ln2": init_rmsnorm(cfg.d_model, device, dtype)}
        if cfg.arch_type == "moe":
            p["moe"] = moe_lib.init_moe(k2, cfg, device, dtype=dtype)
        else:
            p["mlp"] = init_mlp(k2, cfg.d_model, cfg.d_ff, device,
                                gated=cfg.gated_mlp, dtype=dtype)
        return p
    return init_one


def _init_mamba_layer(cfg, device, dtype):
    def init_one(k):
        return {"ln1": init_rmsnorm(cfg.d_model, device, dtype),
                "mamba": ssm_lib.init_mamba_block(k, cfg, device,
                                                  dtype=dtype)}
    return init_one


ARCH_TYPES = ("dense", "moe", "ssm", "hybrid", "vlm")
ATTN_TYPES = ("dense", "moe", "vlm")      # the attention-layer stacks


def init_lm(cfg, key, device="cuda") -> dict:
    """Parameters of a dense, MoE, SSM, hybrid or VLM LM. ``key`` is a
    threefry key (``core.prng.PRNGKey``), which draws the JAX package's
    exact numbers, or a ``torch.Generator``."""
    if cfg.arch_type not in ARCH_TYPES:
        raise ValueError(cfg.arch_type)
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
    if cfg.arch_type in ATTN_TYPES:
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
    """One attention layer -> (h, the MoE block's aux loss or 0)."""
    h = x + attn.attention_forward(
        p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), positions, cfg,
        causal=True, window=window, impl=impl)
    hn = rmsnorm(p["ln2"], h, cfg.norm_eps)
    if "moe" in p:
        y, aux = moe_lib.moe_forward(p["moe"], hn, cfg)
    else:
        y, aux = mlp(p["mlp"], hn), torch.zeros((), device=x.device)
    return h + y, aux


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
            prefix_embeds: torch.Tensor | None = None,
            window: int | None = None, attn_impl: str = "auto",
            remat: bool = False, act_sharding=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Token ids (B, S) (+ optional (B, P, d) prefix embeddings, cast to
    the compute dtype and put in front) -> (logits (B, S, padded_vocab)
    of the token positions only, aux_loss): the MoE layers' load-balance
    losses summed in f32 (0 for the others). ``remat``: each layer under a
    checkpoint. ``act_sharding``: the residual stream pinned at every
    layer boundary (:func:`pinner`)."""
    with shards.replicate_constants(params, tokens):
        return _forward(cfg, params, tokens, prefix_embeds, window,
                        attn_impl, remat, pinner(act_sharding))


def _forward(cfg, params, tokens, prefix_embeds, window, attn_impl, remat,
             pin):
    x = pin(embed(params["embed"], tokens, cfg.compute_dtype))
    n_prefix = 0
    if prefix_embeds is not None:
        n_prefix = prefix_embeds.shape[1]
        x = pin(torch.cat([prefix_embeds.to(x.dtype), x], dim=1))
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    aux = torch.zeros((), device=x.device)

    def attn_layer(p, h):
        h, a = _attn_layer_fwd(cfg, p, pin(h), positions, window=window,
                               impl=attn_impl)
        return pin(h), a

    def mamba_layer(p, h):
        return pin(_mamba_layer_fwd(cfg, p, pin(h)))

    layers = unstack(params["layers"], cfg.num_layers)
    if cfg.arch_type in ATTN_TYPES:
        for p in layers:
            x, a = layer_call(remat, attn_layer, p, x)
            aux = aux + a
    elif cfg.arch_type == "ssm":
        for p in layers:
            x = layer_call(remat, mamba_layer, p, x)
    elif cfg.arch_type == "hybrid":
        for seg in _segments(cfg):
            for i in seg:
                x = layer_call(remat, mamba_layer, layers[i], x)
            x, a = attn_layer(params["shared_attn"], x)
            aux = aux + a
    else:
        raise ValueError(cfg.arch_type)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if n_prefix:
        x = x[:, n_prefix:]
    head = params.get("lm_head", params["embed"])
    return unembed(head, x), aux


def lm_loss(cfg, params: dict, batch: dict, *, window=None,
            attn_impl: str = "auto", remat: bool = False,
            aux_weight: float = 0.01, act_sharding=None) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` (logits at
    positions :-1 against ``batch["labels"]`` at 1:, the padded vocab
    masked; a VLM's logits cover its text only) plus ``aux_weight`` times
    the MoE load-balance loss."""
    with shards.replicate_constants(params, batch):
        return _lm_loss(cfg, params, batch, window, attn_impl, remat,
                        aux_weight, act_sharding)


def _lm_loss(cfg, params, batch, window, attn_impl, remat, aux_weight,
             act_sharding):
    logits, aux = forward(cfg, params, batch["tokens"],
                          prefix_embeds=batch.get("vision_embeds"),
                          window=window, attn_impl=attn_impl, remat=remat,
                          act_sharding=act_sharding)
    loss = cross_entropy_loss(logits[:, :-1], batch["labels"][:, 1:],
                              valid_vocab=cfg.vocab_size)
    return loss + aux_weight * aux


def init_decode_cache(cfg, batch: int, seq_len: int, *, windowed=False,
                      dtype=None, device="cuda") -> dict:
    """Stacked per-layer cache. Attention: a KV cache of capacity
    min(seq_len, window) when windowed (a ring buffer), else seq_len. SSM:
    the O(1) state. Hybrid: the SSM states plus one KV cache per segment
    (``shared_segments``)."""
    cap = min(seq_len, cfg.sliding_window) if windowed else seq_len

    def stack(one: dict, n: int) -> dict:
        return {k: torch.stack([v] * n) for k, v in one.items()}

    if cfg.arch_type in ATTN_TYPES:
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
    hn = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if "moe" in p:
        return x + moe_lib.moe_forward(p["moe"], hn, cfg, decode=True)[0]
    return x + mlp(p["mlp"], hn)


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
    with shards.replicate_constants(params, cache, tokens):
        return _decode_step(cfg, params, cache, tokens, pos, windowed)


def _decode_step(cfg, params, cache, tokens, pos, windowed):
    x = embed(params["embed"], tokens, cfg.compute_dtype)
    if cfg.arch_type in ATTN_TYPES:
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
