"""GQA attention: the prefill/forward form, the KV cache and decode.

The port of the GQA part of the JAX package's ``models/attention.py``.
``attend`` runs two of its paths:
  * ``naive``  — materialised scores (small shapes, the oracle);
  * ``pallas`` — the flash-attention kernel (``kernels.flash_attention``:
    the CUDA kernel on the card, its plain version on the CPU).
``auto`` resolves as the JAX package resolves it; where it would pick
``blockwise`` or ``local`` it raises (ROADMAP item 18). MLA
(``kv_lora_rank > 0``) is not ported; ``models.factory.build`` refuses it.

Decode writes the new token's K/V into the cache tensors in place (the JAX
package returns a new cache); the returned cache is the same dict.
"""
from __future__ import annotations

import torch

from ..kernels import flash_attention as fa
from .layers import apply_rope, init_linear, linear, split, sqrt_f32

NEG_INF = -1e30


def init_attention(key, cfg, device, *, dtype=None) -> dict:
    """GQA attention params (the draws of the JAX package's
    ``init_attention``: ``split(key, 8)``, the first four used)."""
    dtype = dtype or cfg.param_dtype
    if cfg.kv_lora_rank:
        raise NotImplementedError("MLA attention is not ported yet "
                                  "(ROADMAP item 18)")
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ks = split(key, 8)
    return {
        "wq": init_linear(ks[0], d, H * hd, device, bias=cfg.qkv_bias,
                          dtype=dtype),
        "wk": init_linear(ks[1], d, KV * hd, device, bias=cfg.qkv_bias,
                          dtype=dtype),
        "wv": init_linear(ks[2], d, KV * hd, device, bias=cfg.qkv_bias,
                          dtype=dtype),
        "wo": init_linear(ks[3], H * hd, d, device, dtype=dtype),
    }


def _group_heads(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B,S,H,D) -> (B,S,KV,G,D) for GQA."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def naive_attention(q, k, v, *, causal: bool, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Materialised-scores attention, model layout (B, S, H, D)."""
    b, sq, h, d = q.shape
    kv, dv = k.shape[2], v.shape[-1]
    qg = _group_heads(q, kv)                                   # B,Sq,KV,G,D
    scale = 1.0 / sqrt_f32(d, q.device)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones(sq, k.shape[1], dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, dv).to(q.dtype)


def attend(q, k, v, *, causal=True, window=None, impl="auto",
           block_q=512, block_k=512):
    """Dispatch: 'naive' | 'pallas' | 'auto' (the JAX package's rule)."""
    if impl == "auto":
        s = max(q.shape[1], k.shape[1])
        if window is not None and q.shape[1] == k.shape[1] \
                and window < q.shape[1] and q.shape[1] % block_q == 0:
            impl = "local"
        elif s > 2048 and q.shape[1] % block_q == 0 \
                and k.shape[1] % block_k == 0:
            impl = "blockwise"
        else:
            impl = "naive"
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window)
    if impl == "pallas":
        return fa.flash_attention(q, k, v, causal=causal, window=window)
    if impl in ("blockwise", "local"):
        raise NotImplementedError(
            f"attend(impl={impl!r}) is not ported yet (ROADMAP item 18); "
            "pass attn_impl='pallas' or 'naive'")
    raise ValueError(impl)


def gqa_forward(p: dict, x, positions, cfg, *, causal=True, window=None,
                impl="auto") -> torch.Tensor:
    """Standard GQA attention layer (prefill/forward form)."""
    b, s, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = linear(p["wq"], x).reshape(b, s, H, hd)
    k = linear(p["wk"], x).reshape(b, s, KV, hd)
    v = linear(p["wv"], x).reshape(b, s, KV, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = attend(q, k, v, causal=causal, window=window, impl=impl)
    return linear(p["wo"], out.reshape(b, s, H * hd))


def attention_forward(p, x, positions, cfg, **kw):
    if cfg.kv_lora_rank:
        raise NotImplementedError("MLA attention is not ported yet "
                                  "(ROADMAP item 18)")
    return gqa_forward(p, x, positions, cfg, **kw)


def init_kv_cache(cfg, batch: int, max_len: int, device,
                  dtype=None) -> dict:
    """Per-layer GQA cache: K/V of (B, max_len, KV, hd), zeros."""
    dtype = dtype or cfg.compute_dtype
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_decode(p: dict, x, cache: dict, pos: int, cfg, *,
               windowed: bool = False) -> tuple[torch.Tensor, dict]:
    """One-token decode. x (B,1,d); cache K/V (B,C,KV,hd); pos an int.

    If windowed, the cache is a ring buffer of size C=window: slot =
    pos % C, and entries older than pos−window are masked out. The write
    start is clamped to [0, C−1] as ``dynamic_update_slice`` clamps it.
    """
    b = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = int(pos)
    cap = cache["k"].shape[1]
    q = linear(p["wq"], x).reshape(b, 1, H, hd)
    k = linear(p["wk"], x).reshape(b, 1, KV, hd)
    v = linear(p["wv"], x).reshape(b, 1, KV, hd)
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    slot = pos % cap if windowed else pos
    start = min(max(slot, 0), cap - 1)
    cache["k"][:, start] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, start] = v[:, 0].to(cache["v"].dtype)
    kc, vc = cache["k"], cache["v"]
    qg = _group_heads(q, KV)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), kc.float()) \
        / sqrt_f32(hd, x.device)
    idx = torch.arange(cap, device=x.device)
    if windowed:
        # slot i holds absolute position: reconstructed from the ring layout
        abs_pos = torch.where(idx <= slot, pos - (slot - idx),
                              pos - (slot + cap - idx))
        valid = (abs_pos >= 0) & (abs_pos > pos - cap)
    else:
        valid = idx <= pos
    s = torch.where(valid, s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", pr, vc.float())
    out = out.reshape(b, 1, H * hd).to(x.dtype)
    return linear(p["wo"], out), cache


def attention_decode(p, x, cache, pos, cfg, *, windowed=False):
    if cfg.kv_lora_rank:
        raise NotImplementedError("MLA decode is not ported yet "
                                  "(ROADMAP item 18)")
    return gqa_decode(p, x, cache, pos, cfg, windowed=windowed)
