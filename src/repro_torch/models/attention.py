"""GQA and MLA attention: the prefill/forward form, cross attention, the KV
cache and decode.

The port of the JAX package's ``models/attention.py``. MLA (DeepSeek-V2,
``kv_lora_rank > 0``) prefills in the explicit form (q/k of head dim
hd + dr, v of hd) and decodes in the absorbed form over the compressed
(c, k_rope) cache. Cross attention (the enc-dec decoder) is a GQA layer
whose K/V come from the encoder (``gqa_forward(kv_override=)``; q is not
rotated). ``attend`` runs four paths:
  * ``naive``     — materialised scores (small shapes, the oracle);
  * ``blockwise`` — the online-softmax loop over (q-block, kv-block) tiles
    in plain PyTorch (the JAX package's XLA fallback for long sequences);
  * ``local``     — sliding-window causal attention: each q block attends
    to the window's kv blocks only;
  * ``pallas``    — the flash-attention kernel (``kernels.flash_attention``:
    the CUDA kernel on the card, its plain version on the CPU).
``auto`` resolves among the first three as the JAX package does.

Decode writes the new token's K/V (MLA: c and k_rope) into the cache
tensors in place (the JAX package returns a new cache); the returned cache
is the same dict.
"""
from __future__ import annotations

import functools

import torch

from ..kernels import flash_attention as fa
from ..kernels import shards
from .layers import (apply_rope, init_linear, init_rmsnorm, linear,
                     rmsnorm, split, sqrt_f32)

NEG_INF = -1e30


def init_attention(key, cfg, device, *, dtype=None) -> dict:
    """GQA (or MLA if ``cfg.kv_lora_rank > 0``) attention params, the
    draws of the JAX package's ``init_attention``: ``split(key, 8)``, the
    first four used (MLA: six)."""
    dtype = dtype or cfg.param_dtype
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ks = split(key, 8)
    if cfg.kv_lora_rank:
        r, dr = cfg.kv_lora_rank, cfg.rope_head_dim
        return {
            "wq": init_linear(ks[0], d, H * (hd + dr), device, dtype=dtype),
            "w_dkv": init_linear(ks[1], d, r, device, dtype=dtype),
            "w_kr": init_linear(ks[2], d, dr, device, dtype=dtype),
            "kv_norm": init_rmsnorm(r, device, dtype),
            "w_uk": init_linear(ks[3], r, H * hd, device, dtype=dtype),
            "w_uv": init_linear(ks[4], r, H * hd, device, dtype=dtype),
            "wo": init_linear(ks[5], H * hd, d, device, dtype=dtype),
        }
    return {
        "wq": init_linear(ks[0], d, H * hd, device, bias=cfg.qkv_bias,
                          dtype=dtype),
        "wk": init_linear(ks[1], d, KV * hd, device, bias=cfg.qkv_bias,
                          dtype=dtype),
        "wv": init_linear(ks[2], d, KV * hd, device, bias=cfg.qkv_bias,
                          dtype=dtype),
        "wo": init_linear(ks[3], H * hd, d, device, dtype=dtype),
    }


def init_cross_attention(key, cfg, device, *, dtype=None) -> dict:
    """Cross-attention params: GQA's (``kv_lora_rank`` forced to 0)."""
    return init_attention(key, cfg.with_(kv_lora_rank=0), device,
                          dtype=dtype)


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


def blockwise_attention(q, k, v, *, causal: bool,
                        window: int | None = None, block_q: int = 512,
                        block_k: int = 512) -> torch.Tensor:
    """Online-softmax tiled attention (the flash-attention algorithm in
    plain PyTorch), model layout. The blocks are clamped to the lengths,
    which they must then divide. Every kv tile is computed and then masked
    (no tile is skipped), as in the JAX package's XLA fallback."""
    b, sq, h, d = q.shape
    sk, kvh, dv = k.shape[1], k.shape[2], v.shape[-1]
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    if sq % block_q or sk % block_k:
        raise ValueError(f"blockwise_attention: Sq={sq}, Sk={sk} must be "
                         f"multiples of block_q={block_q}, "
                         f"block_k={block_k}")
    g, dev = h // kvh, q.device
    scale = 1.0 / sqrt_f32(d, dev)
    kf, vf = k.float(), v.float()
    outs = []
    for q0 in range(0, sq, block_q):
        qblk = _group_heads(q[:, q0:q0 + block_q], kvh).float()
        qpos = q0 + torch.arange(block_q, device=dev)
        m = torch.full((b, kvh, g, block_q), NEG_INF, device=dev)
        l = torch.zeros(b, kvh, g, block_q, device=dev)
        acc = torch.zeros(b, kvh, g, block_q, dv, device=dev)
        for k0 in range(0, sk, block_k):
            kpos = k0 + torch.arange(block_k, device=dev)
            s = torch.einsum("bqkgd,bskd->bkgqs", qblk,
                             kf[:, k0:k0 + block_k]) * scale
            mask = torch.ones(block_q, block_k, dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window is not None:
                mask &= kpos[None, :] > qpos[:, None] - window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, vf[:, k0:k0 + block_k])
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]      # B,KV,G,bq,Dv
        outs.append(torch.einsum("bkgqd->bqkgd", out))
    return torch.cat(outs, dim=1).reshape(b, sq, h, dv).to(q.dtype)


def local_attention(q, k, v, *, window: int, block: int = 512
                    ) -> torch.Tensor:
    """Sliding-window causal attention, sub-quadratic: q block i attends to
    the gathered kv blocks [i − ⌈window / block⌉, i] (ids below 0 clamped
    to block 0 and masked). Needs Sq = Sk, a multiple of ``block``."""
    b, sq, h, d = q.shape
    sk, kvh, dv = k.shape[1], k.shape[2], v.shape[-1]
    if sq != sk or sq % block:
        raise ValueError(f"local_attention: Sq={sq}, Sk={sk} must be equal "
                         f"and multiples of block={block}")
    nblk, dev = sq // block, q.device
    wblk = max(1, -(-window // block))                          # ceil
    kb = k.float().reshape(b, nblk, block, kvh, d)
    vb = v.float().reshape(b, nblk, block, kvh, dv)
    scale = 1.0 / sqrt_f32(d, dev)
    ar = torch.arange(block, device=dev)
    outs = []
    for qi in range(nblk):
        qblk = _group_heads(q[:, qi * block:(qi + 1) * block], kvh).float()
        offs = qi - torch.arange(wblk, -1, -1, device=dev)      # wblk+1 ids
        offs_c = offs.clamp(0, nblk - 1)
        kw = kb[:, offs_c].reshape(b, (wblk + 1) * block, kvh, d)
        vw = vb[:, offs_c].reshape(b, (wblk + 1) * block, kvh, dv)
        qpos = qi * block + ar
        kpos = (offs_c[:, None] * block + ar[None, :]).reshape(-1)
        valid = (offs >= 0)[:, None].expand(-1, block).reshape(-1)
        s = torch.einsum("bqkgd,bskd->bkgqs", qblk, kw) * scale
        mask = (kpos[None, :] <= qpos[:, None]) \
            & (kpos[None, :] > qpos[:, None] - window) & valid[None, :]
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bkgqs,bskd->bqkgd", p, vw))
    return torch.cat(outs, dim=1).reshape(b, sq, h, dv).to(q.dtype)


def attend(q, k, v, *, causal=True, window=None, impl="auto",
           block_q=512, block_k=512):
    """Dispatch: 'naive' | 'blockwise' | 'local' | 'pallas' | 'auto' (the
    JAX package's rule: ``local`` for a window shorter than Sq = Sk, a
    multiple of ``block_q``; else ``blockwise`` past 2048 tokens when both
    lengths are multiples of the blocks; else ``naive``). DTensor operands
    are attended shard by shard over the batch and the heads
    (``kernels.shards.attention``), as SPMD partitions the attention."""
    if shards.is_dtensor(q):
        return shards.attention("attend", functools.partial(
            attend, causal=causal, window=window, impl=impl,
            block_q=block_q, block_k=block_k), shards.settle(q, (0, 2)),
            k, v)
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
    if impl == "blockwise":
        return blockwise_attention(q, k, v, causal=causal, window=window,
                                   block_q=block_q, block_k=block_k)
    if impl == "local":
        return local_attention(q, k, v, window=window, block=block_q)
    if impl == "pallas":
        return fa.flash_attention(q, k, v, causal=causal, window=window)
    raise ValueError(impl)


def gqa_forward(p: dict, x, positions, cfg, *, causal=True, window=None,
                impl="auto", kv_override=None) -> torch.Tensor:
    """Standard GQA attention layer (prefill/forward form). ``kv_override``
    = (k, v) of (B, Sk, KV, hd) makes it cross attention: those K/V are
    used as they are, and q is not rotated (as in the JAX package)."""
    b, s, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = shards.split_heads(linear(p["wq"], x), H, hd)
    if kv_override is None:
        k = shards.split_heads(linear(p["wk"], x), KV, hd)
        v = shards.split_heads(linear(p["wv"], x), KV, hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    else:
        k, v = kv_override
    out = attend(q, k, v, causal=causal, window=window, impl=impl)
    return linear(p["wo"], shards.merge_heads(out))


def mla_forward(p: dict, x, positions, cfg, *, causal=True, window=None,
                impl="auto") -> torch.Tensor:
    """MLA, the explicit (non-absorbed) form for prefill: q/k of head dim
    hd + dr (the rope part of k one head, broadcast), v of hd."""
    b, s, _ = x.shape
    H, hd, dr = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    q = shards.split_heads(linear(p["wq"], x), H, hd + dr)
    qn, qr = q[..., :hd], apply_rope(q[..., hd:], positions, cfg.rope_theta)
    c = rmsnorm(p["kv_norm"], linear(p["w_dkv"], x))             # (B,S,r)
    kr = apply_rope(shards.split_heads(linear(p["w_kr"], x), 1, dr),
                    positions, cfg.rope_theta)                   # one head
    kn = shards.split_heads(linear(p["w_uk"], c), H, hd)
    v = shards.split_heads(linear(p["w_uv"], c), H, hd)
    qf = torch.cat([qn, qr], dim=-1)
    kf = torch.cat([kn, kr.expand(b, s, H, dr)], dim=-1)
    out = attend(qf, kf, v, causal=causal, window=window, impl=impl)
    return linear(p["wo"], shards.merge_heads(out))


def attention_forward(p, x, positions, cfg, **kw):
    if cfg.kv_lora_rank:
        return mla_forward(p, x, positions, cfg, **kw)
    return gqa_forward(p, x, positions, cfg, **kw)


def init_kv_cache(cfg, batch: int, max_len: int, device,
                  dtype=None) -> dict:
    """Per-layer cache, zeros. GQA: K/V of (B, max_len, KV, hd). MLA: the
    compressed c (B, max_len, r) and k_rope (B, max_len, dr)."""
    dtype = dtype or cfg.compute_dtype
    if cfg.kv_lora_rank:
        return {"c": torch.zeros(batch, max_len, cfg.kv_lora_rank,
                                 dtype=dtype, device=device),
                "kr": torch.zeros(batch, max_len, cfg.rope_head_dim,
                                  dtype=dtype, device=device)}
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
    q = shards.split_heads(linear(p["wq"], x), H, hd)
    k = shards.split_heads(linear(p["wk"], x), KV, hd)
    v = shards.split_heads(linear(p["wv"], x), KV, hd)
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    slot = pos % cap if windowed else pos
    start = min(max(slot, 0), cap - 1)
    cache["k"][:, start] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, start] = v[:, 0].to(cache["v"].dtype)
    core = functools.partial(
        _decode_core, valid=_valid_slots(cap, slot, pos, windowed, x.device))
    if shards.is_dtensor(q):
        out = shards.attention("gqa_decode", core, shards.settle(q, (0, 2)),
                               cache["k"], cache["v"])
    else:
        out = core(q, cache["k"], cache["v"])
    out = out.reshape(b, 1, H * hd).to(x.dtype)
    return linear(p["wo"], out), cache


def _decode_core(q, kc, vc, *, valid):
    """One query token (B, 1, H, hd) over the cache (B, C, KV, hd): f32
    scores over √hd, the slots outside ``valid`` masked, softmax, the
    values' f32 average, (B, 1, H, hd). DTensor operands run it shard by
    shard over the batch and the heads (``kernels.shards.attention``)."""
    b, _, h, hd = q.shape
    qg = _group_heads(q, kc.shape[2])
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), kc.float()) \
        / sqrt_f32(hd, q.device)
    pr = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", pr, vc.float()).reshape(
        b, 1, h, hd)


def _valid_slots(cap: int, slot: int, pos: int, windowed: bool, device):
    """(cap,) mask of the cache slots that hold a position the new token at
    ``pos`` attends to."""
    idx = torch.arange(cap, device=device)
    if windowed:
        # slot i holds absolute position: reconstructed from the ring layout
        abs_pos = torch.where(idx <= slot, pos - (slot - idx),
                              pos - (slot + cap - idx))
        return (abs_pos >= 0) & (abs_pos > pos - cap)
    return idx <= pos


def mla_decode(p: dict, x, cache: dict, pos: int, cfg, *,
               windowed: bool = False) -> tuple[torch.Tensor, dict]:
    """Absorbed MLA decode: scores and output in the r-dim latent space, so
    the per-token cache is only r + dr floats. x (B,1,d); cache c (B,C,r),
    kr (B,C,dr); the ring buffer and the write clamp as in
    :func:`gqa_decode`."""
    b = x.shape[0]
    H, hd, dr = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    r = cfg.kv_lora_rank
    pos = int(pos)
    cap = cache["c"].shape[1]
    q = shards.split_heads(linear(p["wq"], x), H, hd + dr)
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    qn, qr = q[..., :hd], apply_rope(q[..., hd:], posv, cfg.rope_theta)
    c_new = rmsnorm(p["kv_norm"], linear(p["w_dkv"], x))         # (B,1,r)
    kr_new = apply_rope(shards.split_heads(linear(p["w_kr"], x), 1, dr), posv,
                        cfg.rope_theta).reshape(b, 1, dr)
    slot = pos % cap if windowed else pos
    start = min(max(slot, 0), cap - 1)
    cache["c"][:, start] = c_new[:, 0].to(cache["c"].dtype)
    cache["kr"][:, start] = kr_new[:, 0].to(cache["kr"].dtype)
    cc, krc = cache["c"].float(), cache["kr"].float()
    # absorb W_uk into q: q_lat (B,1,H,r)
    wuk = p["w_uk"]["w"].reshape(r, H, hd).float()
    q_lat = torch.einsum("bqhd,rhd->bqhr", qn.float(), wuk)
    s = (torch.einsum("bqhr,bsr->bhqs", q_lat, cc)
         + torch.einsum("bqhd,bsd->bhqs", qr.float(), krc)) \
        / sqrt_f32(hd + dr, x.device)
    s = torch.where(_valid_slots(cap, slot, pos, windowed, x.device), s,
                    NEG_INF)
    pr = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhqs,bsr->bqhr", pr, cc)                 # latent
    wuv = p["w_uv"]["w"].reshape(r, H, hd).float()
    out = torch.einsum("bqhr,rhd->bqhd", ctx, wuv)
    out = out.reshape(b, 1, H * hd).to(x.dtype)
    return linear(p["wo"], out), cache


def attention_decode(p, x, cache, pos, cfg, *, windowed=False):
    if cfg.kv_lora_rank:
        return mla_decode(p, x, cache, pos, cfg, windowed=windowed)
    return gqa_decode(p, x, cache, pos, cfg, windowed=windowed)
