"""Mixture-of-Experts: top-k router + shared experts + expert FFNs.

The port of the JAX package's ``models/moe.py``. Two forms:
  * ``dispatch`` (prefill): sort-based capacity dispatch — each (token,
    slot) pair is ranked within its expert, the kept ones are scattered
    into an (E, cap, d) buffer, the expert FFNs run as batched products
    (``torch.bmm``), and the outputs are gathered back weighted by the
    gate. Pairs past an expert's capacity drop.
  * ``dense`` (decode): all experts for the few tokens, combined with the
    gate mask; it reads every expert's weights once a step.

The aux load-balance loss is Switch/GShard's: E · Σ_e f_e · p_e. The router
is f32. Top-k seats ties at the lower expert index, as ``jax.lax.top_k``
does, through a stable descending sort. Neither form reaches a kernel of
the port: the JAX package computes them outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import shards
from .layers import he_init, init_mlp, mlp, split


def init_moe(key, cfg, device, *, dtype=None) -> dict:
    """The JAX package's draws: ``split(key, 5)``; the (E, d, ff) stacks
    through ``he_init``, whose fan-in is the leading axis, E."""
    dtype = dtype or cfg.param_dtype
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    ks = split(key, 5)
    p = {
        "router": {"w": he_init(ks[0], (d, E), device)},         # f32 router
        "w_gate": he_init(ks[1], (E, d, ff), device, dtype),
        "w_up": he_init(ks[2], (E, d, ff), device, dtype),
        "w_down": he_init(ks[3], (E, ff, d), device, dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(ks[4], d, ff * cfg.n_shared_experts, device,
                               gated=True, dtype=dtype)
    return p


def router_probs(p: dict, x: torch.Tensor) -> torch.Tensor:
    """(N, d) -> (N, E) softmax router probabilities (f32)."""
    return torch.softmax(x.float() @ p["router"]["w"], dim=-1)


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, descending, ties
    at the lower index first (a stable sort; ``torch.topk`` leaves the
    order of ties unspecified)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def load_balance_loss(probs: torch.Tensor, expert_idx: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch aux loss: E · Σ_e (share of slots to e)·(mean prob of e)."""
    me = probs.mean(dim=0)                                       # (E,)
    flat = expert_idx.reshape(-1)
    # out of place: a DTensor ``flat`` cannot scatter into a plain buffer
    counts = torch.zeros(n_experts, device=probs.device).index_add(
        0, flat, torch.ones(flat.shape, device=probs.device))
    ce = counts / counts.sum().clamp(min=1.0)
    return n_experts * (me * ce).sum()


def _route(p: dict, xf: torch.Tensor, cfg):
    probs = router_probs(p, xf)                                  # (N, E)
    gate, expert_idx = top_k(probs, cfg.top_k)                   # (N, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    return gate, expert_idx, load_balance_loss(probs, expert_idx,
                                               cfg.n_experts)


def capacity(n: int, cfg) -> int:
    """Slots per expert for ``n`` tokens (Python float arithmetic, as the
    JAX package computes it)."""
    return max(1, int(n * cfg.top_k / cfg.n_experts * cfg.capacity_factor))


def dispatch_ranks(expert_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each flattened (token, slot) pair's rank within its expert: the
    exclusive int32 cumsum of the one-hot, in (token, slot) order."""
    onehot = F.one_hot(expert_idx.reshape(-1), n_experts).to(torch.int32)
    pos_in_e = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    return (pos_in_e * onehot).sum(-1, dtype=torch.int32)


def moe_dispatch(p: dict, x: torch.Tensor, cfg
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort-based capacity MoE. x (..., d) -> (same shape, aux_loss)."""
    d, E, k = cfg.d_model, cfg.n_experts, cfg.top_k
    xf = x.reshape(-1, d)
    n = xf.shape[0]
    cap = capacity(n, cfg)
    gate, expert_idx, aux = _route(p, xf, cfg)

    flat_e = expert_idx.reshape(-1)                              # (N*k,)
    flat_t = torch.arange(n, device=x.device).repeat_interleave(k)
    rank = dispatch_ranks(expert_idx, E)
    keep = rank < cap
    slot = flat_e * cap + torch.where(keep, rank, 0)             # (N*k,)

    # a dropped pair adds zeros to its expert's slot 0
    src = torch.where(keep[:, None], xf[flat_t], 0)
    buf = torch.zeros(E * cap, d, dtype=xf.dtype, device=x.device)
    buf = buf.index_add_(0, slot, src).reshape(E, cap, d)

    g = torch.bmm(buf, p["w_gate"].to(buf.dtype))
    u = torch.bmm(buf, p["w_up"].to(buf.dtype))
    out_buf = torch.bmm(F.silu(g) * u, p["w_down"].to(buf.dtype))

    out_flat = out_buf.reshape(E * cap, d)[slot] \
        * (gate.reshape(-1) * keep)[:, None]
    # the f32 gate promotes the product; the scatter adds in x's dtype, as
    # the JAX package's ``.at[].add`` casts its updates
    out = torch.zeros_like(xf).index_add_(0, flat_t, out_flat.to(xf.dtype))
    if cfg.n_shared_experts:
        out = out + mlp(p["shared"], xf)
    return out.reshape(x.shape), aux


def moe_dense(p: dict, x: torch.Tensor, cfg
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode-form MoE: all experts for the (few) tokens, masked combine.
    Each product broadcasts the tokens over the contiguous (E, d, ff)
    stack, so no copy of the weights is made."""
    d, E = cfg.d_model, cfg.n_experts
    xf = x.reshape(-1, d)
    gate, expert_idx, aux = _route(p, xf, cfg)
    combine = (F.one_hot(expert_idx, E) * gate[..., None]).sum(1)  # (N, E)
    g = torch.matmul(xf[None], p["w_gate"].to(xf.dtype))        # (E, N, ff)
    u = torch.matmul(xf[None], p["w_up"].to(xf.dtype))
    y = torch.matmul(F.silu(g) * u, p["w_down"].to(xf.dtype))   # (E, N, d)
    out = torch.einsum("end,ne->nd", y.float(), combine).to(xf.dtype)
    if cfg.n_shared_experts:
        out = out + mlp(p["shared"], xf)
    return out.reshape(x.shape), aux


def moe_forward(p: dict, x: torch.Tensor, cfg, *, decode: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense form for decode or fewer than 4·E tokens, else dispatch.
    On DTensors the dense form runs; the dispatch raises: its scatter and
    combine (``aten.index_add_``) address the global token ids, which a
    token-sharded batch splits over the ranks (ROADMAP item 19.5)."""
    n_tokens = x.numel() // cfg.d_model
    if decode or n_tokens < 4 * cfg.n_experts:
        return moe_dense(p, x, cfg)
    if shards.is_dtensor(x):
        raise NotImplementedError(
            "moe_dispatch on DTensors: aten.index_add_ (the capacity "
            "dispatch's scatter into the (E·cap, d) buffer and its combine) "
            "addresses global token ids that a token-sharded batch splits "
            "over the ranks; not ported to DTensors (ROADMAP item 19.5)")
    return moe_dispatch(p, x, cfg)
