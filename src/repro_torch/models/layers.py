"""Shared LM building blocks (functional, params = nested dicts of tensors).

The port of the JAX package's ``models/layers.py``, with its layouts:
linear weights are (in, out), the embedding table is (vocab, d). The GEMMs
stay ``torch.matmul`` (strict f32: the entry points turn TF32 off).

Parity notes: ``jax.nn.gelu`` is the tanh form, so the non-gated MLP uses
``F.gelu(approximate="tanh")``; RoPE rotates the two halves of the last
axis (not interleaved pairs), with angles ``positions · freqs`` in f32.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core import prng
from ..kernels import shards


def normal(key, shape: tuple, device) -> torch.Tensor:
    """A standard normal draw of ``shape`` on ``device``: ``key`` is a
    threefry key (``core.prng.PRNGKey``; the JAX package's exact numbers)
    or a ``torch.Generator`` (drawn on the generator's device). On the
    meta device it draws nothing: an empty meta tensor of ``shape`` (the
    dry run's parameters, shapes without data)."""
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), device="meta")
    if isinstance(key, torch.Generator):
        return torch.randn(shape, generator=key,
                           device=key.device).to(device)
    return prng.normal_t(np.asarray(key, np.uint32), tuple(shape), device)


def split(key, num: int) -> list:
    """``jax.random.split`` of a threefry key; a ``torch.Generator`` is its
    own stream and is handed on ``num`` times."""
    if isinstance(key, torch.Generator):
        return [key] * num
    return list(prng.split(np.asarray(key, np.uint32), num))


def sqrt_f32(n: int, device) -> torch.Tensor:
    """√n in f32 as a 0-d tensor on ``device`` (``jnp.sqrt`` of an int),
    filled there: ``torch.tensor(n, device=cuda)`` would copy from the host
    and synchronise the stream at every call."""
    return torch.full((), float(n), device=device).sqrt()


def he_init(key, shape: tuple, device, dtype=torch.float32) -> torch.Tensor:
    """Normal / √fan_in, fan_in the leading axis (E for an (E, d, ff)
    expert stack, as in the JAX package); divided in place, so a draw of
    5 GB (one deepseek-v2-236b expert matrix) needs no second 5 GB."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    return normal(key, shape, device).div_(sqrt_f32(fan_in, device)).to(dtype)


def init_linear(key, d_in: int, d_out: int, device, *, bias: bool = False,
                dtype=torch.float32) -> dict:
    p = {"w": he_init(key, (d_in, d_out), device, dtype)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=device)
    return p


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def init_rmsnorm(d: int, device, dtype=torch.float32) -> dict:
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * p["scale"].to(dt)


def init_mlp(key, d_model: int, d_ff: int, device, *, gated: bool = True,
             dtype=torch.float32) -> dict:
    k1, k2, k3 = split(key, 3)
    p = {"up": init_linear(k1, d_model, d_ff, device, dtype=dtype),
         "down": init_linear(k2, d_ff, d_model, device, dtype=dtype)}
    if gated:
        p["gate"] = init_linear(k3, d_model, d_ff, device, dtype=dtype)
    return p


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    if "gate" in p:  # SwiGLU
        return linear(p["down"],
                      F.silu(linear(p["gate"], x)) * linear(p["up"], x))
    return linear(p["down"], F.gelu(linear(p["up"], x), approximate="tanh"))


def rope_frequencies(d: int, theta: float = 1e4, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=device) / d))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D) or (..., S, D); positions
    (..., S)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)                # (D/2,)
    angles = positions[..., None].float() * freqs               # (..., S, D/2)
    if x.dim() == angles.dim() + 1:                             # head axis
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def init_embedding(key, vocab: int, d: int, device,
                   dtype=torch.float32) -> dict:
    return {"table": (normal(key, (vocab, d), device) * 0.02).to(dtype)}


def embed(p: dict, tokens: torch.Tensor, dtype=None) -> torch.Tensor:
    """The table's rows at ``tokens``. ``F.embedding`` rather than an index:
    on DTensors torch 2.11's rule for the index's backward builds an
    unnormalised shard dim; a vocab-sharded table gives masked partial rows,
    summed here."""
    t = p["table"]
    if dtype is not None:
        t = t.to(dtype)
    return shards.reduce_partial(F.embedding(tokens.long(), t))


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, p["table"].to(x.dtype).T)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       valid_vocab: int | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy: the padded vocab ids are masked to
    ``finfo(logits.dtype).min`` in the logits' own dtype, then
    ``log_softmax`` in f32, the labels gathered, and the mean taken."""
    if valid_vocab is not None and valid_vocab < logits.shape[-1]:
        mask = torch.arange(logits.shape[-1], device=logits.device) \
            < valid_vocab
        logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())
    return torch.mean(nll)


def num_params(tree) -> int:
    """Element count of a parameter tree."""
    if isinstance(tree, dict):
        return sum(num_params(v) for v in tree.values())
    return math.prod(tree.shape)
