"""Forward flash attention with causal and sliding-window masks and GQA.

:func:`flash_attention` takes the model layout q (B, Sq, H, D), k/v
(B, Sk, KV, D) and returns (B, Sq, H, D) in q's dtype. For CUDA tensors it
launches ``csrc/flash_attention.cu`` (one CTA per (q tile of 64 rows, or
128 at D = 112, q head, batch); the kv loop runs inside the CTA over the
64-key tiles the masks reach, double-buffered by cp.async);
for CPU tensors it runs :func:`attention_plain`, the plain version of the
JAX package's ``kernels/flash_attention/ref.py``. Query head h reads kv
head ``h // (H / KV)``. Masked scores are ``NEG_INF = -1e30`` (not −inf),
as in the Pallas kernel, so a row whose keys are all masked in one tile
takes ``exp(0)`` there and the first unmasked key wipes those terms out.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

NAME = "flash_attention"
SOURCE = "src/repro_torch/csrc/flash_attention.cu"
REPLACES = ("src/repro/kernels/flash_attention/kernel.py:92 "
            "(flash_attention_kernel)")
LAUNCHES = 0

NEG_INF = -1e30
TILE = 64                       # Sq and Sk must be multiples of this
HEAD_DIMS = (32, 64, 112, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None
                    ) -> torch.Tensor:
    """q (B, H, Sq, D), k/v (B, KV, Sk, D/Dv) → (B, H, Sq, Dv): materialised
    f32 scores divided by √d, the −1e30 mask, softmax, in q's dtype."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, sq, d)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg.float(), k.float()) \
        / torch.full((), float(d), device=q.device).sqrt()
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return out.reshape(b, h, sq, v.shape[-1]).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Model layout q (B, Sq, H, D), k/v (B, Sk, KV, D) → (B, Sq, H, D).
    Sq and Sk must be multiples of ``block_q``/``block_k``, as the Pallas
    wrapper asserts."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if sq % block_q or sk % block_k:
        raise ValueError(f"flash_attention: Sq={sq}, Sk={sk} must be "
                         f"multiples of block_q={block_q}, "
                         f"block_k={block_k}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window={window} must be >= 1")
    if q.device.type == "cpu":
        out = attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window)
        return out.transpose(1, 2)
    return _launch(q, k, v, causal, window)


def _launch(q, k, v, causal: bool, window: int | None) -> torch.Tensor:
    lib = build.library()
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS or v.shape[-1] != d:
        raise ValueError(f"flash_attention: head dims {d}/{v.shape[-1]} "
                         f"unsupported (need D = Dv in {HEAD_DIMS})")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype} unsupported (one of f32, bf16)")
    if h % kvh or k.shape[:3] != v.shape[:3] or k.shape[0] != b:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit "
                         "(need H % KV == 0 and k, v of one shape)")
    if sq % TILE or sk % TILE or h > 65535 or b > 65535:
        raise ValueError(f"flash_attention: Sq={sq}, Sk={sk} must be "
                         f"multiples of the kernel's {TILE}-row tile")
    # each row is read as 16-byte (f32) or 8-byte (bf16) vectors of 4
    align = 4 * q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if t.stride(3) != 1 or any(s % 4 for s in t.stride()[:3]) \
                or t.data_ptr() % align:
            raise ValueError(f"flash_attention: {name} needs unit stride in "
                             "D, the other strides multiples of 4 and "
                             f"{align}-byte aligned data")
    out = torch.empty(b, sq, h, d, dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPES[q.dtype], b, h, kvh, sq, sk, d, *strides, int(causal),
        0 if window is None else int(window),
        ctypes.c_float(1.0 / (d ** 0.5)), build.stream(q))
    build.check(err, NAME)
    global LAUNCHES
    LAUNCHES += 1
    return out
