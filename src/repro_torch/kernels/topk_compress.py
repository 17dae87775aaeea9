"""Top-k magnitude selection over the rows of a flat (M, P) buffer
(DESIGN.md §18.2).

:func:`select` keeps the k largest-|x| coordinates of every row, ties to
the LOWER index (``jax.lax.top_k``'s order), and zeroes the rest: the
CUDA kernel ``csrc/topk_compress.cu`` (an exact radix select of the k-th
magnitude, then an index-ordered keep pass; one call for all rows) for
CUDA tensors, :func:`select_plain` for CPU tensors.
"""
from __future__ import annotations

import torch

from . import build

NAME = "topk_compress"
SOURCE = "src/repro_torch/csrc/topk_compress.cu"
REPLACES = "src/repro/kernels/topk_compress/kernel.py:59 (topk_select_kernel)"
LAUNCHES = 0

BINS = 2048                    # radix bins of the kernel's first pass
MAX_BLOCKS = 256               # contiguous chunks per row


def select_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of the kernel: x (M, P), 1 <= k <= P → (M, P). A
    stable descending sort of |x| seats ties in index order; the first k
    are scattered back. Never ``torch.topk``: its order on ties is not
    stable."""
    idx = torch.sort(x.abs(), dim=1, descending=True, stable=True
                     ).indices[:, :k]
    return torch.zeros_like(x).scatter_(1, idx, x.gather(1, idx))


def select(x: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest-|x| of each row of x (M, P), ties to the lower
    index: kernel on the card (P % 4 == 0), plain on CPU."""
    m, p = x.shape
    if not 1 <= k <= p:
        raise ValueError(f"topk_compress: k={k} must lie in [1, P={p}]")
    if x.device.type == "cpu":
        return select_plain(x, k)
    lib = build.library()
    if p % 4 or p >= 2 ** 32 or m > 65535:
        raise ValueError(f"topk_compress: unsupported M={m}, P={p} (need "
                         "P % 4 == 0, P < 2^32, M <= 65535)")
    build.require(x, "x", (m, p), torch.float32, align=16)
    blocks = max(1, min(MAX_BLOCKS, -(-p // 1024)))   # chunks of >= 1024
    out = torch.empty_like(x)
    scratch = torch.empty(m * (BINS + 2 + blocks), dtype=torch.int32,
                          device=x.device)
    err = lib.topk_compress_f32(x.data_ptr(), out.data_ptr(),
                                scratch.data_ptr(), m, p, k, blocks,
                                build.stream(x))
    build.check(err, NAME)
    global LAUNCHES
    LAUNCHES += 1
    return out
