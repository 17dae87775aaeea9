"""Top-k magnitude selection over the rows of a flat (M, P) buffer
(DESIGN.md §18.2).

:func:`select` keeps the k largest-|x| coordinates of every row, ties to
the LOWER index (``jax.lax.top_k``'s order), and zeroes the rest: the
CUDA kernel ``csrc/topk_compress.cu`` for CUDA tensors, :func:`select_plain`
for CPU tensors. The kernel is an exact radix select of the k-th magnitude
τ, then an index-ordered keep pass, one call for all rows: one histogram
pass over the rows fixes τ's top 11 bits, one pass copies each row's
candidates (the keys that share them, every tie among them) into a buffer
of :func:`candidate_capacity` keys per row, and the other two digits and
the tie counts are found there. A row with more candidates than that takes
the overflow route, which finds them on the row itself (the same result).
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
MIN_CAPACITY = 4096            # candidate keys per row, at the least
CAPACITY_SHARE = 16            # ... else 1/16 of the row
STATS = ("tau_key", "ties_kept", "candidates", "route")   # per row


def select_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of the kernel: x (M, P), 1 <= k <= P → (M, P). A
    stable descending sort of |x| seats ties in index order; the first k
    are scattered back. Never ``torch.topk``: its order on ties is not
    stable."""
    idx = torch.sort(x.abs(), dim=1, descending=True, stable=True
                     ).indices[:, :k]
    return torch.zeros_like(x).scatter_(1, idx, x.gather(1, idx))


def blocks_for(p: int) -> int:
    """Contiguous chunks per row, one CTA each: of at least 1024
    coordinates, at most MAX_BLOCKS."""
    return max(1, min(MAX_BLOCKS, -(-p // 1024)))


def candidate_capacity(p: int) -> int:
    """Candidate keys the kernel's buffer holds per row: 1/16 of the row,
    at least 4096, at most the row. A row with more candidates takes the
    overflow route."""
    return min(p, max(MIN_CAPACITY, p // CAPACITY_SHARE))


def scratch_words(m: int, p: int) -> int:
    """32-bit words of the kernel's scratch: the row histograms (BINS per
    row), the per-chunk histograms (BINS per chunk), the candidates'
    offsets per chunk (blocks + 1 per row), the tie counts per chunk and
    the candidate buffer."""
    blocks = blocks_for(p)
    return m * (BINS + blocks * BINS + (blocks + 1) + blocks
                + candidate_capacity(p))


def select(x: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest-|x| of each row of x (M, P), ties to the lower
    index: kernel on the card (P % 4 == 0), plain on CPU."""
    return select_with_stats(x, k)[0]


def select_with_stats(x: torch.Tensor, k: int
                      ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """:func:`select` and, from the kernel, its (M, 4) int32 record per row
    (``STATS``: τ's key, the ties kept, the candidates, the route: 1 the
    candidate buffer, 0 overflow), left on the card; None on CPU."""
    m, p = x.shape
    if not 1 <= k <= p:
        raise ValueError(f"topk_compress: k={k} must lie in [1, P={p}]")
    build.refuse_grad(NAME, x)
    if x.device.type == "cpu":
        return select_plain(x, k), None
    lib = build.library()
    if p % 4 or p >= 2 ** 32 or m > 65535:
        raise ValueError(f"topk_compress: unsupported M={m}, P={p} (need "
                         "P % 4 == 0, P < 2^32, M <= 65535)")
    build.require(x, "x", (m, p), torch.float32, align=16)
    out = torch.empty_like(x)
    scratch = torch.empty(scratch_words(m, p), dtype=torch.int32,
                          device=x.device)
    stats = torch.empty(m, len(STATS), dtype=torch.int32, device=x.device)
    err = lib.topk_compress_f32(x.data_ptr(), out.data_ptr(),
                                scratch.data_ptr(), stats.data_ptr(), m, p,
                                k, blocks_for(p), candidate_capacity(p),
                                build.stream(x))
    build.check(err, NAME)
    global LAUNCHES
    LAUNCHES += 1
    return out, stats
