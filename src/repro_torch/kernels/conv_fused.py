"""Fused conv block: conv(SAME) + bias + ReLU + 2×2 max-pool, per group.

``conv_block_grouped(x, w, b)`` takes x (G, B, H, W, Cin), per-group HWIO
weights w (G, kh, kw, Cin, Cout) and b (G, Cout), and returns
(G, B, H/2, W/2, Cout) — the whole (M·L·n) conv superbatch of a round in
one launch per layer. Three pieces, as in the JAX package's
``kernels/conv_fused/ops.py``:

* :func:`im2col` — k² shifted slices of the zero-padded input concatenated
  on the feature axis (order (kh, kw, cin), matching ``w.reshape(k²·Cin,
  Cout)``); pure data movement, outside the kernel. :func:`col2im` is its
  transpose, k² slice-adds.
* :func:`fused` — the GEMM with its bias/ReLU/pool epilogue: the CUDA
  kernel (``csrc/conv_fused.cu``) for CUDA tensors, :func:`fused_plain`
  for CPU tensors. It writes the pooled output (``pool=False``: relu(y),
  the Pallas kernel's other form) and the pre-activation y.
* :class:`ConvBlock`, a ``torch.autograd.Function`` whose backward reuses
  the patches: dW = patchesᵀ·dy and dpatches = dy·wᵀ as ``torch.matmul``
  (the JAX package leaves them to XLA outside any kernel), an even split of
  tied pool maxima, the ReLU mask ``y > 0`` and :func:`col2im`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

NAME = "conv_fused"
SOURCE = "src/repro_torch/csrc/conv_fused.cu"
REPLACES = "src/repro/kernels/conv_fused/kernel.py:64 (conv_fused_kernel)"
LAUNCHES = 0


def im2col(x: torch.Tensor, ksz: tuple[int, int]) -> torch.Tensor:
    """x (G, B, H, W, C) → patches (G, B·H·W, kh·kw·C), rows in (image,
    row, col) order, features in (kh, kw, c) order (SAME padding)."""
    g, b, h, w, c = x.shape
    kh, kw = ksz
    ph, pw = kh // 2, kw // 2
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    cols = [xp[:, :, i:i + h, j:j + w, :]
            for i in range(kh) for j in range(kw)]
    return torch.cat(cols, dim=-1).reshape(g, b * h * w, kh * kw * c)


def col2im(dpat: torch.Tensor, ksz: tuple[int, int], shape: tuple
           ) -> torch.Tensor:
    """Transpose of :func:`im2col`: add the k² patch slabs back onto the
    padded image grid."""
    g, b, h, w, c = shape
    kh, kw = ksz
    ph, pw = kh // 2, kw // 2
    d = dpat.reshape(g, b, h, w, kh * kw, c)
    dxp = dpat.new_zeros((g, b, h + 2 * ph, w + 2 * pw, c))
    for n, (i, j) in enumerate((i, j) for i in range(kh) for j in range(kw)):
        dxp[:, :, i:i + h, j:j + w, :] += d[:, :, :, :, n, :]
    return dxp[:, :, ph:ph + h, pw:pw + w, :]


def fused_plain(pat: torch.Tensor, wm: torch.Tensor, b: torch.Tensor,
                w_img: int, pool: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: pat (G, R, Q), wm (G, Q, C), b (G, C)
    → (out, y (G, R, C)), out = pool2×2(relu(y)) (G, R/4, C), or relu(y)
    (G, R, C) with ``pool=False``."""
    g, r, _ = pat.shape
    c = wm.shape[-1]
    y = torch.bmm(pat, wm) + b[:, None, :]
    a = torch.relu(y)
    if not pool:
        return a, y
    a = a.reshape(g, -1, 2, w_img // 2, 2, c)
    return a.amax(dim=(2, 4)).reshape(g, r // 4, c), y


def fused(pat: torch.Tensor, wm: torch.Tensor, b: torch.Tensor, w_img: int,
          pool: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """GEMM + bias + ReLU (+ 2×2 pool): kernel on the card, plain on CPU.
    Any C with C % 4 == 0; with ``pool``, W even and R a multiple of 2W
    (whole image row-pairs), as the Pallas wrapper asserts."""
    if pat.device.type == "cpu":
        return fused_plain(pat, wm, b, w_img, pool)
    lib = build.library()
    g, r, q = pat.shape
    c = wm.shape[-1]
    if c % 4 or g > 65535 or (pool and (w_img % 2 or r % (2 * w_img))):
        raise ValueError(f"conv_fused: unsupported shape G={g}, R={r}, "
                         f"C={c}, W={w_img}, pool={pool} (need C % 4 == 0, "
                         "G <= 65535 and, with the pool, W even and R a "
                         "multiple of 2W)")
    build.require(pat, "patches", (g, r, q), torch.float32)
    build.require(wm, "w", (g, q, c), torch.float32, align=16)
    build.require(b, "b", (g, c), torch.float32, align=16)
    y = torch.empty(g, r, c, dtype=torch.float32, device=pat.device)
    out = torch.empty(g, r // 4 if pool else r, c, dtype=torch.float32,
                      device=pat.device)
    err = lib.conv_fused_f32(pat.data_ptr(), wm.data_ptr(), b.data_ptr(),
                             y.data_ptr(), out.data_ptr(), g, r, q, c, w_img,
                             int(pool), build.stream(pat))
    build.check(err, NAME)
    global LAUNCHES
    LAUNCHES += 1
    return out, y


class ConvBlock(torch.autograd.Function):
    """conv(SAME)+bias+ReLU+pool with the matmul-only backward."""

    @staticmethod
    def forward(ctx, x, w, b):
        g, bsz, h, w_img, cin = x.shape
        kh, kw, _, cout = w.shape[1:]
        if h % 2 or w_img % 2:
            raise ValueError(f"pooling needs even spatial dims, got "
                             f"{(h, w_img)}")
        pat = im2col(x.float(), (kh, kw))
        wm = w.reshape(g, kh * kw * cin, cout).float().contiguous()
        out, y = fused(pat, wm, b.float().contiguous(), w_img)
        ctx.save_for_backward(pat, y, w)
        ctx.x_shape = tuple(x.shape)
        return out.reshape(g, bsz, h // 2, w_img // 2, cout)

    @staticmethod
    def backward(ctx, gout):
        pat, y, w = ctx.saved_tensors
        g, bsz, h, w_img, cin = ctx.x_shape
        kh, kw, _, cout = w.shape[1:]
        r = pat.shape[1]
        a5 = torch.relu(y).reshape(g, bsz, h // 2, 2, w_img // 2, 2, cout)
        pooled = a5.amax(dim=(3, 5), keepdim=True)
        eq = (a5 == pooled).float()
        # a tied max splits the subgradient evenly (jnp.max's convention)
        ties = eq.sum(dim=(3, 5), keepdim=True)
        gout = gout.reshape(g, bsz, h // 2, 1, w_img // 2, 1, cout)
        da = (eq * (gout / ties)).reshape(g, r, cout)
        dy = da * (y > 0)                 # ReLU mask (grad 0 at y == 0)
        wm = w.reshape(g, kh * kw * cin, cout).float()
        dw = torch.matmul(pat.transpose(1, 2), dy).reshape(w.shape)
        db = dy.sum(dim=1)
        dpat = torch.matmul(dy, wm.transpose(1, 2))
        dx = col2im(dpat, (kh, kw), ctx.x_shape)
        return dx, dw.to(w.dtype), db


def conv_block_grouped(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                       ) -> torch.Tensor:
    """x (G, B, H, W, Cin), w (G, kh, kw, Cin, Cout), b (G, Cout) →
    (G, B, H/2, W/2, Cout), differentiable in x, w and b."""
    return ConvBlock.apply(x, w, b)
