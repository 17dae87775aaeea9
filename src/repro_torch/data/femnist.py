"""Procedural FEMNIST-like dataset (62 classes, 28×28, per-writer styles).

The port's own copy of the numpy surrogate generator: each of the 62 classes
has a deterministic glyph-like prototype (blobs + strokes); each *writer*
applies a persistent style (rotation/scale/shift bias, stroke gain) plus
per-sample jitter and pixel noise. Pure numpy, so the images are bit-equal
to the JAX package's generator for the same (class, writer, sample) ids.

The device-side generator of the fused engine (DESIGN.md §7) follows:
:func:`writer_style_table` (host, once per partition) and
:func:`generate_images_device`, the port of ``generate_images_jax``, whose
jitter comes from the threefry key chain (``core.prng``) under the same
keys as ``jax.random``, drawn on the tensors' device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import prng

NUM_CLASSES = 62
IMAGE_SIZE = 28


@functools.lru_cache(maxsize=1)
def class_prototypes(size: int = IMAGE_SIZE) -> np.ndarray:
    """(62, size, size) float32 prototypes in [0, 1], deterministic."""
    protos = np.zeros((NUM_CLASSES, size, size), np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for c in range(NUM_CLASSES):
        rng = np.random.default_rng(10_000 + c)
        img = np.zeros((size, size), np.float32)
        # 3-5 gaussian blobs
        for _ in range(rng.integers(3, 6)):
            cx, cy = rng.uniform(5, size - 5, 2)
            sx, sy = rng.uniform(1.2, 3.0, 2)
            img += np.exp(-(((xx - cx) / sx) ** 2 + ((yy - cy) / sy) ** 2))
        # 2-3 thick strokes (anti-aliased line segments)
        for _ in range(rng.integers(2, 4)):
            x0, y0, x1, y1 = rng.uniform(4, size - 4, 4)
            # distance from each pixel to the segment
            dx, dy = x1 - x0, y1 - y0
            L2 = dx * dx + dy * dy + 1e-6
            t = np.clip(((xx - x0) * dx + (yy - y0) * dy) / L2, 0, 1)
            dist = np.sqrt((xx - (x0 + t * dx)) ** 2 + (yy - (y0 + t * dy)) ** 2)
            img += np.exp(-(dist / rng.uniform(0.8, 1.4)) ** 2)
        img /= max(img.max(), 1e-6)
        protos[c] = img
    return protos


@functools.lru_cache(maxsize=16384)
def writer_style(writer_id: int) -> tuple:
    """Persistent per-writer style (rot, scale, shift_x, shift_y, gain, noise)."""
    rng = np.random.default_rng(50_000 + writer_id)
    return (rng.normal(0.0, 0.18), rng.uniform(0.85, 1.15),
            rng.normal(0.0, 1.2), rng.normal(0.0, 1.2),
            rng.uniform(0.8, 1.2), rng.uniform(0.15, 0.3))


def _writer_styles(writer_ids: np.ndarray) -> np.ndarray:
    """(n,) writer ids -> (n, 6) style array, cached per writer."""
    uniq, inv = np.unique(writer_ids, return_inverse=True)
    table = np.array([writer_style(int(w)) for w in uniq], np.float32)
    return table[inv]


def _affine_sample(protos: np.ndarray, classes: np.ndarray, rots: np.ndarray,
                   scales: np.ndarray, shifts: np.ndarray) -> np.ndarray:
    """Bilinear-sample each prototype under a per-sample affine transform."""
    n = classes.shape[0]
    size = protos.shape[-1]
    c0 = (size - 1) / 2.0
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    xy = np.stack([xx - c0, yy - c0], axis=0).reshape(2, -1)     # (2, P)
    cos, sin = np.cos(rots), np.sin(rots)
    # inverse transform: output pixel -> source coordinate
    inv_scale = 1.0 / scales
    rot_m = np.stack([np.stack([cos, sin], -1),
                      np.stack([-sin, cos], -1)], -2)            # (n,2,2)
    src = np.einsum("nij,jp->nip", rot_m, xy) * inv_scale[:, None, None]
    src = src + c0 - shifts[:, :, None]                          # (n,2,P)
    sx, sy = src[:, 0], src[:, 1]
    x0 = np.clip(np.floor(sx).astype(np.int32), 0, size - 2)
    y0 = np.clip(np.floor(sy).astype(np.int32), 0, size - 2)
    fx = np.clip(sx - x0, 0, 1).astype(np.float32)
    fy = np.clip(sy - y0, 0, 1).astype(np.float32)
    imgs = protos[classes]                                       # (n,S,S)
    flat = imgs.reshape(n, -1)
    idx = lambda yv, xv: (yv * size + xv)
    g00 = np.take_along_axis(flat, idx(y0, x0), axis=1)
    g01 = np.take_along_axis(flat, idx(y0, x0 + 1), axis=1)
    g10 = np.take_along_axis(flat, idx(y0 + 1, x0), axis=1)
    g11 = np.take_along_axis(flat, idx(y0 + 1, x0 + 1), axis=1)
    out = (g00 * (1 - fx) * (1 - fy) + g01 * fx * (1 - fy)
           + g10 * (1 - fx) * fy + g11 * fx * fy)
    oob = (sx < 0) | (sx > size - 1) | (sy < 0) | (sy > size - 1)
    out = np.where(oob, 0.0, out)
    return out.reshape(n, size, size).astype(np.float32)


def generate_images(classes: np.ndarray, writer_ids: np.ndarray,
                    sample_ids: np.ndarray) -> np.ndarray:
    """(n,) class/writer/sample ids -> (n, 28, 28) images, deterministic."""
    protos = class_prototypes()
    n = classes.shape[0]
    styles = _writer_styles(np.asarray(writer_ids))            # (n, 6)
    # batch-deterministic jitter (seeded by the first (writer, sample) pair)
    rng = np.random.default_rng(
        (int(writer_ids[0]) * 1_000_003 + int(sample_ids[0])) % (2**31))
    rots = styles[:, 0] + rng.normal(0, 0.08, n).astype(np.float32)
    scales = styles[:, 1] * rng.uniform(0.95, 1.05, n).astype(np.float32)
    shifts = styles[:, 2:4] + rng.normal(0, 0.6, (n, 2)).astype(np.float32)
    imgs = _affine_sample(protos, classes.astype(np.int64), rots, scales, shifts)
    imgs = imgs * styles[:, 4][:, None, None]
    imgs = imgs + rng.normal(0, 1.0, imgs.shape).astype(np.float32) \
        * styles[:, 5][:, None, None]
    return np.clip(imgs, 0.0, 1.5)


# ---------------------------------------------------------------------------
# Device-side generator (DESIGN.md §7): the port of the JAX package's
# ``generate_images_jax``. Styles stay host-precomputed (per-writer
# constants); only the per-sample jitter and noise are drawn on the device.
# ---------------------------------------------------------------------------

def writer_style_table(writer_ids: np.ndarray) -> np.ndarray:
    """(...,) writer-id array -> (..., 6) persistent style array (host, once)."""
    flat = np.asarray(writer_ids).reshape(-1)
    return _writer_styles(flat).reshape(np.shape(writer_ids) + (6,))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a·b + c rounded once to float32, as XLA's contraction of a multiply
    into the add that consumes it computes it: the product of two floats is
    exact in float64 (a double rounding is possible only at a float32 tie
    of the float64 sum)."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


def affine_sample_device(protos: torch.Tensor, classes: torch.Tensor,
                         rots: torch.Tensor, scales: torch.Tensor,
                         shifts: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling under per-sample inverse affine maps, on the
    tensors' device: protos (C, S, S), classes (..., N), rots/scales
    (..., N), shifts (..., N, 2) → (..., N, S, S).

    The arithmetic is the JAX package's ``_affine_sample_jax`` as XLA
    compiles it, multiply-adds contracted into one rounding: the rotation
    ``fma(m_i1, y, m_i0·x)``, then ``fma(·, 1/scale, c0) − shift``,
    ``floor`` and the clips, and the taps summed as ``fma(g11·fx, fy,
    fma(g10·(1−fx), fy, fma(g00·(1−fx), 1−fy, g01·fx·(1−fy))))``. Given the
    same jitter it is bit-equal to XLA on the CPU but for denormals, which
    XLA flushes; a one-ulp difference at an integer coordinate would move
    a whole tap."""
    size = protos.shape[-1]
    c0 = (size - 1) / 2.0
    grid = torch.arange(size, dtype=torch.float32, device=protos.device)
    xx = (grid[None, :] - c0).expand(size, size).reshape(-1)   # (P,)
    yy = (grid[:, None] - c0).expand(size, size).reshape(-1)
    cos, sin = torch.cos(rots)[..., None], torch.sin(rots)[..., None]
    inv_scale = (1.0 / scales)[..., None]
    sx = _fma(_fma(sin, yy, cos * xx), inv_scale, c0) \
        - shifts[..., 0:1]
    sy = _fma(_fma(cos, yy, -sin * xx), inv_scale, c0) \
        - shifts[..., 1:2]
    x0 = torch.clamp(torch.floor(sx).to(torch.int32), 0, size - 2)
    y0 = torch.clamp(torch.floor(sy).to(torch.int32), 0, size - 2)
    fx = torch.clamp(sx - x0, 0.0, 1.0)
    fy = torch.clamp(sy - y0, 0.0, 1.0)
    ux, uy = 1 - fx, 1 - fy
    flat = protos.reshape(protos.shape[0], -1)[classes.long()]   # (..., N, P)
    tap = lambda yv, xv: torch.gather(flat, -1, (yv * size + xv).long())
    out = _fma(tap(y0, x0) * ux, uy, tap(y0, x0 + 1) * fx * uy)
    out = _fma(tap(y0 + 1, x0) * ux, fy, out)
    out = _fma(tap(y0 + 1, x0 + 1) * fx, fy, out)
    oob = (sx < 0) | (sx > size - 1) | (sy < 0) | (sy > size - 1)
    out = torch.where(oob, 0.0, out)
    return out.reshape(out.shape[:-1] + (size, size))


def generate_images_device(protos: torch.Tensor, classes: torch.Tensor,
                           styles: torch.Tensor, key: torch.Tensor
                           ) -> torch.Tensor:
    """The JAX package's ``generate_images_jax`` on the tensors' device,
    batched over leading axes: classes (..., N) int, styles (..., N, 6)
    from :func:`writer_style_table`, key (..., 2) int64 threefry words, one
    key per batch row (a JAX key per vmapped call). Returns (..., N, 28,
    28), the jitter drawn from ``split(key, 4)`` as ``jax.random`` draws
    it (``normal`` to its 5e-7)."""
    n = classes.shape[-1]
    k = prng.split_t(key, 4)
    rots = styles[..., 0] + 0.08 * prng.normal_t(k[..., 0, :], (n,))
    scales = styles[..., 1] * prng.uniform_t(k[..., 1, :], (n,),
                                             minval=0.95, maxval=1.05)
    shifts = styles[..., 2:4] + 0.6 * prng.normal_t(k[..., 2, :], (n, 2))
    imgs = affine_sample_device(protos, classes, rots, scales, shifts)
    imgs = imgs * styles[..., 4, None, None]
    imgs = imgs + prng.normal_t(k[..., 3, :], tuple(imgs.shape[-3:])) \
        * styles[..., 5, None, None]
    return torch.clamp(imgs, 0.0, 1.5)


def make_test_set(n_per_class: int = 40, seed: int = 99
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Balanced i.i.d. test set drawn from held-out writer ids."""
    rng = np.random.default_rng(seed)
    classes = np.repeat(np.arange(NUM_CLASSES), n_per_class)
    writers = rng.integers(900_000, 910_000, size=classes.shape[0])
    samples = rng.integers(0, 2**30, size=classes.shape[0])
    images = generate_images(classes, writers, samples)
    perm = rng.permutation(classes.shape[0])
    return images[perm], classes[perm].astype(np.int32)
