"""Procedural FEMNIST-like dataset (62 classes, 28×28, per-writer styles).

The port's own copy of the numpy surrogate generator: each of the 62 classes
has a deterministic glyph-like prototype (blobs + strokes); each *writer*
applies a persistent style (rotation/scale/shift bias, stroke gain) plus
per-sample jitter and pixel noise. Pure numpy, so the images are bit-equal
to the JAX package's generator for the same (class, writer, sample) ids.
"""
from __future__ import annotations

import functools

import numpy as np

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
