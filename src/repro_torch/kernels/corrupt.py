"""The fault trace of the robustness layer (DESIGN.md §15.1) applied to a
flat member-gradient buffer, in place.

:func:`corrupt_rows` is the CUDA kernel ``csrc/corrupt_rows.cu`` (one
launch whatever fired: the untouched rows cost nothing, the NaN, +Inf,
scale, sign-flip and Gaussian-noise rows are rewritten, the noise drawn
from threefry bits in the kernel, each warp walking its share of the
Gaussian and the other rows interleaved) for CUDA tensors and
:func:`corrupt_rows_plain` for CPU tensors. Both take the trace as tensors
on x's device — ``code`` (R,) (0 = untouched, else 1 + the row's index in
``modes``) and the noise's per-(row, leaf) keys (R, S, 2) — so the call
reads nothing back to the host and a CUDA graph captures it. There is no
Pallas kernel behind it: the JAX package's ``make_corruption_fn`` selects
among per-mode candidates with ``jnp.where``; the kernel is the port's
own.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import prng
from . import build

NAME = "corrupt_rows"
SOURCE = "src/repro_torch/csrc/corrupt_rows.cu"
REPLACES = ("none: jnp src/repro/data/streaming.py:502-544 "
            "(make_corruption_fn) and its jax.random.normal draw (:536)")
LAUNCHES = 0

# CORRUPTION_MODES order: the kernel's op codes
MODES = ("nan_burst", "inf_spike", "scale", "sign_flip", "gauss_noise")
MAX_SEGMENTS = 64
MAX_MODES = 8
MAX_ROWS = 12000

# The kernel held against its plain version (the gpu-marked test and
# chip_smoke.py): (modes, each row's code, leaf sizes, P4). Rows all off,
# one row per mode, mixes over leaves that are not multiples of a float4 or
# of 16384 coordinates, rows of several such chunks, P4 pads; then only
# gauss rows hit, only byte rows hit, every row hit with mixed modes, and
# leaf boundaries inside the float4 that starts a 128-coordinate work item
# (the kernel's item: 32 float4 vectors, one per lane) and at one.
SWEEP = [
    (("scale", "gauss_noise"), (0, 0, 0, 0), (75, 3, 35, 5), 120),
    (MODES, (1, 2, 3, 4, 5, 0, 5), (75, 3, 35, 5), 120),
    (("scale", "nan_burst", "gauss_noise"), (0, 3, 1, 0, 2, 3, 3, 1, 0),
     (16385, 7, 20001, 1, 130), 36528),
    (("gauss_noise", "sign_flip", "inf_spike"), (1, 1, 2, 3, 0, 1),
     (1, 2, 3, 40000, 9), 40016),
    (("sign_flip",), (1,) * 5 + (0,) * 27, (33, 4096), 4132),
    (("scale", "gauss_noise", "nan_burst"), (2, 0, 2, 2, 0, 2),
     (1000, 3, 5000), 6004),
    (("gauss_noise", "scale", "sign_flip", "nan_burst", "inf_spike"),
     (2, 3, 0, 4, 5, 2, 3), (333, 4097, 11), 4444),
    (MODES, (5, 1, 3, 5, 2, 4, 5, 5, 3, 1, 4, 5), (129, 126, 3, 20000, 1),
     20260),
    (("gauss_noise", "scale"), (1, 1, 2, 0, 1), (129, 255, 1, 9000), 9392),
]


def sweep_inputs(case, gen: torch.Generator):
    """(x, code, keys, sizes, modes) of a :data:`SWEEP` case on ``gen``'s
    device: x normal, the pad columns too; keys random uint32 words."""
    modes, codes, sizes, p4 = case
    dev = gen.device
    x = torch.randn(len(codes), p4, generator=gen, device=dev)
    code = torch.tensor(codes, dtype=torch.int32, device=dev)
    keys = torch.randint(0, 2 ** 32, (len(codes), len(sizes), 2),
                         generator=gen, device=dev)
    return x, code, keys, list(sizes), modes


def max_error(out: torch.Tensor, ref: torch.Tensor, code: torch.Tensor,
              modes, sigma: float) -> tuple[bool, float]:
    """(whether every row but the Gaussian ones is bit-equal, pads and
    NaNs included; the Gaussian rows' max |out − ref| / σ)."""
    gauss = torch.zeros_like(code, dtype=torch.bool)
    for j, mode in enumerate(modes):
        if mode == "gauss_noise":
            gauss |= code == j + 1
    exact = torch.equal(out[~gauss].view(torch.int32),
                        ref[~gauss].view(torch.int32))
    err = float((out[gauss] - ref[gauss]).abs().max()) / sigma \
        if bool(gauss.any()) else 0.0
    return exact, err


def _check(x, code, keys, sizes, modes) -> None:
    r, p4 = x.shape
    if tuple(code.shape) != (r,):
        raise ValueError(f"corrupt_rows: code of shape {tuple(code.shape)}, "
                         f"expected ({r},)")
    if sum(sizes) > p4 or not sizes or min(sizes) < 1:
        raise ValueError(f"corrupt_rows: segments {sizes} do not fit P4={p4}")
    unknown = [mode for mode in modes if mode not in MODES]
    if unknown or not modes:
        raise ValueError(f"corrupt_rows: unknown modes {unknown or modes}")
    if "gauss_noise" in modes and (
            keys is None or tuple(keys.shape) != (r, len(sizes), 2)):
        raise ValueError("corrupt_rows: gauss_noise needs keys of shape "
                         f"({r}, {len(sizes)}, 2)")


def corrupt_rows_plain(x: torch.Tensor, code: torch.Tensor, keys, sizes,
                       modes, scale: float, sigma: float) -> torch.Tensor:
    """Plain version of the kernel: rewrite the rows of x (R, P4) in place
    by mode, one indexed write per mode that fired; the Gaussian noise of
    the gauss rows through ``prng.normal_segments_t`` (one draw of every
    leaf of every such row). Columns past Σ sizes are left alone. Returns
    x."""
    _check(x, code, keys, sizes, modes)
    v = x[:, :sum(sizes)]
    for j, mode in enumerate(modes):
        rows = torch.nonzero(code == j + 1).flatten()
        if rows.numel() == 0:
            continue
        if mode == "nan_burst":
            v[rows] = float("nan")
        elif mode == "inf_spike":
            v[rows] = float("inf")
        elif mode == "scale":
            v[rows] = v[rows] * scale
        elif mode == "sign_flip":
            v[rows] = -v[rows]
        else:
            noise = prng.normal_segments_t(keys[rows], sizes, x.device)
            v[rows] = v[rows] + sigma * noise
    return x


def corrupt_rows(x: torch.Tensor, code: torch.Tensor, keys, sizes, modes,
                 scale: float, sigma: float) -> torch.Tensor:
    """Apply the fault trace to x (R, P4) f32 in place: ``code`` (R,) int
    tensor, ``keys`` (R, S, 2) int64 tensor of uint32 words (the noise keys
    of the S leaves, None when no mode is ``gauss_noise``), ``sizes`` the S
    leaves' coordinate counts in x's column order, ``modes`` the mix.
    Kernel on the card, plain on CPU. Returns x."""
    build.refuse_grad(NAME, x)
    if x.device.type == "cpu":
        return corrupt_rows_plain(x, code, keys, sizes, modes, scale, sigma)
    _check(x, code, keys, sizes, modes)
    lib = build.library()
    r, p4 = x.shape
    p = sum(sizes)
    if p4 % 4 or r > MAX_ROWS or len(sizes) > MAX_SEGMENTS \
            or len(modes) > MAX_MODES or p >= 2 ** 32:
        raise ValueError(f"corrupt_rows: unsupported R={r}, P4={p4}, "
                         f"{len(sizes)} segments, {len(modes)} modes (need "
                         f"P4 % 4 == 0, R <= {MAX_ROWS}, <= {MAX_SEGMENTS} "
                         f"segments, <= {MAX_MODES} modes, P < 2^32)")
    build.require(x, "x", (r, p4), torch.float32, align=16)
    code32 = code.to(torch.int32).contiguous()
    kt = None if keys is None else keys.to(torch.int32).contiguous()
    offsets = [0]
    for size in sizes:
        offsets.append(offsets[-1] + int(size))
    offs = (ctypes.c_longlong * len(offsets))(*offsets)
    ops = (ctypes.c_int * len(modes))(*(MODES.index(m) for m in modes))
    err = lib.corrupt_rows_f32(
        x.data_ptr(), code32.data_ptr(),
        None if kt is None else kt.data_ptr(), r, p4,
        ctypes.addressof(offs), len(sizes), ctypes.addressof(ops),
        len(modes), float(scale), float(sigma), build.stream(x))
    build.check(err, NAME)
    global LAUNCHES
    LAUNCHES += 1
    return x
