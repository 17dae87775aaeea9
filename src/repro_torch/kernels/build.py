"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a``; the objects are linked into one shared library with a plain
C interface that is loaded with ``ctypes``. The library is named after a
hash of the sources and lives in ``build/repro_torch_kernels/`` at the repo
root, so the first call after a change rebuilds it and later calls reuse it.

Nothing here runs at import time: :func:`library` builds on first use, and
raises when there is no ``nvcc`` — a kernel wrapper never falls back to its
plain version for a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F, _U = ctypes.c_float, ctypes.c_uint
# C entry points: name -> argtypes (every function returns cudaError_t as int)
SIGNATURES = {
    "gbp_cs_minimize_f32": [_P] * 7 + [_I] * 4 + [_P],
    "gbp_cs_chain": [_I, _I, _P],
    "conv_fused_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "agg_weighted_f32": [_P, _P, _P, _I, _L, _P],
    "robust_agg_f32": [_P, _P, _P, _I, _I, _L, _I, _I, _P],
    "topk_compress_f32": [_P, _P, _P, _P, _I, _L, _L, _I, _L, _P],
    "int8_quant_f32": [_P, _P, _P, _P, _I, _L, _P],
    "corrupt_rows_f32": [_P, _P, _P, _I, _L, _P, _I, _P, _I, _F, _F, _P],
    "dirichlet_rows_f32": [_P, _P, _P, _P, _I, _I, _F, _P],
    "avail_rows_f32": [_P] * 4 + [_I, _I] + [_U] * 4 + [_F] * 3
    + [_I, _F, _F, _P],
    "flash_attention_fwd": [_P, _P, _P, _P] + [_I] * 7 + [_L] * 9
    + [_I, _I, _F, _P],
    "ssd_scan_f32": [_P] * 9 + [_I] * 7 + [_L] * 10 + [_P],
}

_LIB: ctypes.CDLL | None = None
BUILD_SECONDS: float | None = None


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    """Hash of the target and every source and header: editing a shared
    header (``threefry.cuh``) rebuilds the library too."""
    h = hashlib.sha256(ARCH.encode())
    for src in sorted(sources() + list(CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` (or PyTorch's own guess
    of the toolkit root), else ``nvcc`` on ``PATH``."""
    from torch.utils import cpp_extension
    for home in (os.environ.get("CUDA_HOME"), cpp_extension.CUDA_HOME):
        if home and (pathlib.Path(home) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError(
            "repro_torch kernels: no nvcc found (set CUDA_HOME); the CUDA "
            "kernel library cannot be built, and a CUDA tensor has no "
            "plain-PyTorch fallback")
    return nvcc


def build(out: pathlib.Path) -> float:
    """Compile every source in parallel and link ``out``; returns seconds."""
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = []
        for src, proc in procs:
            log, _ = proc.communicate()
            logs.append(f"== {src.name}\n{log}")
            if proc.returncode != 0:
                for _, other in procs:
                    if other.poll() is None:
                        other.kill()
                        other.wait()
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        tmp_so = pathlib.Path(tmp) / out.name
        link = subprocess.run([nvcc, ARCH, "-shared", "-o", str(tmp_so)]
                              + [str(o) for o in objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        (out.parent / "ptxas.log").write_text("\n".join(logs))
        os.replace(tmp_so, out)   # atomic: a reader never sees half a file
    return time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB, BUILD_SECONDS
    if _LIB is not None:
        return _LIB
    path = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if not path.is_file():
        BUILD_SECONDS = build(path)
    else:
        BUILD_SECONDS = 0.0
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def require(t, name: str, shape: tuple, dtype, align: int = 4) -> None:
    """A kernel input must be a contiguous CUDA tensor of this shape/dtype
    whose data starts on an ``align``-byte boundary (16 where the kernel
    reads it as float4)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data must start on a {align}-byte "
                         "boundary")


def stream(t) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as a raw handle."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
