"""Import and device guards of the port."""
import ast
import pathlib

import pytest
import torch

from repro_torch.kernels import (agg_weighted, build, conv_fused, gbp_cs,
                                 robust_agg)
from repro_torch.launch import train

REPO = pathlib.Path(__file__).resolve().parents[1]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    examples = sorted((REPO / "examples").glob("torch_*.py"))
    assert len(examples) == 4
    files += examples
    assert len(files) > 10
    bad = [(str(p.relative_to(REPO)), mod) for p in files
           for mod in _imports(p)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert not bad, f"the port must not import jax or repro: {bad}"


def test_cli_defaults_to_cuda_and_refuses_without_a_card(monkeypatch):
    assert train.build_parser().get_default("device") == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--rounds", "1", "--iters", "1", "--smoke-model"])


def test_entry_point_turns_tf32_off(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert train.resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_wrappers_raise_without_a_library(monkeypatch, tmp_path):
    """A non-CPU tensor goes to the kernel or raises — never to the plain
    version. ``agg_weighted``, which the train step's Eq. 5 reaches, takes
    a CUDA tensor (a fake one here) to the kernel and a meta tensor (the
    dry run's) by the plain version's shape arithmetic alone."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_nvcc():
        raise RuntimeError("no nvcc")

    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    meta = lambda *shape: torch.empty(*shape, device="meta")
    calls = [
        lambda: gbp_cs.minimize(meta(2, 6, 5), meta(2, 6), meta(2, 5), 8),
        lambda: conv_fused.fused(meta(1, 32, 25), meta(1, 25, 4),
                                 meta(1, 4), 4),
        lambda: robust_agg.aggregate(meta(2, 3, 8), meta(2, 3),
                                     "trimmed_mean", 1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no nvcc"):
            call()
    with FakeTensorMode(), pytest.raises(RuntimeError, match="no nvcc"):
        agg_weighted.agg(torch.empty(3, 8, device="cuda"),
                         torch.empty(3, device="cuda"))
    before = agg_weighted.LAUNCHES
    out = agg_weighted.agg(meta(3, 8), meta(3))
    assert out.device.type == "meta" and tuple(out.shape) == (8,)
    assert agg_weighted.LAUNCHES == before
