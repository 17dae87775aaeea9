"""Checkpoints of the port against the JAX package: the same on-disk
format both ways, and ``--ckpt-dir`` on the CLI."""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.launch import train as jtrain
from repro_torch import checkpoint as ckpt
from repro_torch import tree
from repro_torch.launch import train

SMOKE = ["--groups", "4", "--devices-per-group", "8", "--selected", "4",
         "--presampled", "1", "--iters", "5", "--rounds", "3",
         "--batch-size", "8", "--smoke-model", "--lr", "0.05",
         "--eval-every", "2"]
# whole-run parameters against the JAX package: max-pool ties break
# differently in the two GEMMs (ROADMAP.md, queue 3, "Max-pool ties")
PARAM_TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    rng = np.random.default_rng(0)
    return {"b": {"c": torch.tensor([1, 2, 3], dtype=torch.int32),
                  "d": torch.from_numpy(rng.normal(size=(4, 5))
                                        .astype(np.float32))},
            "a": torch.arange(6.0).reshape(2, 3)}


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    d = ckpt.save(str(tmp_path / "ck"), t, step=7, metadata={"k": "v"})
    restored = ckpt.restore(d, t)
    for l1, l2 in zip(tree.leaves(t), tree.leaves(restored), strict=True):
        assert l1.dtype == l2.dtype and l1.device == l2.device
        assert torch.equal(l1, l2)
    _, manifest = ckpt.load(d)
    assert manifest["step"] == 7 and manifest["metadata"] == {"k": "v"}
    assert manifest["dtypes"] == ["float32", "int32", "float32"]


def test_checkpoint_latest_step(tmp_path):
    t = {"a": torch.zeros(2)}
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    for step in (1, 10, 5):
        ckpt.save(str(tmp_path / "ck"), t, step=step)
    assert ckpt.latest_step(str(tmp_path / "ck")).endswith("step_10")
    assert not [p for p in (tmp_path / "ck").iterdir()
                if p.name.startswith(".tmp_")]


def test_checkpoint_shape_mismatch_raises(tmp_path):
    d = ckpt.save(str(tmp_path / "ck"), {"a": torch.zeros(2, 2)}, step=0)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(d, {"a": torch.zeros(3, 2)})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(d, {"a": torch.zeros(2, 2), "b": torch.zeros(1)})


def test_restore_takes_the_template_dtype_and_device(tmp_path):
    d = ckpt.save(str(tmp_path / "ck"), {"a": torch.arange(4.0)}, step=2)
    out = ckpt.restore(d, {"a": torch.zeros(4, dtype=torch.float64)})
    assert out["a"].dtype == torch.float64
    np.testing.assert_array_equal(out["a"].numpy(), [0, 1, 2, 3])


def _without_treedef(manifest):
    return {k: v for k, v in manifest.items() if k != "treedef"}


def test_cross_loading_both_ways(tmp_path):
    """A JAX checkpoint restores in the port and a port checkpoint in the
    JAX package, leaves bit-equal; the manifests differ only in
    ``treedef``."""
    t = _tree()
    jt = jax.tree.map(lambda v: jnp.asarray(v.numpy()), t)
    meta = {"config": {"rounds": 3, "lr": 0.05}}
    jdir = jckpt.save(str(tmp_path / "jax"), jt, step=3, metadata=meta)
    pdir = ckpt.save(str(tmp_path / "port"), t, step=3, metadata=meta)
    assert _without_treedef(ckpt.load(pdir)[1]) == \
        _without_treedef(jckpt.load(jdir)[1])
    from_jax = ckpt.restore(jdir, t)
    for a, b in zip(tree.leaves(from_jax), tree.leaves(t), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    from_port = jckpt.restore(pdir, jt)
    for a, b in zip(jax.tree.leaves(from_port), jax.tree.leaves(jt),
                    strict=True):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _leaf_diff(port_dir, jax_dir):
    """Both CLIs' checkpoints: the same step, shapes and dtypes; returns
    the largest leaf difference."""
    leaves, manifest = ckpt.load(port_dir)
    ref, ref_manifest = jckpt.load(jax_dir)
    for key in ("step", "num_leaves", "shapes", "dtypes"):
        assert manifest[key] == ref_manifest[key], key
    return max(float(np.abs(a - b).max()) for a, b in zip(leaves, ref))


def _check_cli_ckpt_dir(flags, capsys, monkeypatch, tmp_path):
    """``--ckpt-dir`` on the smoke command against the JAX CLI's: the same
    step (``--rounds``), shapes and dtypes, leaves within 2e-4, the flags
    in the metadata."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(sys, "argv", ["train"] + SMOKE + flags
                        + ["--ckpt-dir", str(jdir)])
    jtrain.main()
    train.main(SMOKE + flags + ["--device", "cpu", "--ckpt-dir", str(pdir)])
    out = capsys.readouterr().out
    assert f"checkpoint saved: {pdir / 'step_3'}" in out
    assert _leaf_diff(str(pdir / "step_3"), str(jdir / "step_3")) \
        <= PARAM_TOL
    config = ckpt.load(str(pdir / "step_3"))[1]["metadata"]["config"]
    assert config["rounds"] == 3 and config["device"] == "cpu"
    assert config["ckpt_dir"] == str(pdir)
    json.dumps(config)


@pytest.mark.parametrize("flags", [
    [], ["--strategy", "fedavg", "--engine", "fused", "--local-steps", "2"],
], ids=["fedgs", "fedavg"])
def test_cli_ckpt_dir_matches_reference(flags, capsys, monkeypatch,
                                        tmp_path):
    _check_cli_ckpt_dir(flags, capsys, monkeypatch, tmp_path)


def test_cli_fused_engine_saves(capsys, monkeypatch, tmp_path):
    """``--engine fused`` saves the final params of its last round: the
    same checkpoint as the JAX CLI's fused engine."""
    _check_cli_ckpt_dir(["--engine", "fused"], capsys, monkeypatch,
                        tmp_path)
