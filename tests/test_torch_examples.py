"""Host-batched evaluation and the three example scripts of the port
against the JAX package, on the CPU at reduced sizes."""
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import femnist_cnn as jfemnist_cnn
from repro.core import fedgs as jfedgs
from repro.core import samplers as jsamplers
from repro.data import FactoryStreams as JFactoryStreams
from repro.data import PartitionConfig as JPartitionConfig
from repro.data import femnist as jfemnist
from repro.data import make_partition as jmake_partition
from repro.models import cnn as jcnn
from repro_torch import checkpoint as ckpt
from repro_torch import convert, tree
from repro_torch.configs import femnist_cnn
from repro_torch.core import prng
from repro_torch.models import cnn

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def example(name):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(name, EXAMPLES /
                                                  f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke_params():
    jparams = jcnn.init_cnn(jax.random.PRNGKey(3),
                            jfemnist_cnn.smoke_config())
    return jparams, convert.params_from_jax(
        jax.tree.map(np.asarray, jparams), "cpu")


@pytest.fixture(scope="module")
def test_set():
    return jfemnist.make_test_set(n_per_class=3)     # 186 images


def test_evaluate_matches_reference(smoke_params, test_set):
    """Batches of 64 over 186 images (the last one partial): loss and
    accuracy within 1e-5 of the JAX package's ``evaluate``."""
    jparams, params = smoke_params
    tx, ty = test_set
    for batch in (64, 512):
        ref = jcnn.evaluate(jparams, jnp.asarray(tx), jnp.asarray(ty),
                            batch=batch)
        out = cnn.evaluate(params, tx, ty, batch=batch)
        assert all(isinstance(v, float) for v in out)
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    # tensors already on the params' device take the same path
    out_t = cnn.evaluate(params, torch.from_numpy(tx), torch.from_numpy(ty),
                         batch=64)
    np.testing.assert_allclose(out_t, cnn.evaluate(params, tx, ty, batch=64),
                               rtol=0, atol=0)


def _probe_apply(p, x):
    return x.reshape(x.shape[0], -1) @ p["w"] + p["b"]


def test_make_eval_fn_batch_and_apply_fn_match_reference(smoke_params,
                                                         test_set):
    """``batch=`` (equal chunks; a size that does not divide raises, as
    JAX's does) and ``apply_fn=`` (the linear probe) against JAX's
    ``make_eval_fn``."""
    jparams, params = smoke_params
    tx, ty = test_set
    for batch in (0, 62, 93):
        ref = jcnn.make_eval_fn(tx, ty, batch=batch)(jparams)
        out = cnn.make_eval_fn(tx, ty, "cpu", batch=batch)(params)
        np.testing.assert_allclose([float(v) for v in out],
                                   [float(v) for v in ref], rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="divide"):
        cnn.make_eval_fn(tx, ty, "cpu", batch=100)
    rng = np.random.default_rng(0)
    probe = {"w": (rng.normal(size=(784, 62)) * 0.01).astype(np.float32),
             "b": (rng.normal(size=62) * 0.1).astype(np.float32)}
    jprobe = lambda p, x: x.reshape(x.shape[0], -1) @ p["w"] + p["b"]
    ref = jcnn.make_eval_fn(tx, ty, batch=62, apply_fn=jprobe)(
        jax.tree.map(jnp.asarray, probe))
    out = cnn.make_eval_fn(tx, ty, "cpu", batch=62, apply_fn=_probe_apply)(
        {k: torch.from_numpy(v) for k, v in probe.items()})
    np.testing.assert_allclose([float(v) for v in out],
                               [float(v) for v in ref], rtol=1e-5, atol=1e-5)


QUICK = dict(groups=3, devices=8, selected=3, presampled=1, iters=3,
             rounds=4, batch_size=8, test_per_class=2)


def _argv(sizes):
    return [a for k, v in sizes.items()
            for a in (f"--{k.replace('_', '-')}", str(v))]


def _quickstart_reference(sel):
    """The JAX package's library calls of ``examples/quickstart.py`` at
    QUICK's sizes (the per-group ``loss_fn`` path)."""
    q = QUICK
    part = jmake_partition(JPartitionConfig(
        num_factories=q["groups"], devices_per_factory=q["devices"],
        alpha=0.3, seed=0))
    streams = JFactoryStreams(part, batch_size=q["batch_size"], seed=0)
    params = jcnn.init_cnn(jax.random.PRNGKey(0),
                           jfemnist_cnn.smoke_config())
    cfg = jfedgs.FedGSConfig(
        num_groups=q["groups"], devices_per_group=q["devices"],
        num_selected=q["selected"], num_presampled=q["presampled"],
        iters_per_round=q["iters"], rounds=q["rounds"], lr=0.05,
        batch_size=q["batch_size"], selection=sel)
    tx, ty = jfemnist.make_test_set(n_per_class=q["test_per_class"])
    kw = dict(eval_fn=lambda p: jcnn.evaluate(p, jnp.asarray(tx),
                                              jnp.asarray(ty)),
              eval_every=2) if sel == "gbp_cs" else {}
    return jfedgs.run_fedgs(params, jcnn.loss_fn, streams, part.p_real,
                            cfg, **kw)[1]


def test_quickstart_matches_reference(capsys):
    """The quickstart's rounds (GBP-CS with eval, then random selection)
    against the JAX package's calls at the same reduced size, to 1e-4; its
    closing line."""
    logs, logs_r = example("torch_quickstart").main(
        _argv(QUICK) + ["--device", "cpu"])
    out = capsys.readouterr().out
    for recs, sel in ((logs, "gbp_cs"), (logs_r, "random")):
        refs = _quickstart_reference(sel)
        assert len(recs) == len(refs) == QUICK["rounds"]
        for rec, ref in zip(recs, refs):
            for key in ("loss", "divergence", "test_loss", "test_accuracy"):
                a, b = getattr(rec, key), getattr(ref, key)
                assert (a is None) == (b is None), key
                if a is not None:
                    assert abs(a - b) <= 1e-4, (sel, rec.round, key, a, b)
    assert sum(rec.test_accuracy is not None for rec in logs) == 2
    assert "final divergence (GBP-CS)" in out
    assert ("closer to the global class distribution" in out) == \
        (logs[-1].divergence < logs_r[-1].divergence)


def test_femnist_e2e_writes_checkpoint_and_log(capsys, tmp_path):
    """The end-to-end script at reduced size: a checkpoint of step R·T that
    restores into the CNN's template, ``log.json`` with one record per
    round, and the Prop. 4 verdict."""
    final, logs, path = example("torch_femnist_e2e").main(
        ["--smoke-model", "--groups", "3", "--devices", "8", "--selected",
         "3", "--rounds", "2", "--iters", "2", "--batch-size", "8",
         "--test-per-class", "2", "--out", str(tmp_path), "--device",
         "cpu"])
    out = capsys.readouterr().out
    assert path == str(tmp_path / "ckpt" / "step_4")
    assert f"checkpoint: {path}" in out
    assert "Prop.4 efficiency condition (B_int/B_ext=20): satisfied" in out
    restored = ckpt.restore(path, cnn.init_cnn(
        prng.PRNGKey(9), femnist_cnn.smoke_config(), "cpu"))
    for a, b in zip(tree.leaves(restored), tree.leaves(final), strict=True):
        assert torch.equal(a, b)
    saved = json.loads((tmp_path / "log.json").read_text())
    assert [rec["round"] for rec in saved] == [0, 1] == \
        [rec["round"] for rec in logs]
    assert saved[1]["test_accuracy"] is not None


def test_gbp_cs_demo_matches_reference(capsys):
    """The demo's four mismatches against the JAX package's samplers on
    the same instance: exact for random, mc and brute; 1e-5 for GBP-CS."""
    results = example("torch_gbp_cs_demo").main(["--device", "cpu"])
    out = capsys.readouterr().out
    rng = np.random.default_rng(0)
    skills = rng.integers(0, 10, size=(6, 40)).astype(np.float32)
    target = np.asarray([25, 25, 20, 20, 15, 15], np.float32)
    for name in ("random", "mc", "gbp_cs", "brute"):
        ref = jsamplers.SAMPLERS[name](skills, target, 5)
        res = results[name]
        np.testing.assert_array_equal(res.selected, ref.selected)
        if name == "gbp_cs":
            np.testing.assert_allclose(res.distance, ref.distance, rtol=1e-5)
        else:
            assert res.distance == ref.distance
        assert f"{name:8s} | mismatch {res.distance:7.3f}" in out


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_femnist_e2e",
                                  "torch_gbp_cs_demo"])
def test_example_refuses_cuda_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example(name).main([])
