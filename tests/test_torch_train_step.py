"""The FEDGS pod train step of the port (``launch.steps.make_train_step``)
against the JAX package's, and the semantics ``tests/test_launch.py`` holds
the JAX step to: pods that see different data differ, Eq. 5 makes them
equal again, and gradient accumulation over microbatches equals the full
batch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import build as jbuild
from repro_torch import configs, convert, tree
from repro_torch.launch import steps


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stacked(arch, n_layers, n_pods=2, b=4, s=32):
    """Both packages' pod-stacked parameters (pod m = the init times 1 + m /
    10, so that the pods start apart) and a pod-stacked batch from numpy."""
    jcfg = jconfigs.get_smoke_config(arch).with_(num_layers=n_layers)
    tcfg = configs.get_smoke_config(arch).with_(num_layers=n_layers)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    stacked = jax.tree.map(
        lambda l: jnp.stack([l * (1 + m / 10) for m in range(n_pods)]), jp)
    rng = np.random.default_rng(n_layers + s)
    spec = configs.input_specs(tcfg, configs.InputShape("t", s, b, "train"))
    batch = {name: rng.integers(0, tcfg.vocab_size, (n_pods,) + sp.shape,
                                dtype=np.int32)
             if not sp.dtype.is_floating_point else
             (rng.standard_normal((n_pods,) + sp.shape) * 0.02).astype(
                 np.float32) for name, sp in spec.items()}
    tp = convert.params_from_jax(jax.tree.map(np.asarray, stacked), "cpu")
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    return (jcfg, stacked, jax.tree.map(jnp.asarray, batch)), (tcfg, tp, tb)


def _leaf_close(out, ref, rel=1e-6):
    """Every element within ``rel`` of max(1, max |ref|) of its leaf."""
    ref = np.asarray(ref, np.float32)
    err = float(np.max(np.abs(out.float().numpy() - ref)))
    assert err <= rel * max(1.0, float(np.max(np.abs(ref)))), err


# (arch, layers, grad_accum, accum_mode, gather_dtype)
STEP_CASES = [("granite-3-2b", 2, 1, "grad_each", "fp32"),
              ("granite-3-2b", 2, 2, "grad_each", "fp32"),
              ("granite-3-2b", 2, 2, "loss_scan", "fp32"),
              ("granite-3-2b", 2, 2, "grad_each", "bf16"),
              ("mamba2-780m", 2, 2, "grad_each", "fp32"),
              ("mamba2-780m", 2, 2, "loss_scan", "fp32"),
              ("mamba2-780m", 2, 2, "loss_scan", "bf16"),
              ("dbrx-132b", 1, 2, "grad_each", "fp32")]


@pytest.mark.parametrize("arch,n_layers,ga,mode,gather", STEP_CASES)
def test_train_step_matches_reference(arch, n_layers, ga, mode, gather):
    """One step, both pods: the loss to 1e-6 and every parameter to 1e-6
    of max(1, max |leaf|) of the JAX step's. With bf16 gathering the
    gradient is rounded to bf16 on its way back, at places that differ
    between the packages (the JAX package's own jitted and eager gradients
    differ by up to 3e-3 of a leaf's largest gradient on these configs):
    there a leaf may also differ by one bf16 step (2^-7) of its largest
    update lr |g|."""
    (jcfg, jp, jb), (tcfg, tp, tb) = _stacked(arch, n_layers)
    lr = 0.1
    kw = dict(lr=lr, grad_accum=ga, accum_mode=mode, gather_dtype=gather,
              remat=True)
    jnew, jloss = jax.jit(jsteps.make_train_step(jcfg, **kw))(jp, jb)
    new, loss = steps.make_train_step(tcfg, **kw)(tp, tb)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-6)
    for out, ref, old in zip(tree.leaves(new), jax.tree.leaves(jnew),
                             jax.tree.leaves(jp)):
        if gather == "fp32":
            _leaf_close(out, ref)
            continue
        ref = np.asarray(ref)
        step = float(np.max(np.abs(np.asarray(old) - ref)))     # lr max |g|
        err = float(np.max(np.abs(out.numpy() - ref)))
        assert err <= 1e-6 * max(1.0, float(np.max(np.abs(ref)))) \
            + 2.0 ** -7 * step, err


def test_pods_differ_and_eq5_equalises():
    """test_launch.py's semantics: the pods saw different data, so their
    parameters differ after a step; Eq. 5 makes them equal, to the pod
    mean (``torch.mean`` over the pod axis) within 1e-6."""
    _, (cfg, tp, tb) = _stacked("granite-3-2b", 1)
    same = tree.map(lambda leaf: leaf[:1].expand(leaf.shape).contiguous(),
                    tp)
    new, _ = steps.make_train_step(cfg, lr=0.1, remat=False)(same, tb)
    assert sum(float((leaf[0] - leaf[1]).abs().max())
               for leaf in tree.leaves(new)) > 0
    synced = steps.external_sync_step(new)
    for s, leaf in zip(tree.leaves(synced), tree.leaves(new)):
        assert torch.equal(s[0], s[1])
        torch.testing.assert_close(s[0], leaf.mean(0), rtol=0, atol=1e-6)


def test_grad_accum_matches_full_batch():
    """grad_accum 4 against 1, both accumulation modes, to test_launch.py's
    atol 2e-5 and rtol 2e-4."""
    _, (cfg, tp, tb) = _stacked("granite-3-2b", 1, n_pods=1)
    n1, l1 = steps.make_train_step(cfg, lr=0.1, grad_accum=1,
                                   remat=False)(tp, tb)
    for mode in ("grad_each", "loss_scan"):
        n4, l4 = steps.make_train_step(cfg, lr=0.1, grad_accum=4,
                                       accum_mode=mode, remat=False)(tp, tb)
        assert abs(float(l1) - float(l4)) < 1e-4
        for a, b in zip(tree.leaves(n1), tree.leaves(n4)):
            torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-4)


def test_remat_step_equals_plain_step():
    _, (cfg, tp, tb) = _stacked("mamba2-780m", 2)
    outs = [steps.make_train_step(cfg, lr=0.1, grad_accum=2,
                                  remat=remat)(tp, tb) for remat in (False,
                                                                     True)]
    assert torch.equal(outs[0][1], outs[1][1])
    for a, b in zip(tree.leaves(outs[0][0]), tree.leaves(outs[1][0])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", [dict(accum_mode="scan"),
                                 dict(gather_dtype="fp16"),
                                 dict(grad_accum=0)])
def test_train_step_checks_its_options(bad):
    with pytest.raises(ValueError):
        steps.make_train_step(configs.get_smoke_config("granite-3-2b"),
                              **bad)


def test_microbatches_must_divide_the_batch():
    _, (cfg, tp, tb) = _stacked("granite-3-2b", 1, b=3)
    with pytest.raises(ValueError, match="grad_accum=2"):
        steps.make_train_step(cfg, grad_accum=2, remat=False)(tp, tb)
