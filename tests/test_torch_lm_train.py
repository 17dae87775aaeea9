"""The LM training losses of the port against the JAX package: the masked
cross-entropy, ``build(cfg).loss`` and its gradient for every arch's smoke
config, remat, and the refusals (kernels without a backward under grad, the
SPMD knobs on plain tensors)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build as jbuild
from repro.models import layers as jlayers
from repro_torch import configs, convert, tree
from repro_torch.kernels import (agg_weighted, conv_fused, corrupt, dirichlet,
                                 flash_attention, gbp_cs, int8_quant,
                                 robust_agg, ssd_scan, topk_compress)
from repro_torch.launch import steps
from repro_torch.models import build, layers, transformer
from repro_torch.models.ssm import ssd_chunked


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, b, s, seed):
    """A train batch of ``input_specs(cfg, (b, s))`` from numpy: ids in
    [0, vocab), embeddings normal * 0.02."""
    rng = np.random.default_rng(seed)
    out = {}
    spec = configs.input_specs(cfg, configs.InputShape("t", s, b, "train"))
    for name, sp in spec.items():
        if sp.dtype.is_floating_point:
            out[name] = (rng.standard_normal(sp.shape) * 0.02).astype(
                np.float32)
        else:
            out[name] = rng.integers(0, cfg.vocab_size, sp.shape,
                                     dtype=np.int32)
    return out


def _model(arch, layers_):
    jcfg = jconfigs.get_smoke_config(arch).with_(num_layers=layers_)
    tcfg = configs.get_smoke_config(arch).with_(num_layers=layers_)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _grads(fns, params, batch, **kw):
    leaves = [leaf.detach().requires_grad_(True)
              for leaf in tree.leaves(params)]
    loss = fns.loss(tree.unflatten(params, leaves), batch, **kw)
    return loss, torch.autograd.grad(loss, leaves)


def _close(out, ref, rel=1e-5):
    ref = np.asarray(ref, np.float32)
    err = float(np.max(np.abs(out.detach().float().numpy() - ref)))
    assert err <= rel * max(1.0, float(np.max(np.abs(ref)))), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_reference(dtype):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 7, 96)).astype(np.float32) * 3
    labels = rng.integers(0, 80, (2, 7)).astype(np.int32)
    jl = jnp.asarray(logits).astype(dtype)
    tl = torch.tensor(logits).to(getattr(torch, dtype)).requires_grad_(True)
    ref, jgrad = jax.value_and_grad(
        lambda z: jlayers.cross_entropy_loss(z, jnp.asarray(labels), 80))(jl)
    out = layers.cross_entropy_loss(tl, torch.tensor(labels), 80)
    (grad,) = torch.autograd.grad(out, tl)
    _close(out, ref)
    _close(grad, np.asarray(jgrad.astype(jnp.float32)),
           1e-5 if dtype == "float32" else 1e-2)
    # the padded ids take no probability mass
    assert float(out.detach()) == pytest.approx(float(ref), rel=1e-6)
    assert float(grad[..., 80:].abs().max()) == 0.0


# (arch, layers, batch, seq): every arch's smoke config, the MoE archs in
# both forms (dispatch at 4·E = 16 tokens or more, dense below)
LOSS_CASES = [("granite-3-2b", 2, 2, 32), ("granite-8b", 1, 2, 32),
              ("minitron-8b", 1, 2, 32), ("qwen1.5-4b", 1, 2, 32),
              ("deepseek-v2-236b", 1, 2, 32), ("deepseek-v2-236b", 1, 1, 8),
              ("dbrx-132b", 1, 2, 32), ("dbrx-132b", 1, 1, 8),
              ("mamba2-780m", 2, 2, 64), ("zamba2-7b", 2, 2, 64),
              ("internvl2-26b", 1, 2, 64), ("whisper-large-v3", 1, 2, 64)]


@pytest.mark.parametrize("arch,n_layers,b,s", LOSS_CASES)
def test_loss_and_grads_match_reference(arch, n_layers, b, s):
    jcfg, tcfg, jp, tp = _model(arch, n_layers)
    batch = _batch(tcfg, b, s, seed=n_layers + s)
    jb = jax.tree.map(jnp.asarray, batch)
    ref, jg = jax.jit(jax.value_and_grad(
        lambda p: jbuild(jcfg).loss(p, jb)))(jp)
    loss, grads = _grads(build(tcfg), tp,
                         {k: torch.tensor(v) for k, v in batch.items()})
    _close(loss, ref)
    for g, r in zip(grads, jax.tree.leaves(jg)):
        _close(g, r)


@pytest.mark.parametrize("arch", ["dbrx-132b", "mamba2-780m", "zamba2-7b",
                                  "whisper-large-v3"])
def test_remat_gives_the_same_numbers(arch):
    _, tcfg, _, tp = _model(arch, 2)
    batch = {k: torch.tensor(v) for k, v in _batch(tcfg, 2, 64, 3).items()}
    fns = build(tcfg)
    plain, g0 = _grads(fns, tp, batch, remat=False)
    remat, g1 = _grads(fns, tp, batch, remat=True)
    assert torch.equal(plain, remat)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_ssd_scan_differentiates_on_the_cpu():
    """On the CPU the wrapper is its plain version, and autograd runs
    through it: its gradients are ssd_chunked's."""
    gen = torch.Generator().manual_seed(0)
    x, dt, A, B, C = ssd_scan.example_inputs(gen, 2, 128, 3, 32, 16)
    dy = torch.randn(x.shape, generator=gen)
    grads = []
    for fn in (lambda *a: ssd_scan.ssd_scan(*a, chunk=64),
               lambda *a: ssd_chunked(*a, 64)[0]):
        ins = [t.detach().requires_grad_(True) for t in (x, dt, A, B, C)]
        grads.append(torch.autograd.grad(fn(*ins), ins, dy))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_flash_attention_refuses_under_grad():
    q = torch.randn(1, 128, 2, 32, requires_grad=True)
    k = torch.randn(1, 128, 1, 32)
    with pytest.raises(RuntimeError, match="attn_impl='auto'"):
        flash_attention.flash_attention(q, k, k)
    with torch.no_grad():
        assert flash_attention.flash_attention(q, k, k).shape == q.shape
    flash_attention.flash_attention(q.detach(), k, k)
    _, tcfg, _, tp = _model("granite-3-2b", 1)
    batch = {k: torch.tensor(v) for k, v in _batch(tcfg, 1, 128, 0).items()}
    fns = build(tcfg)
    with pytest.raises(RuntimeError, match="cannot differentiate"):
        _grads(fns, tp, batch, attn_impl="pallas")
    with torch.no_grad():     # prefill through the kernel is unchanged
        assert torch.isfinite(fns.loss(tp, batch, attn_impl="pallas"))


def _wrapper_calls():
    """Each kernel wrapper without a backward, called on a float input that
    requires grad."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 8, generator=g).requires_grad_(True)
    w = torch.ones(3)
    keys = torch.zeros(3, 2, dtype=torch.int32)
    return {
        "agg_weighted": lambda: agg_weighted.agg(x, w),
        "robust_agg": lambda: robust_agg.aggregate(x[:, None, :].expand(
            3, 3, 8), torch.ones(3, 3), "coord_median"),
        "topk_compress": lambda: topk_compress.select(x, 2),
        "int8_quant": lambda: int8_quant.quantize(x, keys),
        "corrupt_rows": lambda: corrupt.corrupt_rows(
            x, torch.zeros(3, dtype=torch.int32), keys, [8], ("scale",), 2.0,
            1.0),
        "dirichlet_rows": lambda: dirichlet.drift_rows(
            x, torch.zeros(3, 4, dtype=torch.int64), 1.0),
        "gbp_cs": lambda: gbp_cs.minimize(x[None], x[None, :, 0], torch.zeros(
            1, 8), 4),
        "conv_fused": lambda: conv_fused.fused(
            x.reshape(1, 4, 6), torch.ones(1, 6, 4), torch.zeros(1, 4), 2),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_kernel_wrappers_refuse_under_grad(name):
    """A wrapper whose kernel has no backward raises under grad on both
    devices, instead of returning an output without a grad_fn."""
    call = _wrapper_calls()[name]
    with pytest.raises(RuntimeError, match="no backward"):
        call()


@pytest.mark.parametrize("knob,value", [("grad_pspecs", {}),
                                        ("mesh", object()),
                                        ("act_sharding", object()),
                                        ("spmd_pod", True)])
def test_spmd_knobs_are_refused(knob, value):
    """The SPMD knobs need DTensor params and batches
    (``launch.sharding.distribute``): on plain tensors the step raises a
    ValueError naming the knob. A mesh without ``grad_pspecs`` is no knob
    (the JAX step ignores it too): the step runs as without it."""
    _, tcfg, _, tp = _model("granite-3-2b", 1)
    kw = {knob: value, **({"mesh": object()} if knob == "grad_pspecs"
                          else {})}
    stacked = tree.map(lambda leaf: leaf[None], tp)
    batch = {k: torch.tensor(v)[None]
             for k, v in _batch(tcfg, 2, 8, 0).items()}
    step = steps.make_train_step(tcfg, lr=0.1, **kw)
    if knob == "mesh":
        new, loss = step(stacked, batch)
        ref, ref_loss = steps.make_train_step(tcfg, lr=0.1)(stacked, batch)
        assert torch.equal(loss, ref_loss)
        for a, b in zip(tree.leaves(new), tree.leaves(ref)):
            assert torch.equal(a, b)
        return
    with pytest.raises(ValueError, match=knob):
        step(stacked, batch)


def test_forward_refuses_act_sharding():
    """``act_sharding`` pins DTensor activations; a plain forward raises."""
    _, tcfg, _, tp = _model("granite-3-2b", 1)
    with pytest.raises(ValueError, match="act_sharding pins a DTensor"):
        transformer.forward(tcfg, tp, torch.zeros(1, 8, dtype=torch.int32),
                            act_sharding=object())
