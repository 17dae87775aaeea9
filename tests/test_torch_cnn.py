"""The port's CNN, fused conv block and parameter conversion against the
JAX package."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import femnist_cnn as jcfg
from repro.kernels.conv_fused import ops as jconv
from repro.models import cnn as jcnn
from repro_torch import convert
from repro_torch.configs import femnist_cnn
from repro_torch.core import prng
from repro_torch.kernels import conv_fused
from repro_torch.models import cnn

TOL = dict(rtol=1e-5, atol=1e-5)


def _conv_inputs(seed, g=2, b=2, h=8, cin=3, cout=4, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (g, b, h, h, cin)).astype(np.float32)
    w = (rng.normal(size=(g, 5, 5, cin, cout)) / 5).astype(np.float32)
    bias = rng.normal(0, 0.1, (g, cout)).astype(np.float32)
    if ties:
        # a zero input region far from the border: y == bias there, so
        # every 2x2 window inside it holds four equal positive maxima
        x[:, 0] = 0.0
        bias = np.abs(bias) + 0.5
    gout = rng.normal(size=(g, b, h // 2, h // 2, cout)).astype(np.float32)
    return x, w, bias, gout


@pytest.mark.parametrize("ties", [False, True])
def test_conv_block_forward_and_grads(ties):
    x, w, b, gout = _conv_inputs(0, ties=ties)

    def jloss(x, w, b):
        out = jconv.conv_block_grouped(x, w, b, force_interpret=True)
        return jnp.sum(out * gout), out

    (_, ref), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                         has_aux=True)(x, w, b)
    tx, tw, tb = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    out = conv_fused.conv_block_grouped(tx, tw, tb)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    torch.sum(out * torch.from_numpy(gout)).backward()
    for t, r in zip((tx, tw, tb), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), **TOL)


def test_pool_ties_split_evenly():
    """Four equal maxima share the window's gradient in quarters (not all
    to one element, as F.max_pool2d's backward would)."""
    x, w, b, _ = _conv_inputs(1, g=1, b=1, cin=1, cout=1, ties=True)
    tx = torch.tensor(x)
    tw = torch.tensor(w)
    tb = torch.tensor(b, requires_grad=True)
    out = conv_fused.conv_block_grouped(tx, tw, tb)
    out.sum().backward()
    # each tied window passes 1 to b once (4 × 1/4), so db = #windows
    np.testing.assert_allclose(tb.grad.numpy(), [[16.0]])


@pytest.mark.parametrize("h,pool", [(7, False), (8, True)])
def test_fused_plain_matches_pallas_kernel(h, pool):
    """The kernel's plain version against the Pallas kernel (interpret
    mode) in both forms: relu(y) at odd spatial dims, and pooled."""
    from repro.kernels.conv_fused import kernel as jkernel
    x, w, b, _ = _conv_inputs(3, g=2, b=2, h=h, cin=3, cout=4)
    g, r = x.shape[0], x.shape[1] * h * h
    pat = np.asarray(jconv.im2col(jnp.asarray(x), (5, 5)))
    wm = w.reshape(g, -1, w.shape[-1])
    out_j, y_j = jkernel.conv_fused_kernel(
        jnp.asarray(pat), jnp.asarray(wm), jnp.asarray(b)[:, None, :],
        w_img=h, block_r=r, pool=pool, interpret=True)
    out_t, y_t = conv_fused.fused_plain(torch.tensor(pat), torch.tensor(wm),
                                        torch.tensor(b), h, pool=pool)
    assert out_t.shape == out_j.shape == ((g, r // 4, 4) if pool
                                          else (g, r, 4))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=1e-5)


def test_im2col_col2im_adjoint():
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(2, 3, 6, 6, 2)), dtype=torch.float32)
    p = torch.tensor(rng.normal(size=(2, 3 * 36, 50)), dtype=torch.float32)
    lhs = torch.sum(conv_fused.im2col(x, (5, 5)) * p)
    rhs = torch.sum(x * conv_fused.col2im(p, (5, 5), tuple(x.shape)))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 5])
def test_init_cnn_matches_jax(seed):
    cfg = femnist_cnn.smoke_config()
    ref = jcnn.init_cnn(jax.random.PRNGKey(seed), jcfg.smoke_config())
    out = cnn.init_cnn(prng.PRNGKey(seed), cfg, "cpu")
    for layer in ref:
        for k in ref[layer]:
            np.testing.assert_allclose(out[layer][k].numpy(),
                                       np.asarray(ref[layer][k]),
                                       rtol=0, atol=1e-6)
    assert dataclasses.asdict(femnist_cnn.CONFIG) == dataclasses.asdict(
        jcfg.CONFIG)


def _params(seed=0):
    p = jcnn.init_cnn(jax.random.PRNGKey(seed), jcfg.smoke_config())
    rng = np.random.default_rng(seed)
    # non-zero biases so every bias gradient path is exercised
    return {layer: {"w": np.asarray(v["w"]),
                    "b": rng.normal(0, 0.05, v["b"].shape).astype(np.float32)}
            for layer, v in p.items()}


def test_apply_loss_and_eval_match_jax():
    params = _params()
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1.5, (6, 28, 28)).astype(np.float32)
    y = rng.integers(0, 62, 6).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, params)
    tp = convert.params_from_jax(params, "cpu")
    np.testing.assert_allclose(cnn.apply(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(jcnn.apply(jp, jnp.asarray(x))),
                               **TOL)
    np.testing.assert_allclose(
        float(cnn.loss_fn(tp, (torch.from_numpy(x), torch.from_numpy(y)))),
        float(jcnn.loss_fn(jp, (jnp.asarray(x), jnp.asarray(y)))), **TOL)
    ref = jcnn.make_eval_fn(x, y)(jp)
    out = cnn.make_eval_fn(x, y, "cpu")(tp)
    np.testing.assert_allclose([float(v) for v in out],
                               [float(v) for v in ref], **TOL)


def test_group_loss_and_grads_match_jax():
    m, l, n = 2, 2, 3
    base = _params(1)
    rng = np.random.default_rng(4)
    gp = {layer: {k: (v[None] + rng.normal(0, 0.01, (m,) + v.shape)
                      ).astype(np.float32) for k, v in lv.items()}
          for layer, lv in base.items()}
    x = rng.uniform(0, 1.5, (m, l, n, 28, 28)).astype(np.float32)
    y = rng.integers(0, 62, (m, l, n)).astype(np.int32)
    wts = rng.uniform(0.5, 1.5, (m, l)).astype(np.float32)
    jfn = jcnn.make_group_loss_fn()

    def jloss(p):
        losses = jfn(p, (jnp.asarray(x), jnp.asarray(y)))
        return jnp.sum(losses * wts), losses

    (_, ref), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, gp))
    tp = convert.params_from_jax(gp, "cpu")
    for layer in tp.values():
        for v in layer.values():
            v.requires_grad_(True)
    losses = cnn.make_group_loss_fn()(
        tp, (torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(ref),
                               **TOL)
    torch.sum(losses * torch.from_numpy(wts)).backward()
    for layer in tp:
        for k in tp[layer]:
            np.testing.assert_allclose(tp[layer][k].grad.numpy(),
                                       np.asarray(jgrads[layer][k]), **TOL)


def test_params_from_jax_round_trip():
    params = jax.tree.map(np.asarray, jcnn.init_cnn(jax.random.PRNGKey(7),
                                                    jcfg.smoke_config()))
    tp = convert.params_from_jax(params, "cpu")
    assert tp["conv1"]["w"].dtype == torch.float32
    back = convert.params_to_numpy(tp)
    assert set(back) == set(params)
    for layer in params:
        for k in params[layer]:
            np.testing.assert_array_equal(back[layer][k], params[layer][k])
