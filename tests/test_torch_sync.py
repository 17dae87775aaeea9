"""Aggregation (Eqs. 3-5) of the port against the JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fedgs as jfedgs
from repro.core import sync as jsync
from repro.kernels.agg_weighted import ops as jagg
from repro_torch import convert, tree
from repro_torch.core import fedgs, sync
from repro_torch.kernels import agg_weighted


def _stack(seed, k=4):
    rng = np.random.default_rng(seed)
    shapes = {"conv1": {"w": (5, 5, 1, 3), "b": (3,)},
              "fc2": {"w": (7, 5), "b": (5,)}}        # P = 75+3+35+5 = 118
    return {layer: {n: rng.normal(size=(k,) + s).astype(np.float32)
                    for n, s in v.items()} for layer, v in shapes.items()}


def _close(out, ref, **tol):
    for layer in ref:
        for n in ref[layer]:
            np.testing.assert_allclose(out[layer][n].numpy(),
                                       np.asarray(ref[layer][n]), **tol)


@pytest.mark.parametrize("weights", [[1.0, 2.0, 0.0, 3.0], [1.0] * 4,
                                     [0.0] * 4])
def test_weighted_average_tree_matches_pallas(weights):
    trees = _stack(0)
    w = np.asarray(weights, np.float32)
    ref = jagg.weighted_average_tree(jax.tree.map(jnp.asarray, trees),
                                     jnp.asarray(w), force_interpret=True)
    out = agg_weighted.weighted_average_tree(
        convert.params_from_jax(trees, "cpu"), torch.from_numpy(w))
    _close(out, ref, rtol=1e-6, atol=1e-6)
    plain = sync.weighted_average(convert.params_from_jax(trees, "cpu"),
                                  torch.from_numpy(w))
    _close(plain, jsync.weighted_average(jax.tree.map(jnp.asarray, trees),
                                         jnp.asarray(w)), rtol=1e-6,
           atol=1e-6)


def test_flat_buffer_padded_to_multiple_of_four():
    trees = convert.params_from_jax(_stack(1, k=3), "cpu")
    flat = agg_weighted.flatten(trees, 3)
    assert flat.shape == (3, 120)
    assert torch.all(flat[:, 118:] == 0)
    np.testing.assert_allclose(
        agg_weighted.agg(flat, torch.tensor([0.5, 0.25, 0.25])).numpy(),
        agg_weighted.agg_plain(flat, torch.tensor([0.5, 0.25, 0.25])).numpy())


def test_external_sync_broadcast_and_sgd_match_jax():
    trees = _stack(2)
    jt = jax.tree.map(jnp.asarray, trees)
    tt = convert.params_from_jax(trees, "cpu")
    _close(sync.external_sync(tt), jsync.external_sync(jt), rtol=1e-6,
           atol=1e-6)
    _close(fedgs.external_sync_and_broadcast(tt),
           jfedgs.external_sync_and_broadcast(jt), rtol=1e-6, atol=1e-6)
    grads = _stack(3)
    _close(sync.apply_sgd(tt, convert.params_from_jax(grads, "cpu"), 0.05),
           jsync.apply_sgd(jt, jax.tree.map(jnp.asarray, grads), 0.05),
           rtol=0, atol=0)


def test_replicate_and_global_params():
    p = convert.params_from_jax(jax.tree.map(lambda a: a[0], _stack(4)),
                                "cpu")
    gp = fedgs.replicate_for_groups(p, 3)
    assert all(leaf.shape[0] == 3 for leaf in tree.leaves(gp))
    gp["fc2"]["b"][0] += 1.0      # copies, not views of one buffer
    assert not torch.equal(gp["fc2"]["b"][0], gp["fc2"]["b"][1])
    _close(fedgs.global_params(fedgs.replicate_for_groups(p, 3)),
           jax.tree.map(np.asarray, convert.params_to_numpy(p)), rtol=1e-6,
           atol=1e-6)


def test_local_step_and_internal_sync_match_jax():
    """Eq. 3 (one device's SGD step) and Eq. 4 in model and gradient space
    on a toy least-squares loss."""
    rng = np.random.default_rng(5)
    params = {"w": rng.normal(size=(6, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    x = rng.normal(size=(8, 6)).astype(np.float32)
    y = rng.normal(size=(8, 3)).astype(np.float32)

    def jloss(p, batch):
        return jnp.mean((batch[0] @ p["w"] + p["b"] - batch[1]) ** 2)

    def tloss(p, batch):
        return torch.mean((batch[0] @ p["w"] + p["b"] - batch[1]) ** 2)

    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jb, tb = (jnp.asarray(x), jnp.asarray(y)), (torch.from_numpy(x),
                                               torch.from_numpy(y))
    ref_l, ref_g = jsync.local_grads(jp, jb, jloss)
    loss, grads = sync.local_grads(tp, tb, tloss)
    np.testing.assert_allclose(float(loss), float(ref_l), rtol=1e-6)
    _close({"g": grads}, {"g": ref_g}, rtol=1e-5, atol=1e-6)
    ref_p, _ = jsync.local_step(jp, jb, jloss, 0.1)
    new, _ = sync.local_step(tp, tb, tloss, 0.1)
    _close({"p": new}, {"p": ref_p}, rtol=1e-5, atol=1e-6)
    trees = _stack(6)
    mask = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    sizes = np.array([3.0, 5.0, 1.0, 2.0], np.float32)
    jt = jax.tree.map(jnp.asarray, trees)
    tt = convert.params_from_jax(trees, "cpu")
    for bs in (None, sizes):
        tbs = None if bs is None else torch.from_numpy(bs)
        jbs = None if bs is None else jnp.asarray(bs)
        for port, ref in ((sync.internal_sync, jsync.internal_sync),
                          (sync.grad_internal_sync,
                           jsync.grad_internal_sync)):
            _close(port(tt, torch.from_numpy(mask), tbs),
                   ref(jt, jnp.asarray(mask), jbs), rtol=1e-6, atol=1e-6)
