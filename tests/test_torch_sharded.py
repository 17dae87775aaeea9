"""The port's group-sharded engine (``--engine sharded``, DESIGN.md §8) in
its library form, on ``test_fedgs_fused.py``'s multi-device config (M=4,
K=8, L=4, T=5, R=2) on the CPU: at world 1 the fused engine bit for bit
on six compositions; the divisor rule of ``make_group_mesh`` over three
gloo ranks, with a rank that sits out; the four ``sync`` collectives
against the JAX package's (its ``psum``/``pmean`` under ``vmap``); a
cadence's re-trigger that fires in one shard only; M that no shard count
divides; ``launch/steps``' select and Eq. 5 steps against JAX's. Worlds 2
and 4 are in ``test_torch_sharded_ranks.py``, the JAX package's 4-shard
run in ``test_torch_sharded_jax*.py``."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharded_ranks as ranks
from repro.core import selection as jselection
from repro.core import sync as jsync
from repro.launch import steps as jsteps
from repro_torch import tree
from repro_torch.core import fedgs, sync
from repro_torch.launch import steps

ENV_ARMS = ("plain", "compress", "robust", "drift", "avail", "population")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    """Three gloo ranks: the collectives, the meshes at M = 4, 5, 6 and
    None, the plain composition at M = 4 (two shards, rank 2 sits out) and
    at M = 5 (one shard)."""
    out = tmp_path_factory.mktemp("world3")
    ranks.spawn(3, ["collectives", ("plain", 4), ("plain", 5)], str(out))
    return str(out)


@pytest.fixture(scope="module")
def world2_retrigger(tmp_path_factory):
    out = tmp_path_factory.mktemp("world2")
    ranks.spawn(2, [("retrigger", 4)], str(out))
    return str(out)


def _assert_same(a, b, params_tol=0.0):
    """Records equal, params within ``params_tol`` (0: bit for bit)."""
    (recs_a, params_a, sel_a), (recs_b, params_b, sel_b) = a, b
    assert recs_a == recs_b
    for x, y in zip(params_a, params_b, strict=True):
        assert float(np.abs(x - y).max()) <= params_tol
    for name in sel_a:
        np.testing.assert_array_equal(sel_a[name], sel_b[name])


@pytest.mark.parametrize("arm", ENV_ARMS)
def test_world1_is_the_fused_engine_bit_for_bit(arm):
    """Without a process group the mesh is one shard: no collective, and
    the round is ``run_fedgs_fused``'s bit for bit, records included."""
    mesh = fedgs.make_group_mesh(ranks.M)
    assert (mesh.size, mesh.rank, mesh.world, mesh.active) == (1, 0, 1,
                                                               True)
    params, sampler, p_real, cfg, kw = ranks.port_run_args(arm)
    fused, logs = fedgs.run_fedgs_fused(params, sampler, p_real, cfg, **kw)
    recs, sharded, _ = ranks.run_arm(arm, mesh)
    for a, b in zip(tree.leaves(fused), sharded, strict=True):
        assert np.array_equal(a.numpy(), b)
    assert [r.to_dict() for r in logs] == recs


def test_indivisible_groups_raise():
    """M must divide over the shards, checked before a round runs (the
    JAX package's ``test_sharded_rejects_indivisible_groups``)."""
    params, sampler, p_real, cfg, kw = ranks.port_run_args("plain")
    three = sync.GroupMesh(size=3)
    with pytest.raises(ValueError, match="must divide"):
        fedgs.make_round_body(kw["group_loss_fn"], cfg, sampler, mesh=three)
    with pytest.raises(ValueError, match="must divide"):
        fedgs.run_fedgs_fused(params, sampler, p_real, cfg, mesh=three, **kw)


def test_mesh_divisor_rule_and_a_rank_that_sits_out(world3):
    """n is the largest divisor of M up to the world size, as the JAX
    package picks it; a rank past n returns (None, []) at once, while the
    n ranks run the rounds and match the unsharded engine; a one-shard
    mesh issues no collective and is the unsharded engine bit for bit."""
    for rank in range(3):
        with open(os.path.join(world3, f"collectives_{rank}.json")) as f:
            sizes = json.load(f)
        assert sizes == {"4": [2, rank, 3, rank < 2],
                         "5": [1, rank, 3, rank == 0],
                         "6": [3, rank, 3, True],
                         "None": [3, rank, 3, True]}
    full = ranks.run_arm("plain")
    two = ranks.load_world(world3, "plain", 4, 3)
    assert two[2] == ([], None, None)
    for recs, params, _ in two[:2]:
        _assert_close(full, (recs, params))
    np.testing.assert_array_equal(
        np.concatenate([two[0][2]["mask"], two[1][2]["mask"]]),
        full[2]["mask"])
    one = ranks.load_world(world3, "plain", 5, 3)
    assert one[1] == one[2] == ([], None, None)
    _assert_same(ranks.run_arm("plain", m=5), one[0])


def _assert_close(full, got, params_tol=1e-5):
    (recs_f, params_f, _), (recs, params) = full, got
    for x, y in zip(params_f, params, strict=True):
        assert float(np.abs(x - y).max()) <= params_tol
    for r, o in zip(recs_f, recs, strict=True):
        assert o["reselections"] == r["reselections"]
        assert o["bytes_int"] == r["bytes_int"]
        for key in ("loss", "divergence", "selection_distance"):
            assert abs(o[key] - r[key]) <= 1e-4


def test_collectives_match_reference(world3):
    """``internal_sync_collective`` (weights per rank), its gradient form
    with a rank of weight 0, ``external_sync_collective`` and
    ``external_sync_grouped`` (two groups a rank) over three gloo ranks
    against the JAX package's over a ``vmap`` axis of three."""
    ins = [ranks.collective_inputs(r) for r in range(3)]
    stack = lambda trees: jax.tree.map(lambda *v: jnp.stack(v), *trees)
    params = stack([p for p, _, _ in ins])
    weights = jnp.asarray([w for _, w, _ in ins])
    gparams = stack([g for _, _, g in ins])
    grad_w = weights.at[1].set(0.0)
    ref = {
        "internal": jax.vmap(lambda p, w: jsync.internal_sync_collective(
            p, w, "r"), axis_name="r")(params, weights),
        "grad_internal": jax.vmap(
            lambda p, w: jsync.grad_internal_sync_collective(p, w, "r"),
            axis_name="r")(params, grad_w),
        "external": jax.vmap(lambda p: jsync.external_sync_collective(
            p, "r"), axis_name="r")(params),
        "grouped": jax.vmap(lambda g: jsync.external_sync_grouped(g, "r"),
                            axis_name="r")(gparams),
    }
    for rank in range(3):
        got = np.load(os.path.join(world3, f"collectives_{rank}.npz"))
        for name, tr in ref.items():
            for key, leaf in tr.items():
                np.testing.assert_allclose(got[f"{name}/{key}"],
                                           np.asarray(leaf)[rank],
                                           rtol=0, atol=1e-6)


def test_retrigger_in_one_shard_rebuilds_every_shard(world2_retrigger):
    """Availability under ``sync`` with a cadence of T: a keep iteration
    rebuilds when a committee member went dark. In some iterations only
    one shard's trigger fires; the OR over the shards makes the other
    rebuild too, so the masks, the rebuild count and the params are the
    unsharded engine's."""
    world = ranks.load_world(world2_retrigger, "retrigger", 4, 2)
    trig = [json.load(open(os.path.join(world2_retrigger,
                                        f"retrigger_4_{r}.triggers")))
            for r in range(2)]
    assert len(trig[0]) == len(trig[1]) == 8      # keep iterations
    assert any(a != b for a, b in zip(*trig)), trig
    full = ranks.run_arm("retrigger")
    np.testing.assert_array_equal(
        np.concatenate([world[0][2]["mask"], world[1][2]["mask"]]),
        full[2]["mask"])
    for recs, params, _ in world:
        _assert_close(full, (recs, params))
        assert [r["dark_selected"] for r in recs] == \
            [r["dark_selected"] for r in full[0]]
    assert 2 < sum(r["reselections"] for r in full[0]) < 10


def test_select_step_matches_reference():
    """``make_select_step``: the GBP-CS step over a batch of groups (one
    ``gbp_cs`` launch on a card), masks and trip counts exact."""
    rng = np.random.default_rng(4)
    counts = rng.integers(0, 6, size=(5, 12, 10)).astype(np.float32)
    p_real = rng.dirichlet(np.ones(10)).astype(np.float32)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(3), 5))
    ref = jsteps.make_select_step(4, 1, max_iters=16)(
        keys, jnp.asarray(counts), jnp.asarray(p_real))
    got = steps.make_select_step(4, 1, max_iters=16)(
        keys, torch.as_tensor(counts), torch.as_tensor(p_real))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(got.distance.numpy(), np.asarray(ref.distance),
                               atol=1e-5)
    assert isinstance(ref, jselection.SelectionResult)


def test_external_sync_step_matches_reference():
    """``external_sync_step``: the pod average (``agg_weighted``),
    broadcast back to every pod."""
    _, _, gp = ranks.collective_inputs(0)
    ref = jsteps.external_sync_step(jax.tree.map(jnp.asarray, gp))
    got = steps.external_sync_step({k: torch.as_tensor(v)
                                    for k, v in gp.items()})
    for key, leaf in ref.items():
        assert got[key].shape == leaf.shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(leaf),
                                   atol=1e-6)
