"""GBP-CS and client selection of the port against the JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_selection_instance
from repro.core import gbp_cs as jgbp
from repro.core import selection as jselection
from repro.data import partition as jpartition
from repro.data import streaming as jstreaming
from repro.kernels.gbp_cs import ops as jops
from repro_torch.core import gbp_cs, prng, selection
from repro_torch.kernels import gbp_cs as kgbp


def _instances():
    """The conftest GBP-CS instances plus FactoryStreams count instances
    built the way selection builds them (A = candidates' counts)."""
    out = []
    for seed in range(4):
        rng = np.random.default_rng(seed)
        out.append(make_selection_instance(rng))
        out.append(make_selection_instance(rng, f=62, k=33, l_sel=8,
                                           max_count=6))
    part = jpartition.make_partition(jpartition.PartitionConfig(
        num_factories=4, devices_per_factory=8, seed=1))
    streams = jstreaming.FactoryStreams(part, batch_size=8, seed=1)
    counts = streams.next_counts().astype(np.float32)
    for m in range(4):
        A = counts[m, 1:].T.copy()
        n_total = counts[m].sum() / 8 * 4
        y = (np.float32(n_total) * part.p_real - counts[m, 0]).astype(
            np.float32)
        out.append((A, y, 3))
    return out


@pytest.mark.parametrize("init", ["mpinv", "zero"])
def test_minimize_matches_reference(init):
    """Masks and iteration counts exact, distance within 1e-5 relative."""
    for A, y, l_sel in _instances():
        ref = jgbp.gbp_cs_minimize(jnp.asarray(A), jnp.asarray(y), l_sel,
                                   init=init, max_iters=64)
        res = gbp_cs.gbp_cs_minimize(torch.from_numpy(A)[None],
                                     torch.from_numpy(y)[None], l_sel,
                                     init=init, max_iters=64)
        np.testing.assert_array_equal(res.x[0].numpy(), np.asarray(ref.x))
        assert int(res.iterations[0]) == int(ref.iterations)
        np.testing.assert_allclose(float(res.distance[0]),
                                   float(ref.distance), rtol=1e-5)
        np.testing.assert_allclose(res.trace[0].numpy(),
                                   np.asarray(ref.trace), rtol=1e-5)


def test_batched_minimize_equals_per_group():
    """The group axis is a batch axis: batching changes nothing."""
    insts = [inst for inst in _instances() if inst[0].shape == (62, 33)]
    A = torch.from_numpy(np.stack([i[0] for i in insts]))
    y = torch.from_numpy(np.stack([i[1] for i in insts]))
    batched = gbp_cs.gbp_cs_minimize(A, y, 8)
    for g in range(A.shape[0]):
        single = gbp_cs.gbp_cs_minimize(A[g:g + 1], y[g:g + 1], 8)
        assert torch.equal(batched.x[g], single.x[0])
        assert int(batched.iterations[g]) == int(single.iterations[0])


def test_plain_step_matches_pallas_step():
    """The kernel's plain step against the Pallas permutation step
    (interpret mode)."""
    for A, y, l_sel in _instances():
        x = np.array(jgbp.init_mpinv(None, jnp.asarray(A), jnp.asarray(y),
                                       l_sel))
        for _ in range(3):
            xr, dr = jops.fused_step(jnp.asarray(A), jnp.asarray(x),
                                     jnp.asarray(y), interpret=True)
            xp, dp = kgbp.step(torch.from_numpy(A), torch.from_numpy(x),
                               torch.from_numpy(y))
            np.testing.assert_array_equal(xp.numpy(), np.asarray(xr))
            np.testing.assert_allclose(float(dp), float(dr), rtol=1e-5)
            x = np.array(xr)


def test_top_lsel_ties_go_to_lower_index():
    """Stable sort, as jnp.argsort: tied scores keep index order."""
    scores = np.array([0.5, 1.0, 1.0, 0.2, 1.0, 0.5], np.float32)
    for l_sel in range(1, 6):
        ref = np.asarray(jgbp.top_lsel(jnp.asarray(scores), l_sel))
        out = gbp_cs.top_lsel(torch.from_numpy(scores), l_sel).numpy()
        np.testing.assert_array_equal(out, ref)


def test_mpinv_uses_jax_pinv_cutoff():
    """A singular value between torch's default cutoff (max(F,K)·eps) and
    jnp's (10·max(F,K)·eps) must be dropped, as jnp.linalg.pinv does."""
    rng = np.random.default_rng(0)
    f, k = 62, 33
    u, _ = np.linalg.qr(rng.normal(size=(f, k)))
    v, _ = np.linalg.qr(rng.normal(size=(k, k)))
    s = np.ones(k)
    s[-1] = 2e-5        # 7.4e-6 < 2e-5 < 7.4e-5 (relative to s_max = 1)
    A = (u * s) @ v.T
    A = A.astype(np.float32)
    y = rng.normal(size=f).astype(np.float32)
    ref = np.asarray(jgbp.init_mpinv(None, jnp.asarray(A), jnp.asarray(y), 8))
    out = gbp_cs.init_mpinv(torch.from_numpy(A), torch.from_numpy(y), 8)
    np.testing.assert_array_equal(out.numpy(), ref)
    default = gbp_cs.top_lsel(
        torch.linalg.pinv(torch.from_numpy(A)) @ torch.from_numpy(y), 8)
    assert not torch.equal(default, out), "the cutoff should matter here"


@pytest.mark.parametrize("method", ["gbp_cs", "random"])
def test_select_for_groups_matches_reference(method):
    part = jpartition.make_partition(jpartition.PartitionConfig(
        num_factories=4, devices_per_factory=8, seed=2))
    streams = jstreaming.FactoryStreams(part, batch_size=8, seed=2)
    key = jax.random.PRNGKey(2)
    pkey = prng.PRNGKey(2)
    for _ in range(3):
        key, sub = jax.random.split(key)
        pkey, psub = prng.split(pkey)
        counts = streams.next_counts()
        streams.fetch_selected(np.eye(4, 8, dtype=np.float32), 1)
        ref = jselection.select_for_groups(
            jax.random.split(sub, 4), jnp.asarray(counts),
            jnp.asarray(part.p_real), 4, 1, method=method)
        out = selection.select_for_groups(
            prng.split(psub, 4), torch.from_numpy(counts),
            torch.from_numpy(part.p_real), 4, 1, method=method)
        np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
        np.testing.assert_array_equal(out.iterations.numpy(),
                                      np.asarray(ref.iterations))
        np.testing.assert_allclose(out.divergence.numpy(),
                                   np.asarray(ref.divergence), rtol=1e-5)
        np.testing.assert_allclose(out.distance.numpy(),
                                   np.asarray(ref.distance), rtol=1e-5)


def test_single_group_selection_and_reselect_predicate():
    part = jpartition.make_partition(jpartition.PartitionConfig(
        num_factories=1, devices_per_factory=8, seed=4))
    counts = jstreaming.FactoryStreams(part, batch_size=8,
                                       seed=4).next_counts()[0]
    key = jax.random.PRNGKey(4)
    ref = jselection.select_clients_via_gbp_cs(
        key, jnp.asarray(counts), jnp.asarray(part.p_real), 4, 1)
    out = selection.select_clients_via_gbp_cs(
        prng.PRNGKey(4), torch.from_numpy(counts),
        torch.from_numpy(part.p_real), 4, 1)
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    ref_r = jselection.select_clients_random(
        key, jnp.asarray(counts), jnp.asarray(part.p_real), 4)
    out_r = selection.select_clients_random(
        prng.PRNGKey(4), torch.from_numpy(counts),
        torch.from_numpy(part.p_real), 4)
    np.testing.assert_array_equal(out_r.mask.numpy(), np.asarray(ref_r.mask))
    for every in (0, 1, 3):
        for t in range(7):
            assert selection.reselect_predicate(t, every) == bool(
                jselection.reselect_predicate(t, every))
