"""The Fig. 4 samplers, the GBP-CS entry points and the distribution
helpers of the port against the JAX package, on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_selection_instance
from repro.core import distributions as jdist
from repro.core import gbp_cs as jgbp
from repro.core import samplers as jsamplers
from repro.data import PartitionConfig as JPartitionConfig
from repro.data import make_partition as jmake_partition
from repro_torch.core import distributions, gbp_cs, prng, samplers
from repro_torch.data import PartitionConfig, make_partition


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fig4_instances(make, config, m=2, k=33, l_sel=8, n=32, seed=0):
    """Fig. 4's instances (M factories, K candidates, L_sel, n, L_rnd = 2),
    built as the JAX package's ``benchmarks/bench_samplers.py`` builds
    them, from the partition ``make(config(...))``."""
    part = make(config(num_factories=m, devices_per_factory=k + 2,
                       seed=seed))
    rng = np.random.default_rng(seed)
    out = []
    for mi in range(m):
        probs = part.class_probs[mi].astype(np.float64)
        probs /= probs.sum(axis=-1, keepdims=True)
        counts = np.stack([rng.multinomial(n, probs[i])
                           for i in range(k)]).astype(np.float32)
        y = (n * (l_sel + 2) * part.p_real).astype(np.float32)
        pre = counts[rng.choice(k, 2, replace=False)].sum(0)
        out.append((counts.T, y - pre, l_sel))
    return out


INSTANCES = {
    "small": make_selection_instance(np.random.default_rng(1), f=8, k=18,
                                     l_sel=5),
    "conftest": make_selection_instance(np.random.default_rng(0)),
    "fig4": fig4_instances(make_partition, PartitionConfig, m=1)[0],
}
NUMPY_SAMPLERS = {
    "random": {"seed": 3},
    "mc": {"trials": 200},
    "brute": {"limit": 20_000},
    "bayesian": {"n_init": 5, "n_iter": 8, "pool": 64},
    "ga": {"population": 30, "generations": 15},
}


def test_fig4_instances_match_reference():
    """The port's partition builds the benchmark's instances bit for bit."""
    for a, b in zip(fig4_instances(make_partition, PartitionConfig),
                    fig4_instances(jmake_partition, JPartitionConfig)):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("inst", list(INSTANCES))
@pytest.mark.parametrize("name", list(NUMPY_SAMPLERS))
def test_numpy_sampler_bit_equal(name, inst):
    """x, distance, trace and evaluations equal the JAX package's; only the
    wall time differs."""
    A, y, l_sel = INSTANCES[inst]
    kw = NUMPY_SAMPLERS[name]
    res = samplers.SAMPLERS[name](A, y, l_sel, **kw)
    ref = jsamplers.SAMPLERS[name](A, y, l_sel, **kw)
    np.testing.assert_array_equal(res.x, ref.x)
    assert res.x.dtype == ref.x.dtype
    assert res.distance == ref.distance
    np.testing.assert_array_equal(res.trace, ref.trace)
    assert res.evaluations == ref.evaluations
    np.testing.assert_array_equal(res.selected, ref.selected)


@pytest.mark.parametrize("init", ["mpinv", "zero", "random"])
def test_gbp_cs_sampler_matches_reference(init):
    """Masks and iterations exact, distance and trace within 1e-5
    relative, evaluations = iterations + 1."""
    for (A, y, l_sel), seed in zip(INSTANCES.values(), (0, 1, 7)):
        res = samplers.gbp_cs_sampler(A, y, l_sel, init=init, seed=seed,
                                      device="cpu")
        ref = jsamplers.gbp_cs_sampler(A, y, l_sel, init=init, seed=seed)
        np.testing.assert_array_equal(res.x, ref.x)
        assert res.evaluations == ref.evaluations
        assert res.trace.shape == ref.trace.shape
        np.testing.assert_allclose(res.distance, ref.distance, rtol=1e-5)
        np.testing.assert_allclose(res.trace, ref.trace, rtol=1e-5)


def test_gbp_cs_sampler_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A, y, l_sel = INSTANCES["small"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        samplers.gbp_cs_sampler(A, y, l_sel)


@pytest.mark.parametrize("init", ["mpinv", "random"])
def test_single_instance_minimize_matches_reference(init):
    """A 2-D A is the JAX package's one-instance call, ``key=`` included,
    and the trace keeps its padding with the final distance."""
    for A, y, l_sel in INSTANCES.values():
        for seed in (0, 5):
            ref = jgbp.gbp_cs_minimize(
                jnp.asarray(A), jnp.asarray(y), l_sel, init=init,
                max_iters=16, key=jnp.asarray(prng.PRNGKey(seed)))
            res = gbp_cs.gbp_cs_minimize(
                torch.from_numpy(A), torch.from_numpy(y), l_sel, init=init,
                max_iters=16, key=prng.PRNGKey(seed))
            assert res.x.shape == (A.shape[1],) and res.distance.dim() == 0
            np.testing.assert_array_equal(res.x.numpy(), np.asarray(ref.x))
            assert int(res.iterations) == int(ref.iterations)
            np.testing.assert_allclose(float(res.distance),
                                       float(ref.distance), rtol=1e-5)
            np.testing.assert_allclose(res.trace.numpy(),
                                       np.asarray(ref.trace), rtol=1e-5)
    with pytest.raises(ValueError, match="key="):
        gbp_cs.gbp_cs_minimize(torch.from_numpy(A), torch.from_numpy(y),
                               l_sel, keys=prng.split(prng.PRNGKey(0), 1))


@pytest.mark.parametrize("init", ["random", "mpinv"])
def test_batched_minimize_matches_reference(init):
    """``gbp_cs_minimize_batched`` with its default keys, split(PRNGKey(0),
    M), against the JAX package's vmap: masks and trip counts exact."""
    insts = fig4_instances(make_partition, PartitionConfig, m=4)
    A = np.stack([i[0] for i in insts])
    y = np.stack([i[1] for i in insts])
    ref = jgbp.gbp_cs_minimize_batched(jnp.asarray(A), jnp.asarray(y), 8,
                                       init=init, max_iters=32)
    res = gbp_cs.gbp_cs_minimize_batched(torch.from_numpy(A),
                                         torch.from_numpy(y), 8, init=init,
                                         max_iters=32)
    np.testing.assert_array_equal(res.x.numpy(), np.asarray(ref.x))
    np.testing.assert_array_equal(res.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(res.distance.numpy(), np.asarray(ref.distance),
                               rtol=1e-5)
    np.testing.assert_allclose(res.trace.numpy(), np.asarray(ref.trace),
                               rtol=1e-5)


def test_divergence_ordering():
    """Fig. 4a: Brute lower-bounds everything; Random upper-bounds the
    optimizers (on average); GBP-CS is near-brute."""
    A, y, l_sel = INSTANCES["small"]
    brute = samplers.brute_sampler(A, y, l_sel).distance
    rnd = np.mean([samplers.random_sampler(A, y, l_sel, seed=s).distance
                   for s in range(20)])
    gbp = samplers.gbp_cs_sampler(A, y, l_sel, device="cpu").distance
    mc = samplers.monte_carlo_sampler(A, y, l_sel, trials=200).distance
    assert brute <= gbp + 1e-6 and brute <= mc + 1e-6
    assert gbp <= rnd + 1e-6, (gbp, rnd)
    assert gbp <= brute * 1.25 + 1e-6, "GBP-CS should be near-optimal"


def test_sampler_lineup_matches_reference():
    assert list(samplers.SAMPLERS) == list(jsamplers.SAMPLERS)


# ---------------------------------------------------------------------------
# the distribution helpers


def _close(out: torch.Tensor, ref) -> None:
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_distribution_helpers_match_reference():
    rng = np.random.default_rng(4)
    counts = rng.integers(0, 9, size=(3, 7, 62)).astype(np.int32)
    _close(distributions.estimate_p_real(torch.from_numpy(counts)),
           jdist.estimate_p_real(jnp.asarray(counts)))
    c2 = counts[0]
    mask = (rng.random(7) < 0.5).astype(np.float32)
    _close(distributions.supernode_distribution(torch.from_numpy(c2)),
           jdist.supernode_distribution(jnp.asarray(c2)))
    _close(distributions.supernode_distribution(torch.from_numpy(c2),
                                                torch.from_numpy(mask)),
           jdist.supernode_distribution(jnp.asarray(c2), jnp.asarray(mask)))
    A, y, l_sel = INSTANCES["fig4"]
    x = np.zeros(A.shape[1], np.float32)
    x[rng.choice(A.shape[1], l_sel, replace=False)] = 1.0
    b = rng.integers(0, 5, size=A.shape[0]).astype(np.float32)
    p_real = rng.dirichlet(np.ones(A.shape[0])).astype(np.float32)
    args = [torch.from_numpy(v) for v in (A, x, y)]
    _close(distributions.selection_objective(*args),
           jdist.selection_objective(*map(jnp.asarray, (A, x, y))))
    _close(distributions.selection_divergence(
        *(torch.from_numpy(v) for v in (A, x, b, p_real))),
        jdist.selection_divergence(*map(jnp.asarray, (A, x, b, p_real))))


def test_class_counts_out_of_range_labels():
    """Negative labels count in bin 0 and labels ≥ F are dropped, as
    ``jnp.bincount(length=F)`` does; int32 and exact."""
    rng = np.random.default_rng(5)
    cases = [np.asarray([-1, 0, 3, 5, 7]),
             rng.integers(-4, 70, size=(6, 9)),
             rng.integers(0, 62, size=200)]
    for labels, f in zip(cases, (5, 62, 62)):
        out = distributions.class_counts(torch.from_numpy(labels), f)
        ref = np.asarray(jdist.class_counts(jnp.asarray(labels), f))
        assert out.dtype == torch.int32 and out.shape == (f,)
        np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        distributions.class_counts(torch.tensor([-1, 0, 3, 5, 7]), 5),
        [2, 0, 0, 1, 0])


def test_token_bucket_counts_wrap_as_uint32():
    """The Knuth hash wraps in uint32: ids near 2³² − 1 land in the JAX
    package's buckets, exactly."""
    rng = np.random.default_rng(6)
    top = np.uint64(2 ** 32 - 1)
    ids = np.concatenate([
        rng.integers(0, 50_000, size=300).astype(np.uint64),
        top - rng.integers(0, 1000, size=300).astype(np.uint64),
        np.asarray([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1], np.uint64)])
    for f in (7, 62, 64):
        ref = np.asarray(jdist.token_bucket_counts(
            jnp.asarray(ids.astype(np.uint32)), f))
        out = distributions.token_bucket_counts(
            torch.from_numpy(ids.astype(np.int64)), f)
        assert out.dtype == torch.int32 and int(out.sum()) == ids.size
        np.testing.assert_array_equal(out.numpy(), ref)
