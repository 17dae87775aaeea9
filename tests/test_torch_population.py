"""The lazy million-device population of the port (DESIGN.md §17) against
the JAX package's, on the CPU: the factory concentrations, the resident
rows and styles, ``p_real``, candidate committees, the sampler and the
client pool over a lazy population, lazy against ``materialize()``, and
flat memory at a population of 10⁹ devices.

Tolerances. A resident row is a Dirichlet draw around its factory's row
of the concentration table, and both are drawn by ``prng.loggamma_t``,
whose samples can differ from ``jax.random``'s in their last bits (its
``log``/``log1p`` are PyTorch's; tests/test_torch_drift.py). So the table
is held to a relative 1e-6 (measured: at most 6 ulp, 5.1e-7, two thirds
to three quarters of it bit-equal) and the rows to PR 21's Dirichlet
tolerance of 1e-6 (measured 2.4e-7 over 3,000 ids), with no acceptance
flip in their log-gamma samples; the blend that turns a prior into a
concentration is held bit for bit, on the JAX package's own prior, to
its arithmetic under ``jit`` (one rounding for the blend, F·α one float32
constant; eagerly, JAX rounds twice). ``p_real`` is held to 1e-7
(measured 3.7e-9). Styles, committees, labels and counts are exact;
images to ``IMG_TOL``."""
import tracemalloc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.streaming import LAZY_POOL_THRESHOLD as J_THRESHOLD
from repro.data import LazyPopulation as JLazyPopulation
from repro.data import PopulationConfig as JPopulationConfig
from repro.data import make_client_pool as jmake_client_pool
from repro.data import make_device_sampler as jmake_device_sampler
from repro.data import population as jpopulation
from repro_torch.core import prng
from repro_torch.data import (LAZY_POOL_THRESHOLD, DeviceStream,
                              LazyPopulation, PopulationConfig,
                              make_client_pool, make_device_sampler)
from repro_torch.data import population
from repro_torch.kernels import dirichlet

LOGGAMMA_ATOL, LOGGAMMA_RTOL = 2e-6, 1e-6   # as tests/test_torch_drift.py
FLIP = 1e-3          # a sample this far off took another acceptance branch
ROW_TOL = 1e-6
TABLE_RTOL = 1e-6
P_REAL_TOL = 1e-7
IMG_TOL = 1e-5
CONFIGS = {
    "million": dict(num_factories=10, devices_per_factory=100_000),
    "skewed": dict(num_factories=8, devices_per_factory=125_000, seed=3,
                   alpha=0.1, factory_bias=0.8),
    "small": dict(num_factories=4, devices_per_factory=12, seed=1,
                  alpha=1.7, factory_bias=0.2, batch_size=8),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(CONFIGS))
def pops(request):
    kw = CONFIGS[request.param]
    return (JLazyPopulation(JPopulationConfig(**kw)),
            LazyPopulation(PopulationConfig(**kw), device="cpu"))


def _ids(pop, n, seed=0):
    return np.random.default_rng(seed).integers(0, pop.total_devices, n)


def test_config_matches_reference():
    assert population.NUM_WRITERS == jpopulation.NUM_WRITERS
    assert LAZY_POOL_THRESHOLD == J_THRESHOLD
    assert PopulationConfig() == PopulationConfig(**vars(JPopulationConfig()))
    assert PopulationConfig(num_factories=3,
                            devices_per_factory=7).total_devices == 21
    for bad in (dict(num_factories=0), dict(devices_per_factory=0),
                dict(alpha=0.0), dict(factory_bias=1.5)):
        with pytest.raises(ValueError) as ours:
            PopulationConfig(**bad)
        with pytest.raises(ValueError) as ref:
            JPopulationConfig(**bad)
        assert str(ours.value) == str(ref.value)


def test_style_bank_and_randint_spans():
    """The port's own style bank equals the JAX package's; ``randint`` is
    bit-equal to ``jax.random.randint`` at the population's spans (the
    writer bank, and K_pop up to 125,000)."""
    assert np.array_equal(population._style_bank(),
                          jpopulation._style_bank())
    keys = prng.fold_in(prng.PRNGKey(5), np.arange(64))
    for span in (population.NUM_WRITERS, 100_000, 125_000, 2 ** 30):
        ref = jax.vmap(lambda k: jax.random.randint(k, (9,), 0, span))(
            jnp.asarray(keys))
        assert np.array_equal(prng.randint(keys, (9,), 0, span),
                              np.asarray(ref)), span


def test_factory_concentration_matches_reference(pops):
    """The (M, F) table: the blend bit for bit on JAX's own prior (as its
    engines compute it under ``jit``), the whole table to TABLE_RTOL."""
    jpop, pop = pops
    m = pop.num_factories
    mids = jnp.arange(m, dtype=jnp.int32)
    ref = np.asarray(jax.jit(jpop.factory_concentration)(mids))
    k_prior = jpop._key(808)
    prior = jax.vmap(lambda mi: jax.random.dirichlet(
        jax.random.fold_in(k_prior, mi),
        jnp.ones((pop.num_classes,), jnp.float32)))(mids)
    assert np.array_equal(pop.blend(torch.as_tensor(np.array(prior)))
                          .numpy(), ref)
    table = pop.table.numpy()
    assert table.shape == (m, pop.num_classes)
    assert float(np.max(np.abs(table - ref) / ref)) <= TABLE_RTOL
    assert np.array_equal(pop.factory_concentration(np.arange(m)).numpy(),
                          table)


def test_probs_for_matches_reference(pops):
    """Resident rows at random ids of the whole universe: each row's
    log-gamma samples with no acceptance flip, the rows to ROW_TOL; a
    subset's rows are the gather of the full draw's."""
    jpop, pop = pops
    ids = _ids(pop, 96)
    ref = np.asarray(jax.jit(jpop.probs_for)(jnp.asarray(ids, jnp.int32)))
    out = pop.probs_for(ids).numpy()
    assert float(np.abs(out - ref).max()) <= ROW_TOL
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)
    # the log-gamma samples behind the rows, on the port's table
    conc = pop.table[torch.as_tensor(ids // pop.devices_per_factory)]
    staged = torch.as_tensor(pop.stage(ids))
    lg = prng.loggamma_t(prng.split_t(staged[:, 3:], pop.num_classes)
                         .reshape(-1, 2), conc.reshape(-1)).numpy()
    k_dev = jpop._key(809)
    jl = np.asarray(jax.jit(jax.vmap(lambda i, a: jax.random.loggamma(
        jax.random.fold_in(k_dev, i), a)))(jnp.asarray(ids, jnp.int32),
                                           jnp.asarray(conc.numpy())))
    flips = int(np.sum(np.abs(lg - jl.reshape(-1)) > FLIP))
    assert flips == 0, f"{flips} acceptance decisions differ from JAX's"
    np.testing.assert_allclose(lg, jl.reshape(-1), rtol=LOGGAMMA_RTOL,
                               atol=LOGGAMMA_ATOL)
    assert torch.equal(pop.probs_for(ids[5:9]), pop.probs_for(ids)[5:9])


def test_styles_and_p_real_match_reference(pops):
    jpop, pop = pops
    ids = _ids(pop, 200, seed=1)
    assert np.array_equal(pop.styles_for(torch.as_tensor(ids)).numpy(),
                          np.asarray(jpop.styles_for(jnp.asarray(
                              ids, jnp.int32))))
    staged = pop.stage(ids)
    assert np.array_equal(staged[:, 0], ids)
    assert np.array_equal(staged[:, 1], ids // pop.devices_per_factory)
    p = pop.p_real
    assert p.dtype == np.float32 and p.shape == (pop.num_classes,)
    assert float(np.abs(p - jpop.p_real).max()) <= P_REAL_TOL
    assert abs(float(p.sum()) - 1.0) < 1e-6


@pytest.mark.parametrize("every", [0, 2, 3])
def test_candidate_committees_match_reference(every):
    """``device_ids(t, gids)`` equal JAX's across ≥ 3 candidate epochs
    (frozen at ``candidate_every`` 0), and the dense grid without
    candidates."""
    kw = CONFIGS["million"]
    jpop = JLazyPopulation(JPopulationConfig(**kw))
    pop = LazyPopulation(PopulationConfig(**kw), device="cpu")
    js = jmake_device_sampler(jpop, candidates=35, candidate_every=every)
    s = make_device_sampler(pop, candidates=35, candidate_every=every)
    assert (s.devices_per_group, s.population_per_group) == (35, 100_000)
    gids = np.arange(10)
    seen = set()
    for t in range(10):
        ids = s.device_ids(t, gids)
        assert ids.shape == (10, 35) and ids.dtype == np.int64
        assert np.array_equal(ids, np.asarray(js.device_ids(
            jnp.int32(t), jnp.asarray(gids, jnp.int32))))
        assert np.all(ids // 100_000 == gids[:, None])
        seen.add(ids.tobytes())
    assert len(seen) == (1 if every == 0 else -(-10 // every))
    dense = make_device_sampler(pop)
    assert np.array_equal(dense.device_ids(7, gids),
                          gids[:, None] * 100_000 + np.arange(100_000))


def test_sampler_validation_matches_reference():
    pop = LazyPopulation(PopulationConfig(**CONFIGS["small"]), device="cpu")
    jpop = JLazyPopulation(JPopulationConfig(**CONFIGS["small"]))
    for kw in (dict(candidates=0), dict(candidates=13),
               dict(candidates=4, candidate_every=-1)):
        with pytest.raises(ValueError) as ours:
            make_device_sampler(pop, **kw)
        with pytest.raises(ValueError) as ref:
            jmake_device_sampler(jpop, **kw)
        assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="staged seats"):
        make_device_sampler(pop).labels(
            torch.zeros(4, 2, 2, dtype=torch.int64), torch.arange(4))


def _sampler_pair(kw, candidates, every, **jkw):
    jpop = JLazyPopulation(JPopulationConfig(**kw))
    pop = LazyPopulation(PopulationConfig(**kw), device="cpu")
    return (jmake_device_sampler(jpop, candidates=candidates,
                                 candidate_every=every, **jkw),
            make_device_sampler(pop, candidates=candidates,
                                candidate_every=every), pop)


def test_sampler_matches_reference():
    """Counts exact and selected batches (labels exact, images to
    IMG_TOL) over a lazy population of 400 devices with committees of 8
    redrawn every 2 iterations, at t = 0..6 (four epochs)."""
    kw = dict(num_factories=4, devices_per_factory=100, batch_size=8)
    js, s, _ = _sampler_pair(kw, 8, 2)
    jcounts = jax.jit(js.counts)
    jbatch = jax.jit(js.selected_batch, static_argnums=3)
    gids = torch.arange(4)
    mask = np.zeros((4, 8), np.float32)
    mask[:, [6, 1, 3, 4]] = 1.0
    worst = 0.0
    for t in range(7):
        keys = torch.as_tensor(s.keys(t, np.arange(4)).astype(np.int64))
        seats = torch.as_tensor(s.seats(t, np.arange(4)))
        labels = s.labels(keys, gids, seats=seats)
        np.testing.assert_array_equal(
            s.counts(labels).numpy(),
            np.asarray(jcounts(jnp.int32(t), jnp.arange(4))), err_msg=str(t))
        imgs, labs = s.selected_batch(labels, keys, gids,
                                      torch.from_numpy(mask), 4, seats)
        jimgs, jlabs = jbatch(jnp.int32(t), jnp.arange(4), jnp.asarray(mask),
                              4)
        np.testing.assert_array_equal(labs.numpy(), np.asarray(jlabs))
        worst = max(worst, float(np.abs(imgs.numpy()
                                        - np.asarray(jimgs)).max()))
    assert worst <= IMG_TOL


@pytest.mark.parametrize("kw,clients", [
    (dict(num_factories=3, devices_per_factory=20, batch_size=8), 6),
    (dict(num_factories=4, devices_per_factory=20_000, batch_size=8), 10),
], ids=["exact-choice", "above-threshold"])
def test_client_pool_matches_reference(kw, clients):
    """The baselines' pool over a lazy population below and above
    ``LAZY_POOL_THRESHOLD``: client ids and labels equal JAX's, images to
    IMG_TOL, in rounds 0–2; the lazy material carries the clients' staged
    words."""
    jpool = jmake_client_pool(JLazyPopulation(JPopulationConfig(**kw)),
                              clients=clients, steps=2)
    pop = LazyPopulation(PopulationConfig(**kw), device="cpu")
    pool = make_client_pool(pop, clients=clients, steps=2)
    assert pool.material_size == clients * 5 + 4
    above = pop.total_devices > LAZY_POOL_THRESHOLD
    for r in range(3):
        (ji, jl), jw = jax.jit(jpool.round_batches)(jnp.int32(r))
        (im, lab), w = pool.round_batches(r)
        assert np.array_equal(lab.numpy(), np.asarray(jl))
        assert np.array_equal(w.numpy(), np.asarray(jw))
        assert float(np.abs(im.numpy() - np.asarray(ji)).max()) <= IMG_TOL
        mat = pool.material(r)
        assert np.array_equal(mat[clients + 4:].reshape(clients, 4),
                              pop.stage(mat[:clients])[:, 1:])
        if not above:   # an exact draw without replacement
            assert len(set(mat[:clients].tolist())) == clients


def test_lazy_equals_materialize():
    """Within the port, the lazy view and its ``materialize()`` give the
    same rows, styles, counts, batches and pool rounds, bit for bit."""
    pop = LazyPopulation(PopulationConfig(**CONFIGS["small"]), device="cpu")
    dense = pop.materialize()
    assert isinstance(dense, DeviceStream)
    ids = np.arange(pop.total_devices)
    assert torch.equal(pop.probs_for(ids), dense.probs_for(ids))
    assert torch.equal(pop.styles_for(ids), dense.styles_for(ids))
    sl, sd = make_device_sampler(pop), make_device_sampler(dense)
    gids = torch.arange(4)
    mask = torch.zeros(4, 12)
    mask[:, [0, 5, 7]] = 1.0
    for t in (0, 3):
        keys = torch.as_tensor(sl.keys(t, np.arange(4)).astype(np.int64))
        seats = torch.as_tensor(sl.seats(t, np.arange(4)))
        ll = sl.labels(keys, gids, seats=seats)
        ld = sd.labels(keys, gids)
        assert torch.equal(ll, ld)
        bl = sl.selected_batch(ll, keys, gids, mask, 3, seats)
        bd = sd.selected_batch(ld, keys, gids, mask, 3)
        assert all(torch.equal(a, b) for a, b in zip(bl, bd))
    pl, pd = (make_client_pool(v, clients=5, steps=2) for v in (pop, dense))
    (il, ll), wl = pl.round_batches(1)
    (id_, ld), wd = pd.round_batches(1)
    assert torch.equal(il, id_) and torch.equal(ll, ld)
    assert torch.equal(wl, wd)


def test_per_element_rows_plain():
    """The kernel's plain version with one concentration per element:
    every row drawn (no base) is ``dirichlet_t`` under the row's key and
    concentrations; a scalar α of the same value gives the same rows;
    shapes, dtypes and values are checked."""
    gen = torch.Generator().manual_seed(0)
    keys = torch.randint(0, 2 ** 32, (6, 2), generator=gen)
    trace = torch.cat([torch.zeros(6, 2, dtype=torch.int64), keys], 1)
    alpha = torch.rand(6, 62, generator=gen) * 3 + 1e-3
    out = dirichlet.draw_rows(trace, alpha)
    assert torch.equal(out, prng.dirichlet_t(keys, alpha, 62))
    flat = torch.full((6, 62), 0.3)
    assert torch.equal(dirichlet.draw_rows(trace, flat),
                       prng.dirichlet_t(keys, 0.3, 62))
    base = torch.full((6, 62), 1 / 62)
    trace[:3, 1] = 1
    mixed = dirichlet.drift_rows(base, trace, alpha)
    assert torch.equal(mixed[:3], out[:3])
    assert torch.equal(mixed[3:], base[3:])
    for bad, match in ((alpha.double(), "float32"), (alpha[:5], "trace"),
                       (-alpha, "finite"), (alpha[:, :30], "base")):
        with pytest.raises(ValueError, match=match):
            dirichlet.drift_rows(base if match == "base" else None, trace,
                                 bad)
    with pytest.raises(ValueError, match="alpha tensor"):
        dirichlet.drift_rows(None, trace, 0.3)
    with pytest.raises(ValueError, match="finite"):
        dirichlet.drift_rows(base, trace, float("nan"))


def test_population_memory_is_flat():
    """A universe of 10⁹ devices answers ``probs_for`` of 16 ids and
    ``p_real`` without an allocation that grows with D: under 4 MB of
    host allocations (tracemalloc), and only the (M, F) table and the
    style bank resident."""
    tracemalloc.start()
    pop = LazyPopulation(PopulationConfig(num_factories=10,
                                          devices_per_factory=10 ** 8),
                         device="cpu")
    ids = np.random.default_rng(2).integers(0, pop.total_devices, 16)
    rows = pop.probs_for(ids)
    p = pop.p_real
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert peak < 4 * 2 ** 20, peak
    assert rows.shape == (16, 62) and torch.isfinite(rows).all()
    assert p.shape == (62,)
    assert tuple(pop.table.shape) == (10, 62)
    assert tuple(pop.bank.shape) == (population.NUM_WRITERS, 6)
