"""The dynamic environments of the port (DESIGN.md §13) against the JAX
package's, on the CPU: the threefry gamma and Dirichlet draws, the five
drift schedules, the blocked cdf of drifted rows, the drifted device
sampler and client pool, ``select_or_keep``, and the fused round against
the port's host loop under drift and reselection cadences.

Tolerances. ``prng.loggamma_t`` runs JAX's Marsaglia–Tsang loops with
PyTorch's ``log``/``log1p`` and the port's ``normal`` (which agrees with
``jax.random.normal`` to 5e-7, not bit for bit), so a sample can differ
from JAX's in its last bits: log-gamma samples are held to 2e-6 + 1e-6·|x|
(measured: 7.6e-6 at |x| ≈ 60 for α = 0.1, 1.9e-6 at α = 0.3, 4.8e-7 at
α = 2.5; ~90% of them bit-equal) and Dirichlet rows to 1e-6 (measured
1.2e-7). An acceptance decision that went the other way would move a
sample by far more (a different V): such flips are counted, and none is
allowed in these draws (0 of 173,600 elements: the four α at (350, 62)
under two sets of random keys). Labels drawn from a drifted cdf are held
exactly: a label differs only if a uniform falls within ~1e-7 of a cdf
step, which none of these draws does."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import selection as jselection
from repro.data import DeviceStream as JDeviceStream
from repro.data import DriftConfig as JDriftConfig
from repro.data import make_client_pool as jmake_client_pool
from repro.data import make_device_sampler as jmake_device_sampler
from repro.data import make_drift_fn as jmake_drift_fn
from repro.models import cnn as jcnn
from repro.configs import femnist_cnn as jcfg
from repro_torch import convert, tree
from repro_torch.core import fedgs, prng, selection
from repro_torch.data import (CorruptionConfig, DeviceBackedStreams,
                              DeviceStream, DriftConfig, PartitionConfig,
                              make_client_pool, make_corruption_fn,
                              make_device_sampler, make_drift_fn,
                              make_partition, streaming)
from repro_torch.kernels import dirichlet
from repro_torch.models import cnn

ALPHAS = (0.1, 0.3, 1.0, 2.5)
SCHEDULES = ("static", "step_shift", "rotate", "redraw", "churn")
# t0 = 3 and period 3: t = 0, 2 before t0 (epoch 0), 3, 5 in epoch 1, 6, 8
# in epoch 2
TIMES = (0, 2, 3, 5, 6, 8)
LOGGAMMA_ATOL, LOGGAMMA_RTOL = 2e-6, 1e-6
DIRICHLET_TOL = 1e-6
FLIP = 1e-3          # a sample this far off took another acceptance branch
CFG = dict(num_groups=4, devices_per_group=8, num_selected=4,
           num_presampled=1, iters_per_round=5, rounds=3, lr=0.05,
           gbp_max_iters=16)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def part():
    return make_partition(PartitionConfig(num_factories=4,
                                          devices_per_factory=8, seed=0))


def _keys(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, (n, 2), dtype=np.uint64).astype(np.uint32)


def _config(schedule):
    return dict(schedule=schedule, t0=3, period=3, alpha=0.3,
                churn_rate=0.4)


# ------------------------------------------------------------ the draws

@pytest.mark.parametrize("alpha", ALPHAS)
def test_loggamma_dirichlet_match_reference(alpha):
    """``prng.loggamma_t`` and ``dirichlet_t`` against ``jax.random.
    loggamma``/``dirichlet`` under ``vmap`` (as ``make_drift_fn`` draws
    them) on 64 rows of F = 62: both boost branches (α < 1 and ≥ 1), no
    acceptance flip, the samples to the module's tolerances."""
    r, f = 64, 62
    kd = _keys(7, r)
    conc = jnp.full((f,), alpha, jnp.float32)
    jl = np.asarray(jax.jit(jax.vmap(lambda k: jax.random.loggamma(
        k, conc)))(jnp.asarray(kd)))
    jd = np.asarray(jax.jit(jax.vmap(lambda k: jax.random.dirichlet(
        k, conc)))(jnp.asarray(kd)))
    kt = torch.as_tensor(kd.astype(np.int64))
    lg = prng.loggamma_t(prng.split_t(kt, f).reshape(-1, 2),
                         torch.full((r * f,), alpha)).reshape(r, f).numpy()
    flips = int(np.sum(np.abs(lg - jl) > FLIP))
    assert flips == 0, f"{flips} acceptance decisions differ from JAX's"
    np.testing.assert_allclose(lg, jl, rtol=LOGGAMMA_RTOL,
                               atol=LOGGAMMA_ATOL)
    dd = prng.dirichlet_t(kt, alpha, f).numpy()
    assert float(np.abs(dd - jd).max()) <= DIRICHLET_TOL
    np.testing.assert_allclose(dd.sum(-1), 1.0, atol=1e-5)


def test_loggamma_stats_count_each_elements_passes():
    """``loggamma_t``'s ``stats``: the batch's elements, passes and draws
    are the sums of each element drawn alone, and ``max_passes`` their
    maximum (the worst element's key chain, which ``chip_smoke.py`` prices
    as ``dirichlet_rows``' latency floor); at α = 0.02 this row has
    elements that take two and three passes."""
    f = 62
    keys = prng.split_t(torch.as_tensor(_keys(9, 1).astype(np.int64)),
                        f).reshape(-1, 2)
    alpha = torch.full((keys.shape[0],), 0.02)
    batch, alone = {}, []
    lg = prng.loggamma_t(keys, alpha, batch)
    for i in range(keys.shape[0]):
        one = {}
        assert torch.equal(prng.loggamma_t(keys[i:i + 1], alpha[i:i + 1],
                                           one), lg[i:i + 1])
        alone.append(one)
    for name in ("elements", "passes", "draws"):
        assert batch[name] == sum(one[name] for one in alone)
    assert batch["max_passes"] == max(one["max_passes"] for one in alone)
    assert batch["max_passes"] > 1


@pytest.mark.parametrize("f,alpha", [(1, 0.3), (33, 0.02), (64, 2.5)])
def test_drift_rows_on_the_cpu_at_the_kernels_edges(f, alpha):
    """``drift_rows`` on CPU tensors is its plain version, at the widths
    the kernel's block treats apart (F = 1: an empty upper warp; 33: one
    upper element; 64: a full row) and α = 0.02 (several outer passes):
    kept rows are their base rows rolled by their shifts, drawn rows sum
    to one, a trace with no row drawn draws nothing, and F = 65 is
    refused."""
    rng = np.random.default_rng(f)
    base = torch.as_tensor(rng.dirichlet(np.ones(f), 5).astype(np.float32))
    trace = torch.as_tensor(np.stack(
        [rng.integers(0, 70, 5), np.array([1, 0, 1, 1, 0]),
         rng.integers(0, 2 ** 32, 5), rng.integers(0, 2 ** 32, 5)], 1))
    out = dirichlet.drift_rows(base, trace, alpha)
    assert torch.equal(out, dirichlet.drift_rows_plain(base, trace, alpha))
    kept = trace[:, 1] == 0
    assert torch.equal(out[kept],
                       dirichlet.roll_rows(base, trace[:, 0])[kept])
    torch.testing.assert_close(out.sum(-1), torch.ones(5))
    trace[:, 1] = 0
    assert torch.equal(dirichlet.drift_rows(base, trace, alpha),
                       dirichlet.roll_rows(base, trace[:, 0]))
    with pytest.raises(ValueError, match="classes"):
        dirichlet.drift_rows(torch.ones(5, 65) / 65, trace, alpha)


def test_exponential_and_softmax_rows():
    kd = _keys(3, 40)
    ref = np.asarray(jax.vmap(lambda k: jax.random.exponential(k))(
        jnp.asarray(kd)))
    out = prng.exponential_t(torch.as_tensor(kd.astype(np.int64))).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=(5, 62)).astype(np.float32))
    assert float((prng.softmax_rows(x) - torch.softmax(x, -1)).abs().max()) \
        <= 1e-7
    with pytest.raises(ValueError, match="64"):
        prng.softmax_rows(torch.zeros(2, 65))


def test_drift_rows_plain_rolls_and_draws():
    """The kernel's plain version: undrawn rows rolled by their shift
    (exactly), drawn rows ``dirichlet_t`` under their keys."""
    base = torch.as_tensor(np.random.default_rng(1).dirichlet(
        np.full(62, 0.3), size=6).astype(np.float32))
    keys = _keys(5, 6).astype(np.int64)
    trace = torch.as_tensor(np.stack(
        [[0, 5, 61, 0, 0, 3], [0, 0, 0, 1, 1, 0], keys[:, 0], keys[:, 1]],
        axis=1))
    out = dirichlet.drift_rows(base, trace, 0.3)
    for r in (0, 1, 2, 5):
        assert torch.equal(out[r], torch.roll(base[r], int(trace[r, 0])))
    assert torch.equal(out[3:5], prng.dirichlet_t(trace[3:5, 2:], 0.3, 62))
    with pytest.raises(ValueError, match="trace"):
        dirichlet.drift_rows(base, trace[:5], 0.3)


# ------------------------------------------------------------ the schedules

@pytest.mark.parametrize("schedule", SCHEDULES)
def test_drift_fn_matches_reference(schedule, part):
    """Every schedule's drifted rows against ``make_drift_fn`` at t before
    and after t0 and in epochs 0, 1 and 2, on scattered flat ids: shifts
    bit-equal, Dirichlet rows to DIRICHLET_TOL and the undrawn rows of
    ``churn`` bit-equal; ``static`` is the no-op (None: the precomputed
    rows stay)."""
    ids = np.array([3, 17, 8, 30, 0, 21, 12, 25, 31, 6])
    base = part.class_probs.reshape(-1, 62)[ids].astype(np.float32)
    jfn = jax.jit(jmake_drift_fn(JDriftConfig(**_config(schedule)), 0, 62,
                                 32))
    fn = make_drift_fn(DriftConfig(**_config(schedule)), 0, 62)
    if schedule == "static":
        assert fn is None
        for t in TIMES:
            np.testing.assert_array_equal(
                np.asarray(jfn(jnp.asarray(base), jnp.int32(t),
                               jnp.asarray(ids))), base)
        return
    drawn = 0
    for t in TIMES:
        ref = np.asarray(jfn(jnp.asarray(base), jnp.int32(t),
                             jnp.asarray(ids)))
        out = fn(torch.as_tensor(base), t, ids).numpy()
        flag = fn.trace(t, ids)[:, 1] != 0
        drawn += int(flag.sum())
        np.testing.assert_array_equal(out[~flag], ref[~flag])
        if flag.any():
            assert float(np.abs(out[flag] - ref[flag]).max()) \
                <= DIRICHLET_TOL
    # redraw draws every row of epochs 1 and 2 (t = 3, 5, 6, 8), churn some
    assert drawn == {"redraw": 4 * len(ids), "churn": drawn}.get(schedule, 0)
    assert schedule != "churn" or 0 < drawn < 4 * len(ids)


def test_drift_config_validates():
    for bad, word in ((dict(schedule="sudden"), "schedule"),
                      (dict(schedule="rotate", period=0), "period"),
                      (dict(schedule="redraw", alpha=0.0), "alpha"),
                      (dict(schedule="churn", churn_rate=1.5), "churn_rate")):
        for cls in (DriftConfig, JDriftConfig):
            with pytest.raises(ValueError, match=word):
                cls(**bad)
    assert streaming.DRIFT_SCHEDULES == tuple(SCHEDULES)


def test_xla_cumsum_t_matches_numpy_and_xla():
    """The blocked cdf on tensors is bit-equal to the numpy form at any
    width up to 256 classes, and to XLA's ``jnp.cumsum`` on drifted
    rows."""
    rng = np.random.default_rng(4)
    for shape in ((7, 62), (3, 5, 17), (4, 256), (2, 10)):
        p = rng.dirichlet(np.full(shape[-1], 0.3),
                          size=shape[:-1]).astype(np.float32)
        np.testing.assert_array_equal(
            streaming.xla_cumsum_t(torch.as_tensor(p)).numpy(),
            streaming.xla_cumsum(p))
    drawn = prng.dirichlet_t(torch.as_tensor(_keys(2, 12).astype(np.int64)),
                             0.3, 62)
    np.testing.assert_array_equal(
        streaming.xla_cumsum_t(drawn).numpy(),
        np.asarray(jax.jit(lambda q: jnp.cumsum(q, axis=-1))(drawn.numpy())))
    with pytest.raises(ValueError, match="classes"):
        streaming.xla_cumsum_t(torch.zeros(1, 257))


# ------------------------------------------------------------ the data

@pytest.mark.parametrize("schedule", SCHEDULES)
def test_drifted_sampler_counts_match_reference(schedule, part):
    """``DeviceSampler`` counts under each schedule against JAX's
    ``make_device_sampler(drift=)`` at t = 0..8, exactly; ``static`` equals
    the sampler without drift."""
    jsampler = jmake_device_sampler(
        JDeviceStream.from_partition(part, batch_size=8, seed=0),
        drift=JDriftConfig(**_config(schedule)))
    stream = DeviceStream.from_partition(part, batch_size=8, seed=0,
                                         device="cpu")
    sampler = make_device_sampler(stream, drift=DriftConfig(
        **_config(schedule)))
    assert (sampler.drift is None) == (schedule == "static")
    jcounts = jax.jit(jsampler.counts)
    gids = torch.arange(4)
    for t in range(9):
        keys = torch.as_tensor(sampler.keys(t, np.arange(4)).astype(
            np.int64))
        trace = None if sampler.drift is None else torch.as_tensor(
            sampler.drift_trace(t, np.arange(4)))
        np.testing.assert_array_equal(
            sampler.counts(sampler.labels(keys, gids, trace)).numpy(),
            np.asarray(jcounts(jnp.int32(t), jnp.arange(4))), err_msg=str(t))


@pytest.mark.parametrize("schedule", ("step_shift", "rotate", "redraw",
                                      "churn"))
def test_drifted_client_pool_matches_reference(schedule, part):
    """The baselines' pool on the FEDGS clock (round r at t = r·T, T = 2):
    labels and weights equal JAX's ``make_client_pool(drift=,
    iters_per_round=)`` in rounds 0–4, across both epochs and t0."""
    cfg = _config(schedule)
    jpool = jmake_client_pool(
        JDeviceStream.from_partition(part, batch_size=4, seed=0), 6, 2,
        drift=JDriftConfig(**cfg), iters_per_round=2)
    pool = make_client_pool(
        DeviceStream.from_partition(part, batch_size=4, seed=0,
                                    device="cpu"), 6, 2,
        drift=DriftConfig(**cfg), iters_per_round=2)
    assert pool.material_size == 6 + 4 + 6 * 4
    fn = jax.jit(jpool.round_batches)
    for r in range(5):
        (_, rl), rw = fn(jnp.int32(r))
        (_, ol), ow = pool.round_batches(r)
        np.testing.assert_array_equal(ol.numpy(), np.asarray(rl))
        np.testing.assert_array_equal(ow.numpy(), np.asarray(rw))


# ------------------------------------------------------------ selection

@pytest.mark.parametrize("with_avail", [False, True], ids=["plain", "avail"])
def test_select_or_keep_matches_reference(with_avail, part):
    """Both branches against JAX's ``select_or_keep``: the fresh GBP-CS
    solve (masks exact, divergence and distance to 1e-6) and the kept
    mask re-scored against the (availability-masked) counts with the last
    rebuild's distance; ``do`` as a bool and as a device predicate, the
    keys as numpy keys and as the staged (perm, opt) tensors."""
    rng = np.random.default_rng(9)
    counts = rng.integers(0, 4, (4, 8, 62)).astype(np.int32)
    prev = np.zeros((4, 8), np.float32)
    prev[:, [0, 2, 5, 7]] = 1.0
    prev_d = rng.random(4).astype(np.float32)
    avail = (rng.random((4, 8)) > 0.2).astype(np.float32) if with_avail \
        else None
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    perm, opt = selection.presample_keys(np.asarray(keys), 8)
    staged = (torch.as_tensor(perm), torch.as_tensor(opt.astype(np.int64)))
    p_real = torch.as_tensor(part.p_real)
    for do in (True, False):
        ref = jselection.select_or_keep(
            jnp.asarray(do), keys, jnp.asarray(counts), part.p_real, 4, 1,
            prev_mask=jnp.asarray(prev), prev_distance=jnp.asarray(prev_d),
            avail=None if avail is None else jnp.asarray(avail),
            max_iters=16)
        for k, d in ((np.asarray(keys), do), (staged, do),
                     (staged, torch.tensor(do))):
            out = selection.select_or_keep(
                d, k, torch.as_tensor(counts), p_real, 4, 1,
                prev_mask=torch.as_tensor(prev),
                prev_distance=torch.as_tensor(prev_d),
                avail=None if avail is None else torch.as_tensor(avail),
                max_iters=16)
            np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
            for o, r in zip(out[1:], ref[1:]):
                np.testing.assert_allclose(o.numpy(), np.asarray(r),
                                           atol=1e-6)
        if not do:
            np.testing.assert_array_equal(np.asarray(ref[0]), prev)


def test_reselect_trigger_device_predicate():
    mask = torch.zeros(2, 4)
    mask[:, :2] = 1.0
    up = torch.ones(2, 4)
    no = torch.zeros((), dtype=torch.bool)
    assert not bool(selection.reselect_trigger(no, mask, up, 2))
    assert bool(selection.reselect_trigger(no, mask, up, 3))   # under
    up[1, 1] = 0.0
    assert bool(selection.reselect_trigger(no, mask, up, 2))   # dark
    assert isinstance(selection.reselect_trigger(no, mask, up, 2),
                      torch.Tensor)


# ------------------------------------------------------------ the engines

@pytest.fixture(scope="module")
def model():
    jparams = jcnn.init_cnn(jax.random.PRNGKey(0), jcfg.smoke_config())
    return convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.mark.parametrize("schedule,every,robust", [
    ("redraw", 0, False), ("step_shift", 2, False), ("churn", 3, False),
    ("rotate", 2, True)], ids=["redraw-0", "step_shift-2", "churn-3",
                               "rotate-2-quarantine"])
def test_fused_matches_host_loop_under_drift(schedule, every, robust, part,
                                             model):
    """The fused round (drift trace staged with the keys, one pattern of
    rebuild and keep iterations per round) and the port's host loop over
    ``DeviceBackedStreams`` of the same drifting sampler take the same
    steps under the cadences N ∈ {0, 2, 3}: params bit-equal (to 1e-5 on
    the robust branch), the selection telemetry to 1e-6 and the rebuilds
    equal. The robust case folds quarantine into the cadence, where the
    keep iterations read the device predicate of ``reselect_trigger``."""
    sampler = make_device_sampler(
        DeviceStream.from_partition(part, batch_size=8, seed=0,
                                    device="cpu"),
        drift=DriftConfig(**_config(schedule)))
    extra = dict(robust_agg="trimmed_mean", quarantine_limit=1,
                 robust_clip=0.5) if robust else {}
    cfg = fedgs.FedGSConfig(**CFG, reselect_every=every, **extra)
    cfn = make_corruption_fn(CorruptionConfig(mode="scale", frac=0.4,
                                              prob=0.8), 0) if robust \
        else None
    kw = dict(group_loss_fn=cnn.make_group_loss_fn(), corrupt_fn=cfn)
    fused, flogs = fedgs.run_fedgs_fused(model, sampler, part.p_real, cfg,
                                         **kw)
    host, hlogs = fedgs.run_fedgs(model, DeviceBackedStreams(sampler),
                                  part.p_real, cfg, **kw)
    diff = max(float((a - b).abs().max()) for a, b in
               zip(tree.leaves(fused), tree.leaves(host), strict=True))
    assert diff <= (1e-5 if robust else 0.0)
    for f, h in zip(flogs, hlogs, strict=True):
        assert f.reselections == h.reselections
        for name in ("loss", "divergence", "group_discrepancy",
                     "selection_distance"):
            assert getattr(f, name) == pytest.approx(getattr(h, name),
                                                     abs=1e-5), name
    per_round = [int(f.reselections) for f in flogs]
    if not robust:
        assert per_round == [sum(fedgs.round_pattern(cfg, r))
                             for r in range(CFG["rounds"])]
    else:
        # quarantine forces rebuilds beyond the cadence's 3, 2, 3
        assert sum(per_round) > 8
