"""The availability layer of the port (DESIGN.md §14) against the JAX
package's, on the CPU: the three schedules' traces, the configs, the
staleness helpers, the fresh/stale split, the weighted and bounded
superbatch step, the all-dark committee, and both engines under
availability, alone and composed with the robust layer and the
compression.

Tolerances. The traces are bit-equal (threefry and compares in float32,
the comparison constants rounded to float32 as JAX rounds a Python float).
γ^s is ``torch.pow`` against XLA's ``pow``: held to 1e-6, as is the stale
mass S. One train step is held to 1e-5 against the JAX package's (the
blend g + (S/D)·ḡ may be contracted into one rounding by XLA and not by
PyTorch). Whole runs are held to ``RUN_TOL`` on the params: the CNN's
max-pool splits a tied window's gradient evenly, and where two identical
patches (the constant post-ReLU bias over a blank image region) are summed
by the two frameworks' GEMMs to values an ulp apart, the tie holds in one
and breaks in the other, so that window's gradient goes to different
inputs — both valid subgradients, ~1% of one group's step (measured
8.2e-5 on the params after 12 iterations of the bernoulli case, the loss
records within 4.5e-6). The port's two engines, whose code is one, are
held to each other bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import femnist_cnn as jcfg
from repro.core import fedgs as jfedgs
from repro.core import sync as jsync
from repro.data import AvailabilityConfig as JAvailabilityConfig
from repro.data import CorruptionConfig as JCorruptionConfig
from repro.data import DeviceBackedStreams as JDeviceBackedStreams
from repro.data import DeviceStream as JDeviceStream
from repro.data import make_availability_fn as jmake_availability_fn
from repro.data import make_corruption_fn as jmake_corruption_fn
from repro.data import make_device_sampler as jmake_device_sampler
from repro.models import cnn as jcnn
from repro_torch import convert, tree
from repro_torch.core import fedgs, sync
from repro_torch.data import (AVAILABILITY_SCHEDULES, AvailabilityConfig,
                              CorruptionConfig, DeviceBackedStreams,
                              DeviceStream, PartitionConfig,
                              make_availability_fn, make_corruption_fn,
                              make_device_sampler, make_partition)
from repro_torch.kernels import agg_weighted, avail
from repro_torch.models import cnn

SCHEDULES = ("bernoulli", "markov", "straggler_tail")
RUN_TOL = 2e-4
CFG = dict(num_groups=4, devices_per_group=8, num_selected=4,
           num_presampled=1, iters_per_round=4, rounds=3, lr=0.05,
           gbp_max_iters=16)
AVAIL = dict(up_prob=0.6, dwell=3, straggler_frac=0.3)
# the JAX package's engine matrix (tests/test_availability.py), plus blind
MATRIX = [("bernoulli", "sync", "aware"), ("markov", "bounded_async", "aware"),
          ("straggler_tail", "bounded_async", "aware"),
          ("markov", "sync", "blind")]
IDS = ["bernoulli-sync", "markov-bounded", "straggler-bounded",
       "markov-sync-blind"]


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


@pytest.fixture(scope="module")
def model():
    jparams = jcnn.init_cnn(jax.random.PRNGKey(0), jcfg.smoke_config())
    return jparams, convert.params_from_jax(
        jax.tree.map(np.asarray, jparams), "cpu")


def _max_diff(port, ref) -> float:
    return max(float(np.abs(port[a][b].numpy() - np.asarray(ref[a][b])).max())
               for a in ref for b in ref[a])


# ------------------------------------------------------------ the traces

@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedule_matches_reference(schedule):
    """Each schedule's (mask, latency) bit for bit against
    ``make_availability_fn``: the 32 dense ids and 60 shuffled ids up to
    2³¹ − 1, at t = 0..19 with ``horizon=8`` (the markov chain restarts at
    t = 8 and 16), and at t = 4,097 of the default horizon on the dense
    ids."""
    kw = dict(AVAIL, schedule=schedule, horizon=8)
    jfn = jax.jit(jmake_availability_fn(JAvailabilityConfig(**kw), 3, 32))
    fn = make_availability_fn(AvailabilityConfig(**kw), 3)
    rng = np.random.default_rng(1)
    big = rng.permutation(np.concatenate(
        [rng.integers(0, 2 ** 31 - 1, 58), [0, 2 ** 31 - 1]]))
    ups = 0.0
    for ids in (np.arange(32), big):
        for t in range(20):
            jm, jl = jfn(jnp.int32(t), jnp.asarray(ids, jnp.int32))
            m, lat = fn(t, torch.as_tensor(ids))
            np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
            np.testing.assert_array_equal(lat.numpy().view(np.uint32),
                                          np.asarray(jl).view(np.uint32))
            ups += float(m.sum())
    assert 0 < ups < 2 * 20 * 46          # neither all up nor all down
    kw["horizon"] = 4096
    jfn = jax.jit(jmake_availability_fn(JAvailabilityConfig(**kw), 3, 32))
    fn = make_availability_fn(AvailabilityConfig(**kw), 3)
    ids = np.arange(32)
    t = 4097
    jm, jl = jfn(jnp.int32(t), jnp.asarray(ids, jnp.int32))
    m, lat = fn(torch.tensor(t), torch.as_tensor(ids))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(lat.numpy(), np.asarray(jl))


def _compose(f, g):
    """The map g after the map f, each (f(0), f(1)) as bool tensors."""
    return (torch.where(f[0], g[1], g[0]), torch.where(f[1], g[1], g[0]))


def _compose_by_masks(maps):
    """The kernel's composition of a warp's (or the block's) maps in
    order: each is the identity, a flip or a constant; the last constant
    sets the state and the flips after it toggle it."""
    has = value = parity = torch.zeros_like(maps[0][0])
    for f0, f1 in maps:
        const = f0 == f1
        has, value = has | const, torch.where(const, f0, value)
        parity = torch.where(const, False, parity ^ (f0 & ~f1))
    return (torch.where(has, value ^ parity, parity),
            torch.where(has, value ^ parity, ~parity))


@pytest.mark.parametrize("t", [0, 1, 31, 32, 33, 257, 300])
def test_markov_step_partition_composes_to_the_chain(t):
    """The kernel's markov plan emulated on the CPU: each thread's steps
    (``avail.step_chunks``: the writer's warp below 32 steps, the step
    warps above) composed in order, the 32 lanes' maps of each warp and
    then the warps' maps by the kernel's rule (the last constant map, then
    the parity of the flips after it), applied to the initial state: equal
    to the plain version's serial chain, mask and latency bit for bit; the
    rule equals composing map by map."""
    fn = make_availability_fn(AvailabilityConfig(**AVAIL, schedule="markov"),
                              3)
    sched = fn.schedule
    ids = torch.tensor([0, 5, 77, 2 ** 31 - 1])
    base = avail.prng.fold_in_t(sched.key, ids)
    ident = (torch.zeros(4, dtype=torch.bool), torch.ones(4, dtype=torch.bool))
    us = avail._unit(avail.prng.fold_in_t(base, torch.arange(t + 1)[:, None]))
    maps = []
    for s0, s1 in avail.step_chunks(t):
        f = ident
        for u in us[s0:s1 + 1]:
            f = _compose(f, (u < float(sched.p_du), u >= float(sched.p_ud)))
        maps.append(f)
    assert sum(max(0, s1 - s0 + 1) for s0, s1 in avail.step_chunks(t)) == t
    warps = [_compose_by_masks(maps[w:w + 32])
             for w in range(0, len(maps), 32)]
    f = _compose_by_masks(warps)
    serial = ident
    for g in maps:
        serial = _compose(serial, g)
    assert all(torch.equal(a, b) for a, b in zip(f, serial))
    up = torch.where(us[0] < float(sched.prob), f[1], f[0])
    lat = avail._unit(avail.prng.fold_in_t(avail.prng.fold_in_t(
        sched.k_lat, ids), t), 0.5, 1.5)
    mask, ref_lat = avail.avail_rows_plain(ids, t, sched)
    assert torch.equal((up & (lat <= float(sched.deadline))).float(), mask)
    assert torch.equal(lat, ref_lat)


def test_availability_config_validates():
    for bad, word in ((dict(schedule="flaky"), "schedule"),
                      (dict(up_prob=0.0), "up_prob"),
                      (dict(dwell=0), "dwell"), (dict(horizon=0), "horizon"),
                      (dict(straggler_frac=1.5), "straggler_frac"),
                      (dict(slow_factor=0.5), "slow_factor"),
                      (dict(deadline=0.0), "deadline")):
        for cls in (AvailabilityConfig, JAvailabilityConfig):
            with pytest.raises(ValueError, match=word):
                cls(**bad)
    assert AVAILABILITY_SCHEDULES == ("always",) + SCHEDULES
    assert make_availability_fn(None, 0) is None
    assert make_availability_fn(AvailabilityConfig(), 0) is None
    assert avail.hashes("markov", 350, 4095) == 350 * (6 + 2 * 4095)
    with pytest.raises(ValueError, match="ids"):
        make_availability_fn(AvailabilityConfig("bernoulli"), 0)(
            0, torch.zeros(2, 2, dtype=torch.int64))


def test_fedgs_config_validates_sync():
    for bad, word in ((dict(sync="async"), "sync mode"),
                      (dict(sync="bounded_async", gamma=0.0), "gamma"),
                      (dict(sync="bounded_async", max_staleness=0),
                       "max_staleness"),
                      (dict(sync="bounded_async", train_step="model_avg"),
                       "grad_avg"),
                      (dict(avail_selection="oracle"), "avail_selection")):
        for cls in (fedgs.FedGSConfig, jfedgs.FedGSConfig):
            with pytest.raises(ValueError, match=word):
                cls(**bad)
    cfg = fedgs.FedGSConfig()
    assert (cfg.sync, cfg.gamma, cfg.max_staleness, cfg.avail_selection) \
        == ("sync", 0.5, 4, "aware")
    # gamma and the cap are only checked where they are used
    fedgs.FedGSConfig(gamma=0.0, max_staleness=0)


# ------------------------------------------------------------ staleness

def test_sync_helpers_match_reference():
    """γ^s (a negative clock clamped to 0, γ = 0.5, 0.7, 1), the clock's
    advance and saturation, and the written-out bounded-async Eq. 4."""
    s = np.array([[-3, 0, 1, 2, 4, 7]], np.int32)
    for gamma in (0.5, 0.7, 1.0):
        out = sync.staleness_weights(torch.as_tensor(s), gamma).numpy()
        ref = np.asarray(jsync.staleness_weights(jnp.asarray(s), gamma))
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
        assert out[0, 0] == 1.0
    contributed = np.array([[1, 0, 0, 1, 0, 0]], np.float32)
    out = sync.update_staleness(torch.as_tensor(s), torch.as_tensor(
        contributed), 4)
    np.testing.assert_array_equal(out.numpy(), np.asarray(
        jsync.update_staleness(jnp.asarray(s), jnp.asarray(contributed), 4)))
    assert out.dtype == torch.int32 and int(out.max()) == 4
    rng = np.random.default_rng(2)
    grads = {"a": rng.normal(size=(5, 3, 2)).astype(np.float32),
             "b": rng.normal(size=(5, 7)).astype(np.float32)}
    g_prev = {k: rng.normal(size=v.shape[1:]).astype(np.float32)
              for k, v in grads.items()}
    fresh = np.array([1, 0, 1, 0.5, 0], np.float32)
    stale = np.array([0, 0.25, 0, 0, 0.125], np.float32)
    ref = jsync.bounded_async_sync(grads, jnp.asarray(fresh), g_prev,
                                   jnp.asarray(stale))
    out = sync.bounded_async_sync(
        {k: torch.as_tensor(v) for k, v in grads.items()},
        torch.as_tensor(fresh), {k: torch.as_tensor(v)
                                 for k, v in g_prev.items()},
        torch.as_tensor(stale))
    for k in grads:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-6)


def test_avail_weights_match_reference():
    """The fresh/stale split of a committee against ``_avail_weights``:
    fresh weights in seating order, S, the clock, dark count and the
    staleness telemetry (γ = 0.7, clocks 0..4)."""
    rng = np.random.default_rng(4)
    m, k, l = 5, 9, 4
    mask = np.zeros((m, k), np.float32)
    for g in range(m):
        mask[g, rng.choice(k, l, replace=False)] = 1.0
    mask[4, :] = 0.0
    mask[4, :2] = 1.0                     # an under-strength committee
    up = (rng.random((m, k)) > 0.4).astype(np.float32)
    st = rng.integers(0, 5, (m, k)).astype(np.int32)
    kw = dict(num_groups=m, devices_per_group=k, num_selected=l,
              num_presampled=1, sync="bounded_async", gamma=0.7,
              max_staleness=4)
    ref = jfedgs._avail_weights(jnp.asarray(mask), jnp.asarray(up),
                                jnp.asarray(st), jfedgs.FedGSConfig(**kw))
    out = fedgs._avail_weights(torch.as_tensor(mask), torch.as_tensor(up),
                               torch.as_tensor(st), fedgs.FedGSConfig(**kw))
    for name in fedgs.AvailStep._fields:
        np.testing.assert_allclose(
            getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
            rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(out.staleness.numpy(),
                                  np.asarray(ref.staleness))
    assert float(out.stale_sum.sum()) > 0


# ------------------------------------------------------------ the step

def _cnn_batch(m, l, n, seed):
    p = jcnn.init_cnn(jax.random.PRNGKey(seed), jcfg.smoke_config())
    rng = np.random.default_rng(seed)
    gp = {layer: {k: (np.asarray(v)[None]
                      + rng.normal(0, 0.01, (m,) + v.shape)).astype(np.float32)
                  for k, v in lv.items()} for layer, lv in p.items()}
    x = rng.uniform(0, 1.5, (m, l, n, 28, 28)).astype(np.float32)
    y = rng.integers(0, 62, (m, l, n)).astype(np.int32)
    return gp, x, y


def _to_torch(gp):
    return convert.params_from_jax(gp, "cpu")


@pytest.mark.parametrize("bounded", [False, True], ids=["weighted", "bounded"])
def test_train_all_groups_matches_reference(bounded):
    """The weighted (``sync``) and bounded (``bounded_async``) superbatch
    step against JAX's ``_train_all_groups`` on the smoke CNN: a dark seat
    (weight 0), a whole dark committee, stale mass with a random ḡ."""
    m, l, n = 3, 3, 4
    gp, x, y = _cnn_batch(m, l, n, 5)
    w = np.array([[1, 0, 1], [1, 1, 1], [0, 0, 0]], np.float32)
    cfg_kw = dict(num_groups=m, num_selected=l, num_presampled=1, lr=0.05)
    jkw, kw = dict(weights=jnp.asarray(w)), dict(weights=torch.as_tensor(w))
    if bounded:
        cfg_kw.update(sync="bounded_async")
        rng = np.random.default_rng(6)
        gprev = jax.tree.map(
            lambda v: rng.normal(0, 0.1, v.shape).astype(np.float32), gp)
        s = np.array([0.25, 0.0, 0.75], np.float32)
        jkw.update(stale_sum=jnp.asarray(s), g_prev=gprev)
        kw.update(stale_sum=torch.as_tensor(s), g_prev=agg_weighted.flatten(
            _to_torch(gprev), m))
    ref = jfedgs._train_all_groups(
        jax.tree.map(jnp.asarray, gp), (jnp.asarray(x), jnp.asarray(y)),
        jcnn.make_group_loss_fn(), jfedgs.FedGSConfig(**cfg_kw), **jkw)
    out = fedgs._train_all_groups(
        _to_torch(gp), (torch.as_tensor(x), torch.as_tensor(y).long()),
        cnn.make_group_loss_fn(), fedgs.FedGSConfig(**cfg_kw), None, **kw)
    assert len(out) == len(ref) == (3 if bounded else 2)
    assert _max_diff(out[0], ref[0]) <= 1e-5
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]),
                               rtol=1e-5)
    if bounded:
        gflat = agg_weighted.flatten(_to_torch(
            jax.tree.map(np.asarray, ref[2])), m)
        assert float((out[2] - gflat).abs().max()) <= 1e-5
    else:                 # the dark committee keeps its params exactly
        for a in gp:
            for b in gp[a]:
                np.testing.assert_array_equal(out[0][a][b][2].numpy(),
                                              gp[a][b][2])


@pytest.mark.parametrize("step", ["grad_avg", "model_avg"])
def test_all_dark_group_keeps_its_params(step, part, model):
    """A committee that is dark for a whole run keeps the model it was
    given (group 0's flat ids < 8 are always down; the other groups are
    dark from t = 6 on): no NaN, and with every device dark the model is
    unchanged exactly, on both train steps and engines."""
    _, params = model
    sampler = make_device_sampler(DeviceStream.from_partition(
        part, batch_size=8, seed=0, device="cpu"))

    def blackout(t, ids):
        up = (ids >= 8).float() * float(int(t) < 6)
        return up, torch.ones_like(up)

    def all_dark(t, ids):
        return torch.zeros(ids.shape), torch.ones(ids.shape)

    cfg = fedgs.FedGSConfig(**CFG, train_step=step)
    kw = dict(group_loss_fn=cnn.make_group_loss_fn())
    out, logs = fedgs.run_fedgs_fused(params, sampler, part.p_real, cfg,
                                      avail_fn=blackout, **kw)
    assert all(bool(torch.isfinite(v).all()) for v in tree.leaves(out))
    assert all(np.isfinite(rec.loss) for rec in logs)
    for engine in ("host", "fused"):
        run = fedgs.run_fedgs if engine == "host" else fedgs.run_fedgs_fused
        data = DeviceBackedStreams(sampler) if engine == "host" else sampler
        frozen, logs = run(params, data, part.p_real, cfg, avail_fn=all_dark,
                           **kw)
        for a, b in zip(tree.leaves(frozen), tree.leaves(params)):
            assert torch.equal(a, b), engine
        assert all(rec.participation == 0.0 and rec.bytes_int == 0.0
                   for rec in logs)


# ------------------------------------------------------------ the engines

def _engines(part, params, cfg, av, cfn=None, jparams=None, jav=None,
             jcfn=None, jcfg_=None):
    """The port's host loop and fused engine over one sampler (and JAX's
    host loop over its own, when ``jparams`` is given)."""
    stream = DeviceStream.from_partition(part, batch_size=8, seed=0,
                                         device="cpu")
    sampler = make_device_sampler(stream)
    kw = dict(group_loss_fn=cnn.make_group_loss_fn(), avail_fn=av,
              corrupt_fn=cfn)
    fused = fedgs.run_fedgs_fused(params, sampler, part.p_real, cfg, **kw)
    host = fedgs.run_fedgs(params, DeviceBackedStreams(sampler),
                           part.p_real, cfg, **kw)
    ref = None
    if jparams is not None:
        jsampler = jmake_device_sampler(JDeviceStream.from_partition(
            part, batch_size=8, seed=0))
        robust = jcfn is not None or jcfg_.robust_agg != "mean"
        ref = jfedgs.run_fedgs(
            jparams, jcnn.loss_fn, JDeviceBackedStreams(jsampler),
            part.p_real, jcfg_, avail_fn=jav, corrupt_fn=jcfn,
            group_loss_fn=None if robust else jcnn.make_group_loss_fn())
    return host, fused, ref


FIELDS = ("loss", "divergence", "group_discrepancy", "selection_distance",
          "participation", "staleness_mean", "staleness_max")
COUNTS = ("reselections", "bytes_int", "bytes_ext", "corrupted_selected",
          "rollbacks", "dark_selected")


def _assert_records(out, ref, tol):
    for o, r in zip(out, ref, strict=True):
        o, r = o._asdict(), r._asdict()
        for name in FIELDS + COUNTS:
            if np.isnan(r[name]):
                assert np.isnan(o[name]), name
            elif name in COUNTS:
                assert o[name] == r[name], (name, o[name], r[name])
            else:
                assert abs(o[name] - r[name]) <= tol, (name, o, r)


@pytest.mark.parametrize("schedule,mode,sel", MATRIX, ids=IDS)
def test_engines_match_reference(schedule, mode, sel, part, model):
    """The JAX package's availability matrix (each schedule with one sync
    mode, cadence 2) plus blind selection: the port's host loop against
    JAX's ``run_fedgs`` (params to ``RUN_TOL``, records to 1e-5, the
    rebuilds, dark members and byte ledger equal), and the port's fused
    round against its host loop, bit for bit."""
    jparams, params = model
    kw = dict(CFG, reselect_every=2, avail_selection=sel)
    if mode == "bounded_async":
        kw.update(sync="bounded_async", gamma=0.5, max_staleness=3)
    acfg = dict(AVAIL, schedule=schedule)
    (hp, hl), (fp, fl), (rp, rl) = _engines(
        part, params, fedgs.FedGSConfig(**kw),
        make_availability_fn(AvailabilityConfig(**acfg), 0), None, jparams,
        jmake_availability_fn(JAvailabilityConfig(**acfg), 0, 32), None,
        jfedgs.FedGSConfig(**kw))
    assert _max_diff(hp, rp) <= RUN_TOL
    _assert_records(hl, rl, 1e-5)
    for a, b in zip(tree.leaves(fp), tree.leaves(hp), strict=True):
        assert torch.equal(a, b)
    _assert_records(fl, hl, 1e-6)
    assert all(0 < rec.participation < 1 for rec in hl)
    if mode == "bounded_async" or sel == "blind":
        assert sum(rec.dark_selected for rec in hl) > 0
    if mode == "bounded_async":
        assert max(rec.staleness_max for rec in hl) <= 3


@pytest.mark.parametrize("agg", ["trimmed_mean", "mean"])
def test_robust_compressed_composition_matches_reference(agg, part, model):
    """Blind selection under markov churn and ``bounded_async``, with
    faults (scale and NaN bursts, quarantine) and ``topk:0.1+int8`` on
    both links: the host loop against JAX's (params to ``RUN_TOL``,
    records to 1e-4, the rebuilds, dark members, faults seated, rollbacks
    and byte ledger equal), and the fused round against the host loop.
    The trimmed mean drops the NaN members; the mean lets them through,
    so the NaN guard rolls groups back, their ḡ, staleness clock and EF
    residual with them."""
    jparams, params = model
    kw = dict(CFG, reselect_every=2, avail_selection="blind",
              sync="bounded_async", gamma=0.5, max_staleness=3,
              robust_agg=agg, quarantine_limit=2,
              compress_int="topk:0.1+int8", compress_ext="int8")
    ckw = dict(mode="scale+nan_burst", frac=0.3, prob=0.7)
    acfg = dict(AVAIL, schedule="markov")
    (hp, hl), (fp, fl), (rp, rl) = _engines(
        part, params, fedgs.FedGSConfig(**kw),
        make_availability_fn(AvailabilityConfig(**acfg), 0),
        make_corruption_fn(CorruptionConfig(**ckw), 0), jparams,
        jmake_availability_fn(JAvailabilityConfig(**acfg), 0, 32),
        jmake_corruption_fn(JCorruptionConfig(**ckw), 0, 32),
        jfedgs.FedGSConfig(**kw))
    assert _max_diff(hp, rp) <= RUN_TOL
    _assert_records(hl, rl, 1e-4)
    assert sum(rec.corrupted_selected for rec in hl) > 0
    assert sum(rec.dark_selected for rec in hl) > 0
    assert (sum(rec.rollbacks for rec in hl) > 0) == (agg == "mean")
    for a, b in zip(tree.leaves(fp), tree.leaves(hp), strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    _assert_records(fl, hl, 1e-5)


@pytest.mark.parametrize("every", [1, 3])
def test_sync_at_full_availability_is_the_blind_path(every, part, model):
    """``sync='sync'`` with every device up (an ``avail_fn`` of ones) takes
    the steps of the run without availability bit for bit, at cadence 1
    and 3, on the fused engine (the JAX package's contract)."""
    _, params = model
    sampler = make_device_sampler(DeviceStream.from_partition(
        part, batch_size=8, seed=0, device="cpu"))
    cfg = fedgs.FedGSConfig(**CFG, reselect_every=every)
    kw = dict(group_loss_fn=cnn.make_group_loss_fn())
    blind, _ = fedgs.run_fedgs_fused(params, sampler, part.p_real, cfg, **kw)
    ones, logs = fedgs.run_fedgs_fused(
        params, sampler, part.p_real, cfg,
        avail_fn=lambda t, ids: (torch.ones(ids.shape),
                                 torch.ones(ids.shape)), **kw)
    for a, b in zip(tree.leaves(blind), tree.leaves(ones), strict=True):
        assert torch.equal(a, b)
    assert all(rec.participation == 1.0 and rec.dark_selected == 0.0
               for rec in logs)
