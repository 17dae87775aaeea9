"""The port's CUDA kernels against their plain versions, on the card.

Run on a machine with a CUDA card:  python -m pytest -m gpu tests/test_torch_gpu.py
Every test here skips without one.
"""
import pytest
import torch

from repro_torch import tree
from repro_torch.core import dispatch, gbp_cs as core_gbp
from repro_torch.kernels import (agg_weighted, conv_fused, corrupt, gbp_cs,
                                 robust_agg, ssd_scan, ssd_scan_bwd)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_gbp_cs_kernel_matches_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    for g, f, k, l_sel in ((4, 10, 20, 6), (10, 62, 33, 8), (3, 62, 7, 7)):
        A = torch.randint(0, 8, (g, f, k), generator=gen,
                          device=cuda).float()
        y = A.sum(-1) * (l_sel / k) + torch.rand(g, f, generator=gen,
                                                 device=cuda)
        for x0 in (core_gbp.init_mpinv(A, y, l_sel),
                   core_gbp.init_zero(A, y, l_sel)):
            x0 = x0.contiguous()
            out = gbp_cs.minimize(A, y, x0, 64)
            ref = gbp_cs.minimize_plain(A, y, x0, 64)
            assert torch.equal(out[0], ref[0])
            assert torch.equal(out[2], ref[2])
            torch.testing.assert_close(out[1], ref[1], rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(out[3], ref[3], rtol=1e-5, atol=1e-5)


def test_gbp_cs_warp_kernel_sweep(cuda):
    """The one-warp kernel against minimize_plain for F, K up to 64 (one
    and two rows/columns per lane, K = 33 as on the main path) and past
    the register-resident templates (K = 200, F = 150: the shared-memory
    form), masks and trip counts equal, distances to 1e-3 as in
    chip_smoke.py; among the groups one stops at its first step
    (y = A·x0, d = 0) and some hit ``max_iters``."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    stopped = capped = 0
    shapes = ((6, 62, 33, 8), (5, 64, 64, 20), (4, 31, 9, 4),
              (3, 33, 64, 30), (2, 1, 1, 1), (4, 64, 2, 1),
              (3, 62, 200, 30), (2, 150, 40, 10))
    for g, f, k, l_sel in shapes:
        A = torch.randint(0, 9, (g, f, k), generator=gen,
                          device=cuda).float()
        y = A.sum(-1) * (l_sel / k) + torch.rand(g, f, generator=gen,
                                                 device=cuda)
        x0 = core_gbp.init_zero(A, y, l_sel).contiguous()
        y[0] = (A[0] @ x0[0].unsqueeze(-1)).squeeze(-1)   # d = 0 at x0
        for max_iters in (0, 2, 64):
            out = gbp_cs.minimize(A, y, x0, max_iters)
            ref = gbp_cs.minimize_plain(A, y, x0, max_iters)
            assert torch.equal(out[0], ref[0])
            assert torch.equal(out[2], ref[2])
            torch.testing.assert_close(out[1], ref[1], rtol=0, atol=1e-3)
            torch.testing.assert_close(out[3], ref[3], rtol=0, atol=1e-3)
            if max_iters == 64:
                stopped += int(out[2][0] == 1)      # the d = 0 group
            elif max_iters == 2:
                capped += int((out[2] == 2).sum())
    assert stopped == len(shapes) and capped > 0


def _fused_graph_against_eager(cuda, corrupt_fn=None, drift=None,
                               iters=5, avail_fn=None, population=None,
                               **extra):
    """The smoke config's fused run eager and as one CUDA graph per round
    (per pattern of rebuild and keep iterations), R = 3 rounds of ``iters``
    iterations read back two at a time, the sampler drifting under
    ``drift``, over a lazy population of ``population`` devices a factory
    (committees of 8 redrawn at the config's cadence) if given:
    (eager, graphed) each as (state leaves, records), and the graphed
    run's round function."""
    from repro_torch import tree
    from repro_torch.configs import femnist_cnn
    from repro_torch.core import engine, fedgs, prng
    from repro_torch.data import (DeviceStream, LazyPopulation,
                                  PartitionConfig, PopulationConfig,
                                  make_device_sampler, make_partition)
    from repro_torch.models import cnn
    cfg = fedgs.FedGSConfig(num_groups=4, devices_per_group=8,
                            num_selected=4, num_presampled=1,
                            iters_per_round=iters, rounds=3, lr=0.05,
                            **extra)
    if population is None:
        part = make_partition(PartitionConfig(num_factories=4,
                                              devices_per_factory=8, seed=0))
        sampler = make_device_sampler(DeviceStream.from_partition(
            part, batch_size=8, seed=0, device=cuda), drift=drift)
    else:
        part = LazyPopulation(PopulationConfig(
            num_factories=4, devices_per_factory=population, batch_size=8),
            cuda)
        sampler = make_device_sampler(part, drift=drift, candidates=8,
                                      candidate_every=cfg.reselect_every)
    params = cnn.init_cnn(prng.PRNGKey(0), femnist_cnn.smoke_config(), cuda)
    runs = []
    for graph in (False, True):
        exp = fedgs.make_fedgs_experiment(
            params, sampler, part.p_real, cfg,
            group_loss_fn=cnn.make_group_loss_fn(), corrupt_fn=corrupt_fn,
            avail_fn=avail_fn, graph=graph)
        state, logs = engine.run_experiment(exp, cfg.rounds, chunk=2)
        runs.append((tree.leaves(state[0]) + list(state[1]), logs,
                     exp.round_fn))
    (eager, elogs, _), (graphed, glogs, rf) = runs
    for a, b in zip(eager, graphed, strict=True):
        assert torch.equal(a, b)
    assert [r.to_dict() for r in elogs] == [r.to_dict() for r in glogs]
    assert rf.replays == 3
    if cfg.reselect_every == 1:
        assert len(rf.segments.graphs) == iters + 1
    return elogs, rf


def test_fused_cadence_graph_replay_equals_eager(cuda):
    """Under ``--drift redraw --drift-period 2 --reselect-every 2`` at T = 3
    the rounds alternate two patterns, (rebuild, keep, rebuild) and (keep,
    rebuild, keep): one capture each, in its own memory pool, both
    replaying the eager run bit for bit; each capture counts one
    ``dirichlet_rows`` launch per iteration and one ``gbp_cs`` per
    rebuild, and has one graph segment more than it has rebuilds."""
    from repro_torch.data import DriftConfig
    logs, rf = _fused_graph_against_eager(
        cuda, drift=DriftConfig(schedule="redraw", period=2), iters=3,
        reselect_every=2)
    assert [r.reselections for r in logs] == [2.0, 1.0, 2.0]
    patterns = {(True, False, True): 2, (False, True, False): 1}
    assert set(rf.graphs) == set(patterns)
    for pattern, rebuilds in patterns.items():
        assert len(rf.graphs[pattern][0].graphs) == rebuilds + 1
        assert {k: v for k, v in rf.captures[pattern].items() if v} == {
            "gbp_cs": rebuilds, "conv_fused": 6, "agg_weighted": 1,
            "dirichlet_rows": 3}


@pytest.mark.parametrize("schedule", ["bernoulli", "markov",
                                      "straggler_tail"])
def test_avail_rows_kernel_matches_plain(cuda, schedule):
    """The availability trace against its plain version on the card, bit
    for bit: the 350 dense ids and 353 shuffled ids up to 2³¹ − 1, at t =
    0, 5 and 4,095 (the default horizon's longest chain) and past the
    wrap, t as an int and as a device tensor; one launch per call."""
    from repro_torch.data import AvailabilityConfig, make_availability_fn
    from repro_torch.kernels import avail
    fn = make_availability_fn(AvailabilityConfig(
        schedule=schedule, up_prob=0.6, straggler_frac=0.3), 0)
    gen = torch.Generator(device=cuda).manual_seed(1)
    big = torch.randint(0, 2 ** 31 - 1, (353,), generator=gen, device=cuda)
    for ids in (torch.arange(350, device=cuda), big):
        for t in (0, 5, 4095, 4096 + 7):
            dispatch.reset_launch_counts()
            mask, lat = fn(torch.tensor(t, device=cuda), ids)
            assert dispatch.launch_counts()["avail_rows"] == 1
            ref = avail.avail_rows_plain(ids.cpu(), t, fn.schedule)
            assert torch.equal(mask.cpu(), ref[0])
            assert torch.equal(lat.cpu(), ref[1])
            assert torch.equal(fn(t, ids)[0], mask)
    with pytest.raises(ValueError, match="ids"):
        fn(0, big.reshape(1, -1))


@pytest.mark.parametrize("r,horizon", [(1, 4096), (8, 7), (350, 4096),
                                       (1000, 4096)])
def test_avail_rows_kernel_steps_and_sizes(cuda, r, horizon):
    """Every schedule bit for bit at t ∈ {0, 1, 31, 32, 33, 4,095, 4,096}
    (the markov steps on one thread, one warp, and on every thread), a
    horizon of 7, R = 1, 8, 350 and 1,000 ids up to 2³¹ − 1."""
    from repro_torch.data import AvailabilityConfig, make_availability_fn
    from repro_torch.kernels import avail
    gen = torch.Generator(device=cuda).manual_seed(r)
    ids = torch.randint(0, 2 ** 31 - 1, (r,), generator=gen, device=cuda)
    ids[0] = 2 ** 31 - 1
    for schedule in avail.SCHEDULES:
        fn = make_availability_fn(AvailabilityConfig(
            schedule=schedule, up_prob=0.6, straggler_frac=0.3,
            horizon=horizon), 0)
        for t in (0, 1, 31, 32, 33, 4095, 4096):
            mask, lat = fn(torch.tensor(t, device=cuda), ids)
            ref = avail.avail_rows_plain(ids.cpu(), t, fn.schedule)
            assert torch.equal(mask.cpu(), ref[0])
            assert torch.equal(lat.cpu(), ref[1])


def test_fused_avail_graph_replay_equals_eager(cuda):
    """Markov churn under ``bounded_async`` with the robust layer and
    compression, cadence 2 (two patterns): the graphs replay the eager
    run bit for bit (the staleness clock and ḡ in the carry, t staged
    with the keys), and each capture counts one ``avail_rows`` launch per
    iteration."""
    from repro_torch.data import (AvailabilityConfig, CorruptionConfig,
                                  make_availability_fn, make_corruption_fn)
    afn = make_availability_fn(AvailabilityConfig(
        schedule="markov", up_prob=0.6, dwell=3), 0)
    cfn = make_corruption_fn(CorruptionConfig(mode="scale+nan_burst",
                                              frac=0.25), 0)
    logs, rf = _fused_graph_against_eager(
        cuda, cfn, iters=3, avail_fn=afn, reselect_every=2,
        sync="bounded_async", robust_agg="trimmed_mean",
        quarantine_limit=2, compress_int="topk:0.1+int8")
    assert all(0 < r.participation < 1 for r in logs)
    assert sum(r.dark_selected for r in logs) > 0
    for captured in rf.captures.values():
        assert captured["avail_rows"] == 3


@pytest.mark.parametrize("alpha,rows,f,drawn", [
    (0.3, 350, 62, True), (2.5, 353, 62, True), (0.1, 5, 62, True),
    (0.02, 350, 62, True), (0.3, 40, 1, True), (0.3, 40, 33, True),
    (0.3, 40, 64, True), (0.3, 40, 62, False)])
def test_dirichlet_rows_kernel_matches_plain(cuda, alpha, rows, f, drawn):
    """The Dirichlet redraw against its plain version on the card: α < 1
    (the boost) and α ≥ 1, α = 0.02 (elements that reject several outer
    passes), F = 1, 33, 64 (an empty upper warp, one upper element, a full
    row), drawn and rolled rows mixed (shifts 0 to F − 1) and a trace with
    no row drawn. Rolled rows are bit-equal; drawn rows are held to 1e-6
    (the kernel's logf/expf are the library calls PyTorch makes on the
    card, the plain softmax sums in the kernel's order; the erfinv's
    Horner steps round through double in the plain version); one launch
    per call."""
    from repro_torch.kernels import dirichlet
    gen = torch.Generator(device=cuda).manual_seed(
        rows if f == 62 else rows + f)
    base = torch.rand(rows, f, generator=gen, device=cuda)
    base = base / base.sum(-1, keepdim=True)
    trace = torch.stack([
        torch.randint(0, 62, (rows,), generator=gen, device=cuda),
        torch.randint(0, 2, (rows,), generator=gen, device=cuda),
        torch.randint(0, 2 ** 32, (rows,), generator=gen, device=cuda),
        torch.randint(0, 2 ** 32, (rows,), generator=gen, device=cuda)],
        dim=1)
    trace[:, 1] *= int(drawn)
    trace[0, 1] = int(drawn)
    dispatch.reset_launch_counts()
    out = dirichlet.drift_rows(base, trace, alpha)
    assert dispatch.launch_counts()["dirichlet_rows"] == 1
    ref = dirichlet.drift_rows_plain(base, trace, alpha)
    is_drawn = trace[:, 1] != 0
    assert torch.equal(out[~is_drawn], ref[~is_drawn])
    if drawn:
        assert float((out[is_drawn] - ref[is_drawn]).abs().max()) <= 1e-6
    torch.testing.assert_close(out.sum(-1), torch.ones(rows, device=cuda))
    with pytest.raises(ValueError, match="trace"):
        dirichlet.drift_rows(base, trace[:-1], alpha)


def _population_rows(cuda):
    """The population's rows of one full-width iteration: the 350 devices
    seated at t = 0 over 10 factories of 100,000 (committees of 35), their
    staged words as the kernel's trace and their factories' rows of the
    concentration table; and the table's build, the 10 factory priors at
    α = 1."""
    import numpy as np
    from repro_torch.core import prng
    from repro_torch.data import (LazyPopulation, PopulationConfig,
                                  make_device_sampler)
    pop = LazyPopulation(PopulationConfig(num_factories=10,
                                          devices_per_factory=100_000), cuda)
    staged = torch.as_tensor(make_device_sampler(
        pop, candidates=35, candidate_every=3).seats(0, np.arange(10)),
        device=cuda).reshape(-1, 5)
    prior = np.zeros((10, 4), np.int64)
    prior[:, 2:] = prng.fold_in(pop._k_prior, np.arange(10))
    return [(staged[:, 1:].contiguous(), pop.table[staged[:, 1]]),
            (torch.as_tensor(prior, device=cuda),
             torch.ones(10, 62, device=cuda))]


def test_dirichlet_rows_per_element_bit_equal_plain(cuda):
    """``dirichlet_rows`` with one concentration per element equals its
    plain version bit for bit: at (350, 62) with the population's
    concentrations, at (10, 62) with α = 1 (the table's priors), at F = 1,
    33 and 64 with concentrations from 0.02; and the drift's scalar path, a
    ``redraw`` trace at (350, 62), bit for bit too. One launch per call."""
    import numpy as np
    from repro_torch.data import DriftConfig, make_drift_fn
    from repro_torch.kernels import dirichlet
    for trace, alpha in _population_rows(cuda):
        dispatch.reset_launch_counts()
        out = dirichlet.draw_rows(trace, alpha)
        assert dispatch.launch_counts()["dirichlet_rows"] == 1
        assert torch.equal(out, dirichlet.drift_rows_plain(None, trace,
                                                           alpha))
    fn = make_drift_fn(DriftConfig(schedule="redraw", period=2), 0, 62)
    trace = fn.device_trace(2, np.arange(350), cuda)
    base = torch.full((350, 62), 1 / 62, device=cuda)
    assert torch.equal(dirichlet.drift_rows(base, trace, 0.3),
                       dirichlet.drift_rows_plain(base, trace, 0.3))
    # small concentrations (several outer passes) at F = 1, 33 and 64
    gen = torch.Generator(device=cuda).manual_seed(3)
    for f in (1, 33, 64):
        alpha = 0.02 + torch.rand(40, f, generator=gen, device=cuda)
        assert torch.equal(dirichlet.draw_rows(trace[:40], alpha),
                           dirichlet.drift_rows_plain(None, trace[:40], alpha))
    with pytest.raises(ValueError, match="float32"):
        dirichlet.draw_rows(trace, alpha.double())


def test_fused_population_graph_replay_equals_eager(cuda):
    """The fused round over a lazy population with candidate committees
    (8 of 1,000 devices a factory, redrawn every 2 iterations, the seats
    staged with the keys): the graphs replay the eager run bit for bit,
    and each capture counts one ``dirichlet_rows`` launch per iteration
    (the seated devices' rows)."""
    from repro_torch.data import AvailabilityConfig, make_availability_fn
    afn = make_availability_fn(AvailabilityConfig(schedule="markov",
                                                  up_prob=0.6), 0)
    logs, rf = _fused_graph_against_eager(cuda, iters=3, avail_fn=afn,
                                          population=1000, reselect_every=2)
    assert len(rf.graphs) == 2
    for captured in rf.captures.values():
        assert captured["dirichlet_rows"] == 3
        assert captured["avail_rows"] == 3


def test_fused_graph_replay_equals_eager(cuda):
    """The smoke config's fused run: one CUDA graph per round (T + 1
    segments around the eager pinv), replayed R times, gives the eager
    run's state and records bit for bit; the capture counted each kernel
    once per launch of one round."""
    _, rf = _fused_graph_against_eager(cuda, compress_int="topk:0.01+int8",
                                       compress_ext="int8")
    assert {k: v for k, v in rf.captured.items() if v} == {
        "gbp_cs": 5, "conv_fused": 10, "agg_weighted": 1,
        "topk_compress": 5, "int8_quant": 6}


def test_sharded_world1_equals_fused_on_card(cuda):
    """``--engine sharded`` without a process group is the one-shard mesh
    (DESIGN.md §8): no collective, so its graphed rounds are the fused
    engine's bit for bit, state and records, with the same captures."""
    from repro_torch import tree
    from repro_torch.configs import femnist_cnn
    from repro_torch.core import engine, fedgs, prng
    from repro_torch.data import (DeviceStream, PartitionConfig,
                                  make_device_sampler, make_partition)
    from repro_torch.models import cnn
    cfg = fedgs.FedGSConfig(num_groups=4, devices_per_group=8,
                            num_selected=4, num_presampled=1,
                            iters_per_round=5, rounds=3, lr=0.05)
    part = make_partition(PartitionConfig(num_factories=4,
                                          devices_per_factory=8, seed=0))
    sampler = make_device_sampler(DeviceStream.from_partition(
        part, batch_size=8, seed=0, device=cuda))
    params = cnn.init_cnn(prng.PRNGKey(0), femnist_cnn.smoke_config(), cuda)
    runs = []
    for mesh in (None, fedgs.make_group_mesh(4)):
        exp = fedgs.make_fedgs_experiment(
            params, sampler, part.p_real, cfg,
            group_loss_fn=cnn.make_group_loss_fn(), mesh=mesh, graph=True)
        state, logs = engine.run_experiment(exp, cfg.rounds, chunk=1)
        runs.append((tree.leaves(state[0]) + list(state[1]),
                     [r.to_dict() for r in logs], exp.round_fn.captured))
    (fused, flogs, fcap), (sharded, slogs, scap) = runs
    for a, b in zip(fused, sharded, strict=True):
        assert torch.equal(a, b)
    assert flogs == slogs and fcap == scap


def test_fused_robust_graph_replay_equals_eager(cuda):
    """The robust branch (DESIGN.md §15) of the fused round with noise in
    the mix and quarantine in the carry: the graph replays the eager run
    bit for bit, a corrupted member is seated, and the capture counts one
    ``corrupt_rows`` and one ``robust_agg`` launch per iteration and the
    residual's M ``agg_weighted`` launches beside the Eq. 5 one."""
    from repro_torch.data import CorruptionConfig, make_corruption_fn
    cfn = make_corruption_fn(CorruptionConfig(
        mode="scale+nan_burst+gauss_noise", frac=0.25), 0)
    logs, rf = _fused_graph_against_eager(
        cuda, cfn, robust_agg="trimmed_mean", quarantine_limit=2)
    assert sum(r.corrupted_selected for r in logs) > 0
    assert {k: v for k, v in rf.captured.items() if v} == {
        "gbp_cs": 5, "conv_fused": 10, "agg_weighted": 1 + 5 * 4,
        "robust_agg": 5, "corrupt_rows": 5}


@pytest.mark.parametrize("case", range(len(corrupt.SWEEP)))
def test_corrupt_rows_kernel_matches_plain(cuda, case):
    """The fault-injection kernel against its plain version on the sweep:
    NaN/Inf/scale/sign rows, untouched rows and the P4 pads bit-equal, the
    Gaussian rows to 2e-6·σ (log1pf and torch.log1p may differ by an ulp,
    and the plain erfinv rounds its Horner steps through double); one
    launch per call."""
    gen = torch.Generator(device=cuda).manual_seed(case)
    x, code, keys, sizes, modes = corrupt.sweep_inputs(corrupt.SWEEP[case],
                                                       gen)
    for sigma in (1.0, 0.25):
        dispatch.reset_launch_counts()
        out = corrupt.corrupt_rows(x.clone(), code, keys, sizes, modes, 25.0,
                                   sigma)
        assert dispatch.launch_counts()["corrupt_rows"] == 1
        ref = corrupt.corrupt_rows_plain(x.clone(), code, keys, sizes, modes,
                                         25.0, sigma)
        exact, err = corrupt.max_error(out, ref, code, modes, sigma)
        assert exact and err <= 2e-6
    with pytest.raises(ValueError):
        corrupt.corrupt_rows(x, code[:-1], keys, sizes, modes, 25.0, 1.0)


@pytest.mark.parametrize("g,b,h,cin,cout", [(10, 8, 28, 1, 32),
                                            (10, 8, 14, 32, 64),
                                            (1, 40, 28, 1, 32),
                                            (4, 4, 28, 1, 8),
                                            (4, 4, 14, 8, 16),
                                            (2, 8, 14, 8, 128),
                                            (3, 8, 14, 3, 36),
                                            (2, 3, 10, 4, 16),
                                            (3, 4, 7, 2, 32),
                                            (2, 3, 13, 4, 64),
                                            (1, 2, 130, 1, 8)])
def test_conv_kernel_matches_plain(cuda, g, b, h, cin, cout):
    """Both forms (the pool only on even dims): conv1/conv2 widths, C = 128
    (two column tiles), C = 36 (a part-empty one), Q not a multiple of 4
    (4-byte copies), R not a multiple of the row tile (R = 300 at W = 10),
    odd H = W, and 2W > 256 (a block of several row tiles)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.rand(g, b, h, h, cin, generator=gen, device=cuda)
    w = torch.randn(g, 25 * cin, cout, generator=gen, device=cuda) / 5
    bias = torch.randn(g, cout, generator=gen, device=cuda)
    pat = conv_fused.im2col(x, (5, 5))
    for pool in (True, False) if h % 2 == 0 else (False,):
        out, y = conv_fused.fused(pat, w, bias, h, pool=pool)
        out_p, y_p = conv_fused.fused_plain(pat, w, bias, h, pool=pool)
        torch.testing.assert_close(y, y_p, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(out, out_p, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="pool"):
        conv_fused.fused(pat, w, bias, h + 1)


def test_agg_kernel_matches_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    for k, p in ((1, 4), (10, 4096), (7, 1_000_004)):
        x = torch.randn(k, p, generator=gen, device=cuda)
        w = torch.rand(k, generator=gen, device=cuda)
        torch.testing.assert_close(agg_weighted.agg(x, w),
                                   agg_weighted.agg_plain(x, w),
                                   rtol=1e-5, atol=1e-6)


def test_weighted_average_tree_at_k100_matches_plain(cuda):
    """A baselines server average: K = 100 stacked client models (the
    smoke CNN's leaves and a leaf whose size pads P to a multiple of 4)
    through one kernel launch, against the same tree on the CPU (the plain
    version)."""
    from repro_torch.configs import femnist_cnn
    from repro_torch.core import prng
    from repro_torch.models import cnn
    gen = torch.Generator(device=cuda).manual_seed(4)
    params = cnn.init_cnn(prng.PRNGKey(0), femnist_cnn.smoke_config(), cuda)
    params["odd"] = torch.zeros(3, device=cuda)
    stack = {name: ({k: v[None] + torch.randn((100,) + tuple(v.shape),
                                               generator=gen, device=cuda)
                     for k, v in layer.items()} if isinstance(layer, dict)
                    else torch.randn(100, 3, generator=gen, device=cuda))
             for name, layer in params.items()}
    w = torch.rand(100, generator=gen, device=cuda)
    dispatch.reset_launch_counts()
    out = agg_weighted.weighted_average_tree(stack, w)
    assert dispatch.launch_counts()["agg_weighted"] == 1
    ref = agg_weighted.weighted_average_tree(
        tree.map(lambda v: v.cpu(), stack), w.cpu())
    for a, b in zip(tree.leaves(out), tree.leaves(ref), strict=True):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)


def _baseline_graph_against_eager(cuda, name):
    """The smoke CNN's fused baseline run (16 clients, 3 local steps, R =
    3 read back two at a time) eagerly and as one CUDA graph per round:
    (eager, graphed) each as (state leaves, records), and the graphed
    run's round function."""
    from repro_torch.configs import femnist_cnn
    from repro_torch.core import baselines, engine, prng
    from repro_torch.data import (DeviceStream, PartitionConfig,
                                  make_client_pool, make_partition)
    from repro_torch.models import cnn
    part = make_partition(PartitionConfig(num_factories=4,
                                          devices_per_factory=8, seed=0))
    pool = make_client_pool(DeviceStream.from_partition(
        part, batch_size=8, seed=0, device=cuda), 16, 3)
    model = cnn.make_model_api(femnist_cnn.smoke_config(), cuda)
    cfg = baselines.BaselineConfig(clients_per_round=16, local_steps=3,
                                   lr=0.05, rounds=3, seed=0)
    runs = []
    for graph in (False, True):
        exp = baselines.make_baseline_experiment(
            model, baselines.all_strategies(model)[name], pool, cfg,
            params=cnn.init_cnn(prng.PRNGKey(0), femnist_cnn.smoke_config(),
                                cuda), graph=graph)
        state, logs = engine.run_experiment(exp, cfg.rounds, chunk=2)
        runs.append((tree.leaves(state), logs, exp.round_fn))
    (eager, elogs, _), (graphed, glogs, rf) = runs
    for a, b in zip(eager, graphed, strict=True):
        assert torch.equal(a, b)
    assert [r.to_dict() for r in elogs] == [r.to_dict() for r in glogs]
    assert rf.replays == 3 and len(rf.segments.graphs) == 1
    return rf


@pytest.mark.parametrize("name", ["fedavg", "fedyogi"])
def test_baseline_graph_replay_equals_eager(cuda, name):
    """A baseline round captured as one CUDA graph (no segment break)
    replays its eager run bit for bit, FedYogi's server state and int32
    step count included; the capture counts one round: two grouped conv
    launches per local step and two for the last batch's accuracy, and
    one server average."""
    rf = _baseline_graph_against_eager(cuda, name)
    assert {k: v for k, v in rf.captured.items() if v} == {
        "conv_fused": 2 * 3 + 2, "agg_weighted": 1}


def test_wrappers_count_launches_and_check_inputs(cuda):
    dispatch.reset_launch_counts()
    agg_weighted.agg(torch.ones(2, 8, device=cuda),
                     torch.ones(2, device=cuda))
    assert dispatch.launch_counts()["agg_weighted"] == 1
    with pytest.raises(ValueError):
        agg_weighted.agg(torch.ones(2, 6, device=cuda),
                         torch.ones(2, device=cuda))
    with pytest.raises(ValueError):
        agg_weighted.agg(torch.ones(2, 8, device=cuda, dtype=torch.float64),
                         torch.ones(2, device=cuda))
    with pytest.raises(ValueError, match="boundary"):   # float4 loads
        agg_weighted.agg(torch.ones(17, device=cuda)[1:].reshape(2, 8),
                         torch.ones(2, device=cuda))
    assert dispatch.launch_counts()["agg_weighted"] == 1


@pytest.mark.parametrize("method", robust_agg.METHODS)
def test_robust_agg_kernel_matches_plain(cuda, method):
    """Medians are exact; trimmed sums run in ascending order in both, but
    the plain version's reduction may group them otherwise (a few ulps of
    the inputs)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    for m, k, p in ((1, 1, 5), (3, 7, 1000), (10, 10, 100_003), (2, 35, 517),
                    (2, 64, 300)):
        x = torch.randn(m, k, p, generator=gen, device=cuda)
        x[:, k // 2] = x[:, 0]                     # exact ties between rows
        active = (torch.rand(m, k, generator=gen, device=cuda) > 0.3).float()
        active[0] = 0.0                            # a group with n = 0
        for trim in (0, 1, 4, 40):
            out = robust_agg.aggregate(x, active, method, trim)
            ref = robust_agg.aggregate_plain(x, active, method, trim)
            if method == "coord_median":
                assert torch.equal(out, ref)
            else:
                torch.testing.assert_close(out, ref, rtol=0, atol=2e-6)
    with pytest.raises(ValueError, match="K <= 64"):
        robust_agg.aggregate(torch.ones(1, 65, 4, device=cuda),
                             torch.ones(1, 65, device=cuda), method)


def _tied_rows(gen, m, p, dev):
    """Gradient-like rows rounded to one decimal (long runs of exact ties,
    across every block boundary), with zeros and −0.0."""
    x = torch.round(torch.randn(m, p, generator=gen, device=dev) * 20) / 10
    x[:, ::7] = 0.0
    x[:, 3::11] = -0.0
    return x


@pytest.mark.parametrize("m,p", [(1, 4), (3, 1000), (10, 100_004),
                                 (2, 1_048_576)])
def test_topk_kernel_matches_plain(cuda, m, p):
    """The exact kept set: k at 1, inside a run of ties, mid-vector, P − 1
    and P; a row of equal magnitudes (every coordinate a tie)."""
    from repro_torch.kernels import topk_compress
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = _tied_rows(gen, m, p, cuda)
    x[-1] = torch.where(torch.arange(p, device=cuda) % 2 == 0, 1.5, -1.5)
    for k in sorted({1, 2, max(1, p // 100), p // 2, p - 1, p}):
        out = topk_compress.select(x, k)
        ref = topk_compress.select_plain(x, k)
        assert torch.equal(out, ref), k
        assert torch.equal(torch.signbit(out), torch.signbit(ref))


def test_topk_kernel_overflow_route_is_exact(cuda):
    """Rows of one magnitude with a few larger values put nearly every
    coordinate in τ's top bin: more than the candidate buffer holds, so
    they take the overflow route (the kernel's per-row record says so),
    while an ordinary row keeps the candidate route; all bit-equal."""
    from repro_torch.kernels import topk_compress
    gen = torch.Generator(device=cuda).manual_seed(7)
    m, p = 3, 200_000
    x = _tied_rows(gen, m, p, cuda)
    x[0] = torch.where(torch.arange(p, device=cuda) % 5 == 0, -0.75, 0.75)
    x[0, 11::9973] = 3.0
    x[1] = -2.5
    x[1, 4::50_000] = 4.0
    cap = topk_compress.candidate_capacity(p)
    assert p > cap
    # k <= 3: τ is a larger value (few candidates); else the common one
    for k, route in ((3, 1), (25, 0), (1000, 0), (p - 1, 0)):
        out, stats = topk_compress.select_with_stats(x, k)
        assert torch.equal(out, topk_compress.select_plain(x, k)), k
        assert torch.equal(torch.signbit(out),
                           torch.signbit(topk_compress.select_plain(x, k)))
        cands, routes = stats[:, 2].tolist(), stats[:, 3].tolist()
        assert routes[:2] == [route, route], (k, cands, routes)
        assert routes[2] == int(cands[2] <= cap), (k, cands, routes)
    assert routes == [0, 0, 0] and cands[:2] == [p - 21, p - 4]
    _, stats = topk_compress.select_with_stats(x, 1000)
    assert stats[:, 3].tolist() == [0, 0, 1]


def test_topk_kernel_nonfinite_row_leaves_others_exact(cuda):
    from repro_torch.kernels import topk_compress
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = _tied_rows(gen, 4, 40_000, cuda)
    x[1, 7] = float("nan")
    x[1, 99] = float("inf")
    x[1, 1000] = -float("inf")
    out = topk_compress.select(x, 400)
    ref = topk_compress.select_plain(x, 400)
    rows = [0, 2, 3]
    assert torch.equal(out[rows], ref[rows])
    assert int((out[1] != 0).sum()) <= 400


def test_int8_kernel_bit_equal_plain(cuda):
    """Every row under its own key, bit for bit; a zero row, a row of
    tiny values, and a NaN row (NaN everywhere, as in the plain form)."""
    import numpy as np

    from repro_torch.core import prng
    from repro_torch.kernels import int8_quant
    gen = torch.Generator(device=cuda).manual_seed(6)
    for m, p in ((1, 4), (5, 1000), (10, 400_000)):
        x = torch.randn(m, p, generator=gen, device=cuda)
        x[0, ::3] = 0.0
        if m > 2:
            x[1] = 0.0
            x[2] *= 1e-20
        keys = prng.split(prng.PRNGKey(m), m)
        out = int8_quant.quantize(x, keys)
        ref = int8_quant.quantize_plain(x, keys)
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
        x[-1, p // 2] = float("nan")
        out = int8_quant.quantize(x, keys)
        assert torch.isnan(out[-1]).all()
        assert torch.equal(out[:-1], int8_quant.quantize_plain(x[:-1],
                                                               keys[:-1]))
    with pytest.raises(ValueError):
        int8_quant.quantize(torch.ones(2, 6, device=cuda),
                            np.zeros((2, 2), np.uint32))


def _int8_bits_equal(x, keys, nan_rows=()):
    from repro_torch.kernels import int8_quant
    dispatch.reset_launch_counts()
    out = int8_quant.quantize(x, keys)
    assert dispatch.launch_counts()["int8_quant"] == 1
    ref = int8_quant.quantize_plain(x, keys)
    rows = [r for r in range(x.shape[0]) if r not in nan_rows]
    assert torch.equal(out[rows].view(torch.int32),
                       ref[rows].view(torch.int32))
    for r in nan_rows:                   # the card's NaN bits are its own
        assert torch.isnan(out[r]).all() and torch.isnan(ref[r]).all()
    return out


@pytest.mark.parametrize("density", [0.01, 0.001])
def test_int8_kernel_on_topk_rows(cuda, density):
    """The internal link's input: top-k rows of the CNN's (10, 6,603,712)
    gradient buffer at 1% and 0.1% density, bit for bit, twice (the row
    barrier's scratch is zeroed by each call)."""
    from repro_torch.core import prng
    from repro_torch.kernels import topk_compress
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(10, 6_603_712, generator=gen, device=cuda) ** 3
    x = topk_compress.select(x, int(density * 6_603_710))
    keys = prng.split(prng.PRNGKey(5), 10)
    assert torch.equal(_int8_bits_equal(x, keys), _int8_bits_equal(x, keys))


@pytest.mark.parametrize("m,p", [(1, 4), (3, 4 * 1237), (2, 4 * 2_000_003),
                                 (2, 8_000_000)])
def test_int8_kernel_edges_and_shapes(cuda, m, p):
    """Rows with −0.0, exact integers after scaling (max 127: scale 1),
    an inf (the whole row NaN) and a NaN, at M = 1, P = 4, a P that leaves
    a partial tile, and P past the blocks' shared memory (8,000,000: each
    slice's tail is read from device memory twice); a dense row beside
    them takes the in-place path. Bit-equal to the plain version, the NaN
    rows NaN."""
    from repro_torch.core import prng
    gen = torch.Generator(device=cuda).manual_seed(p)
    x = torch.randn(m, p, generator=gen, device=cuda)
    nan_rows = ()
    if p >= 4 * 1237:
        x[0, :300] = torch.randint(-127, 128, (300,), generator=gen,
                                   device=cuda).float()
        x[0, 0], x[0, 300:700] = 127.0, -0.0
        x[0, 700:1100] = 0.0
        x[1, 5], x[1, 7:40], x[1, 50:60] = float("inf"), 0.0, -0.0
        nan_rows = (1,)
        if m > 2:
            x[2, 9], x[2, 100:200] = float("nan"), -0.0
            nan_rows = (1, 2)
    else:
        x[0, :2] = torch.tensor([-0.0, 127.0])
    _int8_bits_equal(x, prng.split(prng.PRNGKey(m), m), nan_rows)


def test_compress_wrappers_count_launches(cuda):
    """One EF event on three rows: one call of each kernel; e' = x − y."""
    import numpy as np

    from repro_torch.core import compress
    dispatch.reset_launch_counts()
    spec = compress.parse_compress("topk:0.1+int8")
    g = torch.randn(3, 1000, device=cuda)
    keys = np.arange(6, dtype=np.uint32).reshape(3, 2)
    y, e, _ = compress.ef_compress_rows(g, torch.zeros_like(g), 999, spec,
                                          keys)
    assert torch.equal(e, g - y)
    counts = dispatch.launch_counts()
    assert counts["topk_compress"] == 1 and counts["int8_quant"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,s,d", [(1, 4, 4, 256, 64), (2, 8, 2, 128, 32),
                                        (1, 4, 1, 256, 128),
                                        (1, 8, 2, 1024, 64),
                                        (1, 4, 4, 256, 112),
                                        (1, 8, 2, 512, 112),
                                        (1, 4, 4, 1024, 112),
                                        (1, 2, 1, 192, 112)])
def test_flash_attention_kernel_matches_plain(cuda, b, h, kv, s, d, dtype):
    """The JAX package's sweep (and longer sequences, whose window skips
    whole kv tiles), causal / window 96 / non-causal, at the sweep's
    tolerances; q read through a transposed view (strides, no copy); at
    D = 112 (128-row q tiles) GQA, MHA and a q tile of 64 valid rows."""
    from repro_torch.kernels import flash_attention
    gen = torch.Generator(device=cuda).manual_seed(b * 100 + h)
    q = torch.randn(b, h, s, d, generator=gen, device=cuda).to(dtype)
    q = q.transpose(1, 2)                       # (B, S, H, D), not contiguous
    k, v = (torch.randn(b, s, kv, d, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    blk = 128 if s % 128 == 0 else 64
    for causal, window in ((True, None), (True, 96), (False, None)):
        out = flash_attention.flash_attention(q, k, v, causal=causal,
                                              window=window, block_q=blk,
                                              block_k=blk)
        ref = flash_attention.attention_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window).transpose(1, 2)
        assert out.dtype == dtype and out.shape == q.shape
        err = float((out.float() - ref.float()).abs().max())
        assert err < tol, (causal, window, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,s,d,dv", [(2, 8, 8, 128, 48, 32),
                                           (1, 4, 2, 256, 48, 32),
                                           (1, 4, 4, 256, 192, 128),
                                           (1, 2, 1, 192, 192, 128),
                                           (1, 2, 2, 1024, 192, 128)])
def test_flash_attention_mla_pairs_match_plain(cuda, b, h, kv, s, d, dv,
                                               dtype):
    """MLA's head dims, q/k of D = hd + dr and v of Dv = hd (deepseek's
    smoke config and full width; at (192, 128) in f32 the kernel keeps
    one V buffer), causal / window 96 / non-causal, at the sweep's
    tolerances; the output is (B, S, H, Dv)."""
    from repro_torch.kernels import flash_attention
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    q = torch.randn(b, s, h, d, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, s, kv, d, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, s, kv, dv, generator=gen, device=cuda).to(dtype)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    blk = 128 if s % 128 == 0 else 64
    for causal, window in ((True, None), (True, 96), (False, None)):
        out = flash_attention.flash_attention(q, k, v, causal=causal,
                                              window=window, block_q=blk,
                                              block_k=blk)
        ref = flash_attention.attention_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window).transpose(1, 2)
        assert out.dtype == dtype and out.shape == (b, s, h, dv)
        err = float((out.float() - ref.float()).abs().max())
        assert err < tol, (causal, window, err)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention.flash_attention(q, k, q, block_q=blk, block_k=blk)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "dbrx-132b"])
def test_moe_prefill_on_card_matches_cpu(cuda, arch):
    """The MoE smoke configs: one flash launch per layer (MLA at (48, 32),
    dbrx at 32), the dispatch form's atomics within 1e-4 of the CPU's
    logits, the aux loss within 1e-5."""
    from repro_torch import configs, convert
    from repro_torch.core import prng
    from repro_torch.models import transformer
    cfg = configs.get_smoke_config(arch)
    params = transformer.init_lm(cfg, prng.PRNGKey(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 128),
                         generator=torch.Generator().manual_seed(0))
    ref, ref_aux = transformer.forward(cfg, params, toks, attn_impl="pallas")
    gp = convert.params_from_jax(convert.params_to_numpy(params), cuda)
    dispatch.reset_launch_counts()
    out, aux = transformer.forward(cfg, gp, toks.to(cuda),
                                   attn_impl="pallas")
    assert dispatch.launch_counts()["flash_attention"] == cfg.num_layers
    assert float((out.cpu() - ref).abs().max()) < 1e-4
    assert abs(float(aux) - float(ref_aux)) < 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk", [(128, 512), (512, 128)])
@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_flash_attention_cross_shape_matches_plain(cuda, sq, sk, h, kv,
                                                   dtype):
    """The enc-dec cross-attention form: non-causal q of Sq rows over
    Sk != Sq keys at D = 64 (whisper's 1280 / 20), at the sweep's
    tolerances; a causal or windowed call at Sq != Sk is refused."""
    from repro_torch.kernels import flash_attention
    gen = torch.Generator(device=cuda).manual_seed(sq + 3 * sk + h)
    q = torch.randn(2, sq, h, 64, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(2, sk, kv, 64, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    out = flash_attention.flash_attention(q, k, v, causal=False)
    ref = flash_attention.attention_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=False).transpose(1, 2)
    assert out.dtype == dtype and out.shape == q.shape
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    assert float((out.float() - ref.float()).abs().max()) < tol
    for causal, window in ((True, None), (False, 64)):
        with pytest.raises(ValueError, match="takes no mask"):
            flash_attention.flash_attention(q, k, v, causal=causal,
                                            window=window)


def test_vlm_prefill_on_card_matches_cpu(cuda):
    """internvl2-26b's smoke config with a 32-embedding vision prefix and
    96 tokens (128 positions): one flash launch a layer, the text logits
    within 1e-4 of the CPU's."""
    from repro_torch import configs, convert
    from repro_torch.core import prng
    from repro_torch.models import transformer
    cfg = configs.get_smoke_config("internvl2-26b")
    params = transformer.init_lm(cfg, prng.PRNGKey(0), "cpu")
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 96), generator=gen)
    vis = torch.randn(2, 32, cfg.d_model, generator=gen) * 0.02
    ref, _ = transformer.forward(cfg, params, toks, prefix_embeds=vis,
                                 attn_impl="pallas")
    gp = convert.params_from_jax(convert.params_to_numpy(params), cuda)
    dispatch.reset_launch_counts()
    out, _ = transformer.forward(cfg, gp, toks.to(cuda),
                                 prefix_embeds=vis.to(cuda),
                                 attn_impl="pallas")
    assert dispatch.launch_counts()["flash_attention"] == cfg.num_layers
    assert out.shape == (2, 96, cfg.padded_vocab)
    assert float((out.cpu() - ref).abs().max()) < 1e-4


def test_encdec_on_card_matches_cpu(cuda):
    """whisper-large-v3's smoke config: 256 frames, 128 tokens; three flash
    launches a layer pair (encoder, decoder self, cross at Sq != Sk), the
    logits and 4 decode steps within 1e-4 of the CPU's."""
    from repro_torch import configs, convert
    from repro_torch.core import prng
    from repro_torch.models import encdec
    cfg = configs.get_smoke_config("whisper-large-v3")
    params = encdec.init_encdec(cfg, prng.PRNGKey(0), "cpu")
    gen = torch.Generator().manual_seed(0)
    batch = {"encoder_frames": torch.randn(2, 256, cfg.d_model,
                                           generator=gen) * 0.02,
             "tokens": torch.randint(0, cfg.vocab_size, (2, 128),
                                     generator=gen)}
    gp = convert.params_from_jax(convert.params_to_numpy(params), cuda)
    gb = {k: v.to(cuda) for k, v in batch.items()}
    ref = encdec.forward(cfg, params, batch, attn_impl="pallas")
    dispatch.reset_launch_counts()
    out = encdec.forward(cfg, gp, gb, attn_impl="pallas")
    assert dispatch.launch_counts()["flash_attention"] == 3 * cfg.num_layers
    assert float((out.cpu() - ref).abs().max()) < 1e-4
    for p, b, dev in ((params, batch, "cpu"), (gp, gb, cuda)):
        enc = encdec.encode(cfg, p, b["encoder_frames"])
        cache = encdec.prefill_cross_cache(
            cfg, p, encdec.init_decode_cache(cfg, 2, 8, enc_len=256,
                                             device=dev), enc)
        steps = [encdec.decode_step(cfg, p, cache, b["tokens"][:, i:i + 1],
                                    i)[0].cpu() for i in range(4)]
        if dev == "cpu":
            ref_steps = steps
    for a, r in zip(steps, ref_steps):
        assert float((a - r).abs().max()) < 1e-4


def test_flash_attention_launches_once_per_layer(cuda):
    """One kernel launch per layer per forward, none per decode step."""
    from repro_torch import configs
    from repro_torch.models import build
    cfg = configs.get_config("granite-3-2b").with_(num_layers=2)
    fns = build(cfg)
    params = fns.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    toks = torch.randint(0, cfg.vocab_size, (1, 256), device=cuda)
    dispatch.reset_launch_counts()
    logits = fns.forward(params, {"tokens": toks}, attn_impl="pallas")
    assert dispatch.launch_counts()["flash_attention"] == cfg.num_layers
    assert torch.isfinite(logits).all()
    cache = fns.init_decode_cache(1, 8, device=cuda)
    fns.decode_step(params, cache, toks[:, :1], 0)
    assert dispatch.launch_counts()["flash_attention"] == cfg.num_layers
    with pytest.raises(ValueError, match="multiples"):
        fns.forward(params, {"tokens": toks[:, :100]}, attn_impl="pallas")


def _ssd_inputs(gen, bt, s, h, p, n):
    """The kernel module's inputs, with decays A = -exp(0.3 z) that are not
    the model's integers."""
    A = -torch.exp(0.3 * torch.randn(h, generator=gen, device=gen.device))
    return ssd_scan.example_inputs(gen, bt, s, h, p, n, A)


@pytest.mark.parametrize("bt,s,h,p,n,chunk", ssd_scan.SWEEP)
def test_ssd_scan_kernel_matches_plain(cuda, bt, s, h, p, n, chunk):
    """To 1e-4 · max(1, max |y|), the tolerance of chip_smoke.py."""
    gen = torch.Generator(device=cuda).manual_seed(s + h + n)
    x, dt, A, B, C = _ssd_inputs(gen, bt, s, h, p, n)
    dispatch.reset_launch_counts()
    y = ssd_scan.ssd_scan(x, dt, A, B, C, chunk=chunk)
    assert dispatch.launch_counts()["ssd_scan"] == 1
    ref = ssd_scan.ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    assert y.shape == ref.shape and torch.isfinite(y).all()
    err = float((y - ref).abs().max())
    assert err <= 1e-4 * max(1.0, float(ref.abs().max())), err


def test_ssd_scan_kernel_slow_decay(cuda):
    """A near 0: the states barely decay across 32 chunks, so every
    chunk's output leans on the carried state."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    A = -1e-4 * torch.rand(3, generator=gen, device=cuda)
    x, dt, A, B, C = ssd_scan.example_inputs(gen, 2, 4096, 3, 64, 64, A)
    y = ssd_scan.ssd_scan(x, dt, A, B, C, chunk=128)
    ref = ssd_scan.ssd_scan_plain(x, dt, A, B, C, chunk=128)
    err = float((y - ref).abs().max())
    assert err <= 1e-4 * max(1.0, float(ref.abs().max())), err


def test_ssd_scan_launches_compose(cuda):
    """The four launches run one at a time, in order, give the one-call
    result bit for bit; N = 102 is padded to 104 for the kernel."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    x, dt, A, B, C = _ssd_inputs(gen, 2, 512, 3, 32, 102)
    call = ssd_scan.prepare(x, dt, A, B, C, 128)
    assert call["n"] == 104 and call["B"].shape[-1] == 104
    for i in range(len(ssd_scan.PARTS)):
        ssd_scan.run(call, 1 << i)
    y = ssd_scan.ssd_scan(x, dt, A, B, C, chunk=128)
    assert torch.equal(call["y"], y)


def test_ssd_scan_wrapper_checks_its_inputs(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x, dt, A, B, C = _ssd_inputs(gen, 1, 192, 2, 32, 16)
    with pytest.raises(ValueError, match="multiple"):
        ssd_scan.ssd_scan(x, dt, A, B, C, chunk=128)
    with pytest.raises(ValueError, match="unsupported"):
        ssd_scan.ssd_scan(x, dt, A, B, C, chunk=192)
    x2, dt2, A2, B2, C2 = _ssd_inputs(gen, 1, 128, 2, 16, 16)
    with pytest.raises(ValueError, match="unsupported"):
        ssd_scan.ssd_scan(x2, dt2, A2, B2, C2)
    with pytest.raises(ValueError, match="float32"):
        ssd_scan.ssd_scan(x[:, :128].double(), dt[:, :128], A, B[:, :128],
                          C[:, :128])


def test_mamba_forward_launches_the_scan_once(cuda):
    """One launch per Mamba2 block without a state; none with one."""
    from repro_torch import configs
    from repro_torch.models import ssm
    cfg = configs.get_smoke_config("mamba2-780m")
    p = ssm.init_mamba_block(torch.Generator(device=cuda).manual_seed(0),
                             cfg, cuda)
    x = torch.randn(2, 256, cfg.d_model, device=cuda)
    dispatch.reset_launch_counts()
    out = ssm.mamba_forward(p, x, cfg)
    assert dispatch.launch_counts()["ssd_scan"] == 1
    ref, _ = ssm.mamba_forward(p, x, cfg, return_state=True)
    assert dispatch.launch_counts()["ssd_scan"] == 1
    err = float((out - ref).abs().max())
    assert err <= 1e-4 * max(1.0, float(ref.abs().max())), err


@pytest.mark.parametrize("bt,s,h,p,n,chunk", ssd_scan.SWEEP)
def test_ssd_scan_backward_matches_plain(cuda, bt, s, h, p, n, chunk):
    """dx, ddt, dA, dB and dC of the scan's autograd function (one
    forward and one ``csrc/ssd_scan_bwd.cu`` launch) to 1e-4 · max(1, max
    |ref|) of autograd through the plain version in float64, the
    tolerance of chip_smoke.py (the f32 plain version is itself up to
    ~1e-4 off that at the full-width shapes)."""
    gen = torch.Generator(device=cuda).manual_seed(s + h + n + 1)
    args = _ssd_inputs(gen, bt, s, h, p, n)
    dy = torch.randn(args[0].shape, generator=gen, device=cuda)
    ins = [t.detach().requires_grad_(True) for t in args]
    chunk = min(chunk, s)
    dispatch.reset_launch_counts()
    out = torch.autograd.grad(ssd_scan.ssd_scan(*ins, chunk=chunk), ins, dy)
    counts = dispatch.launch_counts()
    assert counts["ssd_scan"] == 1 and counts["ssd_scan_bwd"] == 1
    ref = ssd_scan_bwd.backward_plain(*(t.double() for t in args),
                                      dy.double(), chunk=chunk)
    for g, r, t in zip(out, ref, args):
        assert g.shape == t.shape and torch.isfinite(g).all()
        err = float((g.double() - r).abs().max())
        assert err <= 1e-4 * max(1.0, float(r.abs().max())), err


@pytest.mark.parametrize("bt,s,h,p,n,chunk", ssd_scan_bwd.EDGES)
def test_ssd_scan_backward_head_group_edges(cuda, bt, s, h, p, n, chunk):
    """The backward where its head groups do not divide H (``EDGES``), to
    1e-4 · max(1, max |ref|) of autograd through the float64 plain
    version, as on the sweep."""
    gen = torch.Generator(device=cuda).manual_seed(s + h + n + 2)
    args = _ssd_inputs(gen, bt, s, h, p, n)
    dy = torch.randn(args[0].shape, generator=gen, device=cuda)
    ins = [t.detach().requires_grad_(True) for t in args]
    lay = ssd_scan_bwd.plan(bt, s, h, p, n, chunk)
    assert h % lay["hg"] and h % lay["hk"]
    out = torch.autograd.grad(ssd_scan.ssd_scan(*ins, chunk=chunk), ins, dy)
    ref = ssd_scan_bwd.backward_plain(*(t.double() for t in args),
                                      dy.double(), chunk=chunk)
    for g, r in zip(out, ref):
        err = float((g.double() - r).abs().max())
        assert err <= 1e-4 * max(1.0, float(r.abs().max())), err


def test_ssd_scan_backward_same_bits(cuda):
    """Two backward calls on the same inputs give bit-equal dx, ddt, dA, dB
    and dC: every sum is taken in a fixed order (mamba2-780m's head and
    state widths, two groups of heads in each grouped launch)."""
    gen = torch.Generator(device=cuda).manual_seed(29)
    x, dt, A, B, C = _ssd_inputs(gen, 2, 1024, 48, 64, 128)
    dy = torch.randn(x.shape, generator=gen, device=cuda)
    call = ssd_scan.prepare(x, dt, A, B, C, 128)
    ssd_scan.run(call)
    args = (call["x"], dt, A, call["B"], call["C"], call["states"], dy, 128)
    first = [g.clone() for g in ssd_scan_bwd.backward(*args)]
    second = ssd_scan_bwd.backward(*args)
    lay = ssd_scan_bwd.plan(2, 1024, 48, 64, 128, 128)
    assert lay["groups_gram"] > 1 and lay["groups_dbc"] > 1
    for a, b in zip(first, second):
        assert torch.isfinite(a).all() and torch.equal(a, b)


def test_flash_attention_refuses_under_grad_on_card(cuda):
    from repro_torch.kernels import flash_attention as fa
    q = torch.randn(1, 128, 2, 32, device=cuda, requires_grad=True)
    k = torch.randn(1, 128, 1, 32, device=cuda)
    dispatch.reset_launch_counts()
    with pytest.raises(RuntimeError, match="attn_impl='auto'"):
        fa.flash_attention(q, k, k)
    assert dispatch.launch_counts()["flash_attention"] == 0
    with torch.no_grad():
        fa.flash_attention(q, k, k)
    assert dispatch.launch_counts()["flash_attention"] == 1


def test_train_step_on_card_matches_cpu(cuda):
    """One mamba2 smoke train step (two pods, grad_accum 2, remat) on the
    card against the CPU: 2 L ga pods scan launches (the remat recompute
    runs each forward again) and L ga pods backward launches; loss and
    parameters to 1e-5 of max(1, max |leaf|)."""
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.launch import steps
    from repro_torch.models import build, make_dummy_batch
    cfg = configs.get_smoke_config("mamba2-780m")
    one = build(cfg).init(prng.PRNGKey(0), "cpu")
    stacked = tree.map(lambda leaf: torch.stack([leaf, leaf * 1.1]), one)
    shape = configs.InputShape("t", 256, 4, "train")
    each = [make_dummy_batch(cfg, shape, prng.PRNGKey(k), "cpu")
            for k in (1, 2)]
    batch = {k: torch.stack([b[k] for b in each]) for k in each[0]}
    step = steps.make_train_step(cfg, lr=0.1, grad_accum=2, remat=True)
    new_c, loss_c = step(stacked, batch)
    dispatch.reset_launch_counts()
    new_g, loss_g = step(tree.map(lambda leaf: leaf.to(cuda), stacked),
                         {k: v.to(cuda) for k, v in batch.items()})
    counts = dispatch.launch_counts()
    L = cfg.num_layers
    assert counts["ssd_scan"] == 2 * L * 2 * 2
    assert counts["ssd_scan_bwd"] == L * 2 * 2
    assert abs(float(loss_g) - float(loss_c)) <= 1e-5 * max(1.0, float(loss_c))
    for a, b in zip(tree.leaves(new_g), tree.leaves(new_c)):
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-5 * max(1.0, float(b.abs().max())), err


def test_hybrid_forward_launch_counts(cuda):
    """zamba2 at width 256: one scan per layer, one flash launch per
    segment (ceil(L / attn_every)); decode launches neither."""
    from repro_torch import configs
    from repro_torch.models import build
    cfg = configs.get_smoke_config("zamba2-7b").with_(num_layers=5)
    fns = build(cfg)
    params = fns.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    toks = torch.randint(0, cfg.vocab_size, (1, 256), device=cuda)
    dispatch.reset_launch_counts()
    logits = fns.forward(params, {"tokens": toks}, attn_impl="pallas")
    counts = dispatch.launch_counts()
    assert counts["ssd_scan"] == 5 and counts["flash_attention"] == 3
    assert torch.isfinite(logits).all()
    cache = fns.init_decode_cache(1, 8, device=cuda)
    fns.decode_step(params, cache, toks[:, :1], 0)
    assert dispatch.launch_counts() == counts


def test_gbp_cs_sampler_card_matches_cpu(cuda):
    """The Fig. 4 sampler on the card against the same call on the CPU:
    masks and iterations equal, distance and trace to 1e-5 relative; one
    ``gbp_cs`` launch a call, one for a batch of instances."""
    import numpy as np
    from repro_torch.core import samplers
    rng = np.random.default_rng(0)
    A = rng.integers(0, 6, size=(4, 62, 33)).astype(np.float32)
    y = (A.sum(-1) * (8 / 33) + rng.random((4, 62))).astype(np.float32)
    for init in ("mpinv", "zero", "random"):
        for a, b in zip(A, y):
            dispatch.reset_launch_counts()
            out = samplers.gbp_cs_sampler(a, b, 8, init=init, device=cuda)
            assert dispatch.launch_counts()["gbp_cs"] == 1
            ref = samplers.gbp_cs_sampler(a, b, 8, init=init, device="cpu")
            assert (out.x == ref.x).all() and out.evaluations == \
                ref.evaluations
            np.testing.assert_allclose(out.trace, ref.trace, rtol=1e-5)
    dispatch.reset_launch_counts()
    res = core_gbp.gbp_cs_minimize_batched(torch.from_numpy(A).to(cuda),
                                           torch.from_numpy(y).to(cuda), 8)
    assert dispatch.launch_counts()["gbp_cs"] == 1
    ref = core_gbp.gbp_cs_minimize_batched(torch.from_numpy(A),
                                           torch.from_numpy(y), 8)
    assert torch.equal(res.x.cpu(), ref.x)
    assert torch.equal(res.iterations.cpu(), ref.iterations)


def test_evaluate_card_matches_cpu(cuda):
    """Host-batched eval at width 32/64/256 with a partial last batch:
    two ``conv_fused`` launches a batch, loss and accuracy to 1e-5 of the
    CPU's."""
    from repro_torch.configs import femnist_cnn
    from repro_torch.core import prng
    from repro_torch.data import femnist
    from repro_torch.models import cnn
    cfg = femnist_cnn.smoke_config()
    params = cnn.init_cnn(prng.PRNGKey(0), cfg, cuda)
    tx, ty = femnist.make_test_set(n_per_class=5)        # 310 images
    dispatch.reset_launch_counts()
    out = cnn.evaluate(params, tx, ty, batch=128)
    assert dispatch.launch_counts()["conv_fused"] == 2 * 3
    ref = cnn.evaluate(tree.map(lambda v: v.cpu(), params), tx, ty,
                       batch=128)
    assert abs(out[0] - ref[0]) <= 1e-5 and abs(out[1] - ref[1]) <= 1e-5


def test_checkpoint_from_card_restores_on_cpu(cuda, tmp_path):
    """A checkpoint of card tensors restores onto the CPU (and back onto
    the card) bit for bit."""
    from repro_torch import checkpoint
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = {"conv": {"w": torch.randn(5, 5, 1, 8, generator=gen,
                                        device=cuda),
                       "b": torch.randn(8, generator=gen, device=cuda)},
              "step": torch.tensor([3], dtype=torch.int32, device=cuda)}
    path = checkpoint.save(str(tmp_path), params, step=1)
    cpu_like = tree.map(lambda v: torch.zeros_like(v, device="cpu"), params)
    on_cpu = checkpoint.restore(path, cpu_like)
    on_card = checkpoint.restore(path, params)
    for a, b, c in zip(tree.leaves(params), tree.leaves(on_cpu),
                       tree.leaves(on_card), strict=True):
        assert b.device.type == "cpu" and c.device == a.device
        assert torch.equal(a.cpu(), b) and torch.equal(a, c)
