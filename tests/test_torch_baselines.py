"""The Table II baselines of the port (``core/baselines.py``, the client pool
of ``data/streaming.py``, ``optim``) against the JAX package's, on the CPU.

The numpy baseline rounds of ``FactoryStreams`` bit for bit; the client
pool's ids and labels bit for bit and its images to ``IMG_TOL``, on a dense
pool and on one above ``LAZY_POOL_THRESHOLD``; all fourteen strategies on
the linear probe (C=4, S=2, n=4, R=2) and six on the smoke CNN against
``run_baseline``'s fused engine (``make_baseline_experiment`` run by
``engine.run_experiment``), params, extras, server state and every round's
loss to 1e-5; the port's host loop against its fused engine (eager on the
CPU) bit for bit; the CLI against the JAX CLI; the optimizers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import femnist_cnn as jcfg
from repro.core import baselines as jbaselines
from repro.core import engine as jengine
from repro.data import DeviceStream as JDeviceStream
from repro.data import FactoryStreams as JFactoryStreams
from repro.data import make_client_pool as jmake_client_pool
from repro.models import cnn as jcnn
from repro_torch import convert, optim, tree
from repro_torch.configs import femnist_cnn
from repro_torch.core import baselines, engine
from repro_torch.data import (LAZY_POOL_THRESHOLD, DeviceStream,
                              DriftConfig, FactoryStreams, HostClientPool,
                              Partition,
                              PartitionConfig, make_client_pool,
                              make_partition)
from repro_torch.launch import train
from repro_torch.models import cnn
from test_torch_fused import IMG_TOL
from test_torch_train import SMOKE, _rounds, assert_cli_matches

TOL = 1e-5
ALL = ("fedavg", "fedprox", "fedmmd", "fedfusion_conv", "fedfusion_multi",
       "fedfusion_single", "ida", "ida_intrac", "ida_fedavg", "cgau",
       "fedavgm", "fedadagrad", "fedadam", "fedyogi")
CNN_STRATEGIES = ("fedprox", "fedmmd", "fedfusion_conv", "cgau",
                  "ida_intrac", "fedyogi")


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


def _pools(part, clients, steps, n):
    jpool = jmake_client_pool(
        JDeviceStream.from_partition(part, batch_size=n, seed=0),
        clients=clients, steps=steps)
    pool = make_client_pool(
        DeviceStream.from_partition(part, batch_size=n, seed=0,
                                    device="cpu"), clients, steps)
    return jpool, pool


def _max_diff(ref, out) -> float:
    ref, out = jax.tree.leaves(ref), tree.leaves(out)
    assert len(ref) == len(out)
    return max([0.0] + [float(np.abs(np.asarray(r, np.float64)
                                     - o.numpy().astype(np.float64)).max())
                        for r, o in zip(ref, out)])


# ------------------------------------------------------------ data

def test_factory_streams_baseline_rounds_bit_equal(part):
    """``sample_baseline_round`` and ``fetch_device_batches`` draw numpy's
    own ``choice`` streams: bit-equal to the JAX package's."""
    ref = JFactoryStreams(part, batch_size=4, seed=1)
    out = FactoryStreams(part, batch_size=4, seed=1)
    for r in range(2):
        (ri, rl), rw = ref.sample_baseline_round(5, 3, seed=100 + r)
        (oi, ol), ow = out.sample_baseline_round(5, 3, seed=100 + r)
        for a, b in ((ri, oi), (rl, ol), (rw, ow)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(ref.fetch_device_batches(3, 7, 2),
                    out.fetch_device_batches(3, 7, 2)):
        assert np.array_equal(a, b)


def _lazy_partition() -> Partition:
    """A dense partition of 2 × 33,000 devices (> LAZY_POOL_THRESHOLD),
    made with numpy."""
    m, k, f = 2, 33_000, 62
    rng = np.random.default_rng(0)
    probs = rng.dirichlet(np.full(f, 0.3), size=(m, k)).astype(np.float32)
    return Partition(class_probs=probs,
                     writer_ids=np.arange(m * k).reshape(m, k),
                     data_rates=np.ones((m, k), np.float32),
                     p_real=probs.mean((0, 1)))


@pytest.mark.parametrize("lazy", [False, True], ids=["dense", "lazy"])
def test_client_pool_matches_reference(part, lazy):
    """The pool's client ids (``jax.random.choice(replace=False)``, or
    ``randint`` above the threshold) and labels (against the XLA-blocked
    cdf) bit for bit, its images to ``IMG_TOL``; ``HostClientPool`` returns
    the pool's exact batches."""
    if lazy:
        part = _lazy_partition()
        assert part.class_probs[..., 0].size > LAZY_POOL_THRESHOLD
    clients, steps, n = 6, 2, 4
    jpool, pool = _pools(part, clients, steps, n)
    size = part.class_probs[..., 0].size
    fn = jax.jit(jpool.round_batches)
    for r in (0, 3):
        k_sel = jax.random.split(jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(0), 303), r), 3)[0]
        ref_ids = jax.random.randint(k_sel, (clients,), 0, size) if lazy \
            else jax.random.choice(k_sel, size, (clients,), replace=False)
        assert np.array_equal(pool.material(r)[:clients],
                              np.asarray(ref_ids))
        (ri, rl), rw = fn(jnp.int32(r))
        (oi, ol), ow = pool.round_batches(r)
        assert np.array_equal(np.asarray(rl), ol.numpy())
        assert np.array_equal(np.asarray(rw), ow.numpy())
        assert float(np.abs(np.asarray(ri) - oi.numpy()).max()) <= IMG_TOL
        (hi, hl), hw = HostClientPool(pool)(r)
        assert torch.equal(hi, oi) and torch.equal(hl, ol) \
            and torch.equal(hw, ow)


def test_client_pool_refuses_drift_and_oversize(part):
    """A drift schedule the JAX package does not know is refused by its
    config (drift itself is ported: tests/test_torch_drift.py), ``static``
    keeps the no-drift pool, and a pool smaller than C raises."""
    stream = DeviceStream.from_partition(part, batch_size=4, device="cpu")
    with pytest.raises(ValueError, match="schedule"):
        make_client_pool(stream, 4, 2, drift=DriftConfig(schedule="sudden"))
    static = make_client_pool(stream, 4, 2, drift=DriftConfig())
    assert static.drift is None and static.material_size == 4 + 4
    with pytest.raises(ValueError, match="exceeds"):
        make_client_pool(stream, 33, 2)


# ------------------------------------------------------------ strategies

def _reference_run(jmodel, name, jpool, cfg):
    """``run_baseline``'s fused engine in the JAX package: (full state,
    losses)."""
    exp = jbaselines.make_baseline_experiment(
        jmodel, jbaselines.all_strategies(jmodel)[name], jpool, cfg)
    state, logs = jengine.run_experiment(exp, cfg.rounds)
    return state, [rec.loss for rec in logs]


def _assert_strategy_matches(jmodel, model, name, part):
    jcfg_b = jbaselines.BaselineConfig(clients_per_round=4, local_steps=2,
                                       lr=0.05, rounds=2, seed=0)
    cfg = baselines.BaselineConfig(clients_per_round=4, local_steps=2,
                                   lr=0.05, rounds=2, seed=0)
    jpool, pool = _pools(part, 4, 2, 4)
    ref_state, ref_losses = _reference_run(jmodel, name, jpool, jcfg_b)
    exp = baselines.make_baseline_experiment(
        model, baselines.all_strategies(model)[name], pool, cfg)
    assert exp.name == jbaselines.all_strategies(jmodel)[name].name
    state, logs = engine.run_experiment(exp, cfg.rounds)
    # the whole state crosses through convert: dicts, (), (m, v, t)
    crossed = convert.params_from_jax(jax.tree.map(np.asarray, ref_state),
                                      "cpu")
    assert [leaf.dtype for leaf in tree.leaves(crossed)] == \
        [leaf.dtype for leaf in tree.leaves(state)]
    assert _max_diff(ref_state, state) <= TOL, name
    assert np.allclose(ref_losses, [rec.loss for rec in logs], rtol=0,
                       atol=TOL)
    return state


@pytest.mark.parametrize("name", ALL)
def test_strategy_matches_reference_linear_probe(name, part):
    """All fourteen strategies on the linear probe: params, extras and
    server state (Adam's int32 t too) to 1e-5 after two rounds."""
    _assert_strategy_matches(jbaselines.linear_probe_model(),
                             baselines.linear_probe_model(device="cpu"),
                             name, part)


@pytest.mark.parametrize("name", CNN_STRATEGIES)
def test_strategy_matches_reference_cnn(name, part):
    """The smoke CNN (every conv through ``conv_fused``'s plain version,
    grouped over the clients; the frozen global features at G = 1):
    params, extras and server state to 1e-5."""
    _assert_strategy_matches(jcnn.make_model_api(jcfg.smoke_config()),
                             cnn.make_model_api(femnist_cnn.smoke_config(),
                                                "cpu"), name, part)


@pytest.mark.parametrize("name", ["fedfusion_single", "ida_intrac",
                                  "fedadam"])
def test_host_loop_equals_fused_engine(name, part):
    """The port's host loop over ``HostClientPool`` and its fused engine
    (eager on the CPU) run the same rounds bit for bit, eval included."""
    model = cnn.make_model_api(femnist_cnn.smoke_config(), "cpu")
    strategy = baselines.all_strategies(model)[name]
    cfg = baselines.BaselineConfig(clients_per_round=5, local_steps=2,
                                   lr=0.05, rounds=2, seed=0)
    pool = _pools(part, 5, 2, 4)[1]
    tx = torch.rand(1, 10, 28, 28,
                    generator=torch.Generator().manual_seed(0))
    ty = torch.arange(10)[None]

    def eval_fn(pe):
        logits = model.apply(tree.map(lambda v: v[None], pe[0]), tx)
        return (baselines.softmax_xent(logits, ty)[0],
                baselines.accuracy(logits, ty)[0])

    runs = [baselines.run_baseline(model, strategy, data, cfg,
                                   eval_fn=eval_fn, eval_every=2)
            for data in (HostClientPool(pool), pool)]
    (host, hlogs), (fused, flogs) = runs
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(host),
                                                 tree.leaves(fused),
                                                 strict=True))
    assert [r.loss for r in hlogs] == [r.loss for r in flogs]
    assert hlogs[1].test_loss == flogs[1].test_loss is not None


def test_round_graph_needs_a_card(part):
    model = baselines.linear_probe_model(device="cpu")
    with pytest.raises(ValueError, match="card"):
        baselines.make_baseline_experiment(
            model, baselines.fedavg(model), _pools(part, 2, 1, 2)[1],
            baselines.BaselineConfig(clients_per_round=2, local_steps=1),
            graph=True)


def test_tree_takes_tuples_in_jax_leaf_order():
    x = {"b": torch.zeros(1), "a": (torch.ones(2), ())}
    t = (x, (), [torch.full((3,), 2.0)])
    ref = jax.tree.leaves(jax.tree.map(lambda v: np.asarray(v), t))
    assert [v.shape for v in tree.leaves(t)] == [r.shape for r in ref]
    back = tree.unflatten(t, tree.leaves(tree.map(lambda v: v + 1, t)))
    assert isinstance(back[2], list) and back[1] == ()
    assert torch.equal(back[0]["a"][0], torch.full((2,), 2.0))


# ------------------------------------------------------------ optimizers

@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("momentum", {}), ("momentum", {"nesterov": True}),
    ("adagrad", {}), ("adam", {}), ("yogi", {})])
def test_optimizers_match_reference(name, kw):
    """Four steps on random gradients: updates and state to 1e-6 (Adam's
    and Yogi's bias correction is an f32 pow, last-bit close to XLA's)."""
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
    jopt, opt = joptim.get(name, 0.05, **kw), optim.get(name, 0.05, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    p = convert.params_from_jax(params, "cpu")
    jstate, state = jopt.init(jp), opt.init(p)
    for _ in range(4):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in params.items()}
        jupd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        upd, state = opt.update(convert.params_from_jax(g, "cpu"), state, p)
        jp, p = joptim.apply_updates(jp, jupd), optim.apply_updates(p, upd)
        assert _max_diff(jupd, upd) <= 1e-6
        assert _max_diff((jp, jstate), (p, state)) <= 1e-6


# ------------------------------------------------------------ the CLI

@pytest.mark.parametrize("flags", [
    ["--strategy", "fedyogi"],
    ["--strategy", "fedmmd", "--engine", "fused"],
    ["--strategy", "ida_intrac", "--engine", "fused", "--clients-per-round",
     "8", "--local-steps", "3", "--eval-chunk", "3"],
], ids=["fedyogi-host", "fedmmd-fused", "ida_intrac-fused"])
def test_cli_matches_reference(flags, capsys, monkeypatch):
    """``--strategy`` prints the JAX CLI's round lines to 1e-4 on the smoke
    command, on the host loop and the fused engine."""
    recs = assert_cli_matches(capsys, monkeypatch, flags)
    assert recs[1]["test_accuracy"] is not None


def test_cli_engines_print_the_same_lines(capsys):
    """The port's host loop and fused engine (``sharded`` runs it too, as
    in the JAX CLI) print the same round lines, the same rounds bit for
    bit; a FedGS-only flag draws the JAX CLI's warning on stderr."""
    flags = SMOKE + ["--device", "cpu", "--strategy", "fedfusion_multi",
                     "--local-steps", "2", "--selection", "random"]
    lines = []
    for engine_name in ("host", "fused", "sharded"):
        train.main(flags + ["--engine", engine_name])
        out, err = capsys.readouterr()
        lines.append(_rounds(out))
        assert "warning: --selection applies only to --strategy fedgs; " \
            "ignored for fedfusion_multi" in err
    assert lines[0] == lines[1] == lines[2] and len(lines[0]) == 3


def test_cli_strategies_are_the_reference_lineup():
    ref = jbaselines.all_strategies(jcnn.make_model_api(jcfg.CONFIG))
    assert train.STRATEGIES == ("fedgs",) + tuple(sorted(ref))
    assert len(ref) == 14
