"""The port's collective and shape accounting (``launch.hlo_analysis``)
against the JAX package's HLO parser: the same op list, written as HLO
lines for JAX and recorded as the port records it, gives equal
``collective_bytes`` and ``param_replica_bytes``. The recorders themselves
(``CollectiveTrace`` on a one-rank gloo world: eager and functional
collectives, their types, bytes and reduce ops; ``ShapeTrace`` on one
fused round: the port's counterpart of
``test_fedgs_fused.py::test_fused_round_param_buffers_scale_with_m_not_ml``)
and the ``Roofline`` at the H100 peaks."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_sharded_ranks as ranks
from repro import configs as jconfigs
from repro.launch import hlo_analysis as jha
from repro.launch import roofline_model as jroof
from repro_torch import configs, tree
from repro_torch.launch import hlo_analysis as ha
from repro_torch.launch import roofline_model as roof

TYPES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
HLO_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.int32: "s32", torch.float16: "f16", torch.int8: "s8",
              torch.float64: "f64", torch.bool: "pred"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hlo(dtype, shape) -> str:
    return f"{HLO_DTYPES[dtype]}[{','.join(str(d) for d in shape)}]"


def _ops(seed):
    """A random op list: (type, dtype, shape) of each collective's result."""
    rng = np.random.default_rng(seed)
    dtypes = list(HLO_DTYPES)
    out = []
    for _ in range(40):
        shape = tuple(int(d) for d in rng.integers(1, 9, rng.integers(0, 4)))
        out.append((TYPES[rng.integers(len(TYPES))],
                    dtypes[rng.integers(len(dtypes))], shape))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_collective_bytes_match_reference(seed):
    ops = _ops(seed)
    text = "\n".join(
        f"  %c{i} = {_hlo(dt, shape)}{{0}} {kind}(f32[4]{{0}} %p{i}), "
        "replica_groups={}" for i, (kind, dt, shape) in enumerate(ops))
    recorded = [{"type": kind, "bytes": int(np.prod(shape, dtype=np.int64))
                 * dt.itemsize, "depth": 0, "op_name": kind, "reduce": ""}
                for kind, dt, shape in ops]
    for trips in ((), (8.0, 36.0)):
        assert ha.collective_bytes(recorded, loop_trips=trips) == \
            jha.collective_bytes(text, loop_trips=trips)
    assert len(ha.collective_ops(recorded)) == \
        len(jha.collective_ops(text)) == 40


@pytest.mark.parametrize("seed", [0, 1])
def test_param_replica_bytes_match_reference(seed):
    rng = np.random.default_rng(seed)
    m, l = 4, 3
    params = [(5, 5, 1, 8), (128, 62), (784, 128)]
    shapes = []
    for _ in range(60):
        pick = rng.integers(4)
        base = params[rng.integers(len(params))]
        shape = ((m,) + base if pick == 0 else (m, l) + base if pick == 1
                 else tuple(int(d) for d in rng.integers(1, 6,
                                                         rng.integers(0, 4))))
        dt = (torch.float32, torch.bfloat16, torch.int32)[rng.integers(3)]
        shapes.append((dt, shape))
    text = "\n".join(f"  %v{i} = {_hlo(dt, s)}{{0}} add(%a, %b)"
                     for i, (dt, s) in enumerate(shapes))
    out = ha.param_replica_bytes(shapes, params, m, l)
    assert out == jha.param_replica_bytes(text, params, m, l)
    assert out["m_count"] > 0 and out["ml_count"] > 0


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A one-rank gloo world for the module, torn down after it."""
    if dist.is_initialized():
        pytest.fail("a process group is already initialised")
    store = tmp_path_factory.mktemp("pg") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_collective_trace_records_eager_and_functional(world1):
    import torch.distributed._functional_collectives as funcol
    x = torch.ones(6)
    with ha.CollectiveTrace() as trace:
        dist.all_reduce(x)
        dist.all_reduce(x[:4], op=dist.ReduceOp.MAX)
        funcol.wait_tensor(funcol.all_reduce(x, "sum", dist.group.WORLD))
        funcol.wait_tensor(funcol.all_gather_single(
            x.to(torch.bfloat16), 0, dist.group.WORLD))
        funcol.wait_tensor(funcol.reduce_scatter_single(
            torch.ones(8), "sum", 0, dist.group.WORLD))
        x + 1                                   # no collective
    got = [(op["type"], op["bytes"], op["reduce"]) for op in trace.ops]
    assert got == [("all-reduce", 24, "sum"), ("all-reduce", 16, "max"),
                   ("all-reduce", 24, "sum"), ("all-gather", 12, ""),
                   ("reduce-scatter", 32, "")]
    assert all(op["depth"] == 0 for op in trace.ops)
    out = ha.collective_bytes(trace)
    assert out == {"all-gather": 12.0, "all-reduce": 64.0,
                   "reduce-scatter": 32.0, "all-to-all": 0.0,
                   "collective-permute": 0.0, "count": 5}


def test_roofline_at_h100_peaks():
    cfg = configs.get_config("granite-8b")
    shape = configs.INPUT_SHAPES["train_4k"]
    analytic = roof.analytic_roofline(cfg, shape, grad_accum=8)
    coll = [{"type": "all-gather", "bytes": 450e9, "depth": 0}]
    r = ha.analyze(coll, chips=256, analytic=analytic)
    assert r.t_compute == analytic.flops_xla / (256 * 989e12)
    assert r.t_memory == analytic.hbm_bytes / (256 * 3.35e12)
    assert r.t_collective == 1.0
    assert ha.analyze(coll, chips=1, analytic=analytic,
                      compute_dtype="fp32").t_compute == \
        analytic.flops_xla / 67e12
    jr = jha.Roofline(flops=1.0, flops_ideal=1.0, hbm_bytes=1.0,
                      coll_bytes={}, chips=1)
    # the JAX artifact's keys, but the compiler's cost counters, which
    # PyTorch has no counterpart of; and the compute dtype of the peak
    assert set(r.as_dict()) == set(jr.as_dict()) - {"raw_cost_analysis"} \
        | {"compute_dtype"}
    assert dataclasses.asdict(analytic) == dataclasses.asdict(
        jroof.analytic_roofline(jconfigs.get_config("granite-8b"),
                                jconfigs.INPUT_SHAPES["train_4k"],
                                grad_accum=8))


def test_fused_round_param_buffers_scale_with_m_not_ml():
    """One round of the port's fused engine under ``ShapeTrace``: under
    grad_avg no (M, L, θ) tensor of a weight leaf appears (one backward
    over the all-groups superbatch, one (M, θ) gradient), while model_avg
    makes the M·L one-step models; both hold (M, θ) group params."""
    from repro_torch.core import fedgs
    params, sampler, p_real, _, kw = ranks.port_run_args("plain")
    weights = [tuple(leaf.shape) for leaf in tree.leaves(params)
               if leaf.ndim >= 2]
    footprints = {}
    for step in ("grad_avg", "model_avg"):
        cfg = fedgs.FedGSConfig(**dict(ranks.CFG, iters_per_round=2,
                                       rounds=1, train_step=step))
        exp = fedgs.make_fedgs_experiment(params, sampler, p_real, cfg,
                                          **kw)
        with ha.ShapeTrace() as trace:
            exp.round_fn(exp.init_state, 0)
        footprints[step] = ha.param_replica_bytes(
            trace.shapes, weights, cfg.num_groups, cfg.num_selected)
    assert footprints["grad_avg"]["ml_count"] == 0, footprints
    assert footprints["grad_avg"]["m_count"] > 0, footprints
    assert footprints["model_avg"]["ml_count"] > 0, footprints
