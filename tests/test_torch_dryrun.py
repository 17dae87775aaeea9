"""The meta-device dry run (``launch.dryrun``) on a fake world of 8 ranks
over a (pod 2, data 2, model 2) mesh, reduced combos, in a process of its
own (the fake process group must not reach the test process): the
smoke-config train step of granite-8b (as ``test_launch.py``'s small-mesh
dry run lowers the JAX one) and of mamba2-780m with every SPMD knob, a
prefill and a decode; the artifact's keys, its recorded collectives, the
Eq. 5 all-reduce's bytes against this rank's shards, the per-rank bytes;
the MoE dispatch's refusal (ROADMAP item 19.5), a kernel wrapper's refusal
of a placement it cannot take, and the wrappers' meta routes. Also
``perf_iter``'s delta table."""
import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
CODE = r"""
import json, torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import configs, tree
from repro_torch.configs import InputShape
from repro_torch.kernels import agg_weighted, flash_attention, ssd_scan
from repro_torch.launch import dryrun, mesh as lmesh, sharding as sh
from repro_torch.models import build

torch.set_num_threads(1)
lmesh.init_fake_world(8)
mesh = init_device_mesh("cpu", (2, 2, 2),
                        mesh_dim_names=("pod", "data", "model"))
out = {}
train = InputShape("t", 64, 8, "train")
for arch, flags in (("granite-8b", {}),
                    ("mamba2-780m", {"grad_sharding": "fsdp",
                                     "act_sharding": "batch"})):
    cfg = configs.get_smoke_config(arch)
    res = dryrun.lower_combo(arch, "t", cfg=cfg, shape=train, mesh=mesh,
                             grad_accum=2, verbose=False, **flags)
    # this rank's pod-local shards of the stacked params, independently
    one = build(dryrun._dtype_cfg(cfg)).init(torch.Generator(),
                                             device="meta")
    stacked = tree.map(lambda p: torch.empty((2,) + tuple(p.shape),
                                             device="meta"), one)
    sp = sh.distribute(stacked, sh.stack_pspecs_for_pods(
        sh.param_pspecs(one, mesh), mesh), mesh)
    local = sum(leaf.to_local().numel() for leaf in tree.leaves(sp))
    batch = {k: torch.empty(s.shape, dtype=s.dtype, device="meta") for k, s
             in sh.stacked_batch_sds(cfg, train, mesh).items()}
    batch = sh.distribute(batch, sh.batch_pspecs(cfg, train, mesh), mesh)
    res["expect_eq5_bytes"] = 4 * (-(-local // 4) * 4)
    res["expect_args"] = 4 * local + sh.local_bytes(batch)
    out[arch + "/train"] = res
for kind in ("prefill", "decode"):
    shape = InputShape("p", 64, 8, kind)
    out["granite-8b/" + kind] = dryrun.lower_combo(
        "granite-8b", "p", cfg=configs.get_smoke_config("granite-8b"),
        shape=shape, mesh=mesh, verbose=False)
try:
    dryrun.lower_combo("dbrx-132b", "p",
                       cfg=configs.get_smoke_config("dbrx-132b"),
                       shape=InputShape("p", 64, 8, "prefill"), mesh=mesh,
                       verbose=False)
    out["moe"] = "ran"
except NotImplementedError as err:
    out["moe"] = str(err)
# a placement the scan cannot take: the sequence sharded
sub = mesh["data", "model"]
x = sh.distribute(torch.empty(2, 64, 4, 32, device="meta"),
                  (None, "data"), sub)
dt = torch.empty(2, 64, 4, device="meta")
A = torch.empty(4, device="meta")
B = torch.empty(2, 64, 16, device="meta")
try:
    ssd_scan.ssd_scan(x, dt, A, B, B, chunk=32)
    out["placement"] = "ran"
except ValueError as err:
    out["placement"] = str(err)
# the meta routes: shapes, no data
q = torch.empty(1, 128, 4, 32, device="meta")
out["meta"] = [
    list(ssd_scan.ssd_scan(torch.empty(2, 64, 4, 32, device="meta"), dt, A,
                           B, B, chunk=32).shape),
    list(flash_attention.flash_attention(q, q[:, :, :2], q[:, :, :2]).shape),
    list(agg_weighted.agg(torch.empty(3, 8, device="meta"),
                          torch.empty(3, device="meta")).shape)]
print("DRYRUN " + json.dumps(out))
"""
# the JAX dry run's artifact keys that have a counterpart here
KEYS = {"arch", "shape", "mesh", "chips", "params", "params_active",
        "lower_s", "memory_analysis", "roofline", "grad_accum",
        "embed_mode", "accum_mode", "gather_dtype", "grad_sharding",
        "act_sharding", "param_mode", "moe_mode",
        "external_sync_collective_bytes", "external_sync_t_s"}


@pytest.fixture(scope="module")
def run():
    r = subprocess.run([sys.executable, "-c", CODE], capture_output=True,
                       text=True, timeout=300, cwd=os.path.dirname(HERE),
                       env={**os.environ, "PYTHONPATH": "src"})
    line = next((x for x in r.stdout.splitlines()
                 if x.startswith("DRYRUN ")), None)
    assert line is not None, r.stderr[-3000:]
    return json.loads(line[len("DRYRUN "):])


@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-780m"])
def test_train_combo_artifact(arch, run):
    res = run[arch + "/train"]
    assert KEYS <= set(res), KEYS - set(res)
    assert res["mesh"] == "2x2x2" and res["chips"] == 8
    coll = res["roofline"]["collective_bytes"]
    # FSDP: weights gathered over 'data', gradients reduce-scattered
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    assert coll["count"] > 50
    # Eq. 5: one all-reduce over 'pod' of this rank's f32 shards (padded)
    ext = res["external_sync_collective_bytes"]
    assert ext["count"] == 1 and ext["all-reduce"] == res["expect_eq5_bytes"]
    mem = res["memory_analysis"]
    assert mem["argument_size_in_bytes"] == res["expect_args"]
    assert mem["output_size_in_bytes"] > 0
    roof = res["roofline"]
    assert roof["compute_dtype"] == "bf16" and roof["t_collective_s"] > 0


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_prefill_and_decode_combos(kind, run):
    res = run["granite-8b/" + kind]
    assert res["roofline"]["collective_bytes"]["count"] > 0
    assert res["memory_analysis"]["argument_size_in_bytes"] > 0


def test_refusals_and_meta_routes(run):
    assert "ROADMAP item 19.5" in run["moe"] and "index_add_" in run["moe"]
    assert "Shard(dim=1)" in run["placement"] and "'data'" in \
        run["placement"]
    assert run["meta"] == [[2, 64, 4, 32], [1, 128, 4, 32], [8]]


def test_perf_iter_deltas():
    from repro_torch.launch import perf_iter
    base = {"t_compute_s": 1.0, "t_memory_s": 2.0, "t_collective_s": 0.0,
            "collective_bytes": {"all-gather": 10.0}}
    new = {"t_compute_s": 0.5, "t_memory_s": 2.0, "t_collective_s": 1.0,
           "collective_bytes": {"all-gather": 5.0, "all-reduce": 3.0}}
    lines = perf_iter.deltas(base, new)
    assert lines[1].endswith("(-50.0%)") and lines[2].endswith("(+0.0%)")
    assert lines[3].endswith("(+nan%)")
    assert "1.000e+01 -> 5.000e+00" in lines[4]
