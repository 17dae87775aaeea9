"""The SPMD knobs of ``launch.steps.make_train_step`` on a CPU gloo world of
2: the step on DTensor params and batches laid out by
``launch.sharding`` (``param_pspecs``, ``stack_pspecs_for_pods``,
``batch_pspecs``), with each knob alone and all four together, against
the port's unsharded step on the same numbers (the JAX sharded step cannot
be the reference: ``test_sharding_equivalence.py`` fails under this jax).
Params and loss to 1e-6, for a dense (granite-3-2b) and an SSM
(mamba2-780m) smoke config at 1 layer, two pods, ``grad_accum`` 2,
remat, and for an MoE one (dbrx-132b) at 4 tokens a row, where the
dense expert form runs (fewer than 4·E tokens) and its load-balance aux
loss, not a per-token mean, tells a microbatch's rows apart. The cases
and their meshes (world 2):

* ``grad``: ``grad_pspecs`` + ``mesh`` (ZeRO-2 reduce-scatter over
  'data'), (2, 1); ``grad_tp``: the same over 'model', (1, 2);
* ``act``: ``act_sharding`` pins the residual stream batch-sharded, (2, 1);
* ``pod``: ``spmd_pod``, the pods on 'pod', (pod 2, data 1, model 1);
* ``all_pod`` and ``all_data``: all four knobs on (2, 1, 1) and
  (1, 2, 1);
* ``grad_ga4``: ``grad_pspecs`` at ``grad_accum`` 4, whose 1-row
  microbatches do not split over 'data' (they are replicated there), (2, 1).

The MoE config takes ``grad`` and ``all_data``.

Each rank is a spawned process; rank 0 writes the differences, which the
tests read."""
import json
import os
import time

import numpy as np
import pytest
import torch

ARCHS = ("granite-3-2b", "mamba2-780m")
MOE_ARCH, MOE_CASES = "dbrx-132b", ("grad", "all_data")
CASES = {
    "grad": ((2, 1), {"grad": True}),
    "grad_tp": ((1, 2), {"grad": True}),
    "act": ((2, 1), {"act": True}),
    "pod": ((2, 1, 1), {"pod": True}),
    "all_pod": ((2, 1, 1), {"grad": True, "act": True, "pod": True}),
    "all_data": ((1, 2, 1), {"grad": True, "act": True, "pod": True}),
    "grad_ga4": ((2, 1), {"grad": True, "ga": 4}),
}
TIMEOUT = 240


def _inputs(arch):
    """Two pods (the second's weights 1.1 x the first's) of the smoke
    config at 1 layer and a pod-stacked (2, 4, 32) batch from numpy
    ((2, 4, 4) for the MoE config)."""
    from repro_torch import configs, tree
    from repro_torch.core import prng
    from repro_torch.models import build
    cfg = configs.get_smoke_config(arch).with_(num_layers=1)
    one = build(cfg).init(prng.PRNGKey(0), "cpu")
    stacked = tree.map(lambda leaf: torch.stack([leaf, leaf * 1.1]), one)
    rng = np.random.default_rng(0)
    shape = configs.InputShape("t", 4 if arch == MOE_ARCH else 32, 8,
                               "train")
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size,
                                          (2, 4) + tuple(v.shape[1:]),
                                          dtype=np.int32))
             for k, v in configs.input_specs(cfg, shape).items()}
    return cfg, one, stacked, batch, shape


def _rank(rank: int, world: int, store: str, out: str) -> None:
    import torch.distributed as dist
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch import tree
        from repro_torch.kernels import shards
        from repro_torch.launch import sharding as sh
        from repro_torch.launch import steps
        res = {}
        for arch in ARCHS + (MOE_ARCH,):
            cfg, one, stacked, batch, shape = _inputs(arch)
            refs = {ga: steps.make_train_step(
                cfg, lr=0.1, grad_accum=ga, remat=True)(stacked, batch)
                for ga in (2, 4)}
            for name, (mshape, knobs) in CASES.items():
                if arch == MOE_ARCH and name not in MOE_CASES:
                    continue
                kw = dict(lr=0.1, grad_accum=knobs.get("ga", 2), remat=True)
                ref, ref_loss = refs[kw["grad_accum"]]
                names = ("pod", "data", "model")[-len(mshape):]
                mesh = init_device_mesh("cpu", mshape, mesh_dim_names=names)
                ps = sh.param_pspecs(one, mesh)
                params = sh.distribute(
                    stacked, sh.stack_pspecs_for_pods(ps, mesh), mesh)
                dbatch = sh.distribute(batch, sh.batch_pspecs(cfg, shape,
                                                              mesh), mesh)
                act = sh.NamedSharding(mesh, ("data", None, None)) \
                    if knobs.get("act") else None
                step = steps.make_train_step(
                    cfg, **kw, grad_pspecs=ps if knobs.get("grad") else None,
                    mesh=mesh, act_sharding=act,
                    spmd_pod=knobs.get("pod", False))
                t0 = time.perf_counter()
                new, loss = step(params, dbatch)
                full = sh.full(new)
                sharded = any(shards.is_dtensor(leaf) and any(
                    not pl.is_replicate() for pl in leaf.placements)
                    for leaf in tree.leaves(new))
                res[f"{arch}/{name}"] = {
                    "params": max(float((a - b).abs().max()) for a, b in
                                  zip(tree.leaves(full), tree.leaves(ref))),
                    "loss": abs(float(loss) - float(ref_loss)),
                    "sharded": sharded,
                    "s": time.perf_counter() - t0}
        if rank == 0:
            with open(os.path.join(out, "result.json"), "w") as f:
                json.dump(res, f)
        dist.destroy_process_group()
    except BaseException:
        import traceback
        with open(os.path.join(out, f"error_{rank}"), "w") as f:
            f.write(traceback.format_exc())
        raise


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("spmd"))
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, 2, os.path.join(out, "store"),
                                             out)) for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [open(os.path.join(out, n)).read() for n in sorted(
        os.listdir(out)) if n.startswith("error")]
    assert not errors and not any(p.exitcode for p in procs), \
        "\n".join(errors)
    with open(os.path.join(out, "result.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("arch,case", [
    (arch, case) for arch in ARCHS for case in sorted(CASES)]
    + [(MOE_ARCH, case) for case in MOE_CASES])
def test_sharded_step_matches_unsharded(arch, case, results):
    r = results[f"{arch}/{case}"]
    assert r["params"] <= 1e-6, r
    assert r["loss"] <= 1e-6, r
    # the step's output stays laid out over the mesh
    assert r["sharded"], r
