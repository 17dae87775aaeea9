"""Helpers of the sharded-engine tests (``test_torch_sharded*.py``): the
compositions the port's group-sharded engine is held on, and ``gloo``
ranks spawned with ``torch.multiprocessing`` that run them on a
``torch.distributed`` mesh and save what each rank returns. Imports no
JAX: every rank is a fresh interpreter."""
from __future__ import annotations

import json
import os
import time
import traceback

import numpy as np

# test_fedgs_fused.py's multi-device config: M=4, K=8, L=4, L_rnd=1, T=5,
# R=2, n=8, the smoke CNN
M = 4
CFG = dict(num_groups=M, devices_per_group=8, num_selected=4,
           num_presampled=1, iters_per_round=5, rounds=2, lr=0.05,
           gbp_max_iters=16)
# name -> (FedGSConfig fields, corruption, drift, availability, K_pop)
ARMS = {
    "plain": ({}, None, None, None, 0),
    "compress": (dict(compress_int="topk:0.01+int8", compress_ext="int8"),
                 None, None, None, 0),
    "robust": (dict(robust_agg="trimmed_mean", quarantine_limit=2),
               dict(mode="scale+nan_burst+gauss_noise", frac=0.25), None,
               None, 0),
    "drift": (dict(reselect_every=2), None, dict(schedule="redraw",
                                                  period=2), None, 0),
    "avail": (dict(sync="bounded_async"), None, None,
              dict(schedule="markov", up_prob=0.6), 0),
    "population": (dict(reselect_every=2), None, None, None, 250),
    # a cadence of T under sync: keep iterations 1-4 rebuild only when a
    # committee member goes dark, which happens in one shard at a time
    "retrigger": (dict(reselect_every=5), None, None,
                  dict(schedule="bernoulli", up_prob=0.9), 0),
}
TIMEOUT = 240          # seconds a spawned world may take


def port_run_args(arm: str, device="cpu", m: int = M):
    """(params, sampler, p_real, FedGSConfig, kwargs of
    ``run_fedgs_fused``) of composition ``arm`` for the port, as its CLI
    builds them from the same flags."""
    from repro_torch.configs import femnist_cnn
    from repro_torch.core import fedgs, prng
    from repro_torch.data import (AvailabilityConfig, CorruptionConfig,
                                  DeviceStream, DriftConfig, LazyPopulation,
                                  PartitionConfig, PopulationConfig,
                                  make_availability_fn, make_corruption_fn,
                                  make_device_sampler, make_partition)
    from repro_torch.models import cnn
    extra, corrupt, drift, avail, k_pop = ARMS[arm]
    cfg = fedgs.FedGSConfig(**dict(CFG, num_groups=m), **extra)
    drift = None if drift is None else DriftConfig(**drift)
    if k_pop:
        pop = LazyPopulation(PopulationConfig(
            num_factories=m, devices_per_factory=k_pop, batch_size=8,
            seed=0), device)
        sampler = make_device_sampler(pop, drift=drift,
                                      candidates=CFG["devices_per_group"],
                                      candidate_every=cfg.reselect_every)
        p_real = pop.p_real
    else:
        part = make_partition(PartitionConfig(
            num_factories=m, devices_per_factory=CFG["devices_per_group"],
            seed=0))
        sampler = make_device_sampler(DeviceStream.from_partition(
            part, batch_size=8, seed=0, device=device), drift=drift)
        p_real = part.p_real
    params = cnn.init_cnn(prng.PRNGKey(0), femnist_cnn.smoke_config(),
                          device)
    kw = dict(group_loss_fn=cnn.make_group_loss_fn(),
              avail_fn=None if avail is None else make_availability_fn(
                  AvailabilityConfig(**avail), 0),
              corrupt_fn=None if corrupt is None else make_corruption_fn(
                  CorruptionConfig(**corrupt), 0))
    return params, sampler, p_real, cfg, kw


def named_state(sel: tuple, bounded: bool, quarantined: bool) -> dict:
    """The carried selection state's parts that the tests hold: the masks,
    the distances, under ``bounded_async`` the staleness clock, with
    quarantine the counters (the last leaf), as numpy."""
    out = {"mask": sel[0], "distance": sel[1]}
    if bounded:
        out["staleness"] = sel[2]
    if quarantined:
        out["quarantine"] = sel[-1]
    return {name: np.asarray(v) for name, v in out.items()}


def run_arm(arm: str, mesh=None, m: int = M):
    """Composition ``arm`` on the fused engine (on ``mesh`` when given),
    eagerly on the CPU: (records as dicts, final params' leaves as numpy,
    :func:`named_state` of this rank's rows); ([], None, None) on a rank
    that sits out."""
    from repro_torch import tree
    from repro_torch.core import engine, fedgs
    params, sampler, p_real, cfg, kw = port_run_args(arm, m=m)
    if mesh is not None and not mesh.active:
        return [], None, None
    exp = fedgs.make_fedgs_experiment(params, sampler, p_real, cfg,
                                      mesh=mesh, **kw)
    state, logs = engine.run_experiment(exp, cfg.rounds, chunk=1)
    return ([rec.to_dict() for rec in logs],
            [leaf.numpy() for leaf in tree.leaves(exp.params_fn(state))],
            named_state(state[1], cfg.sync == "bounded_async",
                        kw["corrupt_fn"] is not None
                        and cfg.quarantine_limit > 0))


def save(path: str, recs, params, sel) -> None:
    """Write what :func:`run_arm` returned (or the JAX package's run of
    the same composition) to ``path``.json and ``path``.npz."""
    arrays = {}
    if params is not None:
        arrays.update({f"p{i}": v for i, v in enumerate(params)})
        arrays.update({f"s_{name}": v for name, v in sel.items()})
    np.savez(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump(recs, f)


def load(path: str):
    """(records, params leaves or None, named state or None) that
    :func:`save` wrote."""
    with open(path + ".json") as f:
        recs = json.load(f)
    z = np.load(path + ".npz")
    params = [z[f"p{i}"] for i in range(sum(k[0] == "p" for k in z.files))]
    sel = {k[2:]: z[k] for k in z.files if k.startswith("s_")}
    return recs, params or None, sel or None


def load_world(out: str, arm: str, m: int, world: int):
    """Every rank's :func:`load` of one composition."""
    return [load(os.path.join(out, f"{arm}_{m}_{rank}"))
            for rank in range(world)]


def _collectives(rank: int, world: int, out: str) -> None:
    """The four ``sync`` collectives on rank-dependent inputs made from a
    seed (:func:`collective_inputs`; rank 1 weighs 0 in the gradient form),
    and the meshes ``launch.mesh.make_group_mesh`` makes at M = 4, 5, 6
    and None."""
    from repro_torch.core import fedgs, sync
    from repro_torch.launch import mesh as lmesh
    params, weight, group_params = collective_inputs(rank)
    import torch
    t = lambda tr: {k: torch.as_tensor(v) for k, v in tr.items()}
    res = {
        "internal": sync.internal_sync_collective(t(params), weight),
        "grad_internal": sync.grad_internal_sync_collective(
            t(params), np.float32(0.0) if rank == 1 else weight),
        "external": sync.external_sync_collective(t(params)),
        "grouped": sync.external_sync_grouped(
            t(group_params), fedgs.make_group_mesh(world * 2)),
    }
    arrays = {f"{name}/{k}": v.numpy() for name, tr in res.items()
              for k, v in tr.items()}
    sizes = {str(m): lmesh.make_group_mesh(m) for m in (4, 5, 6, None)}
    np.savez(out + ".npz", **arrays)
    with open(out + ".json", "w") as f:
        json.dump({m: [g.size, g.rank, g.world, g.active]
                   for m, g in sizes.items()}, f)


def collective_inputs(rank: int):
    """Rank ``rank``'s (params, weight, (2, ...) group params)."""
    rng = np.random.default_rng(100 + rank)
    params = {"w": rng.normal(size=(3, 5)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    group_params = {"w": rng.normal(size=(2, 3, 5)).astype(np.float32),
                    "b": rng.normal(size=(2, 7)).astype(np.float32)}
    return params, np.float32(rng.uniform(0.5, 2.0)), group_params


def _rank_main(rank: int, world: int, store: str, jobs: list, out: str
               ) -> None:
    """One gloo rank: each job's results, and each composition's local
    re-trigger predicates (before the OR over the shards), to ``out``."""
    import torch
    import torch.distributed as dist
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        from repro_torch.core import fedgs, selection
        triggers = []
        trigger = selection.reselect_trigger

        def recorded(*args):
            fired = trigger(*args)
            triggers.append(bool(fired))
            return fired

        selection.reselect_trigger = recorded
        for job in jobs:
            if job == "collectives":
                _collectives(rank, world, os.path.join(out,
                                                       f"{job}_{rank}"))
                continue
            arm, m = job
            triggers.clear()
            mesh = fedgs.make_group_mesh(m)
            recs, params, sel = run_arm(arm, mesh, m)
            path = os.path.join(out, f"{arm}_{m}_{rank}")
            save(path, recs, params, sel)
            with open(path + ".triggers", "w") as f:
                json.dump(triggers, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out, f"error_{rank}"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(world: int, jobs: list, out: str) -> None:
    """Run ``jobs`` (``(arm, M)`` pairs, or ``"collectives"``) on ``world``
    gloo ranks, a file store under ``out``; each rank saves its results
    there (:func:`load`). Raises with a rank's traceback if one fails or
    the world outlasts :data:`TIMEOUT`."""
    import torch.multiprocessing
    ctx = torch.multiprocessing.get_context("spawn")
    store = os.path.join(out, "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(rank, world, store, jobs, out))
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    errors = [open(os.path.join(out, name)).read()
              for name in sorted(os.listdir(out)) if name.startswith("error")]
    if alive or errors or any(p.exitcode for p in procs):
        raise RuntimeError(f"world {world}: {len(alive)} ranks timed out, "
                           f"exit codes {[p.exitcode for p in procs]}\n"
                           + "\n".join(errors))
