"""Multi-pod dry run on the meta device: the port of the JAX package's
``launch/dryrun.py``.

Each (arch × input shape × mesh) runs once with meta-device stand-ins (no
data, no device memory) on the production mesh of a fake world
(``launch.mesh.init_fake_world``: 256 or 512 ranks in one process, on
torch's fake process group, whose collectives move nothing). The params
are meta DTensors laid out by ``launch.sharding.param_pspecs``; one train
step (and one ``external_sync_step``), one prefill or one decode step runs
under ``hlo_analysis.CollectiveTrace``, which records what this rank (rank
0) would send. Where JAX lowers and compiles, the port executes shapes.
On the multi-pod mesh the train step maps the pods onto 'pod'
(``spmd_pod``) and a prefill or decode runs each pod as a replica on the
(data, model) submesh (:func:`_pod_replicas`).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
Artifacts land in experiments/dryrun_torch/<arch>__<shape>__<mesh>.json,
with the JAX artifact's keys where a counterpart exists: ``params``,
``params_active``, ``roofline`` (``hlo_analysis.Roofline`` at the H100
peaks: the analytic FLOPs and bytes, the recorded collectives),
``external_sync_collective_bytes`` (train), ``lower_s`` (the meta run's
wall seconds) and ``memory_analysis``: this rank's argument and output
bytes from its local shard shapes, and ``temp_size_in_bytes``, the peak
of what the step allocates on this rank as
``torch.distributed._tools.mem_tracker.MemTracker`` tracks it on the
meta device (activations and temporaries; the outputs too, from when
they appear: JAX's count leaves them out).

The attention runs shard by shard (``kernels.shards``) and its
implementation moves no byte between ranks, so the dry run takes
``attn_impl="naive"`` by default: one materialised-scores call a layer,
where ``auto``'s blockwise loop (64 tiles a layer at 4,096 tokens, 4,096
at 32,768) costs ten to a hundred times the Python dispatch for the same
shapes and the same collectives. The temp bytes are the implementation's
that ran: naive's score matrices dominate them at 32,768 tokens, where
the card's flash kernel keeps none (``--attn-impl`` picks another).

A combo the port's model code cannot run on DTensors raises
``NotImplementedError`` naming the op and ROADMAP item 19.5, from the two
known sites only: the MoE capacity dispatch (``models.moe.moe_forward``)
and a train microbatch that does not shard evenly over the batch's mesh
dims (checked in :func:`lower_combo`). Any other error propagates as it
is.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from torch.distributed._tools.mem_tracker import MemTracker

from .. import configs, tree
from ..models import build
from . import hlo_analysis, roofline_model, sharding as shlib, steps
from .mesh import init_fake_world, is_fake_world, make_production_mesh

# per-(shape) gradient-accumulation defaults (the JAX dry run's): saved
# activations ≈2 GB per chip under layer remat
GRAD_ACCUM = {
    "train_4k": {
        "deepseek-v2-236b": 16, "internvl2-26b": 16, "granite-8b": 8,
        "minitron-8b": 8, "granite-3-2b": 4, "whisper-large-v3": 4,
        "qwen1.5-4b": 4, "zamba2-7b": 8, "mamba2-780m": 2, "dbrx-132b": 16,
    },
}

LR = 1e-2  # η (Eq. 3); its value does not matter on the meta device

# --preset optimized: the JAX package's per-family flags. MoE archs skip
# activation pinning and use EP-only experts (dbrx pins); small dense
# models also drop FSDP (tp_only); every decode uses the seq-sharded cache.
SMALL_DENSE = {"granite-3-2b", "qwen1.5-4b", "whisper-large-v3",
               "mamba2-780m"}
OUT_DIR = "experiments/dryrun_torch"


def optimized_flags(arch: str, cfg) -> dict:
    flags = {"cross_mode": "seq_sharded"}
    if cfg.arch_type == "moe":
        flags["moe_mode"] = "ep_only"
        if arch == "dbrx-132b":
            flags["act_sharding"] = "batch"
            flags["embed_mode"] = "vocab_model"
    else:
        flags["act_sharding"] = "batch"
        flags["embed_mode"] = "vocab_model"
    if arch in SMALL_DENSE:
        flags["param_mode"] = "tp_only"
    return flags


def _dtype_cfg(cfg):
    return cfg.with_(compute_dtype=torch.bfloat16)


def _enc_len(shape) -> int:
    return min(shape.seq_len // 2, 4096)


def _loop_trips(cfg, shape, ga: int) -> tuple[float, ...]:
    """The JAX dry run's structural trip counts, outermost loop first. The
    port records every trip (depth 0), so they weigh nothing; they are
    kept in the artifact for comparison."""
    l_scan = cfg.attn_every if cfg.arch_type == "hybrid" else cfg.num_layers
    nblk = max(1, shape.seq_len // 512)
    if shape.kind == "train":
        return (float(ga), float(l_scan), float(nblk), float(nblk))
    if shape.kind == "prefill":
        return (float(l_scan), float(nblk), float(nblk))
    return (float(l_scan),)


def ensure_world(size: int) -> None:
    """A fake world of ``size`` ranks (one already up of another size is
    torn down first)."""
    import torch.distributed as dist
    if dist.is_initialized():
        if is_fake_world() and dist.get_world_size() == size:
            return
        if not is_fake_world():
            raise RuntimeError("the dry run needs the fake process group; "
                               "another process group is initialised")
        dist.destroy_process_group()
    init_fake_world(size)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _pod_replicas(mesh, shape):
    """Prefill and decode on a mesh with a 'pod' axis: the params carry no
    pod axis, so each pod is a replica serving its part of the batch (all
    of it when the batch does not split, long_500k's one sequence). This
    rank's pod runs on the (data, model) submesh with B/n_pods sequences:
    the collectives of this rank are the 3-axis program's, and DTensor's
    planner stays on two axes."""
    sizes = shlib.axis_sizes(mesh)
    n_pods = sizes.get("pod", 1)
    if "pod" not in sizes:
        return mesh, shape
    rest = tuple(n for n in mesh.mesh_dim_names if n != "pod")
    b = shape.global_batch
    if b > 1 and b % n_pods == 0:
        b //= n_pods
    return mesh[rest], configs.InputShape(shape.name, shape.seq_len, b,
                                          shape.kind)


def lower_combo(arch: str, shape_name: str, *, multi_pod: bool = False,
                grad_accum: int | None = None, attn_impl: str = "naive",
                embed_mode: str = "fsdp", accum_mode: str = "grad_each",
                gather_dtype: str = "fp32", grad_sharding: str = "none",
                act_sharding: str = "none", param_mode: str = "fsdp",
                moe_mode: str = "ep_fsdp", cross_mode: str = "head_sharded",
                verbose: bool = True, cfg=None, shape=None, mesh=None
                ) -> dict:
    """Run one (arch × shape × mesh) on the meta device; return the
    artifact dict. ``cfg``, ``shape`` and ``mesh`` override the full
    config, ``configs.INPUT_SHAPES[shape_name]`` and the production mesh
    (a reduced combo; a ``mesh`` must be a DeviceMesh of the world)."""
    if mesh is None:
        ensure_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = _dtype_cfg(cfg if cfg is not None else configs.get_config(arch))
    shape = shape if shape is not None else configs.INPUT_SHAPES[shape_name]
    fns = build(cfg)
    chips = mesh.size()
    names = mesh.mesh_dim_names
    mesh_tag = "x".join(str(n) for n in mesh.shape)
    t0 = time.time()

    params = fns.init(torch.Generator(), device="meta")
    local = shape
    if shape.kind != "train":
        mesh, local = _pod_replicas(mesh, shape)
    pspecs = shlib.param_pspecs(params, mesh, embed_mode=embed_mode,
                                param_mode=param_mode, moe_mode=moe_mode)
    trace = hlo_analysis.CollectiveTrace()
    memory = MemTracker()
    extra: dict = {}
    if shape.kind == "train":
        ga = grad_accum or GRAD_ACCUM.get(shape_name, {}).get(arch, 1)
        n_pods = shlib.axis_sizes(mesh).get("pod", 1)
        act_sh = shlib.NamedSharding(mesh, ("data", None, None)) \
            if act_sharding == "batch" else None
        step = steps.make_train_step(
            cfg, lr=LR, grad_accum=ga, attn_impl=attn_impl, remat=True,
            accum_mode=accum_mode, gather_dtype=gather_dtype,
            grad_pspecs=pspecs if grad_sharding == "fsdp" else None,
            mesh=mesh if grad_sharding == "fsdp" else None,
            act_sharding=act_sh, spmd_pod="pod" in names)
        stacked = tree.map(lambda p: _meta((n_pods,) + tuple(p.shape),
                                           p.dtype), params)
        sspecs = shlib.stack_pspecs_for_pods(pspecs, mesh)
        sp = shlib.distribute(stacked, sspecs, mesh)
        batch = {k: _meta(s.shape, s.dtype) for k, s in
                 shlib.stacked_batch_sds(cfg, shape, mesh).items()}
        sb = shlib.distribute(batch, shlib.batch_pspecs(cfg, shape,
                                                        mesh), mesh)
        rows = tree.leaves(sb)[0].shape[1] // ga
        n_rows = steps.row_shards(tree.leaves(sb)[0], 1)
        if rows % n_rows:
            # the step would replicate each microbatch over the batch's
            # dims (steps.microbatch_layout): not the sharded program
            raise NotImplementedError(
                f"dry run of {arch} × {shape_name}: a microbatch of {rows} "
                f"rows does not shard evenly over the {n_rows} ranks of the "
                "batch's mesh dims; DTensor cannot lay out the uneven shard "
                "(aten._unsafe_view), where XLA pads it (ROADMAP item 19.5)")
        with memory, trace:
            new, loss = step(sp, sb)
        args_b = shlib.local_bytes((sp, sb))
        out_b = shlib.local_bytes((new, loss))
        extra = {"grad_accum": ga, "embed_mode": embed_mode,
                 "accum_mode": accum_mode, "gather_dtype": gather_dtype,
                 "grad_sharding": grad_sharding,
                 "act_sharding": act_sharding, "param_mode": param_mode,
                 "moe_mode": moe_mode}
        # Eq. 5, run separately: every T steps, across 'pod'
        with hlo_analysis.CollectiveTrace() as ext:
            steps.external_sync_step(sp)
        ext_coll = hlo_analysis.collective_bytes(ext)
        extra["external_sync_collective_bytes"] = ext_coll
        extra["external_sync_t_s"] = sum(
            v for k, v in ext_coll.items()
            if k != "count") / hlo_analysis.LINK_BW
    elif shape.kind == "prefill":
        dp = shlib.dp_spec_axes(mesh)
        act_sh = shlib.NamedSharding(mesh, (dp, None, None)) \
            if act_sharding == "batch" else None
        batch = {k: _meta(s.shape, s.dtype) for k, s in
                 configs.input_specs(cfg, local).items()}
        bspecs = {k: (dp,) + (None,) * (len(v.shape) - 1)
                  for k, v in batch.items()}
        dparams = shlib.distribute(params, pspecs, mesh)
        db = shlib.distribute(batch, bspecs, mesh)
        with memory, trace, torch.no_grad():
            logits = fns.forward(dparams, db, attn_impl=attn_impl,
                                 act_sharding=act_sh)
            # the JAX program's output layout: batch over dp, vocab
            # over 'model'
            logits = logits.redistribute(mesh, shlib.placements(
                (dp, None, "model"), mesh))
        args_b = shlib.local_bytes((dparams, db))
        out_b = shlib.local_bytes(logits)
    else:  # decode
        windowed = cfg.has_attention and shape_name == "long_500k"
        b = local.global_batch
        kw = {"windowed": windowed}
        if cfg.is_encoder_decoder:
            kw["enc_len"] = _enc_len(shape)
        cache = fns.init_decode_cache(b, shape.seq_len, device="meta",
                                      **kw)
        cspecs = shlib.decode_cache_pspecs(cfg, cache, mesh, batch=b,
                                           cross_mode=cross_mode)
        dp = shlib.dp_spec_axes(mesh)
        tok_spec = (dp, None) if b > 1 else (None, None)
        dparams = shlib.distribute(params, pspecs, mesh)
        dcache = shlib.distribute(cache, cspecs, mesh)
        tokens = shlib.distribute(_meta((b, 1), torch.int32), tok_spec,
                                  mesh)
        args_b = shlib.local_bytes((dparams, dcache, tokens))
        step = steps.make_serve_step(cfg, windowed=windowed)
        with memory, trace:
            nxt, dcache = step(dparams, dcache, tokens,
                               shape.seq_len - 1)
            nxt = nxt.redistribute(mesh, shlib.placements(tok_spec,
                                                          mesh))
        out_b = shlib.local_bytes((nxt, dcache))
        extra = {"windowed": windowed, "cross_mode": cross_mode}
    t_run = time.time() - t0

    ga_used = extra.get("grad_accum", 1)
    analytic = roofline_model.analytic_roofline(cfg, shape,
                                                grad_accum=ga_used)
    roof = hlo_analysis.analyze(trace, chips=chips, analytic=analytic,
                                loop_trips=_loop_trips(cfg, shape, ga_used))
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag,
        "chips": chips,
        "params": cfg.param_count(),
        "params_active": cfg.param_count(active_only=True),
        "lower_s": round(t_run, 1),
        "memory_analysis": {
            "argument_size_in_bytes": args_b,
            "output_size_in_bytes": out_b,
            "temp_size_in_bytes": memory.get_tracker_snapshot("peak").get(
                torch.device("meta"), {}).get("Total", 0)},
        "roofline": roof.as_dict(),
        **extra,
    }
    if verbose:
        r = roof
        print(f"[dryrun] {arch} × {shape_name} × {mesh_tag}: "
              f"run {t_run:.1f}s | FLOPs {r.flops:.3e} | "
              f"bytes {r.hbm_bytes:.3e} | coll {r.total_coll_bytes:.3e} "
              f"({r.coll_bytes['count']} ops) | bottleneck={r.bottleneck} "
              f"useful={r.useful_flops_ratio:.2f}", flush=True)
        print(f"         per-rank bytes: {result['memory_analysis']}",
              flush=True)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(configs.INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch × shape) for the chosen mesh")
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--attn-impl", default="naive",
                    choices=("naive", "blockwise", "auto", "pallas"))
    ap.add_argument("--embed-mode", choices=("fsdp", "replicated_vocab",
                                             "vocab_model"),
                    default="fsdp")
    ap.add_argument("--accum-mode", choices=("grad_each", "loss_scan"),
                    default="grad_each")
    ap.add_argument("--gather-dtype", choices=("fp32", "bf16"),
                    default="fp32")
    ap.add_argument("--grad-sharding", choices=("none", "fsdp"),
                    default="none")
    ap.add_argument("--act-sharding", choices=("none", "batch"),
                    default="none")
    ap.add_argument("--param-mode", choices=("fsdp", "tp_only"),
                    default="fsdp")
    ap.add_argument("--moe-mode", choices=("ep_fsdp", "ep_only"),
                    default="ep_fsdp")
    ap.add_argument("--cross-mode", choices=("head_sharded", "seq_sharded"),
                    default="head_sharded")
    ap.add_argument("--preset", choices=("baseline", "optimized"),
                    default="baseline",
                    help="'optimized' applies the JAX package's per-family "
                         "flags (overrides individual flags)")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("give --arch and --shape, or --all")

    torch.set_num_threads(1)
    os.makedirs(args.out_dir, exist_ok=True)
    combos = ([(a, s) for a in configs.ARCH_IDS
               for s in configs.INPUT_SHAPES]
              if args.all else [(args.arch, args.shape)])
    failures = []
    for arch, shape in combos:
        tag = f"{arch}__{shape}__{'2x16x16' if args.multi_pod else '16x16'}"
        flags = {"embed_mode": args.embed_mode,
                 "accum_mode": args.accum_mode,
                 "gather_dtype": args.gather_dtype,
                 "grad_sharding": args.grad_sharding,
                 "act_sharding": args.act_sharding,
                 "param_mode": args.param_mode,
                 "moe_mode": args.moe_mode, "cross_mode": args.cross_mode}
        if args.preset == "optimized":
            flags.update(optimized_flags(arch, configs.get_config(arch)))
        try:
            res = lower_combo(arch, shape, multi_pod=args.multi_pod,
                              grad_accum=args.grad_accum,
                              attn_impl=args.attn_impl, **flags)
            with open(os.path.join(args.out_dir, tag + ".json"), "w") as f:
                json.dump(res, f, indent=1)
        except Exception:
            print(f"[dryrun] FAILED {tag}", flush=True)
            traceback.print_exc()
            failures.append(tag)
    if failures:
        raise SystemExit(f"dry-run failures: {failures}")
    print("[dryrun] all combinations ran on the meta device OK")


if __name__ == "__main__":
    main()
