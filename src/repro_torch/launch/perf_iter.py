"""Hill-climbing runner: run one combo of the meta-device dry run under a
stack of flags and print the roofline-term deltas against the saved
baseline artifact (the port of the JAX package's ``launch/perf_iter.py``).

  PYTHONPATH=src python -m repro_torch.launch.perf_iter --arch granite-8b \\
      --shape train_4k --embed-mode replicated_vocab --grad-sharding fsdp

The baseline is ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``
(``launch.dryrun``'s artifact); ``--tag`` saves this run's artifact under
``experiments/perf_torch/<tag>.json``.
"""
from __future__ import annotations

import argparse
import json
import os

from .. import configs

TERMS = ("t_compute_s", "t_memory_s", "t_collective_s")
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


def deltas(base: dict, new: dict) -> list[str]:
    """The lines of the delta table between two artifacts' rooflines."""
    lines = ["--- delta vs baseline ---"]
    for term in TERMS:
        b, n = base[term], new[term]
        pct = (n - b) / b * 100 if b else float("nan")
        lines.append(f"{term:16s} {b:.3e} -> {n:.3e}  ({pct:+.1f}%)")
    bc, nc = base["collective_bytes"], new["collective_bytes"]
    for k in KINDS:
        lines.append(f"  {k:20s} {bc.get(k, 0):.3e} -> {nc.get(k, 0):.3e}")
    return lines


def main(argv=None) -> None:
    from . import dryrun
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--shape", required=True,
                    choices=tuple(configs.INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--embed-mode", default="fsdp")
    ap.add_argument("--accum-mode", default="grad_each")
    ap.add_argument("--gather-dtype", default="fp32")
    ap.add_argument("--grad-sharding", default="none")
    ap.add_argument("--act-sharding", default="none")
    ap.add_argument("--param-mode", default="fsdp")
    ap.add_argument("--moe-mode", default="ep_fsdp")
    ap.add_argument("--cross-mode", default="head_sharded")
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--base-dir", default=dryrun.OUT_DIR)
    ap.add_argument("--tag", default=None, help="save artifact as this tag")
    args = ap.parse_args(argv)

    res = dryrun.lower_combo(
        args.arch, args.shape, multi_pod=args.multi_pod,
        grad_accum=args.grad_accum, embed_mode=args.embed_mode,
        accum_mode=args.accum_mode, gather_dtype=args.gather_dtype,
        grad_sharding=args.grad_sharding, act_sharding=args.act_sharding,
        param_mode=args.param_mode, moe_mode=args.moe_mode,
        cross_mode=args.cross_mode)

    mesh = "2x16x16" if args.multi_pod else "16x16"
    base_path = os.path.join(args.base_dir,
                             f"{args.arch}__{args.shape}__{mesh}.json")
    if os.path.exists(base_path):
        with open(base_path) as f:
            base = json.load(f)["roofline"]
        print("\n".join(deltas(base, res["roofline"])))
    if args.tag:
        os.makedirs("experiments/perf_torch", exist_ok=True)
        out = f"experiments/perf_torch/{args.tag}.json"
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
        print(f"saved {out}")


if __name__ == "__main__":
    main()
