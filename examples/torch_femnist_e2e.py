"""End-to-end script of the PyTorch port: train the paper's FULL 4-layer
CNN (6,603,710 parameters) with FEDGS on the streaming non-i.i.d. FEMNIST
surrogate, save a checkpoint and a JSON training log, and check the
Prop. 4 time-efficiency condition.

Paper protocol: M=10, K=35, L=10, T=50. By default T×R = 300 iterations
(≈ the paper's first 6 rounds); pass --rounds 500 --iters 50 for the full
25k-iteration run. The same run as ``examples/femnist_e2e.py``; on the
card GBP-CS, both conv layers (training and the host-batched eval) and the
Eq. 5 average run as the port's CUDA kernels.

  PYTHONPATH=src python examples/torch_femnist_e2e.py [--rounds 10 --iters 30]
  PYTHONPATH=src python examples/torch_femnist_e2e.py --device cpu \\
      --smoke-model --groups 3 --devices 8 --selected 3 --rounds 2 --iters 2
"""
import argparse
import json
import os

from repro_torch import checkpoint as ckpt
from repro_torch import tree
from repro_torch.configs import femnist_cnn
from repro_torch.core import fedgs, prng, theory
from repro_torch.data import (FactoryStreams, PartitionConfig, femnist,
                              make_partition)
from repro_torch.launch.train import resolve_device
from repro_torch.models import cnn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--groups", type=int, default=10)
    ap.add_argument("--devices", type=int, default=35)
    ap.add_argument("--selected", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--test-per-class", type=int, default=20)
    ap.add_argument("--smoke-model", action="store_true",
                    help="reduced CNN for quick runs")
    ap.add_argument("--out", default="experiments/torch_femnist_e2e")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    part = make_partition(PartitionConfig(
        num_factories=args.groups, devices_per_factory=args.devices,
        alpha=0.3, seed=0))
    streams = FactoryStreams(part, batch_size=args.batch_size, seed=0)
    mcfg = femnist_cnn.smoke_config() if args.smoke_model \
        else femnist_cnn.CONFIG
    params = cnn.init_cnn(prng.PRNGKey(0), mcfg, device)
    n_params = sum(leaf.numel() for leaf in tree.leaves(params))
    print(f"model: paper 4-layer CNN, {n_params/1e6:.2f}M params")

    cfg = fedgs.FedGSConfig(
        num_groups=args.groups, devices_per_group=args.devices,
        num_selected=args.selected, num_presampled=2,
        iters_per_round=args.iters, rounds=args.rounds, lr=0.01)

    tx, ty = femnist.make_test_set(n_per_class=args.test_per_class)
    logs_out = []

    def log_fn(l):
        line = (f"round {l.round:3d} | loss {l.loss:.4f} | "
                f"div {l.divergence:.4f}")
        if l.test_accuracy is not None:
            line += f" | acc {l.test_accuracy:.4f}"
        print(line, flush=True)
        logs_out.append(l.to_dict())

    final, _ = fedgs.run_fedgs(
        params, streams, part.p_real, cfg,
        group_loss_fn=cnn.make_group_loss_fn(),
        eval_fn=lambda p: cnn.evaluate(p, tx, ty),
        eval_every=2, log_fn=log_fn)

    path = ckpt.save(os.path.join(args.out, "ckpt"), final,
                     step=args.rounds * args.iters)
    with open(os.path.join(args.out, "log.json"), "w") as f:
        json.dump(logs_out, f, indent=1)
    print(f"checkpoint: {path}")

    # Prop. 4 sanity: is this configuration communication-efficient?
    net = theory.NetworkModel()
    ok = theory.efficiency_condition(args.iters, args.groups,
                                     args.selected, net)
    print(f"Prop.4 efficiency condition (B_int/B_ext="
          f"{net.b_int/net.b_ext:.0f}): {'satisfied' if ok else 'violated'}")
    return final, logs_out, path


if __name__ == "__main__":
    main()
