"""Federated training entry point of the port: Alg. 1 on the FEMNIST CNN.

Runs FEDGS (host engine, gradient-space Eq. 4, mean aggregation) end to
end on the synthetic FEMNIST stream with the paper's hyperparameters as
defaults (M=10, K=35, L=10, L_rnd=2, T=50, R=500, η=0.01, n=32). The flags
are the JAX CLI's (``python -m repro.launch.train``) for this path, plus
``--device``; from the same ``--seed`` both print the same round lines.

  PYTHONPATH=src python -m repro_torch.launch.train --rounds 20 --iters 10
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --smoke-model --groups 4 --devices-per-group 8 --selected 4 \\
      --presampled 1 --iters 5 --rounds 3 --batch-size 8 --lr 0.05

It runs on the GPU, where the GBP-CS loop, both conv layers and the Eq. 5
average run as the port's CUDA kernels; ``--device cpu`` runs their plain
PyTorch versions instead. Asking for ``cuda`` without a card is an error.
"""
from __future__ import annotations

import argparse
import json
import math
import os

import torch

from ..configs import femnist_cnn
from ..core import fedgs, prng
from ..data import FactoryStreams, PartitionConfig, femnist, make_partition
from ..models import cnn


def resolve_device(name: str) -> torch.device:
    """The run's device. ``cuda`` without a card raises: the port never
    carries on quietly on the CPU. Sets strict f32 matmuls and convs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was requested but no CUDA device "
                           "is available; pass --device cpu to run the "
                           "plain PyTorch versions on the CPU")
    return torch.device(name)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--groups", type=int, default=10, help="M factories")
    ap.add_argument("--devices-per-group", type=int, default=35, help="K^m")
    ap.add_argument("--selected", type=int, default=10, help="L")
    ap.add_argument("--presampled", type=int, default=2, help="L_rnd")
    ap.add_argument("--iters", type=int, default=50, help="T per round")
    ap.add_argument("--rounds", type=int, default=500, help="R")
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--selection", choices=("gbp_cs", "random"),
                    default="gbp_cs")
    ap.add_argument("--init", choices=("mpinv", "zero"), default="mpinv")
    ap.add_argument("--alpha", type=float, default=0.3, help="Dirichlet skew")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--smoke-model", action="store_true",
                    help="reduced CNN for quick runs")
    ap.add_argument("--log-json", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda runs the CUDA kernels; cpu their plain "
                         "PyTorch versions")
    return ap


def format_record(rec: fedgs.RoundRecord) -> str:
    msg = f"round {rec.round:4d} | loss {rec.loss:.4f}"
    if not math.isnan(rec.divergence):
        msg += f" | divergence {rec.divergence:.4f}"
    if not math.isnan(rec.group_discrepancy):
        msg += (f" | disc {rec.group_discrepancy:.4f}"
                f" | resel {rec.reselections:.0f}")
    if rec.test_accuracy is not None:
        msg += (f" | test acc {rec.test_accuracy:.4f} "
                f"loss {rec.test_loss:.4f}")
    return msg


def main(argv: list[str] | None = None) -> list[dict]:
    """Run the CLI; returns the per-round records as dicts."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    part = make_partition(PartitionConfig(
        num_factories=args.groups, devices_per_factory=args.devices_per_group,
        alpha=args.alpha, seed=args.seed))
    test_x, test_y = femnist.make_test_set(n_per_class=20)
    eval_fn = cnn.make_eval_fn(test_x, test_y, device)
    mcfg = femnist_cnn.smoke_config() if args.smoke_model \
        else femnist_cnn.CONFIG
    params = cnn.init_cnn(prng.PRNGKey(args.seed), mcfg, device)
    fcfg = fedgs.FedGSConfig(
        num_groups=args.groups, devices_per_group=args.devices_per_group,
        num_selected=args.selected, num_presampled=args.presampled,
        iters_per_round=args.iters, rounds=args.rounds, lr=args.lr,
        selection=args.selection, init=args.init, seed=args.seed)
    streams = FactoryStreams(part, batch_size=args.batch_size, seed=args.seed)
    logs_out = []

    def log_fn(rec):
        print(format_record(rec), flush=True)
        logs_out.append(rec.to_dict())

    fedgs.run_fedgs(params, streams, part.p_real, fcfg,
                    group_loss_fn=cnn.make_group_loss_fn(), eval_fn=eval_fn,
                    eval_every=args.eval_every, log_fn=log_fn)
    if args.log_json:
        os.makedirs(os.path.dirname(args.log_json) or ".", exist_ok=True)
        with open(args.log_json, "w") as f:
            json.dump(logs_out, f, indent=1)
    return logs_out


if __name__ == "__main__":
    main()
