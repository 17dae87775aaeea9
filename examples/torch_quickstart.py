"""Quickstart of the PyTorch port: FEDGS on the public API.

Trains the paper's CNN (reduced for a quick run) on the synthetic
non-i.i.d. FEMNIST stream with GBP-CS group client selection, then compares
the selection divergence against random selection. The same run as
``examples/quickstart.py``; on the card GBP-CS, both conv layers and the
Eq. 5 average run as the port's CUDA kernels.

  PYTHONPATH=src python examples/torch_quickstart.py              # the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

from repro_torch.configs import femnist_cnn
from repro_torch.core import fedgs, prng
from repro_torch.data import (FactoryStreams, PartitionConfig, femnist,
                              make_partition)
from repro_torch.launch.train import resolve_device
from repro_torch.models import cnn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--groups", type=int, default=4, help="M factories")
    ap.add_argument("--devices", type=int, default=12,
                    help="K OCR cameras per factory")
    ap.add_argument("--selected", type=int, default=4, help="L")
    ap.add_argument("--presampled", type=int, default=1, help="L_rnd")
    ap.add_argument("--iters", type=int, default=10, help="T per round")
    ap.add_argument("--rounds", type=int, default=8, help="R")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--test-per-class", type=int, default=8)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. A modern industrial park: M factories × K OCR cameras, non-iid.
    part = make_partition(PartitionConfig(
        num_factories=args.groups, devices_per_factory=args.devices,
        alpha=0.3, seed=0))

    # 2. The paper's 4-layer CNN (reduced for the quickstart).
    mcfg = femnist_cnn.smoke_config()

    # 3. FEDGS: GBP-CS selects L devices per factory each iteration
    #    (L_rnd random + L_sel optimized); internal sync every iteration,
    #    external sync every T.
    cfg = fedgs.FedGSConfig(
        num_groups=args.groups, devices_per_group=args.devices,
        num_selected=args.selected, num_presampled=args.presampled,
        iters_per_round=args.iters, rounds=args.rounds, lr=0.05,
        selection="gbp_cs")

    test_x, test_y = femnist.make_test_set(n_per_class=args.test_per_class)
    eval_fn = lambda p: cnn.evaluate(p, test_x, test_y)

    def run(cfg, **kw):
        streams = FactoryStreams(part, batch_size=args.batch_size, seed=0)
        params = cnn.init_cnn(prng.PRNGKey(0), mcfg, device)
        return fedgs.run_fedgs(params, streams, part.p_real, cfg,
                               group_loss_fn=cnn.make_group_loss_fn(), **kw)

    _, logs = run(cfg, eval_fn=eval_fn, eval_every=2, log_fn=lambda l: print(
        f"round {l.round:2d}  loss {l.loss:.3f}  divergence "
        f"{l.divergence:.4f}"
        + (f"  acc {l.test_accuracy:.3f}" if l.test_accuracy else "")))
    print(f"\nfinal divergence (GBP-CS): {logs[-1].divergence:.4f}")

    # 4. Ablation: the same run with FedAvg-style random selection.
    _, logs_r = run(fedgs.FedGSConfig(**{**vars(cfg),
                                         "selection": "random"}))
    print(f"final divergence (random):  {logs_r[-1].divergence:.4f}")
    print("GBP-CS super nodes are closer to the global class distribution"
          if logs[-1].divergence < logs_r[-1].divergence else "unexpected!")
    return logs, logs_r


if __name__ == "__main__":
    main()
