"""GBP-CS of the PyTorch port as a general constrained 0-1 optimizer (paper
§V claim: "can be used for other practical cases such as game matching").

Demo: balanced team drafting — pick a team of L players out of K so the
team's six-skill vector matches a target profile. Compares GBP-CS (the
``gbp_cs`` kernel on the card) against random, Monte Carlo and brute-force
drafting. The same instance as ``examples/gbp_cs_demo.py``.

  PYTHONPATH=src python examples/torch_gbp_cs_demo.py              # the card
  PYTHONPATH=src python examples/torch_gbp_cs_demo.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core import samplers
from repro_torch.launch.train import resolve_device

TARGET = [25, 25, 20, 20, 15, 15]          # desired profile of six skills


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)
    K, F, L = 40, len(TARGET), 5        # 40 players, 6 skills, team of 5
    skills = rng.integers(0, 10, size=(F, K)).astype(np.float32)
    target = np.asarray(TARGET, np.float32)

    print(f"drafting {L} of {K} players to match profile "
          f"{target.tolist()}\n")
    results = {}
    for name in ("random", "mc", "gbp_cs", "brute"):
        kw = {"device": device} if name == "gbp_cs" else {}
        res = results[name] = samplers.SAMPLERS[name](skills, target, L,
                                                      **kw)
        team = res.selected.tolist()
        got = skills[:, res.selected].sum(1)
        print(f"{name:8s} | mismatch {res.distance:7.3f} | "
              f"{res.wall_time_s*1e3:8.1f} ms | team {team} | "
              f"profile {got.astype(int).tolist()}")
    return results


if __name__ == "__main__":
    main()
