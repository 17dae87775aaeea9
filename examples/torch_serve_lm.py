"""Serving example of the PyTorch port: batched auto-regressive decoding of
an assigned architecture (its smoke config) with a KV cache / SSM state,
through the same serve step as ``python -m repro_torch.launch.serve``.
The same run as ``examples/serve_lm.py``: from the same arch and flags it
prints the same first sequence.

  PYTHONPATH=src python examples/torch_serve_lm.py --arch mamba2-780m
  PYTHONPATH=src python examples/torch_serve_lm.py --arch granite-8b \\
      --windowed --device cpu

The first token of each row is drawn from ``MarkovLMStream``; one warm-up
step runs on a cache of its own (the decode step writes the KV caches and
the Mamba2 state in place, so a warm-up on the served cache would advance
it), then ``--gen`` greedy steps from position 0. Without ``--device`` it
runs on the card.
"""
import argparse
import time

import torch

from repro_torch import configs
from repro_torch.core import prng
from repro_torch.data.lm_data import MarkovLMStream
from repro_torch.launch import steps
from repro_torch.launch.train import resolve_device
from repro_torch.models import build


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=configs.ARCH_IDS, default="mamba2-780m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--gen", type=int, default=48)
    ap.add_argument("--windowed", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = configs.get_smoke_config(args.arch)
    if cfg.is_encoder_decoder:
        raise SystemExit("enc-dec serving: see tests/test_torch_encdec.py")
    fns = build(cfg)
    params = fns.init(prng.PRNGKey(0), device)
    new_cache = lambda: fns.init_decode_cache(
        args.batch, args.gen + 8, windowed=args.windowed, device=device)
    serve_step = steps.make_serve_step(cfg, windowed=args.windowed)

    stream = MarkovLMStream(cfg.vocab_size, seed=0)
    tok = torch.as_tensor(stream.sample(args.batch, 1), dtype=torch.int32,
                          device=device)
    serve_step(params, new_cache(), tok, 0)          # warm-up, cache dropped

    sync = torch.cuda.synchronize if device.type == "cuda" else lambda: None
    cache = new_cache()
    sync()
    t0 = time.perf_counter()
    toks = [tok]
    for i in range(args.gen):
        tok, cache = serve_step(params, cache, toks[-1], i)
        toks.append(tok)
    sync()
    dt = time.perf_counter() - t0
    out = torch.cat(toks, dim=1).cpu().numpy()
    print(f"arch={cfg.name} ({'windowed ' if args.windowed else ''}cache) "
          f"batch={args.batch}: {args.gen} steps in {dt:.2f}s "
          f"= {1e3 * dt / args.gen:.1f} ms/step, "
          f"{args.batch * args.gen / dt:.0f} tok/s")
    print("first sequence:", out[0, :24].tolist())
    return {"tokens": out, "seconds": dt, "ms_per_step": 1e3 * dt / args.gen}


if __name__ == "__main__":
    main()
