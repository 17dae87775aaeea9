"""Batched decode driver: serve an LM with a KV cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
      --batch 4 --prompt-len 32 --gen 32 --device cpu

The flags are the JAX CLI's (``python -m repro.launch.serve``) plus
``--device``; the CLI runs the smoke config of ``--arch``, and from the
same ``--seed`` both CLIs print the same token ids. The prompt is fed one
token at a time through the decode step (prefill by repeated decode, as
the JAX CLI does), then ``--gen`` tokens are generated greedily. The
dense, SSM (``mamba2-780m``) and hybrid (``zamba2-7b``) archs run; the
others raise ``NotImplementedError``. On the card the model's GEMMs run in
strict f32 (TF32 off), and the KV-cache attention and the Mamba2 state
update are plain PyTorch (decode launches none of the port's kernels);
``--device cpu`` runs it on the CPU. Asking for ``cuda`` without a card is
an error. :func:`serve` is the body, for any config (``chip_smoke.py``
drives it at full width).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import configs
from ..core import prng
from ..data.lm_data import MarkovLMStream
from ..models import build
from . import steps
from .train import resolve_device


def serve(cfg, *, batch: int = 4, prompt_len: int = 32, gen: int = 32,
          windowed: bool = False, seed: int = 0,
          device: str | torch.device = "cuda") -> dict:
    """Serve ``cfg`` from a threefry init of ``seed``: prints the timing
    line and the first 16 generated ids of row 0, and returns
    ``{"tokens": (batch, gen) int32 array,
    "seconds", "steps", "ms_per_step", "tok_per_s"}``."""
    device = torch.device(device)
    if cfg.is_encoder_decoder:
        raise SystemExit("enc-dec serving is not ported yet "
                         "(ROADMAP item 18)")
    fns = build(cfg)
    params = fns.init(prng.PRNGKey(seed), device)
    max_len = prompt_len + gen
    cache = fns.init_decode_cache(batch, max_len, windowed=windowed,
                                  device=device)
    stream = MarkovLMStream(cfg.vocab_size, seed=seed)
    prompts = torch.as_tensor(stream.sample(batch, prompt_len),
                              device=device)
    serve_step = steps.make_serve_step(cfg, windowed=windowed)

    sync = torch.cuda.synchronize if device.type == "cuda" else lambda: None
    sync()
    t0 = time.perf_counter()
    for i in range(prompt_len):
        nxt, cache = serve_step(params, cache, prompts[:, i:i + 1], i)
    generated = [nxt]
    for i in range(prompt_len, max_len - 1):
        nxt, cache = serve_step(params, cache, generated[-1], i)
        generated.append(nxt)
    out = torch.cat(generated, dim=1)
    sync()
    dt = time.perf_counter() - t0
    n_steps = max_len - 1
    print(f"arch={cfg.name} batch={batch} steps={n_steps} "
          f"total {dt:.2f}s  ({1e3 * dt / n_steps:.1f} ms/step, "
          f"{batch * n_steps / dt:.1f} tok/s)", flush=True)
    tokens = out.cpu().numpy().astype(np.int32)
    print("sample generation (token ids):", tokens[0, :16].tolist(),
          flush=True)
    return {"tokens": tokens, "seconds": dt, "steps": n_steps,
            "ms_per_step": 1e3 * dt / n_steps,
            "tok_per_s": batch * n_steps / dt}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=configs.ARCH_IDS, default="granite-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--windowed", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda runs the model on the card; cpu on the CPU")
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    return serve(configs.get_smoke_config(args.arch), batch=args.batch,
                 prompt_len=args.prompt_len, gen=args.gen,
                 windowed=args.windowed, seed=args.seed, device=device)


if __name__ == "__main__":
    main()
