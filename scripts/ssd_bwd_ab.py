"""Time this checkout's ``ssd_scan`` backward kernel against other
checkouts' on one card, in turns.

  python3 scripts/ssd_bwd_ab.py OTHER_CHECKOUT [OTHER_CHECKOUT ...]

Runs a child process per checkout in turns, the others, this, this, the
others in reverse, each with its own checkout's ``src`` on the path (each builds its kernel library into its
own ``build/``). A child runs the backward (``kernels.ssd_scan_bwd.
backward``) at mamba2-780m's training microbatch (2, 2048, 48, 64, 128,
chunk 128) and zamba2-7b's (1, 4096, 112, 64, 64, 128) on inputs drawn
from one seed, and prints one JSON line: the mean ms of a call (CUDA
events, 10 calls after 2 warm-ups), the sums of |dx|, |ddt|, |dA|, |dB|,
|dC| (both checkouts see the same inputs), and, where the checkout's
wrapper has a per-launch switch (``PARTS``), each launch timed alone on
the buffers of a full call. Prints the card's name and power limit, each
turn's line, and each checkout's mean ms per shape. Needs one card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"mamba2-780m": (2, 2048, 48, 64, 128, 128),
          "zamba2-7b": (1, 4096, 112, 64, 64, 128)}

CHILD = r"""
import json, sys, torch
sys.path.insert(0, "src")
from repro_torch.kernels import ssd_scan as kssd, ssd_scan_bwd as kb
torch.backends.cuda.matmul.allow_tf32 = False

def time_ms(fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps

out = {}
for name, (bt, s, h, p, n, q) in SHAPES.items():
    gen = torch.Generator(device="cuda").manual_seed(12)
    x, dt, A, B, C = kssd.example_inputs(gen, bt, s, h, p, n)
    dy = torch.randn(x.shape, generator=gen, device="cuda")
    call = kssd.prepare(x, dt, A, B, C, q)
    kssd.run(call)
    args = (call["x"], dt, A, call["B"], call["C"], call["states"], dy, q)
    grads = kb.backward(*args)
    row = {"ms": time_ms(lambda: kb.backward(*args)),
           "abs_sums": [float(g.double().abs().sum()) for g in grads]}
    if hasattr(kb, "PARTS"):
        bwd = kb.prepare(*args)
        kb.run(bwd)
        row["split"] = {part: time_ms(lambda: kb.run(bwd, 1 << i))
                        for i, part in enumerate(kb.PARTS)}
    out[name] = row
    del x, dt, A, B, C, dy, call, args, grads
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def turn(checkout: str) -> dict:
    code = f"SHAPES = {SHAPES!r}\n" + CHILD
    res = subprocess.run([sys.executable, "-c", code], cwd=checkout,
                         capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        sys.exit(f"ssd_bwd_ab: {checkout} failed:\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> None:
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    others = [os.path.abspath(a) for a in sys.argv[1:]]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    order = others + [HERE, HERE] + others[::-1]
    runs = {path: [] for path in others + [HERE]}
    for path in order:
        row = turn(path)
        runs[path].append(row)
        print(f"{os.path.relpath(path, HERE)}: {json.dumps(row)}", flush=True)
    for name in SHAPES:
        print(f"{name}: " + "; ".join(
            f"{os.path.relpath(path, HERE)} "
            f"{[round(r[name]['ms'], 4) for r in rows]} ms, mean "
            f"{sum(r[name]['ms'] for r in rows) / len(rows):.4f}"
            for path, rows in runs.items()), flush=True)


if __name__ == "__main__":
    main()
