"""Chip smoke test of the PyTorch/CUDA port: build, check and drive it.

  python3 chip_smoke.py

Needs one CUDA card. Phases, in order (any failure exits non-zero before
the last line):

1. environment — torch/CUDA versions, the card's name and power limit;
2. build — compiles ``src/repro_torch/csrc/*.cu`` (one nvcc per source, in
   parallel) into ``build/repro_torch_kernels/`` and prints each kernel
   instance's registers and spills from ``-Xptxas -v``; beside it, one more
   nvcc compiles ``csrc/probe/latency_probe.cu`` into a library of its own
   (measurement only: no path runs it);
3. kernel checks — each kernel against its plain PyTorch version on the
   card (``gbp_cs`` also timed per launch inside a CUDA graph beside an
   empty kernel's node and its latency floor: the chain that
   ``gbp_cs_chain`` in ``csrc/gbp_cs.cu`` counts, priced at the latencies
   that ``csrc/probe/latency_probe.cu`` measures), at the shapes of the paths
   (M=10 groups, K=35 devices, L=10,
   n=32: a 3200-image superbatch through the full-width CNN, and conv2's
   shape in the conv kernel's ``pool=False`` form; the robust
   path's (M, L, |θ|) member-gradient stack; the compress path's (M, |θ|)
   gradient rows for top-k, with each row's candidates and route, and
   with an all-ties and an overflow row, and for int8; ``corrupt_rows`` on
   its sweep and on the robust path's (M·L, P4) member buffer, with the
   CLI's typical fault trace and with every row Gaussian), with times;
4. main path — ``python -m repro_torch.launch.train`` at full width for
   2 rounds of 3 iterations, with every kernel's launch count checked
   against what the path implies; one profiled full-width round (host
   spans, device busy share, top kernels); then the smoke configuration on
   the card against the same run's plain versions on the CPU;
5. robust path (DESIGN.md §15) — the same CLI with ``--corrupt
   scale+nan_burst+gauss_noise --robust-agg trimmed_mean``, driven, counted
   (one ``corrupt_rows`` launch per iteration) and profiled the same way,
   and its smoke configuration card vs CPU;
6. compress path (DESIGN.md §18) — the same CLI with ``--compress-int
   topk:0.01+int8 --compress-ext int8``, driven, counted and profiled the
   same way; three compressed smoke configurations card vs CPU, their
   ``--log-json`` byte ledgers equal;
6b. fused path (the device-resident engine, ``--engine fused``) — the
   CLI at full width (R=2, T=3), one CUDA graph per round in segments
   around the eager ``pinv``: the wrappers' counts (they move at the eager
   warm-up round and at the capture, not at a replay) and, from a second
   run of the CLI under ``torch.profiler``, each kernel's executions on
   the card, which must be the host loop's launches plus one warm-up
   round's; graph against eager over
   4 rounds (states bit-equal), ``gbp_cs`` against its plain version on
   the path's instances, ms per internal iteration eager and replayed
   beside the host loop's, one traced replay, the device stream's share
   of an iteration; the smoke configuration card vs CPU; all of it again
   with the compress flags, and with the robust flags (the fault trace
   staged with the round's keys; the CLI run must seat a corrupted
   member; peak device memory of the graph and eager runs), whose smoke
   configuration, Gaussian noise in the mix, is held card vs CPU plain
   and with ``--compress-int topk:0.1+int8``;
6c. baselines (the Table II strategies, ``--strategy``) — each of the
   fourteen through the CLI at full width and the paper's traffic (C = M·L
   = 100 clients a round, S = 10 local steps, n = 32, R = 2, eval at round
   2) on ``--engine host`` and ``--engine fused``, the wrappers' counts
   held to the formula of ``baseline_round_launches`` (the fused capture
   to one round's); the fused rounds as CUDA graphs against their eager
   run, bit for bit, with ms per round (host loop, replayed, eager) and
   peak device memory; five strategies' smoke configurations card vs CPU
   on both engines to 1e-4; ``agg_weighted`` at K = 100 client models and
   ``conv_fused`` at G = 100 client CNNs against their plain versions,
   with kernel, plain and library times;
7. LM path (the dense-LM serving slice, ``granite-3-2b`` at full width
   and depth) — ``flash_attention`` against its plain version at the
   prefill shape (2, 4096, 32/8 heads, 64) in f32 (causal, causal with
   window 1024, non-causal; kernel, plain and SDPA times, SDPA both as the
   GQA call and on K/V expanded to 32 heads; TFLOP/s and share of the
   bound), at zamba2-7b's
   shape (1, 4096, 32/32 heads, 112) and on the JAX package's sweep in f32
   and bf16; one full-width prefill forward (``attn_impl="pallas"``,
   tokens (2, 4096) from ``MarkovLMStream``) with exactly 40 kernel
   launches, timed and profiled; ``serve()`` at the JAX CLI's defaults
   (batch 4, prompt 32, gen 32; no kernel launch); decode against prefill
   at full width, plain and ring buffer; then the smoke config card vs CPU
   (serve token ids, prefill logits);
8. SSM and hybrid paths (the Mamba2 serving slice) — ``ssd_scan`` against
   its plain version on a sweep (chunk 64/128, N 16–256, P 32/64, one
   chunk, chunks shorter than the kernel's 128 rows, up to 32 chunks) and
   at both full-width prefill shapes, with kernel and plain times and each
   of its four launches timed on its own; ``mamba2-780m`` at full
   width and depth: prefill (4, 2048) from ``MarkovLMStream`` with exactly
   48 ``ssd_scan`` launches, timed and profiled, decode against prefill,
   ``serve()`` at batch 4, prompt 32, gen 32; ``zamba2-7b`` at full width
   and depth: prefill (1, 4096) with exactly 81 ``ssd_scan`` and 14
   ``flash_attention`` (D = 112) launches, timed and profiled, decode
   against prefill (its full-width ``serve()`` is left out for time); both
   smoke configs card vs CPU (serve token ids, prefill logits);
6d. after the baselines, the drift phase (DESIGN.md §13) and the
   availability phase (§14), the population phase (DESIGN.md §17):
   ``dirichlet_rows`` with one concentration per element against its
   plain version bit for bit (the 350 devices seated at D = 10⁶, the 10
   factory priors at α = 1; per launch in a CUDA graph and eager); the CLI
   with ``--devices 1000000 --reselect-every 3`` at full width on the host
   loop and the fused engine (launch counts held to ``fedgs_expect``, the
   table's launch included; graph == eager over the same population), the
   same at ``--devices 10000`` with peak device memory within 16 MB of D =
   10⁶'s; fedavg over the lazy pool on both engines; the README's
   ``--devices 1000000 --groups 8 --devices-per-group 16`` command, fused,
   2 rounds; the smoke configuration with ``--devices 1000`` card vs CPU,
   alone and with the availability, robust and drift flags, and fedavg;
9. one JSON line of kernel results, the ``nvidia-smi`` line, and the
   result line ``{"ok": true, "device": {...}}``.

Imports nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import ctypes
import gc
import io
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W); the int32
# rate is the Hopper white paper's 64 INT32 lanes per SM x 132 SMs x the
# 1.98 GHz boost clock that the FP32 peak assumes.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
INT32_OPS = 132 * 64 * 1.98e9
# 32-bit integer operations of one threefry draw in csrc/int8_quant.cu:
# counter add 1, 20 x (add, rotate, xor), 5 x 2 key-injection adds, the
# output xor, the uniform's shift and or
THREEFRY_INT_OPS = 1 + 20 * 3 + 5 * 2 + 1 + 2


def main_flags(rounds: int, iters: int, eval_every: int) -> list[str]:
    """The CLI at the paper's traffic and full CNN width, depth cut."""
    return ["--groups", "10", "--devices-per-group", "35", "--selected",
            "10", "--presampled", "2", "--batch-size", "32", "--seed", "0",
            "--rounds", str(rounds), "--iters", str(iters), "--eval-every",
            str(eval_every)]


SMOKE_FLAGS = ["--groups", "4", "--devices-per-group", "8", "--selected",
               "4", "--presampled", "1", "--iters", "5", "--rounds", "3",
               "--batch-size", "8", "--smoke-model", "--lr", "0.05",
               "--eval-every", "2"]
ROBUST_FLAGS = ["--corrupt", "scale+nan_burst+gauss_noise", "--robust-agg",
                "trimmed_mean"]
ROBUST_SMOKE_FLAGS = ["--corrupt", "scale+nan_burst", "--corrupt-frac",
                      "0.25", "--quarantine-limit", "2", "--robust-agg",
                      "trimmed_mean"]
# the fused robust path's smoke configuration, Gaussian noise in the mix
FUSED_ROBUST_SMOKE_FLAGS = ["--corrupt", "scale+nan_burst+gauss_noise",
                            "--corrupt-frac", "0.25", "--quarantine-limit",
                            "2", "--robust-agg", "trimmed_mean"]
COMPRESS_FLAGS = ["--compress-int", "topk:0.01+int8", "--compress-ext",
                  "int8"]
COMPRESS_SMOKE_FLAGS = [
    COMPRESS_FLAGS,
    ["--compress-int", "int8", "--compress-ext", "topk:0.01"],
    ROBUST_SMOKE_FLAGS + ["--compress-int", "topk:0.1+int8"],
]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def ptxas_lines(log: str) -> list[str]:
    """One line per compiled kernel instance of ``nvcc -Xptxas -v``'s log:
    source, entry (mangled), registers, spill stores and loads."""
    out, src, entry, spill = [], "", "", ""
    for line in log.splitlines():
        if line.startswith("== "):
            src = line[3:].strip()
        elif "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and entry:
            regs = line.split("Used")[1].split(",")[0].strip()
            out.append(f"ptxas {src} {entry}: {regs}; {spill}")
            entry = ""
    return out


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_: float, ops: float, rate: float = FP32_FLOPS
          ) -> tuple[float, str]:
    """Least time in ms: bytes over HBM's rate or ops over ``rate``."""
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


PROBE_SRC = os.path.join(ROOT, "src", "repro_torch", "csrc", "probe",
                         "latency_probe.cu")
CHAIN_OPS = ("shfl", "lds", "fma", "div", "sqrt")


def start_probe_build():
    """One nvcc of ``csrc/probe/latency_probe.cu`` into a library of its
    own, started beside the kernel library's build: (process, path)."""
    from repro_torch.kernels import build
    out = build.BUILD_DIR / "latency_probe.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(
        [build.find_nvcc(), build.ARCH, "-std=c++17", "-O3", "-Xcompiler",
         "-fPIC", "-shared", PROBE_SRC, "-o", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def load_probe(proc, out) -> ctypes.CDLL:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"nvcc failed on latency_probe.cu:\n{log}")
    lib = ctypes.CDLL(str(out))
    lib.noop_launch.argtypes = [ctypes.c_void_p]
    lib.latency_probe.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p]
    lib.noop_launch.restype = lib.latency_probe.restype = ctypes.c_int
    return lib


def chain_latencies(torch, probe, dev, n: int = 4096) -> dict[str, float]:
    """Cycles per dependent operation on the card: a shuffle+add round, a
    shared-memory load, an FMA, an IEEE division and a square root, and
    the SM clock in GHz over the same kernel."""
    from repro_torch.kernels import build
    out = torch.zeros(8, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for _ in range(2):                    # the second run is the one read
        build.check(probe.latency_probe(out.data_ptr(), n, stream),
                    "latency_probe")
    c = out.cpu().tolist()
    lat = {name: c[i] / n for i, name in enumerate(CHAIN_OPS)}
    lat["ghz"] = c[5] / c[6]
    return lat


def gbp_cs_chain(f: int, k: int) -> tuple[dict, dict]:
    """The kernel's dependent chain as ``csrc/gbp_cs.cu`` counts it: (one
    step, the set-up before the first step), operations by kind."""
    from repro_torch.kernels import build
    out = (ctypes.c_int * 10)()
    build.check(build.library().gbp_cs_chain(f, k, ctypes.addressof(out)),
                "gbp_cs_chain")
    return dict(zip(CHAIN_OPS, out[:5])), dict(zip(CHAIN_OPS, out[5:]))


def chain_ms(chain: dict[str, int], lat: dict[str, float]) -> float:
    """A chain of dependent operations priced in ms at ``lat``."""
    return sum(n * lat[op] for op, n in chain.items()) / lat["ghz"] * 1e-6


def graph_ms(torch, fn, n: int = 50, reps: int = 5) -> float:
    """Device time per call of ``fn`` inside a CUDA graph of ``n`` calls
    (CUDA events around each replay, the best of ``reps``): the cost of
    the launches without the host's."""
    from repro_torch.core import engine
    side = engine.capture_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / n)
    return best


def check_gbp_cs(torch, dev, probe):
    """GBP-CS on FactoryStreams instances of the main path: masks and trip
    counts equal to the plain version on 8 draws, distances to 1e-3; the
    wrapper's time eagerly, the device time per launch in a CUDA graph of
    50 launches, an empty kernel's time per graph node, and the latency
    floor: the node time plus the chain of the launch (its set-up, then
    s_max steps, the most steps of any group) priced at the latencies
    ``csrc/probe/latency_probe.cu`` measures here."""
    from repro_torch.core import gbp_cs, prng, selection
    from repro_torch.data import (FactoryStreams, PartitionConfig,
                                  make_partition)
    from repro_torch.kernels import build
    from repro_torch.kernels import gbp_cs as kgbp

    m, k, l, l_rnd, max_iters = 10, 35, 10, 2, 64
    part = make_partition(PartitionConfig(num_factories=m,
                                          devices_per_factory=k, seed=0))
    p_real = torch.as_tensor(part.p_real, device=dev)
    key = prng.PRNGKey(0)
    err, steps, first = 0.0, 0, None
    for it in range(8):
        key, sub = prng.split(key)
        streams = FactoryStreams(part, batch_size=32, seed=it)
        counts = torch.as_tensor(streams.next_counts(), device=dev)
        _, _, A, y = selection.gbp_cs_instances(prng.split(sub, m), counts,
                                                p_real, l, l_rnd)
        x0 = gbp_cs.init_mpinv(A, y, l - l_rnd).contiguous()
        xk, dk, ik, tk = kgbp.minimize(A, y, x0, max_iters)
        xp, dp, ip, tp = kgbp.minimize_plain(A, y, x0, max_iters)
        torch.cuda.synchronize()
        if not torch.equal(xk, xp):
            fail(f"gbp_cs: masks differ from the plain version (draw {it})")
        if not torch.equal(ik, ip):
            fail(f"gbp_cs: iteration counts differ: {ik.tolist()} vs "
                 f"{ip.tolist()}")
        err = max(err, float((dk - dp).abs().max()),
                  float((tk - tp).abs().max()))
        steps += int(ik.sum())
        if first is None:
            first = (A, y, x0, ik)
    # one instance past the register-resident templates (K > 128): the
    # kernel's shared-memory form
    gen = torch.Generator(device=dev).manual_seed(0)
    Ab = torch.randint(0, 9, (4, 62, 200), generator=gen, device=dev).float()
    yb = Ab.sum(-1) * (30 / 200) + torch.rand(4, 62, generator=gen,
                                               device=dev)
    xb = gbp_cs.init_zero(Ab, yb, 30).contiguous()
    outb = kgbp.minimize(Ab, yb, xb, max_iters)
    refb = kgbp.minimize_plain(Ab, yb, xb, max_iters)
    if not (torch.equal(outb[0], refb[0]) and torch.equal(outb[2], refb[2])):
        fail("gbp_cs: the F=62, K=200 instance differs from the plain "
             "version")
    err = max(err, float((outb[1] - refb[1]).abs().max()))
    tol = 1e-3
    if err > tol:
        fail(f"gbp_cs: distance error {err} > {tol}")
    A, y, x0, iters = first
    g, f, kc = A.shape
    ms = time_ms(lambda: kgbp.minimize(A, y, x0, max_iters), reps=50)
    g_ms = graph_ms(torch, lambda: kgbp.minimize(A, y, x0, max_iters))
    setup_ms = graph_ms(torch, lambda: kgbp.minimize(A, y, x0, 0))
    node_ms = graph_ms(torch, lambda: build.check(probe.noop_launch(
        torch.cuda.current_stream(dev).cuda_stream), "noop"))
    plain_ms = time_ms(lambda: kgbp.minimize_plain(A, y, x0, max_iters),
                       reps=5, warmup=1)
    lat = chain_latencies(torch, probe, dev)
    step, init = gbp_cs_chain(f, kc)
    s, s_max = int(iters.sum()), int(iters.max())
    floor_ms = node_ms + chain_ms(init, lat) + s_max * chain_ms(step, lat)
    # bytes and FLOP of the carried design: A, y, x0 in, the outputs out;
    # the first product, then per step A^T r and the column update
    ops = g * (2 * f * kc + 3 * f) + s * (2 * f * kc + 8 * f + 3 * kc)
    bytes_ = 4 * (g * f * kc + g * f + 2 * g * kc + 2 * g
                  + g * (max_iters + 1))
    b_ms, b_by = bound(bytes_, ops)
    print(f"gbp_cs: G={g} F={f} K={kc}, {steps} steps over 8 draws, masks "
          f"and iteration counts equal (and at F=62 K=200, "
          f"{int(outb[2].sum())} steps), max |d err| {err:.3g} (tol {tol}); "
          f"first draw {s} steps, s_max {s_max}: {ms:.4f} ms eager, "
          f"{g_ms:.5f} ms per launch in a graph ({setup_ms:.5f} at "
          f"max_iters 0), empty node {node_ms:.5f} "
          f"ms; latency floor {floor_ms:.5f} ms (step chain {step}, set-up "
          f"{init}; cycles per op "
          f"{', '.join(f'{n} {v:.1f}' for n, v in lat.items() if n != 'ghz')}"
          f" at {lat['ghz']:.3f} GHz); bytes/FLOP bound {b_ms:.7f} ms "
          f"({b_by})", flush=True)
    return dict(name=kgbp.NAME, route="cuda", source=kgbp.SOURCE,
                replaces=kgbp.REPLACES, max_abs_err=err, tol=tol, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, graph_ms=g_ms, setup_ms=setup_ms,
                node_ms=node_ms,
                floor_ms=floor_ms, latencies=lat,
                shape=f"G={g} F={f} K={kc} steps={s} s_max={s_max}")


def check_conv(torch, dev):
    """Both conv layers of the full-width CNN over the 3200-image
    superbatch (G=10 groups of L·n=320 images), and conv2's shape in the
    kernel's ``pool=False`` form (no path runs it: checked and timed, not
    counted in the entry's totals)."""
    from repro_torch.kernels import conv_fused as kconv

    gen = torch.Generator(device=dev).manual_seed(0)
    g, b = 10, 320
    worst, rows, tol = 0.0, [], 1e-4
    for name, h, cin, cout, pool in (("conv1", 28, 1, 32, True),
                                     ("conv2", 14, 32, 64, True),
                                     ("conv2 pool=False", 14, 32, 64, False)):
        x = torch.rand(g, b, h, h, cin, generator=gen, device=dev)
        w = torch.randn(g, 5, 5, cin, cout, generator=gen, device=dev) \
            / math.sqrt(25 * cin)
        bias = 0.1 * torch.randn(g, cout, generator=gen, device=dev)
        pat = kconv.im2col(x, (5, 5))
        wm = w.reshape(g, 25 * cin, cout).contiguous()
        out_k, y_k = kconv.fused(pat, wm, bias, h, pool=pool)
        out_p, y_p = kconv.fused_plain(pat, wm, bias, h, pool=pool)
        err = max(float((y_k - y_p).abs().max()),
                  float((out_k - out_p).abs().max()))
        if err > tol:
            fail(f"conv_fused {name}: max error {err} > {tol}")
        worst = max(worst, err)
        r, q = pat.shape[1], pat.shape[2]
        ms = time_ms(lambda: kconv.fused(pat, wm, bias, h, pool=pool),
                     reps=10)
        plain_ms = time_ms(
            lambda: kconv.fused_plain(pat, wm, bias, h, pool=pool), reps=10)
        lib_ms = time_ms(lambda: torch.baddbmm(bias[:, None, :], pat, wm),
                         reps=10)
        out_rows = g * r * cout // 4 if pool else g * r * cout
        bytes_ = 4 * (g * r * q + g * q * cout + g * cout + g * r * cout
                      + out_rows)
        ops = 2 * g * r * q * cout + 2 * g * r * cout
        b_ms, b_by = bound(bytes_, ops)
        rows.append(dict(layer=name, G=g, R=r, Q=q, C=cout, pool=pool,
                         ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                         tflops=ops / ms / 1e9, share_of_bound=b_ms / ms))
        print(f"conv_fused {name}: G={g} R={r} Q={q} C={cout} max err "
              f"{err:.3g} (tol {tol}); {ms:.4f} ms kernel, {plain_ms:.4f} "
              f"ms plain, {lib_ms:.4f} ms baddbmm, bound {b_ms:.4f} ms "
              f"({b_by}), {ops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.0%} of "
              "the bound", flush=True)
        del x, pat, out_k, y_k, out_p, y_p
        torch.cuda.empty_cache()
    path = [row for row in rows if row["pool"]]
    tot = lambda key: sum(row[key] for row in path)
    return dict(name=kconv.NAME, route="cuda", source=kconv.SOURCE,
                replaces=kconv.REPLACES, max_abs_err=worst, tol=tol,
                ms=tot("ms"), plain_ms=tot("plain_ms"),
                bound_ms=tot("bound_ms"),
                bound_by=max(path, key=lambda r: r["bound_ms"])["bound_by"],
                library_ms=tot("library_ms"),
                shape="conv1 + conv2 forward, G=10, 3200 images",
                layers=rows)


def check_agg(torch, dev):
    """Eq. 5 over the M=10 stacked full-width models."""
    from repro_torch.configs import femnist_cnn
    from repro_torch.kernels import agg_weighted as kagg
    from repro_torch.models import cnn

    m = 10
    params = cnn.init_cnn(torch.Generator().manual_seed(0),
                          femnist_cnn.CONFIG, dev)
    n_par = sum(v.numel() for layer in params.values()
                for v in layer.values())
    gen = torch.Generator(device=dev).manual_seed(1)
    stacked = {name: {k: v[None] + 0.01 * torch.randn(
        (m,) + tuple(v.shape), generator=gen, device=dev)
        for k, v in layer.items()} for name, layer in params.items()}
    flat = kagg.flatten(stacked, m)
    w = torch.full((m,), 1.0 / m, device=dev)
    out_k = kagg.agg(flat, w)
    out_p = kagg.agg_plain(flat, w)
    err, tol = float((out_k - out_p).abs().max()), 1e-6
    if err > tol:
        fail(f"agg_weighted: max error {err} > {tol}")
    k, p = flat.shape
    ms = time_ms(lambda: kagg.agg(flat, w), reps=50)
    plain_ms = time_ms(lambda: kagg.agg_plain(flat, w), reps=20)
    lib_ms = time_ms(lambda: torch.matmul(w[None], flat), reps=50)
    b_ms, b_by = bound(4 * (k * p + k + p), 2 * k * p)
    print(f"agg_weighted: K={k} P={p} (|θ|={n_par}) max err {err:.3g} "
          f"(tol {tol}); {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
          f"{lib_ms:.4f} ms matmul, bound {b_ms:.4f} ms ({b_by})",
          flush=True)
    return dict(name=kagg.NAME, route="cuda", source=kagg.SOURCE,
                replaces=kagg.REPLACES, max_abs_err=err, tol=tol, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, shape=f"K={k} P={p}")


def check_robust_agg(torch, dev, p: int = 6_603_712):
    """The order statistics of the robust Eq. 4 over the robust path's
    member-gradient stack, (M, L, P4) = (10, 10, 6,603,712): both methods,
    trim in {0, 1, 4}, with exact ties between rows, inactive members and a
    group with none active. Timed on the path's common case: every member
    active, trimmed_mean, trim 1."""
    from repro_torch.kernels import robust_agg as krob

    m, k = 10, 10
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(m, k, p, generator=gen, device=dev)
    x[:, 5] = x[:, 0]                       # whole rows tie
    x[:, 7, ::2] = x[:, 3, ::2]             # every other coordinate ties
    active = torch.ones(m, k, device=dev)
    active[torch.arange(m), torch.arange(m)] = 0.0   # one member out
    active[8, :5] = 0.0                     # four members left
    active[9] = 0.0                         # none left: the result is 0
    # trimmed sums run in ascending order in both versions, but the plain
    # version's reduction may group them otherwise: |values| <= 6 here,
    # <= 10 terms, a few ulps of their sum; medians must be equal
    tol = 5e-6
    err = {}
    for method in krob.METHODS:
        for trim in (0, 1, 4):
            out_k = krob.aggregate(x, active, method, trim)
            out_p = krob.aggregate_plain(x, active, method, trim)
            e = float((out_k - out_p).abs().max())
            if method == "coord_median" and not torch.equal(out_k, out_p):
                fail(f"robust_agg coord_median trim={trim}: differs from the "
                     f"plain version by {e}")
            if e > tol:
                fail(f"robust_agg {method} trim={trim}: max error {e} > {tol}")
            err[(method, trim)] = e
            del out_k, out_p
    active.fill_(1.0)
    ms = time_ms(lambda: krob.aggregate(x, active, "trimmed_mean", 1),
                 reps=20)
    med_ms = time_ms(lambda: krob.aggregate(x, active, "coord_median", 1),
                     reps=20)
    plain_ms = time_ms(
        lambda: krob.aggregate_plain(x, active, "trimmed_mean", 1), reps=3,
        warmup=1)
    sort_ms = time_ms(lambda: torch.sort(x, dim=1), reps=3, warmup=1)
    # every member active: each value read once, one result per coordinate;
    # the reference's K(K-1)/2 pairwise compares and K adds per coordinate
    b_ms, b_by = bound(4 * (m * k * p + m * k + m * p),
                       m * p * (k * (k - 1) // 2 + k))
    worst = max(err.values())
    print(f"robust_agg: M={m} K={k} P={p} max err trimmed_mean "
          f"{max(e for (me, _), e in err.items() if me == 'trimmed_mean'):.3g}"
          f" (tol {tol}), coord_median 0; {ms:.4f} ms kernel (trimmed_mean, "
          f"trim 1), {med_ms:.4f} ms coord_median, {plain_ms:.4f} ms plain, "
          f"{sort_ms:.4f} ms torch.sort(dim=1) alone, bound {b_ms:.4f} ms "
          f"({b_by})", flush=True)
    del x
    torch.cuda.empty_cache()
    return dict(name=krob.NAME, route="cuda", source=krob.SOURCE,
                replaces=krob.REPLACES, max_abs_err=worst, tol=tol, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, median_ms=med_ms, sort_ms=sort_ms,
                shape=f"M={m} K={k} P={p}")


# the compress path's (M, P4) gradient rows: |θ| = 6,603,710 padded to 4
CNN_PARAMS, CNN_P4 = 6_603_710, 6_603_712


def gradient_rows(torch, dev, seed: int):
    """(10, P4) gradient-like rows (per-row scales 1e-4..1e-1, heavy-tailed
    by a cube), the two pad columns zero."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(10, CNN_P4, generator=gen, device=dev) ** 3
    x *= torch.logspace(-4, -1, 10, device=dev)[:, None]
    x[:, CNN_PARAMS:] = 0.0
    return x


def check_topk_compress(torch, dev):
    """Top-k of the compress path, k from |θ| at 1%: rows with a run of
    exact ties at each row's threshold (k lands inside it, the ties spread
    over every block of the row), zeros and -0.0; one more row holding
    NaN and ±inf. Every finite row must equal the plain version exactly;
    each row's candidate count and route are printed. Then the same rows
    with row 0 of one magnitude (every coordinate a tie) and row 1 of one
    magnitude with a few larger values: both overflow the candidate
    buffer and must take the overflow route, the others not, and every
    finite row must still equal the plain version."""
    from repro_torch.core import compress
    from repro_torch.kernels import topk_compress as ktop

    m, p, n = 10, CNN_P4, CNN_PARAMS
    k = compress.topk_count(n, 0.01)
    x = gradient_rows(torch, dev, 3)
    gen = torch.Generator(device=dev).manual_seed(4)
    tau = torch.kthvalue(-x.abs(), k, dim=1).values.neg()      # (M,)
    ties = torch.randint(0, n, (m, 4000), generator=gen, device=dev)
    sign = torch.where(torch.rand(m, 4000, generator=gen, device=dev) < 0.5,
                       -1.0, 1.0)
    x.scatter_(1, ties, sign * tau[:, None])
    x[:, 1:n:97] = 0.0
    x[:, 5:n:101] = -0.0
    x[m - 1, 17] = float("nan")
    x[m - 1, n // 3] = float("inf")
    x[m - 1, 2 * n // 3] = -float("inf")
    fin = list(range(m - 1))

    def exact(x, label):
        out_k, stats = ktop.select_with_stats(x, k)
        out_p = ktop.select_plain(x, k)
        torch.cuda.synchronize()
        if not torch.equal(out_k[fin], out_p[fin]):
            bad = (out_k[fin] != out_p[fin]).sum().item()
            fail(f"topk_compress ({label}): {bad} coordinates differ from "
                 "the plain version on the finite rows")
        kept = int((out_k[m - 1] != 0).sum())
        if kept > k:
            fail(f"topk_compress ({label}): the non-finite row kept {kept} "
                 f"> k = {k}")
        cands, routes = stats[:, 2].tolist(), stats[:, 3].tolist()
        print(f"topk_compress {label}: candidates per row {cands} (buffer "
              f"{ktop.candidate_capacity(p)} per row), route per row "
              f"{routes} (1 candidates, 0 overflow)", flush=True)
        return kept, routes

    kept, routes = exact(x, "gradient rows")
    if not all(routes):
        fail(f"topk_compress: a gradient row overflowed: routes {routes}")
    nties = int((x[fin].abs() == tau[fin, None]).sum())
    ms = time_ms(lambda: ktop.select(x, k), reps=20)
    plain_ms = time_ms(lambda: ktop.select_plain(x, k), reps=3, warmup=1)
    lib_ms = time_ms(lambda: torch.topk(x.abs(), k, dim=1, sorted=False),
                     reps=10)
    # one read and one write of the rows; one compare per coordinate
    b_ms, b_by = bound(8 * m * p, m * p)
    print(f"topk_compress: M={m} P4={p} n={n} k={k}, {nties} exact ties at "
          f"the thresholds, finite rows equal to the plain version, the "
          f"NaN/inf row kept {kept}; {ms:.4f} ms kernel, "
          f"{plain_ms:.4f} ms plain (stable sort), {lib_ms:.4f} ms "
          f"torch.topk (not tie-stable), bound {b_ms:.4f} ms ({b_by})",
          flush=True)

    x[0] = torch.where(torch.arange(p, device=dev) % 3 == 0, -0.25, 0.25)
    x[1] = 0.5
    x[1, 7:n:n // 20] = 2.0
    x[1, n:] = 0.0
    _, routes = exact(x, "with an all-ties row 0 and an overflow row 1")
    if routes[:2] != [0, 0] or not all(routes[2:]):
        fail(f"topk_compress: routes {routes}, want overflow on rows 0 and "
             "1 only")
    del x
    torch.cuda.empty_cache()
    return dict(name=ktop.NAME, route="cuda", source=ktop.SOURCE,
                replaces=ktop.REPLACES, max_abs_err=0.0, tol=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, shape=f"M={m} P4={p} k={k}")


def check_int8(torch, dev):
    """Stochastic int8 of the compress path's rows, a different key per
    row: bit-equal to the plain version (threefry in PyTorch int64 ops)."""
    from repro_torch.core import prng
    from repro_torch.kernels import int8_quant as kq

    m, p = 10, CNN_P4
    x = gradient_rows(torch, dev, 5)
    x[3, ::2] = 0.0
    keys = prng.split(prng.PRNGKey(7), m)
    out_k = kq.quantize(x, keys)
    out_p = kq.quantize_plain(x, keys)
    torch.cuda.synchronize()
    if not torch.equal(out_k.view(torch.int32), out_p.view(torch.int32)):
        bad = (out_k != out_p).sum().item()
        fail(f"int8_quant: {bad} coordinates differ from the plain version")
    del out_p
    ms = time_ms(lambda: kq.quantize(x, keys), reps=20)
    plain_ms = time_ms(lambda: kq.quantize_plain(x, keys), reps=3,
                       warmup=1)
    b_ms, b_by = bound(8 * m * p, THREEFRY_INT_OPS * m * p, INT32_OPS)
    print(f"int8_quant: M={m} P4={p}, bit-equal to the plain version; "
          f"{ms:.4f} ms kernel, {plain_ms:.4f} ms plain, bound {b_ms:.4f} "
          f"ms ({b_by}: {THREEFRY_INT_OPS} int32 ops per coordinate at "
          f"{INT32_OPS / 1e12:.1f} Tops/s)", flush=True)
    del x, out_k
    torch.cuda.empty_cache()
    return dict(name=kq.NAME, route="cuda", source=kq.SOURCE,
                replaces=kq.REPLACES, max_abs_err=0.0, tol=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, shape=f"M={m} P4={p}")


def check_corrupt_rows(torch, dev):
    """The fault injection against its plain version: the sweep
    (``kernels.corrupt.SWEEP``), then the robust path's member stack
    (M·L, P4) = (100, 6,603,712) with the CLI's fault trace at an
    iteration that seats a Gaussian row (its typical fill) and with every
    row Gaussian. NaN/Inf/scale/sign rows, untouched rows and pads must be
    bit-equal, Gaussian rows within 2e-6·σ (``log1pf`` against
    ``torch.log1p``, and the plain erfinv's Horner steps rounded through
    double). The all-Gaussian plain version runs in 25-row slices (its
    int64 threefry takes ~10 GB a row slice of 25)."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.configs import femnist_cnn
    from repro_torch.core import prng
    from repro_torch.data import CorruptionConfig, make_corruption_fn
    from repro_torch.kernels import corrupt as kc
    from repro_torch.models import cnn

    tol, worst = 2e-6, 0.0
    gen = torch.Generator(device=dev).manual_seed(4)
    for case in kc.SWEEP:
        x, code, keys, sizes, modes = kc.sweep_inputs(case, gen)
        for sigma in (1.0, 0.25):
            out = kc.corrupt_rows(x.clone(), code, keys, sizes, modes, 25.0,
                                  sigma)
            ref = kc.corrupt_rows_plain(x.clone(), code, keys, sizes, modes,
                                        25.0, sigma)
            exact, err = kc.max_error(out, ref, code, modes, sigma)
            if not exact or err > tol:
                fail(f"corrupt_rows sweep {case[:2]}: exact {exact}, gauss "
                     f"error {err} sigma > {tol}")
            worst = max(worst, err)
    print(f"corrupt_rows sweep ({len(kc.SWEEP)} cases x sigma 1, 0.25): "
          f"exact rows bit-equal, gauss max err {worst:.3g} sigma (tol {tol})",
          flush=True)

    params = cnn.init_cnn(prng.PRNGKey(0), femnist_cnn.CONFIG, dev)
    sizes = [leaf.numel() for leaf in tree.leaves(params)]
    del params
    m, l, k, p, p4 = 10, 10, 35, CNN_PARAMS, CNN_P4
    cfn = make_corruption_fn(CorruptionConfig(mode=ROBUST_FLAGS[1]), 0)
    seats = np.arange(m)[:, None] * k + np.arange(l)
    gauss = 1 + cfn.modes.index("gauss_noise")
    t = next(t for t in range(1, 100)
             if (cfn.trace(t, seats, len(sizes))[0] == gauss).any())
    code, keys = cfn.device_trace(t, seats.reshape(-1), len(sizes), dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(m * l, p4, generator=gen, device=dev) * 1e-2
    x[:, p:] = 0.0
    fills = {"typical": code, "all gauss": torch.full_like(code, gauss)}
    res = {}
    for fill, c in fills.items():
        out = cfn.apply(x.clone(), c, keys, sizes)
        ref = x.clone()
        step = m * l if fill == "typical" else 25
        for r0 in range(0, m * l, step):        # in place, row slices
            kc.corrupt_rows_plain(ref[r0:r0 + step], c[r0:r0 + step],
                                  keys[r0:r0 + step], sizes, cfn.modes,
                                  cfn.config.scale, cfn.config.sigma)
        exact, err = kc.max_error(out, ref, c, cfn.modes, cfn.config.sigma)
        del out, ref
        if not exact or err > tol:
            fail(f"corrupt_rows {fill} at ({m * l}, {p4}): exact {exact}, "
                 f"gauss error {err} sigma > {tol}")
        buf = x.clone()
        ms = time_ms(lambda: cfn.apply(buf, c, keys, sizes), reps=20)
        if fill == "typical":
            plain_ms = time_ms(lambda: kc.corrupt_rows_plain(
                buf, c, keys, sizes, cfn.modes, cfn.config.scale,
                cfn.config.sigma), reps=3, warmup=1)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for r0 in range(0, m * l, 25):
                kc.corrupt_rows_plain(buf[r0:r0 + 25], c[r0:r0 + 25],
                                      keys[r0:r0 + 25], sizes, cfn.modes,
                                      cfn.config.scale, cfn.config.sigma)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t0)
        del buf
        torch.cuda.empty_cache()
        counts = {mode: int((c == j + 1).sum()) for j, mode in
                  enumerate(cfn.modes)}
        # each hit row's P coordinates written once and, but for NaN/Inf,
        # read once; 74 int32 operations per Gaussian coordinate
        read = sum(v for mode, v in counts.items()
                   if mode not in ("nan_burst", "inf_spike"))
        b_ms, b_by = bound(4 * p * (sum(counts.values()) + read),
                           THREEFRY_INT_OPS * p * counts["gauss_noise"],
                           INT32_OPS)
        res[fill] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, err=err, counts=counts)
        print(f"corrupt_rows {fill} (t={t}, rows hit by mode {counts} of "
              f"{m * l}, P4={p4}): exact rows bit-equal, gauss max err "
              f"{err:.3g} sigma; {ms:.4f} ms kernel, {plain_ms:.4f} ms plain"
              f"{' (25-row slices)' if fill != 'typical' else ''}, bound "
              f"{b_ms:.4f} ms ({b_by}); library: none (no PyTorch call draws "
              "threefry normals)", flush=True)
    del x
    torch.cuda.empty_cache()
    typ, full = res["typical"], res["all gauss"]
    return dict(name=kc.NAME, route="cuda", source=kc.SOURCE,
                replaces=kc.REPLACES,
                max_abs_err=max(worst, typ["err"], full["err"]), tol=tol,
                ms=typ["ms"], plain_ms=typ["plain_ms"],
                bound_ms=typ["bound_ms"], bound_by=typ["bound_by"],
                library_ms=None, all_gauss_ms=full["ms"],
                all_gauss_plain_ms=full["plain_ms"],
                all_gauss_bound_ms=full["bound_ms"],
                all_gauss_bound_by=full["bound_by"],
                shape=f"R={m * l} P4={p4}, typical {typ['counts']}")


class _Stamps(io.TextIOBase):
    """stdout tee that stamps every 'round' line with the host clock."""

    def __init__(self, out):
        self.out, self.stamps, self.lines = out, [], []

    def write(self, s):
        for line in s.splitlines():
            if line.startswith("round"):
                self.stamps.append(time.perf_counter())
                self.lines.append(line)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def run_cli(argv):
    from repro_torch.launch import train
    tee = _Stamps(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        logs = train.main(argv)
    return logs, tee, t0


def drive(label, flags, expect, torch):
    """Run the CLI at full width with every launch count set to 0 just
    before and read just after; fail unless they equal ``expect`` and the
    round records are sane. Returns (records, counts, ms per internal
    iteration of the last round)."""
    from repro_torch.core import dispatch

    iters = int(flags[flags.index("--iters") + 1])
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    logs, tee, t_start = run_cli(flags)
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    if counts != expect:
        fail(f"{label}: launch counts {counts} != the path's {expect}")
    for rec in logs:
        vals = [rec["loss"], rec["divergence"], rec["group_discrepancy"]]
        if not all(math.isfinite(v) for v in vals):
            fail(f"{label}: non-finite round record {rec}")
    acc = logs[-1]["test_accuracy"]
    if acc is None or not 0.0 <= acc <= 1.0:
        fail(f"{label}: no valid test accuracy in the last round: {acc}")
    round_s = [b - a for a, b in zip([t_start] + tee.stamps, tee.stamps)]
    ms_iter = 1e3 * round_s[-1] / iters
    print(f"{label}: {len(logs)} rounds x {iters} iterations at full width, "
          f"launches {counts}; round wall times "
          f"{[round(s, 3) for s in round_s]} s; {ms_iter:.1f} ms per internal "
          "iteration in the last round (incl. its eval)", flush=True)
    return logs, counts, ms_iter


def profile_round(label, flags, torch) -> None:
    """One traced round at full width: the host loop's spans (``fedgs.*``,
    device synchronised at each span's ends; ``fedgs.train.*`` split the
    robust train step and time the compression of the Eq. 4 gradient,
    ``fedgs.external_sync.compress`` that of the Eq. 5 delta), device busy
    time and the top kernels by device time (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import fedgs

    iters = 3
    torch.cuda.synchronize()
    fedgs.SPANS = {}
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, _, t0 = run_cli(main_flags(1, iters, 1) + flags)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        spans = {k: 1e3 * v for k, v in fedgs.SPANS.items()}
    finally:
        fedgs.SPANS = None
    # top-level spans tile the loop; fedgs.X.* nest inside fedgs.X
    loop_ms = sum(v for k, v in spans.items() if k.count(".") == 1)
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0), reverse=True)
    busy = sum(k[0] for k in kernels)
    share = f"{100 * busy / loop_ms:.1f}%" if busy > 0 and loop_ms > 0 \
        else "not measured"
    print(f"{label} profile: 1 round x {iters} iterations + eval at full "
          f"width, wall {wall_ms:.1f} ms with set-up, loop spans "
          f"{loop_ms:.1f} ms; device busy {busy:.1f} ms = {share} of the "
          "loop", flush=True)
    print(f"{label} profile host spans (ms, summed over the round): "
          + ", ".join(f"{k} {v:.1f}" for k, v in sorted(spans.items())),
          flush=True)
    for ms, count, name in kernels[:12]:
        print(f"{label} profile device: {ms:9.3f} ms  x{count:<5d} "
              f"{name[:90]}", flush=True)


COUNTED = ("resel", "corr", "rb")     # integers that must be equal


def smoke_card_vs_cpu(label, flags) -> None:
    """The smoke configuration: kernels on the card vs plain versions on
    the CPU, round lines to 2e-3 with the counted fields equal; the
    ``--log-json`` byte ledgers equal and ``compress_error`` to 1e-2
    relative (stochastic int8 turns the two devices' last-bit differences
    in the gradients into whole-quantum ones, which later iterations carry
    on; tests/test_torch_compress.py measures the same drift between the
    JAX package and the port on the CPU)."""
    logs_gpu, tee_gpu, _ = run_cli(SMOKE_FLAGS + flags + ["--device", "cuda"])
    logs_cpu, tee_cpu, _ = run_cli(SMOKE_FLAGS + flags + ["--device", "cpu"])
    ce_worst = 0.0
    for rg, rc in zip(logs_gpu, logs_cpu):
        for name in ("bytes_int", "bytes_ext"):
            if rg[name] != rc[name]:
                fail(f"{label} smoke: {name} differs card vs CPU: "
                     f"{rg[name]} vs {rc[name]}")
        cg, cc = rg["compress_error"], rc["compress_error"]
        if (cg is None) != (cc is None):
            fail(f"{label} smoke: compress_error {cg} vs {cc}")
        if cg is not None:
            ce_worst = max(ce_worst, abs(cg - cc) / max(abs(cc), 1e-30))
    if ce_worst > 1e-2:
        fail(f"{label} smoke: compress_error differs card vs CPU by "
             f"{ce_worst} relative")
    worst = 0.0
    for lg, lc in zip(tee_gpu.lines, tee_cpu.lines):
        fg = [t for t in lg.replace("|", " ").split()
              if t.replace(".", "", 1).isdigit()]
        fc = [t for t in lc.replace("|", " ").split()
              if t.replace(".", "", 1).isdigit()]
        if len(fg) != len(fc):
            fail(f"{label} smoke lines differ in shape:\n{lg}\n{lc}")
        worst = max([worst] + [abs(float(a) - float(b))
                               for a, b in zip(fg, fc)])
        tg, tc = lg.split(), lc.split()
        for name in COUNTED:
            if name in tg and tg[tg.index(name) + 1] != \
                    tc[tc.index(name) + 1]:
                fail(f"{label} smoke: {name} differs card vs CPU:\n{lg}\n{lc}")
    if len(tee_gpu.lines) != 3 or worst > 2e-3:
        fail(f"{label} smoke run on the card differs from the CPU run by "
             f"{worst}")
    print(f"{label} smoke config: card vs CPU round lines agree to "
          f"{worst:.2g}, {'/'.join(COUNTED)} and the byte ledger equal, "
          f"compress_error to {ce_worst:.2g} relative", flush=True)


def fused_setup(torch, dev, extra: dict, rounds: int, graph: bool,
                corrupt: str | None = None, drift=None, avail=None,
                population: int | None = None):
    """The fused engine at the paper's traffic and full CNN width, through
    the library, with the CLI's fault schedule of mode(s) ``corrupt``, the
    sampler drifting under ``drift`` (a ``DriftConfig``) and the devices'
    availability under ``avail`` (an ``AvailabilityConfig``) if given; over
    a lazy population of ``population`` devices a factory (DESIGN.md §17;
    candidate committees of 35 redrawn at the config's cadence) instead of
    the dense partition if given: (experiment, sampler)."""
    from repro_torch.configs import femnist_cnn
    from repro_torch.core import fedgs, prng
    from repro_torch.data import (CorruptionConfig, DeviceStream,
                                  LazyPopulation, PartitionConfig,
                                  PopulationConfig, make_availability_fn,
                                  make_corruption_fn, make_device_sampler,
                                  make_partition)
    from repro_torch.models import cnn

    cfg = fedgs.FedGSConfig(num_groups=10, devices_per_group=35,
                            num_selected=10, num_presampled=2,
                            iters_per_round=3, rounds=rounds, **extra)
    if population is None:
        part = make_partition(PartitionConfig(num_factories=10,
                                              devices_per_factory=35, seed=0))
        sampler = make_device_sampler(DeviceStream.from_partition(
            part, batch_size=32, seed=0, device=dev), drift=drift)
        p_real = part.p_real
    else:
        pop = LazyPopulation(PopulationConfig(
            num_factories=10, devices_per_factory=population), dev)
        sampler = make_device_sampler(pop, drift=drift, candidates=35,
                                      candidate_every=cfg.reselect_every)
        p_real = pop.p_real
    params = cnn.init_cnn(prng.PRNGKey(0), femnist_cnn.CONFIG, dev)
    cfn = None if corrupt is None else make_corruption_fn(
        CorruptionConfig(mode=corrupt), 0)
    return fedgs.make_fedgs_experiment(
        params, sampler, p_real, cfg,
        group_loss_fn=cnn.make_group_loss_fn(), corrupt_fn=cfn,
        avail_fn=make_availability_fn(avail, 0), graph=graph), sampler


def fused_rounds(torch, exp, rounds: int) -> tuple[list, list, list]:
    """Run ``rounds`` rounds one by one, synchronised: (host seconds per
    round, the records' metrics, the final state)."""
    state, secs, mets = exp.init_state, [], []
    for r in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = exp.round_fn(state, r)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        mets.append({k: float(v) for k, v in m.items()})
    return secs, mets, state


# ---------------------------------------------------------------- baselines
# The Table II strategies (``--strategy``) at the paper's traffic and full
# CNN width: C = M·L = 100 clients a round, S = 10 local steps, n = 32.
BASELINE_ROUNDS, BASELINE_EVERY = 2, 2
BASELINE_CLIENTS, BASELINE_STEPS = 100, 10
# strategies whose client objective also runs the frozen global model's
# features (one G = 1 forward, two conv launches, per local step)
GLOBAL_FEATURES = ("fedmmd", "fedfusion_conv", "fedfusion_multi",
                   "fedfusion_single")
# averaged trees per round: the params, the extras where the strategy has
# them, IDA's uniform mean beside its weighted one
TWO_AVERAGES = ("fedfusion_conv", "fedfusion_multi", "fedfusion_single",
                "cgau", "ida", "ida_intrac", "ida_fedavg")
BASELINE_SMOKE = ("fedavg", "fedmmd", "fedfusion_conv", "ida_intrac",
                  "fedyogi")
BASELINE_PROFILED = "fedavg"     # one traced replayed round


def baseline_round_launches(name: str, draws: int = 0) -> dict:
    """One baseline round's wrapper launches, from ``core/baselines.py``:
    per local step one grouped ``conv_fused`` per conv layer (the clients'
    forward; the backward is PyTorch), two more for the global features of
    FedMMD and FedFusion; two for the last batch's accuracy; one
    ``agg_weighted`` per averaged tree; ``draws`` ``dirichlet_rows`` for
    the pool's draw (one for a Dirichlet drift, one for a lazy
    population's rows)."""
    conv = 2 * BASELINE_STEPS * (1 + (name in GLOBAL_FEATURES)) + 2
    out = {"conv_fused": conv, "agg_weighted": 1 + (name in TWO_AVERAGES)}
    if draws:
        out["dirichlet_rows"] = int(draws)
    return out


def baseline_expect(name: str, fused: bool, draws: int = 0,
                    tables: int = 0) -> dict:
    """The CLI run's wrapper counts: R rounds on the host loop; on the
    fused engine the eager warm-up round and the capture (a replay calls no
    wrapper); the eval's two conv launches every ``BASELINE_EVERY``
    rounds; ``tables`` ``dirichlet_rows`` launches of a lazy population's
    concentration table, built once."""
    from repro_torch.core import dispatch
    per = baseline_round_launches(name, draws)
    times = 2 if fused else BASELINE_ROUNDS
    out = {k: 0 for k in dispatch.KERNELS}
    out.update({k: v * times for k, v in per.items()})
    out["conv_fused"] += 2 * (BASELINE_ROUNDS // BASELINE_EVERY)
    out["dirichlet_rows"] += tables
    return out


def baseline_strategy(torch, dev, name: str, extra: tuple = (),
                      iters: int = 1, draws: int = 0,
                      tables: int = 0) -> dict:
    """One strategy at full width through the CLI, on the host loop and on
    the fused engine, each with its launch counts set to 0 before and read
    after and held to :func:`baseline_expect` (the fused capture to one
    round's :func:`baseline_round_launches`). The host loop runs each
    round eagerly, the fused engine as a CUDA graph: their final params
    and extras and their records must be equal bit for bit. Then the fused
    run's round function, its graph still held, runs two more rounds
    replayed and the same two eagerly from a copy of the same state: the
    whole states (server state included) and records bit for bit, and
    their times. Peak device memory of the
    host loop's run (eager) and of the fused run (warm-up and capture
    included). ``extra`` flags (a drift schedule, its clock ``iters``
    internal iterations a round; ``draws``: its Dirichlet launches a
    round; a lazy population's, whose table adds ``tables`` launches) go to
    both CLI runs."""
    from repro_torch import tree
    from repro_torch.core import baselines, dispatch

    argv = main_flags(BASELINE_ROUNDS, iters, BASELINE_EVERY) + [
        "--strategy", name, "--clients-per-round", str(BASELINE_CLIENTS),
        "--local-steps", str(BASELINE_STEPS)] + list(extra)
    label = " ".join(("baselines", name) + tuple(extra))
    out = {"strategy": name}
    runs, exps = {}, []
    make, run = baselines.make_baseline_experiment, baselines.run_baseline

    def spy_make(*args, **kw):     # keep the CLI's round function in view
        exps.append(make(*args, **kw))
        return exps[-1]

    def spy_run(*args, **kw):      # and its final (params, extras)
        res = run(*args, **kw)
        runs[engine_name] = res[0]
        return res

    for engine_name in ("host", "fused"):
        baselines.make_baseline_experiment = spy_make
        baselines.run_baseline = spy_run
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launch_counts()
        try:
            logs, tee, t0 = run_cli(argv + ["--engine", engine_name])
        finally:
            baselines.make_baseline_experiment = make
            baselines.run_baseline = run
        torch.cuda.synchronize()
        counts = dispatch.launch_counts()
        expect = baseline_expect(name, engine_name == "fused", draws,
                                 tables)
        if counts != expect:
            fail(f"{label} {engine_name}: launch counts {counts} "
                 f"!= the formula's {expect}")
        if len(logs) != BASELINE_ROUNDS or not all(
                math.isfinite(rec["loss"]) for rec in logs):
            fail(f"{label} {engine_name}: round records {logs}")
        acc = logs[-1]["test_accuracy"]
        if acc is None or not 0.0 <= acc <= 1.0:
            fail(f"{label} {engine_name}: no valid test accuracy "
                 f"in the last round: {acc}")
        walls = [b - a for a, b in zip([t0] + tee.stamps, tee.stamps)]
        out[engine_name] = dict(
            counts={k: v for k, v in counts.items() if v}, round_s=walls,
            records=[(r["loss"], r["test_loss"], r["test_accuracy"])
                     for r in logs],
            peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    rf = exps[0].round_fn
    per = {k: v for k, v in rf.captured.items() if v}
    if per != baseline_round_launches(name, draws) or \
            rf.replays != BASELINE_ROUNDS:
        fail(f"{label}: the capture counted {per} for "
             f"{rf.replays} replays, one round being "
             f"{baseline_round_launches(name, draws)}")
    if out["host"]["records"] != out["fused"]["records"] or not all(
            torch.equal(a, b) for a, b in zip(tree.leaves(runs["host"]),
                                              tree.leaves(runs["fused"]),
                                              strict=True)):
        fail(f"{label}: the fused engine's graph rounds differ "
             f"from the host loop's eager rounds: {out['host']['records']} "
             f"vs {out['fused']['records']}")
    del runs
    # two more rounds from the CLI's final state, replayed, then eagerly
    # from a copy of the same state: bit for bit, server state included
    snap = [leaf.clone() for leaf in tree.leaves(rf.static[0])]
    secs, finals, mets = {}, {}, {}
    for graph in (True, False):
        rf.graph, secs[graph], mets[graph] = graph, [], []
        state = rf.static[0] if graph else tree.unflatten(
            rf.static[0], [leaf.clone() for leaf in snap])
        for r in range(BASELINE_ROUNDS, BASELINE_ROUNDS + 2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = rf(state, r)
            torch.cuda.synchronize()
            secs[graph].append(time.perf_counter() - t1)
            mets[graph].append({k: float(v) for k, v in m.items()})
        finals[graph] = [leaf.clone() for leaf in tree.leaves(state)]
    if mets[True] != mets[False] or not all(
            torch.equal(a, b) for a, b in zip(finals[True], finals[False],
                                              strict=True)):
        fail(f"{label}: two replayed rounds differ from the same "
             f"rounds run eagerly: {mets[True]} vs {mets[False]}")
    del snap, finals
    out.update(host_ms=1e3 * out["host"]["round_s"][-1],
               replayed_ms=1e3 * secs[True][-1],
               eager_ms=1e3 * secs[False][-1])
    if name == BASELINE_PROFILED and not extra:
        rf.graph = True
        baseline_profile(torch, rf, name, out["replayed_ms"])
    print(f"{label}: host loop round {out['host_ms']:.1f} ms (CLI "
          f"rounds {[round(1e3 * t, 1) for t in out['host']['round_s']]} "
          f"ms, the first with the CLI's set-up, the last with its eval), "
          f"fused replayed {out['replayed_ms']:.1f} ms, eager "
          f"{out['eager_ms']:.1f} ms (fused CLI rounds "
          f"{[round(1e3 * t, 1) for t in out['fused']['round_s']]} ms; then "
          f"replays {[round(1e3 * t, 1) for t in secs[True]]}, eager "
          f"{[round(1e3 * t, 1) for t in secs[False]]} ms, no eval); peak "
          f"device memory host loop {out['host']['peak_gb']:.2f} GB, fused "
          f"{out['fused']['peak_gb']:.2f} GB; launches host "
          f"{out['host']['counts']}, fused (warm-up + capture + eval) "
          f"{out['fused']['counts']}; graph == eager bit for bit", flush=True)
    del exps, rf
    gc.collect()
    torch.cuda.empty_cache()
    return out


def baseline_profile(torch, rf, name: str, replayed_ms: float) -> None:
    """One traced replay of a captured baseline round: wall time, device
    busy share and the top kernels by device time (``torch.profiler``);
    then the client pool's draw of the round's labels and images alone
    (graph-timed) and its share of the replayed round."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rf(rf.static[0], BASELINE_ROUNDS + 2)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0), reverse=True)
    busy = sum(k[0] for k in kernels)
    share = f"{100 * busy / wall:.1f}%" if busy > 0 else "not measured"
    print(f"baselines {name} profile: one replayed round (S = "
          f"{BASELINE_STEPS} local steps, no eval) wall {wall:.1f} ms, "
          f"device busy {busy:.1f} ms = {share}", flush=True)
    for ms, count, kname in kernels[:12]:
        print(f"baselines {name} profile device: {ms:9.3f} ms  "
              f"x{count:<5d} {kname[:90]}", flush=True)
    draw_ms = graph_ms(torch, lambda: rf.pool.draw(rf.inputs), n=3, reps=3)
    c, s, n = rf.pool.num_clients, rf.pool.local_steps, rf.pool.batch_size
    print(f"baselines {name} client pool: labels and {c * s * n} images "
          f"{draw_ms:.3f} ms a round ({100 * draw_ms / replayed_ms:.1f}% of "
          "the replayed round)", flush=True)


def records_card_vs_cpu(label: str, flags: list, keys: tuple = (
        "loss", "test_loss", "test_accuracy"), counted: tuple = ()) -> None:
    """The smoke configuration plus ``flags``, kernels on the card vs plain
    versions on the CPU: the round records' ``keys`` (the unrounded
    numbers the round lines print) to 1e-4, ``counted`` ones equal."""
    logs = [run_cli(SMOKE_FLAGS + flags + ["--device", d])[0]
            for d in ("cuda", "cpu")]
    worst = 0.0
    for rg, rc in zip(*logs, strict=True):
        for key in keys + counted:
            if (rg[key] is None) != (rc[key] is None) or (
                    key in counted and rg[key] != rc[key]):
                fail(f"{label} smoke: {key} {rg[key]} vs {rc[key]}")
            if rg[key] is not None:
                worst = max(worst, abs(rg[key] - rc[key]))
    if len(logs[0]) != 3 or worst > 1e-4:
        fail(f"{label} smoke run on the card differs from the CPU run by "
             f"{worst}")
    print(f"{label} smoke config: card vs CPU round records agree to "
          f"{worst:.2g}" + (f", {'/'.join(counted)} equal" if counted else ""),
          flush=True)


def baseline_smoke_card_vs_cpu(name: str, engine_name: str,
                               extra: tuple = ()) -> None:
    """The smoke configuration of one strategy, kernels on the card vs
    plain versions on the CPU: the round records' loss, test loss and
    accuracy (the numbers the round lines print) to 1e-4."""
    records_card_vs_cpu(
        " ".join(("baselines", name, engine_name) + tuple(extra)),
        ["--strategy", name, "--engine", engine_name] + list(extra))


def check_baseline_kernels(torch, dev) -> dict:
    """The two kernels at the baselines' shapes, each against its plain
    version and its library call: ``agg_weighted`` over the K = 100
    stacked full-width client models, and both conv layers over the
    clients' own CNNs (G = 100, B = 32)."""
    from repro_torch.kernels import agg_weighted as kagg
    from repro_torch.kernels import conv_fused as kconv

    gen = torch.Generator(device=dev).manual_seed(5)
    k, p = BASELINE_CLIENTS, CNN_P4
    flat = torch.randn(k, p, generator=gen, device=dev)
    w = torch.rand(k, generator=gen, device=dev)
    w = w / w.sum()
    out_k, out_p = kagg.agg(flat, w), kagg.agg_plain(flat, w)
    err, tol = float((out_k - out_p).abs().max()), 1e-5
    if err > tol:
        fail(f"agg_weighted K={k}: max error {err} > {tol}")
    ms = time_ms(lambda: kagg.agg(flat, w), reps=20)
    plain_ms = time_ms(lambda: kagg.agg_plain(flat, w), reps=5)
    lib_ms = time_ms(lambda: torch.matmul(w[None], flat), reps=20)
    b_ms, b_by = bound(4 * (k * p + k + p), 2 * k * p)
    agg = dict(shape=f"K={k} P={p}", ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
               max_abs_err=err, tol=tol)
    print(f"baselines agg_weighted: K={k} P={p} max err {err:.3g} (tol "
          f"{tol}); {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
          f"{lib_ms:.4f} ms matmul, bound {b_ms:.4f} ms ({b_by}), "
          f"{b_ms / ms:.0%} of the bound", flush=True)
    del flat, out_k, out_p
    torch.cuda.empty_cache()
    g, b, rows = BASELINE_CLIENTS, 32, []
    for layer, h, cin, cout in (("conv1", 28, 1, 32), ("conv2", 14, 32, 64)):
        x = torch.rand(g, b, h, h, cin, generator=gen, device=dev)
        wt = torch.randn(g, 5, 5, cin, cout, generator=gen, device=dev) \
            / math.sqrt(25 * cin)
        bias = 0.1 * torch.randn(g, cout, generator=gen, device=dev)
        pat = kconv.im2col(x, (5, 5))
        wm = wt.reshape(g, 25 * cin, cout).contiguous()
        out_k, y_k = kconv.fused(pat, wm, bias, h)
        out_p, y_p = kconv.fused_plain(pat, wm, bias, h)
        err = max(float((y_k - y_p).abs().max()),
                  float((out_k - out_p).abs().max()))
        if err > 1e-4:
            fail(f"conv_fused {layer} G={g}: max error {err} > 1e-4")
        r, q = pat.shape[1], pat.shape[2]
        ms = time_ms(lambda: kconv.fused(pat, wm, bias, h), reps=10)
        plain_ms = time_ms(lambda: kconv.fused_plain(pat, wm, bias, h),
                           reps=10)
        lib_ms = time_ms(lambda: torch.baddbmm(bias[:, None, :], pat, wm),
                         reps=10)
        bytes_ = 4 * (g * r * q + g * q * cout + g * cout + g * r * cout
                      + g * r * cout // 4)
        ops = 2 * g * r * q * cout + 2 * g * r * cout
        b_ms, b_by = bound(bytes_, ops)
        rows.append(dict(layer=layer, G=g, R=r, Q=q, C=cout, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                         bound_by=b_by, max_abs_err=err))
        print(f"baselines conv_fused {layer}: G={g} R={r} Q={q} C={cout} "
              f"max err {err:.3g} (tol 1e-4); {ms:.4f} ms kernel, "
              f"{plain_ms:.4f} ms plain, {lib_ms:.4f} ms baddbmm, bound "
              f"{b_ms:.4f} ms ({b_by}), {b_ms / ms:.0%} of the bound",
              flush=True)
        del x, pat, out_k, y_k, out_p, y_p
        torch.cuda.empty_cache()
    return {"agg_weighted": agg, "conv_fused": rows}


def baselines_phase(torch, dev) -> tuple[dict, dict, dict]:
    """Every Table II strategy at full width on both engines
    (:func:`baseline_strategy`), five of them card vs CPU on the smoke
    configuration to 1e-4, and the two kernels at the path's shapes.
    Returns (the host runs' summed counts, the fused runs' summed counts,
    the kernels' rows at the path's shapes)."""
    from repro_torch.configs import femnist_cnn
    from repro_torch.core import baselines, dispatch
    from repro_torch.models import cnn

    t0 = time.perf_counter()
    names = sorted(baselines.all_strategies(cnn.make_model_api(
        femnist_cnn.CONFIG)))
    if len(names) != 14:
        fail(f"baselines: {len(names)} strategies, expected 14")
    sums = {e: {k: 0 for k in dispatch.KERNELS} for e in ("host", "fused")}
    rows = []
    for name in names:
        res = baseline_strategy(torch, dev, name)
        rows.append(res)
        for e in sums:
            for k, v in res[e]["counts"].items():
                sums[e][k] += v
    print("baselines table (ms per round at C=100, S=10, n=32, full CNN: "
          "host loop's last CLI round with its eval / fused replayed / "
          "fused eager, no eval; peak GB host loop / fused): " +
          "; ".join(f"{r['strategy']} {r['host_ms']:.1f} / "
                    f"{r['replayed_ms']:.1f} / {r['eager_ms']:.1f}, "
                    f"{r['host']['peak_gb']:.2f} / "
                    f"{r['fused']['peak_gb']:.2f} GB" for r in rows),
          flush=True)
    for name in BASELINE_SMOKE:
        for engine_name in ("host", "fused"):
            baseline_smoke_card_vs_cpu(name, engine_name)
    kernel_rows = check_baseline_kernels(torch, dev)
    print(f"baselines phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return sums["host"], sums["fused"], kernel_rows


# per wrapper, the one kernel that each of its calls runs once, by the
# name the trace gives it (gbp_cs_warp also matches gbp_cs_warp_any)
DEVICE_KERNEL = {"gbp_cs": "gbp_cs_warp", "conv_fused": "conv_fused_kernel",
                 "agg_weighted": "agg_weighted_kernel",
                 "robust_agg": "robust_agg_kernel",
                 "topk_compress": "topk_hist0", "int8_quant": "int8_absmax",
                 "flash_attention": "flash_fwd", "ssd_scan": "ssd_chunk_scan",
                 "corrupt_rows": "corrupt_rows_kernel",
                 "dirichlet_rows": "dirichlet_rows_kernel",
                 "avail_rows": "avail_rows_kernel"}


def device_launches(torch, argv) -> tuple[dict, dict]:
    """The CLI run once under ``torch.profiler``, every launch count set to
    0 just before and read just after: (the wrappers' counts, each
    kernel's executions on the card as the trace names them; a kernel
    replayed in a CUDA graph counts once per replay)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import dispatch

    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_cli(argv)
        torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    execs = {name: sum(e.count for e in events if tag in e.key)
             for name, tag in DEVICE_KERNEL.items()}
    return counts, execs


def fused_path(label, flags, extra, host_expect, host_ms, torch, dev,
               corrupt: str | None = None):
    """``--engine fused`` at full width (R=2, T=3). The CLI driven with the
    counts set to 0 before and read after: the wrappers count where they
    launch, so a replay moves no counter and the counts hold the eager
    warm-up round, the capture and the eval launches (each round's
    launches twice, plus eval); the capture must count one round's
    launches. The same CLI again under ``torch.profiler``, its counts
    reset too: each kernel's executions on the card, which must be the
    host loop's launches plus the warm-up round's; these measured counts
    are the path's ``launches_by_path``. Then, through the library:
    graph against eager (states bit-equal, records equal), the kernel
    against its plain version on the path's GBP-CS instances, ms per
    internal iteration eager and replayed, one traced replay, and the
    share of an iteration spent on drawing labels and images on the card
    and on their threefry bits alone. With ``corrupt`` (the robust
    branch: the CLI's fault mode(s), ``extra`` its aggregator) the CLI run
    must seat a corrupted member, and the graph and eager runs print their
    peak device memory."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tree
    from repro_torch.core import dispatch, fedgs, prng
    from repro_torch.kernels import gbp_cs as kgbp

    rounds, iters, every = 2, 3, 2
    argv = main_flags(rounds, iters, every) + ["--engine", "fused"] + flags
    evals = {"conv_fused": 2 * (rounds // every)}
    per_round = {k: (v - evals.get(k, 0)) // rounds
                 for k, v in host_expect.items()}
    calls = {k: 2 * v + evals.get(k, 0) for k, v in per_round.items()}
    seen = []
    make = fedgs.make_fedgs_experiment

    def spy(*args, **kw):      # keep the CLI's round function in view
        seen.append(make(*args, **kw))
        return seen[-1]

    fedgs.make_fedgs_experiment = spy
    try:
        logs, counts, cli_ms = drive(label, argv, calls, torch)
    finally:
        fedgs.make_fedgs_experiment = make
    if corrupt is not None and sum(rec["corrupted_selected"]
                                   for rec in logs) <= 0:
        fail(f"{label}: no corrupted member was seated in the run")
    rf = seen[0].round_fn
    if rf.captured != per_round or rf.replays != rounds:
        fail(f"{label}: the capture counted {rf.captured} for "
             f"{rf.replays} replays, one round of the host loop's being "
             f"{per_round} for {rounds}")
    traced_calls, run = device_launches(torch, argv)
    expect = {k: v + per_round[k] for k, v in host_expect.items()}
    if traced_calls != calls or run != expect:
        fail(f"{label}: traced run: wrapper counts {traced_calls} (expected "
             f"{calls}), kernel executions on the card {run}, expected the "
             f"host loop's {host_expect} plus one warm-up round {per_round}")
    print(f"{label}: one round captured in {len(rf.segments.graphs)} graph "
          f"segments around {len(rf.segments.breaks)} eager pinv calls; "
          f"wrapper counts (warm-up round + capture + eval) {counts}; "
          f"kernel executions on the card, traced: {run} = the host "
          f"loop's {host_expect} + the warm-up round", flush=True)
    del seen, rf                  # the CLI run's graph and its memory pool

    # graph against eager, and the kernel on the path's GBP-CS instances
    t_rounds = 4
    runs, peaks = {}, {}
    for graph in (True, False):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        exp, sampler = fused_setup(torch, dev, extra, t_rounds, graph,
                                   corrupt)
        runs[graph] = fused_rounds(torch, exp, t_rounds) + (exp, sampler)
        peaks[graph] = torch.cuda.max_memory_allocated() / 1e9
    (g_secs, g_mets, g_state, g_exp, sampler), (e_secs, e_mets, e_state,
                                               _, _) = runs[True], runs[False]
    leaves = lambda st: tree.leaves(st[0]) + list(st[1])
    if not all(torch.equal(a, b) for a, b in zip(leaves(g_state),
                                                  leaves(e_state))):
        fail(f"{label}: graph and eager states differ after {t_rounds} "
             "rounds")
    if g_mets != e_mets:
        fail(f"{label}: graph and eager records differ:\n{g_mets}\n{e_mets}")
    worst, instances = 0.0, 0
    loop = dispatch.gbp_cs_loop

    def checked(A, y, x0, max_iters):
        nonlocal worst, instances
        out = loop(A, y, x0, max_iters)
        ref = kgbp.minimize_plain(A, y, x0, max_iters)
        if not (torch.equal(out[0], ref[0]) and torch.equal(out[2], ref[2])):
            fail(f"{label}: gbp_cs differs from its plain version on a "
                 "fused-path instance")
        worst = max(worst, float((out[1] - ref[1]).abs().max()))
        instances += A.shape[0]
        return out

    dispatch.gbp_cs_loop = checked
    try:
        fused_rounds(torch, fused_setup(torch, dev, extra, 2, False,
                                        corrupt)[0], 2)
    finally:
        dispatch.gbp_cs_loop = loop
    if worst > 1e-3:
        fail(f"{label}: gbp_cs distance error {worst} on the fused path")
    replay_ms = 1e3 * sorted(g_secs[1:])[len(g_secs[1:]) // 2] / iters
    eager_ms = 1e3 * sorted(e_secs[1:])[len(e_secs[1:]) // 2] / iters
    print(f"{label}: graph == eager over {t_rounds} rounds (states bit-equal,"
          f" records equal); gbp_cs == plain on {instances} fused-path "
          f"instances (masks, trip counts; |d err| {worst:.3g}); ms per "
          f"internal iteration: replayed {replay_ms:.2f} (rounds "
          f"{[round(1e3 * t / iters, 2) for t in g_secs]}), eager "
          f"{eager_ms:.2f} (rounds {[round(1e3 * t / iters, 2) for t in e_secs]}"
          f", no eval); the CLI's last round, eval included: fused "
          f"{cli_ms:.1f}, host loop {host_ms:.1f} (this call), "
          f"{host_ms / cli_ms:.2f}x; peak device memory graph "
          f"{peaks[True]:.2f} GB (4 rounds, capture included), eager "
          f"{peaks[False]:.2f} GB (the graph run's buffers still held)",
          flush=True)

    # one traced replay
    rf = g_exp.round_fn
    state = g_state
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = rf(state, t_rounds)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0), reverse=True)
    busy = sum(k[0] for k in kernels)
    share = f"{100 * busy / wall:.1f}%" if busy > 0 else "not measured"
    print(f"{label} profile: one replayed round ({iters} iterations, no "
          f"eval) wall {wall:.1f} ms, device busy {busy:.1f} ms = {share}",
          flush=True)
    for ms, count, name in kernels[:12]:
        print(f"{label} profile device: {ms:9.3f} ms  x{count:<5d} "
              f"{name[:90]}", flush=True)

    # the device stream's share of an iteration (graph-timed)
    keys = rf.keys["data"][0]
    gids = torch.arange(10, device=dev)
    mask = state[1][0]
    n, n_img = 32, 10 * 10 * 32

    def datagen():
        labels = sampler.labels(keys, gids)
        sampler.counts(labels)
        sampler.selected_batch(labels, keys, gids, mask, 10)

    def draws():
        prng.random_bits_t(keys[:, 0], (35, n, 1))
        k4 = prng.split_t(keys[:, 1], 4)
        for i, shape in enumerate(((n_img // 10,), (n_img // 10,),
                                   (n_img // 10, 2), (n_img // 10, 28, 28))):
            prng.random_bits_t(k4[:, i], shape)

    gen_ms, thr_ms = graph_ms(torch, datagen, n=10), graph_ms(torch, draws,
                                                             n=10)
    print(f"{label} device stream: labels + counts + images {gen_ms:.3f} ms "
          f"per iteration ({100 * gen_ms / replay_ms:.1f}% of the replayed "
          f"iteration), their threefry bits alone {thr_ms:.3f} ms "
          f"({100 * thr_ms / replay_ms:.1f}%)", flush=True)
    del runs, g_state, e_state, state
    torch.cuda.empty_cache()
    return run


# ------------------------------------------------------------------ drift
# The dynamic environments (DESIGN.md §13): the drift schedules and the
# GBP-CS cadence on the host loop, the fused engine and the baselines.
DRIFT_FLAGS = ["--drift", "redraw", "--drift-period", "2", "--reselect-every",
               "2"]
STEP_FLAGS = ["--drift", "step_shift", "--drift-t0", "3", "--reselect-every",
              "0"]
CHURN_FLAGS = ["--drift", "churn", "--drift-period", "3"]
DRIFT_COUNTED = ("reselections",)
DRIFT_KEYS = ("loss", "divergence", "group_discrepancy",
              "selection_distance", "test_loss", "test_accuracy")


def check_dirichlet_rows(torch, dev):
    """The Dirichlet redraw against its plain version at the drift's
    shape, the paper's 350 devices of 62 classes: a ``redraw`` trace of
    epoch 1 (every row drawn) and a ``churn`` one (a quarter drawn, the
    rest kept), α = 0.3. Kept rows bit-equal, drawn rows to 1e-6. The
    bound counts this draw's work, from the plain version: ~74 integer
    operations (``THREEFRY_INT_OPS``) per threefry hash, 4 hashes per
    element (its key, ``split``, the exponential), 4 per outer pass, 3
    per inner normal draw."""
    import numpy as np

    from repro_torch.core import prng
    from repro_torch.data import (DriftConfig, PartitionConfig,
                                  make_drift_fn, make_partition)
    from repro_torch.kernels import dirichlet as kd

    part = make_partition(PartitionConfig(num_factories=10,
                                          devices_per_factory=35, seed=0))
    r, f = 350, 62
    base = torch.as_tensor(part.class_probs.reshape(r, f), device=dev)
    ids = np.arange(r)
    tol, res = 1e-6, {}
    for sched in ("redraw", "churn"):
        fn = make_drift_fn(DriftConfig(schedule=sched, period=2), 0, f)
        trace = fn.device_trace(2, ids, dev)
        out = kd.drift_rows(base, trace, fn.config.alpha)
        ref = kd.drift_rows_plain(base, trace, fn.config.alpha)
        drawn = trace[:, 1] != 0
        err = float((out[drawn] - ref[drawn]).abs().max())
        exact = int((out[drawn] == ref[drawn]).all(dim=1).sum())
        if not torch.equal(out[~drawn], ref[~drawn]) or err > tol:
            fail(f"dirichlet_rows {sched}: drawn rows err {err} > {tol} or "
                 "kept rows differ")
        stats = {}
        prng.dirichlet_t(trace[drawn, 2:], fn.config.alpha, f, stats)
        hashes = 4 * stats["elements"] + 4 * stats["passes"] \
            + 3 * stats["draws"]
        ms = time_ms(lambda: kd.drift_rows(base, trace, fn.config.alpha),
                     reps=50)
        plain_ms = time_ms(lambda: kd.drift_rows_plain(
            base, trace, fn.config.alpha), reps=3, warmup=1)
        b_ms, b_by = bound(8 * r * f + 32 * r, THREEFRY_INT_OPS * hashes,
                           INT32_OPS)
        res[sched] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, drawn=int(drawn.sum()))
        print(f"dirichlet_rows {sched} (R={r}, F={f}, alpha "
              f"{fn.config.alpha}, {int(drawn.sum())} rows drawn: "
              f"{stats['elements']} elements, {stats['passes']} outer "
              f"passes, {stats['draws']} normal draws): kept rows "
              f"bit-equal, drawn max err {err:.3g} (tol {tol}), {exact} "
              f"drawn rows bit-equal; {ms:.4f} ms kernel, {plain_ms:.4f} ms "
              f"plain, bound {b_ms:.5f} ms ({b_by}); library: none (no "
              "PyTorch call draws JAX's threefry gamma)", flush=True)
    red = res["redraw"]
    return dict(name=kd.NAME, route="cuda", source=kd.SOURCE,
                replaces=kd.REPLACES, max_abs_err=max(v["err"] for v in
                                                      res.values()),
                tol=tol, ms=red["ms"], plain_ms=red["plain_ms"],
                bound_ms=red["bound_ms"], bound_by=red["bound_by"],
                library_ms=None, churn_ms=res["churn"]["ms"],
                churn_plain_ms=res["churn"]["plain_ms"],
                shape=f"R={r} F={f}, redraw all rows / churn "
                      f"{res['churn']['drawn']} rows drawn")


def fedgs_expect(rounds: int, iters: int, every: int, reselect: int,
                 draws: int, fused: bool, avail: bool = False,
                 tables: int = 0) -> dict:
    """A FEDGS CLI run's wrapper counts under a cadence: per round, one
    ``gbp_cs`` per rebuild iteration of its pattern
    (``fedgs.round_pattern``), two ``conv_fused`` an iteration, one
    ``agg_weighted`` (Eq. 5), ``draws`` ``dirichlet_rows`` an iteration
    (one for a Dirichlet drift, one for a lazy population's resident rows;
    ``tables`` more, once, for its concentration table), with an
    availability schedule
    (``avail``; no churn trigger: cadence 1 or ``bounded_async``) one
    ``avail_rows`` an iteration; the eval's two conv launches every
    ``every`` rounds. The host loop runs every round; the fused engine
    warms up and captures each distinct pattern once (a replay calls no
    wrapper)."""
    from repro_torch.core import dispatch, fedgs

    cfg = fedgs.FedGSConfig(iters_per_round=iters, reselect_every=reselect)
    patterns = [fedgs.round_pattern(cfg, r) for r in range(rounds)]
    if fused:
        patterns = [p for p in dict.fromkeys(patterns) for _ in range(2)]
    out = {k: 0 for k in dispatch.KERNELS}
    for p in patterns:
        out["gbp_cs"] += sum(p)
        out["conv_fused"] += 2 * iters
        out["agg_weighted"] += 1
        out["dirichlet_rows"] += iters * int(draws)
        out["avail_rows"] += iters if avail else 0
    out["conv_fused"] += 2 * (rounds // every)
    out["dirichlet_rows"] += tables
    return out


def drift_fused(label, flags, drift, reselect, draws, torch, dev,
                avail=None, extra: dict | None = None, population=None,
                library: bool = True) -> dict:
    """One fused drift (or, with ``avail``, availability) path at full
    width (R=2, T=3): the CLI driven with the counts set to 0 before and
    read after, held to :func:`fedgs_expect` and each pattern's capture to
    one round of it, with the peak device memory of the run (each
    pattern's graphs hold a memory pool of their own); then through the
    library (``extra`` config fields), graph against eager over 4 rounds
    (states bit-equal, records equal) and ms per internal iteration
    replayed and eager (``library`` False skips it). With ``population``
    (the devices a factory of a lazy population, as in ``flags``) the
    table's launch joins the counts and the library runs over the same
    population. Returns (the CLI's counts, its ms per internal iteration,
    its peak GB, the replayed and eager ms)."""
    from repro_torch.core import fedgs

    rounds, iters, every = 2, 3, 2
    argv = main_flags(rounds, iters, every) + ["--engine", "fused"] + flags
    seen, make = [], fedgs.make_fedgs_experiment

    def spy(*args, **kw):      # keep the CLI's round function in view
        seen.append(make(*args, **kw))
        return seen[-1]

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fedgs.make_fedgs_experiment = spy
    try:
        logs, counts, cli_ms = drive(
            label, argv, fedgs_expect(rounds, iters, every, reselect, draws,
                                      True, avail is not None,
                                      int(population is not None)), torch)
    finally:
        fedgs.make_fedgs_experiment = make
    peak = torch.cuda.max_memory_allocated() / 1e9
    rf = seen[0].round_fn
    cfg = fedgs.FedGSConfig(iters_per_round=iters, reselect_every=reselect)
    for pattern, captured in rf.captures.items():
        one = fedgs_expect(1, iters, rounds + 1, reselect, draws, False,
                           avail is not None)
        one["gbp_cs"] = sum(pattern)
        if captured != one:
            fail(f"{label}: pattern {pattern} captured {captured}, one "
                 f"round being {one}")
    patterns = {fedgs.round_pattern(cfg, r) for r in range(rounds)}
    if set(rf.captures) != patterns or rf.replays != rounds:
        fail(f"{label}: captures {list(rf.captures)} for {rf.replays} "
             f"replays, the rounds' patterns being {patterns}")
    resel = [rec["reselections"] for rec in logs]
    print(f"{label}: {len(rf.graphs)} patterns captured "
          + ", ".join(f"{p}: {len(g.graphs)} graph segments"
                      for p, (g, _) in rf.graphs.items())
          + f"; reselections per round {resel}; peak device memory of the "
          f"CLI run {peak:.2f} GB", flush=True)
    del seen, rf
    if not library:
        return counts, cli_ms, peak, None, None

    replay_ms, eager_ms = drift_graph_vs_eager(
        label, dict(extra or {}, reselect_every=reselect), drift, None,
        torch, dev, avail, population)
    print(f"{label}: the CLI's last round, eval included: {cli_ms:.1f} ms "
          "per internal iteration", flush=True)
    return counts, cli_ms, peak, replay_ms, eager_ms


def drift_graph_vs_eager(label, extra, drift, corrupt, torch, dev,
                         avail=None, population=None) -> tuple[float, float]:
    """Through the library at full width, 4 rounds of T = 3 as CUDA graphs
    (one per pattern, each captured at its first round) and eagerly:
    states bit-equal and records equal; ms per internal iteration of the
    rounds after every pattern's capture (rounds 2 and 3), replayed and
    eager. Returns (replayed, eager) ms per iteration."""
    from repro_torch import tree

    t_rounds, iters = 4, 3
    runs = {}
    for graph in (True, False):
        gc.collect()
        torch.cuda.empty_cache()
        exp, _ = fused_setup(torch, dev, extra, t_rounds, graph, corrupt,
                             drift, avail, population)
        runs[graph] = fused_rounds(torch, exp, t_rounds)
        del exp
    (g_secs, g_mets, g_state), (e_secs, e_mets, e_state) = runs[True], \
        runs[False]
    leaves = lambda st: tree.leaves(st[0]) + list(st[1])
    if not all(torch.equal(a, b) for a, b in zip(leaves(g_state),
                                                  leaves(e_state))):
        fail(f"{label}: graph and eager states differ after {t_rounds} "
             "rounds")
    if g_mets != e_mets:
        fail(f"{label}: graph and eager records differ:\n{g_mets}\n{e_mets}")
    replay_ms = 1e3 * sum(g_secs[2:]) / (iters * (t_rounds - 2))
    eager_ms = 1e3 * sum(e_secs[2:]) / (iters * (t_rounds - 2))
    print(f"{label}: graph == eager over {t_rounds} rounds (states "
          f"bit-equal, records equal; reselections "
          f"{[m['reselections'] for m in g_mets]}); ms per internal "
          f"iteration over rounds 2-3: replayed {replay_ms:.2f}, eager "
          f"{eager_ms:.2f} (rounds replayed "
          f"{[round(1e3 * t / iters, 2) for t in g_secs]}, eager "
          f"{[round(1e3 * t / iters, 2) for t in e_secs]}, rounds 0-1 "
          "with their captures, no eval)", flush=True)
    del runs, g_state, e_state
    gc.collect()
    torch.cuda.empty_cache()
    return replay_ms, eager_ms


def drift_phase(torch, dev) -> dict:
    """The dynamic environments at full width and the paper's traffic:
    ``--drift redraw --drift-period 2 --reselect-every 2`` on the host
    loop (driven and counted: one ``dirichlet_rows`` an iteration, one
    ``gbp_cs`` per rebuild) and the fused engine (:func:`drift_fused`: two
    patterns, graph == eager), ``--drift step_shift --drift-t0 3
    --reselect-every 0`` on the fused engine (no draw, two patterns, one
    without a rebuild), ``--strategy fedavg --drift churn --drift-period
    3`` on both engines (:func:`baseline_strategy`, the FEDGS clock of T =
    3); then the smoke configurations card vs CPU, records to 1e-4 with
    ``reselections`` equal. Returns each path's counts."""
    from repro_torch.data import DriftConfig

    t0 = time.perf_counter()
    rounds, iters, every = 2, 3, 2
    out = {}
    _, out["drift_host"], _ = drive(
        "drift host path", main_flags(rounds, iters, every) + DRIFT_FLAGS,
        fedgs_expect(rounds, iters, every, 2, True, False), torch)
    out["drift_fused"] = drift_fused(
        "drift fused path", DRIFT_FLAGS,
        DriftConfig(schedule="redraw", period=2), 2, True, torch, dev)[0]
    out["drift_step_fused"] = drift_fused(
        "drift step_shift fused path", STEP_FLAGS,
        DriftConfig(schedule="step_shift", t0=3), 0, False, torch, dev)[0]
    # the robust path's cadence with quarantine: keep iterations run
    # GBP-CS too (the device predicate picks); without quarantine they
    # skip it, so the difference is what the predicate costs
    redraw = DriftConfig(schedule="redraw", period=2)
    robust = {"reselect_every": 2, "robust_agg": ROBUST_FLAGS[3]}
    q_ms = drift_graph_vs_eager("drift fused robust path, quarantine 3",
                                robust, redraw, ROBUST_FLAGS[1], torch,
                                dev)[0]
    o_ms = drift_graph_vs_eager("drift fused robust path, quarantine off",
                                dict(robust, quarantine_limit=0), redraw,
                                ROBUST_FLAGS[1], torch, dev)[0]
    print(f"drift fused robust path: the quarantine cadence's keep "
          f"iterations (1 of 3 at N = 2, T = 3) cost {q_ms - o_ms:.2f} ms "
          f"per iteration on average, {3 * (q_ms - o_ms):.2f} ms per keep "
          "iteration (a GBP-CS solve and its pinv break)", flush=True)
    res = baseline_strategy(torch, dev, "fedavg", tuple(CHURN_FLAGS), iters,
                            draws=True)
    out["drift_baselines_host"] = dict(res["host"]["counts"])
    out["drift_baselines_fused"] = dict(res["fused"]["counts"])
    for flags in (DRIFT_FLAGS, DRIFT_FLAGS + ["--engine", "fused"],
                  STEP_FLAGS + ["--engine", "fused"]):
        records_card_vs_cpu("drift " + " ".join(flags), flags, DRIFT_KEYS,
                            DRIFT_COUNTED)
    for engine_name in ("host", "fused"):
        baseline_smoke_card_vs_cpu("fedavg", engine_name, tuple(CHURN_FLAGS))
    print(f"drift phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# ------------------------------------------------------------ availability
# The availability layer (DESIGN.md §14): devices drop out and straggle,
# bounded-async sync keeps missed members at γ^staleness.
AVAIL_FLAGS = ["--avail", "markov", "--avail-up-prob", "0.6", "--sync",
               "bounded_async"]
AVAIL_SMOKE = [(["--avail", "bernoulli"], ("host",)),
               (["--avail", "straggler_tail", "--avail-selection", "blind"],
                ("host",)),
               (AVAIL_FLAGS + ROBUST_SMOKE_FLAGS, ("host", "fused")),
               (AVAIL_FLAGS + ROBUST_SMOKE_FLAGS + COMPRESS_FLAGS,
                ("host", "fused"))]
AVAIL_KEYS = DRIFT_KEYS + ("participation", "staleness_mean",
                           "staleness_max", "agg_residual")
AVAIL_COUNTED = ("reselections", "dark_selected", "corrupted_selected",
                 "rollbacks", "bytes_int", "bytes_ext")


def check_avail_rows(torch, dev):
    """The availability trace against its plain version on the card, bit
    for bit, for the three schedules at the CLI's shape (up_prob 0.6, the
    straggler tail 0.15): the 350 dense ids and 350 shuffled ids up to
    2³¹ − 1, at t = 0, 5 and 4,095 (the default horizon's longest markov
    chain), t read from a device tensor (the plain version on the card,
    but on the CPU for the shuffled ids at t = 4,095: its markov chain is
    a Python loop of key-tensor threefry passes, ~13 s there on the card).
    Times on the dense ids at t = 5 and 4,095: per launch inside a CUDA
    graph (the device's time, as the fused round pays it; the headline)
    and eager (CUDA events over back-to-back calls, host wrapper
    included), and the plain version's on the card. The bound counts the
    draw's hashes (``kernels.avail.hashes``) at ~74 integer operations
    (``THREEFRY_INT_OPS``) each against 16 bytes per id."""
    from repro_torch.data import AvailabilityConfig, make_availability_fn
    from repro_torch.kernels import avail as ka

    r = 350
    gen = torch.Generator(device=dev).manual_seed(0)
    id_sets = {"dense": torch.arange(r, device=dev),
               "shuffled": torch.randint(0, 2 ** 31 - 1, (r,), generator=gen,
                                         device=dev)}
    res = {}
    for kind in ka.SCHEDULES:
        fn = make_availability_fn(AvailabilityConfig(
            schedule=kind, up_prob=0.6), 0)
        times = {}
        for name, ids in id_sets.items():
            for t in (0, 5, 4095):
                tt = torch.full((), t, dtype=torch.int64, device=dev)
                mask, lat = fn(tt, ids)
                on = ids.cpu() if (name, t) == ("shuffled", 4095) else ids
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref = ka.avail_rows_plain(on, t, fn.schedule)
                torch.cuda.synchronize()
                times[(name, t)] = 1e3 * (time.perf_counter() - t0)
                if not (torch.equal(mask.cpu(), ref[0].cpu())
                        and torch.equal(lat.cpu(), ref[1].cpu())):
                    fail(f"avail_rows {kind} {name} t={t}: the kernel "
                         "differs from its plain version")
        ids = id_sets["dense"]
        for t in (5, 4095):
            tt = torch.full((), t, dtype=torch.int64, device=dev)
            call = lambda: fn(tt, ids)
            ms, eager = graph_ms(torch, call), time_ms(call, reps=50)
            b_ms, b_by = bound(16 * r + 8, THREEFRY_INT_OPS * ka.hashes(
                kind, r, t % fn.config.horizon), INT32_OPS)
            res[(kind, t)] = dict(ms=ms, eager_ms=eager,
                                  plain_ms=times[("dense", t)],
                                  bound_ms=b_ms, bound_by=b_by)
        up = float(fn(torch.full((), 5, dtype=torch.int64, device=dev),
                      ids)[0].mean())
        print(f"avail_rows {kind} (R={r}, dense and shuffled ids, t = 0, 5, "
              f"4095): kernel == plain bit for bit; up at t=5 {up:.3f}; "
              + "; ".join(f"t={t}: {res[(kind, t)]['ms']:.4f} ms kernel "
                          "per launch in a graph, "
                          f"{res[(kind, t)]['eager_ms']:.4f} eager, "
                          f"{res[(kind, t)]['plain_ms']:.3f} ms plain, bound "
                          f"{res[(kind, t)]['bound_ms']:.5f} ms "
                          f"({res[(kind, t)]['bound_by']})"
                          for t in (5, 4095))
              + "; library: none (no PyTorch call draws JAX's threefry "
              "bernoulli)", flush=True)
    worst = res[("markov", 4095)]
    return dict(name=ka.NAME, route="cuda", source=ka.SOURCE,
                replaces=ka.REPLACES, max_abs_err=0.0, tol=0.0,
                ms=worst["ms"], eager_ms=worst["eager_ms"],
                plain_ms=worst["plain_ms"], bound_ms=worst["bound_ms"],
                bound_by=worst["bound_by"], library_ms=None,
                ms_t5={k: v["ms"] for (k, t), v in res.items() if t == 5},
                shape=f"R={r}, markov at t = 4095, per launch in a CUDA "
                      "graph (the headline); each schedule at t = 5 in "
                      "ms_t5")


def avail_host_vs_fused(torch, dev, extra: dict, avail) -> None:
    """Through the library at full width, R = 2 rounds of T = 3: the host
    loop over ``DeviceBackedStreams`` of the fused engine's sampler against
    the fused engine (CUDA graphs): records to 1e-4, the rebuilds and dark
    members equal, the byte ledger to float32's rounding (the fused
    round sums its metrics in float32 on the device, as the JAX package's
    fused engine does; the host loop in float64)."""
    from repro_torch.configs import femnist_cnn
    from repro_torch.core import fedgs, prng
    from repro_torch.data import (DeviceBackedStreams, DeviceStream,
                                  PartitionConfig, make_availability_fn,
                                  make_device_sampler, make_partition)
    from repro_torch.models import cnn

    part = make_partition(PartitionConfig(num_factories=10,
                                          devices_per_factory=35, seed=0))
    sampler = make_device_sampler(DeviceStream.from_partition(
        part, batch_size=32, seed=0, device=dev))
    params = cnn.init_cnn(prng.PRNGKey(0), femnist_cnn.CONFIG, dev)
    cfg = fedgs.FedGSConfig(num_groups=10, devices_per_group=35,
                            num_selected=10, num_presampled=2,
                            iters_per_round=3, rounds=2, **extra)
    kw = dict(group_loss_fn=cnn.make_group_loss_fn(),
              avail_fn=make_availability_fn(avail, 0))
    _, host = fedgs.run_fedgs(params, DeviceBackedStreams(sampler),
                              part.p_real, cfg, **kw)
    _, fused = fedgs.run_fedgs_fused(params, sampler, part.p_real, cfg,
                                     graph=True, **kw)
    worst = 0.0
    for h, f in zip(host, fused, strict=True):
        h, f = h.to_dict(), f.to_dict()
        for key in ("loss", "divergence", "participation", "staleness_mean",
                    "staleness_max") + AVAIL_COUNTED[:2]:
            if key in AVAIL_COUNTED and h[key] != f[key]:
                fail(f"avail fused vs host loop: {key} {f[key]} vs {h[key]}")
            worst = max(worst, abs(h[key] - f[key]))
        for key in AVAIL_COUNTED[4:]:
            if abs(h[key] - f[key]) > 2.0 ** -22 * h[key]:
                fail(f"avail fused vs host loop: {key} {f[key]} vs {h[key]}")
    if worst > 1e-4:
        fail(f"avail fused vs host loop: records differ by {worst}")
    print(f"avail path at full width, {extra}: the fused engine (graphs) "
          "equals the "
          f"host loop over its sampler, records to {worst:.2g} (rebuilds, "
          "dark members equal, the byte ledgers to float32's rounding: "
          f"bytes_int host {host[-1].bytes_int:.0f}, fused "
          f"{fused[-1].bytes_int:.0f}); participation "
          + ", ".join(f"{rec.participation:.3f}" for rec in host)
          + "; dark members " + ", ".join(f"{rec.dark_selected:.0f}"
                                          for rec in host), flush=True)


def avail_phase(torch, dev) -> tuple[dict, dict]:
    """The availability layer at full width and the paper's traffic:
    ``avail_rows`` against its plain version (:func:`check_avail_rows`);
    ``--avail markov --avail-up-prob 0.6 --sync bounded_async`` driven on
    the host loop (one ``avail_rows`` an iteration; peak memory) and the
    fused engine (:func:`drift_fused`: the capture held to one round; then
    through the library with blind selection, graph == eager and ms per
    iteration replayed and eager); the fused engine against the host loop
    over the same sampler, blind too (:func:`avail_host_vs_fused`); then
    four smoke configurations card vs CPU, records to 1e-4 with the
    counted fields equal. Returns (each path's counts, the kernel's
    entry)."""
    from repro_torch.data import AvailabilityConfig

    t0 = time.perf_counter()
    entry = check_avail_rows(torch, dev)
    rounds, iters, every = 2, 3, 2
    markov = AvailabilityConfig(schedule="markov", up_prob=0.6)
    # the library runs select blind, so that dark members are seated and
    # their stale mass enters Eq. 4 inside the graphs (aware selection at
    # cadence 1 seats none: the CLI run's S is 0)
    extra = {"sync": "bounded_async", "avail_selection": "blind"}
    out = {}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 1e9
    logs, out["avail_host"], host_ms = drive(
        "avail host path", main_flags(rounds, iters, every) + AVAIL_FLAGS,
        fedgs_expect(rounds, iters, every, 1, False, False, True), torch)
    host_peak = torch.cuda.max_memory_allocated() / 1e9
    print("avail host path telemetry: " + "; ".join(
        f"round {rec['round']} part {rec['participation']:.3f} dark "
        f"{rec['dark_selected']:.0f} stale {rec['staleness_mean']:.2f}/"
        f"{rec['staleness_max']:.0f}" for rec in logs)
        + f"; peak device memory {host_peak:.2f} GB ({base:.2f} GB "
        "allocated before the run)", flush=True)
    out["avail_fused"], cli_ms, peak, replay_ms, eager_ms = drift_fused(
        "avail fused path", AVAIL_FLAGS, None, 1, False, torch, dev, markov,
        extra)
    print(f"avail ms per internal iteration: host loop {host_ms:.1f} (the "
          f"CLI's last round, eval included), fused CLI {cli_ms:.1f}; the "
          f"library's blind run replayed {replay_ms:.2f}, eager "
          f"{eager_ms:.2f}; peak device memory of the CLI runs: host "
          f"{host_peak:.2f} GB, fused {peak:.2f} GB", flush=True)
    avail_host_vs_fused(torch, dev, extra, markov)
    gc.collect()
    torch.cuda.empty_cache()
    for flags, engines in AVAIL_SMOKE:
        for engine_name in engines:
            records_card_vs_cpu(
                f"avail {engine_name} " + " ".join(flags),
                flags + ["--engine", engine_name], AVAIL_KEYS, AVAIL_COUNTED)
    print(f"avail phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return out, entry


# -------------------------------------------------------------- population
# The lazy population (DESIGN.md §17): a million devices, each factory's
# engine slots bound to a candidate committee, every resident device's
# Dirichlet row drawn on the card by dirichlet_rows each iteration.
POP_DEVICES, POP_SMALL = 1_000_000, 10_000
POP_FLAGS = ["--reselect-every", "3"]        # the committee redrawn at t = 3
POP_SMOKE = ["--devices", "1000", "--reselect-every", "2"]
POP_SMOKE_SETS = [([], ("host", "fused")), (AVAIL_FLAGS, ("host",)),
                  (ROBUST_SMOKE_FLAGS, ("host",)),
                  (["--drift", "redraw", "--drift-period", "2"], ("host",))]
README_FLAGS = ["--devices", "1000000", "--groups", "8",
                "--devices-per-group", "16", "--reselect-every", "10"]
POP_MEMORY_TOL = 16 * 2 ** 20           # bytes of peak device memory


def check_population_rows(torch, dev) -> dict:
    """``dirichlet_rows`` with one concentration per element, against its
    plain version on the card, bit for bit: the 350 devices seated at t =
    0 by the full-width CLI at D = 10⁶ (the committee of 35 from each
    factory's 100,000), around their factories' rows of the concentration
    table; the M = 10 factory priors at α = 1 (the table's build). Each
    timed per launch inside a CUDA graph (as the fused round pays it) and
    eagerly (CUDA events, the host wrapper included), and the plain
    version on the card. The bound counts the draw's hashes from the plain
    version's loop passes, as :func:`check_dirichlet_rows` does."""
    import numpy as np

    from repro_torch.core import prng
    from repro_torch.data import (LazyPopulation, PopulationConfig,
                                  make_device_sampler)
    from repro_torch.kernels import dirichlet as kd

    pop = LazyPopulation(PopulationConfig(
        num_factories=10, devices_per_factory=POP_DEVICES // 10), dev)
    seats = make_device_sampler(pop, candidates=35, candidate_every=3).seats(
        0, np.arange(10)).reshape(-1, pop.staged_words)
    staged = torch.as_tensor(seats, device=dev)
    prior = np.zeros((10, 4), np.int64)
    prior[:, 2:] = prng.fold_in(pop._k_prior, np.arange(10))
    cases = {"population": (staged[:, 1:].contiguous(),
                            pop.table[staged[:, 1]].contiguous()),
             "prior": (torch.as_tensor(prior, device=dev),
                       torch.ones(10, 62, device=dev))}
    res = {}
    for name, (trace, alpha) in cases.items():
        r, f = alpha.shape
        out = kd.draw_rows(trace, alpha)
        ref = kd.drift_rows_plain(None, trace, alpha)
        if not torch.equal(out, ref):
            fail(f"dirichlet_rows {name}: the kernel differs from its plain "
                 f"version by {float((out - ref).abs().max())}")
        stats = {}
        prng.dirichlet_t(trace[:, 2:], alpha, f, stats)
        hashes = 4 * stats["elements"] + 4 * stats["passes"] \
            + 3 * stats["draws"]
        call = lambda: kd.draw_rows(trace, alpha)
        ms, eager = graph_ms(torch, call), time_ms(call, reps=50)
        plain_ms = time_ms(lambda: kd.drift_rows_plain(None, trace, alpha),
                           reps=3, warmup=1)
        b_ms, b_by = bound(8 * r * f + 32 * r, THREEFRY_INT_OPS * hashes,
                           INT32_OPS)
        res[name] = dict(ms=ms, eager_ms=eager, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, rows=r)
        print(f"dirichlet_rows {name} (R={r}, F={f}, one concentration per "
              f"element, {stats['elements']} elements, {stats['passes']} "
              f"outer passes, {stats['draws']} normal draws): kernel == "
              f"plain bit for bit; {ms:.4f} ms per launch in a graph, "
              f"{eager:.4f} eager, {plain_ms:.4f} ms plain, bound "
              f"{b_ms:.5f} ms ({b_by}); library: none", flush=True)
    return res


def pop_host(label, flags, draws, torch) -> tuple:
    """The host loop of the CLI over a lazy population at full width (R =
    2, T = 3): driven and counted (:func:`fedgs_expect`, the table's launch
    included), with its peak device memory. Returns (counts, ms per
    internal iteration, peak bytes)."""
    rounds, iters, every = 2, 3, 2
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, counts, ms = drive(label, main_flags(rounds, iters, every) + flags,
                          fedgs_expect(rounds, iters, every, 3, draws, False,
                                       tables=1), torch)
    return counts, ms, torch.cuda.max_memory_allocated()


def population_phase(torch, dev) -> tuple[dict, dict]:
    """The lazy population at full width and the paper's traffic (M = 10,
    K = 35 slots, L = 10, L_rnd = 2, n = 32; committees redrawn every 3
    iterations): ``dirichlet_rows`` per element against its plain version
    (:func:`check_population_rows`); the CLI at D = 10⁶ on the host loop
    (one ``dirichlet_rows`` an iteration for the seated rows, one for the
    table) and the fused engine (:func:`drift_fused`: the capture held to
    one round, graph == eager through the library over the same
    population, ms per iteration replayed and eager); the same at D = 10⁴,
    whose peak device memory must be within ``POP_MEMORY_TOL`` of D =
    10⁶'s on each engine; fedavg over the lazy pool at D = 10⁶ on both
    engines (:func:`baseline_strategy`); the README's command, fused, 2
    rounds; then the smoke configuration with ``--devices`` card vs CPU,
    alone and composed with the availability, robust and drift flags.
    Returns (each path's counts, the kernel's numbers)."""
    t0 = time.perf_counter()
    rows = check_population_rows(torch, dev)
    out, peaks, ms = {}, {}, {}
    for d in (POP_DEVICES, POP_SMALL):
        flags = ["--devices", str(d)] + POP_FLAGS
        key = "pop_host" if d == POP_DEVICES else "pop_host_small"
        out[key], ms[("host", d)], peaks[("host", d)] = pop_host(
            f"population host path D={d}", flags, 1, torch)
    for d in (POP_DEVICES, POP_SMALL):
        flags = ["--devices", str(d)] + POP_FLAGS
        key = "pop_fused" if d == POP_DEVICES else "pop_fused_small"
        res = drift_fused(f"population fused path D={d}", flags, None, 3, 1,
                          torch, dev, population=d // 10,
                          library=d == POP_DEVICES)
        out[key], ms[("fused", d)] = res[0], res[1]
        peaks[("fused", d)] = int(res[2] * 1e9)
        if d == POP_DEVICES:
            ms["replayed"], ms["eager"] = res[3], res[4]
    for engine_name in ("host", "fused"):
        big, small = peaks[(engine_name, POP_DEVICES)], \
            peaks[(engine_name, POP_SMALL)]
        if abs(big - small) > POP_MEMORY_TOL:
            fail(f"population {engine_name}: peak device memory "
                 f"{big / 1e9:.4f} GB at D={POP_DEVICES} against "
                 f"{small / 1e9:.4f} GB at D={POP_SMALL}")
    print("population peak device memory (CLI runs): " + "; ".join(
        f"{e} D={d} {peaks[(e, d)] / 1e9:.4f} GB"
        for e in ("host", "fused") for d in (POP_DEVICES, POP_SMALL))
        + f" (flat in D to {POP_MEMORY_TOL >> 20} MB); ms per internal "
        "iteration (the CLI's last round, eval included): " + "; ".join(
            f"{e} D={d} {ms[(e, d)]:.1f}"
            for e in ("host", "fused") for d in (POP_DEVICES, POP_SMALL))
        + f"; fused library D={POP_DEVICES} replayed {ms['replayed']:.2f}, "
        f"eager {ms['eager']:.2f}", flush=True)
    res = baseline_strategy(torch, dev, "fedavg",
                            ("--devices", str(POP_DEVICES)), draws=1,
                            tables=1)
    out["pop_baselines_host"] = dict(res["host"]["counts"])
    out["pop_baselines_fused"] = dict(res["fused"]["counts"])
    # the README's command: 8 factories of 125,000, 16 slots, 2 rounds of
    # the default T = 50 with the committee redrawn every 10 iterations
    readme = README_FLAGS + ["--engine", "fused", "--rounds", "2",
                             "--iters", "50", "--eval-every", "2", "--seed",
                             "0"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    logs, out["pop_readme"], readme_ms = drive(
        "population README command", readme,
        fedgs_expect(2, 50, 2, 10, 1, True, tables=1), torch)
    print(f"population README command: reselections "
          f"{[rec['reselections'] for rec in logs]}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.4f} GB", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    for flags, engines in POP_SMOKE_SETS:
        for engine_name in engines:
            records_card_vs_cpu(
                f"population {engine_name} " + " ".join(POP_SMOKE + flags),
                POP_SMOKE + flags + ["--engine", engine_name], AVAIL_KEYS,
                AVAIL_COUNTED)
    records_card_vs_cpu("population fedavg", [
        "--devices", "1000", "--strategy", "fedavg", "--engine", "fused"])
    ms["readme"] = readme_ms
    ms["fedavg"] = (res["host_ms"], res["replayed_ms"], res["eager_ms"])
    print(f"population phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return out, dict(rows=rows, ms=ms, peaks=peaks)



LM_ARCH = "granite-3-2b"
PREFILL_BATCH, PREFILL_LEN = 2, 4096     # granite's published context
FLASH_SWEEP = [(1, 4, 4, 256, 64), (2, 8, 2, 128, 32), (1, 4, 1, 256, 128)]
FLASH_MASKS = [(True, None), (True, 96), (False, None)]


def attended_pairs(s: int, causal: bool, window) -> int:
    """(query, key) pairs a mask leaves unmasked in an (s, s) attention."""
    if not causal:
        return s * s if window is None else sum(
            s - max(0, i - window + 1) for i in range(s))
    return sum(min(i + 1, window or s) for i in range(s))


def check_flash_attention(torch, dev):
    """``flash_attention`` against ``attention_plain`` on the card: the
    JAX package's sweep (f32 to 2e-5, bf16 to 2e-2, three masks), then the
    full-width prefill shape in f32 with kernel, plain and SDPA times (the
    GQA call, and the MHA call on K/V expanded to H heads outside the timed
    region) and the bound of each mask (the FLOP of the unmasked pairs
    only), then zamba2-7b's D = 112 shape."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kfa

    gen = torch.Generator(device=dev).manual_seed(7)
    tols = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    worst = {dt: 0.0 for dt in tols}

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def plain(q, k, v, causal, window):
        return kfa.attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal,
                                   window=window).transpose(1, 2)

    for b, h, kv, s, d in FLASH_SWEEP:
        for dtype, tol in tols.items():
            q, k, v = rand(b, s, h, d, dtype=dtype), \
                rand(b, s, kv, d, dtype=dtype), rand(b, s, kv, d, dtype=dtype)
            for causal, window in FLASH_MASKS:
                out = kfa.flash_attention(q, k, v, causal=causal,
                                          window=window, block_q=min(128, s),
                                          block_k=min(128, s))
                err = float((out.float() - plain(q, k, v, causal, window)
                             .float()).abs().max())
                if not err <= tol:
                    fail(f"flash_attention sweep {(b, h, kv, s, d)} {dtype} "
                         f"causal={causal} window={window}: max error {err} "
                         f"> {tol}")
                worst[dtype] = max(worst[dtype], err)
    print(f"flash_attention sweep {FLASH_SWEEP} x f32/bf16 x {FLASH_MASKS}: "
          f"max err f32 {worst[torch.float32]:.3g} (tol 2e-5), bf16 "
          f"{worst[torch.bfloat16]:.3g} (tol 2e-2)", flush=True)

    b, s, h, kv, d = PREFILL_BATCH, PREFILL_LEN, 32, 8, 64
    q, k, v = rand(b, s, h, d), rand(b, s, kv, d), rand(b, s, kv, d)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    rows = []
    for causal, window in ((True, None), (True, 1024), (False, None)):
        out = kfa.flash_attention(q, k, v, causal=causal, window=window)
        err = float((out - plain(q, k, v, causal, window)).abs().max())
        if not err <= tols[torch.float32]:
            fail(f"flash_attention prefill causal={causal} window={window}: "
                 f"max error {err} > 2e-5")
        worst[torch.float32] = max(worst[torch.float32], err)
        run = lambda: kfa.flash_attention(q, k, v, causal=causal,
                                          window=window)
        ms = time_ms(run, reps=10)
        plain_ms = time_ms(lambda: plain(q, k, v, causal, window), reps=3,
                           warmup=1)
        # SDPA's yardsticks: the GQA call, and (MHA) the same call on K/V
        # expanded to H heads before the timed region
        mask = {}
        if window is not None:
            i = torch.arange(s, device=dev)
            mask = dict(attn_mask=(i[None, :] <= i[:, None])
                        & (i[None, :] > i[:, None] - window))
        else:
            mask = dict(is_causal=causal)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **mask), reps=5)
        ke, ve = (x.repeat_interleave(h // kv, dim=1) for x in (kt, vt))
        mha_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, ke, ve, **mask), reps=5)
        del ke, ve, mask
        ops = 4 * d * b * h * attended_pairs(s, causal, window)
        bytes_ = 4 * (2 * b * s * h * d + 2 * b * s * kv * d)
        b_ms, b_by = bound(bytes_, ops)
        rows.append(dict(causal=causal, window=window, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         library_mha_ms=mha_ms, bound_ms=b_ms, bound_by=b_by,
                         tflops=ops / ms / 1e9, share_of_bound=b_ms / ms))
        print(f"flash_attention prefill (B, S, H, KV, D) = {(b, s, h, kv, d)} "
              f"f32 causal={causal} window={window}: max err {err:.3g} (tol "
              f"2e-5); {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
              f"{lib_ms:.4f} ms SDPA (GQA), {mha_ms:.4f} ms SDPA on K/V "
              f"expanded to {h} heads (MHA), bound {b_ms:.4f} ms ({b_by}), "
              f"{ops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.0%} of the bound",
              flush=True)
        torch.cuda.empty_cache()
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()

    # zamba2-7b's shared attention: 32/32 heads of 3584 / 32 = 112
    b, s, h, kv, d = HYBRID_PREFILL + (32, 32, 112)
    q, k, v = rand(b, s, h, d), rand(b, s, kv, d), rand(b, s, kv, d)
    out = kfa.flash_attention(q, k, v)
    err = float((out - plain(q, k, v, True, None)).abs().max())
    if not err <= tols[torch.float32]:
        fail(f"flash_attention D=112 (zamba2-7b): max error {err} > 2e-5")
    worst[torch.float32] = max(worst[torch.float32], err)
    ms = time_ms(lambda: kfa.flash_attention(q, k, v), reps=10)
    plain_ms = time_ms(lambda: plain(q, k, v, True, None), reps=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), reps=5)
    ops = 4 * d * b * h * attended_pairs(s, True, None)
    b_ms, b_by = bound(4 * (2 * b * s * h * d + 2 * b * s * kv * d), ops)
    rows.append(dict(causal=True, window=None, D=d, shape=(b, s, h, kv, d),
                     max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                     tflops=ops / ms / 1e9, share_of_bound=b_ms / ms))
    print(f"flash_attention zamba2-7b shape (B, S, H, KV, D) = "
          f"{(b, s, h, kv, d)} f32 causal: max err {err:.3g} (tol 2e-5); "
          f"{ms:.4f} ms kernel, {plain_ms:.4f} ms plain, {lib_ms:.4f} ms "
          f"SDPA, bound {b_ms:.4f} ms ({b_by}), {ops / ms / 1e9:.1f} "
          f"TFLOP/s, {b_ms / ms:.0%} of the bound", flush=True)
    del q, k, v, qt, kt, vt, out
    torch.cuda.empty_cache()
    main_row = rows[0]
    return dict(name=kfa.NAME, route="cuda", source=kfa.SOURCE,
                replaces=kfa.REPLACES, max_abs_err=worst[torch.float32],
                tol=2e-5, max_abs_err_bf16=worst[torch.bfloat16],
                tol_bf16=2e-2, ms=main_row["ms"],
                plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
                bound_by=main_row["bound_by"],
                library_ms=main_row["library_ms"],
                shape=(f"B={PREFILL_BATCH} S={PREFILL_LEN} H=32 KV=8 D=64 "
                       "f32 causal"),
                cases=rows)


def lm_profile(torch, run, label) -> None:
    """Device time of one ``run()`` by kernel class: the port's flash and
    SSD kernels, the GEMMs and the rest, against the host clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    kern = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(k[0] for k in kern)
    tags = {"flash_attention": ("flash_fwd",),
            "ssd_scan": ("ssd_gram", "ssd_chunk_state", "ssd_state_pass",
                         "ssd_chunk_scan")}
    mine = lambda key: any(t in key for ts in tags.values() for t in ts)
    ours = {name: sum(k[0] for k in kern if any(t in k[2] for t in ts))
            for name, ts in tags.items()}
    gemm = sum(k[0] for k in kern if not mine(k[2]) and any(
        w in k[2].lower() for w in ("gemm", "cutlass", "sm90_xmma")))
    if busy <= 0:
        print(f"{label} profile: device time not measured (no CUDA events "
              "in the trace)", flush=True)
        return
    other = busy - gemm - sum(ours.values())
    print(f"{label} profile: wall {wall:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall:.1f}%): " + "".join(
              f"{name} {ms:.1f} ms ({100 * ms / busy:.1f}%), "
              for name, ms in ours.items() if ms > 0)
          + f"GEMMs {gemm:.1f} ms ({100 * gemm / busy:.1f}%), other "
          f"{other:.1f} ms", flush=True)
    for ms, count, name in sorted(kern, reverse=True)[:8]:
        print(f"{label} profile device: {ms:9.3f} ms  x{count:<5d} "
              f"{name[:90]}", flush=True)


def uncounted_params(cfg) -> int:
    """Parameters that ``ArchConfig.param_count`` leaves out: the norm
    scales, and per Mamba2 block the depthwise conv, its bias, the dt bias,
    A_log, D and the gated norm."""
    d = cfg.d_model
    if cfg.arch_type == "dense":
        return (2 * cfg.num_layers + 1) * d
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    per_layer = (d + cfg.ssm_conv_width * conv_ch + conv_ch
                 + 3 * cfg.ssm_heads + cfg.d_inner)
    shared = 2 * d if cfg.arch_type == "hybrid" else 0
    return cfg.num_layers * per_layer + d + shared


def check_param_count(label, cfg, params) -> int:
    from repro_torch.models import layers
    n_par = layers.num_params(params)
    extra = uncounted_params(cfg)
    if n_par != cfg.param_count() + extra:
        fail(f"{label}: {n_par} parameters, the config counts "
             f"{cfg.param_count()} + {extra} outside param_count")
    return n_par


def prefill(torch, label, cfg, fns, params, toks, launches: dict) -> dict:
    """One full-width prefill forward (``attn_impl="pallas"``) with every
    launch count set to 0 just before and read just after: it must equal
    ``launches`` (the other kernels 0). Then three timed runs (host clock,
    synchronised), tokens/s, peak memory and one profiled run."""
    from repro_torch.core import dispatch

    forward = lambda: fns.forward(params, {"tokens": toks},
                                  attn_impl="pallas")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    logits = forward()
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    expect = dict({name: 0 for name in counts}, **launches)
    if counts != expect:
        fail(f"{label} prefill: launch counts {counts} != {expect}")
    shape = tuple(toks.shape) + (cfg.padded_vocab,)
    if tuple(logits.shape) != shape or not bool(torch.isfinite(logits).all()):
        fail(f"{label} prefill: logits {tuple(logits.shape)} (want {shape}) "
             "or not finite")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del logits
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    n_tok = toks.numel()
    print(f"{label} prefill: (B, S) = {tuple(toks.shape)}, launches "
          + ", ".join(f"{n} {name}" for name, n in launches.items())
          + f", logits finite; {[round(w, 1) for w in walls]} ms per "
          f"prefill (host clock, synchronised), "
          f"{n_tok / min(walls) * 1e3:.0f} tokens/s at the best; peak "
          f"device memory {peak_gb:.2f} GB", flush=True)
    lm_profile(torch, forward, f"{label} prefill")
    return counts


def decode_vs_prefill(torch, label, cfg, params, toks, window=None) -> None:
    """Decode step by step against the kernels' prefill of the same
    tokens, to 1e-4 of the largest logit (windowed: a ring cache of
    ``window`` slots)."""
    from repro_torch.models import transformer

    c = cfg if window is None else cfg.with_(sliding_window=window)
    s = toks.shape[1]
    full, _ = transformer.forward(c, params, toks, window=window,
                                  attn_impl="pallas")
    cache = transformer.init_decode_cache(c, toks.shape[0], s,
                                          windowed=window is not None,
                                          device=toks.device)
    outs = []
    for i in range(s):
        lg, cache = transformer.decode_step(c, params, cache,
                                            toks[:, i:i + 1], i,
                                            windowed=window is not None)
        outs.append(lg)
    err = float((torch.cat(outs, 1) - full).abs().max())
    scale = float(full.abs().max())
    tol = 1e-4 * scale
    if not err <= tol:
        fail(f"{label} decode vs prefill (window {window}): max error {err} "
             f"> {tol:.3g} (1e-4 of max |logit| {scale:.3g})")
    what = f"window {window}, ring cache of {window}" if window else \
        "plain cache"
    print(f"{label} decode vs prefill at full width, {tuple(toks.shape)} "
          f"tokens, {what}: {s} decode steps against the kernels' prefill, "
          f"max |diff| {err:.3g} (tol {tol:.3g} = 1e-4 of max |logit| "
          f"{scale:.3g})", flush=True)
    del full, cache, outs


def serve_phase(torch, label, cfg, dev) -> None:
    """``serve()`` at the JAX CLI's defaults (batch 4, prompt 32, gen 32):
    threefry init, prefill by repeated decode, no kernel launch."""
    from repro_torch.core import dispatch
    from repro_torch.launch import serve

    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    res = serve.serve(cfg, batch=4, prompt_len=32, gen=32, windowed=False,
                      seed=0, device=dev)
    serve_counts = dispatch.launch_counts()
    if any(serve_counts.values()):
        fail(f"{label} serve: kernel launches {serve_counts}, want none")
    if res["tokens"].shape != (4, 32) or res["tokens"].min() < 0 or \
            res["tokens"].max() >= cfg.vocab_size:
        fail(f"{label} serve: token ids out of range: {res['tokens']}")
    print(f"{label} serve: {cfg.name} full width, batch 4, prompt 32, gen 32 "
          f"(threefry init, prefill by repeated decode): "
          f"{res['ms_per_step']:.2f} ms/step, {res['tok_per_s']:.1f} tok/s, "
          f"{res['steps']} steps, no kernel launch; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    torch.cuda.empty_cache()


def markov_tokens(torch, dev, vocab, shape):
    """Prefill tokens of ``shape`` and 128 decode tokens from
    ``MarkovLMStream(vocab, seed=0)``, as the JAX package's LM data."""
    from repro_torch.data import MarkovLMStream
    stream = MarkovLMStream(vocab, seed=0)
    return (torch.as_tensor(stream.sample(*shape), device=dev),
            torch.as_tensor(stream.sample(1, 128), device=dev),
            "MarkovLMStream")


def random_tokens(torch, dev, vocab, shape):
    """The same tokens' shapes drawn on the card: the model does the same
    work for any ids, and a vocab² Markov table costs a minute of host
    time at zamba2's 32,000."""
    gen = torch.Generator(device=dev).manual_seed(1)
    return (torch.randint(0, vocab, shape, generator=gen, device=dev),
            torch.randint(0, vocab, (1, 128), generator=gen, device=dev),
            "torch.randint")


def lm_path(torch, dev):
    """The dense-LM serving slice at full width and depth: prefill with the
    kernel (counted, timed, profiled), serve(), decode against prefill.
    Returns the prefill run's launch counts."""
    from repro_torch import configs
    from repro_torch.models import build

    cfg = configs.get_config(LM_ARCH)
    fns = build(cfg)
    t0 = time.perf_counter()
    toks, dec_toks, _ = markov_tokens(torch, dev, cfg.vocab_size,
                                      (PREFILL_BATCH, PREFILL_LEN))
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = fns.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_par = check_param_count("lm", cfg, params)
    print(f"lm: {LM_ARCH} at full width and depth ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, vocab {cfg.vocab_size} -> {cfg.padded_vocab}), "
          f"{n_par:,} f32 parameters from a CUDA torch.Generator in "
          f"{init_s:.1f} s; MarkovLMStream tokens {tuple(toks.shape)} in "
          f"{data_s:.1f} s", flush=True)

    counts = prefill(torch, "lm", cfg, fns, params, toks,
                     {"flash_attention": cfg.num_layers})

    # decode against prefill at full width (the JAX package's tests)
    for window in (None, 64):
        decode_vs_prefill(torch, "lm", cfg, params, dec_toks, window)
    del params
    torch.cuda.empty_cache()
    serve_phase(torch, "lm", cfg, dev)
    return counts


def lm_smoke_card_vs_cpu(torch, dev, arch=LM_ARCH, prefix="lm") -> None:
    """The smoke config of ``arch``: the serve CLI's token ids on the card
    equal the CPU run's (plain and ring cache, the ring wrapping, for archs
    with attention), and the prefill logits through the kernels agree with
    the CPU's plain versions."""
    from repro_torch import configs, convert
    from repro_torch.core import prng
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    cfg = configs.get_smoke_config(arch)
    runs = [["--arch", arch]]
    if cfg.has_attention:
        runs.append(["--arch", arch, "--windowed", "--prompt-len", "40",
                     "--gen", "40"])
    for flags in runs:
        ids = {}
        for device in ("cuda", "cpu"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res = serve.main(flags + ["--device", device])
            ids[device] = res["tokens"]
        if not (ids["cuda"] == ids["cpu"]).all():
            fail(f"{prefix} smoke serve {flags}: token ids differ card vs "
                 f"CPU:\n{ids['cuda'][0].tolist()}\n{ids['cpu'][0].tolist()}")
        print(f"{prefix} smoke serve {' '.join(flags)}: all "
              f"{ids['cpu'].size} token ids equal card vs CPU; row 0 starts "
              f"{ids['cpu'][0, :16].tolist()}", flush=True)
    params = transformer.init_lm(cfg, prng.PRNGKey(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 256),
                         generator=torch.Generator().manual_seed(0))
    ref, _ = transformer.forward(cfg, params, toks, attn_impl="pallas")
    gp = convert.params_from_jax(convert.params_to_numpy(params), dev)
    out, _ = transformer.forward(cfg, gp, toks.to(dev), attn_impl="pallas")
    err = float((out.cpu() - ref).abs().max())
    if not err <= 1e-4:
        fail(f"{prefix} smoke prefill: card vs CPU logits differ by {err} > "
             "1e-4")
    print(f"{prefix} smoke prefill (2, 256), attn_impl='pallas': card "
          f"(kernels) vs CPU (plain) logits max |diff| {err:.3g} (tol 1e-4)",
          flush=True)


SSM_ARCH, HYBRID_ARCH = "mamba2-780m", "zamba2-7b"
SSM_PREFILL = (4, 2048)          # Mamba2's training context, 8192 tokens
HYBRID_PREFILL = (1, 4096)


def ssd_work(bt, s, h, p, n) -> tuple[int, int]:
    """(bytes, FLOP) the scan needs at the least: each input read and y
    written once; per (token, head) C·S and the state update, 2NP each. A
    chunked form that walks blocks of T steps adds the causal triangles
    (the masked product with x·dt per head, C·Bᵀ per batch), which grow
    with T and vanish at T = 1, where the recurrent form is left; so the
    floor is 4NP per (token, head), whatever blocking a kernel picks."""
    flop = 4 * bt * s * h * n * p
    bytes_ = 4 * (2 * bt * s * h * p + bt * s * h + h + 2 * bt * s * n)
    return bytes_, flop


def ssd_split(kssd, args, chunk) -> dict:
    """Each launch of ``csrc/ssd_scan.cu`` timed on its own (CUDA events,
    on the buffers of one full run), with its CTAs and the work it does:
    the state and scan launches' FLOP (the scan's causal triangle as the
    kernel runs it: each 32-column slice on the rows at or below its first
    column), the
    pass's bytes (each state slot but the last read, each but the first
    written)."""
    x, dt, A, B, C = args
    bt, s, h, p = x.shape
    call = kssd.prepare(x, dt, A, B, C, chunk)
    kssd.run(call)
    lay = kssd.plan(bt, s, h, p, B.shape[-1], chunk)
    nc, n = lay["chunks"], lay["n"]
    tri = sum(32 * (chunk - j0) for j0 in range(0, chunk, 32))  # (i, j)
    work = {"state": ("tflops", 2 * bt * (nc - 1) * h * n * p * chunk),
            "pass": ("tbps", 2 * 4 * bt * (nc - 1) * h * n * p),
            "scan": ("tflops", 2 * bt * h * p * ((nc - 1) * chunk * n
                                                 + nc * tri))}
    split = {}
    for i, part in enumerate(kssd.PARTS):
        ms = time_ms(lambda: kssd.run(call, 1 << i), reps=10)
        split[part] = {"ms": ms, "ctas": lay["ctas"][part]}
        if part in work:
            key, amount = work[part]
            split[part][key] = amount / ms / 1e9
    return split


def check_ssd_scan(torch, dev):
    """``ssd_scan`` against ``ssd_scan_plain`` on the card, to 1e-4 ·
    max(1, max |y|): the sweep, then both full-width prefill shapes
    (mamba2-780m (4, 2048, 48, 64, 128), zamba2-7b (1, 4096, 112, 64, 64),
    chunk 128) with kernel and plain times, the FLOP bound and each of the
    kernel's four launches timed on its own."""
    from repro_torch import configs
    from repro_torch.kernels import ssd_scan as kssd

    gen = torch.Generator(device=dev).manual_seed(11)
    worst = 0.0

    def compare(case, chunk):
        nonlocal worst
        args = kssd.example_inputs(gen, *case)
        y = kssd.ssd_scan(*args, chunk=chunk)
        ref = kssd.ssd_scan_plain(*args, chunk=chunk)
        err = float((y - ref).abs().max())
        scale = max(1.0, float(ref.abs().max()))
        if not err <= 1e-4 * scale:
            fail(f"ssd_scan {case} chunk={chunk}: max error {err} > 1e-4 * "
                 f"{scale:.3g}")
        worst = max(worst, err / scale)
        return args, err, scale

    for bt, s, h, p, n, chunk in kssd.SWEEP:
        compare((bt, s, h, p, n), chunk)
    print(f"ssd_scan sweep {kssd.SWEEP}: max err {worst:.3g} of max(1, "
          "max |y|) (tol 1e-4)", flush=True)

    rows = []
    for arch, (bt, s) in ((SSM_ARCH, SSM_PREFILL),
                          (HYBRID_ARCH, HYBRID_PREFILL)):
        cfg = configs.get_config(arch)
        h, p, n, q = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                      cfg.ssm_chunk)
        args, err, scale = compare((bt, s, h, p, n), q)
        ms = time_ms(lambda: kssd.ssd_scan(*args, chunk=q), reps=10)
        plain_ms = time_ms(lambda: kssd.ssd_scan_plain(*args, chunk=q),
                           reps=3, warmup=1)
        bytes_, flop = ssd_work(bt, s, h, p, n)
        b_ms, b_by = bound(bytes_, flop)
        split = ssd_split(kssd, args, q)
        rows.append(dict(arch=arch, shape=(bt, s, h, p, n, q),
                         max_abs_err=err, scale=scale, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         gflop=flop / 1e9, tflops=flop / ms / 1e9,
                         split=split))
        print(f"ssd_scan {arch} prefill (Bt, S, H, P, N, Q) = "
              f"{(bt, s, h, p, n, q)}: max err {err:.3g} (tol 1e-4 * "
              f"{scale:.3g}); {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
              f"bound {b_ms:.4f} ms ({b_by}: {flop / 1e9:.2f} GFLOP), "
              f"{flop / ms / 1e9:.1f} TFLOP/s; no single PyTorch call "
              "computes the scan", flush=True)
        print(f"ssd_scan {arch} launches, each timed alone: " + "; ".join(
            f"{part} {v['ms']:.4f} ms ({v['ctas']} CTAs"
            + (f", {v['tflops']:.1f} TFLOP/s" if "tflops" in v else "")
            + (f", {v['tbps']:.2f} TB/s" if "tbps" in v else "") + ")"
            for part, v in split.items()) + "; sum "
            f"{sum(v['ms'] for v in split.values()):.4f} ms", flush=True)
        del args
        torch.cuda.empty_cache()
    main_row = rows[0]
    return dict(name=kssd.NAME, route="cuda", source=kssd.SOURCE,
                replaces=kssd.REPLACES, max_abs_err=main_row["max_abs_err"],
                tol="1e-4 * max(1, max |y|)", max_rel_err_all=worst,
                ms=main_row["ms"], plain_ms=main_row["plain_ms"],
                bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
                library_ms=None,
                shape="Bt=4 S=2048 H=48 P=64 N=128 Q=128 f32 (mamba2-780m)",
                cases=rows)


def ssm_path(torch, dev, arch, tokens, launches):
    """The SSM or hybrid serving slice of ``arch`` at full width and depth:
    weights from a CUDA ``torch.Generator``, parameter count, the counted,
    timed and profiled prefill of ``tokens`` (prefill ids, decode ids,
    their source), decode against prefill. Returns the prefill's launch
    counts."""
    from repro_torch import configs
    from repro_torch.models import build

    cfg = configs.get_config(arch)
    fns = build(cfg)
    toks, dec_toks, source = tokens
    t0 = time.perf_counter()
    params = fns.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_par = check_param_count(arch, cfg, params)
    heads = f", shared attention {cfg.n_heads}/{cfg.n_kv_heads} heads of " \
        f"{cfg.head_dim} every {cfg.attn_every} layers" \
        if cfg.has_attention else ""
    print(f"{arch}: full width and depth ({cfg.num_layers} Mamba2 layers, "
          f"d_model {cfg.d_model}, {cfg.ssm_heads} SSM heads of "
          f"{cfg.ssm_head_dim}, state {cfg.ssm_state}{heads}, vocab "
          f"{cfg.vocab_size} -> {cfg.padded_vocab}), {n_par:,} f32 "
          f"parameters ({cfg.param_count():,} by param_count) from a CUDA "
          f"torch.Generator in {init_s:.1f} s; {source} tokens "
          f"{tuple(toks.shape)}", flush=True)
    counts = prefill(torch, arch, cfg, fns, params, toks, launches)
    del toks
    torch.cuda.empty_cache()
    decode_vs_prefill(torch, arch, cfg, params, dec_toks)
    del params
    torch.cuda.empty_cache()
    return counts


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    print(f"environment: python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {card}", flush=True)

    t0 = time.perf_counter()
    probe_build = start_probe_build()
    build.library()
    probe = load_probe(*probe_build)
    print(f"build: {len(build.sources())} sources -> {build.BUILD_DIR} in "
          f"{time.perf_counter() - t0:.1f} s (nvcc {build.BUILD_SECONDS:.1f} "
          "s), and the latency probe beside them", flush=True)
    log = build.BUILD_DIR / "ptxas.log"
    for line in ptxas_lines(log.read_text() if log.is_file() else ""):
        print(line, flush=True)

    kernels = [check_gbp_cs(torch, dev, probe), check_conv(torch, dev),
               check_agg(torch, dev), check_robust_agg(torch, dev),
               check_topk_compress(torch, dev), check_int8(torch, dev),
               check_corrupt_rows(torch, dev),
               check_dirichlet_rows(torch, dev)]
    torch.cuda.synchronize()

    # each path at full width: R rounds of T iterations, eval every E
    rounds, iters, every, m = 2, 3, 2, 10
    flags = main_flags(rounds, iters, every)
    main_expect = {"gbp_cs": rounds * iters,
                   "conv_fused": 2 * rounds * iters + 2 * (rounds // every),
                   "agg_weighted": rounds, "robust_agg": 0,
                   "topk_compress": 0, "int8_quant": 0, "flash_attention": 0,
                   "ssd_scan": 0, "corrupt_rows": 0, "dirichlet_rows": 0,
                   "avail_rows": 0}
    _, main_counts, main_ms = drive("main path", flags, main_expect, torch)
    profile_round("main path", [], torch)
    smoke_card_vs_cpu("main path", [])

    # robust path (DESIGN.md §15): per-member backward (the same conv
    # launches, at G = M·L), one fault-injection and one order-statistics
    # launch per iteration, and the residual's finite-masked mean, one
    # agg_weighted launch per group
    robust_expect = dict(main_expect, robust_agg=rounds * iters,
                         corrupt_rows=rounds * iters,
                         agg_weighted=rounds + m * rounds * iters)
    logs, robust_counts, robust_ms = drive(
        "robust path", flags + ROBUST_FLAGS, robust_expect, torch)
    if sum(rec["corrupted_selected"] for rec in logs) <= 0:
        fail("robust path: no corrupted member was seated in the run")
    print("robust path telemetry: " + "; ".join(
        f"round {rec['round']} corr {rec['corrupted_selected']:.0f} clip "
        f"{rec['clipped_fraction']:.2f} rb {rec['rollbacks']:.0f} residual "
        f"{rec['agg_residual']:.4g}" for rec in logs), flush=True)
    profile_round("robust path", ROBUST_FLAGS, torch)
    smoke_card_vs_cpu("robust path", ROBUST_SMOKE_FLAGS)

    # compress path (DESIGN.md §18): one top-k and one int8 call per
    # internal iteration (all M rows each), one int8 call per round for
    # the external delta; the rest as on the main path
    compress_expect = dict(main_expect, topk_compress=rounds * iters,
                           int8_quant=rounds * iters + rounds)
    logs, compress_counts, compress_ms = drive(
        "compress path", flags + COMPRESS_FLAGS, compress_expect, torch)
    # the analytic ledger (DESIGN.md §18.3): M·L uploads per iteration
    from repro_torch.core import compress
    pay = lambda spec: compress.payload_bytes(
        CNN_PARAMS, compress.parse_compress(spec))
    ledger = (2 * pay(COMPRESS_FLAGS[1]) * iters * m * 10,
              2 * pay(COMPRESS_FLAGS[3]) * m)
    for rec in logs:
        ce = rec["compress_error"]
        if (rec["bytes_int"], rec["bytes_ext"]) != ledger or ce is None \
                or not math.isfinite(ce) or ce <= 0:
            fail(f"compress path: ledger {rec} against the formula's "
                 f"{ledger}")
    print("compress path ledger: " + "; ".join(
        f"round {rec['round']} bytes_int {rec['bytes_int']:.0f} bytes_ext "
        f"{rec['bytes_ext']:.0f} compress_error {rec['compress_error']:.6g}"
        for rec in logs), flush=True)
    profile_round("compress path", COMPRESS_FLAGS, torch)
    for i, smoke in enumerate(COMPRESS_SMOKE_FLAGS):
        smoke_card_vs_cpu(f"compress path {i + 1}", smoke)

    # fused path (the device-resident engine, --engine fused): one CUDA
    # graph per round at full width, without and with compression, each
    # beside its host loop's counts and ms/iteration; smoke card vs CPU
    mem0 = torch.cuda.memory_allocated()
    fused_counts = fused_path("fused path", [], {}, main_expect, main_ms,
                              torch, dev)
    smoke_card_vs_cpu("fused path", ["--engine", "fused"])
    fused_c_counts = fused_path(
        "fused compress path", COMPRESS_FLAGS,
        dict(compress_int=COMPRESS_FLAGS[1], compress_ext=COMPRESS_FLAGS[3]),
        compress_expect, compress_ms, torch, dev)
    smoke_card_vs_cpu("fused compress path",
                      ["--engine", "fused"] + COMPRESS_FLAGS)
    # the fused robust path (DESIGN.md §15 on the device-resident engine):
    # the fault trace staged with the round's keys, one corrupt_rows launch
    # per iteration inside the graph, quarantine in the carry
    fused_r_counts = fused_path(
        "fused robust path", ROBUST_FLAGS,
        dict(robust_agg=ROBUST_FLAGS[3]), robust_expect, robust_ms, torch,
        dev, corrupt=ROBUST_FLAGS[1])
    for extra in ([], ["--compress-int", "topk:0.1+int8"]):
        smoke_card_vs_cpu(
            "fused robust path" + (" compressed" if extra else ""),
            ["--engine", "fused"] + FUSED_ROBUST_SMOKE_FLAGS + extra)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"fused phases: device memory allocated {mem0 / 1e9:.3f} GB "
          f"before, {torch.cuda.memory_allocated() / 1e9:.3f} GB after",
          flush=True)

    # baselines (the Table II strategies, --strategy): all fourteen at full
    # width on the host loop and the fused engine, launch counts held to
    # their formula, graph == eager, five card vs CPU, and the two kernels
    # at the path's shapes (K = 100 client models, G = 100 client CNNs)
    base_host, base_fused, base_kernels = baselines_phase(torch, dev)

    # the dynamic environments (DESIGN.md §13): drift schedules and the
    # GBP-CS cadence on both engines and the baselines, the Dirichlet
    # redraw through dirichlet_rows
    drift_counts = drift_phase(torch, dev)

    # the availability layer (DESIGN.md §14): the trace through avail_rows,
    # markov churn under bounded-async sync on both engines, composed with
    # the robust and compressed paths in the smoke configurations
    avail_counts, avail_entry = avail_phase(torch, dev)
    kernels.append(avail_entry)

    # the lazy population (DESIGN.md §17): a million devices on both
    # engines and the baselines, each resident device's Dirichlet row drawn
    # by dirichlet_rows with its factory's concentrations
    pop_counts, pop_entry = population_phase(torch, dev)
    entry = next(k for k in kernels if k["name"] == "dirichlet_rows")
    for name, row in pop_entry["rows"].items():
        entry.update({f"{name}_{key}": v for key, v in row.items()})
    entry["population_peak_bytes"] = {
        f"{e} D={d}": v for (e, d), v in pop_entry["peaks"].items()}

    # LM path (the dense-LM serving slice): the kernel at the prefill
    # shape, then the full-width prefill, decode and serve, then the smoke
    # config card vs CPU
    kernels.append(check_flash_attention(torch, dev))
    lm_counts = lm_path(torch, dev)
    lm_smoke_card_vs_cpu(torch, dev)

    # SSM and hybrid paths (the Mamba2 serving slice): the scan kernel at
    # both prefill shapes, then mamba2-780m (one scan per layer) and
    # zamba2-7b (one scan per layer, one flash launch per segment of
    # attn_every layers) at full width and depth, mamba2's serve(), and
    # both smoke configs card vs CPU
    from repro_torch import configs
    kernels.append(check_ssd_scan(torch, dev))
    ssm_cfg, hyb_cfg = configs.get_config(SSM_ARCH), \
        configs.get_config(HYBRID_ARCH)
    ssm_counts = ssm_path(
        torch, dev, SSM_ARCH,
        markov_tokens(torch, dev, ssm_cfg.vocab_size, SSM_PREFILL),
        {"ssd_scan": ssm_cfg.num_layers})
    serve_phase(torch, SSM_ARCH, ssm_cfg, dev)
    n_seg = -(-hyb_cfg.num_layers // hyb_cfg.attn_every)
    hybrid_counts = ssm_path(
        torch, dev, HYBRID_ARCH,
        random_tokens(torch, dev, hyb_cfg.vocab_size, HYBRID_PREFILL),
        {"ssd_scan": hyb_cfg.num_layers, "flash_attention": n_seg})
    for arch in (SSM_ARCH, HYBRID_ARCH):
        lm_smoke_card_vs_cpu(torch, dev, arch, arch)

    for k in kernels:
        by_path = {"main": main_counts[k["name"]],
                   "robust": robust_counts[k["name"]],
                   "compress": compress_counts[k["name"]],
                   "fused": fused_counts[k["name"]],
                   "fused_compress": fused_c_counts[k["name"]],
                   "fused_robust": fused_r_counts[k["name"]],
                   "lm": lm_counts[k["name"]],
                   "ssm": ssm_counts[k["name"]],
                   "hybrid": hybrid_counts[k["name"]],
                   "baselines_host": base_host[k["name"]],
                   "baselines_fused": base_fused[k["name"]]}
        by_path.update({p: c.get(k["name"], 0)
                        for p, c in drift_counts.items()})
        by_path.update({p: c.get(k["name"], 0)
                        for p, c in avail_counts.items()})
        by_path.update({p: c.get(k["name"], 0)
                        for p, c in pop_counts.items()})
        k["launches"] = next((v for v in by_path.values() if v), 0)
        k["launches_by_path"] = by_path
        if k["name"] in base_kernels:
            k["baselines_shapes"] = base_kernels[k["name"]]

    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
