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
   CLI's typical fault trace (also per launch in a CUDA graph), its byte
   rows and its Gaussian rows alone, every row ``scale`` and every row
   Gaussian, beside the card's threefry rate from
   ``csrc/probe/latency_probe.cu``; ``dirichlet_rows`` at the drift's
   shape, eagerly and in a graph, beside its latency floor), with times;
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
6b'. sharded path (the group-sharded engine, ``--engine sharded``,
   DESIGN.md §8) — the CLI at full width (R=2, T=3) without a process
   group against ``--engine fused``: records bit for bit, the same
   wrapper counts, and traced, each kernel's executions on the card the
   host loop's plus the warm-up round's; two gloo ranks on the one card
   as child processes (five groups each, one CUDA graph a round, R=3)
   against world 1 through the library (records to 1e-4, params to 1e-5,
   the ranks equal), each rank's capture one round's ``gbp_cs``,
   ``conv_fused`` and ``agg_weighted`` launches and T + 2 graph breaks,
   ms per internal iteration and the collectives' ms per round on each
   rank; the smoke configuration card vs CPU under ``--engine sharded``;
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
   shape (1, 4096, 32/32 heads, 112), at deepseek-v2-236b's MLA shape
   (1, 4096, 128/128 heads, D = 192, Dv = 128; causal and a 64-key window;
   kernel, plain and SDPA times), at dbrx-132b's and internvl2-26b's GQA
   shape (1, 4096, 48/8 heads of 128, causal), at whisper-large-v3's
   encoder (4, 2048, 20/20 heads of 64, non-causal), decoder (causal) and
   cross-attention (512 rows over 2,048 keys, non-causal) shapes (kernel,
   plain and SDPA times), on the JAX
   package's sweep and on MLA's (48, 32) and (192, 128) sweep in f32 and
   bf16; one full-width prefill forward
   (``attn_impl="pallas"``, tokens (2, 4096) drawn on the card) with
   exactly 40 kernel launches, timed and profiled; ``serve()`` at the JAX
   CLI's defaults (batch 4, prompt 32 drawn on the card, gen 32; no kernel
   launch); decode against prefill
   at full width, plain and ring buffer; then the smoke config card vs CPU
   (serve token ids, prefill logits);
8. SSM and hybrid paths (the Mamba2 serving slice) — ``ssd_scan`` against
   its plain version on a sweep (chunk 64/128, N 16–256, P 32/64, one
   chunk, chunks shorter than the kernel's 128 rows, up to 32 chunks) and
   at both full-width prefill shapes, with kernel and plain times and each
   of its four launches timed on its own; ``mamba2-780m`` at full
   width and depth: prefill (4, 2048) drawn on the card with exactly
   48 ``ssd_scan`` launches, timed and profiled, decode against prefill,
   ``serve()`` at batch 4, prompt 32, gen 32; ``zamba2-7b`` at full width
   and depth: prefill (1, 4096) with exactly 81 ``ssd_scan`` and 14
   ``flash_attention`` (D = 112) launches, timed and profiled, decode
   against prefill (its full-width ``serve()`` is left out for time); both
   smoke configs card vs CPU (serve token ids, prefill logits);
8b. MoE paths (the MoE serving slice) — ``deepseek-v2-236b`` (MLA +
   160 experts top-6 + 2 shared) and ``dbrx-132b`` (GQA + 16 experts
   top-4) at full width, depth cut to fit the card (3 layers if the f32
   weights and a prefill's activations fit 75 GB, else 2; printed):
   prefill (1, 4096) drawn on the card with exactly one
   ``flash_attention`` launch a layer (MLA at D = 192, Dv = 128) and the
   MoE dispatch form, timed, profiled, peak memory under 75 GB; decode
   against prefill (deepseek 128 tokens through the kernel, dbrx 48
   against the naive attention; plain and on a ring cache; under 4·E
   tokens, so both sides take the dense MoE form), with ms per decode
   step; dbrx's prefill of 128 tokens through the kernel against the naive
   attention's; deepseek's ``serve()``; both smoke configs card vs CPU;
8c. VLM and enc-dec paths — ``internvl2-26b`` (GQA 48/8 heads of 128) at
   full width, depth cut to fit the card (the most layers whose f32
   weights and 5 GB of prefill activations fit 75 GB; printed): prefill of
   ``make_dummy_batch``'s (1, 4096) batch on the card, 512 vision
   embeddings before 3,584 tokens, one ``flash_attention`` launch a layer,
   timed, profiled, peak memory under 75 GB; the kernels' prefill against
   the naive attention's on 32 + 96 positions; decode of 64 tokens
   against prefill (plain and a 16-slot ring); ``serve()``;
   ``whisper-large-v3`` at full width and depth (32 + 32 layers): a
   forward of ``make_dummy_batch``'s (4, 4096) batch (2,048 frames, 2,048
   tokens) with exactly 96
   ``flash_attention`` launches (encoder, decoder self and cross attention
   a layer), a second with 512 decoder tokens over the same frames (cross
   attention at Sq != Sk), both timed and profiled; greedy decode through
   ``encode`` → ``prefill_cross_cache`` → the serve step at B = 4 against
   the teacher-forced logits; both smoke configs card vs CPU;
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
6e. after the population phase, the tools phase (``tools_phase``): the six
   Fig. 4 samplers over 10 paper-size instances (M=10, K=33, L_sel=8,
   n=32, L_rnd=2; brute capped at 100,000 combinations), each one's mean
   wall ms, divergence / (n·L) and evaluations, ``gbp_cs_sampler`` on the
   card against the CPU, one ``gbp_cs`` launch a call and one for
   ``gbp_cs_minimize_batched`` over all 10, GBP-CS warm per call and
   batched with the ``pinv``'s share; ``cnn.evaluate`` at full width over
   1,240 test images (6 ``conv_fused`` launches) against the CPU and
   ``make_eval_fn`` (one pass and batch=310); the full-width CLI with
   ``--ckpt-dir`` (R=1, T=3), restored on the card and the CPU bit for
   bit, ``evaluate`` of the restored params equal to the saved ones'; the
   three example scripts as child processes (``torch_gbp_cs_demo.py``,
   ``torch_quickstart.py`` at its defaults, ``torch_femnist_e2e.py
   --rounds 2 --iters 3`` at full width), exit 0 and launch counts held;
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

# The H100 SXM peaks: one table for the package and this script
# (``repro_torch.launch.roofline_model.H100_SXM``, each entry with its
# source). Without the package (the script alone) main() stops at its
# first import of it.
try:
    from repro_torch.launch.roofline_model import H100_SXM, THREEFRY_INT_OPS
    HBM_BYTES_PER_S = H100_SXM["hbm_bytes_per_s"]
    FP32_FLOPS = H100_SXM["fp32_flops"]
    INT32_OPS = H100_SXM["int32_ops"]
except ImportError:
    pass


# times this run measured, by path (ms, best of the run's repeats), read
# back by roofline_phase: it adds no run of its own
MEASURED: dict[str, float] = {}


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


def bound(bytes_: float, ops: float, rate: float | None = None
          ) -> tuple[float, str]:
    """Least time in ms: bytes over HBM's rate or ops over ``rate`` (the
    FP32 peak by default)."""
    rate = FP32_FLOPS if rate is None else rate
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


PROBE_SRC = os.path.join(ROOT, "src", "repro_torch", "csrc", "probe",
                         "latency_probe.cu")
CHAIN_OPS = ("shfl", "lds", "fma", "div", "sqrt")
RNG_CHAIN_OPS = ("mix", "normal", "logf", "expf")


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
    lib.hash_rate.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p]
    lib.noop_launch.restype = lib.latency_probe.restype = ctypes.c_int
    lib.hash_rate.restype = ctypes.c_int
    return lib


def chain_latencies(torch, probe, dev, n: int = 4096) -> dict[str, float]:
    """Cycles per dependent operation on the card: a shuffle+add round, a
    shared-memory load, an FMA, an IEEE division, a square root, a
    threefry mix round (``mix``: add, funnel rotate, xor), a normal from
    its bits, a ``logf`` and an ``expf``; and the SM clock in GHz over the
    same kernel."""
    from repro_torch.kernels import build
    out = torch.zeros(16, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for _ in range(2):                    # the second run is the one read
        build.check(probe.latency_probe(out.data_ptr(), n, stream),
                    "latency_probe")
    c = out.cpu().tolist()
    lat = {name: c[i] / n for i, name in enumerate(CHAIN_OPS)}
    lat.update({name: c[8 + i] / n for i, name in enumerate(RNG_CHAIN_OPS)})
    lat["ghz"] = c[5] / c[6]
    return lat


def hash_rate(torch, probe, dev, n: int = 4096) -> float:
    """Threefry hashes a second over the whole card: 8 blocks of 256
    threads an SM, each thread ``n`` hashes four at a time under one key
    (``threefry_bits``, as ``corrupt_rows``' Gaussian rows draw them),
    CUDA events over 5 launches."""
    from repro_torch.kernels import build
    blocks = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(blocks * 256, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ms = time_ms(lambda: build.check(probe.hash_rate(
        out.data_ptr(), blocks, n, stream), "hash_rate"), reps=5)
    return blocks * 256 * n / (ms * 1e-3)


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


def dirichlet_chain(p_max: int) -> dict[str, int]:
    """The chain that no implementation of ``dirichlet_rows`` can shorten,
    by kind: the worst element's key hash, its split, the p_max − 1 further
    key-chain hashes to the accepted pass's key, that pass's candidate (the
    normal's key, its split and its bits: 3 hashes; the normal; v, v², v³),
    log V and the two adds into the log-gamma value; then the row's softmax
    (the max butterfly, the subtraction, expf, the sum butterfly, the
    division). A hash counts as its 20 mix rounds, its key injections left
    out, so the price is a floor."""
    return {"mix": 20 * (p_max + 4), "normal": 1, "fma": 6, "logf": 1,
            "expf": 1, "shfl": 10, "div": 1}


def node_ms(torch, probe, dev) -> float:
    """An empty kernel's time per node of a CUDA graph of 50."""
    from repro_torch.kernels import build
    return graph_ms(torch, lambda: build.check(probe.noop_launch(
        torch.cuda.current_stream(dev).cuda_stream), "noop"))


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
    n_ms = node_ms(torch, probe, dev)
    plain_ms = time_ms(lambda: kgbp.minimize_plain(A, y, x0, max_iters),
                       reps=5, warmup=1)
    lat = chain_latencies(torch, probe, dev)
    step, init = gbp_cs_chain(f, kc)
    s, s_max = int(iters.sum()), int(iters.max())
    floor_ms = n_ms + chain_ms(init, lat) + s_max * chain_ms(step, lat)
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
          f"max_iters 0), empty node {n_ms:.5f} "
          f"ms; latency floor {floor_ms:.5f} ms (step chain {step}, set-up "
          f"{init}; cycles per op "
          f"{', '.join(f'{n} {v:.1f}' for n, v in lat.items() if n != 'ghz')}"
          f" at {lat['ghz']:.3f} GHz); bytes/FLOP bound {b_ms:.7f} ms "
          f"({b_by})", flush=True)
    return dict(name=kgbp.NAME, route="cuda", source=kgbp.SOURCE,
                replaces=kgbp.REPLACES, max_abs_err=err, tol=tol, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, graph_ms=g_ms, setup_ms=setup_ms,
                node_ms=n_ms,
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


def int8_draws(torch, x) -> int:
    """Coordinates of x (M, P) whose stochastic rounding needs its draw:
    y − floor(y) > 0, y = x / the row's scale (``quantize_plain``'s
    arithmetic); the others come out the same whatever the draw."""
    from repro_torch.kernels import int8_quant as kq
    scale = torch.clamp_min(x.abs().amax(dim=1, keepdim=True) * kq.INV_127,
                            1e-30)
    y = x / scale
    return int((y - torch.floor(y) > 0).sum())


def check_int8(torch, dev, probe):
    """Stochastic int8 of the compress path's two inputs, a different key
    per row, (10, P4) gradient rows: the internal link's top-k rows (k at
    1% of |θ|, ``topk_compress.select``) and the external link's dense
    rows (row 3 half zeros). Each bit-equal to the plain version
    (threefry in PyTorch int64 ops), timed eagerly and per launch inside a
    CUDA graph of 50. The bound prices the draws the rows need
    (:func:`int8_draws`) at the card's threefry rate (``hash_rate``)
    against one read and one write, 8 bytes a coordinate; beside it the
    two-read design's 12 bytes and the 74-op formula at ``INT32_OPS``."""
    import numpy as np

    from repro_torch.core import compress, prng
    from repro_torch.kernels import int8_quant as kq
    from repro_torch.kernels import topk_compress as ktop

    m, p = 10, CNN_P4
    rate = hash_rate(torch, probe, dev)
    dense = gradient_rows(torch, dev, 5)
    sparse = ktop.select(dense, compress.topk_count(CNN_PARAMS, 0.01))
    dense[3, ::2] = 0.0
    keys = torch.as_tensor(prng.split(prng.PRNGKey(7), m).astype(np.int64),
                           device=dev)
    res = {}
    for link, x in (("internal", sparse), ("external", dense)):
        out_k = kq.quantize(x, keys)
        out_p = kq.quantize_plain(x, keys)
        torch.cuda.synchronize()
        if not torch.equal(out_k.view(torch.int32), out_p.view(torch.int32)):
            bad = (out_k != out_p).sum().item()
            fail(f"int8_quant ({link} link's rows): {bad} coordinates differ "
                 "from the plain version")
        del out_k, out_p
        call = lambda x=x: kq.quantize(x, keys)
        draws = int8_draws(torch, x)
        ms, g_ms = time_ms(call, reps=20), graph_ms(torch, call)
        b_ms, b_by = bound(8 * m * p, draws, rate)
        two_ms, two_by = bound(12 * m * p, draws, rate)
        f_ms, f_by = bound(8 * m * p, THREEFRY_INT_OPS * draws, INT32_OPS)
        res[link] = dict(ms=ms, graph_ms=g_ms, draws=draws, bound_ms=b_ms,
                         bound_by=b_by, two_read_bound_ms=two_ms,
                         formula_bound_ms=f_ms)
        print(f"int8_quant {link} link's rows (M={m} P4={p}, {draws} "
              f"coordinates need a draw, {100 * draws / (m * p):.2f}%): "
              f"bit-equal to the plain version; {ms:.4f} ms kernel, "
              f"{g_ms:.4f} per launch in a graph; bound {b_ms:.4f} ms "
              f"({b_by}: 8 B a coordinate, the draws at the measured "
              f"{rate:.4g} hashes/s; {100 * b_ms / ms:.1f}%, "
              f"{100 * b_ms / g_ms:.1f}% in a graph); two reads (12 B) "
              f"{two_ms:.4f} ms ({two_by}); formula {f_ms:.4f} ms ({f_by}, "
              f"{THREEFRY_INT_OPS} int32 ops a draw at "
              f"{INT32_OPS / 1e12:.1f} Tops/s); library: none", flush=True)
    plain_ms = time_ms(lambda: kq.quantize_plain(sparse, keys), reps=3,
                       warmup=1)
    del sparse, dense
    torch.cuda.empty_cache()
    head, ext = res["internal"], res["external"]
    return dict(name=kq.NAME, route="cuda", source=kq.SOURCE,
                replaces=kq.REPLACES, max_abs_err=0.0, tol=0.0,
                ms=head["ms"], plain_ms=plain_ms, bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], library_ms=None,
                graph_ms=head["graph_ms"], draws=head["draws"],
                two_read_bound_ms=head["two_read_bound_ms"],
                formula_bound_ms=head["formula_bound_ms"],
                **{f"external_{key}": v for key, v in ext.items()},
                hash_rate=rate,
                shape=f"M={m} P4={p}, the internal link's top-k rows (k at "
                      "1%); external_*: the external link's dense rows")


def corrupt_fills(code, modes) -> dict:
    """The fills ``check_corrupt_rows`` times, from the CLI's trace
    ``code`` over ``modes``: the trace itself (``typical``), its byte rows
    alone and its Gaussian rows alone (the other codes set to 0), every row
    ``scale`` and every row Gaussian."""
    import torch
    gauss = 1 + modes.index("gauss_noise")
    return {"typical": code, "bytes": torch.where(code == gauss, 0, code),
            "gauss": torch.where(code == gauss, code, 0),
            "all scale": torch.full_like(code, 1 + modes.index("scale")),
            "all gauss": torch.full_like(code, gauss)}


def check_corrupt_rows(torch, dev, probe):
    """The fault injection against its plain version: the sweep
    (``kernels.corrupt.SWEEP``), then the robust path's member stack
    (M·L, P4) = (100, 6,603,712) with the CLI's fault trace at an
    iteration that seats a Gaussian row (its typical fill), that trace's
    byte rows alone and Gaussian rows alone, every row ``scale`` and every
    row Gaussian (:func:`corrupt_fills`). NaN/Inf/scale/sign rows,
    untouched rows and pads must be bit-equal, Gaussian rows within
    2e-6·σ (``log1pf`` against ``torch.log1p``, and the plain erfinv's
    Horner steps rounded through double). Each fill timed eagerly, the
    typical one also per launch inside a CUDA graph (as the fused robust
    round pays it). A fill's bound prices its Gaussian coordinates' hashes
    at the card's threefry rate as ``csrc/probe/latency_probe.cu``
    measures it (faster than ``THREEFRY_INT_OPS`` at ``INT32_OPS``); the
    bound at that formula's rate is printed beside it (``formula_bound``).
    The all-Gaussian plain
    version runs in 25-row slices (its int64 threefry takes ~10 GB a row
    slice of 25)."""
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

    rate = hash_rate(torch, probe, dev)
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
    res = {}
    for fill, c in corrupt_fills(code, cfn.modes).items():
        out = cfn.apply(x.clone(), c, keys, sizes)
        ref = x.clone()
        step = 25 if fill == "all gauss" else m * l
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
        call = lambda: cfn.apply(buf, c, keys, sizes)
        ms = time_ms(call, reps=3 if fill == "all gauss" else 20)
        g_ms = graph_ms(torch, call) if fill == "typical" else None
        plain_ms = None
        if fill == "typical":
            plain_ms = time_ms(lambda: kc.corrupt_rows_plain(
                buf, c, keys, sizes, cfn.modes, cfn.config.scale,
                cfn.config.sigma), reps=3, warmup=1)
        elif fill == "all gauss":
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
        # read once; one threefry hash per Gaussian coordinate, at the
        # measured rate (the bound) and at 74 int32 operations each
        read = sum(v for mode, v in counts.items()
                   if mode not in ("nan_burst", "inf_spike"))
        moved, hashes = 4 * p * (sum(counts.values()) + read), \
            p * counts["gauss_noise"]
        b_ms, b_by = bound(moved, hashes, rate)
        f_ms, f_by = bound(moved, THREEFRY_INT_OPS * hashes, INT32_OPS)
        res[fill] = dict(ms=ms, graph_ms=g_ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, err=err,
                         counts=counts, formula_bound_ms=f_ms,
                         formula_bound_by=f_by)
        in_graph = f", {100 * b_ms / g_ms:.1f}% in a graph" if g_ms else ""
        print(f"corrupt_rows {fill} (t={t}, rows hit by mode {counts} of "
              f"{m * l}, P4={p4}): exact rows bit-equal, gauss max err "
              f"{err:.3g} sigma; {ms:.4f} ms kernel"
              f"{f', {g_ms:.4f} per launch in a graph' if g_ms else ''}"
              f"{f', {plain_ms:.4f} ms plain' if plain_ms else ''}"
              f"{' (25-row slices)' if fill == 'all gauss' else ''}, bound "
              f"{b_ms:.4f} ms ({b_by}, hashes at the measured rate; "
              f"{100 * b_ms / ms:.1f}%{in_graph}), "
              f"formula bound {f_ms:.4f} ms ({f_by}, {THREEFRY_INT_OPS} "
              f"int32 ops a hash at {INT32_OPS / 1e12:.1f} Tops/s; "
              f"{100 * f_ms / ms:.1f}%); library: none (no PyTorch call "
              "draws threefry normals)", flush=True)
    print(f"corrupt_rows: the card hashes {rate:.4g} threefry draws a "
          f"second ({rate * THREEFRY_INT_OPS / 1e12:.2f} T int32 ops/s at "
          f"{THREEFRY_INT_OPS} a draw; the bound's rate is "
          f"{INT32_OPS / 1e12:.2f} T)", flush=True)
    del x
    torch.cuda.empty_cache()
    typ, full = res["typical"], res["all gauss"]
    parts = {f"{fill.replace(' ', '_')}_{key}": row[key]
             for fill, row in res.items() if fill != "typical"
             for key in ("ms", "bound_ms", "bound_by", "formula_bound_ms")}
    return dict(name=kc.NAME, route="cuda", source=kc.SOURCE,
                replaces=kc.REPLACES,
                max_abs_err=max(worst, *(r["err"] for r in res.values())),
                tol=tol, ms=typ["ms"], plain_ms=typ["plain_ms"],
                bound_ms=typ["bound_ms"], bound_by=typ["bound_by"],
                formula_bound_ms=typ["formula_bound_ms"],
                library_ms=None, graph_ms=typ["graph_ms"],
                all_gauss_plain_ms=full["plain_ms"], hash_rate=rate,
                **parts,
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
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
                population: int | None = None, mesh=None):
    """The fused engine at the paper's traffic and full CNN width, through
    the library, with the CLI's fault schedule of mode(s) ``corrupt``, the
    sampler drifting under ``drift`` (a ``DriftConfig``) and the devices'
    availability under ``avail`` (an ``AvailabilityConfig``) if given; over
    a lazy population of ``population`` devices a factory (DESIGN.md §17;
    candidate committees of 35 redrawn at the config's cadence) instead of
    the dense partition if given; on ``mesh`` (the sharded engine's, this
    rank's groups) if given: (experiment, sampler)."""
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
        avail_fn=make_availability_fn(avail, 0), mesh=mesh,
        graph=graph), sampler


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
BASELINE_EXTRA = 1               # rounds replayed and run eagerly after
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
# strategies the card runs on both engines, held equal bit for bit: one of
# each family (the smoke set and the two with their own local step); the
# others run on the fused engine alone, whose round step the host loop
# shares (core/baselines.make_round_step; the CPU tests hold the two equal)
BASELINE_BOTH = BASELINE_SMOKE + ("fedprox", "cgau")
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
                      iters: int = 1, draws: int = 0, tables: int = 0,
                      host: bool = True) -> dict:
    """One strategy at full width through the CLI, on the host loop (unless
    ``host`` is false) and on the fused engine, each with its launch counts
    set to 0 before and read after and held to :func:`baseline_expect`
    (the fused capture to one round's :func:`baseline_round_launches`).
    The host loop runs each round eagerly, the fused engine as a CUDA
    graph: their final params and extras and their records must be equal
    bit for bit. Then the fused run's round function, its graph still
    held, runs ``BASELINE_EXTRA`` more rounds replayed and the same rounds
    eagerly from a copy of the same state: the whole states (server state
    included) and records bit for bit, and their times. Peak device memory
    of the host loop's run (eager) and of the fused run (warm-up and
    capture included). ``extra`` flags (a drift schedule, its clock
    ``iters`` internal iterations a round; ``draws``: its Dirichlet
    launches a round; a lazy population's, whose table adds ``tables``
    launches) go to both CLI runs."""
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

    for engine_name in ("host", "fused") if host else ("fused",):
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
    if host and (out["host"]["records"] != out["fused"]["records"] or not all(
            torch.equal(a, b) for a, b in zip(tree.leaves(runs["host"]),
                                              tree.leaves(runs["fused"]),
                                              strict=True))):
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
        for r in range(BASELINE_ROUNDS, BASELINE_ROUNDS + BASELINE_EXTRA):
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
    out.update(host_ms=1e3 * out["host"]["round_s"][-1] if host else None,
               replayed_ms=1e3 * secs[True][-1],
               eager_ms=1e3 * secs[False][-1])
    if name == BASELINE_PROFILED and not extra:
        rf.graph = True
        baseline_profile(torch, rf, name, out["replayed_ms"])
    hosted = (
        f"host loop round {out['host_ms']:.1f} ms (CLI rounds "
        f"{[round(1e3 * t, 1) for t in out['host']['round_s']]} ms, the "
        f"first with the CLI's set-up, the last with its eval; its params, "
        f"extras and records == the fused engine's bit for bit), "
        if host else "fused engine only (host loop: not run), ")
    print(f"{label}: {hosted}fused replayed {out['replayed_ms']:.1f} ms, eager "
          f"{out['eager_ms']:.1f} ms (fused CLI rounds "
          f"{[round(1e3 * t, 1) for t in out['fused']['round_s']]} ms; then "
          f"replays {[round(1e3 * t, 1) for t in secs[True]]}, eager "
          f"{[round(1e3 * t, 1) for t in secs[False]]} ms, no eval); peak "
          f"device memory " + (f"host loop {out['host']['peak_gb']:.2f} GB, "
                               if host else "") +
          f"fused {out['fused']['peak_gb']:.2f} GB; launches " +
          (f"host {out['host']['counts']}, " if host else "") +
          f"fused (warm-up + capture + eval) {out['fused']['counts']}; "
          "graph == eager bit for bit", flush=True)
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rf(rf.static[0], BASELINE_ROUNDS + BASELINE_EXTRA)
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
    """Every Table II strategy at full width (:func:`baseline_strategy`):
    on the fused engine, and those of ``BASELINE_BOTH`` also on the host
    loop, equal bit for bit; five of them card vs CPU on the smoke
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
        res = baseline_strategy(torch, dev, name,
                                host=name in BASELINE_BOTH)
        rows.append(res)
        for e in sums:
            for k, v in res.get(e, {"counts": {}})["counts"].items():
                sums[e][k] += v
    print("baselines table (ms per round at C=100, S=10, n=32, full CNN: "
          "host loop's last CLI round with its eval / fused replayed / "
          "fused eager, no eval; peak GB host loop / fused): " +
          "; ".join(f"{r['strategy']} " + (
              f"{r['host_ms']:.1f}" if "host" in r else "-") +
              f" / {r['replayed_ms']:.1f} / {r['eager_ms']:.1f}, " + (
              f"{r['host']['peak_gb']:.2f}" if "host" in r else "-") +
              f" / {r['fused']['peak_gb']:.2f} GB" for r in rows),
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
                 "topk_compress": "topk_hist0",
                 "int8_quant": "int8_quant_rows",
                 "flash_attention": "flash_fwd", "ssd_scan": "ssd_chunk_scan",
                 "ssd_scan_bwd": "ssd_bwd_dt",
                 "corrupt_rows": "corrupt_rows_kernel",
                 "dirichlet_rows": "dirichlet_rows_kernel",
                 "avail_rows": "avail_rows_kernel"}


# Traced runs of one CLI call at most: the profiler's kernel records may
# come up short of what executed (one CUDA graph segment's replay was once
# missing from a full-width trace, the host's counts exact), never over.
TRACE_ATTEMPTS = 3


def device_launches(torch, argv) -> tuple[dict, dict]:
    """The CLI run once under ``torch.profiler`` (the device's activity
    alone), every launch count set to 0 just before and read just after:
    (the wrappers' counts, each kernel's executions on the card as the
    trace names them; a kernel replayed in a CUDA graph counts once per
    replay)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import dispatch

    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_cli(argv)
        torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    execs = {name: sum(e.count for e in events if tag in e.key)
             for name, tag in DEVICE_KERNEL.items()}
    return counts, execs


def traced_executions(label, argv, calls, per_round, host_expect, rounds,
                      torch) -> tuple[dict, int]:
    """The fused (or sharded) CLI ``argv`` under ``torch.profiler``, its
    counts reset: each kernel's executions on the card, which must be the
    host loop's ``host_expect`` plus the warm-up round's ``per_round``
    (the traced run's own wrapper counts ``calls``, capture and replays
    held too; a shortfall of profiler records is traced again, at most
    ``TRACE_ATTEMPTS`` runs, an excess fails). Returns (the executions,
    the attempt that matched)."""
    from repro_torch.core import fedgs

    seen, make = [], fedgs.make_fedgs_experiment

    def spy(*args, **kw):      # keep the CLI's round function in view
        seen.append(make(*args, **kw))
        return seen[-1]

    expect = {k: v + per_round[k] for k, v in host_expect.items()}
    short = []
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        seen.clear()
        fedgs.make_fedgs_experiment = spy
        try:
            traced_calls, run = device_launches(torch, argv)
        finally:
            fedgs.make_fedgs_experiment = make
        rf_t = seen[0].round_fn
        if (traced_calls != calls or rf_t.captured != per_round
                or rf_t.replays != rounds
                or any(run[k] > expect[k] for k in run)):
            fail(f"{label}: traced run: wrapper counts {traced_calls} "
                 f"(expected {calls}), capture {rf_t.captured} for "
                 f"{rf_t.replays} replays, kernel executions on the card "
                 f"{run}, expected the host loop's {host_expect} plus one "
                 f"warm-up round {per_round}")
        if run == expect:
            return run, attempt
        # every launch and replay was counted on the host, so a kernel
        # that executed fewer times than that is a record the profiler lost
        short.append({k: expect[k] - run[k] for k in run if run[k] != expect[k]})
        print(f"{label}: traced run {attempt}: the profiler reported "
              f"{short[-1]} fewer kernel executions than the host counted "
              f"launches", flush=True)
        del rf_t
        seen.clear()
    fail(f"{label}: traced run: in {TRACE_ATTEMPTS} traced runs the "
         f"kernel executions on the card fell short of the host loop's "
         f"{host_expect} plus one warm-up round {per_round} by {short}")


def fused_path(label, flags, extra, host_expect, host_ms, torch, dev,
               corrupt: str | None = None):
    """``--engine fused`` at full width (R=2, T=3). The CLI driven with the
    counts set to 0 before and read after: the wrappers count where they
    launch, so a replay moves no counter and the counts hold the eager
    warm-up round, the capture and the eval launches (each round's
    launches twice, plus eval); the capture must count one round's
    launches. The same CLI again under ``torch.profiler``, its counts
    reset too: each kernel's executions on the card, which must be the
    host loop's launches plus the warm-up round's (the traced run's own
    wrapper counts, capture and replays held too; a shortfall of profiler
    records is traced again, at most ``TRACE_ATTEMPTS`` runs, an excess
    fails); these measured counts are the path's ``launches_by_path``.
    Then, through the library: graph against eager (states bit-equal,
    records equal), the kernel against its plain version on the path's
    GBP-CS instances, ms per internal iteration eager and replayed, one
    traced replay, and the share of an iteration spent on drawing labels
    and images on the card and on their threefry bits alone. With
    ``corrupt`` (the robust branch: the CLI's fault mode(s), ``extra`` its
    aggregator) the CLI run must seat a corrupted member, and the graph
    and eager runs print their peak device memory."""
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
    run, attempt = traced_executions(label, argv, calls, per_round,
                                     host_expect, rounds, torch)
    print(f"{label}: one round captured in {len(rf.segments.graphs)} graph "
          f"segments around {len(rf.segments.breaks)} eager pinv calls; "
          f"wrapper counts (warm-up round + capture + eval) {counts}; "
          f"kernel executions on the card, traced (run {attempt} of at most "
          f"{TRACE_ATTEMPTS}): {run} = the host loop's {host_expect} + the "
          f"warm-up round", flush=True)
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


# ---------------------------------------------------------------- sharded
# The group-sharded engine (--engine sharded, DESIGN.md §8): world 1 in this
# process, and two gloo ranks on the one card as child processes (NCCL
# refuses two ranks on one device), five groups each.
SHARDED_ROUNDS = 3
SHARDED_WORLD = 2
SHARDED_DIR = os.path.join(ROOT, "build", "chip_smoke_sharded")
SHARDED_TIMEOUT = 300          # seconds the two ranks may take


def sharded_rounds(torch, dev, mesh, rounds: int) -> tuple[dict, list]:
    """The fused engine at full width on ``mesh`` (None: unsharded), one
    CUDA graph per round (after the eager warm-up and the capture of round
    0), ``rounds`` rounds of T = 3 one by one, synchronised, every
    ``torch.distributed.all_reduce`` timed on the host clock with the
    device synchronised at both ends: (summary, global params' leaves on
    the host). The summary holds the records' metrics, seconds per round,
    the collectives' ms and count per round, the graph's segments and
    breaks, the capture's counts and the wrappers' (warm-up + capture)."""
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.core import dispatch

    from repro_torch.launch.hlo_analysis import CollectiveTrace

    times, ops = [], []
    all_reduce = dist.all_reduce
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def timed(tensor, *args, **kw):
        # an eager break between graph segments, never inside a capture:
        # the trace is on around the collective alone
        sync()
        t0 = time.perf_counter()
        with CollectiveTrace() as trace:
            out = all_reduce(tensor, *args, **kw)
        sync()
        times.append(time.perf_counter() - t0)
        ops.extend([op["reduce"], op["bytes"]] for op in trace.ops)
        return out

    dist.all_reduce = timed
    try:
        dispatch.reset_launch_counts()
        exp, _ = fused_setup(torch, dev, {}, rounds, dev.type == "cuda",
                             mesh=mesh)
        state, secs, mets, coll_ms, coll_n = exp.init_state, [], [], [], []
        coll_ops = []
        for r in range(rounds):
            n0, k0 = len(times), len(ops)
            sync()
            t0 = time.perf_counter()
            state, m = exp.round_fn(state, r)
            sync()
            secs.append(time.perf_counter() - t0)
            coll_ms.append(1e3 * sum(times[n0:]))
            coll_n.append(len(times) - n0)
            coll_ops.append(ops[k0:])
            mets.append({k: float(v) for k, v in m.items()})
        counts = dispatch.launch_counts()
    finally:
        dist.all_reduce = all_reduce
    segs = exp.round_fn.segments          # None in an eager run
    params = [leaf.cpu().numpy() for leaf in tree.leaves(exp.params_fn(state))]
    return dict(records=mets, secs=secs, coll_ms=coll_ms, coll_n=coll_n,
                coll_ops=coll_ops, segments=len(segs.graphs) if segs else 0,
                breaks=len(segs.breaks) if segs else 0,
                captured=exp.round_fn.captured, counts=counts), params


def sharded_rank(rank: int, world: int, out: str, device: str) -> None:
    """One rank of the two-rank run (a child process): gloo over a file
    store in ``out``, the sharded engine on this rank's five groups
    (:func:`sharded_rounds`) on ``device``; its summary and params go to
    ``out``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(out, 'store')}",
            rank=rank, world_size=world)
        from repro_torch.core import fedgs
        mesh = fedgs.make_group_mesh(10)
        summary, params = sharded_rounds(torch, torch.device(device), mesh,
                                         SHARDED_ROUNDS)
        summary["mesh"] = [mesh.size, mesh.rank, mesh.world]
        summary["backend"] = dist.get_backend()
        dist.destroy_process_group()
        np.savez(os.path.join(out, f"params_{rank}.npz"), *params)
        with open(os.path.join(out, f"rank_{rank}.json"), "w") as f:
            json.dump(summary, f)
    except BaseException:
        import traceback
        with open(os.path.join(out, f"error_{rank}"), "w") as f:
            f.write(traceback.format_exc())
        raise


def sharded_two_ranks(device: str = "cuda") -> list[tuple[dict, list]]:
    """:func:`sharded_rank` on ``SHARDED_WORLD`` child processes (spawned,
    so each makes its own CUDA context on the one card), joined with a
    time limit and killed past it: each rank's (summary, params)."""
    import multiprocessing

    import numpy as np
    if os.path.isdir(SHARDED_DIR):
        for name in os.listdir(SHARDED_DIR):
            os.remove(os.path.join(SHARDED_DIR, name))
    os.makedirs(SHARDED_DIR, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=sharded_rank,
                         args=(rank, SHARDED_WORLD, SHARDED_DIR, device))
             for rank in range(SHARDED_WORLD)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + SHARDED_TIMEOUT
    for p in procs:
        p.join(max(1.0, deadline - time.perf_counter()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [open(os.path.join(SHARDED_DIR, n)).read()
              for n in sorted(os.listdir(SHARDED_DIR))
              if n.startswith("error")]
    if errors or any(p.exitcode for p in procs):
        fail(f"sharded path: two ranks: exit codes "
             f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))
    out = []
    for rank in range(SHARDED_WORLD):
        with open(os.path.join(SHARDED_DIR, f"rank_{rank}.json")) as f:
            summary = json.load(f)
        z = np.load(os.path.join(SHARDED_DIR, f"params_{rank}.npz"))
        out.append((summary, [z[f"arr_{i}"] for i in range(len(z.files))]))
    return out


def check_sharded_collectives(rank: int, coll_ops: list, iters: int
                              ) -> None:
    """A rank's traced all_reduces per round against the formula: per
    round one SUM of Eq. 5's flat buffer (``CNN_P4`` floats) and one SUM
    of the packed metrics (T floats per metric); no MAX (the re-trigger's,
    which only a GBP-CS cadence issues); round 0 also the eager warm-up
    round's pair."""
    for r, ops in enumerate(coll_ops):
        pairs = 2 if r == 0 else 1
        eq5 = [b for op, b in ops if op == "sum" and b == 4 * CNN_P4]
        packed = [b for op, b in ops if op == "sum" and b != 4 * CNN_P4]
        if len(ops) != 2 * pairs or len(eq5) != pairs or \
                len(packed) != pairs or len(set(packed)) != 1 or \
                packed[0] % (4 * iters) or any(op != "sum" for op, _ in ops):
            fail(f"sharded path: rank {rank} round {r}: traced all_reduces "
                 f"{ops}; want {pairs} x (SUM of {4 * CNN_P4} bytes, SUM "
                 f"of the packed metrics), no MAX")


def sharded_phase(torch, dev, host_expect) -> dict:
    """The group-sharded engine (DESIGN.md §8) at the paper's traffic and
    full width: the CLI with ``--engine sharded`` at world 1 (no process
    group) against ``--engine fused`` (R=2, T=3): records bit for bit and
    the same wrapper counts, then traced: each kernel's executions on the
    card the host loop's ``host_expect`` plus the warm-up round's; two
    gloo ranks on the one card (five groups each, graphed, R=3) against
    world 1 through the library: rank 0's records within 1e-4 and params
    within 1e-5, rank 1's equal to rank 0's, every rank's capture one
    round of ``gbp_cs``, ``conv_fused`` and ``agg_weighted`` launches
    over its five groups, T + 2 graph breaks (T ``pinv`` calls, the
    metrics' SUM, the Eq. 5 average); ms per internal iteration replayed
    and the collectives' ms per round on each rank; the smoke
    configuration card vs CPU under ``--engine sharded``. Returns
    {path: launches}: the traced executions of the CLI and each rank's
    wrapper counts."""
    import numpy as np
    t0 = time.perf_counter()
    rounds, iters, every = 2, 3, 2
    base = main_flags(rounds, iters, every)
    evals = {"conv_fused": 2 * (rounds // every)}
    per_round = {k: (v - evals.get(k, 0)) // rounds
                 for k, v in host_expect.items()}
    calls = {k: 2 * v + evals.get(k, 0) for k, v in per_round.items()}
    fused_logs, _, _ = drive("sharded path: --engine fused",
                             base + ["--engine", "fused"], calls, torch)
    logs, counts, cli_ms = drive("sharded path: --engine sharded",
                                 base + ["--engine", "sharded"], calls, torch)
    if logs != fused_logs:
        fail(f"sharded path: world 1 records differ from --engine fused's:"
             f"\n{logs}\n{fused_logs}")
    run, attempt = traced_executions("sharded path",
                                     base + ["--engine", "sharded"], calls,
                                     per_round, host_expect, rounds, torch)
    print(f"sharded path: world 1 == --engine fused bit for bit (records), "
          f"wrapper counts {counts}; kernel executions on the card, traced "
          f"(run {attempt}): {run}; the CLI's last round with eval "
          f"{cli_ms:.1f} ms per internal iteration", flush=True)

    one, one_params = sharded_rounds(torch, dev, None, SHARDED_ROUNDS)
    gc.collect()
    torch.cuda.empty_cache()
    ranks = sharded_two_ranks(dev.type)
    rec_worst = par_worst = 0.0
    for rank, (summary, params) in enumerate(ranks):
        if summary["mesh"] != [SHARDED_WORLD, rank, SHARDED_WORLD]:
            fail(f"sharded path: rank {rank}'s mesh {summary['mesh']}")
        # a rank launches each kernel as often as one rank of all groups
        if summary["captured"] != per_round or \
                summary["counts"] != {k: 2 * v for k, v in per_round.items()}:
            fail(f"sharded path: rank {rank} captured {summary['captured']}"
                 f" (wrappers {summary['counts']}), one round over its "
                 f"groups being {per_round}")
        # round 0 also runs the eager warm-up round before the capture
        if summary["breaks"] != iters + 2 or \
                summary["coll_n"] != [4] + [2] * (SHARDED_ROUNDS - 1):
            fail(f"sharded path: rank {rank}: {summary['breaks']} graph "
                 f"breaks, collectives per round {summary['coll_n']}")
        check_sharded_collectives(rank, summary["coll_ops"], iters)
        for a, b in zip(one["records"], summary["records"], strict=True):
            for k, v in a.items():
                rec_worst = max(rec_worst, abs(b[k] - v) / max(1.0, abs(v)))
        for a, b in zip(one_params, params, strict=True):
            par_worst = max(par_worst, float(np.abs(a - b).max()))
    if rec_worst > 1e-4 or par_worst > 1e-5:
        fail(f"sharded path: two ranks against world 1: records {rec_worst}"
             f", params {par_worst}")
    r0, r1 = ranks[0][0], ranks[1][0]
    if r0["records"] != r1["records"] or not all(
            np.array_equal(a, b) for a, b in zip(ranks[0][1], ranks[1][1])):
        fail("sharded path: the two ranks' records or params differ")
    ms = lambda sm: [round(1e3 * t / iters, 2) for t in sm["secs"]]
    print(f"sharded path: two gloo ranks on one card ({r0['backend']}, "
          f"5 groups each, {SHARDED_ROUNDS} rounds x {iters} iterations, "
          f"one graph a round in {r0['segments']} segments around "
          f"{r0['breaks']} breaks): records within {rec_worst:.3g} and "
          f"params within {par_worst:.3g} of world 1, the ranks equal; ms "
          f"per internal iteration by round (round 0 warm-up + capture): "
          f"world 1 {ms(one)}, rank 0 {ms(r0)}, rank 1 {ms(r1)}; "
          f"collectives ms per round (2 all_reduce a round: metrics, the "
          f"Eq. 5 average of 26.4 MB; round 0 also the warm-up's 2): rank 0 "
          f"{[round(t, 2) for t in r0['coll_ms']]}, rank 1 "
          f"{[round(t, 2) for t in r1['coll_ms']]}; wrapper counts rank 0 "
          f"{r0['counts']}, rank 1 {r1['counts']}", flush=True)
    if any(one["coll_ops"]):
        fail(f"sharded path: world 1 issued collectives {one['coll_ops']}")
    metrics = r0["coll_ops"][1][0][1]
    print(f"sharded path: all_reduce a round on each rank, traced by "
          f"hlo_analysis.CollectiveTrace around the eager breaks: 2 SUMs, "
          f"Eq. 5's P4 x 4 = {4 * CNN_P4:,} bytes and the packed metrics' "
          f"{metrics} bytes ({metrics // (4 * iters)} metrics x T = "
          f"{iters} floats), no MAX (no re-trigger without a cadence); "
          f"round 0 twice that (the warm-up round's and the capture's)",
          flush=True)
    smoke_card_vs_cpu("sharded path", ["--engine", "sharded"])
    print(f"sharded phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"sharded": run, "sharded_rank0": r0["counts"],
            "sharded_rank1": r1["counts"]}


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


def dirichlet_work(trace, alpha, f: int) -> dict:
    """The work of one ``dirichlet_rows`` draw, from its plain version's
    loops (``prng.dirichlet_t``'s stats over the drawn rows of ``trace``):
    elements, outer passes, inner normal draws, the worst element's passes
    (``max_passes``) and hashes, 4 an element (its key, ``split``, the
    exponential), 4 an outer pass, 3 an inner draw."""
    from repro_torch.core import prng
    stats = {}
    prng.dirichlet_t(trace[:, 2:], alpha, f, stats)
    stats["hashes"] = 4 * stats["elements"] + 4 * stats["passes"] \
        + 3 * stats["draws"]
    return stats


def dirichlet_floor(work: dict, node: float, lat: dict) -> float:
    """The latency floor of one ``dirichlet_rows`` launch in a CUDA graph:
    an empty node plus :func:`dirichlet_chain` at the worst element's
    passes, priced at the latencies of ``csrc/probe/latency_probe.cu``."""
    return node + chain_ms(dirichlet_chain(work["max_passes"]), lat)


def check_dirichlet_rows(torch, dev, probe):
    """The Dirichlet redraw against its plain version at the drift's
    shape, the paper's 350 devices of 62 classes: a ``redraw`` trace of
    epoch 1 (every row drawn) and a ``churn`` one (a quarter drawn, the
    rest kept), α = 0.3. Kept rows bit-equal, drawn rows to 1e-6. Each
    timed eagerly and per launch inside a CUDA graph. The bound counts
    this draw's work (:func:`dirichlet_work`): ~74 integer operations
    (``THREEFRY_INT_OPS``) per threefry hash; beside it the latency floor
    (:func:`dirichlet_floor`)."""
    import numpy as np

    from repro_torch.data import (DriftConfig, PartitionConfig,
                                  make_drift_fn, make_partition)
    from repro_torch.kernels import dirichlet as kd

    part = make_partition(PartitionConfig(num_factories=10,
                                          devices_per_factory=35, seed=0))
    r, f = 350, 62
    base = torch.as_tensor(part.class_probs.reshape(r, f), device=dev)
    ids = np.arange(r)
    node, lat = node_ms(torch, probe, dev), chain_latencies(torch, probe, dev)
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
        work = dirichlet_work(trace[drawn], fn.config.alpha, f)
        call = lambda: kd.drift_rows(base, trace, fn.config.alpha)
        ms, g_ms = time_ms(call, reps=50), graph_ms(torch, call)
        plain_ms = time_ms(lambda: kd.drift_rows_plain(
            base, trace, fn.config.alpha), reps=3, warmup=1)
        b_ms, b_by = bound(8 * r * f + 32 * r,
                           THREEFRY_INT_OPS * work["hashes"], INT32_OPS)
        floor = dirichlet_floor(work, node, lat)
        res[sched] = dict(err=err, ms=ms, graph_ms=g_ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, floor_ms=floor,
                          drawn=int(drawn.sum()),
                          max_passes=work["max_passes"])
        print(f"dirichlet_rows {sched} (R={r}, F={f}, alpha "
              f"{fn.config.alpha}, {int(drawn.sum())} rows drawn: "
              f"{work['elements']} elements, {work['passes']} outer "
              f"passes, at most {work['max_passes']} an element, "
              f"{work['draws']} normal draws): kept rows bit-equal, drawn "
              f"max err {err:.3g} (tol {tol}), {exact} drawn rows "
              f"bit-equal; {ms:.4f} ms kernel eager, {g_ms:.5f} per launch "
              f"in a graph (empty node {node:.5f}), {plain_ms:.4f} ms "
              f"plain; bound {b_ms:.5f} ms ({b_by}), latency floor "
              f"{floor:.5f} ms ({100 * max(b_ms, floor) / g_ms:.1f}% of "
              f"the larger in a graph; mix round {lat['mix']:.2f}, normal "
              f"{lat['normal']:.1f}, logf {lat['logf']:.1f}, expf "
              f"{lat['expf']:.1f} cycles at {lat['ghz']:.3f} GHz); "
              "library: none (no PyTorch call draws JAX's threefry gamma)",
              flush=True)
    red, churn = res["redraw"], res["churn"]
    return dict(name=kd.NAME, route="cuda", source=kd.SOURCE,
                replaces=kd.REPLACES, max_abs_err=max(v["err"] for v in
                                                      res.values()),
                tol=tol, ms=red["ms"], plain_ms=red["plain_ms"],
                bound_ms=red["bound_ms"], bound_by=red["bound_by"],
                library_ms=None, graph_ms=red["graph_ms"],
                floor_ms=red["floor_ms"], node_ms=node,
                max_passes=red["max_passes"], latencies=lat,
                churn_ms=churn["ms"], churn_graph_ms=churn["graph_ms"],
                churn_plain_ms=churn["plain_ms"],
                churn_floor_ms=churn["floor_ms"],
                shape=f"R={r} F={f}, redraw all rows / churn "
                      f"{churn['drawn']} rows drawn")


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


def avail_floor(torch, probe, dev) -> float:
    """The latency floor of one ``avail_rows`` launch in a CUDA graph: an
    empty node plus three dependent hashes (the latency draw's fold_in(k,
    id), fold_in(·, t) and its bits; the state's K, its key and its bits),
    each priced as its 20 mix rounds at ``csrc/probe/latency_probe.cu``'s
    latency, the key injections left out."""
    return node_ms(torch, probe, dev) + chain_ms(
        {"mix": 3 * 20}, chain_latencies(torch, probe, dev))


def check_avail_rows(torch, dev, probe):
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
    included), and the plain version's on the card. The bound is the
    larger of the draw's hashes (``kernels.avail.hashes``) at the card's
    threefry rate (``hash_rate``; 16 bytes per id never bind) and the
    latency floor (:func:`avail_floor`); the formula's bound (~74 integer
    operations a hash at ``INT32_OPS``) is printed beside it."""
    from repro_torch.data import AvailabilityConfig, make_availability_fn
    from repro_torch.kernels import avail as ka

    rate, floor = hash_rate(torch, probe, dev), avail_floor(torch, probe, dev)
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
            work = ka.hashes(kind, r, t % fn.config.horizon)
            ops_ms, b_by = bound(16 * r + 8, work, rate)
            if floor > ops_ms:
                b_by = "latency"
            f_ms, _ = bound(16 * r + 8, THREEFRY_INT_OPS * work, INT32_OPS)
            res[(kind, t)] = dict(ms=ms, eager_ms=eager,
                                  plain_ms=times[("dense", t)],
                                  bound_ms=max(ops_ms, floor), bound_by=b_by,
                                  ops_ms=ops_ms, floor_ms=floor,
                                  formula_bound_ms=f_ms,
                                  share=100 * max(ops_ms, floor) / ms)
        up = float(fn(torch.full((), 5, dtype=torch.int64, device=dev),
                      ids)[0].mean())
        print(f"avail_rows {kind} (R={r}, dense and shuffled ids, t = 0, 5, "
              f"4095): kernel == plain bit for bit; up at t=5 {up:.3f}; "
              + "; ".join(f"t={t}: {res[(kind, t)]['ms']:.4f} ms kernel "
                          "per launch in a graph, "
                          f"{res[(kind, t)]['eager_ms']:.4f} eager, "
                          f"{res[(kind, t)]['plain_ms']:.3f} ms plain, bound "
                          f"{res[(kind, t)]['bound_ms']:.5f} ms "
                          f"({res[(kind, t)]['bound_by']}; hashes at the "
                          f"measured rate {res[(kind, t)]['ops_ms']:.5f}, "
                          f"latency floor {floor:.5f}; "
                          f"{res[(kind, t)]['share']:.1f}% in a graph), "
                          "formula bound "
                          f"{res[(kind, t)]['formula_bound_ms']:.5f}"
                          for t in (5, 4095))
              + "; library: none (no PyTorch call draws JAX's threefry "
              "bernoulli)", flush=True)
    worst = res[("markov", 4095)]
    return dict(name=ka.NAME, route="cuda", source=ka.SOURCE,
                replaces=ka.REPLACES, max_abs_err=0.0, tol=0.0,
                ms=worst["ms"], eager_ms=worst["eager_ms"],
                plain_ms=worst["plain_ms"], bound_ms=worst["bound_ms"],
                bound_by=worst["bound_by"], library_ms=None,
                formula_bound_ms=worst["formula_bound_ms"], floor_ms=floor,
                hash_rate=rate,
                ms_t5={k: v["ms"] for (k, t), v in res.items() if t == 5},
                ms_t4095={k: v["ms"] for (k, t), v in res.items()
                          if t == 4095},
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


def avail_phase(torch, dev, probe) -> tuple[dict, dict]:
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
    entry = check_avail_rows(torch, dev, probe)
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


def check_population_rows(torch, dev, probe) -> dict:
    """``dirichlet_rows`` with one concentration per element, against its
    plain version on the card, bit for bit: the 350 devices seated at t =
    0 by the full-width CLI at D = 10⁶ (the committee of 35 from each
    factory's 100,000), around their factories' rows of the concentration
    table; the M = 10 factory priors at α = 1 (the table's build). Each
    timed per launch inside a CUDA graph (as the fused round pays it) and
    eagerly (CUDA events, the host wrapper included), and the plain
    version on the card. The bound counts the draw's hashes from the plain
    version's loop passes, and the latency floor its worst element's, as
    :func:`check_dirichlet_rows` does."""
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
    node, lat = node_ms(torch, probe, dev), chain_latencies(torch, probe, dev)
    res = {}
    for name, (trace, alpha) in cases.items():
        r, f = alpha.shape
        out = kd.draw_rows(trace, alpha)
        ref = kd.drift_rows_plain(None, trace, alpha)
        if not torch.equal(out, ref):
            fail(f"dirichlet_rows {name}: the kernel differs from its plain "
                 f"version by {float((out - ref).abs().max())}")
        work = dirichlet_work(trace, alpha, f)
        call = lambda: kd.draw_rows(trace, alpha)
        ms, eager = graph_ms(torch, call), time_ms(call, reps=50)
        plain_ms = time_ms(lambda: kd.drift_rows_plain(None, trace, alpha),
                           reps=3, warmup=1)
        b_ms, b_by = bound(8 * r * f + 32 * r,
                           THREEFRY_INT_OPS * work["hashes"], INT32_OPS)
        floor = dirichlet_floor(work, node, lat)
        res[name] = dict(ms=ms, eager_ms=eager, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, floor_ms=floor,
                         max_passes=work["max_passes"], rows=r)
        print(f"dirichlet_rows {name} (R={r}, F={f}, one concentration per "
              f"element, {work['elements']} elements, {work['passes']} "
              f"outer passes, at most {work['max_passes']} an element, "
              f"{work['draws']} normal draws): kernel == plain bit for bit; "
              f"{ms:.5f} ms per launch in a graph, {eager:.4f} eager, "
              f"{plain_ms:.4f} ms plain, bound {b_ms:.5f} ms ({b_by}), "
              f"latency floor {floor:.5f} ms "
              f"({100 * max(b_ms, floor) / ms:.1f}% of the larger); "
              "library: none", flush=True)
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


def population_phase(torch, dev, probe) -> tuple[dict, dict]:
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
    rows = check_population_rows(torch, dev, probe)
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



# the tools phase: the Fig. 4 samplers, host-batched evaluation,
# checkpointing and the three example scripts (paper §VII.A, §VI)
FIG4 = dict(m=10, k=33, l_sel=8, n=32)    # paper §VII.A: L_rnd = 2
FIG4_KW = {"random": {}, "mc": {"trials": 1000},
           "brute": {"limit": 100_000}, "bayesian": {"n_init": 5,
                                                     "n_iter": 25},
           "ga": {"population": 100, "generations": 100}, "gbp_cs": {}}
TOOLS_DIR = os.path.join(ROOT, "build", "chip_smoke_tools")
EVAL_PER_CLASS, EVAL_BATCH = 20, 512        # 1,240 test images
# runs an example script as __main__ in a child process, then prints that
# process's kernel launch counts
EXAMPLE_RUNNER = (
    "import json, runpy, sys\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_path(sys.argv[0], run_name='__main__')\n"
    "from repro_torch.core import dispatch\n"
    "print('launch counts: ' + json.dumps(dispatch.launch_counts()))\n")


def fig4_instances(m: int, k: int, l_sel: int, n: int, seed: int = 0):
    """Fig. 4's selection instances, built as the JAX package's
    ``benchmarks/bench_samplers.py`` builds them: per factory K candidates'
    multinomial class counts, the target n(L_sel + 2)·P_real less a random
    pre-sample of 2. Returns [(A (F, K), y, L_sel, n·L)]."""
    import numpy as np
    from repro_torch.data import PartitionConfig, make_partition
    part = make_partition(PartitionConfig(num_factories=m,
                                          devices_per_factory=k + 2,
                                          seed=seed))
    rng = np.random.default_rng(seed)
    out = []
    for mi in range(m):
        probs = part.class_probs[mi].astype(np.float64)
        probs /= probs.sum(axis=-1, keepdims=True)
        counts = np.stack([rng.multinomial(n, probs[i])
                           for i in range(k)]).astype(np.float32)
        y = (n * (l_sel + 2) * part.p_real).astype(np.float32)
        pre = counts[rng.choice(k, 2, replace=False)].sum(0)
        out.append((counts.T, y - pre, l_sel, n * (l_sel + 2)))
    return out


def expect_only(**counts) -> dict:
    """Every kernel's launch count 0 but those given."""
    from repro_torch.core import dispatch
    return {name: counts.get(name, 0) for name in dispatch.KERNELS}


def host_ms(torch, fn, reps: int) -> float:
    """Median host-clock ms of ``fn()``, the device synchronised at both
    ends of each call."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[len(times) // 2]


def sampler_phase(torch, dev) -> tuple[dict, dict]:
    """Fig. 4 on the card: the six samplers over the 10 paper-size
    instances (brute capped at 100,000 of C(33, 8) ≈ 13.9 M combinations),
    each sampler's mean wall ms, divergence / (n·L) and evaluations; GBP-CS
    card vs CPU (masks and iterations equal, distance to 1e-5 relative);
    the counted run holds one ``gbp_cs`` launch per sampler call and one
    for ``gbp_cs_minimize_batched`` over all 10; then GBP-CS warm per call
    and batched, and the ``pinv``'s share of each (host clock,
    synchronised). Returns (counts, numbers)."""
    import numpy as np
    from repro_torch.core import dispatch, gbp_cs, samplers
    insts = fig4_instances(**FIG4)
    A0, y0, l0, _ = insts[0]
    samplers.gbp_cs_sampler(A0, y0, l0, device=dev)     # may build: not timed
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    stats = {}
    for name, kw in FIG4_KW.items():
        extra = {"device": dev} if name == "gbp_cs" else {}
        res = [(samplers.SAMPLERS[name](A, y, l, **kw, **extra), nl)
               for A, y, l, nl in insts]
        stats[name] = (1e3 * float(np.mean([r.wall_time_s for r, _ in res])),
                       float(np.mean([r.distance / nl for r, nl in res])),
                       float(np.mean([r.evaluations for r, _ in res])),
                       [r for r, _ in res])
    A = torch.as_tensor(np.stack([i[0] for i in insts]), device=dev)
    y = torch.as_tensor(np.stack([i[1] for i in insts]), device=dev)
    batched = gbp_cs.gbp_cs_minimize_batched(A, y, FIG4["l_sel"])
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    want = expect_only(gbp_cs=len(insts) + 1)
    if counts != want:
        fail(f"samplers: launch counts {counts} != {want}")
    for (Ai, yi, li, _), card in zip(insts, stats["gbp_cs"][3]):
        ref = samplers.gbp_cs_sampler(Ai, yi, li, device="cpu")
        if not (np.array_equal(card.x, ref.x)
                and card.evaluations == ref.evaluations
                and abs(card.distance - ref.distance)
                <= 1e-5 * max(1.0, abs(ref.distance))):
            fail(f"samplers: gbp_cs_sampler on the card ({card.distance}, "
                 f"{card.evaluations} evaluations) != the CPU's "
                 f"({ref.distance}, {ref.evaluations})")
    ref_b = gbp_cs.gbp_cs_minimize_batched(A.cpu(), y.cpu(), FIG4["l_sel"])
    if not (torch.equal(batched.x.cpu(), ref_b.x)
            and torch.equal(batched.iterations.cpu(), ref_b.iterations)):
        fail("samplers: gbp_cs_minimize_batched on the card != the CPU's")
    call_ms = host_ms(torch, lambda: samplers.gbp_cs_sampler(
        A0, y0, l0, device=dev), 20)
    batch_ms = host_ms(torch, lambda: gbp_cs.gbp_cs_minimize_batched(
        A, y, FIG4["l_sel"]), 20)
    pinv1_ms = host_ms(torch, lambda: gbp_cs.pinv(A[:1]), 20)
    pinvb_ms = host_ms(torch, lambda: gbp_cs.pinv(A), 20)
    print("samplers (Fig. 4: M=10 instances, F=62, K=33, L_sel=8, n=32, "
          "L_rnd=2; brute capped at 100,000 combinations of C(33, 8); mean "
          "wall ms, divergence / (n·L), evaluations): " + "; ".join(
              f"{name} {ms:.3f} ms, {div:.4f}, {ev:.0f}"
              for name, (ms, div, ev, _) in stats.items()), flush=True)
    print(f"samplers: gbp_cs_sampler card == CPU on all {len(insts)} "
          f"instances (masks, iterations; distance to 1e-5); launches "
          f"{counts['gbp_cs']} (one a call, one batched); GBP-CS warm "
          f"{call_ms:.4f} ms a call (median of 20, host clock, synchronised; "
          f"pinv {pinv1_ms:.4f} ms, {100 * pinv1_ms / call_ms:.1f}%), "
          f"batched over {len(insts)} {batch_ms:.4f} ms (pinv "
          f"{pinvb_ms:.4f} ms, {100 * pinvb_ms / batch_ms:.1f}%)",
          flush=True)
    return counts, dict(
        fig4={name: dict(ms=ms, divergence=div, evaluations=ev)
              for name, (ms, div, ev, _) in stats.items()},
        call_ms=call_ms, batched_ms=batch_ms, pinv_call_ms=pinv1_ms,
        pinv_batched_ms=pinvb_ms)


def evaluate_phase(torch, dev) -> tuple[dict, float]:
    """``cnn.evaluate`` at full width over 1,240 test images in batches of
    512: 2 ``conv_fused`` launches a batch (6), loss and accuracy within
    1e-5 of the CPU's, of ``make_eval_fn`` in one pass and at batch=310;
    the card's ms (median of 5, host clock, synchronised). Returns
    (counts, ms)."""
    from repro_torch import tree
    from repro_torch.configs import femnist_cnn
    from repro_torch.core import dispatch, prng
    from repro_torch.data import femnist
    from repro_torch.models import cnn
    params = cnn.init_cnn(prng.PRNGKey(0), femnist_cnn.CONFIG, dev)
    tx, ty = femnist.make_test_set(n_per_class=EVAL_PER_CLASS)
    n = tx.shape[0]
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    card = cnn.evaluate(params, tx, ty, batch=EVAL_BATCH)
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    want = expect_only(conv_fused=2 * -(-n // EVAL_BATCH))
    if counts != want:
        fail(f"evaluate: launch counts {counts} != {want}")
    others = {
        "CPU": cnn.evaluate(tree.map(lambda v: v.cpu(), params), tx, ty,
                            batch=EVAL_BATCH),
        "make_eval_fn": tuple(float(v) for v in cnn.make_eval_fn(
            tx, ty, dev)(params)),
        "make_eval_fn batch=310": tuple(float(v) for v in cnn.make_eval_fn(
            tx, ty, dev, batch=310)(params))}
    for label, (loss, acc) in others.items():
        if abs(loss - card[0]) > 1e-5 or abs(acc - card[1]) > 1e-5:
            fail(f"evaluate: the card's (loss, acc) {card} against "
                 f"{label}'s {(loss, acc)}")
    ms = host_ms(torch, lambda: cnn.evaluate(params, tx, ty,
                                             batch=EVAL_BATCH), 5)
    one_ms = host_ms(torch, lambda: cnn.make_eval_fn(tx, ty, dev)(params), 5)
    print(f"evaluate: full width, {n} images in batches of {EVAL_BATCH}: "
          f"loss {card[0]:.6f}, acc {card[1]:.6f}, within 1e-5 of the CPU, "
          f"make_eval_fn and make_eval_fn(batch=310); conv_fused launches "
          f"{counts['conv_fused']}; {ms:.3f} ms (make_eval_fn with its "
          f"copy, one pass: {one_ms:.3f} ms; medians of 5)", flush=True)
    return counts, ms


def checkpoint_phase(torch, dev) -> dict:
    """The full-width CLI (R = 1, T = 3, eval after the round) with
    ``--ckpt-dir`` on the card, its counts held as on the main path; the
    checkpoint restored onto the card and onto the CPU holds the bytes of
    the params the CLI saved, and ``cnn.evaluate`` of the restored params
    equals that of the saved ones bit for bit. Returns the CLI's counts."""
    import shutil
    from repro_torch import checkpoint, tree
    from repro_torch.configs import femnist_cnn
    from repro_torch.core import prng
    from repro_torch.data import femnist
    from repro_torch.models import cnn
    ck_dir = os.path.join(TOOLS_DIR, "ckpt")
    shutil.rmtree(ck_dir, ignore_errors=True)
    saved, save = {}, checkpoint.save

    def capture(path, params, **kw):
        saved["params"] = params
        return save(path, params, **kw)

    checkpoint.save = capture
    try:
        _, counts, _ = drive(
            "checkpoint CLI", main_flags(1, 3, 1) + ["--ckpt-dir", ck_dir],
            fedgs_expect(1, 3, 1, 1, 0, False), torch)
    finally:
        checkpoint.save = save
    path = checkpoint.latest_step(ck_dir)
    if path is None or not path.endswith("step_1"):
        fail(f"checkpoint: no step_1 under {ck_dir}: {path}")
    like = cnn.init_cnn(prng.PRNGKey(1), femnist_cnn.CONFIG, dev)
    on_card = checkpoint.restore(path, like)
    on_cpu = checkpoint.restore(path, tree.map(lambda v: v.cpu(), like))
    for a, b, c in zip(tree.leaves(saved["params"]), tree.leaves(on_card),
                       tree.leaves(on_cpu), strict=True):
        if not (b.device == a.device and c.device.type == "cpu"
                and torch.equal(a, b) and torch.equal(a.cpu(), c)):
            fail("checkpoint: a restored leaf differs from the saved one")
    tx, ty = femnist.make_test_set(n_per_class=EVAL_PER_CLASS)
    ev_saved = cnn.evaluate(saved["params"], tx, ty)
    ev_restored = cnn.evaluate(on_card, tx, ty)
    if ev_saved != ev_restored:
        fail(f"checkpoint: evaluate of the restored params {ev_restored} "
             f"!= of the saved {ev_saved}")
    _, manifest = checkpoint.load(path)
    print(f"checkpoint: {path} ({manifest['num_leaves']} leaves, "
          f"{sum(math.prod(s) for s in manifest['shapes'])} parameters, "
          f"{os.path.getsize(os.path.join(path, 'arrays.npz'))} bytes) "
          f"restored on the card and the CPU bit for bit; evaluate of the "
          f"restored params == of the saved ones {ev_restored}", flush=True)
    return counts


def run_example(name: str, args: list, expect: dict, must: tuple = (),
                never: tuple = ()) -> dict:
    """``examples/<name>.py`` as a child process (its own launch counts
    printed after it returns): exit code 0, the counts ``expect``, every
    line of ``must`` in its output and none of ``never``."""
    path = os.path.join(ROOT, "examples", f"{name}.py")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", EXAMPLE_RUNNER, path, *args],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    secs = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"example {name}: exit code {out.returncode}\n"
             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    lines = out.stdout.splitlines()
    counts = json.loads(lines[-1].split("launch counts: ", 1)[1])
    missing = [s for s in must if s not in out.stdout]
    found = [s for s in never if s in out.stdout]
    if counts != expect or missing or found:
        fail(f"example {name}: counts {counts} (want {expect}), missing "
             f"{missing}, found {found}\n{out.stdout[-3000:]}")
    print(f"example {name} {' '.join(args)}: exit 0 in {secs:.1f} s, "
          f"launches {counts}; last lines: {' / '.join(lines[-4:-1])}",
          flush=True)
    return counts


def examples_phase() -> dict:
    """The three example scripts on the card, each its own process:
    the GBP-CS demo as is (one ``gbp_cs`` launch); the quickstart at the
    JAX example's sizes (M=4, K=12, L=4, T=10, R=8, a GBP-CS run evaluated
    every 2 rounds over 496 images, then a random-selection run), which
    must print its closing "closer" line; the end-to-end script at full
    width (M=10, K=35, L=10) for 2 rounds of 3, evaluated once over 1,240
    images. Returns each one's counts."""
    e2e_out = os.path.join(TOOLS_DIR, "femnist_e2e")
    qs_iters = 10 * 8                       # T·R of each quickstart run
    return {
        "examples_demo": run_example(
            "torch_gbp_cs_demo", [], expect_only(gbp_cs=1),
            must=("gbp_cs   | mismatch", "brute    | mismatch")),
        "examples_quickstart": run_example(
            "torch_quickstart", [],
            expect_only(gbp_cs=qs_iters,
                        conv_fused=2 * 2 * qs_iters + 2 * (8 // 2),
                        agg_weighted=2 * 8),
            must=("GBP-CS super nodes are closer to the global class "
                  "distribution",), never=("unexpected!",)),
        "examples_e2e": run_example(
            "torch_femnist_e2e", ["--rounds", "2", "--iters", "3", "--out",
                                  e2e_out],
            expect_only(gbp_cs=6, conv_fused=2 * 6 + 2 * -(-1240 // 512),
                        agg_weighted=2),
            must=("model: paper 4-layer CNN, 6.60M params", "checkpoint: ",
                  "Prop.4 efficiency condition")),
    }


def tools_phase(torch, dev) -> tuple[dict, dict]:
    """The FEMNIST trainer's public surface on the card: the Fig. 4
    samplers (:func:`sampler_phase`), host-batched evaluation
    (:func:`evaluate_phase`), ``--ckpt-dir`` (:func:`checkpoint_phase`) and
    the three example scripts (:func:`examples_phase`). Returns (each
    path's counts, the numbers for the kernel line)."""
    t0 = time.perf_counter()
    os.makedirs(TOOLS_DIR, exist_ok=True)
    out, nums = {}, {}
    out["samplers"], nums["samplers"] = sampler_phase(torch, dev)
    out["evaluate"], nums["evaluate_ms"] = evaluate_phase(torch, dev)
    out["ckpt_cli"] = checkpoint_phase(torch, dev)
    out.update(examples_phase())
    print(f"tools phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return out, nums


LM_ARCH = "granite-3-2b"
PREFILL_BATCH, PREFILL_LEN = 2, 4096     # granite's published context
FLASH_SWEEP = [(1, 4, 4, 256, 64), (2, 8, 2, 128, 32), (1, 4, 1, 256, 128)]
FLASH_MASKS = [(True, None), (True, 96), (False, None)]
# MLA's (D, Dv) at deepseek-v2-236b's smoke config and, short, at its full
# width: (B, H, KV, S, D, Dv)
FLASH_MLA_SWEEP = [(2, 8, 8, 128, 48, 32), (1, 4, 2, 256, 48, 32),
                   (1, 4, 4, 256, 192, 128)]
MLA_ARCH, MOE_ARCH = "deepseek-v2-236b", "dbrx-132b"


def attended_pairs(s: int, causal: bool, window) -> int:
    """(query, key) pairs a mask leaves unmasked in an (s, s) attention."""
    if not causal:
        return s * s if window is None else sum(
            s - max(0, i - window + 1) for i in range(s))
    return sum(min(i + 1, window or s) for i in range(s))


def sdpa_ms(torch, q, k, v, mask) -> tuple[float | None, str]:
    """``F.scaled_dot_product_attention``'s time on (B, H, S, ·) inputs with
    the first backend that takes them (efficient, cuDNN, flash, math), and
    that backend's name; (None, the backends' refusals) if none does."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    refusals = []
    for backend in (SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.MATH):
        run = lambda: F.scaled_dot_product_attention(q, k, v, **mask)
        with sdpa_kernel(backend):
            try:       # a backend refuses shapes or dtypes it lacks
                run()
            except RuntimeError as e:
                refusals.append(f"{backend.name}: {str(e).splitlines()[0]}")
                continue
            return time_ms(run, reps=5), backend.name
    return None, "; ".join(refusals)


def check_flash_attention(torch, dev):
    """``flash_attention`` against ``attention_plain`` on the card: the
    JAX package's sweep (f32 to 2e-5, bf16 to 2e-2, three masks) and MLA's
    (48, 32) and (192, 128) sweep, then the full-width prefill shape in f32
    with kernel, plain and SDPA times (the GQA call, and the MHA call on K/V
    expanded to H heads outside the timed region) and the bound of each
    mask (the FLOP of the unmasked pairs only), then zamba2-7b's D = 112
    shape, deepseek-v2-236b's MLA shape (D = 192, Dv = 128), causal and
    with a 64-key window, dbrx-132b's and internvl2-26b's GQA shape (48/8
    heads of 128), causal, and whisper-large-v3's encoder (4, 2048, 20/20
    heads of 64, non-causal), decoder (the same, causal) and cross
    attention (512 rows over 2,048 keys, non-causal)."""
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

    sweeps = {"sweep": [c + (c[-1],) for c in FLASH_SWEEP],
              "MLA (D, Dv) sweep": FLASH_MLA_SWEEP}
    for label, sweep in sweeps.items():
        sweep_worst = {dt: 0.0 for dt in tols}
        for b, h, kv, s, d, dv in sweep:
            for dtype, tol in tols.items():
                q, k, v = rand(b, s, h, d, dtype=dtype), \
                    rand(b, s, kv, d, dtype=dtype), \
                    rand(b, s, kv, dv, dtype=dtype)
                for causal, window in FLASH_MASKS:
                    out = kfa.flash_attention(
                        q, k, v, causal=causal, window=window,
                        block_q=min(128, s), block_k=min(128, s))
                    err = float((out.float() - plain(q, k, v, causal, window)
                                 .float()).abs().max())
                    if not err <= tol or out.shape != (b, s, h, dv):
                        fail(f"flash_attention {label} {(b, h, kv, s, d, dv)}"
                             f" {dtype} causal={causal} window={window}: "
                             f"max error {err} > {tol} or out "
                             f"{tuple(out.shape)}")
                    sweep_worst[dtype] = max(sweep_worst[dtype], err)
        for dt in tols:
            worst[dt] = max(worst[dt], sweep_worst[dt])
        print(f"flash_attention {label} {sweep} x f32/bf16 x {FLASH_MASKS}: "
              f"max err f32 {sweep_worst[torch.float32]:.3g} (tol 2e-5), bf16 "
              f"{sweep_worst[torch.bfloat16]:.3g} (tol 2e-2)", flush=True)

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

    # the MoE archs' prefill at full width: deepseek-v2-236b's MLA (128
    # heads, q/k of 128 + 64, v of 128; causal and a 64-key window) and
    # dbrx-132b's GQA (48/8 heads of 128, group 6; causal)
    from repro_torch import configs
    for arch, windows in ((MLA_ARCH, (None, 64)), (MOE_ARCH, (None,)),
                          (VLM_ARCH, (None,))):
        c = configs.get_config(arch)
        b, s, h = MOE_PREFILL + (c.n_heads,)
        mla = c.kv_lora_rank > 0
        kv = c.n_heads if mla else c.n_kv_heads
        d, dv = c.head_dim + (c.rope_head_dim if mla else 0), c.head_dim
        q, k, v = rand(b, s, h, d), rand(b, s, kv, d), rand(b, s, kv, dv)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        for window in windows:
            out = kfa.flash_attention(q, k, v, window=window)
            ref = plain(q, k, v, True, window)
            err = float((out - ref).abs().max())
            del ref
            if not err <= tols[torch.float32] or out.shape != (b, s, h, dv):
                fail(f"flash_attention {arch} {(b, s, h, kv, d, dv)} window="
                     f"{window}: max error {err} > 2e-5 or out "
                     f"{tuple(out.shape)}")
            worst[torch.float32] = max(worst[torch.float32], err)
            del out
            ms = time_ms(lambda: kfa.flash_attention(q, k, v, window=window),
                         reps=5)
            plain_ms = time_ms(lambda: plain(q, k, v, True, window), reps=2,
                               warmup=1)
            torch.cuda.empty_cache()
            if window is None:
                mask = dict(is_causal=True)
            else:
                i = torch.arange(s, device=dev)
                mask = dict(attn_mask=(i[None, :] <= i[:, None])
                            & (i[None, :] > i[:, None] - window))
            mha_ms = mha = None
            if kv != h:     # and SDPA on K/V expanded to H heads (MHA)
                ke, ve = (x.repeat_interleave(h // kv, dim=1)
                          for x in (kt, vt))
                mha_ms, mha = sdpa_ms(torch, qt, ke, ve, mask)
                del ke, ve
                mask["enable_gqa"] = True
            lib_ms, backend = sdpa_ms(torch, qt, kt, vt, mask)
            del mask
            ops = 2 * (d + dv) * b * h * attended_pairs(s, True, window)
            b_ms, b_by = bound(4 * b * s * (h * d + kv * d + kv * dv
                                            + h * dv), ops)
            rows.append(dict(arch=arch, causal=True, window=window, D=d,
                             Dv=dv, shape=(b, s, h, kv, d, dv),
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, library_backend=backend,
                             library_mha_ms=mha_ms, bound_ms=b_ms,
                             bound_by=b_by, tflops=ops / ms / 1e9,
                             share_of_bound=b_ms / ms))
            lib = f"{lib_ms:.4f} ms SDPA ({backend})" if lib_ms is not None \
                else f"SDPA: none ({backend})"
            if mha is not None:
                lib += (f", {mha_ms:.4f} ms SDPA on K/V expanded to {h} heads"
                        f" ({mha})" if mha_ms is not None
                        else f", SDPA on K/V expanded: none ({mha})")
            print(f"flash_attention {arch} shape (B, S, H, KV, D, Dv) = "
                  f"{(b, s, h, kv, d, dv)} f32 causal window={window}: max "
                  f"err {err:.3g} (tol 2e-5); {ms:.4f} ms kernel, "
                  f"{plain_ms:.4f} ms plain, {lib}, bound {b_ms:.4f} ms "
                  f"({b_by}), {ops / ms / 1e9:.1f} TFLOP/s, "
                  f"{b_ms / ms:.0%} of the bound", flush=True)
            torch.cuda.empty_cache()
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()

    # whisper-large-v3 (20/20 heads of 64): the encoder's self attention
    # over 2,048 frames, non-causal; the decoder's causal self attention
    # over 2,048 tokens; the cross attention, 512 rows over the 2,048
    # frames (Sq != Sk), non-causal
    c = configs.get_config(ENCDEC_ARCH)
    b, h, d = ENCDEC_PREFILL[0], c.n_heads, c.head_dim
    sk = ENCDEC_PREFILL[1] // 2
    for what, sq, causal in (("encoder", sk, False), ("decoder", sk, True),
                             ("cross", ENCDEC_CROSS_TOKENS, False)):
        q, k, v = rand(b, sq, h, d), rand(b, sk, h, d), rand(b, sk, h, d)
        out = kfa.flash_attention(q, k, v, causal=causal)
        err = float((out - plain(q, k, v, causal, None)).abs().max())
        if not err <= tols[torch.float32] or out.shape != q.shape:
            fail(f"flash_attention {ENCDEC_ARCH} {what} {(b, sq, sk, h, d)}: "
                 f"max error {err} > 2e-5 or out {tuple(out.shape)}")
        worst[torch.float32] = max(worst[torch.float32], err)
        del out
        run = lambda: kfa.flash_attention(q, k, v, causal=causal)
        ms = time_ms(run, reps=10)
        plain_ms = time_ms(lambda: plain(q, k, v, causal, None), reps=3,
                           warmup=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms, backend = sdpa_ms(torch, qt, kt, vt, dict(is_causal=causal))
        pairs = attended_pairs(sk, True, None) if causal else sq * sk
        ops = 4 * d * b * h * pairs
        b_ms, b_by = bound(4 * b * h * d * (2 * sq + 2 * sk), ops)
        rows.append(dict(arch=ENCDEC_ARCH, what=what, causal=causal,
                         window=None, D=d, Dv=d, shape=(b, sq, sk, h, h, d),
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, library_backend=backend,
                         bound_ms=b_ms, bound_by=b_by, tflops=ops / ms / 1e9,
                         share_of_bound=b_ms / ms))
        lib = f"{lib_ms:.4f} ms SDPA ({backend})" if lib_ms is not None \
            else f"SDPA: none ({backend})"
        print(f"flash_attention {ENCDEC_ARCH} {what} shape (B, Sq, Sk, H, KV, "
              f"D) = {(b, sq, sk, h, h, d)} f32 causal={causal}: max err "
              f"{err:.3g} (tol 2e-5); {ms:.4f} ms kernel, {plain_ms:.4f} ms "
              f"plain, {lib}, bound {b_ms:.4f} ms ({b_by}), "
              f"{ops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.0%} of the bound",
              flush=True)
        del q, k, v, qt, kt, vt
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
                pairs=[list(p) for p in kfa.HEAD_DIMS], cases=rows)


def lm_profile(torch, run, label) -> None:
    """Device time of one ``run()`` by kernel class: the port's flash and
    SSD kernels, the GEMMs and the rest, against the host clock. The
    device's activity alone is traced: a train step's host ops (tens of
    thousands) would cost over half a minute to record and sort."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
                         "ssd_chunk_scan"),
            "ssd_scan_bwd": ("ssd_bwd_",)}
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
    scales (MLA's ``kv_norm`` too, r a layer), and per Mamba2 block the
    depthwise conv, its bias, the dt bias, A_log, D and the gated norm
    (enc-dec: less what it counts twice)."""
    d = cfg.d_model
    if cfg.is_encoder_decoder:
        # the encoder's 2 and the decoder's 3 norms a layer, enc_norm and
        # final_norm; param_count also counts a cross attention in every
        # encoder layer, which has none
        hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        per_attn = d * H * hd + 2 * d * KV * hd + H * hd * d
        return (5 * cfg.num_layers + 2) * d - cfg.num_layers * per_attn
    if cfg.arch_type in ("dense", "moe", "vlm"):
        return (2 * cfg.num_layers + 1) * d \
            + cfg.num_layers * cfg.kv_lora_rank
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


def prefill(torch, label, cfg, fns, params, toks, launches: dict,
            extra: dict | None = None) -> dict:
    """One full-width prefill forward (``attn_impl="pallas"``) of ``toks``
    (and the ``extra`` inputs: a VLM's ``vision_embeds``, an enc-dec's
    ``encoder_frames``) with every launch count set to 0 just before and
    read just after: it must equal ``launches`` (the other kernels 0). Then
    three timed runs (host clock, synchronised), positions/s (every input
    position: tokens, vision embeddings, frames), peak memory and one
    profiled run."""
    from repro_torch.core import dispatch

    batch = dict(extra or {}, tokens=toks)
    forward = lambda: fns.forward(params, batch, attn_impl="pallas")
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
    MEASURED[f"{label} prefill"] = min(walls)
    n_pos = sum(math.prod(x.shape[:2]) for x in batch.values())
    inputs = ", ".join(f"{name} {tuple(x.shape)}"
                       for name, x in batch.items())
    print(f"{label} prefill: {inputs}, launches "
          + ", ".join(f"{n} {name}" for name, n in launches.items())
          + f", logits finite; {[round(w, 1) for w in walls]} ms per "
          f"prefill (host clock, synchronised), "
          f"{n_pos / min(walls) * 1e3:.0f} positions/s at the best; peak "
          f"device memory {peak_gb:.2f} GB", flush=True)
    lm_profile(torch, forward, f"{label} prefill")
    return counts


def decode_vs_prefill(torch, label, cfg, params, toks, window=None,
                      attn_impl="pallas", steps=None) -> None:
    """Decode step by step against the prefill of the same tokens (through
    the kernels unless ``attn_impl`` says otherwise), to 1e-4 of the
    largest logit (windowed: a ring cache of ``window`` slots); ms per
    decode step on the host clock, synchronised at both ends. ``steps``
    decodes only the first ``steps`` tokens against the prefill's first
    ``steps`` positions (causal: they see no later token), so that the
    prefill keeps a length the flash kernel's blocks take."""
    from repro_torch.models import transformer

    c = cfg if window is None else cfg.with_(sliding_window=window)
    full, _ = transformer.forward(c, params, toks, window=window,
                                  attn_impl=attn_impl)
    s = steps or toks.shape[1]
    full = full[:, :s]
    cache = transformer.init_decode_cache(c, toks.shape[0], s,
                                          windowed=window is not None,
                                          device=toks.device)
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(s):
        lg, cache = transformer.decode_step(c, params, cache,
                                            toks[:, i:i + 1], i,
                                            windowed=window is not None)
        outs.append(lg)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / s
    err = float((torch.cat(outs, 1) - full).abs().max())
    scale = float(full.abs().max())
    tol = 1e-4 * scale
    if not err <= tol:
        fail(f"{label} decode vs prefill (window {window}): max error {err} "
             f"> {tol:.3g} (1e-4 of max |logit| {scale:.3g})")
    what = f"window {window}, ring cache of {window}" if window else \
        "plain cache"
    against = "the kernels'" if attn_impl == "pallas" else \
        f"the {attn_impl} attention's"
    print(f"{label} decode vs prefill at full width, {tuple(toks.shape)} "
          f"tokens, {what}: {s} decode steps ({step_ms:.2f} ms/step) against "
          f"{against} prefill, max |diff| {err:.3g} (tol {tol:.3g} = 1e-4 of "
          f"max |logit| {scale:.3g})", flush=True)
    del full, cache, outs


def serve_phase(torch, label, cfg, dev) -> None:
    """``serve()`` at the JAX CLI's defaults (batch 4, prompt 32, gen 32):
    threefry init, prefill by repeated decode, no kernel launch. The
    prompts are drawn on the card: ``MarkovLMStream``'s vocab² table would
    cost 20 GB of host memory and over a minute at 49K ids, 84 GB at
    deepseek's 102K."""
    from repro_torch.core import dispatch
    from repro_torch.launch import serve

    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    prompts = torch.randint(0, cfg.vocab_size, (4, 32), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(2))
    res = serve.serve(cfg, batch=4, prompt_len=32, gen=32, windowed=False,
                      seed=0, device=dev, prompts=prompts)
    serve_counts = dispatch.launch_counts()
    if any(serve_counts.values()):
        fail(f"{label} serve: kernel launches {serve_counts}, want none")
    if res["tokens"].shape != (4, 32) or res["tokens"].min() < 0 or \
            res["tokens"].max() >= cfg.vocab_size:
        fail(f"{label} serve: token ids out of range: {res['tokens']}")
    print(f"{label} serve: {cfg.name} full width, {cfg.num_layers} layers, "
          "batch 4, prompt 32 (torch.randint), gen 32 (threefry init, "
          "prefill by repeated decode): "
          f"{res['ms_per_step']:.2f} ms/step, {res['tok_per_s']:.1f} tok/s, "
          f"{res['steps']} steps, no kernel launch; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    torch.cuda.empty_cache()


# decode steps of a plain-cache decode-vs-prefill run (a windowed run takes
# all 128 tokens, so that its ring cache wraps)
PLAIN_DECODE = 64


def random_tokens(torch, dev, vocab, shape):
    """Prefill tokens of ``shape`` and 128 decode tokens drawn on the card:
    the model does the same work for any ids, and ``MarkovLMStream``'s
    vocab² table costs 20 GB and over a minute of host time at granite's
    49,155 and mamba2's 50,280."""
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
    toks, dec_toks, source = random_tokens(
        torch, dev, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN))
    t0 = time.perf_counter()
    params = fns.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_par = check_param_count("lm", cfg, params)
    print(f"lm: {LM_ARCH} at full width and depth ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, vocab {cfg.vocab_size} -> {cfg.padded_vocab}), "
          f"{n_par:,} f32 parameters from a CUDA torch.Generator in "
          f"{init_s:.1f} s; {source} tokens {tuple(toks.shape)}",
          flush=True)

    counts = prefill(torch, "lm", cfg, fns, params, toks,
                     {"flash_attention": cfg.num_layers})

    # decode against prefill at full width (the JAX package's tests)
    for window in (None, 64):     # a ring of 64 wraps over 128 steps
        decode_vs_prefill(torch, "lm", cfg, params, dec_toks, window,
                          steps=None if window else PLAIN_DECODE)
    del params
    torch.cuda.empty_cache()
    serve_phase(torch, "lm", cfg.with_(num_layers=SERVE_DEPTH[LM_ARCH]), dev)
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


MOE_PREFILL = (1, 4096)
MOE_PEAK_BYTES = 75e9          # a one-card run's prefill stays below this
MOE_ACTIVATION_BYTES = 10e9    # a (1, 4096) prefill's activations, at most
# decode against prefill: tokens (under 4·E, so both sides take the dense
# MoE form), the prefill's attention (dbrx's 48 tokens are no multiple of
# the kernel's 128-row block), the ring's window
MOE_DECODE = {MLA_ARCH: (128, "pallas", 64), MOE_ARCH: (48, "naive", 16)}


def kernel_vs_naive(torch, label, what, run) -> None:
    """``run(attn_impl)``'s logits through the kernels (``"pallas"``)
    against the naive attention's on the same input at full width, to
    1e-4 of the largest logit; ``what`` names the input."""
    ref = run("naive")
    out = run("pallas")
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    if not err <= 1e-4 * scale:
        fail(f"{label} prefill {what}: kernels vs naive attention max "
             f"error {err} > 1e-4 of max |logit| {scale:.3g}")
    print(f"{label} prefill at full width, {what}: the kernels' logits vs "
          f"the naive attention's, max |diff| {err:.3g} (tol "
          f"{1e-4 * scale:.3g} = 1e-4 of max |logit| {scale:.3g})",
          flush=True)
    del ref, out


def moe_depth(cfg) -> int:
    """Layers of ``cfg`` kept on one card: 3 if their f32 weights and a
    prefill's activations stay under ``MOE_PEAK_BYTES``, else 2."""
    for depth in (3, 2):
        c = cfg.with_(num_layers=depth)
        if 4 * (c.param_count() + uncounted_params(c)) \
                + MOE_ACTIVATION_BYTES <= MOE_PEAK_BYTES:
            return depth
    fail(f"{cfg.name}: two layers do not fit one card")


def moe_path(torch, dev, arch) -> dict:
    """An MoE serving slice at full width, depth cut to fit one card: a
    (1, 4096) prefill (flash once a layer, MoE dispatch; counted, timed,
    profiled, peak memory under ``MOE_PEAK_BYTES``), decode against
    prefill plain and on a ring cache, where that prefill's attention is
    the naive one the kernels' prefill against it, and deepseek's
    ``serve()``. Returns the prefill's launch counts."""
    from repro_torch import configs
    from repro_torch.models import build, moe, transformer

    full = configs.get_config(arch)
    depth = moe_depth(full)
    cfg = full.with_(num_layers=depth)
    fns = build(cfg)
    toks, dec_toks, source = random_tokens(torch, dev, cfg.vocab_size,
                                           MOE_PREFILL)
    t0 = time.perf_counter()
    params = fns.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_par = check_param_count(arch, cfg, params)
    attn = (f"MLA r {cfg.kv_lora_rank}, rope {cfg.rope_head_dim}, "
            f"{cfg.n_heads} heads of {cfg.head_dim} (flash at D = "
            f"{cfg.head_dim + cfg.rope_head_dim}, Dv = {cfg.head_dim})"
            if cfg.kv_lora_rank else
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}")
    n = math.prod(MOE_PREFILL)
    print(f"{arch}: full width, depth {depth} of {full.num_layers} layers "
          f"(3 if the f32 weights, {4 * n_par / 1e9:.1f} GB here, and a "
          f"prefill's activations fit {MOE_PEAK_BYTES / 1e9:.0f} GB, else "
          f"2): d_model {cfg.d_model}, {attn}, {cfg.n_experts} experts "
          f"top-{cfg.top_k} of d_ff {cfg.d_ff} + {cfg.n_shared_experts} "
          f"shared, vocab {cfg.vocab_size} -> {cfg.padded_vocab}; "
          f"{n_par:,} f32 parameters from a CUDA torch.Generator in "
          f"{init_s:.1f} s; {source} tokens {MOE_PREFILL}: {n} tokens >= "
          f"4·E = {4 * cfg.n_experts}, the dispatch form, capacity "
          f"{moe.capacity(n, cfg)} a expert", flush=True)
    counts = prefill(torch, arch, cfg, fns, params, toks,
                     {"flash_attention": depth})
    peak = torch.cuda.max_memory_allocated()
    if peak > MOE_PEAK_BYTES:
        fail(f"{arch} prefill: peak device memory {peak / 1e9:.2f} GB > "
             f"{MOE_PEAK_BYTES / 1e9:.0f} GB at depth {depth}")
    del toks
    torch.cuda.empty_cache()
    n_dec, impl, window = MOE_DECODE[arch]
    for w in (None, window):
        decode_vs_prefill(torch, arch, cfg, params, dec_toks[:, :n_dec], w,
                          attn_impl=impl,
                          steps=None if w else min(n_dec, PLAIN_DECODE))
    if impl != "pallas":     # so the kernel is held in the model here too
        kernel_vs_naive(torch, arch, f"{tuple(dec_toks.shape)} tokens",
                        lambda impl: transformer.forward(
                            cfg, params, dec_toks, attn_impl=impl)[0])
    del params
    torch.cuda.empty_cache()
    if arch == MLA_ARCH:
        serve_phase(torch, arch, cfg.with_(num_layers=SERVE_DEPTH[arch]), dev)
    return counts


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


def ssd_bwd_split(kb, call) -> dict:
    """Each launch of ``csrc/ssd_scan_bwd.cu`` timed on its own (CUDA
    events, on the buffers of one full call), with its CTAs and its rate:
    TFLOP/s of the FLOP it does as tiled, or TB/s of the bytes it moves
    (``kb.work``)."""
    x, B = call["x"], call["B"]
    shape = (*x.shape, B.shape[-1], call["chunk"])
    kb.run(call)
    ctas, work = kb.plan(*shape)["ctas"], kb.work(*shape)
    split = {}
    for i, part in enumerate(kb.PARTS):
        ms = time_ms(lambda: kb.run(call, 1 << i), reps=10)
        kind, amount = work[part]
        split[part] = {"ms": ms, "ctas": ctas[part],
                       "tflops" if kind == "flop" else "tbps":
                       amount / ms / 1e9}
    return split


def split_line(split: dict) -> str:
    """A per-launch split as one line: ms, CTAs and rate of each launch."""
    return "; ".join(
        f"{part} {v['ms']:.4f} ms ({v['ctas']} CTAs"
        + (f", {v['tflops']:.1f} TFLOP/s" if "tflops" in v else "")
        + (f", {v['tbps']:.2f} TB/s" if "tbps" in v else "") + ")"
        for part, v in split.items()) + \
        f"; sum {sum(v['ms'] for v in split.values()):.4f} ms"


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
        print(f"ssd_scan {arch} launches, each timed alone: "
              f"{split_line(split)}", flush=True)
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
    decode_vs_prefill(torch, arch, cfg, params, dec_toks,
                      steps=PLAIN_DECODE)
    del params
    torch.cuda.empty_cache()
    return counts


VLM_ARCH, ENCDEC_ARCH = "internvl2-26b", "whisper-large-v3"
# serve() at a cut depth where a full-depth init dominates its run: the
# prefill and decode checks run at the path's own depth
SERVE_DEPTH = {LM_ARCH: 8, SSM_ARCH: 8, MLA_ARCH: 1, VLM_ARCH: 8}
VLM_PREFILL = (1, 4096)           # 512 vision embeddings + 3,584 tokens
VLM_ACTIVATION_BYTES = 5e9        # a (1, 4096) prefill's activations, at most
ENCDEC_PREFILL = (4, 4096)        # 2,048 frames + 2,048 tokens
ENCDEC_CROSS_TOKENS = 512         # decoder rows of the Sq != Sk forward
ENCDEC_DECODE = 64                # greedy steps, B = 4, over 2,048 frames
# decode against prefill: tokens, the prefill's attention (64 tokens are no
# multiple of the kernel's 128-row block), the ring's window (wrapped)
VLM_DECODE = (64, "naive", 16)


def vlm_depth(cfg) -> int:
    """The most layers of ``cfg`` whose f32 weights and a (1, 4096)
    prefill's activations stay under ``MOE_PEAK_BYTES``."""
    depth = cfg.num_layers
    while depth > 1:
        c = cfg.with_(num_layers=depth)
        if 4 * (c.param_count() + uncounted_params(c)) \
                + VLM_ACTIVATION_BYTES <= MOE_PEAK_BYTES:
            return depth
        depth -= 1
    fail(f"{cfg.name}: one layer does not fit one card")


def vlm_path(torch, dev) -> dict:
    """The VLM serving slice (internvl2-26b) at full width, depth cut to fit
    one card (``vlm_depth``, printed): a (1, 4096) prefill of
    ``make_dummy_batch``'s batch on the card (512 vision embeddings before
    3,584 tokens; one flash launch a layer; counted, timed, profiled,
    peak memory under ``MOE_PEAK_BYTES``), the kernels' prefill against
    the naive attention's on 32 + 96 positions, decode of 64 tokens
    against the naive attention's prefill without a prefix (plain and a
    16-slot ring), and ``serve()``. Returns the prefill's launch
    counts."""
    from repro_torch import configs
    from repro_torch.models import build, make_dummy_batch, transformer

    full = configs.get_config(VLM_ARCH)
    depth = vlm_depth(full)
    cfg = full.with_(num_layers=depth)
    fns = build(cfg)
    shape = configs.InputShape("vlm", VLM_PREFILL[1], VLM_PREFILL[0],
                               "prefill")
    batch = make_dummy_batch(cfg, shape, device=dev)
    toks, vis = batch["tokens"], batch["vision_embeds"]
    dec_toks = torch.randint(0, cfg.vocab_size, (1, 128), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(1))
    t0 = time.perf_counter()
    params = fns.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_par = check_param_count(VLM_ARCH, cfg, params)
    print(f"vlm: {VLM_ARCH} at full width, depth {depth} of "
          f"{full.num_layers} layers (the most whose f32 weights, "
          f"{4 * n_par / 1e9:.1f} GB here, and "
          f"{VLM_ACTIVATION_BYTES / 1e9:.0f} GB of prefill activations fit "
          f"{MOE_PEAK_BYTES / 1e9:.0f} GB): d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size} -> {cfg.padded_vocab}; "
          f"{n_par:,} f32 parameters from a CUDA torch.Generator in "
          f"{init_s:.1f} s; make_dummy_batch of {VLM_PREFILL} on the card: "
          f"vision_embeds {tuple(vis.shape)} before tokens "
          f"{tuple(toks.shape)}; decode tokens by torch.randint", flush=True)
    counts = prefill(torch, "vlm", cfg, fns, params, toks,
                     {"flash_attention": depth}, {"vision_embeds": vis})
    peak = torch.cuda.max_memory_allocated()
    if peak > MOE_PEAK_BYTES:
        fail(f"vlm prefill: peak device memory {peak / 1e9:.2f} GB > "
             f"{MOE_PEAK_BYTES / 1e9:.0f} GB at depth {depth}")
    del batch, toks
    torch.cuda.empty_cache()
    kernel_vs_naive(torch, "vlm", "(1, 96) tokens after 32 vision "
                    "embeddings", lambda impl: transformer.forward(
                        cfg, params, dec_toks[:, :96],
                        prefix_embeds=vis[:, :32], attn_impl=impl)[0])
    del vis
    n_dec, impl, ring = VLM_DECODE
    for window in (None, ring):
        decode_vs_prefill(torch, "vlm", cfg, params, dec_toks[:, :n_dec],
                          window, attn_impl=impl)
    del params
    torch.cuda.empty_cache()
    serve_phase(torch, "vlm", cfg.with_(num_layers=SERVE_DEPTH[VLM_ARCH]), dev)
    return counts


def encdec_decode(torch, label, cfg, params, frames, first) -> None:
    """Greedy decode through ``encode`` → ``prefill_cross_cache`` → the
    serve step, ``ENCDEC_DECODE`` steps from the tokens ``first`` (B, 1)
    (ms a step, host clock, synchronised at both ends), then the generated
    sequence decoded again through ``decode_step`` against the
    teacher-forced forward of the same tokens (the naive attention: 64
    tokens are no multiple of the kernel's block; the forwards above hold
    the kernel), to 1e-4 of the largest logit; the serve step's ids must
    be the argmax of those decode logits."""
    from repro_torch.launch import steps
    from repro_torch.models import encdec

    b, n = first.shape[0], ENCDEC_DECODE
    serve_step = steps.make_serve_step(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = encdec.encode(cfg, params, frames, attn_impl="pallas")
    cache = encdec.prefill_cross_cache(
        cfg, params, encdec.init_decode_cache(cfg, b, n, enc_len=
                                              frames.shape[1],
                                              device=frames.device), enc)
    torch.cuda.synchronize()
    enc_ms = 1e3 * (time.perf_counter() - t0)
    toks = [first]
    t0 = time.perf_counter()
    for i in range(n - 1):
        nxt, cache = serve_step(params, cache, toks[-1], i)
        toks.append(nxt)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / (n - 1)
    seq = torch.cat(toks, dim=1)
    cache = encdec.prefill_cross_cache(
        cfg, params, encdec.init_decode_cache(cfg, b, n, enc_len=
                                              frames.shape[1],
                                              device=frames.device), enc)
    outs = []
    with torch.no_grad():
        for i in range(n):
            lg, cache = encdec.decode_step(cfg, params, cache,
                                           seq[:, i:i + 1], i)
            outs.append(lg)
        dec = torch.cat(outs, dim=1)
        full = encdec.decode_train(cfg, params, seq, enc, attn_impl="naive")
    ids = torch.argmax(dec[..., :cfg.vocab_size], dim=-1).to(torch.int32)
    if not torch.equal(ids[:, :-1], seq[:, 1:]):
        fail(f"{label} greedy decode: the serve step's ids are not the "
             "argmax of the decode logits")
    err = float((dec - full).abs().max())
    scale = float(full.abs().max())
    if not err <= 1e-4 * scale:
        fail(f"{label} decode vs teacher-forced: max error {err} > 1e-4 of "
             f"max |logit| {scale:.3g}")
    print(f"{label} greedy decode at full width, B = {b}, {n - 1} serve "
          f"steps over {frames.shape[1]} frames: encode + cross cache "
          f"{enc_ms:.1f} ms, {step_ms:.2f} ms/step; decode vs the "
          f"teacher-forced forward (naive) of the {n} tokens max |diff| "
          f"{err:.3g} (tol {1e-4 * scale:.3g} = 1e-4 of max |logit| "
          f"{scale:.3g}); the serve step's ids are the decode's argmax",
          flush=True)
    del cache, dec, full, enc


def encdec_path(torch, dev) -> tuple[dict, dict]:
    """The enc-dec serving slice (whisper-large-v3) at full width and
    depth: a forward of ``make_dummy_batch``'s (4, 4096) (2,048 frames,
    2,048 tokens; three flash launches a layer pair: encoder, decoder self,
    cross; counted, timed, profiled), a second with 512 decoder tokens
    over the same frames (the cross attention at Sq != Sk), and greedy
    decode against teacher forcing. Returns the two forwards' counts."""
    from repro_torch import configs
    from repro_torch.models import build, encdec, make_dummy_batch

    cfg = configs.get_config(ENCDEC_ARCH)
    fns = build(cfg)
    shape = configs.InputShape("encdec", ENCDEC_PREFILL[1],
                               ENCDEC_PREFILL[0], "prefill")
    batch = make_dummy_batch(cfg, shape, device=dev)
    frames, toks = batch["encoder_frames"], batch["tokens"]
    t0 = time.perf_counter()
    params = fns.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_par = check_param_count(ENCDEC_ARCH, cfg, params)
    print(f"encdec: {ENCDEC_ARCH} at full width and depth ({cfg.num_layers} "
          f"encoder + {cfg.num_layers} decoder layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, gelu MLP of {cfg.d_ff}, vocab {cfg.vocab_size} "
          f"-> {cfg.padded_vocab}), {n_par:,} f32 parameters from a CUDA "
          f"torch.Generator in {init_s:.1f} s; make_dummy_batch of "
          f"{ENCDEC_PREFILL} on the card: encoder_frames "
          f"{tuple(frames.shape)}, tokens {tuple(toks.shape)}", flush=True)
    flash = {"flash_attention": 3 * cfg.num_layers}
    counts = prefill(torch, "encdec", cfg, fns, params, toks, flash,
                     {"encoder_frames": frames})
    cross = prefill(torch, "encdec cross (Sq != Sk)", cfg, fns, params,
                    toks[:, :ENCDEC_CROSS_TOKENS].contiguous(), flash,
                    {"encoder_frames": frames})
    torch.cuda.empty_cache()
    short = {"encoder_frames": frames[:1, :256], "tokens": toks[:1, :128]}
    kernel_vs_naive(torch, "encdec", "(1, 256) frames and (1, 128) tokens",
                    lambda impl: encdec.forward(cfg, params, short,
                                                attn_impl=impl))
    encdec_decode(torch, "encdec", cfg, params, frames, toks[:, :1])
    del params, batch, frames, toks
    torch.cuda.empty_cache()
    return counts, cross


def vlm_smoke_card_vs_cpu(torch, dev) -> None:
    """internvl2-26b's smoke config: the serve CLI's ids and the prefill
    logits card vs CPU (``lm_smoke_card_vs_cpu``), and the prefill with a
    32-embedding vision prefix before 96 tokens."""
    from repro_torch import configs, convert
    from repro_torch.core import prng
    from repro_torch.models import transformer

    lm_smoke_card_vs_cpu(torch, dev, VLM_ARCH, "vlm")
    cfg = configs.get_smoke_config(VLM_ARCH)
    params = transformer.init_lm(cfg, prng.PRNGKey(0), "cpu")
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 96), generator=gen)
    vis = torch.randn(2, 32, cfg.d_model, generator=gen) * 0.02
    ref, _ = transformer.forward(cfg, params, toks, prefix_embeds=vis,
                                 attn_impl="pallas")
    gp = convert.params_from_jax(convert.params_to_numpy(params), dev)
    out, _ = transformer.forward(cfg, gp, toks.to(dev),
                                 prefix_embeds=vis.to(dev),
                                 attn_impl="pallas")
    err = float((out.cpu() - ref).abs().max())
    if not err <= 1e-4:
        fail(f"vlm smoke prefill with a prefix: card vs CPU logits differ "
             f"by {err} > 1e-4")
    print(f"vlm smoke prefill, 32 vision embeddings + 96 tokens, "
          f"attn_impl='pallas': card (kernels) vs CPU (plain) text logits "
          f"max |diff| {err:.3g} (tol 1e-4)", flush=True)


def encdec_smoke_card_vs_cpu(torch, dev) -> None:
    """whisper-large-v3's smoke config card vs CPU: the forward over 256
    frames and 128 tokens through the kernels (the cross attention at
    Sq != Sk) and 8 decode steps after the cross cache, to 1e-4; the
    greedy ids of the serve step equal."""
    from repro_torch import configs, convert
    from repro_torch.core import prng
    from repro_torch.launch import steps
    from repro_torch.models import encdec

    cfg = configs.get_smoke_config(ENCDEC_ARCH)
    params = encdec.init_encdec(cfg, prng.PRNGKey(0), "cpu")
    gen = torch.Generator().manual_seed(0)
    batch = {"encoder_frames": torch.randn(2, 256, cfg.d_model,
                                           generator=gen) * 0.02,
             "tokens": torch.randint(0, cfg.vocab_size, (2, 128),
                                     generator=gen)}
    serve_step = steps.make_serve_step(cfg)
    res = {}
    for device in ("cpu", dev):
        p = params if device == "cpu" else convert.params_from_jax(
            convert.params_to_numpy(params), dev)
        b = {k: v.to(device) for k, v in batch.items()}
        logits = encdec.forward(cfg, p, b, attn_impl="pallas")
        cache = encdec.prefill_cross_cache(
            cfg, p, encdec.init_decode_cache(cfg, 2, 8, enc_len=256,
                                             device=device),
            encdec.encode(cfg, p, b["encoder_frames"]))
        ids = [b["tokens"][:, :1]]
        for i in range(8):
            nxt, cache = serve_step(p, cache, ids[-1], i)
            ids.append(nxt)
        res[str(device)] = (logits.cpu(), torch.cat(ids, 1).cpu())
    (ref, ref_ids), (out, ids) = res["cpu"], res[str(dev)]
    err = float((out - ref).abs().max())
    if not err <= 1e-4 or not torch.equal(ids, ref_ids):
        fail(f"encdec smoke: card vs CPU logits differ by {err} > 1e-4, or "
             f"the greedy ids differ:\n{ids[0].tolist()}\n"
             f"{ref_ids[0].tolist()}")
    print(f"encdec smoke forward (2, 256 frames, 128 tokens), "
          f"attn_impl='pallas': card (kernels) vs CPU (plain) logits max "
          f"|diff| {err:.3g} (tol 1e-4); 8 greedy serve steps equal card "
          f"vs CPU, row 0 {ids[0].tolist()}", flush=True)


TRAIN_ARCH = SSM_ARCH             # mamba2-780m, trained at full width
TRAIN_SHAPE = (4, 2048)           # each pod's "train" batch (B, S)
TRAIN_PODS, TRAIN_ACCUM, TRAIN_LR = 2, 2, 0.1
TRAIN_ITERS, TRAIN_ROUNDS = 2, 2  # T internal steps a round, R rounds
TRAIN_CUT_LAYERS = 4              # the full-width comparisons, depth cut
TRAIN_SMOKE_SHAPE = (4, 256)      # the smoke configs' card-vs-CPU step
DRYRUN_TIMEOUT = 300              # seconds the dry run's child may take


def ssd_bwd_work(bt, s, h, p, n) -> tuple[int, int]:
    """(bytes, FLOP) the scan's gradient needs at the least: x, dt, A, B,
    C and dy read once, dx, ddt, dA, dB and dC written once; per (token,
    head) the state gradient's update (C dy^T) and its three contractions
    (with B for dx, with xd for dB, and dC's with the state), 2NP each:
    8NP, whatever blocking a kernel picks (a chunked form adds the causal
    triangles, as in the forward's ``ssd_work``)."""
    flop = 8 * bt * s * h * n * p
    bytes_ = 4 * (3 * bt * s * h * p + 2 * bt * s * h + 4 * bt * s * n
                  + 2 * h)
    return bytes_, flop


def check_ssd_scan_bwd(torch, dev):
    """The ``ssd_scan`` gradient (``csrc/ssd_scan_bwd.cu``, through the
    wrapper's autograd function) against autograd of ``ssd_scan_plain``
    on the card: the sweep and both full-width shapes (mamba2-780m's
    training microbatch (2, 2048, 48, 64, 128), zamba2-7b's (1, 4096, 112,
    64, 64)), each of dx, ddt, dA, dB and dC to 1e-4 * max(1, max |ref|)
    of the plain version run in float64. The f32 plain version's own
    distance to it is printed beside the kernel's: its cumsum-difference
    exponents and its f32 sums lose up to ~1e-4 of the largest gradient
    at these shapes, so an f32 reference cannot hold the kernel to 1e-4.
    Then the kernel's and the plain backward's times and the FLOP bound."""
    from repro_torch import configs
    from repro_torch.kernels import ssd_scan as kssd
    from repro_torch.kernels import ssd_scan_bwd as kb

    gen = torch.Generator(device=dev).manual_seed(12)
    names = ("dx", "ddt", "dA", "dB", "dC")
    worst = {"kernel": 0.0, "plain32": 0.0}

    def compare(case, chunk):
        args = kssd.example_inputs(gen, *case)
        dy = torch.randn(args[0].shape, generator=gen, device=dev)
        ins = [t.detach().requires_grad_(True) for t in args]
        out = torch.autograd.grad(kssd.ssd_scan(*ins, chunk=chunk), ins, dy)
        ref32 = kb.backward_plain(*args, dy, chunk=chunk)
        ref = kb.backward_plain(*(t.double() for t in args), dy.double(),
                                chunk=chunk)
        rel, rel32, absolute = {}, {}, 0.0
        for name, a, r32, r in zip(names, out, ref32, ref):
            scale = max(1.0, float(r.abs().max()))
            err = float((a.double() - r).abs().max())
            rel[name] = err / scale
            rel32[name] = float((r32.double() - r).abs().max()) / scale
            absolute = max(absolute, err)
            if not err <= 1e-4 * scale:
                fail(f"ssd_scan backward {case} chunk={chunk}: {name} max "
                     f"error {err} > 1e-4 * {scale:.4g} (float64 plain)")
        worst["kernel"] = max(worst["kernel"], max(rel.values()))
        worst["plain32"] = max(worst["plain32"], max(rel32.values()))
        return args, dy, rel, rel32, absolute

    for bt, s, h, p, n, chunk in kssd.SWEEP + kb.EDGES:
        compare((bt, s, h, p, n), min(chunk, s))
    print(f"ssd_scan backward sweep {kssd.SWEEP} and edges {kb.EDGES}: max err "
          f"{worst['kernel']:.3g} of max(1, max |grad|) against the float64 "
          f"plain version (tol 1e-4); the f32 plain version's own: "
          f"{worst['plain32']:.3g}", flush=True)

    rows = []
    for arch, (bt, s) in ((SSM_ARCH, (TRAIN_SHAPE[0] // TRAIN_ACCUM,
                                      TRAIN_SHAPE[1])),
                          (HYBRID_ARCH, HYBRID_PREFILL)):
        cfg = configs.get_config(arch)
        h, p, n, q = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                      cfg.ssm_chunk)
        args, dy, rel, rel32, absolute = compare((bt, s, h, p, n), q)
        x, dt, A, B, C = args
        call = kssd.prepare(x, dt, A, B, C, q)
        kssd.run(call)
        ms = time_ms(lambda: kb.backward(call["x"], dt, A, call["B"],
                                         call["C"], call["states"], dy, q),
                     reps=10)
        bwd = kb.prepare(call["x"], dt, A, call["B"], call["C"],
                         call["states"], dy, q)
        split = ssd_bwd_split(kb, bwd)
        kb.run(bwd)
        first = [bwd[k].clone() for k in names]
        kb.run(bwd)
        if not all(torch.equal(a, bwd[k]) for a, k in zip(first, names)):
            fail(f"ssd_scan backward {arch}: two calls on the same inputs "
                 "differ")
        ins = [t.detach().requires_grad_(True) for t in args]
        y = kssd.ssd_scan_plain(*ins, chunk=q)
        plain_ms = time_ms(lambda: torch.autograd.grad(
            y, ins, dy, retain_graph=True), reps=3, warmup=1)
        bytes_, flop = ssd_bwd_work(bt, s, h, p, n)
        b_ms, b_by = bound(bytes_, flop)
        rows.append(dict(arch=arch, shape=(bt, s, h, p, n, q),
                         max_abs_err=absolute, rel_err=rel,
                         plain32_rel_err=rel32, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, gflop=flop / 1e9,
                         split=split))
        print(f"ssd_scan backward {arch} (Bt, S, H, P, N, Q) = "
              f"{(bt, s, h, p, n, q)}: err of max(1, max |grad|) against "
              f"float64 " + ", ".join(f"{k} {v:.2g}" for k, v in rel.items())
              + "; the f32 plain version's " + ", ".join(
                  f"{k} {v:.2g}" for k, v in rel32.items())
              + f"; {ms:.4f} ms kernel, {plain_ms:.4f} ms plain backward "
              f"(autograd), bound {b_ms:.4f} ms ({b_by}: "
              f"{flop / 1e9:.2f} GFLOP), {100 * b_ms / ms:.1f}% of it; no "
              "single PyTorch call computes the gradient", flush=True)
        print(f"ssd_scan backward {arch} launches, each timed alone: "
              f"{split_line(split)}; two calls bit-equal in dx, ddt, dA, "
              "dB and dC", flush=True)
        del args, dy, call, bwd, first, ins, y, x, dt, A, B, C
        torch.cuda.empty_cache()
    main_row = rows[0]
    return dict(name=kb.NAME, route="cuda", source=kb.SOURCE,
                replaces=kb.REPLACES, max_abs_err=main_row["max_abs_err"],
                tol="1e-4 * max(1, max |grad|) of the float64 plain version",
                max_rel_err_all=worst["kernel"],
                plain32_max_rel_err_all=worst["plain32"],
                ms=main_row["ms"], plain_ms=main_row["plain_ms"],
                bound_ms=main_row["bound_ms"],
                bound_by=main_row["bound_by"], library_ms=None,
                shape="Bt=2 S=2048 H=48 P=64 N=128 Q=128 f32 (mamba2-780m, "
                      "one microbatch of the train step)", cases=rows)


def pod_batch(torch, cfg, shape, pods: int, device):
    """``pods`` ``make_dummy_batch`` "train" batches of (B, S) = shape,
    keys 1, 2, ..., stacked on a leading pod axis."""
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.models import make_dummy_batch

    spec = configs.InputShape("train", shape[1], shape[0], "train")
    each = [make_dummy_batch(cfg, spec, prng.PRNGKey(1 + m), device)
            for m in range(pods)]
    return {k: torch.stack([b[k] for b in each]) for k in each[0]}


def leaf_err(a, b) -> float:
    """max |a - b| over max(1, max |b|)."""
    return float((a.float() - b.float()).abs().max()) / max(
        1.0, float(b.float().abs().max()))


def train_path(torch, dev) -> dict:
    """The FEDGS pod train step on mamba2-780m at full width and depth:
    two pods, each its own fixed "train" batch, ``grad_accum`` 2, remat;
    T internal steps a round, R rounds, Eq. 5 after each round. Launch
    counts over the run against the formulas, ms per step and per Eq. 5,
    peak memory, the loss per step; the pods differ after a step and are
    equal after Eq. 5, which is within 1e-6 of ``torch.mean``; the loss
    falls. Returns the run's launch counts."""
    from repro_torch import configs, tree
    from repro_torch.core import dispatch
    from repro_torch.launch import steps
    from repro_torch.models import build

    cfg = configs.get_config(TRAIN_ARCH)
    L = cfg.num_layers
    t0 = time.perf_counter()
    one = build(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
    n_par = check_param_count(TRAIN_ARCH, cfg, one)
    stacked = tree.map(lambda leaf: torch.stack([leaf] * TRAIN_PODS), one)
    del one
    batch = pod_batch(torch, cfg, TRAIN_SHAPE, TRAIN_PODS, dev)
    step = steps.make_train_step(cfg, lr=TRAIN_LR, grad_accum=TRAIN_ACCUM,
                                 remat=True)
    torch.cuda.synchronize()
    print(f"train {TRAIN_ARCH}: full width and depth ({L} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size} -> {cfg.padded_vocab}), "
          f"{n_par:,} f32 parameters a pod from a CUDA torch.Generator, "
          f"{TRAIN_PODS} pods, each a fixed make_dummy_batch 'train' batch "
          f"{TRAIN_SHAPE}, grad_accum {TRAIN_ACCUM}, remat, lr {TRAIN_LR}, "
          f"T = {TRAIN_ITERS}, R = {TRAIN_ROUNDS}; set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    n_steps = TRAIN_ITERS * TRAIN_ROUNDS
    # per pod and step: each layer's forward once and once more in the
    # remat recompute, per microbatch; one backward per layer and microbatch
    expect = expect_only(
        ssd_scan=2 * L * TRAIN_ACCUM * TRAIN_PODS * n_steps,
        ssd_scan_bwd=L * TRAIN_ACCUM * TRAIN_PODS * n_steps,
        agg_weighted=TRAIN_ROUNDS)
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    losses, step_ms, sync_ms, sync_extra = [], [], [], []
    peak = 0
    for r in range(TRAIN_ROUNDS):
        for _ in range(TRAIN_ITERS):
            t1 = time.perf_counter()
            stacked, loss = step(stacked, batch)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t1))
            losses.append(float(loss))
            if not math.isfinite(losses[-1]):
                fail(f"train {TRAIN_ARCH}: loss {losses[-1]} at step "
                     f"{len(losses)}")
            if len(losses) == 1 and not any(
                    bool((leaf[0] != leaf[1]).any())
                    for leaf in tree.leaves(stacked)):
                fail(f"train {TRAIN_ARCH}: the pods saw different batches "
                     "but are equal after a step")
        # Eq. 5's own peak above what it starts from: the flat (M, P4)
        # copy, the mean and the new stacked tree
        peak = max(peak, torch.cuda.max_memory_allocated())
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        synced = steps.external_sync_step(stacked)
        torch.cuda.synchronize()
        sync_ms.append(1e3 * (time.perf_counter() - t1))
        sync_extra.append((torch.cuda.max_memory_allocated() - base) / 1e9)
        err = 0.0
        for s_leaf, leaf in zip(tree.leaves(synced), tree.leaves(stacked)):
            if not all(torch.equal(s_leaf[0], s_leaf[m])
                       for m in range(1, TRAIN_PODS)):
                fail(f"train {TRAIN_ARCH}: the pods differ after Eq. 5")
            err = max(err, float((s_leaf[0] - leaf.mean(0)).abs().max()))
        if not err <= 1e-6:
            fail(f"train {TRAIN_ARCH}: Eq. 5 differs from torch.mean over "
                 f"the pods by {err} > 1e-6")
        stacked = synced
        del synced
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    if counts != expect:
        fail(f"train {TRAIN_ARCH}: launch counts {counts} != {expect}")
    peak_gb = max(peak, torch.cuda.max_memory_allocated()) / 1e9
    MEASURED["train step"] = min(step_ms)
    if not losses[-1] < losses[0]:
        fail(f"train {TRAIN_ARCH}: the loss on the fixed batches did not "
             f"fall: {losses}")
    print(f"train {TRAIN_ARCH}: losses {[round(v, 5) for v in losses]} over "
          f"{n_steps} steps; {[round(v, 1) for v in step_ms]} ms per train "
          f"step (host clock, synchronised; {TRAIN_PODS} pods x "
          f"{TRAIN_SHAPE[0] * TRAIN_SHAPE[1]} tokens), "
          f"{[round(v, 1) for v in sync_ms]} ms per Eq. 5 (its peak "
          f"{[round(v, 2) for v in sync_extra]} GB above the "
          f"{TRAIN_PODS} x {4 * n_par / 1e9:.2f} GB of stacked parameters "
          f"it starts from); Eq. 5 within {err:.3g} of torch.mean; peak "
          f"device memory {peak_gb:.2f} GB; "
          f"launches ssd_scan {counts['ssd_scan']} = 2 L ga pods steps "
          f"(remat runs each forward twice), ssd_scan_bwd "
          f"{counts['ssd_scan_bwd']} = L ga pods steps, agg_weighted "
          f"{counts['agg_weighted']} = R", flush=True)
    lm_profile(torch, lambda: step(stacked, batch), f"train {TRAIN_ARCH} step")
    del stacked, batch
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def train_cut_checks(torch, dev) -> None:
    """mamba2-780m at full width, 4 of 48 layers, one pod: one step with
    remat against one without (parameters within 1e-6 of max(1, max
    |leaf|)), and ``grad_accum`` 2 against 1 (test_launch.py's atol 2e-5,
    rtol 2e-4)."""
    from repro_torch import configs, tree
    from repro_torch.launch import steps
    from repro_torch.models import build

    cfg = configs.get_config(TRAIN_ARCH).with_(num_layers=TRAIN_CUT_LAYERS)
    one = build(cfg).init(torch.Generator(device=dev).manual_seed(2), dev)
    stacked = tree.map(lambda leaf: leaf[None], one)
    batch = pod_batch(torch, cfg, TRAIN_SHAPE, 1, dev)
    run = lambda ga, remat: steps.make_train_step(
        cfg, lr=TRAIN_LR, grad_accum=ga, remat=remat)(stacked, batch)
    new_r, loss_r = run(TRAIN_ACCUM, True)
    new_p, loss_p = run(TRAIN_ACCUM, False)
    remat_err = max(leaf_err(a, b) for a, b in zip(tree.leaves(new_r),
                                                   tree.leaves(new_p)))
    if not remat_err <= 1e-6 or float(loss_r) != float(loss_p):
        fail(f"train cut: remat on vs off: params differ by {remat_err} of "
             f"max(1, max |leaf|), losses {float(loss_r)} {float(loss_p)}")
    del new_p
    new_1, loss_1 = run(1, True)
    for a, b in zip(tree.leaves(new_1), tree.leaves(new_r)):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-4)
    accum_err = max(float((a - b).abs().max())
                    for a, b in zip(tree.leaves(new_1), tree.leaves(new_r)))
    print(f"train cut ({TRAIN_ARCH}, full width, {TRAIN_CUT_LAYERS} of 48 "
          f"layers, one pod, {TRAIN_SHAPE}): remat on vs off params "
          f"{remat_err:.3g} of max(1, max |leaf|) (tol 1e-6), losses "
          f"equal; grad_accum 1 vs {TRAIN_ACCUM}: max |diff| "
          f"{accum_err:.3g} (atol 2e-5, rtol 2e-4), losses "
          f"{float(loss_1):.6f} / {float(loss_r):.6f}", flush=True)
    del one, stacked, batch, new_r, new_1
    torch.cuda.empty_cache()


def train_smoke_card_vs_cpu(torch, dev) -> None:
    """Every arch's smoke config: one train step (two pods, the second's
    weights 1.1 x the first's, ``grad_accum`` 2, remat) on the card and on
    the CPU from the same threefry weights and batches; the loss and every
    parameter within 1e-5 of max(1, max |leaf|). Then the refusal: flash
    attention under grad raises on the card."""
    from repro_torch import configs, tree
    from repro_torch.core import prng
    from repro_torch.launch import steps
    from repro_torch.models import build

    worst = {}
    for arch in configs.ARCH_IDS:
        cfg = configs.get_smoke_config(arch)
        one = build(cfg).init(prng.PRNGKey(0), "cpu")
        stacked = tree.map(lambda leaf: torch.stack([leaf, leaf * 1.1]), one)
        batch = pod_batch(torch, cfg, TRAIN_SMOKE_SHAPE, 2, "cpu")
        step = steps.make_train_step(cfg, lr=TRAIN_LR,
                                     grad_accum=TRAIN_ACCUM, remat=True)
        new_c, loss_c = step(stacked, batch)
        new_g, loss_g = step(tree.map(lambda leaf: leaf.to(dev), stacked),
                             {k: v.to(dev) for k, v in batch.items()})
        err = max([leaf_err(a.cpu(), b) for a, b in zip(
            tree.leaves(new_g), tree.leaves(new_c))]
            + [leaf_err(loss_g.cpu(), loss_c)])
        if not err <= 1e-5:
            fail(f"train smoke {arch}: card vs CPU differ by {err} of "
                 "max(1, max |leaf|) (tol 1e-5)")
        worst[arch] = err
    print(f"train smoke, one step each (2 pods, ga {TRAIN_ACCUM}, remat, "
          f"{TRAIN_SMOKE_SHAPE}), card vs CPU, loss and params of max(1, "
          f"max |leaf|): " + ", ".join(f"{a} {e:.2g}"
                                      for a, e in worst.items())
          + " (tol 1e-5)", flush=True)
    cfg = configs.get_smoke_config(LM_ARCH)
    one = build(cfg).init(prng.PRNGKey(0), dev)
    stacked = tree.map(lambda leaf: leaf[None], one)
    batch = pod_batch(torch, cfg, TRAIN_SMOKE_SHAPE, 1, dev)
    try:
        steps.make_train_step(cfg, attn_impl="pallas")(stacked, batch)
    except RuntimeError as err:
        if "cannot differentiate" not in str(err):
            raise
        print(f"train refusal on the card: attn_impl='pallas' under grad "
              f"raises: {str(err)[:100]}...", flush=True)
    else:
        fail("train: flash_attention under grad did not raise on the card")


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def spmd_phase(torch, dev) -> dict:
    """``train_path``'s step (mamba2-780m at full width and depth, two pods
    x ``TRAIN_SHAPE``, ``grad_accum`` 2, remat) with every SPMD knob on
    (``grad_pspecs`` + ``mesh``, ``act_sharding`` batch over 'data',
    ``spmd_pod``) on DTensors laid out by ``launch.sharding`` over a
    (pod, data, model) = (1, 1, 1) mesh of a world-1 NCCL group, against
    the same step unsharded from the same weights and batches: params and
    loss within 1e-6 of max(1, max |leaf|), the ``ssd_scan`` and
    ``ssd_scan_bwd`` launch counts equal (the kernels run on the local
    shards), ms of each step. Returns the sharded step's launch counts."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import configs, tree
    from repro_torch.core import dispatch
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch.hlo_analysis import CollectiveTrace

    cfg = configs.get_config(TRAIN_ARCH)
    one = build_params(torch, cfg, dev)
    stacked = tree.map(lambda leaf: torch.stack([leaf] * TRAIN_PODS), one)
    batch = pod_batch(torch, cfg, TRAIN_SHAPE, TRAIN_PODS, dev)
    kw = dict(lr=TRAIN_LR, grad_accum=TRAIN_ACCUM, remat=True)
    dispatch.reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ref, ref_loss = steps.make_train_step(cfg, **kw)(stacked, batch)
    torch.cuda.synchronize()
    ref_ms = 1e3 * (time.perf_counter() - t1)
    ref_counts = dispatch.launch_counts()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1, 1),
                                mesh_dim_names=("pod", "data", "model"))
        pspecs = sh.param_pspecs(one, mesh)
        del one
        spec = configs.InputShape("train", TRAIN_SHAPE[1],
                                  TRAIN_PODS * TRAIN_SHAPE[0], "train")
        params = sh.distribute(stacked, sh.stack_pspecs_for_pods(pspecs,
                                                                 mesh), mesh)
        del stacked
        dbatch = sh.distribute(batch, sh.batch_pspecs(cfg, spec, mesh), mesh)
        step = steps.make_train_step(
            cfg, **kw, grad_pspecs=pspecs, mesh=mesh,
            act_sharding=sh.NamedSharding(mesh, ("data", None, None)),
            spmd_pod=True)
        dispatch.reset_launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with CollectiveTrace() as trace:
            new, loss = step(params, dbatch)
        torch.cuda.synchronize()
        spmd_ms = 1e3 * (time.perf_counter() - t1)
        counts = dispatch.launch_counts()
        err = max([leaf_err(a.to_local(), b) for a, b in zip(
            tree.leaves(new), tree.leaves(ref))]
            + [leaf_err(loss, ref_loss)])
    finally:
        dist.destroy_process_group()
    L = cfg.num_layers
    expect = expect_only(ssd_scan=2 * L * TRAIN_ACCUM * TRAIN_PODS,
                         ssd_scan_bwd=L * TRAIN_ACCUM * TRAIN_PODS)
    if counts != ref_counts or counts != expect:
        fail(f"spmd: launch counts {counts}, unsharded {ref_counts}, "
             f"formula {expect}")
    if not err <= 1e-6:
        fail(f"spmd: the sharded step differs from the unsharded one by "
             f"{err} of max(1, max |leaf|) (tol 1e-6)")
    print(f"spmd {TRAIN_ARCH}: one train step (full width and depth, "
          f"{TRAIN_PODS} pods x {TRAIN_SHAPE}, ga {TRAIN_ACCUM}, remat) with "
          f"grad_pspecs + mesh, act_sharding and spmd_pod on a (1, 1, 1) "
          f"NCCL mesh of DTensors: params and loss within {err:.3g} of the "
          f"unsharded step's (tol 1e-6); launches ssd_scan "
          f"{counts['ssd_scan']}, ssd_scan_bwd {counts['ssd_scan_bwd']} = "
          f"the unsharded step's; {len(trace.ops)} collectives traced; "
          f"{spmd_ms:.1f} ms (unsharded {ref_ms:.1f} ms, host clock, "
          "synchronised)", flush=True)
    del params, dbatch, new, ref, batch
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def build_params(torch, cfg, dev):
    """``cfg``'s params from a CUDA ``torch.Generator`` seeded 0 (the
    weights ``train_path`` trains)."""
    from repro_torch.models import build
    return build(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)


def roofline_phase() -> dict:
    """The analytic FLOPs and bytes (``launch.roofline_model``) of the LM
    runs this script timed, at the card's shapes: the granite-3-2b and
    mamba2-780m prefills and the mamba2-780m train step (its two pods'
    batches as one global batch, ``grad_accum`` 2, remat). Bytes at the
    port's f32 weights and activations; t_compute at the FP32 peak (the
    port's strict f32), t_memory at HBM's rate, and the measured time's
    share of the larger. No run of its own: it reads ``MEASURED``."""
    from repro_torch import configs
    from repro_torch.launch import roofline_model as rm

    rows = (("lm prefill", LM_ARCH, configs.InputShape(
                "prefill", PREFILL_LEN, PREFILL_BATCH, "prefill"), 1),
            (f"{SSM_ARCH} prefill", SSM_ARCH, configs.InputShape(
                "prefill", SSM_PREFILL[1], SSM_PREFILL[0], "prefill"), 1),
            ("train step", TRAIN_ARCH, configs.InputShape(
                "train", TRAIN_SHAPE[1], TRAIN_PODS * TRAIN_SHAPE[0],
                "train"), TRAIN_ACCUM))
    out = {}
    for label, arch, shape, ga in rows:
        cfg = configs.get_config(arch)
        flops = rm.step_flops(cfg, shape)
        hbm = rm.step_bytes(cfg, shape, grad_accum=ga,
                            act_bytes=rm.FP32)["total"]
        t_c = flops["ideal"] / rm.peak_flops("fp32") * 1e3
        t_m = hbm / rm.H100_SXM["hbm_bytes_per_s"] * 1e3
        ms = MEASURED[label]
        out[label] = dict(flops=flops["ideal"], flops_xla=flops[
            "xla_fallback"], hbm_bytes=hbm, t_compute_ms=t_c,
            t_memory_ms=t_m, measured_ms=ms, share=max(t_c, t_m) / ms)
        print(f"roofline {label} ({arch}, {shape.global_batch} x "
              f"{shape.seq_len}{', ga %d, remat' % ga if ga > 1 else ''}): "
              f"{flops['ideal']:.4g} FLOP (masked {flops['xla_fallback']:.4g}"
              f"), {hbm:.4g} bytes at f32; t_compute {t_c:.2f} ms at 67 "
              f"TFLOP/s FP32, t_memory {t_m:.2f} ms at 3.35 TB/s; measured "
              f"{ms:.1f} ms = {100 * max(t_c, t_m) / ms:.1f}% of the "
              "roofline", flush=True)
    return out


DRYRUN_COMBOS = (("granite-8b", "train_4k", False),
                 ("mamba2-780m", "train_4k", True),
                 ("granite-3-2b", "decode_32k", False))


def dryrun_child(out: str) -> None:
    """The child process of :func:`dryrun_phase`: ``DRYRUN_COMBOS`` on the
    meta device in fake worlds of 256 and 512 ranks; their artifacts to
    ``out`` as one JSON object."""
    import torch
    from repro_torch.launch import dryrun
    torch.set_num_threads(1)
    res = {}
    for arch, shape, multi in DRYRUN_COMBOS:
        res[f"{arch} {shape} {'2x16x16' if multi else '16x16'}"] = \
            dryrun.lower_combo(arch, shape, multi_pod=multi, verbose=False)
    with open(out, "w") as f:
        json.dump(res, f)


def start_dryrun():
    """:func:`dryrun_child` in a child process (its fake process group
    never meets this process's NCCL one), on the CPU, after the timed
    phases: (process, output path)."""
    out = os.path.join(ROOT, "build", "dryrun_phase.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if os.path.exists(out):
        os.remove(out)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--dryrun-child", out],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, out


def dryrun_phase(proc, out: str) -> dict:
    """The dry run's results (:func:`start_dryrun`): each combo's
    collective bytes by type and count, Eq. 5's, and this rank's argument
    and output bytes; the child's wall seconds."""
    try:
        log, _ = proc.communicate(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"dryrun: the child outlasted {DRYRUN_TIMEOUT} s")
    if proc.returncode != 0 or not os.path.exists(out):
        fail(f"dryrun: the child failed:\n{log[-3000:]}")
    with open(out) as f:
        res = json.load(f)
    for tag, r in res.items():
        coll = r["roofline"]["collective_bytes"]
        if coll["count"] <= 0 or coll["all-gather"] <= 0:
            fail(f"dryrun {tag}: no collective recorded: {coll}")
        ext = r.get("external_sync_collective_bytes")
        print(f"dryrun {tag} (meta device, fake world of {r['chips']}): "
              f"{coll['count']} collectives on rank 0, bytes "
              + ", ".join(f"{k} {v:.4g}" for k, v in coll.items()
                          if k != "count" and v)
              + (f"; Eq. 5 {ext['all-reduce']:.4g} bytes in "
                 f"{ext['count']} all-reduce" if ext else "")
              + f"; per rank: arguments "
              f"{r['memory_analysis']['argument_size_in_bytes'] / 1e9:.3f} "
              f"GB, outputs "
              f"{r['memory_analysis']['output_size_in_bytes'] / 1e9:.3f} GB;"
              f" t_compute {r['roofline']['t_compute_s'] * 1e3:.2f} ms, "
              f"t_memory {r['roofline']['t_memory_s'] * 1e3:.2f} ms, "
              f"t_collective {r['roofline']['t_collective_s'] * 1e3:.2f} ms "
              f"at the H100 peaks ({r['roofline']['bottleneck']}); run "
              f"{r['lower_s']} s", flush=True)
    return res


def train_phase(torch, dev) -> tuple[dict, dict]:
    """LM training (the FEDGS pod train step): the ssd_scan backward
    against its plain version, mamba2-780m trained at full width and
    depth, the cut-depth comparisons, every smoke config card vs CPU."""
    t_phase = time.perf_counter()
    entry = check_ssd_scan_bwd(torch, dev)
    counts = train_path(torch, dev)
    counts = {"train": counts, "train_spmd": spmd_phase(torch, dev)}
    train_cut_checks(torch, dev)
    train_smoke_card_vs_cpu(torch, dev)
    print(f"train phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts, entry


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
               check_topk_compress(torch, dev), check_int8(torch, dev, probe),
               check_corrupt_rows(torch, dev, probe),
               check_dirichlet_rows(torch, dev, probe)]
    torch.cuda.synchronize()

    print(f"kernel checks: {time.perf_counter() - t0:.1f} s since the "
          "start", flush=True)

    # each path at full width: R rounds of T iterations, eval every E
    t_phase = time.perf_counter()
    rounds, iters, every, m = 2, 3, 2, 10
    flags = main_flags(rounds, iters, every)
    main_expect = {"gbp_cs": rounds * iters,
                   "conv_fused": 2 * rounds * iters + 2 * (rounds // every),
                   "agg_weighted": rounds, "robust_agg": 0,
                   "topk_compress": 0, "int8_quant": 0, "flash_attention": 0,
                   "ssd_scan": 0, "ssd_scan_bwd": 0, "corrupt_rows": 0,
                   "dirichlet_rows": 0,
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

    print(f"host loop paths: {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # fused path (the device-resident engine, --engine fused): one CUDA
    # graph per round at full width, without and with compression, each
    # beside its host loop's counts and ms/iteration; smoke card vs CPU
    t_phase = time.perf_counter()
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
          f"before, {torch.cuda.memory_allocated() / 1e9:.3f} GB after; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    # the group-sharded engine (--engine sharded): world 1 == fused, two
    # gloo ranks on the one card against world 1, smoke card vs CPU
    sharded_counts = sharded_phase(torch, dev, main_expect)

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
    avail_counts, avail_entry = avail_phase(torch, dev, probe)
    kernels.append(avail_entry)

    # the lazy population (DESIGN.md §17): a million devices on both
    # engines and the baselines, each resident device's Dirichlet row drawn
    # by dirichlet_rows with its factory's concentrations
    pop_counts, pop_entry = population_phase(torch, dev, probe)
    entry = next(k for k in kernels if k["name"] == "dirichlet_rows")
    for name, row in pop_entry["rows"].items():
        entry.update({f"{name}_{key}": v for key, v in row.items()})
    entry["population_peak_bytes"] = {
        f"{e} D={d}": v for (e, d), v in pop_entry["peaks"].items()}

    # the trainer's public surface: the Fig. 4 samplers, host-batched
    # evaluation, --ckpt-dir and the three example scripts
    tools_counts, tools_nums = tools_phase(torch, dev)
    entry = next(k for k in kernels if k["name"] == "gbp_cs")
    entry["fig4"] = tools_nums["samplers"]
    entry = next(k for k in kernels if k["name"] == "conv_fused")
    entry["evaluate_ms"] = tools_nums["evaluate_ms"]

    # LM path (the dense-LM serving slice): the kernel at the prefill
    # shape, then the full-width prefill, decode and serve, then the smoke
    # config card vs CPU
    t_phase = time.perf_counter()
    kernels.append(check_flash_attention(torch, dev))
    lm_counts = lm_path(torch, dev)
    lm_smoke_card_vs_cpu(torch, dev)

    print(f"lm phase: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # SSM and hybrid paths (the Mamba2 serving slice): the scan kernel at
    # both prefill shapes, then mamba2-780m (one scan per layer) and
    # zamba2-7b (one scan per layer, one flash launch per segment of
    # attn_every layers) at full width and depth, mamba2's serve(), and
    # both smoke configs card vs CPU
    from repro_torch import configs
    t_phase = time.perf_counter()
    kernels.append(check_ssd_scan(torch, dev))
    ssm_cfg, hyb_cfg = configs.get_config(SSM_ARCH), \
        configs.get_config(HYBRID_ARCH)
    ssm_counts = ssm_path(
        torch, dev, SSM_ARCH,
        random_tokens(torch, dev, ssm_cfg.vocab_size, SSM_PREFILL),
        {"ssd_scan": ssm_cfg.num_layers})
    serve_phase(torch, SSM_ARCH,
                ssm_cfg.with_(num_layers=SERVE_DEPTH[SSM_ARCH]), dev)
    n_seg = -(-hyb_cfg.num_layers // hyb_cfg.attn_every)
    hybrid_counts = ssm_path(
        torch, dev, HYBRID_ARCH,
        random_tokens(torch, dev, hyb_cfg.vocab_size, HYBRID_PREFILL),
        {"ssd_scan": hyb_cfg.num_layers, "flash_attention": n_seg})
    for arch in (SSM_ARCH, HYBRID_ARCH):
        lm_smoke_card_vs_cpu(torch, dev, arch, arch)
    print(f"ssm and hybrid phases: {time.perf_counter() - t_phase:.1f} s; "
          f"{time.perf_counter() - t0:.1f} s since the start", flush=True)

    # MoE paths (the MoE serving slice): deepseek-v2-236b (MLA + MoE +
    # shared experts; flash at D = 192, Dv = 128) and dbrx-132b (GQA + MoE)
    # at full width, depth cut to fit the card; both smoke configs card vs
    # CPU. The MLA kernel rows were checked in check_flash_attention.
    t_phase = time.perf_counter()
    moe_counts = {f"moe_{arch}": moe_path(torch, dev, arch)
                  for arch in (MLA_ARCH, MOE_ARCH)}
    for arch in (MLA_ARCH, MOE_ARCH):
        lm_smoke_card_vs_cpu(torch, dev, arch, arch)
    print(f"moe phases: {time.perf_counter() - t_phase:.1f} s; "
          f"{time.perf_counter() - t0:.1f} s since the start", flush=True)

    # the VLM (internvl2-26b, a vision prefix; depth cut to fit the card)
    # and enc-dec (whisper-large-v3, full depth; the flash kernel in the
    # encoder, the decoder and the cross attention at Sq != Sk) serving
    # slices; both smoke configs card vs CPU
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    vlm_counts = vlm_path(torch, dev)
    vlm_smoke_card_vs_cpu(torch, dev)
    encdec_counts, encdec_cross_counts = encdec_path(torch, dev)
    encdec_smoke_card_vs_cpu(torch, dev)
    print(f"vlm and encdec phases: {time.perf_counter() - t_phase:.1f} s; "
          f"{time.perf_counter() - t0:.1f} s since the start", flush=True)

    # LM training (the FEDGS pod train step): the ssd_scan backward at the
    # sweep and both full-width shapes, mamba2-780m trained at full width
    # and depth (two pods, Eq. 5 each round), the full-width comparisons at
    # 4 layers, the ten smoke configs card vs CPU, the refusal under grad
    gc.collect()
    torch.cuda.empty_cache()
    train_counts, bwd_entry = train_phase(torch, dev)
    kernels.append(bwd_entry)
    print(f"{time.perf_counter() - t0:.1f} s since the start", flush=True)

    # the roofline shares of the LM runs timed above, and the meta-device
    # dry run's collectives: its child starts after the last timed phase,
    # so that its CPU load overlaps no timed run
    dryrun_proc = start_dryrun()
    roofline_phase()
    dryrun_phase(*dryrun_proc)
    print(f"{time.perf_counter() - t0:.1f} s since the start", flush=True)

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
                        for p, c in sharded_counts.items()})
        by_path.update({p: c.get(k["name"], 0)
                        for p, c in drift_counts.items()})
        by_path.update({p: c.get(k["name"], 0)
                        for p, c in avail_counts.items()})
        by_path.update({p: c.get(k["name"], 0)
                        for p, c in pop_counts.items()})
        by_path.update({p: c.get(k["name"], 0)
                        for p, c in tools_counts.items()})
        by_path.update({p: c[k["name"]] for p, c in moe_counts.items()})
        by_path.update({"vlm": vlm_counts[k["name"]],
                        "encdec": encdec_counts[k["name"]],
                        "encdec_cross": encdec_cross_counts[k["name"]],
                        "train": train_counts["train"][k["name"]],
                        "train_spmd": train_counts["train_spmd"][k["name"]]})
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
    if sys.argv[1:2] == ["--dryrun-child"]:
        dryrun_child(sys.argv[2])
    else:
        main()
