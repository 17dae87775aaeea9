"""Time this checkout's ``corrupt_rows``, ``dirichlet_rows``,
``int8_quant`` and ``avail_rows`` kernels against other checkouts' on one
card, in turns.

  python3 scripts/rng_kernels_ab.py [--turns N] OTHER_CHECKOUT [...]

Runs a child process per checkout in turns, the others, this, this, the
others in reverse, N / 2 times over (N = 2 by default, so each checkout
runs N turns), each with its own checkout's ``src`` on the path (each
builds its kernel library into its own ``build/``). A child times, on
inputs drawn from fixed seeds:

- ``corrupt_rows`` on the robust path's member buffer (M·L, P4) = (100,
  6,603,712) with the CLI's fault trace at its first iteration that seats
  a Gaussian row (``scale+nan_burst+gauss_noise``), eagerly (CUDA events
  over 20 calls) and per launch inside a CUDA graph of 50; then that
  trace's byte rows alone and its Gaussian rows alone (the other codes set
  to 0), every row ``scale`` and every row Gaussian, eagerly;
- ``dirichlet_rows`` at the drift's (350, 62), α = 0.3, on a ``redraw``
  trace (every row drawn) and a ``churn`` one, and with one concentration
  per element at the lazy population's (350, 62) and its table's (10, 62)
  priors, each eagerly (the best of 5 runs of 100 calls: an eager call
  is the host wrapper's time, which varies by tens of percent between
  runs) and per launch in a graph of 50;
- ``int8_quant`` on the compress path's two inputs, (10, 6,603,712)
  gradient rows: the internal link's (``topk_compress.select`` at k = 1%
  of |θ|, 99% exact zeros) and the external link's (dense), eagerly (CUDA
  events over 20 calls) and per launch in a graph of 50, and each device
  kernel of one call alone (``torch.profiler`` over 20 eager calls, the
  mean device time of each kernel whose name holds ``int8``);
- ``avail_rows`` at the CLI's 350 ids (up_prob 0.6) for each schedule at
  t = 5 and 4,095, per launch in a graph of 50;

and prints one JSON line: those ms, and a checksum of each output's bits
(both checkouts see the same inputs, so equal sums mean equal bits). The
parent prints the card's name and power limit, each turn's line, and each
checkout's times per measurement with their median and range.

  python3 scripts/rng_kernels_ab.py --split

times this checkout's ``int8_quant`` and ``avail_rows`` against timing-only
variants of their sources (``SPLITS``: the quantization replaced by a copy,
the row barrier or the hashes taken out, the markov steps on other warp
counts), each built by nvcc beside the library and called through ctypes on
the same inputs; a variant that changes the arithmetic is marked so. The
parts that hold a kernel short of its bound are read from the differences.

An eager ``dirichlet_rows`` call costs the host wrapper's time, which moves
with the process more than with the kernel. So, last, one process of this
checkout loads every checkout's kernel library (each built by its turns)
and times the four eager calls through this checkout's wrapper, the
libraries in turns (20 rounds of 100 calls each, the order flipped every
round), and prints each library's median and range. Needs one card.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = r"""
import ctypes, glob, json, math, os, sys, numpy as np, torch
sys.path.insert(0, "src")
from repro_torch import tree
from repro_torch.configs import femnist_cnn
from repro_torch.core import engine, prng
from repro_torch.data import (CorruptionConfig, DriftConfig, LazyPopulation,
                              PartitionConfig, PopulationConfig,
                              make_corruption_fn, make_device_sampler,
                              make_drift_fn, make_partition)
from repro_torch.core import compress
from repro_torch.data import AvailabilityConfig, make_availability_fn
from repro_torch.kernels import (corrupt as kc, dirichlet as kd,
                                 int8_quant as kq, topk_compress as ktop)
from repro_torch.models import cnn

dev = torch.device("cuda")

def time_ms(fn, reps, warmup=2):
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

def graph_ms(fn, n=50, reps=5):
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
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b) / n)
    return best

def eager_ms(fn):
    return min(time_ms(fn, 100) for _ in range(5))

def bits_sum(t):
    return int(t.contiguous().view(torch.int32).to(torch.int64).sum())

def kernel_split_ms(fn, tag, reps=20):
    # mean device time per call of each kernel whose name holds ``tag``
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and tag in e.key}

def dirichlet_calls():
    # the drift's redraw and churn at (350, 62), alpha 0.3; the population's
    # (350, 62) and its table's (10, 62) priors, one alpha per element
    calls = {}
    part = make_partition(PartitionConfig(num_factories=10,
                                          devices_per_factory=35, seed=0))
    base = torch.as_tensor(part.class_probs.reshape(350, 62), device=dev)
    for sched in ("redraw", "churn"):
        fn = make_drift_fn(DriftConfig(schedule=sched, period=2), 0, 62)
        trace = fn.device_trace(2, np.arange(350), dev)
        calls[sched] = (lambda trace=trace, a=fn.config.alpha:
                        kd.drift_rows(base, trace, a))
    pop = LazyPopulation(PopulationConfig(num_factories=10,
                                          devices_per_factory=100_000), dev)
    staged = torch.as_tensor(make_device_sampler(
        pop, candidates=35, candidate_every=3).seats(0, np.arange(10)),
        device=dev).reshape(-1, pop.staged_words)
    prior = np.zeros((10, 4), np.int64)
    prior[:, 2:] = prng.fold_in(pop._k_prior, np.arange(10))
    cases = {"population": (staged[:, 1:].contiguous(),
                            pop.table[staged[:, 1]].contiguous()),
             "prior": (torch.as_tensor(prior, device=dev),
                       torch.ones(10, 62, device=dev))}
    for name, (trace, alpha) in cases.items():
        calls[name] = (lambda trace=trace, alpha=alpha:
                       kd.draw_rows(trace, alpha))
    return calls
"""

CHILD = PRELUDE + r"""
out = {}
params = cnn.init_cnn(prng.PRNGKey(0), femnist_cnn.CONFIG, dev)
sizes = [leaf.numel() for leaf in tree.leaves(params)]
del params
m, l, k = 10, 10, 35
p = sum(sizes)
p4 = -(-p // 4) * 4
cfn = make_corruption_fn(CorruptionConfig(
    mode="scale+nan_burst+gauss_noise"), 0)
seats = np.arange(m)[:, None] * k + np.arange(l)
gauss = 1 + cfn.modes.index("gauss_noise")
scale = 1 + cfn.modes.index("scale")
t = next(t for t in range(1, 100)
         if (cfn.trace(t, seats, len(sizes))[0] == gauss).any())
code, keys = cfn.device_trace(t, seats.reshape(-1), len(sizes), dev)
gen = torch.Generator(device=dev).manual_seed(6)
x = torch.randn(m * l, p4, generator=gen, device=dev) * 1e-2
x[:, p:] = 0.0
fills = {"typical": code,
         "bytes": torch.where(code == gauss, 0, code),
         "gauss": torch.where(code == gauss, code, 0),
         "all_scale": torch.full_like(code, scale),
         "all_gauss": torch.full_like(code, gauss)}
buf = x.clone()
for fill, c in fills.items():
    buf.copy_(x)
    cfn.apply(buf, c, keys, sizes)
    out[f"corrupt_{fill}_sum"] = bits_sum(buf)
    call = lambda: cfn.apply(buf, c, keys, sizes)
    out[f"corrupt_{fill}_ms"] = time_ms(call, 3 if fill == "all_gauss"
                                        else 20)
    if fill == "typical":
        out["corrupt_typical_graph_ms"] = graph_ms(call)
del buf, x
torch.cuda.empty_cache()

for name, call in dirichlet_calls().items():
    out[f"dirichlet_{name}_sum"] = bits_sum(call())
    out[f"dirichlet_{name}_ms"] = eager_ms(call)
    out[f"dirichlet_{name}_graph_ms"] = graph_ms(call)

# the compress path's rows: gradient-like (10, P4), per-row scales
# 1e-4..1e-1, heavy-tailed by a cube, the pads zero; the internal link
# quantizes their top 1% (chip_smoke.gradient_rows, check_int8)
p = 6_603_710
gen = torch.Generator(device=dev).manual_seed(5)
x = torch.randn(10, p4, generator=gen, device=dev) ** 3
x *= torch.logspace(-4, -1, 10, device=dev)[:, None]
x[:, p:] = 0.0
qkeys = torch.as_tensor(prng.split(prng.PRNGKey(7), 10).astype(np.int64),
                        device=dev)
for link, rows in (("sparse", ktop.select(x, compress.topk_count(p, 0.01))),
                   ("dense", x)):
    call = lambda rows=rows: kq.quantize(rows, qkeys)
    out[f"int8_{link}_sum"] = bits_sum(call())
    out[f"int8_{link}_ms"] = time_ms(call, 20)
    out[f"int8_{link}_graph_ms"] = graph_ms(call)
    out[f"int8_{link}_split_ms"] = kernel_split_ms(call, "int8")
    del rows
del x
torch.cuda.empty_cache()

ids = torch.arange(350, device=dev)
for kind in ("bernoulli", "markov", "straggler_tail"):
    fn = make_availability_fn(AvailabilityConfig(schedule=kind,
                                                 up_prob=0.6), 0)
    for t in (5, 4095):
        tt = torch.full((), t, dtype=torch.int64, device=dev)
        call = lambda fn=fn, tt=tt: fn(tt, ids)
        mask, lat = call()
        out[f"avail_{kind}_{t}_sum"] = bits_sum(mask) + bits_sum(lat)
        out[f"avail_{kind}_{t}_graph_ms"] = graph_ms(call)
print(json.dumps(out))
"""

SAME_PROCESS = PRELUDE + r"""
from repro_torch.kernels import build
libs = {".": build.library()}
for other in sys.argv[1:]:
    path = max(glob.glob(f"{other}/build/repro_torch_kernels/*.so"),
               key=os.path.getmtime)
    lib = ctypes.CDLL(path)
    lib.dirichlet_rows_f32.argtypes = build.SIGNATURES["dirichlet_rows_f32"]
    lib.dirichlet_rows_f32.restype = ctypes.c_int
    libs[other] = lib
calls = dirichlet_calls()
res = {name: {key: [] for key in libs} for name in calls}
sums = {name: set() for name in calls}
for rnd in range(20):
    for key in (list(libs) if rnd % 2 == 0 else list(libs)[::-1]):
        build._LIB = libs[key]
        for name, call in calls.items():
            sums[name].add(bits_sum(call()))
            res[name][key].append(time_ms(call, 100))
build._LIB = libs["."]
print(json.dumps({"ms": res, "same_bits": {name: len(v) == 1
                                           for name, v in sums.items()}}))
"""


# timing-only variants of this checkout's sources: (source, [(text, its
# replacement)], whether the output bits stay the plain version's)
INT8_COPY = ("if (__reduce_add_sync(0xffffffffu, nonzero) > kDense) {",
             "if (true) { for (int v = 0; v < kV; ++v) { const int j = base + "
             "v * 32 + lane; if (j < s.w1) yr[s0 + j] = f[v]; } continue;")
INT8_NO_BARRIER = ("if (ld_acquire(arrivals) < target) {", "if (false) {")
SPLITS = {
    "int8 kernel": ("int8_quant.cu", [], True),
    "int8 as a copy (its reads, writes, max and barriers)": (
        "int8_quant.cu", [INT8_COPY], False),
    "int8 as a copy without the row barrier": (
        "int8_quant.cu", [INT8_COPY, INT8_NO_BARRIER], False),
    "int8 without the dense rows' hashes": ("int8_quant.cu", [(
        "threefry::threefry2x32_n<kCoords>(k0, k1, c, h0, h1);",
        "for (int b = 0; b < kCoords; ++b) { h0[b] = c[b] * 0x9E3779B9u; "
        "h1[b] = k0[b]; }")], False),
    "avail kernel (4 step warps)": ("avail_rows.cu", [], True),
    "avail on 8 step warps": ("avail_rows.cu", [(
        "constexpr int kStepWarps = 4;", "constexpr int kStepWarps = 8;")],
        True),
    "avail on 3 step warps": ("avail_rows.cu", [(
        "constexpr int kStepWarps = 4;", "constexpr int kStepWarps = 3;")],
        True),
    "avail on 2 step warps": ("avail_rows.cu", [(
        "constexpr int kStepWarps = 4;", "constexpr int kStepWarps = 2;")],
        True),
}

SPLIT = PRELUDE + r"""
import subprocess
from repro_torch.data import AvailabilityConfig, make_availability_fn
from repro_torch.kernels import avail as ka, build
splits = json.loads(sys.argv[1])
out_dir = os.path.join("build", "rng_kernels_ab")
os.makedirs(out_dir, exist_ok=True)
procs = {}
for i, (name, (src, subs, _)) in enumerate(splits.items()):
    text = open(os.path.join(build.CSRC, src)).read()
    for old, new in subs:
        if old not in text:
            sys.exit(f"split {name}: {old!r} not in {src}")
        text = text.replace(old, new)
    path = os.path.join(out_dir, f"split{i}.cu")
    open(path, "w").write(text)
    so = path[:-3] + ".so"
    procs[name] = (so, subprocess.Popen(
        [build.find_nvcc(), build.ARCH, "-std=c++17", "-O3", "-Xcompiler",
         "-fPIC", "-shared", "-I", str(build.CSRC), path, "-o", so],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
fns = {}
for name, (so, proc) in procs.items():
    log, _ = proc.communicate()
    if proc.returncode:
        sys.exit(f"split {name}: nvcc failed: {log}")
    entry = "int8_quant_f32" if name.startswith("int8") else "avail_rows_f32"
    fn = getattr(ctypes.CDLL(so), entry)
    fn.argtypes, fn.restype = build.SIGNATURES[entry], ctypes.c_int
    fns[name] = fn
stream = lambda: torch.cuda.current_stream().cuda_stream
out = {}
p, p4 = 6_603_710, 6_603_712
gen = torch.Generator(device=dev).manual_seed(5)
x = torch.randn(10, p4, generator=gen, device=dev) ** 3
x *= torch.logspace(-4, -1, 10, device=dev)[:, None]
x[:, p:] = 0.0
keys = torch.as_tensor(prng.split(prng.PRNGKey(7), 10).astype(np.int64),
                       device=dev)
kt = keys.to(torch.int32).contiguous()
y = torch.empty_like(x)
scratch = torch.empty(11, dtype=torch.int32, device=dev)
for link, rows in (("sparse", ktop.select(x, compress.topk_count(p, 0.01))),
                   ("dense", x)):
    ref = kq.quantize(rows, keys).view(torch.int32)
    for name, fn in fns.items():
        if not name.startswith("int8"):
            continue
        call = lambda fn=fn, rows=rows: build.check(fn(
            rows.data_ptr(), kt.data_ptr(), y.data_ptr(), scratch.data_ptr(),
            10, p4, stream()), name)
        call()
        out[f"{name} | {link}"] = dict(
            same_bits=torch.equal(y.view(torch.int32), ref),
            ms=min(time_ms(call, 20) for _ in range(3)),
            graph_ms=min(graph_ms(call) for _ in range(3)))
del x, y
torch.cuda.empty_cache()
ids = torch.arange(350, device=dev)
mask, lat = (torch.empty(350, device=dev) for _ in range(2))
for kind in ka.SCHEDULES:
    fn_ = make_availability_fn(AvailabilityConfig(schedule=kind,
                                                  up_prob=0.6), 0)
    sch = fn_.schedule
    key, kl = (np.asarray(k, np.uint32) for k in (sch.key, sch.k_lat))
    for t in (5, 4095):
        tt = torch.full((), t, dtype=torch.int64, device=dev)
        ref = fn_(tt, ids)
        for name, fn in fns.items():
            if not name.startswith("avail"):
                continue
            call = lambda fn=fn, tt=tt: build.check(fn(
                ids.data_ptr(), tt.data_ptr(), mask.data_ptr(),
                lat.data_ptr(), 350, ka.SCHEDULES.index(kind), int(key[0]),
                int(key[1]), int(kl[0]), int(kl[1]), float(sch.prob),
                float(sch.p_ud), float(sch.p_du), sch.horizon,
                float(sch.slow), float(sch.deadline), stream()), name)
            call()
            out[f"{name} | {kind} t={t}"] = dict(
                same_bits=torch.equal(mask, ref[0])
                and torch.equal(lat, ref[1]),
                graph_ms=min(graph_ms(call) for _ in range(5)))
print(json.dumps(out))
"""


def turn(checkout: str, program: str = CHILD, args=()) -> dict:
    res = subprocess.run([sys.executable, "-c", program, *args],
                         cwd=checkout, capture_output=True, text=True,
                         timeout=900)
    if res.returncode != 0:
        sys.exit(f"rng_kernels_ab: {checkout} failed:\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def split() -> None:
    """This checkout's kernels against the ``SPLITS`` variants, one
    process."""
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    for name, row in turn(HERE, SPLIT, [json.dumps(SPLITS)]).items():
        exact = SPLITS[name.split(" | ")[0]][2]
        print(f"{name}: " + ", ".join(
            f"{k} {v:.5f}" for k, v in row.items() if k != "same_bits")
            + ("; bits equal to the kernel's" if row["same_bits"] else
               "; bits differ" + (" (A FAULT)" if exact else "")),
            flush=True)


def main() -> None:
    if sys.argv[1:] == ["--split"]:
        return split()
    args, turns = sys.argv[1:], 2
    if args[:1] == ["--turns"] and len(args) > 1:
        turns, args = int(args[1]), args[2:]
    if not args or turns < 2 or turns % 2:
        sys.exit(__doc__)
    others = [os.path.abspath(a) for a in args]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    order = (others + [HERE, HERE] + others[::-1]) * (turns // 2)
    runs = {path: [] for path in others + [HERE]}
    for path in order:
        row = turn(path)
        runs[path].append(row)
        print(f"{os.path.relpath(path, HERE)}: {json.dumps(row)}", flush=True)
    for key in runs[HERE][0]:
        if key.endswith("_split_ms"):
            for path, rows in runs.items():
                print(f"{key}: {os.path.relpath(path, HERE)} "
                      f"{[r[key] for r in rows]}", flush=True)
            continue
        if key.endswith("_sum"):
            same = len({r[key] for rows in runs.values() for r in rows}) == 1
            print(f"{key}: {'equal in every turn' if same else 'DIFFERS'}",
                  flush=True)
            continue
        print(f"{key}: " + "; ".join(
            f"{os.path.relpath(path, HERE)} "
            f"{[round(r[key], 5) for r in rows]}, median "
            f"{statistics.median(r[key] for r in rows):.5f}, range "
            f"{min(r[key] for r in rows):.5f}-"
            f"{max(r[key] for r in rows):.5f}"
            for path, rows in runs.items()), flush=True)
    same = turn(HERE, SAME_PROCESS, others)
    print(f"one process, the libraries in turns: {json.dumps(same)}",
          flush=True)
    for name, by_lib in same["ms"].items():
        print(f"dirichlet_{name}_ms, one process: " + "; ".join(
            f"{os.path.relpath(os.path.join(HERE, key), HERE)} median "
            f"{statistics.median(v):.5f}, range {min(v):.5f}-{max(v):.5f}"
            for key, v in by_lib.items())
            + f"; same bits {same['same_bits'][name]}", flush=True)


if __name__ == "__main__":
    main()
