"""Federated training entry point of the port: Alg. 1 on the FEMNIST CNN.

Runs FEDGS (host engine) end to end on the synthetic FEMNIST stream with
the paper's hyperparameters as defaults (M=10, K=35, L=10, L_rnd=2, T=50,
R=500, η=0.01, n=32). The flags are the JAX CLI's (``python -m
repro.launch.train``) for the ported paths, plus ``--device``; from the
same ``--seed`` both print the same round lines.

  PYTHONPATH=src python -m repro_torch.launch.train --rounds 20 --iters 10
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --smoke-model --groups 4 --devices-per-group 8 --selected 4 \\
      --presampled 1 --iters 5 --rounds 3 --batch-size 8 --lr 0.05

Corruption robustness (DESIGN.md §15): ``--corrupt`` injects gradient
faults into a deterministic faulty-device subset, ``--robust-agg`` swaps
the Eq. 4 internal sync for a robust aggregator, and repeat offenders are
quarantined out of GBP-CS after ``--quarantine-limit`` flags:

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --corrupt scale+nan_burst --corrupt-frac 0.2 \\
      --robust-agg trimmed_mean --quarantine-limit 3

Communication-efficient sync (DESIGN.md §18): ``--compress-int`` /
``--compress-ext`` compress the Eq. 4 (device↔BS) and Eq. 5 (BS↔cloud)
payloads independently — top-k sparsification and/or stochastic int8
quantization, each with per-group error feedback (DESIGN.md §18.1); every
round's ``bytes_int`` / ``bytes_ext`` ledger and ``compress_error`` go to
``--log-json`` (the round lines do not change):

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --compress-int topk:0.01+int8 --compress-ext int8

``--train-step model_avg`` runs the paper's literal L one-step models.

``--engine fused`` runs the device-resident engine (DESIGN.md §7, §12):
labels, counts and images drawn on the device from the threefry key
chain, each round one CUDA graph on the card (eager on the CPU), the
metrics read back once per ``--eval-chunk`` rounds. It prints the JAX
CLI's ``--engine fused`` round lines, the robust flags included (the
fault trace of every device staged with the round's keys, quarantine
counters in the carried state):

  PYTHONPATH=src python -m repro_torch.launch.train --engine fused \\
      --corrupt scale+nan_burst+gauss_noise --corrupt-frac 0.2 \\
      --robust-agg trimmed_mean --quarantine-limit 3

``--strategy`` runs any of the fourteen Table II baselines instead of
FEDGS (DESIGN.md §12.4): ``--clients-per-round`` clients (0 = groups ×
selected) drawn per round from the device pool, ``--local-steps`` local
SGD steps each, the server average through the ``agg_weighted`` kernel.
``--engine host`` loops over the pool's batches round by round; any other
engine (``sharded`` included, as in the JAX CLI) runs the fused engine,
one CUDA graph per round on the card. FedGS-only flags draw a warning:

  PYTHONPATH=src python -m repro_torch.launch.train --strategy fedyogi \
      --engine fused --rounds 20

Dynamic environments (DESIGN.md §13): ``--drift`` evolves every device's
class distribution with the internal iteration t (``step_shift`` at
``--drift-t0``, ``rotate``, ``redraw`` and ``churn`` every
``--drift-period`` iterations, the last two drawing Dirichlet
(``--drift-alpha``) rows, ``churn`` for a ``--drift-churn`` fraction of
devices), on both engines and for the baselines (round r at t = r·T);
``--reselect-every N`` rebuilds the super nodes every N iterations (0 =
once, at t = 0) and re-scores the carried ones between rebuilds:

  PYTHONPATH=src python -m repro_torch.launch.train --engine fused \
      --drift redraw --drift-period 2 --reselect-every 2

Availability (DESIGN.md §14): ``--avail`` makes devices drop out
(``bernoulli`` at ``--avail-up-prob``, ``markov`` churn with mean sojourn
``--avail-dwell``) or straggle (``straggler_tail``: a
``--avail-straggler-frac`` tail ``--avail-slow-factor``× slower), a
latency above ``--avail-deadline`` missing the iteration;
``--avail-selection blind`` hides the up-mask from GBP-CS; ``--sync
bounded_async`` keeps missed committee members in Eq. 4 at
``--gamma``^staleness (capped at ``--max-staleness``) through each group's
carried gradient, on both engines and composed with the robust and
compress flags; the round lines gain ``part`` and ``stale mean/max``:

  PYTHONPATH=src python -m repro_torch.launch.train --engine fused \
      --avail markov --avail-up-prob 0.6 --sync bounded_async

The lazy population (DESIGN.md §17): ``--devices D`` (or
``--population-per-group`` K_pop = D / M) draws each factory's devices
as a pure function of their flat id, never materialized; the engine
trains ``--devices-per-group`` slots a group, bound to a candidate
committee redrawn every ``--reselect-every`` iterations when K_pop is
larger. On both engines and for the baselines' pool; the resident
devices' Dirichlet rows are drawn on the card each iteration:

  PYTHONPATH=src python -m repro_torch.launch.train --engine fused \
      --devices 1000000 --groups 8 --devices-per-group 16 --reselect-every 10

``--engine sharded`` raises for FEDGS (ROADMAP item 17).

It runs on the GPU, where the GBP-CS loop, both conv layers, the Eq. 4/5
averages, the fault injection, the robust order statistics, the top-k
selection (DESIGN.md §18.2), the stochastic int8 quantizer, the drift's
and the population's Dirichlet draws and the availability trace run as
the port's CUDA kernels; ``--device cpu`` runs their plain PyTorch
versions instead.
Asking for ``cuda`` without a card is an error.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch

from ..configs import femnist_cnn
from ..core import baselines, fedgs, prng, sync
from ..data import (AVAILABILITY_SCHEDULES, CORRUPTION_MODES,
                    DRIFT_SCHEDULES, AvailabilityConfig, CorruptionConfig,
                    DeviceBackedStreams, DeviceStream, DriftConfig,
                    FactoryStreams, HostClientPool, LazyPopulation,
                    PartitionConfig, PopulationConfig, femnist,
                    make_availability_fn, make_client_pool,
                    make_corruption_fn, make_device_sampler, make_partition)
from ..models import cnn

STRATEGIES = ("fedgs",) + tuple(sorted(baselines.all_strategies(
    cnn.make_model_api(femnist_cnn.CONFIG))))
# flags of the FEDGS path that a baseline strategy ignores (with a warning)
FEDGS_ONLY = ("train_step", "selection", "init", "reselect_every", "avail",
              "sync", "corrupt", "robust_agg", "quarantine_limit",
              "compress_int", "compress_ext")


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
    ap.add_argument("--strategy", choices=STRATEGIES, default="fedgs",
                    help="fedgs (Alg. 1) or any Table II baseline strategy")
    ap.add_argument("--groups", type=int, default=10, help="M factories")
    ap.add_argument("--devices-per-group", type=int, default=35, help="K^m")
    ap.add_argument("--selected", type=int, default=10, help="L")
    ap.add_argument("--presampled", type=int, default=2, help="L_rnd")
    ap.add_argument("--iters", type=int, default=50, help="T per round")
    ap.add_argument("--rounds", type=int, default=500, help="R")
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--clients-per-round", type=int, default=0,
                    help="baseline strategies: C sampled clients per round "
                         "(default M*L — matches FEDGS participation)")
    ap.add_argument("--local-steps", type=int, default=10,
                    help="baseline strategies: local mini-batch steps")
    ap.add_argument("--selection", choices=("gbp_cs", "random"),
                    default="gbp_cs")
    ap.add_argument("--engine", choices=("host", "fused", "sharded"),
                    default="host",
                    help="host loop / device-resident fused rounds (one CUDA "
                         "graph per round on the card) / sharded (not "
                         "ported for fedgs: ROADMAP item 17; the baselines "
                         "run it as fused)")
    ap.add_argument("--eval-chunk", type=int, default=1,
                    help="fused: rounds per host read-back of the metrics "
                         "(0 = auto, 1 = per round)")
    ap.add_argument("--train-step", choices=("grad_avg", "model_avg"),
                    default="grad_avg",
                    help="Eq. 4 in gradient space (one update per group) / "
                         "the paper's literal L one-step models (oracle)")
    ap.add_argument("--drift", choices=DRIFT_SCHEDULES, default="static",
                    help="dynamic environment: drift schedule of the "
                         "per-device class distributions (DESIGN.md §13)")
    ap.add_argument("--drift-t0", type=int, default=50,
                    help="step_shift: first shifted internal iteration")
    ap.add_argument("--drift-period", type=int, default=50,
                    help="rotate/redraw/churn: iterations per drift epoch")
    ap.add_argument("--drift-alpha", type=float, default=0.3,
                    help="redraw/churn: Dirichlet concentration of re-drawn "
                         "device distributions")
    ap.add_argument("--drift-churn", type=float, default=0.25,
                    help="churn: expected fraction of devices replaced "
                         "per epoch")
    ap.add_argument("--reselect-every", type=int, default=1,
                    help="GBP-CS rebuild cadence in internal iterations "
                         "(1 = every iteration, N = every N, 0 = static "
                         "super nodes; fedgs only, DESIGN.md §13)")
    ap.add_argument("--avail", choices=AVAILABILITY_SCHEDULES,
                    default="always",
                    help="device availability / straggler schedule "
                         "(DESIGN.md §14; fedgs only)")
    ap.add_argument("--avail-up-prob", type=float, default=0.9,
                    help="bernoulli/markov: stationary up-probability")
    ap.add_argument("--avail-dwell", type=int, default=8,
                    help="markov: internal iterations per on/off epoch")
    ap.add_argument("--avail-straggler-frac", type=float, default=0.15,
                    help="straggler_tail: fraction of slow devices")
    ap.add_argument("--avail-slow-factor", type=float, default=4.0,
                    help="straggler_tail: latency multiplier of the tail")
    ap.add_argument("--avail-deadline", type=float, default=3.0,
                    help="latency budget; draws above it miss the iteration")
    ap.add_argument("--sync", choices=("sync", "bounded_async"),
                    default="sync",
                    help="missed committee members: drop (sync, with "
                         "churn-triggered reselection) or keep at "
                         "gamma^staleness weight (bounded_async)")
    ap.add_argument("--gamma", type=float, default=0.5,
                    help="bounded_async staleness decay γ")
    ap.add_argument("--max-staleness", type=int, default=4,
                    help="bounded_async staleness cap")
    ap.add_argument("--avail-selection", choices=("aware", "blind"),
                    default="aware",
                    help="whether GBP-CS sees the up-mask (aware) or "
                         "ignores it (blind — the ablation baseline)")
    ap.add_argument("--corrupt", default="none",
                    help="gradient corruption mode(s), '+'-joined from "
                         f"{CORRUPTION_MODES} (DESIGN.md §15.1; 'none' "
                         "disables injection)")
    ap.add_argument("--corrupt-frac", type=float, default=0.2,
                    help="fraction of devices that are faulty")
    ap.add_argument("--corrupt-prob", type=float, default=0.5,
                    help="per-iteration fault firing probability of a "
                         "faulty device")
    ap.add_argument("--corrupt-t0", type=int, default=0,
                    help="first internal iteration faults can fire")
    ap.add_argument("--corrupt-scale", type=float, default=25.0,
                    help="scale mode: gradient blow-up factor")
    ap.add_argument("--corrupt-sigma", type=float, default=1.0,
                    help="gauss_noise mode: additive noise stddev")
    ap.add_argument("--robust-agg", choices=sync.ROBUST_AGGREGATORS,
                    default="mean",
                    help="Eq. 4 internal aggregator (DESIGN.md §15.2; "
                         "'mean' is the exact historical path)")
    ap.add_argument("--robust-clip", type=float, default=10.0,
                    help="clip_norm: per-member gradient L2 norm cap (also "
                         "the outlier-flag threshold for quarantine)")
    ap.add_argument("--robust-trim", type=int, default=1,
                    help="trimmed_mean: members trimmed per extreme end")
    ap.add_argument("--quarantine-limit", type=int, default=3,
                    help="outlier flags before a device is barred from "
                         "selection (0 disables quarantine)")
    ap.add_argument("--compress-int", default="none",
                    help="Eq. 4 device->BS gradient compression "
                         "(DESIGN.md §18): 'none', 'topk:FRAC', 'int8' or "
                         "'topk:FRAC+int8' — top-k sparsification and/or "
                         "stochastic int8, with per-group error feedback")
    ap.add_argument("--compress-ext", default="none",
                    help="Eq. 5 BS->cloud round-delta compression, same "
                         "grammar as --compress-int")
    ap.add_argument("--no-nan-guard", action="store_true",
                    help="disable the per-iteration NaN/Inf rollback guard "
                         "(DESIGN.md §15.3)")
    ap.add_argument("--population-per-group", type=int, default=0,
                    help="lazy population (DESIGN.md §17): PHYSICAL devices "
                         "per factory, evaluated as a pure function of the "
                         "flat device id — never materialized. The engine "
                         "still trains K = --devices-per-group slots per "
                         "group, rebound to fresh candidate ids every "
                         "--reselect-every iterations. 0 = historical dense "
                         "partition")
    ap.add_argument("--devices", type=int, default=0,
                    help="total population size shorthand: sets "
                         "--population-per-group to --devices / --groups "
                         "(must divide evenly). Scales to millions with "
                         "flat memory — see README 'Scaling to millions of "
                         "devices'")
    ap.add_argument("--init", choices=("mpinv", "zero", "random"),
                    default="mpinv")
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


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    """The flags, with ``k_pop`` derived from ``--devices`` /
    ``--population-per-group`` (0: the dense partition), refused as the
    JAX CLI refuses them."""
    ap = build_parser()
    args = ap.parse_args(argv)
    k_pop = args.population_per_group
    if args.devices:
        if args.devices % args.groups:
            ap.error("--devices must be divisible by --groups")
        k_pop = args.devices // args.groups
    if k_pop and k_pop < args.devices_per_group:
        ap.error("--population-per-group / --devices per factory must be "
                 ">= --devices-per-group (the engine slots draw from it)")
    args.k_pop = k_pop
    return args


def format_record(rec: fedgs.RoundRecord) -> str:
    msg = f"round {rec.round:4d} | loss {rec.loss:.4f}"
    if not math.isnan(rec.divergence):
        msg += f" | divergence {rec.divergence:.4f}"
    if not math.isnan(rec.group_discrepancy):
        msg += (f" | disc {rec.group_discrepancy:.4f}"
                f" | resel {rec.reselections:.0f}")
    if not math.isnan(rec.participation):
        msg += f" | part {rec.participation:.2f}"
    if not math.isnan(rec.staleness_mean):
        msg += (f" | stale {rec.staleness_mean:.2f}"
                f"/{rec.staleness_max:.0f}")
    if not math.isnan(rec.clipped_fraction):
        msg += (f" | corr {rec.corrupted_selected:.0f}"
                f" | clip {rec.clipped_fraction:.2f}"
                f" | rb {rec.rollbacks:.0f}")
    if rec.test_accuracy is not None:
        msg += (f" | test acc {rec.test_accuracy:.4f} "
                f"loss {rec.test_loss:.4f}")
    return msg


def drift_config(args) -> DriftConfig | None:
    """The ``--drift*`` flags' schedule (None for ``static``)."""
    if args.drift == "static":
        return None
    return DriftConfig(schedule=args.drift, t0=args.drift_t0,
                       period=args.drift_period, alpha=args.drift_alpha,
                       churn_rate=args.drift_churn)


def avail_fn_of(args):
    """The ``--avail*`` flags' schedule (None for ``always``)."""
    return make_availability_fn(AvailabilityConfig(
        schedule=args.avail, up_prob=args.avail_up_prob,
        dwell=args.avail_dwell, straggler_frac=args.avail_straggler_frac,
        slow_factor=args.avail_slow_factor, deadline=args.avail_deadline),
        args.seed)


def run_fedgs(args, part, pop, p_real, params, eval_fn, log_fn) -> None:
    """Alg. 1 on the host loop or the fused engine: numpy
    ``FactoryStreams`` of the dense ``part`` on the host loop without a
    drift, else the device sampler over ``pop()``, the population view
    (dense or lazy), built when first needed."""
    fcfg = fedgs.FedGSConfig(
        num_groups=args.groups, devices_per_group=args.devices_per_group,
        num_selected=args.selected, num_presampled=args.presampled,
        iters_per_round=args.iters, rounds=args.rounds, lr=args.lr,
        selection=args.selection, init=args.init, seed=args.seed,
        reselect_every=args.reselect_every, sync=args.sync,
        gamma=args.gamma, max_staleness=args.max_staleness,
        avail_selection=args.avail_selection,
        train_step=args.train_step, robust_agg=args.robust_agg,
        robust_clip=args.robust_clip, robust_trim=args.robust_trim,
        quarantine_limit=args.quarantine_limit,
        nan_guard=not args.no_nan_guard, compress_int=args.compress_int,
        compress_ext=args.compress_ext)
    corrupt_fn = None if args.corrupt == "none" else make_corruption_fn(
        CorruptionConfig(
            mode=args.corrupt, frac=args.corrupt_frac,
            prob=args.corrupt_prob, t0=args.corrupt_t0,
            scale=args.corrupt_scale, sigma=args.corrupt_sigma), args.seed)
    if args.engine == "sharded":
        raise NotImplementedError("--engine sharded (the group-sharded "
                                  "engine, DESIGN.md §8) is ROADMAP item 17")
    drift = drift_config(args)
    # candidate committees only when the universe exceeds the engine
    # slots; equal sizes keep the dense slot binding
    make_sampler = lambda: make_device_sampler(
        pop(), drift=drift,
        candidates=args.devices_per_group
        if args.k_pop > args.devices_per_group else None,
        candidate_every=args.reselect_every)
    if args.engine == "fused":
        fedgs.run_fedgs_fused(params, make_sampler(), p_real, fcfg,
                              group_loss_fn=cnn.make_group_loss_fn(),
                              avail_fn=avail_fn_of(args),
                              corrupt_fn=corrupt_fn, eval_fn=eval_fn,
                              eval_every=args.eval_every, log_fn=log_fn,
                              chunk=args.eval_chunk)
    else:
        # a drifting environment and the lazy population live on the
        # device stream (pure in (t, id)); the host loop replays it
        # through DeviceBackedStreams, as the JAX CLI does
        streams = FactoryStreams(part, batch_size=args.batch_size,
                                 seed=args.seed) \
            if drift is None and part is not None else \
            DeviceBackedStreams(make_sampler())
        fedgs.run_fedgs(params, streams, p_real, fcfg,
                        group_loss_fn=cnn.make_group_loss_fn(),
                        avail_fn=avail_fn_of(args),
                        corrupt_fn=corrupt_fn, eval_fn=eval_fn,
                        eval_every=args.eval_every, log_fn=log_fn)


def run_strategy(args, pop, params, mcfg, device, eval_fn, log_fn) -> None:
    """A Table II baseline (the JAX CLI's branch): FedGS-only flags warn,
    the clients come from the device pool over ``pop()``, eval sees the
    global params."""
    defaults = build_parser()
    for flag in FEDGS_ONLY:
        if getattr(args, flag) != defaults.get_default(flag):
            print(f"warning: --{flag.replace('_', '-')} applies only to "
                  f"--strategy fedgs; ignored for {args.strategy}",
                  file=sys.stderr)
    model = cnn.make_model_api(mcfg, device)
    strategy = baselines.all_strategies(model)[args.strategy]
    clients = args.clients_per_round or args.groups * args.selected
    bcfg = baselines.BaselineConfig(
        clients_per_round=clients, local_steps=args.local_steps, lr=args.lr,
        rounds=args.rounds, seed=args.seed)
    # the baselines share FEDGS's environment clock: round r sits at t = r·T
    pool = make_client_pool(pop(), clients=clients, steps=args.local_steps,
                            drift=drift_config(args),
                            iters_per_round=args.iters)
    data = HostClientPool(pool) if args.engine == "host" else pool
    baselines.run_baseline(model, strategy, data, bcfg,
                           eval_fn=lambda pe: eval_fn(pe[0]),
                           eval_every=args.eval_every, params=params,
                           chunk=args.eval_chunk, log_fn=log_fn)


def main(argv: list[str] | None = None) -> list[dict]:
    """Run the CLI; returns the per-round records as dicts."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.k_pop:
        # the lazy universe (DESIGN.md §17) holds O(resident) memory
        # however large D = M·K_pop gets; its p_real is analytic, with no
        # build loop
        lazy = LazyPopulation(PopulationConfig(
            num_factories=args.groups, devices_per_factory=args.k_pop,
            alpha=args.alpha, batch_size=args.batch_size, seed=args.seed),
            device)
        part, p_real, pop = None, lazy.p_real, lambda: lazy
    else:
        part = make_partition(PartitionConfig(
            num_factories=args.groups,
            devices_per_factory=args.devices_per_group, alpha=args.alpha,
            seed=args.seed))
        p_real = part.p_real
        pop = lambda: DeviceStream.from_partition(
            part, batch_size=args.batch_size, seed=args.seed, device=device)
    test_x, test_y = femnist.make_test_set(n_per_class=20)
    eval_fn = cnn.make_eval_fn(test_x, test_y, device)
    mcfg = femnist_cnn.smoke_config() if args.smoke_model \
        else femnist_cnn.CONFIG
    params = cnn.init_cnn(prng.PRNGKey(args.seed), mcfg, device)
    logs_out = []

    def log_fn(rec):
        print(format_record(rec), flush=True)
        logs_out.append(rec.to_dict())

    if args.strategy == "fedgs":
        run_fedgs(args, part, pop, p_real, params, eval_fn, log_fn)
    else:
        run_strategy(args, pop, params, mcfg, device, eval_fn, log_fn)
    if args.log_json:
        os.makedirs(os.path.dirname(args.log_json) or ".", exist_ok=True)
        with open(args.log_json, "w") as f:
            json.dump(logs_out, f, indent=1)
    return logs_out


if __name__ == "__main__":
    main()
