"""The typed per-round log record shared by the host loop and the CLI, and
the chunked multi-round driver of the device-resident engine (the JAX
package's ``core/engine.py``, DESIGN.md §12).

An :class:`Experiment` is a ``round_fn(state, r) -> (state', metrics)``
whose metrics are tensors left on the device; :func:`run_experiment` runs
``chunk`` rounds per host read-back, evaluating on the device every
``eval_every`` rounds, and turns each chunk's stacked metrics into
:class:`RoundRecord` s (:func:`records_from_metrics`).
:class:`SegmentedGraph` captures a function as CUDA graphs, split where
it calls an op that a graph cannot hold; :class:`GraphedRound` runs one
round of an experiment eagerly or as such a capture, replayed, its state
in static tensors (the fused FEDGS round and the fused baselines, DESIGN.md
§12.4).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .. import tree
from . import dispatch

_NAN = float("nan")


class RoundRecord(NamedTuple):
    """One federated round's log entry (the JAX package's field set).

    ``test_loss``/``test_accuracy`` are None on rounds without eval. The
    telemetry fields are NaN where a run does not report them:
    ``group_discrepancy`` is the mean per-group discrepancy of the groups'
    data distribution vs the global one, ``selection_distance`` the GBP-CS
    objective ``d`` of the last rebuild, ``reselections`` the number of
    GBP-CS rebuilds this round, ``bytes_int`` the round's device↔BS bytes
    (Eq. 4, download + upload per seated contributor over all T
    iterations) and ``bytes_ext`` the BS↔cloud bytes (Eq. 5, 2·payload·M),
    the payload being 4|θ| dense and smaller under §18 compression;
    ``compress_error`` is the mean EF residual norm of a compressed run.
    The availability fields stay NaN on the port's path; the robustness
    fields are set on the robust path.
    """
    round: int
    loss: float
    divergence: float = _NAN
    test_loss: float | None = None
    test_accuracy: float | None = None
    strategy: str = ""
    group_discrepancy: float = _NAN
    selection_distance: float = _NAN
    reselections: float = _NAN
    participation: float = _NAN
    staleness_mean: float = _NAN
    staleness_max: float = _NAN
    dark_selected: float = _NAN
    corrupted_selected: float = _NAN
    clipped_fraction: float = _NAN
    rollbacks: float = _NAN
    agg_residual: float = _NAN
    bytes_int: float = _NAN
    bytes_ext: float = _NAN
    compress_error: float = _NAN

    def to_dict(self) -> dict:
        d = dict(self._asdict())
        for k in _OPTIONAL_METRICS:
            if math.isnan(d[k]):          # runs without the telemetry
                d[k] = None               # (strict-JSON safe, unlike NaN)
        return d


_OPTIONAL_METRICS = ("divergence", "group_discrepancy", "selection_distance",
                     "reselections", "participation", "staleness_mean",
                     "staleness_max", "dark_selected", "corrupted_selected",
                     "clipped_fraction", "rollbacks", "agg_residual",
                     "bytes_int", "bytes_ext", "compress_error")


def records_from_metrics(r0: int, metrics: dict, *, strategy: str = ""
                         ) -> list[RoundRecord]:
    """Stacked per-chunk metrics -> per-round typed records.

    ``metrics`` maps name -> (chunk,) array or tensor; recognized names:
    ``loss``, ``test_loss``, ``test_accuracy`` (NaN = no eval that round),
    and the telemetry names in ``_OPTIONAL_METRICS``."""
    host = {k: np.asarray(torch.as_tensor(v).cpu(), np.float64)
            for k, v in metrics.items()}
    n = len(next(iter(host.values())))
    recs = []
    for i in range(n):
        tl = host.get("test_loss", [_NAN] * n)[i]
        ta = host.get("test_accuracy", [_NAN] * n)[i]
        recs.append(RoundRecord(
            round=r0 + i,
            loss=float(host["loss"][i]) if "loss" in host else _NAN,
            test_loss=None if math.isnan(tl) else float(tl),
            test_accuracy=None if math.isnan(ta) else float(ta),
            strategy=strategy,
            **{k: float(host[k][i]) for k in _OPTIONAL_METRICS if k in host},
        ))
    return recs


@dataclasses.dataclass(frozen=True)
class Experiment:
    """One federated-learning experiment, engine-agnostic.

    ``round_fn(state, r) -> (state', metrics)`` runs round ``r`` on the
    device; ``metrics`` is a dict of 0-d tensors with the same keys every
    round, left on the device. ``params_fn(state)`` extracts the evaluable
    global parameters; ``eval_fn(params) -> (test_loss, test_accuracy)``
    returns 0-d tensors (``models.cnn.make_eval_fn``)."""
    name: str
    init_state: Any
    round_fn: Callable[[Any, int], tuple[Any, dict]]
    params_fn: Callable[[Any], Any]
    eval_fn: Callable[[Any], tuple[Any, Any]] | None = None


def default_chunk(rounds: int, eval_every: int = 0) -> int:
    """Rounds per host read-back when the caller doesn't say: the eval
    period when there is one, else 8."""
    chunk = eval_every if eval_every > 0 else 8
    return max(1, min(chunk, rounds))


def run_experiment(
    exp: Experiment,
    rounds: int,
    *,
    eval_every: int = 0,
    chunk: int = 0,
    log_fn: Callable[[RoundRecord], None] | None = None,
    on_chunk: Callable[[int, int], None] | None = None,
) -> tuple[Any, list[RoundRecord]]:
    """Run ``rounds`` rounds of ``exp``, reading the metrics back once per
    chunk of ``chunk`` rounds (0 = :func:`default_chunk`); with
    ``exp.eval_fn`` set and ``eval_every`` > 0, evaluate on the device
    after every ``eval_every``-th round. ``on_chunk(r0, n)`` fires after
    each read-back. Returns (final state, one :class:`RoundRecord` per
    round)."""
    eval_on = eval_every if exp.eval_fn is not None else 0
    chunk = chunk or default_chunk(rounds, eval_on)
    chunk = max(1, min(chunk, rounds))
    state = exp.init_state
    logs: list[RoundRecord] = []
    r0 = 0
    while r0 < rounds:
        n = min(chunk, rounds - r0)
        mets: list[dict] = []
        for r in range(r0, r0 + n):
            state, m = exp.round_fn(state, r)
            m = dict(m)
            if eval_on > 0:
                if (r + 1) % eval_on == 0:
                    tl, ta = exp.eval_fn(exp.params_fn(state))
                else:
                    tl = ta = torch.tensor(_NAN)
                m["test_loss"], m["test_accuracy"] = tl, ta
            mets.append(m)
        stacked = {k: torch.stack([torch.as_tensor(m[k], dtype=torch.float32)
                                   .to(mets[0]["loss"].device) for m in mets])
                   for k in mets[0]}
        recs = records_from_metrics(r0, stacked, strategy=exp.name)
        logs.extend(recs)
        if log_fn is not None:
            for rec in recs:
                log_fn(rec)
        if on_chunk is not None:
            on_chunk(r0, n)
        r0 += n
    return state, logs


def num_dispatches(rounds: int, chunk: int) -> int:
    """⌈R/chunk⌉ — the host read-backs an experiment costs on this
    engine."""
    return math.ceil(rounds / max(1, chunk))


_CAPTURE_STREAMS: dict[int, "torch.cuda.Stream"] = {}


def capture_stream() -> "torch.cuda.Stream":
    """The process's one side stream (per card) for graph warm-ups and
    captures. cuBLAS keeps a workspace for every stream that runs a GEMM
    for the life of the process, so a new stream per capture would leave
    one behind each time."""
    idx = torch.cuda.current_device()
    if idx not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[idx] = torch.cuda.Stream(idx)
    return _CAPTURE_STREAMS[idx]


class SegmentedGraph:
    """A function captured as CUDA graphs, split at the ops a graph cannot
    hold (an op that reads a status back to the host, as the SVD of
    ``torch.linalg.pinv`` does). Inside :meth:`capture`, :meth:`eager`
    ends the current graph, returns a static output tensor and begins the
    next graph; :meth:`replay` replays the graphs in order and runs each
    such op eagerly between two of them, from its static input into its
    static output. The graphs share one memory pool and replay in capture
    order, so a tensor made in one segment is safe to read in the next.
    A capture that fails raises; nothing falls back to the eager loop."""

    def __init__(self):
        self.graphs: list[torch.cuda.CUDAGraph] = []
        self.breaks: list[tuple[Callable, torch.Tensor, torch.Tensor]] = []
        self._pool = None

    @contextlib.contextmanager
    def capture(self):
        self._pool = torch.cuda.graph_pool_handle()
        stream = capture_stream()
        stream.wait_stream(torch.cuda.current_stream())
        torch.cuda.synchronize()
        with torch.cuda.stream(stream):
            self._begin()
            try:
                yield self
            finally:
                self.graphs[-1].capture_end()
        torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize()

    def _begin(self) -> None:
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self._pool)
        self.graphs.append(graph)

    def eager(self, fn: Callable, x: torch.Tensor, shape: tuple
              ) -> torch.Tensor:
        """``fn(x)`` as a break between two graphs: (replayed) ``out`` of
        ``shape`` and x's dtype receives ``fn(x)``."""
        self.graphs[-1].capture_end()
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        self.breaks.append((fn, x, out))
        self._begin()
        return out

    def replay(self) -> None:
        for i, graph in enumerate(self.graphs):
            graph.replay()
            if i < len(self.breaks):
                fn, x, out = self.breaks[i]
                out.copy_(fn(x))


class GraphedRound:
    """One round of an experiment, :meth:`step` ``(carry, inputs, segs,
    variant) -> (carry', metrics)``, run eagerly or (``graph``) as CUDA
    graphs.

    :meth:`run` copies the round's host-staged ``material`` (int64 words:
    keys, ids) into the static ``inputs`` buffer and runs the step. A
    round's ``variant`` (hashable, host-known: the FEDGS round's pattern of
    rebuild and keep iterations, DESIGN.md §13) selects what the step
    traces. With ``graph``, the first call of each variant runs one eager
    warm-up round on the capture stream (outputs dropped), hands its
    cached blocks back, and captures the step in a :class:`SegmentedGraph`
    of its own (``segs``; None in eager runs), with its own memory pool:
    the carry lives in static tensors that every variant's graphs read and
    overwrite with the round's outputs, and every call replays its
    variant's graphs. Nothing reads back to the host inside a round, so a
    capture that fails raises.

    Kernel launch counters move where a wrapper launches, so in a graphed
    run they count the warm-ups and the captures only: :attr:`captures`
    holds each variant's capture counts (:attr:`captured` and
    :attr:`segments` are the last run variant's), and a run's launches
    are those times each variant's replays."""

    def __init__(self, size: int, device, graph: bool):
        self.graph = graph
        self.inputs = torch.zeros(size, dtype=torch.int64, device=device)
        self.static = None
        self.graphs: dict[Any, tuple[SegmentedGraph, dict]] = {}
        self.captures: dict[Any, dict[str, int]] = {}
        self.segments: SegmentedGraph | None = None
        self.captured: dict[str, int] | None = None
        self.replays = 0

    def step(self, carry, inputs: torch.Tensor, segs, variant):
        raise NotImplementedError

    def run(self, carry, material: np.ndarray, variant=None):
        self.inputs.copy_(torch.from_numpy(material), non_blocking=True)
        if not self.graph:
            return self.step(carry, self.inputs, None, variant)
        if self.static is None:
            self.static = (tree.map(torch.clone, carry), None)
        else:
            for dst, src in zip(tree.leaves(self.static[0]),
                                tree.leaves(carry)):
                if dst is not src:
                    dst.copy_(src)
        if variant not in self.graphs:
            self._capture(variant)
        self.segments, mets = self.graphs[variant]
        self.captured = self.captures[variant]
        self.segments.replay()
        self.replays += 1
        self.static = (self.static[0], mets)
        return self.static[0], {name: v.clone() for name, v in mets.items()}

    def _capture(self, variant) -> None:
        static = self.static[0]
        side = capture_stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):        # warm-up, outputs dropped
            self.step(static, self.inputs, None, variant)
        torch.cuda.current_stream().wait_stream(side)
        # the warm-up's cached blocks cannot serve the graph's private
        # pool: hand them back first (the robust round's member stacks
        # are 2.64 GB each at full width)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        segments = SegmentedGraph()
        before = dispatch.launch_counts()
        with segments.capture() as segs:
            out, mets = self.step(static, self.inputs, segs, variant)
            for dst, src in zip(tree.leaves(static), tree.leaves(out)):
                dst.copy_(src)
        after = dispatch.launch_counts()
        self.captures[variant] = {name: after[name] - before[name]
                                  for name in after}
        self.graphs[variant] = (segments, mets)
