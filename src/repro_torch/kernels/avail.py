"""The availability trace of DESIGN.md §14: for a vector of flat device
ids at internal iteration t, each device's effective up-mask (the latency
deadline folded in) and its latency draw, under the ``bernoulli``,
``markov`` or ``straggler_tail`` schedule (``data.streaming.AvailFn``).

:func:`avail_rows` is the CUDA kernel ``csrc/avail_rows.cu`` (one warp per
id; the markov chain's steps split over the lanes, each step a map of the
state bit, the lanes' maps composed by a warp reduction) for CUDA tensors
and :func:`avail_rows_plain` for CPU tensors. Both read t from an int64
tensor on the ids' device (a Python int is put there first), so a CUDA
graph captures the call with t staged in its input buffer and one graph
serves every iteration. Every draw is ``jax.random``'s, bit for bit: a
device's key is ``fold_in(fold_in(k, id), t)`` (markov: ``fold_in(
fold_in(k, id), s)`` for s = 0, the initial state, and s = 1 … t mod
horizon), its number one threefry hash of the counter (0, 0).
There is no Pallas kernel behind it: the JAX package draws the trace with
``jax.random.bernoulli``/``uniform`` under ``vmap`` in
``make_availability_fn``; the kernel is the port's own.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import prng
from . import build

NAME = "avail_rows"
SOURCE = "src/repro_torch/csrc/avail_rows.cu"
REPLACES = ("none: jax.random.bernoulli/uniform under vmap in "
            "src/repro/data/streaming.py:319-406 (make_availability_fn)")
LAUNCHES = 0

SCHEDULES = ("bernoulli", "markov", "straggler_tail")


class Schedule(NamedTuple):
    """One schedule's constants, as the kernel takes them: the schedule's
    key (``bernoulli``: 1, ``markov``: 2, ``straggler_tail``: 4 off the
    availability base key) and the latency key (9), uint32 words; ``prob``
    is ``up_prob`` (``straggler_frac`` for the tail); the comparison
    constants are float32, as JAX compares a float32 draw with a Python
    float: ``p_ud`` = f32((1 − up_prob)/dwell), ``p_du`` =
    f32(up_prob/dwell), ``slow`` and ``deadline``."""
    kind: str
    key: np.ndarray
    k_lat: np.ndarray
    prob: np.float32
    p_ud: np.float32
    p_du: np.float32
    horizon: int
    slow: np.float32
    deadline: np.float32


def _unit(keys: torch.Tensor, lo: float = 0.0, hi: float = 1.0
          ) -> torch.Tensor:
    """``jax.random.uniform(key, (), lo, hi)`` for each key of an int64
    key tensor (..., 2)."""
    return prng._uniform_from_bits(prng.random_bits_t(keys, ()), lo, hi)


def hashes(kind: str, n: int, tm: int) -> int:
    """Threefry hashes the trace of ``n`` ids takes at t mod horizon =
    ``tm``: latency 3 (two ``fold_in`` and the draw); ``bernoulli`` 3 more;
    ``straggler_tail`` 2; ``markov`` 3 (the id's key, the initial state's
    key and draw) and 2 a step."""
    extra = {"bernoulli": 3, "straggler_tail": 2, "markov": 3 + 2 * tm}
    return n * (3 + extra[kind])


def _check(ids: torch.Tensor, sched: Schedule) -> None:
    if ids.dim() != 1:
        raise ValueError(f"avail_rows: ids of shape {tuple(ids.shape)}, "
                         "expected (R,)")
    if sched.kind not in SCHEDULES:
        raise ValueError(f"avail_rows: unknown schedule {sched.kind!r}")
    if sched.horizon < 1:
        raise ValueError(f"avail_rows: horizon {sched.horizon} < 1")


def _t_tensor(t, device) -> torch.Tensor:
    """t as a 0-d int64 tensor on ``device`` (filled there: no host
    copy)."""
    if isinstance(t, torch.Tensor):
        return t.reshape(()).to(torch.int64)
    return torch.full((), int(t), dtype=torch.int64, device=device)


def avail_rows_plain(ids: torch.Tensor, t, sched: Schedule
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: ids (R,) integer, t an int or 0-d
    integer tensor → (mask (R,), latency (R,)) float32, vectorised over
    the ids with ``prng``'s key-tensor threefry; the markov chain is a
    Python loop over its steps."""
    _check(ids, sched)
    t = int(t)
    ids = ids.to(torch.int64)
    lat = _unit(prng.fold_in_t(prng.fold_in_t(sched.k_lat, ids), t), 0.5,
                1.5)
    if sched.kind == "straggler_tail":
        tail = _unit(prng.fold_in_t(sched.key, ids)) < float(sched.prob)
        lat = torch.where(tail, lat * float(sched.slow), lat)
        return (lat <= float(sched.deadline)).float(), lat
    if sched.kind == "bernoulli":
        up = _unit(prng.fold_in_t(prng.fold_in_t(sched.key, ids), t)) \
            < float(sched.prob)
    else:
        base = prng.fold_in_t(sched.key, ids)
        up = _unit(prng.fold_in_t(base, 0)) < float(sched.prob)
        for s in range(1, t % sched.horizon + 1):
            u = _unit(prng.fold_in_t(base, s))
            up = torch.where(up, u >= float(sched.p_ud),
                             u < float(sched.p_du))
    return (up & (lat <= float(sched.deadline))).float(), lat


def avail_rows(ids: torch.Tensor, t, sched: Schedule
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mask, latency) of the devices ``ids`` (R,) at iteration ``t`` (an
    int, or a 0-d integer tensor on the ids' device, read there):
    kernel on the card, plain on CPU."""
    if ids.device.type == "cpu":
        return avail_rows_plain(ids, t, sched)
    _check(ids, sched)
    lib = build.library()
    r = ids.shape[0]
    ids = ids.to(torch.int64).contiguous()
    t = _t_tensor(t, ids.device)
    build.require(ids, "ids", (r,), torch.int64, align=8)
    build.require(t, "t", (), torch.int64, align=8)
    mask = torch.empty(r, dtype=torch.float32, device=ids.device)
    lat = torch.empty_like(mask)
    key, k_lat = (np.asarray(k, np.uint32) for k in (sched.key, sched.k_lat))
    err = lib.avail_rows_f32(
        ids.data_ptr(), t.data_ptr(), mask.data_ptr(), lat.data_ptr(), r,
        SCHEDULES.index(sched.kind), int(key[0]), int(key[1]),
        int(k_lat[0]), int(k_lat[1]), float(sched.prob), float(sched.p_ud),
        float(sched.p_du), sched.horizon, float(sched.slow),
        float(sched.deadline), build.stream(ids))
    build.check(err, NAME)
    global LAUNCHES
    LAUNCHES += 1
    return mask, lat
