"""FIFO streaming device data (paper §I: rapidly changing streaming data),
the gradient-corruption schedule of the robustness layer (DESIGN.md §15),
the drift schedules of the dynamic environments (DESIGN.md §13) and the
availability schedules (DESIGN.md §14).

Every device holds only its *next* mini-batch (labels pre-drawn so the
class-count vector a_t^{m,k} is reportable to the BS before selection);
images are generated lazily ONLY for the devices that are actually selected.
After each iteration all devices advance. Pure numpy, so counts and images
are bit-equal to the JAX package's ``FactoryStreams`` for the same seed.

The device-resident streams of the fused engine (DESIGN.md §7) follow at
the end: the dense population view :class:`DeviceStream`, the
:class:`DeviceSampler` over it or a lazy ``data.population.LazyPopulation``
(with candidate committees, DESIGN.md §17) and the host-loop adapter
:class:`DeviceBackedStreams`, drawing labels and images on the card from
threefry keys; then the baselines' :class:`ClientPool` over either view
and its host adapter :class:`HostClientPool`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import tree
from ..core import prng
from ..kernels import agg_weighted, avail, corrupt, dirichlet
from . import femnist
from .partition import Partition


class FactoryStreams:
    """Vectorized streams for all M×K devices."""

    def __init__(self, part: Partition, batch_size: int = 32, seed: int = 0):
        self.part = part
        self.n = batch_size
        self.m, self.k, self.f = part.class_probs.shape
        self._rng = np.random.default_rng(seed + 7)
        self._t = 0
        self._next_labels = None
        self._draw_next()

    def _draw_next(self) -> None:
        """Draw next-batch labels for every device: (M, K, n)."""
        probs = self.part.class_probs                     # (M,K,F)
        u = self._rng.random((self.m, self.k, self.n, 1))
        cdf = np.cumsum(probs, axis=-1)[:, :, None, :]    # (M,K,1,F)
        self._next_labels = (u > cdf).sum(axis=-1).astype(np.int32)
        self._t += 1

    def next_counts(self) -> np.ndarray:
        """a_t^{m,k} for all devices: (M, K, F) int32."""
        onehot = (self._next_labels[..., None]
                  == np.arange(self.f)[None, None, None, :])
        return onehot.sum(axis=2).astype(np.int32)

    def fetch_selected(self, masks: np.ndarray, l: int
                       ) -> tuple[np.ndarray, np.ndarray]:
        """Generate images for the selected devices only.

        Args:
          masks: (M, K) 0/1 selection; exactly ``l`` ones per group.
        Returns:
          images (M, L, n, 28, 28), labels (M, L, n) — device order matches
          ``argsort(-mask, kind="stable")[:L]``, i.e. ascending device index
          (the gather order the trainer relies on).
        """
        imgs = np.zeros((self.m, l, self.n, femnist.IMAGE_SIZE,
                         femnist.IMAGE_SIZE), np.float32)
        labs = np.zeros((self.m, l, self.n), np.int32)
        for mi in range(self.m):
            sel = np.argsort(-masks[mi], kind="stable")[:l]
            for j, ki in enumerate(sel):
                labels = self._next_labels[mi, ki]
                wid = int(self.part.writer_ids[mi, ki])
                sample_ids = (self._t * 1_000_000
                              + (mi * self.k + ki) * self.n
                              + np.arange(self.n))
                imgs[mi, j] = femnist.generate_images(
                    labels, np.full(self.n, wid), sample_ids)
                labs[mi, j] = labels
        self._draw_next()  # streaming: every device's buffer rolls over
        return imgs, labs

    def fetch_device_batches(self, mi: int, ki: int, steps: int
                             ) -> tuple[np.ndarray, np.ndarray]:
        """S consecutive mini-batches of one device (baseline local
        epochs)."""
        probs = self.part.class_probs[mi, ki]
        rng = np.random.default_rng((self._t * 9973 + mi * 131 + ki)
                                    % (2**31))
        labels = rng.choice(self.f, size=(steps, self.n), p=probs)
        wid = int(self.part.writer_ids[mi, ki])
        sample_ids = (self._t * 1_000_000 + rng.integers(0, 2**20)
                      + np.arange(steps * self.n))
        imgs = femnist.generate_images(
            labels.reshape(-1), np.full(steps * self.n, wid), sample_ids)
        return (imgs.reshape(steps, self.n, femnist.IMAGE_SIZE,
                             femnist.IMAGE_SIZE), labels.astype(np.int32))

    def sample_baseline_round(self, clients: int, steps: int, seed: int
                              ) -> tuple[tuple[np.ndarray, np.ndarray],
                                         np.ndarray]:
        """FedAvg-style round data: ``clients`` devices sampled uniformly
        across all factories, each with ``steps`` local batches.

        Returns ((images (C,S,n,28,28), labels (C,S,n)), weights (C,))."""
        rng = np.random.default_rng(seed)
        flat = rng.choice(self.m * self.k, size=clients, replace=False)
        imgs = np.zeros((clients, steps, self.n, femnist.IMAGE_SIZE,
                         femnist.IMAGE_SIZE), np.float32)
        labs = np.zeros((clients, steps, self.n), np.int32)
        for c, idx in enumerate(flat):
            mi, ki = divmod(int(idx), self.k)
            imgs[c], labs[c] = self.fetch_device_batches(mi, ki, steps)
        self._t += 1
        weights = np.full(clients, float(steps * self.n), np.float32)
        return (imgs, labs), weights


# ---------------------------------------------------------------------------
# Gradient corruption (DESIGN.md §15.1): a deterministic subset of devices
# emits a poisoned/faulty *update* (sensor fault, firmware bug, adversary).
# ---------------------------------------------------------------------------

CORRUPTION_MODES = corrupt.MODES


@dataclasses.dataclass(frozen=True)
class CorruptionConfig:
    """Parameterized gradient corruption (DESIGN.md §15.1).

    ``mode`` is one of :data:`CORRUPTION_MODES`, or a ``'+'``-joined mix
    (e.g. ``'scale+nan_burst'``): each faulty device is assigned ONE mode
    from the mix by a per-device hash.

      * ``nan_burst``   — the whole gradient becomes NaN.
      * ``inf_spike``   — the whole gradient becomes +Inf.
      * ``scale``       — the gradient is multiplied by ``scale``.
      * ``sign_flip``   — the gradient is negated.
      * ``gauss_noise`` — i.i.d. N(0, ``sigma``²) noise is added.

    A fixed ``frac`` fraction of devices is faulty (hashed membership);
    each faulty device fires i.i.d. with probability ``prob`` per
    iteration, starting at iteration ``t0``.
    """
    mode: str = "nan_burst"
    frac: float = 0.2          # fraction of devices that are faulty
    prob: float = 0.5          # per-iteration firing probability
    t0: int = 0                # first iteration at which faults can fire
    scale: float = 25.0        # 'scale' mode multiplier
    sigma: float = 1.0         # 'gauss_noise' mode std deviation

    @property
    def modes(self) -> tuple:
        return tuple(s.strip() for s in self.mode.split("+"))

    def __post_init__(self):
        for m in self.modes:
            if m not in CORRUPTION_MODES:
                raise ValueError(
                    f"unknown corruption mode: {m!r} (expected '+'-joined "
                    f"names from {CORRUPTION_MODES})")
        if not 0.0 <= self.frac <= 1.0:
            raise ValueError(f"frac must be a probability in [0, 1], "
                             f"got {self.frac}")
        if not 0.0 < self.prob <= 1.0:
            raise ValueError(f"prob must be in (0, 1], got {self.prob}")
        if self.t0 < 0:
            raise ValueError(f"t0 must be >= 0, got {self.t0}")
        if self.scale <= 0:
            raise ValueError(f"scale must be > 0, got {self.scale}")
        if self.sigma <= 0:
            raise ValueError(f"sigma must be > 0, got {self.sigma}")


class CorruptionFn:
    """One corruption schedule's fault trace (DESIGN.md §15.1), split into
    a host trace and a device apply.

    :meth:`trace` hashes, in numpy, the JAX package's ``fold_in`` keys (606
    off the seed) for any array of flat population ids at
    iteration t: faulty membership, firing, the per-device mode and the
    per-(device, t, leaf) noise keys, so both packages corrupt the same
    members the same way. :meth:`apply` rewrites the rows of a flat
    (R, P4) member buffer on its device from that trace in one call of
    ``kernels.corrupt.corrupt_rows`` (the kernel on the card), reading
    nothing back: the trace's tensors may come from staged keys, as in the
    fused round. ``corrupt_fn(grads, t, ids) -> (grads', hit)`` is the
    two together on a stacked per-member gradient tree (leaves (D, ...)),
    the JAX package's ``make_corruption_fn`` contract: the corrupted stack
    and the (D,) float32 ground-truth hit mask on the leaves' device."""

    def __init__(self, config: CorruptionConfig, seed: int):
        self.config = config
        self.modes = config.modes
        base_key = prng.fold_in(prng.PRNGKey(seed), 606)
        self._k_faulty, self._k_mode, self._k_fire, self._k_noise = (
            prng.fold_in(base_key, i) for i in (1, 2, 3, 4))

    @property
    def noisy(self) -> bool:
        """Does the mix draw Gaussian noise (so the trace carries keys)?"""
        return "gauss_noise" in self.modes

    def trace(self, t: int, ids, num_leaves: int):
        """(code, keys) of the devices ``ids`` (any shape (...,)) at
        iteration ``t``: code (...,) int32, 0 for an untouched device, else
        1 + its mode's index in ``modes``; keys (..., S, 2) uint32, each
        leaf's noise key ``fold_in(fold_in(fold_in(k_noise, id), t), s)``
        for the S = ``num_leaves`` leaves, or None when no mode draws
        noise."""
        c = self.config
        ids = np.asarray(ids, np.int64)
        faulty = prng.bernoulli(prng.fold_in(self._k_faulty, ids), c.frac)
        fire = prng.bernoulli(prng.fold_in(prng.fold_in(self._k_fire, ids),
                                           t), c.prob)
        hit = faulty & fire & (t >= c.t0)
        midx = prng.randint(prng.fold_in(self._k_mode, ids), (), 0,
                            len(self.modes))
        code = np.where(hit, midx + 1, 0).astype(np.int32)
        if not self.noisy:
            return code, None
        nkeys = prng.fold_in(prng.fold_in(self._k_noise, ids), t)
        return code, prng.fold_in(nkeys[..., None, :], np.arange(num_leaves))

    def apply(self, flat: torch.Tensor, code: torch.Tensor, keys, sizes
              ) -> torch.Tensor:
        """Corrupt the rows of ``flat`` (R, P4) in place from a trace on its
        device: code (R,), keys (R, S, 2) int64 words or None; ``sizes``
        are the S leaves' coordinate counts in column order."""
        c = self.config
        return corrupt.corrupt_rows(flat, code, keys, sizes, self.modes,
                                    c.scale, c.sigma)

    def device_trace(self, t: int, ids, num_leaves: int, device):
        """:meth:`trace` as tensors on ``device``: (code int32, keys int64
        or None)."""
        code, keys = self.trace(t, ids, num_leaves)
        return (torch.as_tensor(code, device=device),
                None if keys is None else
                torch.as_tensor(keys.astype(np.int64), device=device))

    def __call__(self, grads, t: int, ids):
        leaves = tree.leaves(grads)
        d, dev = leaves[0].shape[0], leaves[0].device
        code, keys = self.device_trace(
            t, np.asarray(torch.as_tensor(ids).cpu(), np.int64), len(leaves),
            dev)
        flat = agg_weighted.flatten(grads, d)
        self.apply(flat, code, keys, [leaf[0].numel() for leaf in leaves])
        return agg_weighted.unflatten(flat, grads, 1), (code > 0).float()


def make_corruption_fn(corrupt: CorruptionConfig | None, seed: int):
    """The schedule's :class:`CorruptionFn` (``corrupt=None`` returns
    None)."""
    if corrupt is None:
        return None
    return CorruptionFn(corrupt, seed)


# ---------------------------------------------------------------------------
# Drift schedules (DESIGN.md §13): the per-device class distributions are a
# pure function of (iteration t, flat population id, seed), so the
# host loop, the fused round and the baselines' pool see one environment.
# ---------------------------------------------------------------------------

DRIFT_SCHEDULES = ("static", "step_shift", "rotate", "redraw", "churn")


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Parameterized drift of the per-device class distributions.

    schedule:
      * ``static``     — no drift (an exact no-op).
      * ``step_shift`` — at t >= ``t0`` every device's distribution is
        cyclically shifted by a per-device offset drawn once from the seed.
      * ``rotate``     — all distributions rotate by ``(t // period) % F``
        classes.
      * ``redraw``     — every ``period`` iterations each device's
        distribution is re-drawn from Dirichlet(``alpha``) (epoch e > 0;
        epoch 0 keeps the base partition).
      * ``churn``      — every ``period`` iterations a ``churn_rate``
        fraction of devices (Bernoulli per device per epoch) is replaced by
        a fresh device with a Dirichlet(``alpha``) distribution; the rest
        keep the base partition.
    """
    schedule: str = "static"
    t0: int = 50            # step_shift: first shifted iteration
    period: int = 50        # rotate / redraw / churn: iterations per epoch
    alpha: float = 0.3      # redraw / churn Dirichlet concentration
    churn_rate: float = 0.25  # churn: expected fraction replaced per epoch

    def __post_init__(self):
        if self.schedule not in DRIFT_SCHEDULES:
            raise ValueError(f"unknown drift schedule: {self.schedule!r} "
                             f"(expected one of {DRIFT_SCHEDULES})")
        if self.period < 1:
            raise ValueError(f"drift period must be >= 1, got {self.period}")
        if self.alpha <= 0:
            raise ValueError("drift alpha (Dirichlet concentration) must be "
                             f"> 0, got {self.alpha}")
        if not 0.0 <= self.churn_rate <= 1.0:
            raise ValueError("churn_rate must be a probability in [0, 1], "
                             f"got {self.churn_rate}")


# words of one device's drift trace: class shift, drawn flag, Dirichlet key
DRIFT_WORDS = 4


class DriftFn:
    """One drift schedule (DESIGN.md §13), split into a host trace and a
    device apply, as :class:`CorruptionFn` is.

    :meth:`trace` hashes, in numpy, the JAX package's ``fold_in`` keys (404
    off the seed, then 1 ``step_shift`` / 2 ``redraw`` / 3 ``churn``) for
    any array of flat device ids at iteration t: (..., 4) int64 words per
    device — the class shift (``step_shift``'s ``randint(fold_in(k, id), 1,
    F)`` from t0 on, ``rotate``'s ``(t // period) % F``), whether the row
    is drawn (``redraw`` in epochs e > 0, ``churn`` where also
    ``bernoulli(fold_in(ke, 1), churn_rate)``), and the draw's key
    (``fold_in(fold_in(k, id), e)``; ``churn``'s ``fold_in(ke, 2)``).
    :meth:`apply` turns the base rows (R, F) into the drifted rows on their
    device from such a trace, reading nothing back: each row rolled by its
    shift, a drawn row replaced by its Dirichlet draw
    (``kernels.dirichlet.drift_rows``, the kernel on the card).
    ``drift_fn(base, t, ids)`` is the two together, the JAX package's
    ``make_drift_fn`` contract."""

    def __init__(self, config: DriftConfig, seed: int, num_classes: int):
        self.config, self.num_classes = config, num_classes
        self.draws = config.schedule in ("redraw", "churn")
        fold = {"step_shift": 1, "redraw": 2, "churn": 3}
        base_key = prng.fold_in(prng.PRNGKey(seed), 404)
        self._key = prng.fold_in(base_key, fold.get(config.schedule, 0))

    def trace(self, t: int, ids) -> np.ndarray:
        """(..., 4) int64 trace of the devices ``ids`` (any shape (...,))
        at iteration ``t``."""
        c, f = self.config, self.num_classes
        ids = np.asarray(ids, np.int64)
        out = np.zeros(ids.shape + (DRIFT_WORDS,), np.int64)
        if c.schedule == "step_shift":
            if t >= c.t0:
                out[..., 0] = prng.randint(prng.fold_in(self._key, ids), (),
                                           1, f)
        elif c.schedule == "rotate":
            out[..., 0] = (t // c.period) % f
        else:
            e = t // c.period
            ke = prng.fold_in(prng.fold_in(self._key, ids), e)
            if c.schedule == "redraw":
                drawn = np.full(ids.shape, e > 0)
            else:
                drawn = (e > 0) & prng.bernoulli(prng.fold_in(ke, 1),
                                                 c.churn_rate)
                ke = prng.fold_in(ke, 2)
            out[..., 1] = drawn
            out[..., 2:] = ke
        return out

    def device_trace(self, t: int, ids, device) -> torch.Tensor:
        return torch.as_tensor(self.trace(t, ids), device=device)

    def apply(self, base: torch.Tensor, trace: torch.Tensor) -> torch.Tensor:
        """Drifted rows of ``base`` (R, F) from an (R, 4) trace on its
        device."""
        if self.draws:
            return dirichlet.drift_rows(base, trace, self.config.alpha)
        return dirichlet.roll_rows(base, trace[:, 0])

    def __call__(self, base: torch.Tensor, t: int, ids) -> torch.Tensor:
        ids = np.asarray(torch.as_tensor(ids).cpu(), np.int64)
        return self.apply(base, self.device_trace(t, ids, base.device))


def make_drift_fn(drift: DriftConfig | None, seed: int,
                  num_classes: int) -> DriftFn | None:
    """The schedule's :class:`DriftFn`; ``drift=None`` and ``static``
    return None, and callers keep the precomputed distributions — the
    bit-identical no-op of the JAX package's identity ``probs_fn``."""
    if drift is None or drift.schedule == "static":
        return None
    return DriftFn(drift, seed, num_classes)


# ---------------------------------------------------------------------------
# Availability and straggler schedules (DESIGN.md §14): each device's up/down
# state and latency are a pure function of (flat device id, iteration t,
# seed), so every engine sees one trace; a latency above the deadline misses
# the iteration, so the returned mask already folds the deadline in.
# ---------------------------------------------------------------------------

AVAILABILITY_SCHEDULES = ("always", "bernoulli", "markov", "straggler_tail")


@dataclasses.dataclass(frozen=True)
class AvailabilityConfig:
    """Parameterized per-device availability and latency (DESIGN.md §14.1).

    schedule:
      * ``always``        — every device up, unit latency (callers pass
        ``avail_fn=None``: the path without availability).
      * ``bernoulli``     — each device up with probability ``up_prob``,
        i.i.d. per (device, iteration).
      * ``markov``        — a 2-state chain per device, P(up→down) =
        (1 − up_prob)/dwell and P(down→up) = up_prob/dwell, started at its
        stationary Bernoulli(up_prob); replayed per id from the start of
        its ``horizon`` block, so the trace repeats with period
        ``horizon``.
      * ``straggler_tail``— every device up, but a fixed ``straggler_frac``
        tail (hashed from the seed) runs ``slow_factor``× slower.

    Latency draws are uniform in [0.5, 1.5) (× ``slow_factor`` for tail
    devices); a draw above ``deadline`` misses the iteration.
    """
    schedule: str = "always"
    up_prob: float = 0.9       # bernoulli / markov stationary up-probability
    dwell: int = 8             # markov: mean sojourn time (iterations)
    horizon: int = 4096        # markov: the trace's period in iterations
    straggler_frac: float = 0.15  # straggler_tail: fraction of slow devices
    slow_factor: float = 4.0   # straggler_tail: latency multiplier
    deadline: float = 3.0      # latency budget; draws above it are missed

    def __post_init__(self):
        if self.schedule not in AVAILABILITY_SCHEDULES:
            raise ValueError(
                f"unknown availability schedule: {self.schedule!r} "
                f"(expected one of {AVAILABILITY_SCHEDULES})")
        if not 0.0 < self.up_prob <= 1.0:
            raise ValueError(f"up_prob must be in (0, 1], got {self.up_prob}")
        if self.dwell < 1:
            raise ValueError(f"dwell must be >= 1, got {self.dwell}")
        if self.horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {self.horizon}")
        if not 0.0 <= self.straggler_frac <= 1.0:
            raise ValueError("straggler_frac must be a probability in "
                             f"[0, 1], got {self.straggler_frac}")
        if self.slow_factor < 1.0:
            raise ValueError(f"slow_factor must be >= 1, "
                             f"got {self.slow_factor}")
        if self.deadline <= 0.0:
            raise ValueError(f"deadline must be > 0, got {self.deadline}")


class AvailFn:
    """One availability schedule (DESIGN.md §14): ``avail_fn(t, ids) ->
    (mask, latency)``, the (R,) float32 effective up-mask and latency draws
    of the flat device ids ``ids`` (R,) at iteration ``t``, on the ids'
    device (the JAX package's ``make_availability_fn`` contract). ``t``
    may be an int or a 0-d integer tensor on that device, read there (the
    fused round stages it with the keys). The keys are derived once, on
    the host: ``fold_in(PRNGKey(seed), 505)``, then 9 for the latency and
    1 (``bernoulli``), 2 (``markov``) or 4 (``straggler_tail``) for the
    schedule; the trace is one ``kernels.avail.avail_rows`` call (the
    kernel on the card)."""

    def __init__(self, config: AvailabilityConfig, seed: int):
        c = self.config = config
        base = prng.fold_in(prng.PRNGKey(seed), 505)
        fold = {"bernoulli": 1, "markov": 2, "straggler_tail": 4}
        tail = c.schedule == "straggler_tail"
        self.schedule = avail.Schedule(
            kind=c.schedule, key=prng.fold_in(base, fold[c.schedule]),
            k_lat=prng.fold_in(base, 9),
            prob=np.float32(c.straggler_frac if tail else c.up_prob),
            p_ud=np.float32((1.0 - c.up_prob) / c.dwell),
            p_du=np.float32(c.up_prob / c.dwell), horizon=c.horizon,
            slow=np.float32(c.slow_factor), deadline=np.float32(c.deadline))

    def __call__(self, t, ids: torch.Tensor):
        return avail.avail_rows(ids, t, self.schedule)


def make_availability_fn(config: AvailabilityConfig | None,
                         seed: int) -> AvailFn | None:
    """The schedule's :class:`AvailFn`; ``None`` and ``always`` return
    None, the path without availability."""
    if config is None or config.schedule == "always":
        return None
    return AvailFn(config, seed)


# ---------------------------------------------------------------------------
# Device-resident streams (DESIGN.md §7): the stream is a pure function of
# (iteration t, group id). Every key of an iteration depends on nothing the
# device computes, so the host derives them (:meth:`DeviceSampler.keys`,
# the JAX package's ``fold_in(fold_in(·, t), gid)``) and the device draws
# labels and images from them; the fused engine stages a round's keys in
# one buffer, so a CUDA graph replays the round with no host copy inside.
# ---------------------------------------------------------------------------

def xla_cumsum(p: np.ndarray, base: int = 16) -> np.ndarray:
    """``jnp.cumsum(p, axis=-1)`` in float32 as XLA on the CPU computes it
    (its reduce-window rewrite): the last axis in blocks of ``base``, each
    summed in order, plus the in-order sum of the blocks before it. The
    label draw compares uniforms against it, so its last bit matters."""
    p = np.asarray(p, np.float32)
    f = p.shape[-1]
    nb = -(-f // base)
    if nb > base:
        raise ValueError(f"xla_cumsum: {f} > {base * base} classes")
    q = np.zeros(p.shape[:-1] + (nb * base,), np.float32)
    q[..., :f] = p
    q = q.reshape(p.shape[:-1] + (nb, base))
    within = np.empty_like(q)
    acc = np.zeros(q.shape[:-1], np.float32)
    for i in range(base):
        acc = acc + q[..., i]
        within[..., i] = acc
    before = np.zeros(q.shape[:-1], np.float32)
    acc = np.zeros(q.shape[:-2], np.float32)
    for b in range(1, nb):
        acc = acc + within[..., b - 1, base - 1]
        before[..., b] = acc
    out = within + before[..., None]
    return out.reshape(p.shape[:-1] + (nb * base,))[..., :f]


def xla_cumsum_t(p: torch.Tensor, base: int = 16) -> torch.Tensor:
    """:func:`xla_cumsum` on a float32 tensor on its device, the same adds
    in the same order, each an elementwise tensor add (never
    ``torch.cumsum``, whose scan may associate them otherwise): the cdf of
    drifted rows, bit-equal to the numpy form."""
    f = p.shape[-1]
    nb = -(-f // base)
    if nb > base:
        raise ValueError(f"xla_cumsum_t: {f} > {base * base} classes")
    q = torch.nn.functional.pad(p.float(), (0, nb * base - f))
    q = q.reshape(p.shape[:-1] + (nb, base))
    acc = q[..., 0]
    within = [acc]
    for i in range(1, base):
        acc = acc + q[..., i]
        within.append(acc)
    within = torch.stack(within, dim=-1)
    acc = torch.zeros_like(within[..., 0, 0])
    before = [acc]
    for b in range(1, nb):
        acc = acc + within[..., b - 1, base - 1]
        before.append(acc)
    out = within + torch.stack(before, dim=-1)[..., None]
    return out.reshape(p.shape[:-1] + (nb * base,))[..., :f]


@dataclasses.dataclass(frozen=True)
class DeviceStream:
    """All M×K streams on one device: the per-device class distributions,
    their cumulative sums (:func:`xla_cumsum`, once, on the host) and the
    persistent writer styles. The dense population view of DESIGN.md §17,
    with the interface of ``data.population.LazyPopulation``: the host
    stages an array of flat device ids (:meth:`stage`; here the id alone,
    ``staged_words`` = 1) and the device gathers rows, cdfs and styles
    from the staged words (:meth:`rows`, :meth:`cdf_of`, :meth:`styles`);
    ``probs_for``/``styles_for`` take the ids themselves."""
    class_probs: torch.Tensor   # (M, K, F)
    cdf: torch.Tensor           # (M, K, F)
    styles_table: torch.Tensor  # (M, K, 6)
    batch_size: int             # n
    seed: int

    staged_words = 1

    @classmethod
    def from_partition(cls, part: Partition, batch_size: int = 32,
                       seed: int = 0, device="cuda") -> "DeviceStream":
        probs = np.asarray(part.class_probs, np.float32)
        on = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                       device=device)
        return cls(class_probs=on(probs), cdf=on(xla_cumsum(probs)),
                   styles_table=on(femnist.writer_style_table(
                       part.writer_ids)),
                   batch_size=batch_size, seed=seed)

    @property
    def num_factories(self) -> int:
        return self.class_probs.shape[0]

    @property
    def devices_per_factory(self) -> int:
        return self.class_probs.shape[1]

    @property
    def num_classes(self) -> int:
        return self.class_probs.shape[2]

    @property
    def device(self) -> torch.device:
        return self.class_probs.device

    def stage(self, ids) -> np.ndarray:
        """(...,) flat device ids → (..., 1) int64 staged words."""
        return np.asarray(ids, np.int64)[..., None]

    def rows(self, staged: torch.Tensor) -> torch.Tensor:
        """(..., 1) staged words → (..., F) class distributions."""
        return self.class_probs.reshape(-1, self.num_classes)[staged[..., 0]]

    def styles(self, staged: torch.Tensor) -> torch.Tensor:
        """(..., 1) staged words → (..., 6) writer-style rows."""
        return self.styles_table.reshape(-1, 6)[staged[..., 0]]

    def cdf_of(self, staged: torch.Tensor, drift: DriftFn | None = None,
               trace: torch.Tensor | None = None) -> torch.Tensor:
        """(..., 1) staged words → (..., F) cumulative distributions: the
        precomputed table without a drift, else :meth:`cumulative` of the
        drifted rows."""
        if drift is None:
            return self.cdf.reshape(-1, self.num_classes)[staged[..., 0]]
        return self.cumulative(self.rows(staged), drift, trace)

    @staticmethod
    def cumulative(rows: torch.Tensor, drift: DriftFn | None,
                   trace: torch.Tensor | None) -> torch.Tensor:
        """(..., F) rows → their cdf on the device, under a drift ``trace``
        (..., 4) (:meth:`DriftFn.trace`) when ``drift`` is given: the
        drifted rows' :func:`xla_cumsum_t`."""
        if drift is not None:
            f = rows.shape[-1]
            rows = drift.apply(rows.reshape(-1, f),
                               trace.reshape(-1, DRIFT_WORDS)
                               ).reshape(rows.shape)
        return xla_cumsum_t(rows)

    def probs_for(self, ids) -> torch.Tensor:
        """(...,) flat device ids → (..., F) class distributions."""
        return self.class_probs.reshape(-1, self.num_classes)[
            torch.as_tensor(ids, device=self.device)]

    def styles_for(self, ids) -> torch.Tensor:
        """(...,) flat device ids → (..., 6) writer-style rows."""
        return self.styles_table.reshape(-1, 6)[
            torch.as_tensor(ids, device=self.device)]


class DeviceSampler:
    """The fused engine's sampling interface over a population view (the
    dense :class:`DeviceStream` or a ``data.population.LazyPopulation``).

    On the host, for iteration t: ``keys(t, gids)`` derives each group's
    (label, image) key, (G, 2, 2) uint32 words: the JAX package's
    ``fold_in(fold_in(base ⊕ 101 | 202, t), gid)``; ``device_ids(t,
    gids)`` the (G, K) flat population ids seated in the groups' K
    engine slots (DESIGN.md §17); ``seats(t, gids)`` their staged words
    (G, K, W) (the view's ``stage``); under a drift schedule (``drift``, a
    :class:`DriftFn`) ``drift_trace(t, gids)`` the (G, K, 4) trace of those
    devices. The device side takes them as int64 tensors:

    * ``labels(keys, gids, trace=None, seats=None)`` → (G, K, n)
      next-batch labels, ``u > cdf`` summed over classes from one
      ``uniform`` draw per group, the cdf that of the seated devices
      (drifted when a trace is given);
    * ``counts(labels)`` → (G, K, F) int32 class counts;
    * ``selected_batch(labels, keys, gids, masks, l, seats=None)`` →
      (images (G, l, n, 28, 28), labels (G, l, n)) of the selected
      devices, in the order ``argsort(-mask, stable)[:l]`` (``lax.top_k``'s,
      the host loop's).

    ``seats`` None stands for the dense slots gid·K + slot of a dense
    stream without candidates (the ids of every iteration). With
    ``candidates`` C each factory polls C of its ``devices_per_factory``
    physical devices: slot s of group g holds ``g·K_pop + randint(
    fold_in(fold_in(707, epoch), g), (C,), 0, K_pop)[s]``, epoch = t //
    ``candidate_every`` (0: one committee for the whole run).

    The same (t, gid) gives the same batch, which is how the host loop over
    :class:`DeviceBackedStreams` and the fused round see identical data.
    """

    def __init__(self, stream, drift: DriftFn | None = None,
                 candidates: int | None = None, candidate_every: int = 0):
        self.stream, self.drift = stream, drift
        self.num_groups = stream.num_factories
        self.population_per_group = stream.devices_per_factory
        self.candidates, self.candidate_every = candidates, candidate_every
        self.devices_per_group = stream.devices_per_factory \
            if candidates is None else candidates
        self.num_classes = stream.num_classes
        self.batch_size = stream.batch_size
        self.device = stream.device
        self.protos = torch.as_tensor(femnist.class_prototypes(),
                                      device=self.device)
        base = prng.PRNGKey(stream.seed)
        self._label_key = prng.fold_in(base, 101)
        self._img_key = prng.fold_in(base, 202)
        self._cand_key = prng.fold_in(base, 707)

    def keys(self, t: int, gids) -> np.ndarray:
        """(G, 2, 2) uint32: each group's label and image key of
        iteration ``t``."""
        g = np.asarray(gids, np.int64)
        return np.stack([prng.fold_in(prng.fold_in(self._label_key, t), g),
                         prng.fold_in(prng.fold_in(self._img_key, t), g)],
                        axis=1)

    def device_ids(self, t: int, gids) -> np.ndarray:
        """(G, K) int64 flat population ids of each group's K slots at
        iteration ``t``: the dense grid gid·K + slot without candidates,
        else the candidate committee of t's epoch."""
        g = np.asarray(gids, np.int64)
        k_pop, k = self.population_per_group, self.devices_per_group
        if self.candidates is None:
            return g[:, None] * k_pop + np.arange(k)
        epoch = t // self.candidate_every if self.candidate_every else 0
        kc = prng.fold_in(prng.fold_in(self._cand_key, epoch), g)
        return g[:, None] * k_pop + prng.randint(kc, (k,), 0, k_pop)

    def seats(self, t: int, gids) -> np.ndarray:
        """(G, K, W) int64 staged words of the devices seated at ``t``."""
        return self.stream.stage(self.device_ids(t, gids))

    def drift_trace(self, t: int, gids) -> np.ndarray:
        """(G, K, 4) int64 drift trace of the groups' seated devices at
        iteration ``t``."""
        return self.drift.trace(t, self.device_ids(t, gids))

    def _seats(self, gids: torch.Tensor, seats: torch.Tensor | None
               ) -> torch.Tensor:
        if seats is not None:
            return seats
        if self.candidates is not None or self.stream.staged_words > 1:
            raise ValueError("this sampler needs the staged seats of the "
                             "iteration (seats(t, gids))")
        k = self.devices_per_group
        return (gids[:, None] * k + torch.arange(k, device=gids.device)
                )[..., None]

    def labels(self, keys: torch.Tensor, gids: torch.Tensor,
               trace: torch.Tensor | None = None,
               seats: torch.Tensor | None = None) -> torch.Tensor:
        k, n, f = self.devices_per_group, self.batch_size, self.num_classes
        u = prng.uniform_t(keys[:, 0], (k, n, 1))               # (G, K, n, 1)
        cdf = self.stream.cdf_of(self._seats(gids, seats), self.drift,
                                 trace)[:, :, None, :]
        return torch.clamp_max((u > cdf).sum(-1), f - 1)

    def counts(self, labels: torch.Tensor) -> torch.Tensor:
        f = self.num_classes
        onehot = labels[..., None] == torch.arange(f, device=labels.device)
        return onehot.sum(dim=2, dtype=torch.int32)

    def selected_batch(self, labels: torch.Tensor, keys: torch.Tensor,
                       gids: torch.Tensor, masks: torch.Tensor, l: int,
                       seats: torch.Tensor | None = None):
        g, _, n = labels.shape
        idx = torch.argsort(-masks, dim=1, stable=True)[:, :l]   # (G, l)
        lab = labels.gather(1, idx[..., None].expand(g, l, n))
        sty = self.stream.styles(self._seats(gids, seats))
        sty = sty.gather(1, idx[..., None].expand(g, l, 6))
        sty = sty[:, :, None, :].expand(g, l, n, 6).reshape(g, l * n, 6)
        imgs = femnist.generate_images_device(
            self.protos, lab.reshape(g, l * n), sty, keys[:, 1])
        return imgs.reshape(g, l, n, femnist.IMAGE_SIZE,
                            femnist.IMAGE_SIZE), lab


def make_device_sampler(stream, drift: DriftConfig | None = None, *,
                        candidates: int | None = None,
                        candidate_every: int = 0) -> DeviceSampler:
    """The device sampler over any population view (``stream``: the dense
    :class:`DeviceStream` or a lazy ``data.population.LazyPopulation``),
    its class distributions drifting with t under ``drift`` (DESIGN.md
    §13; None and ``static`` keep the dense precomputed cdf).
    ``candidates=C`` turns on candidate committees (DESIGN.md §17): each
    factory polls C of its ``devices_per_factory`` physical devices, the
    engine's K becomes C, and the committee is redrawn every
    ``candidate_every`` iterations (0 = one draw for the run). Slots are
    drawn independently, so two slots of a group may (rarely) hold the
    same device."""
    k_pop = stream.devices_per_factory
    if candidates is not None and not 0 < candidates <= k_pop:
        raise ValueError(f"candidates={candidates} must be in "
                         f"[1, devices_per_factory={k_pop}]")
    if candidate_every < 0:
        raise ValueError(f"candidate_every must be >= 0, "
                         f"got {candidate_every}")
    return DeviceSampler(stream, make_drift_fn(drift, stream.seed,
                                               stream.num_classes),
                         candidates, candidate_every)


class DeviceBackedStreams:
    """Host-facing ``FactoryStreams`` adapter over a :class:`DeviceSampler`:
    the two-phase host loop (``fedgs.run_fedgs``) consumes the exact
    batches the fused round sees, as tensors on the sampler's device.
    ``next_counts`` is repeatable (pure in t); ``fetch_selected`` advances
    time; ``device_ids(t, gids)`` is the sampler's, so the host loop
    hashes the schedules on the resident ids the fused round sees
    (DESIGN.md §17)."""

    def __init__(self, sampler: DeviceSampler):
        self.sampler = sampler
        self._t = 0
        self._gids = torch.arange(sampler.num_groups, device=sampler.device)
        self._labels = None     # (t, keys, seats, labels) of the last draw

    def device_ids(self, t: int, gids) -> np.ndarray:
        return self.sampler.device_ids(t, gids)

    def _draw(self):
        """Iteration t's keys, seats and labels, drawn once (with the drift
        trace of t when the sampler drifts) and reused until t advances."""
        if self._labels is None or self._labels[0] != self._t:
            s, gids = self.sampler, np.arange(self.sampler.num_groups)
            on = lambda a: torch.as_tensor(a, device=s.device)
            ids = s.device_ids(self._t, gids)
            keys = on(s.keys(self._t, gids).astype(np.int64))
            seats = on(s.stream.stage(ids))
            trace = None if s.drift is None else on(s.drift.trace(self._t,
                                                                  ids))
            self._labels = (self._t, keys, seats,
                            s.labels(keys, self._gids, trace, seats))
        return self._labels[1:]

    def next_counts(self) -> torch.Tensor:
        return self.sampler.counts(self._draw()[2])

    def fetch_selected(self, masks, l: int):
        keys, seats, labels = self._draw()
        masks = torch.as_tensor(masks, dtype=torch.float32,
                                device=self.sampler.device)
        imgs, labs = self.sampler.selected_batch(labels, keys, self._gids,
                                                 masks, l, seats)
        self._t += 1
        return imgs, labs


# ---------------------------------------------------------------------------
# The baselines' client pool (core.baselines): C clients drawn uniformly from
# all M·K devices per round, each with S local mini-batches, a pure function
# of the round index. The host derives the round's key words and client ids
# (:meth:`ClientPool.material`); the device draws labels and images from
# them (:meth:`ClientPool.draw`), so a CUDA graph replays a round from one
# staged buffer.
# ---------------------------------------------------------------------------

# pools larger than this draw client ids by per-slot hashing (randint)
# instead of an exact no-replacement choice, as the JAX package does: its
# choice(replace=False) sorts a pool-length key vector (DESIGN.md §17)
LAZY_POOL_THRESHOLD = 1 << 16


class ClientPool:
    """Device-resident FedAvg-style client pool over a population view (the
    dense :class:`DeviceStream` or a ``data.population.LazyPopulation``;
    the JAX package's ``ClientPool``).

    ``round_batches(r) -> ((images (C, S, n, 28, 28), labels (C, S, n)),
    weights (C,))`` on the stream's device; the weights are the client data
    sizes S·n. Round r's keys are ``split(fold_in(fold_in(PRNGKey(seed),
    303), r), 3)``: the client ids from the first (``permutation(·,
    pool)[:C]``, ``jax.random.choice(replace=False)``'s draw, or
    ``randint`` above :data:`LAZY_POOL_THRESHOLD`), the labels from
    ``uniform(k_lab, (C, S, n, 1)) > cdf`` and all C·S·n images from one
    key ``k_img``. :meth:`material` stages those on the host as C + 4
    int64 words, and after them the rest of the clients' staged words
    (the view's ``stage``: a lazy population's factory, writer and
    Dirichlet key, C·4 words; none for a dense stream); :meth:`draw` runs
    the rest on the device from them.

    Under a ``drift`` schedule (DESIGN.md §13) round r sits at environment
    time t = r·``iters_per_round`` (the FEDGS clock of T iterations a
    round): the material carries the C clients' drift trace (C·4 more
    words) and the draw's cdf is that of their drifted distributions."""

    def __init__(self, stream, clients: int, steps: int,
                 drift: DriftConfig | None = None, iters_per_round: int = 1):
        self.stream = stream
        self.pool_size = stream.num_factories * stream.devices_per_factory
        if clients > self.pool_size:
            raise ValueError(f"clients={clients} exceeds pool of "
                             f"{self.pool_size} devices")
        self.num_clients, self.local_steps = clients, steps
        self.batch_size = stream.batch_size
        self.num_classes = stream.num_classes
        self.device = stream.device
        self.drift = make_drift_fn(drift, stream.seed, stream.num_classes)
        self.iters_per_round = iters_per_round
        self.material_size = clients * stream.staged_words + 4 + (
            0 if self.drift is None else DRIFT_WORDS * clients)
        self.protos = torch.as_tensor(femnist.class_prototypes(),
                                      device=self.device)
        self._key = prng.fold_in(prng.PRNGKey(stream.seed), 303)

    def material(self, r: int) -> np.ndarray:
        """Round r's client ids (C,), its label and image keys (2 + 2
        words), the clients' other staged words (C, W − 1), and under
        drift their (C, 4) drift trace at t = r·T, as one int64 array."""
        k_sel, k_lab, k_img = prng.split(prng.fold_in(self._key, r), 3)
        if self.pool_size <= LAZY_POOL_THRESHOLD:
            ids = prng.permutation(k_sel, self.pool_size)[:self.num_clients]
        else:
            ids = prng.randint(k_sel, (self.num_clients,), 0, self.pool_size)
        ids = np.asarray(ids, np.int64)
        parts = [ids, k_lab.astype(np.int64), k_img.astype(np.int64),
                 self.stream.stage(ids)[:, 1:].reshape(-1)]
        if self.drift is not None:
            parts.append(self.drift.trace(r * self.iters_per_round,
                                          ids).reshape(-1))
        return np.concatenate(parts)

    def draw(self, material: torch.Tensor):
        """The round's batches from its staged :meth:`material` on the
        device (no host copy: the form a CUDA graph captures)."""
        c, s, n = self.num_clients, self.local_steps, self.batch_size
        w = self.stream.staged_words
        ids, k_lab, k_img = material[:c], material[c:c + 2], \
            material[c + 2:c + 4]
        end = c + 4 + c * (w - 1)
        seats = torch.cat([ids[:, None],
                           material[c + 4:end].view(c, w - 1)], dim=1)
        u = prng.uniform_t(k_lab, (c, s, n, 1))
        trace = None if self.drift is None else material[end:].view(
            c, DRIFT_WORDS)
        cdf = self.stream.cdf_of(seats, self.drift, trace)[:, None, None, :]
        labels = torch.clamp_max((u > cdf).sum(-1), self.num_classes - 1)
        sty = torch.repeat_interleave(self.stream.styles(seats), s * n,
                                      dim=0)
        imgs = femnist.generate_images_device(self.protos,
                                              labels.reshape(-1), sty, k_img)
        imgs = imgs.reshape(c, s, n, femnist.IMAGE_SIZE, femnist.IMAGE_SIZE)
        weights = torch.full((c,), float(s * n), dtype=torch.float32,
                             device=self.device)
        return (imgs, labels), weights

    def round_batches(self, r: int):
        return self.draw(torch.as_tensor(self.material(r),
                                         device=self.device))


def make_client_pool(stream, clients: int, steps: int,
                     drift: DriftConfig | None = None,
                     iters_per_round: int = 1) -> ClientPool:
    """The baselines' pool over any population view (``stream``: dense or
    lazy); ``drift`` evolves its devices' distributions with round r at t
    = r·``iters_per_round`` (DESIGN.md §13)."""
    return ClientPool(stream, clients, steps, drift, iters_per_round)


class HostClientPool:
    """The baselines' host-loop adapter over a :class:`ClientPool`:
    ``pool(r)`` returns the exact batches the fused engine draws in round r,
    as tensors on the pool's device."""

    def __init__(self, pool: ClientPool):
        self.pool = pool

    def __call__(self, r: int):
        return self.pool.round_batches(r)
