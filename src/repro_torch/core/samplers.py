"""Benchmark client-selection samplers (paper §VII.A, Fig. 4).

All samplers solve the same constrained 0-1 program as GBP-CS:

    min_x || A x - y ||_2   s.t. x ∈ {0,1}^K, sum(x) = L_sel

and return a 0/1 numpy vector. Five of them are host-side numpy, as the
paper runs them on the BS CPU, and draw the JAX package's exact
``default_rng`` sequences; GBP-CS (:func:`gbp_cs_sampler`) runs the port's
``core.gbp_cs`` on a device. Each returns a :class:`SamplerResult` whose
``trace`` is the best-so-far distance after each evaluation (Fig. 4c).
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass

import numpy as np
import torch

from . import gbp_cs as G
from . import prng


def _distance(A: np.ndarray, x: np.ndarray, y: np.ndarray) -> float:
    return float(np.linalg.norm(A.astype(np.float64) @ x.astype(np.float64)
                                - y))


def _random_feasible(rng: np.random.Generator, k: int, l_sel: int
                     ) -> np.ndarray:
    x = np.zeros((k,), np.float32)
    x[rng.choice(k, size=l_sel, replace=False)] = 1.0
    return x


@dataclass
class SamplerResult:
    x: np.ndarray
    distance: float
    wall_time_s: float
    trace: np.ndarray  # best-so-far distance per evaluation
    evaluations: int

    @property
    def selected(self) -> np.ndarray:
        return np.nonzero(self.x > 0.5)[0]


def random_sampler(A, y, l_sel, *, seed: int = 0) -> SamplerResult:
    """1) Random Sampler: uniform feasible draw (FedAvg's selection)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    x = _random_feasible(rng, A.shape[1], l_sel)
    d = _distance(A, x, y)
    return SamplerResult(x, d, time.perf_counter() - t0, np.array([d]), 1)


def monte_carlo_sampler(A, y, l_sel, *, trials: int = 1000,
                        seed: int = 0) -> SamplerResult:
    """2) Monte Carlo Sampler: best of ``trials`` random draws (paper:
    1000)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    best_x, best_d, trace = None, np.inf, []
    for _ in range(trials):
        x = _random_feasible(rng, A.shape[1], l_sel)
        d = _distance(A, x, y)
        if d < best_d:
            best_x, best_d = x, d
        trace.append(best_d)
    return SamplerResult(best_x, best_d, time.perf_counter() - t0,
                         np.asarray(trace), trials)


def _best_of(A64: np.ndarray, y: np.ndarray, chunk: list, best_idx,
             best_d: float):
    """The best combination of ``chunk`` against the best so far."""
    idx = np.asarray(chunk)                       # (C, L_sel)
    sums = A64[:, idx].sum(axis=2)                # (F, C): A @ x per combo
    d = np.linalg.norm(sums.T - y[None, :], axis=1)
    j = int(np.argmin(d))
    if d[j] < best_d:
        return idx[j], float(d[j])
    return best_idx, best_d


def brute_sampler(A, y, l_sel, *, limit: int | None = None) -> SamplerResult:
    """3) Brute Sampler: exhaustive search over all C(K, L_sel) solutions.

    ``limit`` caps the number of enumerated combinations; the paper's
    instance (C(33,8) ≈ 13.9M) took 979 s.
    """
    t0 = time.perf_counter()
    k = A.shape[1]
    A64 = A.astype(np.float64)
    best_idx, best_d, trace, n_eval = None, np.inf, [], 0
    chunk, chunk_size = [], 8192
    for comb in itertools.combinations(range(k), l_sel):
        chunk.append(comb)
        n_eval += 1
        if len(chunk) == chunk_size:
            best_idx, best_d = _best_of(A64, y, chunk, best_idx, best_d)
            trace.append(best_d)
            chunk = []
        if limit is not None and n_eval >= limit:
            break
    if chunk:
        best_idx, best_d = _best_of(A64, y, chunk, best_idx, best_d)
        trace.append(best_d)
    x = np.zeros((k,), np.float32)
    x[np.asarray(best_idx)] = 1.0
    return SamplerResult(x, best_d, time.perf_counter() - t0,
                         np.asarray(trace), n_eval)


def bayesian_sampler(A, y, l_sel, *, n_init: int = 5, n_iter: int = 25,
                     pool: int = 256, seed: int = 0) -> SamplerResult:
    """4) Bayesian Sampler: GP-UCB over feasible binary vectors.

    Mirrors fmfn/BayesianOptimization defaults from the paper (5 initial
    points, 25 exploration iterations). The GP uses an RBF kernel on the
    0/1 vectors (Hamming-equivalent); each iteration scores a random
    feasible candidate pool with UCB and evaluates the argmax.
    """
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    k = A.shape[1]
    X, D = [], []
    for _ in range(n_init):
        x = _random_feasible(rng, k, l_sel)
        X.append(x)
        D.append(_distance(A, x, y))
    ell2 = 2.0 * l_sel  # RBF lengthscale² ~ typical Hamming distance
    noise = 1e-6
    trace = list(np.minimum.accumulate(D))
    for _ in range(n_iter):
        Xm = np.stack(X)
        Dv = np.asarray(D)
        mu0, sd0 = Dv.mean(), Dv.std() + 1e-9
        z = (Dv - mu0) / sd0
        # GP posterior over the candidate pool
        sq = ((Xm[:, None, :] - Xm[None, :, :]) ** 2).sum(-1)
        Kxx = np.exp(-sq / ell2) + noise * np.eye(len(X))
        cand = np.stack([_random_feasible(rng, k, l_sel)
                         for _ in range(pool)])
        sq_c = ((cand[:, None, :] - Xm[None, :, :]) ** 2).sum(-1)
        Kcx = np.exp(-sq_c / ell2)
        Kinv_z = np.linalg.solve(Kxx, z)
        mean = Kcx @ Kinv_z
        var = 1.0 - np.einsum("ij,jk,ik->i", Kcx, np.linalg.inv(Kxx), Kcx)
        var = np.maximum(var, 1e-12)
        # minimize distance -> maximize negative mean + exploration
        ucb = -mean + 2.0 * np.sqrt(var)
        x = cand[int(np.argmax(ucb))]
        X.append(x)
        D.append(_distance(A, x, y))
        trace.append(min(trace[-1], D[-1]))
    j = int(np.argmin(D))
    return SamplerResult(X[j], float(D[j]), time.perf_counter() - t0,
                         np.asarray(trace), len(D))


def genetic_sampler(A, y, l_sel, *, population: int = 100,
                    generations: int = 100, mutation_p: float = 0.001,
                    elite: int = 4, seed: int = 0) -> SamplerResult:
    """5) Genetic Sampler: constrained 0-1 GA (paper defaults: pop=100,
    mutation=0.001, generations=100). Crossover/mutation repair the
    cardinality constraint by randomly flipping surplus/deficit bits."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    k = A.shape[1]
    A64 = A.astype(np.float64)

    def fitness(pop):  # (P, K) -> (P,)
        return np.linalg.norm(pop @ A64.T - y[None, :], axis=1)

    def repair(x):
        ones = np.nonzero(x > 0.5)[0]
        zeros = np.nonzero(x < 0.5)[0]
        if len(ones) > l_sel:
            drop = rng.choice(ones, size=len(ones) - l_sel, replace=False)
            x[drop] = 0.0
        elif len(ones) < l_sel:
            add = rng.choice(zeros, size=l_sel - len(ones), replace=False)
            x[add] = 1.0
        return x

    pop = np.stack([_random_feasible(rng, k, l_sel)
                    for _ in range(population)])
    trace, n_eval = [], 0
    best_x, best_d = None, np.inf
    for _ in range(generations):
        fit = fitness(pop)
        n_eval += population
        order = np.argsort(fit)
        if fit[order[0]] < best_d:
            best_d = float(fit[order[0]])
            best_x = pop[order[0]].copy()
        trace.append(best_d)
        parents = pop[order[: population // 2]]
        children = []
        while len(children) < population - elite:
            i, j = rng.integers(0, len(parents), size=2)
            mask = rng.random(k) < 0.5
            child = np.where(mask, parents[i], parents[j]).astype(np.float32)
            flip = rng.random(k) < mutation_p
            child = np.abs(child - flip.astype(np.float32))
            children.append(repair(child))
        pop = np.concatenate([pop[order[:elite]], np.stack(children)], axis=0)
    return SamplerResult(best_x, best_d, time.perf_counter() - t0,
                         np.asarray(trace), n_eval)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def gbp_cs_sampler(A, y, l_sel, *, init: str = G.MPINV, max_iters: int = 64,
                   seed: int = 0, device: str | torch.device = "cuda"
                   ) -> SamplerResult:
    """6) The proposed GBP-CS, wrapped in the common sampler interface:
    ``core.gbp_cs.gbp_cs_minimize`` on ``device`` (the ``gbp_cs`` kernel on
    the card, its plain version on the CPU) with ``key=PRNGKey(seed)``.

    The JAX package's ``use_kernel`` switch has no counterpart: the
    tensor's device decides which version runs. ``cuda`` without a card
    raises. ``wall_time_s`` covers the copies to and from the device; on
    the card the clock is read after a device synchronize at both ends."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("gbp_cs_sampler: device cuda was requested but "
                           "no CUDA device is available")
    _sync(dev)
    t0 = time.perf_counter()
    res = G.gbp_cs_minimize(
        torch.as_tensor(np.asarray(A, np.float32), device=dev),
        torch.as_tensor(np.asarray(y, np.float32), device=dev), l_sel,
        key=prng.PRNGKey(seed), init=init, max_iters=max_iters)
    x, d, iters, trace = (v.cpu().numpy() for v in res)
    _sync(dev)
    iters = int(iters)
    return SamplerResult(x, float(d), time.perf_counter() - t0,
                         trace[: iters + 1], iters + 1)


SAMPLERS = {
    "random": random_sampler,
    "mc": monte_carlo_sampler,
    "brute": brute_sampler,
    "bayesian": bayesian_sampler,
    "ga": genetic_sampler,
    "gbp_cs": gbp_cs_sampler,
}
