"""The Table II comparison FL approaches on one trainer skeleton (the JAX
package's ``core/baselines.py``, DESIGN.md §12.4).

FedAvg, FedProx, FedMMD, FedFusion(Conv/Multi/Single), IDA(+INTRAC/+FedAvg),
CGAU, FedAvgM, FedAdagrad, FedAdam, FedYogi: the fourteen entries of
:func:`all_strategies`.

All share the classic FedAvg workflow (paper §III): per round, sample C
clients at random across all factories, each runs ``local_steps``
mini-batch SGD steps, uploads its model; the server aggregates and applies
a server-side optimizer. Strategies differ in (a) the client objective, (b)
extra client-side modules, and/or (c) the server aggregation — isolated
behind :class:`Strategy`.

Where the JAX package vmaps one client's function, the port batches the
clients: a :class:`ModelAPI`'s functions take a leading client axis
(params leaves (C, ...), x (C, n, ...)), a client objective returns the
(C,) losses, and one ``torch.autograd.grad`` of their sum per local step
gives every client its own gradient. Every server average goes through
``kernels.agg_weighted.weighted_average_tree`` (the ``agg_weighted``
kernel on the card), and the CNN's conv layers through ``conv_fused``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .. import optim, tree
from ..kernels.agg_weighted import weighted_average_tree
from . import engine, prng

Tree = Any


class ModelAPI(NamedTuple):
    """Minimal model protocol for the baseline strategies. ``init(key)``
    draws one model; the other functions take a leading client axis."""
    init: Callable[[np.ndarray], Tree]
    apply: Callable[[Tree, torch.Tensor], torch.Tensor]     # x -> logits
    features: Callable[[Tree, torch.Tensor], torch.Tensor]  # x -> features
    head: Callable[[Tree, torch.Tensor], torch.Tensor]      # f -> logits
    feature_dim: int
    num_classes: int


def linear_probe_model(image_pixels: int = 784, num_classes: int = 62,
                       device: str | torch.device = "cuda") -> ModelAPI:
    """flatten->softmax probe: negligible train compute, so a run of it
    measures the harness (sampling, dispatch, aggregation) rather than the
    model (DESIGN.md §9)."""
    def init(key):
        w = prng.normal(np.asarray(key, np.uint32),
                        (image_pixels, num_classes)) * np.float32(0.01)
        return {"w": torch.as_tensor(w, device=device),
                "b": torch.zeros(num_classes, device=device)}

    def features(params, x):
        return x.reshape(x.shape[0], x.shape[1], -1)

    def head(params, f):
        return torch.bmm(f, params["w"]) + params["b"][:, None]

    return ModelAPI(init=init, apply=lambda p, x: head(p, features(p, x)),
                    features=features, head=head, feature_dim=image_pixels,
                    num_classes=num_classes)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the sample axis: logits (..., n, K), labels
    (..., n) → (...)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0].mean(-1)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean(-1)


def _mmd2_linear(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """Linear-kernel MMD² between two feature batches (FedMMD §II), per
    client: (C, n, F), (C, n, F) → (C,)."""
    d = f1.mean(-2) - f2.mean(-2)
    return (d * d).sum(-1)


def _per_client(leaf: torch.Tensor) -> torch.Tensor:
    """A (C, ...) leaf's squares summed per client → (C,)."""
    return leaf.square().reshape(leaf.shape[0], -1).sum(-1)


def _global_features(model: ModelAPI, gparams: Tree, x: torch.Tensor
                     ) -> torch.Tensor:
    """The frozen global model's features of every client's batch, x (C, n,
    ...) → (C, n, F): one forward over the C·n images (G = 1), no
    gradient."""
    c, n = x.shape[:2]
    with torch.no_grad():
        f = model.features(tree.map(lambda g: g[None], gparams),
                           x.reshape((1, c * n) + tuple(x.shape[2:])))
    return f.reshape(c, n, -1)


# ---------------------------------------------------------------------------
# Strategy interface
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Strategy:
    """A (client objective, extras, server aggregation) triple."""
    name: str
    # client_loss(params, extras, global_params, global_extras, batch)
    #   -> (C,) losses (params, extras leaves (C, ...); x, y (C, n, ...))
    client_loss: Callable[..., torch.Tensor]
    # aggregate(stacked client params, extras, weights, client train acc,
    #           server state, global params, global extras)
    #   -> (params, extras, state)
    aggregate: Callable[..., tuple]
    init_extras: Callable[[np.ndarray, ModelAPI], Tree] = lambda k, m: ()
    init_server_state: Callable[[Tree], Tree] = lambda p: ()


def _plain_loss(model: ModelAPI):
    def loss(params, extras, gparams, gextras, batch):
        x, y = batch
        return softmax_xent(model.apply(params, x), y)
    return loss


def _fedavg_aggregate(stack_p, stack_e, w, accs, state, gp, ge):
    return (weighted_average_tree(stack_p, w),
            weighted_average_tree(stack_e, w) if tree.leaves(stack_e) else ge,
            state)


def fedavg(model: ModelAPI) -> Strategy:
    return Strategy("fedavg", _plain_loss(model), _fedavg_aggregate)


def fedprox(model: ModelAPI, mu: float = 0.1) -> Strategy:
    """FedProx (Li et al.): + (μ/2)||w − w_global||² proximal term."""
    def loss(params, extras, gparams, gextras, batch):
        x, y = batch
        task = softmax_xent(model.apply(params, x), y)
        prox = sum(_per_client(p - g[None])
                   for p, g in zip(tree.leaves(params),
                                   tree.leaves(gparams)))
        return task + 0.5 * mu * prox
    return Strategy(f"fedprox(mu={mu})", loss, _fedavg_aggregate)


def fedmmd(model: ModelAPI, gamma: float = 0.1) -> Strategy:
    """FedMMD (Yao et al.): two-stream MMD between local features and the
    frozen global model's features on the same batch."""
    def loss(params, extras, gparams, gextras, batch):
        x, y = batch
        f_local = model.features(params, x)
        task = softmax_xent(model.head(params, f_local), y)
        f_global = _global_features(model, gparams, x)
        return task + gamma * _mmd2_linear(f_local, f_global)
    return Strategy(f"fedmmd(gamma={gamma})", loss, _fedavg_aggregate)


def fedfusion(model: ModelAPI, mode: str = "multi") -> Strategy:
    """FedFusion (Yao et al.): fuse global & local features.

    mode='single': scalar α;  'multi': per-channel vector;  'conv': 1×1 conv
    (a (F, F) matrix on the feature vector). Fusion params are client
    extras, trained locally and averaged like the model."""
    fdim = model.feature_dim

    def init_extras(key, m):
        if mode == "single":
            return {"alpha": torch.tensor(0.5)}
        if mode == "multi":
            return {"alpha": torch.full((fdim,), 0.5)}
        if mode == "conv":
            return {"w_local": torch.eye(fdim) * 0.5,
                    "w_global": torch.eye(fdim) * 0.5}
        raise ValueError(mode)

    def fuse(extras, f_local, f_global):
        if mode == "conv":
            return torch.bmm(f_local, extras["w_local"].transpose(1, 2)) \
                + torch.bmm(f_global, extras["w_global"].transpose(1, 2))
        a = extras["alpha"]
        a = a[:, None, None] if a.dim() == 1 else a[:, None, :]
        return a * f_local + (1.0 - a) * f_global

    def loss(params, extras, gparams, gextras, batch):
        x, y = batch
        f_local = model.features(params, x)
        f_global = _global_features(model, gparams, x)
        logits = model.head(params, fuse(extras, f_local, f_global))
        return softmax_xent(logits, y)

    return Strategy(f"fedfusion+{mode}", loss, _fedavg_aggregate,
                    init_extras)


def cgau(model: ModelAPI, units: int = 256, layers: int = 1) -> Strategy:
    """CGAU (Rieger et al.): conditional gated activation units on top of
    the backbone: z = tanh(U f) ⊙ σ(V f); logits = W z (+ per-layer
    stacking). 'FineTuning+n×CGAU': the backbone fine-tunes jointly."""
    fdim, ncls = model.feature_dim, model.num_classes

    def init_extras(key, m):
        ks = prng.split(np.asarray(key, np.uint32), 2 * layers + 1)
        draw = lambda k, shape, s: torch.from_numpy(
            prng.normal(k, shape) * np.float32(s))
        ps = {}
        d_in = fdim
        for i in range(layers):
            s = 1.0 / np.sqrt(d_in)
            ps[f"u{i}"] = draw(ks[2 * i], (d_in, units), s)
            ps[f"v{i}"] = draw(ks[2 * i + 1], (d_in, units), s)
            d_in = units
        ps["w_out"] = torch.from_numpy(
            prng.normal(ks[-1], (d_in, ncls)) / np.float32(np.sqrt(d_in)))
        return ps

    def loss(params, extras, gparams, gextras, batch):
        x, y = batch
        z = model.features(params, x)
        for i in range(layers):
            z = torch.tanh(torch.bmm(z, extras[f"u{i}"])) \
                * torch.sigmoid(torch.bmm(z, extras[f"v{i}"]))
        return softmax_xent(torch.bmm(z, extras["w_out"]), y)

    return Strategy(f"cgau({layers}x{units})", loss, _fedavg_aggregate,
                    init_extras)


def ida(model: ModelAPI, variant: str = "plain") -> Strategy:
    """IDA (Yeganeh et al.): inverse-distance aggregation weights
    ‖w_k − w̄‖⁻¹; variants multiply by inverse train accuracy (INTRAC) or
    by data size (+FedAvg)."""
    def aggregate(stack_p, stack_e, w, accs, state, gp, ge):
        mean_p = weighted_average_tree(stack_p, torch.ones_like(w))
        dists = torch.sqrt(sum(
            _per_client(s.float() - m)
            for s, m in zip(tree.leaves(stack_p), tree.leaves(mean_p))))
        inv = 1.0 / torch.clamp_min(dists, 1e-8)
        if variant == "intrac":
            inv = inv * (1.0 / torch.clamp_min(accs, 1e-3))
        elif variant == "fedavg":
            inv = inv * w
        return (weighted_average_tree(stack_p, inv),
                weighted_average_tree(stack_e, inv) if tree.leaves(stack_e)
                else ge,
                state)

    suffix = {"plain": "", "intrac": "+intrac", "fedavg": "+fedavg"}[variant]
    return Strategy(f"ida{suffix}", _plain_loss(model), aggregate)


def _server_opt_strategy(model: ModelAPI, name: str,
                         opt: optim.Optimizer) -> Strategy:
    """FedOpt family (Reddi et al.): server optimizer on the pseudo-gradient
    Δ = w̄_clients − w_global. FedAvgM is the momentum instance (Hsu et
    al.)."""
    def aggregate(stack_p, stack_e, w, accs, state, gp, ge):
        mean_p = weighted_average_tree(stack_p, w)
        # pseudo-gradient (negated delta, so optimizers descend)
        pseudo_grad = tree.map(lambda g, m: g.float() - m, gp, mean_p)
        updates, state = opt.update(pseudo_grad, state, gp)
        new_p = optim.apply_updates(gp, updates)
        new_e = weighted_average_tree(stack_e, w) if tree.leaves(stack_e) \
            else ge
        return new_p, new_e, state

    return Strategy(name, _plain_loss(model), aggregate,
                    init_server_state=opt.init)


def fedavgm(model: ModelAPI, server_lr: float = 1.0, beta: float = 0.9
            ) -> Strategy:
    return _server_opt_strategy(model, f"fedavgm(b={beta})",
                                optim.momentum(server_lr, beta))


def fedadagrad(model: ModelAPI, server_lr: float = 0.05, tau: float = 1e-3
               ) -> Strategy:
    return _server_opt_strategy(model, "fedadagrad",
                                optim.adagrad(server_lr, eps=tau))


def fedadam(model: ModelAPI, server_lr: float = 0.02, tau: float = 1e-3
            ) -> Strategy:
    return _server_opt_strategy(model, "fedadam",
                                optim.adam(server_lr, 0.9, 0.99, eps=tau))


def fedyogi(model: ModelAPI, server_lr: float = 0.02, tau: float = 1e-3
            ) -> Strategy:
    return _server_opt_strategy(model, "fedyogi",
                                optim.yogi(server_lr, 0.9, 0.99, eps=tau))


def all_strategies(model: ModelAPI) -> dict[str, Strategy]:
    """The Table II lineup."""
    return {
        "fedavg": fedavg(model),
        "fedprox": fedprox(model),
        "fedmmd": fedmmd(model),
        "fedfusion_conv": fedfusion(model, "conv"),
        "fedfusion_multi": fedfusion(model, "multi"),
        "fedfusion_single": fedfusion(model, "single"),
        "ida": ida(model, "plain"),
        "ida_intrac": ida(model, "intrac"),
        "ida_fedavg": ida(model, "fedavg"),
        "cgau": cgau(model),
        "fedavgm": fedavgm(model),
        "fedadagrad": fedadagrad(model),
        "fedadam": fedadam(model),
        "fedyogi": fedyogi(model),
    }


# ---------------------------------------------------------------------------
# Shared trainer skeleton
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BaselineConfig:
    clients_per_round: int = 100      # M*L — matches FEDGS participation
    local_steps: int = 10             # e epochs worth of mini-batches
    lr: float = 0.01
    rounds: int = 100
    seed: int = 0


def _stack(t: Tree, c: int) -> Tree:
    """Every leaf repeated along a new leading client axis of size c."""
    return tree.map(lambda v: v.unsqueeze(0).repeat((c,) + (1,) * v.dim()),
                    t)


def make_round_step(model: ModelAPI, strategy: Strategy, cfg: BaselineConfig):
    """One federated round: the clients' local updates (S steps as a Python
    loop, all C clients batched in each) + the server aggregation. Shared
    by the per-round host harness (:func:`run_baseline` over a host batch
    callable) and the fused engine (:func:`make_baseline_experiment`).

    round_step(gparams, gextras, server_state, batches, weights) ->
    (new_params, new_extras, new_server_state, mean client train loss)."""

    def client_update(gparams, gextras, batches):
        x, y = batches                              # (C, S, n, ...), (C, S, n)
        c, steps = y.shape[:2]
        pe = (_stack(gparams, c), _stack(gextras, c))
        losses = []
        for s in range(steps):
            leaves = [v.detach().requires_grad_(True)
                      for v in tree.leaves(pe)]
            params, extras = tree.unflatten(pe, leaves)
            loss = strategy.client_loss(params, extras, gparams, gextras,
                                        (x[:, s], y[:, s]))
            # each client's loss depends on its own slice only, so the
            # gradient of the sum is every client's own gradient; a leaf
            # its objective leaves unused (CGAU's head) keeps its value
            grads = torch.autograd.grad(loss.sum(), leaves,
                                        allow_unused=True)
            pe = tree.unflatten(pe, [
                v.detach() if g is None else (v - cfg.lr * g).detach()
                for v, g in zip(leaves, grads)])
            losses.append(loss.detach())
        params, extras = pe
        # client train accuracy on the last batch (for IDA+INTRAC)
        with torch.no_grad():
            acc = accuracy(model.apply(params, x[:, -1]), y[:, -1])
        return params, extras, acc, torch.stack(losses).mean(0)

    def round_step(gparams, gextras, server_state, batches, weights):
        stack_p, stack_e, accs, losses = client_update(gparams, gextras,
                                                       batches)
        new_p, new_e, server_state = strategy.aggregate(
            stack_p, stack_e, weights, accs, server_state, gparams, gextras)
        # cast back to the original dtypes
        new_p = tree.map(lambda n, o: n.to(o.dtype), new_p, gparams)
        return new_p, new_e, server_state, losses.mean()

    return round_step


def make_round_fn(model: ModelAPI, strategy: Strategy, cfg: BaselineConfig):
    """The host harness' per-round function: :func:`make_round_step`, run
    eagerly (the JAX package jits it)."""
    return make_round_step(model, strategy, cfg)


def init_strategy_state(model: ModelAPI, strategy: Strategy, seed: int,
                        params: Tree | None = None) -> tuple:
    """The (params, extras, server_state) triple every harness starts from
    — one PRNG discipline, so host and fused runs are parameter-identical.
    The extras follow the params onto their device."""
    key = prng.PRNGKey(seed)
    if params is None:
        params = model.init(key)
    dev = tree.leaves(params)[0].device
    extras = tree.map(lambda v: v.float().to(dev),
                      strategy.init_extras(prng.fold_in(key, 1), model))
    return params, extras, strategy.init_server_state(params)


class BaselineRound(engine.GraphedRound):
    """``round_fn(state, r)`` of the fused baselines: the pool's round
    material (client ids, label and image keys) staged on the host, the
    batches drawn on the device (``pool.draw``) and the round step, eagerly
    or as one CUDA graph (``engine.GraphedRound``, no segment break: no op
    of a baseline round reads a status back)."""

    def __init__(self, round_step, pool, bytes_ext: float, device,
                 graph: bool):
        super().__init__(pool.material_size, device, graph)
        self.round_step, self.pool = round_step, pool
        self.bytes_ext = bytes_ext

    def step(self, carry, inputs, segs, variant=None):
        batches, weights = self.pool.draw(inputs)
        params, extras, server_state, loss = self.round_step(
            *carry, batches, weights)
        return (params, extras, server_state), {
            "loss": loss, "bytes_ext": torch.full(
                (), self.bytes_ext, dtype=torch.float32,
                device=loss.device)}

    def __call__(self, state, r: int):
        return self.run(state, self.pool.material(r))


def make_baseline_experiment(model: ModelAPI, strategy: Strategy, pool,
                             cfg: BaselineConfig, *,
                             eval_fn: Callable | None = None,
                             params: Tree | None = None,
                             graph: bool | None = None) -> engine.Experiment:
    """A Table II strategy as an ``engine.Experiment`` (DESIGN.md §12.4).

    State is (params, extras, server_state); each round draws its
    ``cfg.clients_per_round`` clients' batches on the device from ``pool``
    (a ``data.ClientPool``) and applies :func:`make_round_step` through a
    :class:`BaselineRound`. ``graph`` (default: whether the params lie on a
    card) captures the round as a CUDA graph; the CPU runs it eagerly.
    ``eval_fn`` sees the (params, extras) pair."""
    round_step = make_round_step(model, strategy, cfg)
    state = init_strategy_state(model, strategy, cfg.seed, params)
    dev = tree.leaves(state[0])[0].device
    if graph is None:
        graph = dev.type == "cuda"
    if graph and dev.type != "cuda":
        raise ValueError("a CUDA graph needs the params on a card")
    # §18.3 byte ledger: every baseline client syncs the dense f32 model
    # with the cloud directly (no BS tier, no compression)
    n_par = sum(leaf.numel() for leaf in tree.leaves(state[0]))
    bytes_ext = 2.0 * 4.0 * n_par * cfg.clients_per_round
    round_fn = BaselineRound(round_step, pool, bytes_ext, dev, graph)
    return engine.Experiment(
        name=strategy.name, init_state=state, round_fn=round_fn,
        params_fn=lambda st: (st[0], st[1]), eval_fn=eval_fn)


def run_baseline(model: ModelAPI, strategy: Strategy, data,
                 cfg: BaselineConfig, *, eval_fn: Callable | None = None,
                 eval_every: int = 5, params: Tree | None = None,
                 chunk: int = 0,
                 log_fn: Callable[[engine.RoundRecord], None] | None = None
                 ) -> tuple[Tree, list[engine.RoundRecord]]:
    """Run ``cfg.rounds`` federated rounds of ``strategy``.

    ``data`` selects the harness:

    * a ``data.ClientPool``: the fused engine, the batches drawn on the
      device inside each round (one CUDA graph per round on the card),
      ``chunk`` rounds per host read-back (0 = auto), eval on the device;
    * a callable ``data(r) -> (batches, weights)`` with batch leaves (C, S,
      n, ...) (``data.HostClientPool``, or numpy
      ``FactoryStreams.sample_baseline_round``): the per-round host loop
      over the same :func:`make_round_step`.

    Both return (final (params, extras), one RoundRecord per round)."""
    if hasattr(data, "round_batches"):          # fused engine path
        exp = make_baseline_experiment(model, strategy, data, cfg,
                                       eval_fn=eval_fn, params=params)
        state, logs = engine.run_experiment(
            exp, cfg.rounds,
            eval_every=eval_every if eval_fn is not None else 0,
            chunk=chunk, log_fn=log_fn)
        return (state[0], state[1]), logs
    params, extras, server_state = init_strategy_state(
        model, strategy, cfg.seed, params)
    dev = tree.leaves(params)[0].device
    round_fn = make_round_fn(model, strategy, cfg)
    logs = []
    for r in range(cfg.rounds):
        (x, y), weights = data(r)
        batches = (torch.as_tensor(x, device=dev),
                   torch.as_tensor(y, device=dev))
        params, extras, server_state, loss = round_fn(
            params, extras, server_state, batches,
            torch.as_tensor(weights, dtype=torch.float32, device=dev))
        tl = ta = None
        if eval_fn is not None and (r + 1) % eval_every == 0:
            tl, ta = eval_fn((params, extras))
            tl, ta = float(tl), float(ta)
        rec = engine.RoundRecord(round=r, loss=float(loss), test_loss=tl,
                                 test_accuracy=ta, strategy=strategy.name)
        logs.append(rec)
        if log_fn is not None:
            log_fn(rec)
    return (params, extras), logs
