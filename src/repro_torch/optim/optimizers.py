"""Minimal optax-style optimizers (client-side and FedOpt server-side), the
JAX package's ``optim/optimizers.py`` over the port's trees
(``repro_torch.tree``).

SGD (Eq. 3), server momentum (FedAvgM), Adagrad/Adam/Yogi
(FedAdagrad/FedAdam/FedYogi, Reddi et al. 2021). Each optimizer is an
(init, update) pair over trees; ``update`` returns additive updates:
``params_new = params + updates``. Adam's and Yogi's step count ``t`` is a
0-d int32 tensor on the params' device, so a round captured as a CUDA
graph increments it on the card.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from .. import tree

Tree = Any


class Optimizer(NamedTuple):
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree], tuple[Tree, Tree]]


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree.map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _zeros(params: Tree) -> Tree:
    return tree.map(torch.zeros_like, params)


def _step_count(params: Tree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree.leaves(params)[0].device)


def _bias_correction(b: float, t: torch.Tensor) -> torch.Tensor:
    """1 − b^t in f32. The f32 ``pow`` may differ from XLA's in the last
    bit; the servers' parity tolerance (1e-5) covers it."""
    base = torch.full((), b, dtype=torch.float32, device=t.device)
    return 1 - torch.pow(base, t.float())


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params=None):
        return tree.map(lambda g: -lr * g, grads), state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9, nesterov: bool = False
             ) -> Optimizer:
    def update(grads, m, params=None):
        m = tree.map(lambda mm, g: beta * mm + g, m, grads)
        if nesterov:
            upd = tree.map(lambda mm, g: -lr * (beta * mm + g), m, grads)
        else:
            upd = tree.map(lambda mm: -lr * mm, m)
        return upd, m

    return Optimizer(_zeros, update)


def adagrad(lr: float, eps: float = 1e-3) -> Optimizer:
    """FedAdagrad's server optimizer (β1=β2=0, τ=eps in Reddi et al.)."""
    def update(grads, v, params=None):
        v = tree.map(lambda vv, g: vv + g * g, v, grads)
        upd = tree.map(lambda g, vv: -lr * g / (torch.sqrt(vv) + eps),
                       grads, v)
        return upd, v

    return Optimizer(_zeros, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.99, eps: float = 1e-3
         ) -> Optimizer:
    def init(params):
        return (_zeros(params), _zeros(params), _step_count(params))

    def update(grads, state, params=None):
        m, v, t = state
        t = t + 1
        m = tree.map(lambda mm, g: b1 * mm + (1 - b1) * g, m, grads)
        v = tree.map(lambda vv, g: b2 * vv + (1 - b2) * g * g, v, grads)
        c1, c2 = _bias_correction(b1, t), _bias_correction(b2, t)
        upd = tree.map(
            lambda mm, vv: -lr * (mm / c1) / (torch.sqrt(vv / c2) + eps),
            m, v)
        return upd, (m, v, t)

    return Optimizer(init, update)


def yogi(lr: float, b1: float = 0.9, b2: float = 0.99, eps: float = 1e-3
         ) -> Optimizer:
    """Yogi: additive, sign-controlled second-moment update (Zaheer et
    al.)."""
    def init(params):
        return (_zeros(params),
                tree.map(lambda p: torch.full_like(p, 1e-6), params),
                _step_count(params))

    def update(grads, state, params=None):
        m, v, t = state
        t = t + 1
        m = tree.map(lambda mm, g: b1 * mm + (1 - b1) * g, m, grads)
        v = tree.map(
            lambda vv, g: vv - (1 - b2) * torch.sign(vv - g * g) * g * g,
            v, grads)
        c1 = _bias_correction(b1, t)
        upd = tree.map(
            lambda mm, vv: -lr * (mm / c1)
            / (torch.sqrt(torch.clamp_min(vv, 0.0)) + eps), m, v)
        return upd, (m, v, t)

    return Optimizer(init, update)


_REGISTRY = {
    "sgd": sgd,
    "momentum": momentum,
    "adagrad": adagrad,
    "adam": adam,
    "yogi": yogi,
}


def get(name: str, lr: float, **kw) -> Optimizer:
    return _REGISTRY[name](lr, **kw)
