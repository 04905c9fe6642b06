"""Server optimizers on parameter trees (port of
``repro.optim.optimizers``): SGD, momentum, Adam.

    opt = make_optimizer("momentum", lr=0.05, beta=0.9)
    state = opt.init(params)
    params, state = opt.update(grads, state, params)

Functional like the reference: ``update`` returns new tensors and leaves its
inputs untouched. The f32 order follows the reference: ``p - lr * g`` with
``g`` cast to the parameter's dtype first; Adam's bias corrections ``1 - b **
t`` are f32 tensors on the params' device, ``t`` an f32 step count, as the
reference computes them.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]  # (grads, state, params)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=torch.float32)


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params):
        return tree_map(lambda p, g: p - lr * g.to(p.dtype), params,
                        grads), state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9,
             nesterov: bool = False) -> Optimizer:
    def init(params):
        return tree_map(_zeros_f32, params)

    def update(grads, state, params):
        new_m = tree_map(lambda m, g: beta * m + g.to(torch.float32), state,
                         grads)
        step = (tree_map(lambda m, g: beta * m + g.to(torch.float32), new_m,
                         grads) if nesterov else new_m)
        new_p = tree_map(lambda p, s: p - lr * s.to(p.dtype), params, step)
        return new_p, new_m

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    def init(params):
        return {"m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params), "t": 0}

    def update(grads, state, params):
        t = state["t"] + 1
        device = tree_leaves(params)[0].device
        t32 = torch.tensor(t, dtype=torch.float32, device=device)
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                     state["m"], grads)
        v = tree_map(lambda v, g: b2 * v
                     + (1 - b2) * torch.square(g.to(torch.float32)),
                     state["v"], grads)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=device), t32)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=device), t32)
        new_p = tree_map(
            lambda p, m_, v_: p - (lr * (m_ / bc1)
                                   / (torch.sqrt(v_ / bc2) + eps)).to(p.dtype),
            params, m, v)
        return new_p, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def make_optimizer(name: str, lr: float, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "momentum":
        return momentum(lr, **kw)
    if name == "adam":
        return adam(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
