"""Functional optimizers over parameter dicts, with the reference's formulas
(``repro/optim/optimizers.py``).

An :class:`Optimizer` is a pair of functions:
  init(params)                         -> opt_state
  update(grads, opt_state, params, lr) -> (updates, opt_state)
``params``, ``grads`` and ``updates`` are ``{name: tensor}`` dicts with the
same keys. ``updates`` are *descent* directions: apply with
``apply_updates``. Nothing is updated in place: every call returns new
tensors, as the reference's pure functions do.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params, float], Tuple[Params, Any]]
    name: str = "optimizer"


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(_f32(x))) for x in tree.values()))


def clip_by_global_norm(tree: Params, max_norm: float) -> Tuple[Params, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    # bf16 leaves come back f32, as the reference's jnp promotion makes them
    return {k: g.to(torch.promote_types(g.dtype, scale.dtype)) * scale
            for k, g in tree.items()}, norm


def apply_updates(params: Params, updates: Params) -> Params:
    return {
        k: (_f32(p) - _f32(updates[k])).to(p.dtype) for k, p in params.items()
    }


def sgd(momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {}
        return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}

    def update(grads, state, params, lr):
        if momentum == 0.0:
            return {k: lr * _f32(g) for k, g in grads.items()}, state
        new_m = {k: momentum * state[k] + _f32(g) for k, g in grads.items()}
        if nesterov:
            upd = {k: lr * (momentum * new_m[k] + _f32(g)) for k, g in grads.items()}
        else:
            upd = {k: lr * m for k, m in new_m.items()}
        return upd, new_m

    return Optimizer(init, update, f"sgd(m={momentum})")


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)
        some = next(iter(params.values()))
        return {
            "mu": {k: z(p) for k, p in params.items()},
            "nu": {k: z(p) for k, p in params.items()},
            "t": torch.zeros((), dtype=torch.int32, device=some.device),
        }

    def update(grads, state, params, lr):
        t = state["t"] + 1
        mu = {k: b1 * state["mu"][k] + (1 - b1) * _f32(g) for k, g in grads.items()}
        nu = {
            k: b2 * state["nu"][k] + (1 - b2) * torch.square(_f32(g))
            for k, g in grads.items()
        }
        tf = _f32(t)
        bc1 = 1 - torch.pow(torch.full_like(tf, b1), tf)
        bc2 = 1 - torch.pow(torch.full_like(tf, b2), tf)
        upd = {k: lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps) for k in mu}
        return upd, {"mu": mu, "nu": nu, "t": t}

    return Optimizer(init, update, "adam")


def adamw(
    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.01
) -> Optimizer:
    base = adam(b1, b2, eps)

    def update(grads, state, params, lr):
        upd, state2 = base.update(grads, state, params, lr)
        upd = {k: u + lr * weight_decay * _f32(params[k]) for k, u in upd.items()}
        return upd, state2

    return Optimizer(base.init, update, "adamw")
