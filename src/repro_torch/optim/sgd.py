"""Optimizers, the port of ``repro.optim.sgd``.

Protocol scale uses the paper's decreasing-step SGD schedule:

    eta^kbar = 1 / (R * kbar^q),  kbar = (t-1)K + k   (paper §VI-B, q=0.499)

which satisfies Assumption 2 for 1/2 < q < 1. Pod scale adds momentum SGD
(what ``dist.steps.make_train_step`` runs) and AdamW.

They work on the port's parameter trees (nested dicts, lists and tuples of
float32 tensors, walked by ``torch.utils._pytree``), in the reference's
arithmetic order. The momentum step updates the given trees in place,
under ``torch.no_grad()``: a full-width model then holds its weights,
gradients and velocity and nothing more. ``sgd_update`` and
``adamw_update`` return new trees, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

__all__ = [
    "decreasing_lr",
    "sgd_update",
    "MomentumState",
    "momentum_init",
    "momentum_sgd",
    "momentum_update",
    "adamw_init",
    "adamw_update",
]


def decreasing_lr(kbar: int, r: float = 5.0, q: float = 0.499) -> float:
    """eta^kbar = 1/(R * kbar^q); kbar counts global SGD steps from 1.

    Evaluated in float32 on the host, as the reference evaluates it in
    float32; returned as the exact Python value of that float32."""
    k = np.maximum(np.float32(kbar), np.float32(1.0))
    return float(np.float32(1.0) / (np.float32(r) * k ** np.float32(q)))


@torch.no_grad()
def sgd_update(params: Any, grads: Any, lr: float) -> Any:
    """p - lr * g, leaf by leaf, as new tensors."""
    return tree_map(lambda p, g: p - lr * g, params, grads)


@dataclasses.dataclass
class MomentumState:
    velocity: Any


@torch.no_grad()
def momentum_init(params: Any) -> MomentumState:
    return MomentumState(tree_map(torch.zeros_like, params))


@torch.no_grad()
def momentum_sgd(params: Any, vel: Any, grads: Any, lr: float, beta: float = 0.9
                 ) -> tuple[Any, Any]:
    """Heavy-ball update, in place: v <- beta * v + g, then p <- p - lr * v
    (as the reference's, two roundings each, no fused multiply-add).
    Returns the same ``(params, vel)`` trees, updated."""
    for p, v, g in zip(tree_leaves(params), tree_leaves(vel), tree_leaves(grads)):
        v.mul_(beta).add_(g)
        p.sub_(lr * v)
    return params, vel


def momentum_update(params: Any, grads: Any, state: MomentumState, lr: float,
                    beta: float = 0.9) -> tuple[Any, MomentumState]:
    new, vel = momentum_sgd(params, state.velocity, grads, lr, beta)
    return new, MomentumState(vel)


@torch.no_grad()
def adamw_init(params: Any) -> dict:
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "count": torch.zeros((), dtype=torch.int32)}


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: dict, lr: float, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1
                 ) -> tuple[Any, dict]:
    """The reference's AdamW: moments, bias correction by 1 - b**count in
    float32, then p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p); new trees."""
    count = state["count"] + 1
    cf = count.to(torch.float32)
    c1 = 1 - torch.tensor(b1, dtype=torch.float32) ** cf
    c2 = 1 - torch.tensor(b2, dtype=torch.float32) ** cf
    m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
    v = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state["v"], grads)

    def step(p, m, v):
        c1d, c2d = c1.to(p.device), c2.to(p.device)
        return p - lr * ((m / c1d) / (torch.sqrt(v / c2d) + eps) + weight_decay * p)

    return tree_map(step, params, m, v), {"m": m, "v": v, "count": count}
