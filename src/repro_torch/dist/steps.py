"""Step builders of one device, the port of ``repro.dist.steps``'s
``make_train_step``, ``make_serve_step`` and ``make_prefill_step``.

``make_train_step``'s ``step_fn(params, vel, batch, step)`` takes the
gradient of ``T.loss_fn`` (autograd; on the card through the backward
kernels of ``block_attn`` and ``ssd_scan``), the paper's decreasing
learning rate ``decreasing_lr(step + 1, r=lr_r)`` and a heavy-ball
momentum step (``optim.momentum_sgd``), as the reference's
``jax.value_and_grad`` followed by ``momentum_sgd``.

``make_serve_step`` builds the serve engine's per-slot decode step over
the cache (the reference's ``slots=True`` variant; its ``slots=False``
variant serves only ``launch/dryrun.py``, which is not ported) and
``make_prefill_step`` the chunked batched prefill into it
(``T.prefill_chunk``).

There is no mesh and no ``p_specs``: the model, its gradients, its
velocity and the cache live on one device, so each builder returns its
step alone. Sharding (``param_specs``, ``cache_specs``,
``serve_arg_specs``), and the federated step built on the train step's
pieces (``make_fed_train_step``), are ROADMAP.md queue A, item 11.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from repro_torch.optim.sgd import decreasing_lr, momentum_sgd

__all__ = ["make_train_step", "make_serve_step", "make_prefill_step"]


def make_train_step(cfg: ArchConfig, *, lr_r: float = 5.0, beta: float = 0.9,
                    remat: bool = True):
    """step_fn(params, vel, batch, step) -> (params, vel, loss).

    ``vel`` is a zeros-like mirror of ``params`` (``optim.momentum_init``).
    Both are updated in place and returned; ``loss`` is the detached scalar
    of this step's batch, before the update. ``remat`` recomputes each block
    in the backward pass (memory, not numbers)."""

    def step_fn(params: dict, vel: dict, batch: dict, step: int):
        leaves, spec = tree_flatten(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss = T.loss_fn(cfg, params, batch, remat=remat)
                grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        lr = decreasing_lr(int(step) + 1, r=lr_r)
        params, vel = momentum_sgd(params, vel, tree_unflatten(list(grads), spec), lr, beta)
        return params, vel, loss.detach()

    return step_fn


def make_serve_step(cfg: ArchConfig):
    """serve_fn(params, cache, token, positions, active) -> (logits,
    new_cache), the continuous-batching decode step (``T.decode_step``):
    every cache row is a request slot at its own absolute position, and
    ``active`` freezes free and retired rows."""

    def serve_fn(params, cache, token, positions, active):
        return T.decode_step(cfg, params, cache, token, positions=positions, active=active)

    return serve_fn


def make_prefill_step(cfg: ArchConfig):
    """prefill_fn(params, cache, tokens (B,C), positions (B,), n_valid (B,))
    -> (logits (B,C,V), new_cache): the chunked batched prefill into the
    decode cache at per-row offsets (``T.prefill_chunk``)."""

    def prefill_fn(params, cache, tokens, positions, n_valid):
        return T.prefill_chunk(cfg, params, cache, tokens, positions, n_valid)

    return prefill_fn
