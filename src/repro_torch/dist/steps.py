"""Step builders, the port of ``repro.dist.steps``: ``make_train_step``,
``make_serve_step``, ``make_prefill_step``, and the DFedRW pod deployment's
``make_gossip_step`` and ``make_fed_train_step``.

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
(``T.prefill_chunk``). Both run in the parameters' and the cache's dtype,
float32 or bf16, and return logits in it. Given a mesh
(``launch.mesh.make_host_mesh``), each runs tensor-parallel on the mesh's
model axis (``dist.parallel``) and returns ``(fn, p_specs)``, the
reference's pair: ``fn`` takes this rank's blocks of the parameters and
the cache, placed by ``p_specs`` (``dist.sharding.param_specs``) and
``cache_specs``.

``make_gossip_step`` and ``make_fed_train_step`` run G pods, each with its
own model, on the pod mesh of ``launch.mesh.make_pod_mesh``: stacked on one
device (every leaf with a leading pod dimension, the reference's global
view of its fed tree) or one pod a rank of a ``torch.distributed`` group.
Each pod takes a local step of ``make_train_step``'s body on its own batch
(no cross-pod traffic), and the pods gossip-average every ``gossip.every``
steps (``dist.gossip``, quantized through the int8 wire kernels at
``quant_bits < 32``).

Training keeps a model, its gradients and its velocity whole on one device,
so the training builders return no ``p_specs``: sharded training with
``opt_specs`` and a pod with a data axis are ROADMAP.md A11b (the data
axis).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch.dist.gossip import GossipConfig, mix_into
from repro_torch.dist.sharding import param_specs
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from repro_torch.optim.sgd import decreasing_lr, momentum_sgd

__all__ = ["make_train_step", "make_serve_step", "make_prefill_step", "make_gossip_step",
           "make_fed_train_step"]


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


def make_serve_step(cfg: ArchConfig, mesh=None):
    """serve_fn(params, cache, token, positions, active) -> (logits,
    new_cache), the continuous-batching decode step (``T.decode_step``):
    every cache row is a request slot at its own absolute position, and
    ``active`` freezes free and retired rows. Without a mesh, the step
    alone; with one, (serve_fn, p_specs) and the step runs on the mesh's
    model axis, its logits whole on every rank."""
    axis = mesh.axis if mesh is not None else None

    def serve_fn(params, cache, token, positions, active):
        return T.decode_step(cfg, params, cache, token, positions=positions, active=active,
                             axis=axis)

    if mesh is None:
        return serve_fn
    return serve_fn, param_specs(T.abstract_params(cfg), mesh)


def make_prefill_step(cfg: ArchConfig, mesh=None):
    """prefill_fn(params, cache, tokens (B,C), positions (B,), n_valid (B,))
    -> (logits (B,C,V), new_cache): the chunked batched prefill into the
    decode cache at per-row offsets (``T.prefill_chunk``). With a mesh,
    (prefill_fn, p_specs), as :func:`make_serve_step`; ``prefill_fn(...,
    last=True)`` returns each row's last logits alone, (B, 1, V)."""
    axis = mesh.axis if mesh is not None else None

    def prefill_fn(params, cache, tokens, positions, n_valid, last=False):
        return T.prefill_chunk(cfg, params, cache, tokens, positions, n_valid, axis=axis,
                               last=last)

    if mesh is None:
        return prefill_fn
    return prefill_fn, param_specs(T.abstract_params(cfg), mesh)


def make_gossip_step(cfg: ArchConfig, mesh, gossip: GossipConfig, *,
                     dtype=torch.float32):
    """Cross-pod decentralized averaging of the pods' models.

    Returns (gstep, fed_abstract): ``gstep(params, *, uniforms=None,
    generator=None)`` mixes ``params`` in place with the doubly stochastic
    ``dist.gossip.mixing_weights`` (the mean over the pods is preserved) and
    returns them. ``params`` stacks one model a pod along a leading dimension
    on ``mesh.device``, or is this rank's pod when ``mesh.group`` is a
    process group. ``uniforms(li, oi, pod)`` or ``generator`` feed the
    stochastic quantizer when ``gossip.quant_bits < 32``. ``fed_abstract``
    is the stacked tree on the meta device: ``(pods, ...)`` of each leaf of
    ``T.abstract_params(cfg, dtype)``."""
    fed_abstract = tree_map(lambda l: torch.empty((mesh.pods, *l.shape), dtype=l.dtype,
                                                  device="meta"),
                            T.abstract_params(cfg, dtype))

    def gstep(params, *, uniforms=None, generator=None):
        return mix_into(params, gossip, group=mesh.group, uniforms=uniforms,
                        generator=generator)

    return gstep, fed_abstract


def make_fed_train_step(cfg: ArchConfig, mesh, gossip: GossipConfig, *,
                        lr_r: float = 5.0, beta: float = 0.9, remat: bool = True,
                        dtype=torch.float32, scheduled: bool = False):
    """The DFedRW pod deployment: ``step_fn(params, vel, batch, step, *,
    uniforms=None, generator=None) -> (params, vel, mean_loss)``; returns
    (step_fn, fed_abstract).

    Stacked on one device, ``params``, ``vel`` and ``batch`` carry a
    leading pod dimension; in a process group they are this rank's pod's.
    Every step runs an independent local momentum-SGD step per pod, the
    body of :func:`make_train_step` on the pod's views ``{leaf[i]}`` (one
    pod after another: ``torch.func.vmap`` does not pass through the
    kernels' autograd Functions), at ``decreasing_lr(step + 1, r=lr_r)``
    for every pod; the loss is the mean of the pods' losses. Every
    ``gossip.every``-th step the pods then gossip-average in place
    (quantized when ``quant_bits < 32``, with ``uniforms`` or
    ``generator``).

    ``scheduled=True`` builds the trace-driven variant ``step_fn(params,
    vel, batch, step, do_gossip, *, uniforms=None, generator=None)``: the
    pods gossip when ``do_gossip`` (a host bool, one element of
    ``SimTrace.gossip_flags()`` a step) is true, and ``gossip.every`` is
    ignored."""
    gstep, fed_abstract = make_gossip_step(cfg, mesh, gossip, dtype=dtype)
    local = make_train_step(cfg, lr_r=lr_r, beta=beta, remat=remat)
    every = max(int(gossip.every), 1)

    def local_loss(params, vel, batch, step):
        """Each pod's local step, in place; the mean of the pods' losses."""
        if mesh.group is not None:
            loss = local(params, vel, batch, step)[2].reshape(1)
            losses = [torch.empty_like(loss) for _ in range(mesh.pods)]
            dist.all_gather(losses, loss, group=mesh.group)
        else:
            losses = [local(*(tree_map(lambda l: l[i], tree) for tree in (params, vel, batch)),
                            step)[2].reshape(1)
                      for i in range(mesh.pods)]
        return torch.cat(losses).mean()

    def scheduled_fn(params, vel, batch, step, do_gossip, *, uniforms=None, generator=None):
        loss = local_loss(params, vel, batch, step)
        if do_gossip:
            gstep(params, uniforms=uniforms, generator=generator)
        return params, vel, loss

    if scheduled:
        return scheduled_fn, fed_abstract

    def step_fn(params, vel, batch, step, *, uniforms=None, generator=None):
        return scheduled_fn(params, vel, batch, step, (int(step) + 1) % every == 0,
                            uniforms=uniforms, generator=generator)

    return step_fn, fed_abstract
