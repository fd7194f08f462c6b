"""Step builders, the port of ``repro.dist.steps``: ``make_train_step``,
``make_serve_step``, ``make_prefill_step``, and the DFedRW pod deployment's
``make_gossip_step`` and ``make_fed_train_step``.

``make_train_step``'s ``step_fn(params, vel, batch, step)`` takes the
gradient of ``T.loss_fn`` (autograd; on the card through the backward
kernels of ``block_attn`` and ``ssd_scan``), the paper's decreasing
learning rate ``decreasing_lr(step + 1, r=lr_r)`` and a heavy-ball
momentum step (``optim.momentum_sgd``), as the reference's
``jax.value_and_grad`` followed by ``momentum_sgd``. Given a mesh
(``launch.mesh.make_host_mesh``) it trains on both of the mesh's axes,
data-parallel on the data axis and tensor-parallel on the model axis, and
returns ``(step_fn, p_specs)``, the reference's pair: each rank stores its
blocks of the parameters (``p_specs``) and of the velocity (``opt_specs``
or ``p_specs``) and takes its block of the batch (``batch_specs``); see
:func:`make_train_step`.

``make_serve_step`` builds the serve engine's per-slot decode step over
the cache (the reference's ``slots=True`` variant; its ``slots=False``
variant serves only ``launch/dryrun.py``, which is not ported) and
``make_prefill_step`` the chunked batched prefill into it
(``T.prefill_chunk``). Both run in the parameters' and the cache's dtype,
float32 or bf16, and return logits in it. Given a mesh
(``launch.mesh.make_host_mesh``), each returns ``(fn, p_specs)``, the
reference's pair, and ``fn`` runs on this rank's share of the mesh: on the
model axis, tensor-parallel (``dist.parallel``), with its blocks of the
parameters and of the cache's heads or d; on the data axis, its slots,
the rows that ``sharding.slot_rows`` gives it (its block of the cache's
slot dim under ``cache_specs`` and of the step's arguments under
``serve_arg_specs``). The step is row by row, so a rank's rows need nothing
of another data rank's. ``p_specs`` is the placement ``fn`` takes: the
parameters are whole along the data axis (``sharding.model_specs`` of
``param_specs``), where the reference stores them split over it and
gathers them inside every step.

``make_gossip_step`` and ``make_fed_train_step`` run G pods, each with its
own model, on the pod mesh of ``launch.mesh.make_pod_mesh``: stacked on one
device (every leaf with a leading pod dimension, the reference's global
view of its fed tree), or the ranks of a ``torch.distributed`` group as the
reference's ``(pod, data, 1)`` mesh, one pod a rank or a pod on several
data ranks. Each pod takes a local step of ``make_train_step``'s body on
its own batch (no cross-pod traffic; data-parallel over the pod's data
ranks), and the pods gossip-average every ``gossip.every`` steps
(``dist.gossip``, each rank's blocks over its gossip group, quantized
through the int8 wire kernels at ``quant_bits < 32``). Both return the
reference's triples, with ``p_specs = param_specs(abstract, mesh,
fed_axis="pod")``, the placement of the stacked tree on the pod mesh.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch.dist.gossip import GossipConfig, mix_into
from repro_torch.dist.sharding import (block_slices, model_specs, opt_specs, param_specs,
                                      zip_specs)
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from repro_torch.optim.sgd import decreasing_lr, momentum_sgd

__all__ = ["make_train_step", "make_serve_step", "make_prefill_step", "make_gossip_step",
           "make_fed_train_step", "whole_params"]


def make_train_step(cfg: ArchConfig, mesh=None, *, lr_r: float = 5.0, beta: float = 0.9,
                    remat: bool = True):
    """step_fn(params, vel, batch, step) -> (params, vel, loss).

    ``vel`` is a zeros-like mirror of ``params`` (``optim.momentum_init``).
    Both are updated in place and returned; ``loss`` is the detached scalar
    of this step's batch, before the update. ``remat`` recomputes each block
    in the backward pass (memory, not numbers).

    Without a mesh, the step alone, on whole trees. With one, ``(step_fn,
    p_specs)``: the step is data-parallel over ``mesh.data_axis`` and
    tensor-parallel over ``mesh.axis``, and takes this rank's blocks,
    ``params`` placed by ``p_specs``
    (``sharding.param_specs``), ``vel`` by ``sharding.opt_specs`` or by
    ``p_specs`` (leaf by leaf, told apart by the block's shape; the same
    bits either way), and ``batch`` by ``sharding.batch_specs``: its rows,
    or with ``batch_spec=`` (the spec tree ``batch_specs`` gave the global
    batch) a share of a batch it does not cut by rows. In a step a rank
    gathers every parameter leaf over the data axis into its model block,
    takes the gradient of its share of the batch through the model on the
    model axis (``T.loss_fn(..., axis=mesh.axis)``; the adjoints of
    ``dist.parallel``'s collectives make each block's gradient complete),
    averages each gradient over the data axis in rank order in float32
    (:meth:`MeshAxis.mean`: the global batch's gradient, the same bits on
    every rank) and a leaf's that the model axis does not split over that
    axis too (its ranks computed it alike, but the card's atomics may add
    in another order: the mean keeps their copies equal), updates its
    velocity block and the matching slice of the parameter (the data cut
    within its model block), and gathers again a leaf that ``p_specs``
    replicates where its velocity is split. The loss is the global batch's
    mean, the same on every rank. A rank's share:

    - rows (``batch_specs`` cut dim 0): the NLL over its rows, and MoE aux
      losses over the global batch (``moe_route``'s ``data_axis``);
    - positions (a batch of 1, cut on the sequence): the whole rows are
      gathered, and the NLL is over its own positions;
    - the whole batch (``batch_specs`` replicated it): every rank runs it.
    """
    if mesh is None:
        return _local_step(cfg, lr_r, beta, remat)
    abstract = T.abstract_params(cfg)
    p_specs, o_specs = param_specs(abstract, mesh), opt_specs(abstract, mesh)
    shapes = zip_specs(lambda leaf, _: tuple(leaf.shape), abstract, abstract)
    data, model = mesh.data_axis, mesh.axis

    def block(shape, spec):
        return tuple(cut.stop - cut.start for cut in block_slices(shape, spec, mesh, mesh.rank))

    def data_cut(shape, spec):
        """This rank's data block within its model block of a leaf."""
        inner = tuple(n // mesh.model if ax == "model" else n for n, ax in zip(shape, spec))
        return block_slices(inner, tuple(ax if ax == "data" else None for ax in spec),
                            {"data": mesh.data}, data.rank)

    def step_fn(params: dict, vel: dict, batch: dict, step: int, batch_spec=None):
        whole = whole_params(params, p_specs, mesh)
        rows = _rows(params, vel, whole, shapes, p_specs, o_specs)
        leaves = [row[2] for row in rows]
        local, span = _share(data, batch, batch_spec)
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss = T.loss_fn(cfg, whole, local, remat=remat, axis=model,
                                 data_axis=data if span == "rows" else None,
                                 span=span if isinstance(span, tuple) else None)
                grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        lr = decreasing_lr(int(step) + 1, r=lr_r)
        grads = _model_mean(model, grads, [row[4] for row in rows])
        for (p, v, _, shape, p_spec, o_spec), g in zip(rows, grads):
            g = data.mean(g)
            spec = p_spec if tuple(v.shape) == block(shape, p_spec) else o_spec
            if tuple(v.shape) != block(shape, spec):
                raise ValueError(f"a velocity block of shape {tuple(v.shape)} for a leaf of "
                                 f"shape {shape}: placed by neither p_specs {p_spec} nor "
                                 f"opt_specs {o_spec}")
            cut = data_cut(shape, spec)
            if spec == p_spec:
                momentum_sgd([p], [v], [g[cut]], lr, beta)
            else:                  # p_specs replicates the leaf, opt_specs splits it
                momentum_sgd([p[cut]], [v], [g[cut]], lr, beta)
                p.copy_(_gather(data, p[cut], spec))
        return params, vel, data.mean(loss.detach())

    return step_fn, p_specs


def _model_mean(axis, grads, specs) -> list:
    """``grads`` with those of the leaves that ``specs`` do not split on
    the model ``axis`` averaged over it in rank order: one
    :meth:`MeshAxis.mean` of their concatenation in float32, each rounded
    back to its dtype."""
    grads = list(grads)
    picks = [i for i, spec in enumerate(specs) if "model" not in spec]
    if axis.size == 1 or not picks:
        return grads
    flat = axis.mean(torch.cat([grads[i].float().reshape(-1) for i in picks]))
    for i, part in zip(picks, flat.split([grads[i].numel() for i in picks])):
        grads[i] = part.view_as(grads[i]).to(grads[i].dtype)
    return grads


def _local_step(cfg: ArchConfig, lr_r: float, beta: float, remat: bool):
    """The step on one device, on whole trees."""

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


def _rows(tree, *mirrors) -> list[tuple]:
    """(leaf, each mirror's entry at the leaf's place) for every leaf of
    ``tree``, in ``zip_specs``'s order. A mirror has the tree's nesting
    down to its leaves (a spec tree's tuples are entries)."""
    if isinstance(tree, dict):
        return [row for k, v in tree.items() for row in _rows(v, *(m[k] for m in mirrors))]
    if isinstance(tree, (list, tuple)):
        return [row for i, v in enumerate(tree) for row in _rows(v, *(m[i] for m in mirrors))]
    return [(tree, *mirrors)]


def whole_params(params, p_specs, mesh):
    """The whole tree from this rank's blocks of a data-parallel step's
    parameters (or of a velocity by its specs): each leaf gathered over the
    mesh's data axis. Every rank of the axis makes the same calls."""
    return zip_specs(lambda leaf, spec: _gather(mesh.data_axis, leaf, spec), params, p_specs)


def _gather(axis, block: torch.Tensor, spec: tuple) -> torch.Tensor:
    """The whole of a leaf that ``spec`` may split on the data axis: its
    ranks' blocks gathered along that dim, or the block itself."""
    return axis.all_gather(block, spec.index("data")) if "data" in spec else block


def _share(axis, batch: dict, batch_spec):
    """(this rank's batch for the loss, its share): ``"rows"`` when the batch
    is cut by rows (no ``batch_spec``, or one that cuts dim 0); ``(lo, hi)``
    when it is cut on the sequence, the other leaves gathered whole and the
    labels this rank's positions [lo, hi); ``"whole"`` when it is
    replicated."""
    spec = batch_spec["labels"] if batch_spec is not None else ("data",)
    if axis.size == 1 or spec[0] == "data":
        return batch, "rows"
    if "data" not in spec:
        return batch, "whole"
    whole = {key: leaf if key == "labels" else _gather(axis, leaf, batch_spec[key])
             for key, leaf in batch.items()}
    s = batch["labels"].shape[1]
    return whole, (axis.rank * s, (axis.rank + 1) * s)


def make_serve_step(cfg: ArchConfig, mesh=None):
    """serve_fn(params, cache, token, positions, active) -> (logits,
    new_cache), the continuous-batching decode step (``T.decode_step``):
    every cache row is a request slot at its own absolute position, and
    ``active`` freezes free and retired rows. Without a mesh, the step
    alone. With one, (serve_fn, p_specs): the step runs on the mesh's model
    axis, its logits whole on every rank, over the rows that the caller
    passes, this rank's slots on the data axis (``sharding.slot_rows``):
    the cache's rows and the arguments' rows alike. ``p_specs`` places the
    parameters that ``serve_fn`` takes (:func:`_serve_specs`)."""
    axis = mesh.axis if mesh is not None else None

    def serve_fn(params, cache, token, positions, active):
        return T.decode_step(cfg, params, cache, token, positions=positions, active=active,
                             axis=axis)

    if mesh is None:
        return serve_fn
    return serve_fn, _serve_specs(cfg, mesh)


def make_prefill_step(cfg: ArchConfig, mesh=None):
    """prefill_fn(params, cache, tokens (B,C), positions (B,), n_valid (B,))
    -> (logits (B,C,V), new_cache): the chunked batched prefill into the
    decode cache at per-row offsets (``T.prefill_chunk``). With a mesh,
    (prefill_fn, p_specs), as :func:`make_serve_step`, B being this rank's
    rows; ``prefill_fn(..., last=True)`` returns each row's last logits
    alone, (B, 1, V)."""
    axis = mesh.axis if mesh is not None else None

    def prefill_fn(params, cache, tokens, positions, n_valid, last=False):
        return T.prefill_chunk(cfg, params, cache, tokens, positions, n_valid, axis=axis,
                               last=last)

    if mesh is None:
        return prefill_fn
    return prefill_fn, _serve_specs(cfg, mesh)


def _serve_specs(cfg: ArchConfig, mesh):
    """The serving steps' parameter placement: ``param_specs`` on the model
    axis, whole along the data axis (``sharding.model_specs``), so a decode
    step gathers no weight across the data ranks."""
    return model_specs(param_specs(T.abstract_params(cfg), mesh))


def make_gossip_step(cfg: ArchConfig, mesh, gossip: GossipConfig, *,
                     dtype=torch.float32):
    """Cross-pod decentralized averaging of the pods' models.

    Returns (gstep, p_specs, fed_abstract): ``gstep(params, *,
    uniforms=None, generator=None)`` mixes ``params`` in place with the
    doubly stochastic ``dist.gossip.mixing_weights`` (the mean over the pods
    is preserved) and returns them. ``params`` stacks one model a pod along
    a leading dimension on ``mesh.device``, or, when ``mesh.group`` is a
    process group, holds this rank's blocks of its pod's model (the whole
    model at data = 1): they mix over the mesh's gossip group, a wire tensor
    a (block, leaf, offset). ``uniforms(li, oi, pod)`` or ``generator``
    feed the stochastic quantizer when ``gossip.quant_bits < 32``.
    ``p_specs`` is ``param_specs(T.abstract_params(cfg, dtype), mesh,
    fed_axis="pod")``, the placement of the stacked tree ``fed_abstract``
    (on the meta device: ``(pods, ...)`` of each leaf) on the pod mesh."""
    base = T.abstract_params(cfg, dtype)
    p_specs = param_specs(base, mesh, fed_axis="pod")
    fed_abstract = tree_map(lambda l: torch.empty((mesh.pods, *l.shape), dtype=l.dtype,
                                                  device="meta"), base)
    group = None if mesh.group is None else mesh.gossip_axis

    def gstep(params, *, uniforms=None, generator=None):
        return mix_into(params, gossip, group=group, uniforms=uniforms, generator=generator)

    return gstep, p_specs, fed_abstract


def make_fed_train_step(cfg: ArchConfig, mesh, gossip: GossipConfig, *,
                        lr_r: float = 5.0, beta: float = 0.9, remat: bool = True,
                        dtype=torch.float32, scheduled: bool = False):
    """The DFedRW pod deployment: ``step_fn(params, vel, batch, step, *,
    uniforms=None, generator=None, batch_spec=None) -> (params, vel,
    mean_loss)``; returns (step_fn, p_specs, fed_abstract), as
    :func:`make_gossip_step`.

    Stacked on one device, ``params``, ``vel`` and ``batch`` carry a
    leading pod dimension, and each pod runs the body of
    :func:`make_train_step` on its views ``{leaf[i]}`` (one pod after
    another: ``torch.func.vmap`` does not pass through the kernels'
    autograd Functions). In a process group they are this rank's: at data
    = 1 its pod's, and on a pod mesh with a data axis its blocks of its
    pod's parameters (``param_specs`` on ``mesh.host``), of the velocity
    (``opt_specs`` or ``param_specs``) and of the pod's batch
    (``batch_specs``; ``batch_spec`` as ``make_train_step(cfg, mesh)``'s
    step takes it): the pod's step is that data-parallel step on
    ``mesh.host``, gradients averaged over the pod's data ranks. Every pod
    steps at ``decreasing_lr(step + 1, r=lr_r)``; the loss is the mean over
    the pods of each pod's global-batch loss, the same on every rank. Every
    ``gossip.every``-th step the pods then gossip-average in place
    (quantized when ``quant_bits < 32``, with ``uniforms`` or
    ``generator``).

    ``scheduled=True`` builds the trace-driven variant ``step_fn(params,
    vel, batch, step, do_gossip, *, uniforms=None, generator=None,
    batch_spec=None)``: the pods gossip when ``do_gossip`` (a host bool, one
    element of ``SimTrace.gossip_flags()`` a step) is true, and
    ``gossip.every`` is ignored."""
    gstep, p_specs, fed_abstract = make_gossip_step(cfg, mesh, gossip, dtype=dtype)
    if mesh.data > 1:
        local = make_train_step(cfg, mesh.host, lr_r=lr_r, beta=beta, remat=remat)[0]
    else:
        local = make_train_step(cfg, lr_r=lr_r, beta=beta, remat=remat)
    every = max(int(gossip.every), 1)

    def local_loss(params, vel, batch, step, batch_spec):
        """Each pod's local step, in place; the mean of the pods' losses."""
        if mesh.group is not None:
            kw = {"batch_spec": batch_spec} if mesh.data > 1 else {}
            loss = local(params, vel, batch, step, **kw)[2].reshape(1)
            return mesh.pod_axis.all_gather(loss, 0).mean()
        losses = [local(*(tree_map(lambda l: l[i], tree) for tree in (params, vel, batch)),
                        step)[2].reshape(1)
                  for i in range(mesh.pods)]
        return torch.cat(losses).mean()

    def scheduled_fn(params, vel, batch, step, do_gossip, *, uniforms=None, generator=None,
                     batch_spec=None):
        loss = local_loss(params, vel, batch, step, batch_spec)
        if do_gossip:
            gstep(params, uniforms=uniforms, generator=generator)
        return params, vel, loss

    if scheduled:
        return scheduled_fn, p_specs, fed_abstract

    def step_fn(params, vel, batch, step, *, uniforms=None, generator=None, batch_spec=None):
        return scheduled_fn(params, vel, batch, step, (int(step) + 1) % every == 0,
                            uniforms=uniforms, generator=generator, batch_spec=batch_spec)

    return step_fn, p_specs, fed_abstract
