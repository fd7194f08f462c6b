"""The axes of a ``("data", "model")`` mesh: the work the reference leaves
to XLA's partitioner, written out over ``torch.distributed`` groups.

The reference places its parameters and cache by ``dist.sharding``'s specs
on a ``("data", "model")`` mesh and lets the partitioner insert the
collectives. Here every rank of the model axis holds its block of each leaf
(``sharding.shard_tree``) and the layer functions of ``models.layers``
compute on it, Megatron-style, where a spec's split falls on a unit
boundary (a head, an FFN column, an expert, a vocab row): column-parallel
products give each rank its own heads or columns, and row-parallel products
a partial sum that :meth:`MeshAxis.sum` adds up. Where a spec cuts inside
a unit (MQA's single K/V head, an odd vocab falling to d), the leaf is
gathered whole before use (:meth:`MeshAxis.whole`): the sharded model
computes the unsharded function either way. On the data axis each rank
holds its block of the parameters and the velocity and its block of the
batch; ``dist.steps.make_train_step`` gathers the parameters whole and
averages the gradients over the axis (:meth:`MeshAxis.mean`). In serving a
data rank holds its rows of the cache's slots and the whole weights, and
the engine gathers each step's sampled tokens over the axis
(``serve.engine``).

Two collectives carry it, both in rank order so that every rank holds the
same bits whatever the backend's reduction order: ``all_gather`` (blocks
concatenated in rank order) and a sum over the axis, done as an
``all_gather`` followed by a float32 sum in rank order, rounded once to
the operands' dtype. A rank's collectives go through its group's backend:
NCCL when every rank has a card of its own; gloo on the CPU and for ranks
that share one card (NCCL refuses two ranks on one device). Gloo's
``all_gather`` is given host tensors: a CUDA operand is copied into a
pinned host buffer, gathered into pinned buffers and copied back (the
buffers are kept and grown, one set a dtype). ``MeshAxis(size=1)`` runs no
collective at all.

Training on the model axis differentiates through these collectives under
one convention: the gradient of every tensor that is whole on every rank
is complete, and the same bits, on every rank. Three operations carry it,
each an autograd ``Function``: :meth:`MeshAxis.sum` (its adjoint is the
identity: the partial's gradient is the sum's), :meth:`MeshAxis.all_gather`
and :meth:`MeshAxis.whole` (this rank's slice of the upstream gradient
along the gathered dim), and :meth:`MeshAxis.enter`, the identity where a
tensor that is whole on every rank enters this rank's share (a product
with its heads', columns' or experts' block), whose adjoint sums the
ranks' gradients in rank order in float32, rounded once. Every rank makes
the same collectives in the same order, forward and backward; a rank that
does not meets its process group's timeout.

The DFedRW pod mesh's gossip moves each rank's payload to another rank of
its axis (:meth:`MeshAxis.exchange`, a batch of point-to-point sends and
receives).

One class serves every axis (``name`` says which); each axis object keeps
its own :attr:`MeshAxis.stats` (calls, bytes received, and wall seconds,
host-synchronous), so a step reports its data collectives apart from its
model collectives. The layout helpers (``model_dim``, ``cache_dim``,
``span``, ``splits``, ``whole``) read the model axis's specs.
"""
from __future__ import annotations

import time
from functools import lru_cache

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import cache_spec_for_leaf, spec_for_leaf

__all__ = ["MeshAxis"]


@lru_cache(maxsize=None)
def _model_dim(name: str, full_shape: tuple, size: int, cache: bool) -> int | None:
    mesh = {"data": 1, "model": size}
    spec = (cache_spec_for_leaf(name, full_shape, mesh) if cache
            else spec_for_leaf(name, full_shape, mesh))
    return spec.index("model") if "model" in spec else None


class MeshAxis:
    """Rank ``rank`` of the mesh axis ``name`` (``"model"`` or ``"data"``)
    of ``size`` ranks over ``group`` (a ``torch.distributed`` process group
    whose ranks are the axis's, in its order; None with size 1)."""

    def __init__(self, group=None, rank: int = 0, size: int = 1, name: str = "model"):
        if size > 1 and group is None:
            raise ValueError(f"a {name} axis of {size} ranks needs a process group")
        self.group, self.rank, self.size, self.name = group, rank, size, name
        self.backend = dist.get_backend(group) if group is not None else None
        self.stats = {"calls": 0, "bytes": 0, "seconds": 0.0}
        self._pinned: dict = {}

    def __repr__(self) -> str:
        return (f"MeshAxis({self.name!r}, rank={self.rank}, size={self.size}, "
                f"backend={self.backend})")

    # ------------------------------------------------------------ layout
    def model_dim(self, name: str, full_shape) -> int | None:
        """The dim of a parameter leaf (by its name, at its unstacked full
        shape) that the model axis splits, or None."""
        return _model_dim(name, tuple(full_shape), self.size, False)

    def cache_dim(self, name: str, full_shape) -> int | None:
        """The same for a decode-cache leaf (``sharding.cache_specs``)."""
        return _model_dim(name, tuple(full_shape), self.size, True)

    def span(self, n: int) -> tuple[int, int]:
        """This rank's [lo, hi) of ``n`` units split evenly."""
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per

    def splits(self, name: str, full_shape, dim: int, unit: int = 1) -> bool:
        """Whether leaf ``name`` is split on ``dim`` at whole ``unit``s."""
        return (self.size > 1 and self.model_dim(name, full_shape) == dim
                and (full_shape[dim] // unit) % self.size == 0
                and full_shape[dim] % unit == 0)

    # -------------------------------------------------------- collectives
    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order.
        Differentiable: the gradient of ``x`` is this rank's slice of the
        upstream gradient along ``dim``."""
        if self.size == 1:
            return x
        return _AxisGather.apply(x, self, dim)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x``: gathered, added in rank order in
        float32, rounded once to ``x.dtype``; the same bits on every rank.
        Differentiable: the gradient of ``x`` is the upstream gradient."""
        if self.size == 1:
            return x
        return _AxisSum.apply(x, self)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, whole on every rank, as it enters this rank's share of a
        computation: the identity, whose gradient is the sum of every rank's
        upstream gradient, in rank order in float32, rounded once to its
        dtype (each rank's holds only its share's contribution). Where no
        gradient is taken (serving), ``x`` itself."""
        if self.size == 1 or not torch.is_grad_enabled():
            return x
        return _AxisEnter.apply(x, self)

    def _sum_float(self, x: torch.Tensor) -> torch.Tensor:
        parts = self._gather(x)
        out = parts[0].float()
        for part in parts[1:]:
            out = out + part.float()
        return out

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of every rank's ``x`` (the sum of :meth:`sum`, divided
        by the size in float32, rounded once), the same bits on every rank.
        Differentiable: the gradient of a rank's ``x`` is the mean of every
        rank's upstream gradient, so the ranks' gradients, averaged, are
        those of the mean as one device would take it."""
        if self.size == 1:
            return x
        return _AxisMean.apply(x, self)

    def whole(self, leaf: torch.Tensor, name: str, full_shape) -> torch.Tensor:
        """The whole of a parameter leaf that the model axis may split:
        gathered along its split dim (:meth:`all_gather`, differentiable),
        or the leaf itself."""
        dim = self.model_dim(name, full_shape) if self.size > 1 else None
        return leaf if dim is None else self.all_gather(leaf, dim)

    def all_equal(self, values: list[int]) -> bool:
        """Whether every rank passed the same list of int64 values."""
        if self.size == 1:
            return True
        mine = torch.tensor(values, dtype=torch.int64)
        parts = [torch.empty_like(mine) for _ in range(self.size)]
        if self.backend == "nccl":
            dev = torch.device("cuda", torch.cuda.current_device())
            got = [p.to(dev) for p in parts]
            dist.all_gather(got, mine.to(dev), group=self.group)
            parts = [g.cpu() for g in got]
        else:
            dist.all_gather(parts, mine, group=self.group)
        return all(torch.equal(p, parts[0]) for p in parts)

    def exchange(self, tensors, send_to: int, recv_from: int) -> list[torch.Tensor]:
        """Send each tensor to rank ``send_to`` of the axis and receive one of
        the same shape and dtype from rank ``recv_from``, in one batch of
        point-to-point operations; counts the bytes sent. Gloo is given host
        tensors: a CUDA tensor is copied to the host and back."""
        t0 = time.perf_counter()
        tensors = [t.contiguous() for t in tensors]
        staged = self.backend != "nccl" and any(t.is_cuda for t in tensors)
        sends = [t.cpu() for t in tensors] if staged else tensors
        bufs = [torch.empty_like(t) for t in sends]
        ops = ([dist.P2POp(dist.isend, t, self._peer(send_to), self.group) for t in sends]
               + [dist.P2POp(dist.irecv, b, self._peer(recv_from), self.group) for b in bufs])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if staged:
            bufs = [b.to(t.device) for b, t in zip(bufs, tensors)]
        self.stats["calls"] += 1
        self.stats["bytes"] += sum(t.numel() * t.element_size() for t in tensors)
        self.stats["seconds"] += time.perf_counter() - t0
        return bufs

    def _peer(self, rank: int) -> int:
        """The global rank of rank ``rank`` of the axis's group."""
        if self.group is None or self.group is dist.group.WORLD:
            return rank
        return dist.get_global_rank(self.group, rank)

    def _staging(self, n: int, dtype) -> list[torch.Tensor]:
        """size + 1 pinned host buffers of at least ``n`` elements of
        ``dtype`` (this rank's send buffer, then one receive buffer a rank)."""
        bufs = self._pinned.get(dtype)
        if bufs is None or bufs[0].numel() < n:
            bufs = [torch.empty(n, dtype=dtype, pin_memory=True) for _ in range(self.size + 1)]
            self._pinned[dtype] = bufs
        return [b[:n] for b in bufs]

    def _gather(self, x: torch.Tensor) -> list[torch.Tensor]:
        t0 = time.perf_counter()
        x = x.contiguous()
        if x.is_cuda and self.backend != "nccl":
            # gloo between ranks that share a card, through pinned host
            # buffers; the blocking copy in waits for the stream, so the
            # last call's copies out of the receive buffers are done
            send, *recv = self._staging(x.numel(), x.dtype)
            send.copy_(x.view(-1))
            dist.all_gather(recv, send, group=self.group)
            parts = [r.to(x.device, non_blocking=True).view(x.shape) for r in recv]
        else:
            parts = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(parts, x, group=self.group)
        self.stats["calls"] += 1
        self.stats["bytes"] += x.numel() * x.element_size() * self.size
        self.stats["seconds"] += time.perf_counter() - t0
        return parts


class _AxisSum(torch.autograd.Function):
    """:meth:`MeshAxis.sum` with its adjoint, the identity."""

    @staticmethod
    def forward(ctx, x, axis):
        return axis._sum_float(x).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AxisGather(torch.autograd.Function):
    """:meth:`MeshAxis.all_gather` with its adjoint, this rank's slice."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.dim, ctx.lo, ctx.n = dim, axis.rank * x.shape[dim], x.shape[dim]
        return torch.cat(axis._gather(x), dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.lo, ctx.n), None, None


class _AxisEnter(torch.autograd.Function):
    """:meth:`MeshAxis.enter`: the identity, its adjoint the rank-order sum."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis._sum_float(grad).to(grad.dtype), None


class _AxisMean(torch.autograd.Function):
    """:meth:`MeshAxis.mean` with its adjoint: the mean over the axis again."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return (axis._sum_float(x) / axis.size).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        axis = ctx.axis
        return (axis._sum_float(grad) / axis.size).to(grad.dtype), None
