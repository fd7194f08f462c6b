"""The model axis of a tensor-parallel model: the work the reference leaves
to XLA's partitioner, written out over a ``torch.distributed`` group.

The reference places its parameters and cache by ``dist.sharding``'s specs
on a ``("data", "model")`` mesh and lets the partitioner insert the
collectives. Here every rank of the model axis holds its block of each leaf
(``sharding.shard_tree``) and the layer functions of ``models.layers``
compute on it, Megatron-style, where a spec's split falls on a unit
boundary (a head, an FFN column, an expert, a vocab row): column-parallel
products give each rank its own heads or columns, and row-parallel products
a partial sum that :meth:`ModelAxis.sum` adds up. Where a spec cuts inside
a unit (MQA's single K/V head, an odd vocab falling to d), the leaf is
gathered whole before use (:meth:`ModelAxis.whole`): the sharded model
computes the unsharded function either way.

Two collectives carry it, both in rank order so that every rank holds the
same bits whatever the backend's reduction order: ``all_gather`` (blocks
concatenated in rank order) and a sum over the axis, done as an
``all_gather`` followed by a float32 sum in rank order, rounded once to
the operands' dtype. A rank's collectives go through its group's backend:
NCCL when every rank has a card of its own; gloo on the CPU and for ranks
that share one card (NCCL refuses two ranks on one device). Gloo's
``all_gather`` is given host tensors: a CUDA operand is copied into a
pinned host buffer, gathered into pinned buffers and copied back (the
buffers are kept and grown, one set a dtype). ``ModelAxis(size=1)`` runs no
collective at all.

Each collective adds to :attr:`ModelAxis.stats` (calls, bytes received, and
wall seconds, host-synchronous).
"""
from __future__ import annotations

import time
from functools import lru_cache

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import cache_spec_for_leaf, spec_for_leaf

__all__ = ["ModelAxis"]


@lru_cache(maxsize=None)
def _model_dim(name: str, full_shape: tuple, size: int, cache: bool) -> int | None:
    mesh = {"data": 1, "model": size}
    spec = (cache_spec_for_leaf(name, full_shape, mesh) if cache
            else spec_for_leaf(name, full_shape, mesh))
    return spec.index("model") if "model" in spec else None


class ModelAxis:
    """Rank ``rank`` of a model axis of ``size`` ranks over ``group`` (a
    ``torch.distributed`` process group; None with size 1)."""

    def __init__(self, group=None, rank: int = 0, size: int = 1):
        if size > 1 and group is None:
            raise ValueError(f"a model axis of {size} ranks needs a process group")
        self.group, self.rank, self.size = group, rank, size
        self.backend = dist.get_backend(group) if group is not None else None
        self.stats = {"calls": 0, "bytes": 0, "seconds": 0.0}
        self._pinned: dict = {}

    def __repr__(self) -> str:
        return f"ModelAxis(rank={self.rank}, size={self.size}, backend={self.backend})"

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
        """Every rank's ``x`` concatenated along ``dim`` in rank order."""
        if self.size == 1:
            return x
        return torch.cat(self._gather(x), dim)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x``: gathered, added in rank order in
        float32, rounded once to ``x.dtype``; the same bits on every rank."""
        if self.size == 1:
            return x
        parts = self._gather(x)
        out = parts[0].float()
        for part in parts[1:]:
            out = out + part.float()
        return out.to(x.dtype)

    def whole(self, leaf: torch.Tensor, name: str, full_shape) -> torch.Tensor:
        """The whole of a parameter leaf that the model axis may split:
        gathered along its split dim, or the leaf itself."""
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
