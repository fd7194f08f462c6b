"""The meshes of the port's deployments: the ports of
``repro.launch.mesh``'s ``HW``, ``make_production_mesh``,
``make_host_mesh``, ``make_pod_mesh`` and ``make_metal_mesh``; and how a
launcher's ranks join their process group under ``torchrun``
(:func:`join_torchrun`, :func:`group_backend`).

The reference lays its devices out as a ``(data, model)`` mesh, with a
leading ``pod`` axis for the DFedRW deployment. The port's meshes:

- ``make_production_mesh``: the reference's production shapes as a
  :class:`~repro_torch.dist.sharding.MeshShape` with no devices, for the
  sharding rules;
- ``make_host_mesh``: the ranks of a ``torch.distributed`` group as a
  ``(data, model)`` mesh (:class:`HostMesh`), one rank a device, laid out
  as ``sharding.mesh_coords`` lays them (row-major, model fastest); the
  model axis carries tensor-parallel serving (``launch.serve
  --mesh-model``), the data axis data-parallel training (``launch.train
  pod`` under ``torchrun``, ``dist.steps.make_train_step(cfg, mesh)``) and
  data-parallel serving slots (``launch.serve`` under ``torchrun``, a
  ``(world / N, N)`` mesh for ``--mesh-model N``);
- ``make_pod_mesh``: pods stacked on one device (every leaf of the fed tree
  with a leading pod dimension, ``group=None``; a card holds G pods this
  way), or the ranks of a group as the reference's ``(pod, data, model)``
  mesh: ``pods`` pods of ``world // pods`` data ranks each (:class:`PodMesh`:
  one pod a rank when ``pods`` is the world size);
- ``make_metal_mesh``: the metal deployment (``launch/replay.py``) walks a
  process's chain slice on its local *positions*, a list of devices in
  which one device may appear more than once; with several processes it
  takes the deployment's census over a gloo process group.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.dist.parallel import MeshAxis
from repro_torch.dist.sharding import MeshShape

__all__ = ["HW", "HostMesh", "PodMesh", "group_backend", "join_torchrun", "make_host_mesh",
           "make_metal_mesh", "make_pod_mesh", "make_production_mesh"]


class HW:
    """The NVIDIA H100 SXM5 80GB's published constants, for rooflines."""

    PEAK_FLOPS_BF16 = 989e12       # dense bf16 on the tensor cores, per card
    PEAK_FLOPS_TF32 = 494.7e12     # dense TF32 on the tensor cores, per card
    HBM_BW = 3.35e12               # HBM3 bytes/s per card
    HBM_BYTES = 80e9               # HBM3 capacity
    NVLINK_BW = 900e9              # NVLink bytes/s per card (all links, both directions)
    NVLINK_SEND_BW = 450e9         # NVLink bytes/s a card sends (half of NVLINK_BW)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production mesh shapes, ``(data=16, model=16)`` or
    ``(pod=2, data=16, model=16)``, with no devices: what the sharding rules
    need. On H100s a model axis of 16 spans two 8-card nodes, so its
    collectives leave NVLink for the network between the nodes."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


@dataclasses.dataclass
class HostMesh:
    """A ``(data, model)`` mesh over the ranks of ``group`` (None: this
    process alone), with this rank's ``device``. ``shape`` is the ``{axis:
    size}`` dict the sharding rules read; ``axis`` is this rank's model
    axis and ``data_axis`` its data axis (:class:`MeshAxis`, each with its
    collectives and their counters) over ``model_group`` and
    ``data_group``, the ranks that share this rank's data or model index."""

    data: int
    model: int
    device: torch.device
    group: Any = None
    rank: int = 0
    model_group: Any = None
    data_group: Any = None

    def __post_init__(self):
        self.axis = MeshAxis(self.model_group, self.rank % self.model, self.model, "model")
        self.data_axis = MeshAxis(self.data_group, self.rank // self.model, self.data, "data")

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    def all_equal(self, values: list[int]) -> bool:
        """Whether every rank of the mesh, on both axes, passed the same
        list of int64 values (one all-gather over ``group``)."""
        if self.size == 1:
            return True
        return MeshAxis(self.group, self.rank, self.size, "mesh").all_equal(values)


def make_host_mesh(data: int = 1, model: int = 1, *, device, group=None) -> HostMesh:
    """A mesh over the group's ranks (one rank a device; no group: this
    process alone), clamped as the reference clamps its host mesh: the
    model axis to [1, ranks], the data axis to [1, ranks // model]. The
    mesh must take every rank (ValueError otherwise). Rank r sits at data
    index r // model and model index r % model. Where both axes have more
    than one rank, each axis's subgroups are made with ``dist.new_group``
    (every rank makes every call, in the same order)."""
    n = dist.get_world_size(group) if group is not None else 1
    model = max(1, min(model, n))
    data = max(1, min(data, n // model))
    if data * model != n:
        raise ValueError(f"a ({data}, {model}) mesh over {n} ranks: the mesh must take them all")
    rank = dist.get_rank(group) if group is not None else 0
    if n == 1:
        return HostMesh(data, model, torch.device(device))
    if data == 1 or model == 1:
        return HostMesh(data, model, torch.device(device), group, rank,
                        model_group=group if model > 1 else None,
                        data_group=group if data > 1 else None)
    ranks = dist.get_process_group_ranks(group)
    rows = [dist.new_group([ranks[d * model + m] for m in range(model)])
            for d in range(data)]
    cols = [dist.new_group([ranks[d * model + m] for d in range(data)])
            for m in range(model)]
    return HostMesh(data, model, torch.device(device), group, rank,
                    model_group=rows[rank // model], data_group=cols[rank % model])


def group_backend(local_world: int, cards: int, device_type: str) -> str:
    """The process group's backend: NCCL when the ranks run on cards and
    every local rank has a card of its own; gloo when ranks share cards
    (NCCL refuses two ranks on one device) and on the CPU."""
    return "nccl" if device_type == "cuda" and cards >= local_world else "gloo"


def join_torchrun(device: torch.device) -> tuple[torch.device, str]:
    """Join the default process group of the ranks ``torchrun`` started
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, the
    rendezvous in ``MASTER_ADDR``/``MASTER_PORT``) over
    :func:`group_backend`'s backend. On the card a rank takes card
    ``LOCAL_RANK`` modulo the cards. The ranks share one stdout, so each
    line a rank prints leaves it in one write, also under ``python -u``
    (which would write ``print``'s text and its newline apart, and another
    rank's line could fall between them). Returns (this rank's device, the
    backend)."""
    import datetime
    import os
    import sys

    if hasattr(sys.stdout, "reconfigure"):
        sys.stdout.reconfigure(line_buffering=True, write_through=False)
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    cards = 0
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
    backend = group_backend(local_world, cards, device.type)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                timeout=datetime.timedelta(seconds=600))
    return device, dist.get_backend()


@dataclasses.dataclass
class PodMesh:
    """G pods on ``device``: stacked (``group`` None), or the ranks of
    ``group`` laid out as the reference's ``(pods, data, 1)`` mesh, rank r
    at pod ``r // data`` and data index ``r % data`` (``rank`` is r).

    ``host`` is the pod's own ``(data, 1)`` :class:`HostMesh` over its data
    ranks (its ``data_axis`` carries the pod's data-parallel step; one rank
    alone at data = 1). ``gossip_group`` holds the ranks with this rank's
    data index, ordered by pod, so that a rank's number in it is its pod:
    ``pod_axis`` gathers over it (the step's loss) and ``gossip_axis`` makes
    the gossip's exchanges over it, each :class:`MeshAxis` with its own
    counters. ``shape`` is the ``{"pod", "data", "model"}`` dict the sharding
    rules read (``param_specs(..., fed_axis="pod")``)."""

    pods: int
    device: torch.device
    group: Any = None
    data: int = 1
    rank: int = 0
    gossip_group: Any = None
    host: HostMesh | None = None

    def __post_init__(self):
        if self.host is None:
            self.host = HostMesh(1, 1, self.device)
        stacked = self.group is None
        self.pod_axis = MeshAxis(None if stacked else self.gossip_group,
                                 0 if stacked else self.pod, 1 if stacked else self.pods, "pod")
        self.gossip_axis = MeshAxis(None if stacked else self.gossip_group,
                                    0 if stacked else self.pod, 1 if stacked else self.pods,
                                    "gossip")

    @property
    def pod(self) -> int:
        return self.rank // self.data

    @property
    def shape(self) -> dict:
        return {"pod": self.pods, "data": self.data, "model": 1}


def make_pod_mesh(pods: int = 0, *, device: torch.device, group=None) -> PodMesh:
    """The pod mesh: ``pods=0`` puts one pod on each rank of ``group``, or
    one pod on ``device`` without a group (the reference on one device).
    Without a group ``pods`` pods stack on ``device``. With one of W ranks,
    ``pods`` must divide W (ValueError otherwise, as the reference's assert
    refuses it) and the W // pods ranks a pod leaves over fold into its
    data axis, the reference's ``(pods, W // pods, 1)`` mesh. Each pod's
    data group and each data index's gossip group are made with
    ``dist.new_group`` (every rank makes every call, in the same order); a
    group that takes every rank is ``group`` itself."""
    if pods < 0:
        raise ValueError(f"pods must be >= 0, got {pods}")
    if group is None:
        return PodMesh(pods or 1, device)
    world = dist.get_world_size(group)
    pods = pods or world
    if pods > world or world % pods:
        raise ValueError(f"{pods} pods over {world} ranks: the pods must divide the ranks")
    data, rank = world // pods, dist.get_rank(group)
    if data == 1:
        return PodMesh(pods, device, group, 1, rank, group)
    ranks = dist.get_process_group_ranks(group)
    rows = [dist.new_group([ranks[p * data + d] for d in range(data)]) if pods > 1 else group
            for p in range(pods)]
    cols = [dist.new_group([ranks[p * data + d] for p in range(pods)]) for d in range(data)]
    pod = rank // data
    host = HostMesh(data, 1, device, rows[pod], rank % data, data_group=rows[pod])
    return PodMesh(pods, device, group, data, rank, cols[rank % data], host)


def make_metal_mesh(chains: int = 0, *, device, coordinator: str | None = None,
                    num_processes: int = 1, process_id: int = 0):
    """Bring-up for the trace-driven metal deployment (launch/replay.py).

    ``device`` is the process's device, or a list of its local positions
    (one device may be listed more than once). Multi-process
    (``num_processes`` > 1): joins a gloo process group at ``coordinator``
    (``host:port``) to take the deployment's census, where the reference
    joins ``jax.distributed``. The trajectories do not cross that group:
    they travel through the launcher's exchange, as a DFedRW fleet
    exchanges *messages* (see ``repro_torch.sim.metal``). The group stays
    up; the caller destroys it (``torch.distributed.destroy_process_group``).

    Returns ``(devices, info)``: the largest divisor-of-``chains`` prefix of
    the positions (``chains=0`` = all of them, so no padding is ever
    needed), and the process/device census the launcher logs, with the
    reference's keys."""
    import datetime

    from repro_torch.sim.metal import positions_for

    devs = list(device) if isinstance(device, (list, tuple)) else [device]
    devs = [torch.device(d) for d in devs]
    if num_processes > 1:
        if coordinator is None:
            raise ValueError("multi-process bring-up needs a coordinator "
                             "address (host:port)")
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                timeout=datetime.timedelta(seconds=300))
        counts = [None] * num_processes
        dist.all_gather_object(counts, len(devs))
        process_id, process_count, global_devices = (
            dist.get_rank(), dist.get_world_size(), sum(counts))
    else:
        process_id, process_count, global_devices = 0, 1, len(devs)
    axis = positions_for(chains, len(devs)) if chains else len(devs)
    info = {
        "process_id": process_id,
        "process_count": process_count,
        "local_devices": len(devs),
        "global_devices": global_devices,
        "mesh_axis": axis,
    }
    return devs[:axis], info
