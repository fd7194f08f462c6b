"""The meshes of the port's deployments: the ports of
``repro.launch.mesh.make_pod_mesh`` and ``make_metal_mesh``.

The reference lays its devices out as a ``(pod, data, model)`` mesh with one
model replica a pod. The port places pods in one of two ways:

- stacked: every pod on one device, each leaf of the fed tree with a
  leading pod dimension (``group=None``); a card holds G pods this way;
- one pod a rank of a ``torch.distributed`` process group (``torchrun``),
  each rank holding its own pod on its own device.

A pod spans one device: a pod with a data or model axis (``pods`` smaller
than the group's world size) is ROADMAP.md A11b, as are the reference's
production and host meshes (``HW``, ``make_production_mesh``,
``make_host_mesh``).

The metal deployment (``launch/replay.py``) walks a process's chain slice on
its local *positions*, a list of devices in which one device may appear
more than once; ``make_metal_mesh`` picks them and, with several
processes, takes the deployment's census over a gloo process group.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

__all__ = ["PodMesh", "make_metal_mesh", "make_pod_mesh"]


class PodMesh(NamedTuple):
    """G pods on ``device``: stacked (``group`` None) or one a rank of
    ``group``."""

    pods: int
    device: torch.device
    group: Any = None


def make_pod_mesh(pods: int = 0, *, device: torch.device, group=None) -> PodMesh:
    """The pod mesh: ``pods=0`` puts one pod on each rank of ``group``, or
    one pod on ``device`` without a group (the reference on one device).
    Without a group ``pods`` pods stack on ``device``; with one, ``pods``
    must be 0 or the group's size."""
    if pods < 0:
        raise ValueError(f"pods must be >= 0, got {pods}")
    if group is None:
        return PodMesh(pods or 1, device, None)
    world = dist.get_world_size(group)
    if pods and pods < world:
        raise NotImplementedError(
            f"{pods} pods over {world} ranks: pods with a data axis are ROADMAP.md A11b")
    if pods > world:
        raise ValueError(f"{pods} pods over {world} ranks: one pod a rank, so pods must be "
                         f"0 or {world}")
    return PodMesh(world, device, group)


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
