"""The pod mesh of the DFedRW pod deployment: the port of
``repro.launch.mesh.make_pod_mesh``.

The reference lays its devices out as a ``(pod, data, model)`` mesh with one
model replica a pod. The port places pods in one of two ways:

- stacked: every pod on one device, each leaf of the fed tree with a
  leading pod dimension (``group=None``); a card holds G pods this way;
- one pod a rank of a ``torch.distributed`` process group (``torchrun``),
  each rank holding its own pod on its own device.

A pod spans one device: a pod with a data or model axis (``pods`` smaller
than the group's world size) is ROADMAP.md A11b, as are the reference's
production, host and metal meshes (``HW``, ``make_production_mesh``,
``make_host_mesh``, ``make_metal_mesh``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

__all__ = ["PodMesh", "make_pod_mesh"]


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
