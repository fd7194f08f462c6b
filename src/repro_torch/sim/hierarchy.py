"""Hierarchical (device -> cell -> metro -> backbone) link model.

The uniform all-pairs :class:`repro_torch.sim.links.LinkModel` prices every
cross-device message identically — fine for a lab cluster, wrong for the
paper's fleet setting, where a hand-off to the neighbor one cell over and a
hand-off across the country differ by orders of magnitude. This module
prices a message by the highest network tier it must traverse:

* devices ``src // devices_per_cell == dst // devices_per_cell`` share a
  **cell** (base station / edge PoP): the message pays the asymmetric
  access hop twice — sender uplink (``up_bps``) and receiver downlink
  (``down_bps``), each with ``access_latency_s``;
* cells ``cell // cells_per_metro`` sharing a **metro** additionally pay
  two metro-fabric traversals (``metro_latency_s`` + bits/``cell_bps``,
  in and out);
* different metros additionally pay two **backbone** traversals
  (``backbone_latency_s`` + bits/``backbone_bps``).

Self-messages are free, matching the uniform model's self-hop convention.
Contention (``queue=True``) is modeled at the *device uplink* tier — the
bottleneck in fleet uplinks — through the same
:class:`repro_torch.sim.events.UplinkQueue` FIFO the uniform model uses, with the
full path price as service time; the shared cell/metro/backbone fabrics are
treated as statistically multiplexed (no queueing), but every message's
per-tier occupancy is still accounted in ``tier_stats`` (an
:class:`repro_torch.sim.events.UplinkStats` per tier, ``queued_s`` always 0) so
scenarios can report per-tier load alongside per-device contention.

The device -> cell -> metro map is positional (``id // devices_per_cell``),
deliberately aligned with ``core/graph.py``'s generative ``"metro"``
topology so that graph locality and link locality coincide — random-walk
chains mostly pay cell prices, aggregation fan-ins pay metro/backbone
prices.

The model is jitter-free by design (no ``jitter_sigma``): the fleet engine
prices whole windows at a time, and per-message jitter draws would couple
the RNG stream to event processing order.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.sim.events import UplinkQueue, UplinkStats

__all__ = ["HierLinkConfig", "HierarchicalLinkModel"]

_TIERS = ("access", "metro", "backbone")


@dataclasses.dataclass(frozen=True)
class HierLinkConfig:
    """Tiered fleet network knobs (defaults: LTE-ish access, metro fiber,
    fat backbone).

    >>> cfg = HierLinkConfig(devices_per_cell=4, cells_per_metro=2)
    >>> HierarchicalLinkModel(cfg).transfer_time(0, 0, 1e9)   # self-hop free
    0.0
    """

    devices_per_cell: int = 100
    cells_per_metro: int = 32
    up_bps: float = 10e6             # device uplink (sender side)
    down_bps: float = 50e6           # device downlink (receiver side)
    cell_bps: float = 1e9            # metro fabric, per traversal
    backbone_bps: float = 10e9       # backbone, per traversal
    access_latency_s: float = 0.005  # per access hop
    metro_latency_s: float = 0.010   # per metro traversal
    backbone_latency_s: float = 0.030
    queue: bool = False              # device-uplink FIFO contention
    seed: int = 0

    def __post_init__(self):
        if self.devices_per_cell < 1 or self.cells_per_metro < 1:
            raise ValueError("devices_per_cell and cells_per_metro must be >= 1")


class HierarchicalLinkModel:
    """Tiered link model; interface-compatible with
    :class:`repro_torch.sim.links.LinkModel` (``transfer_time`` /
    ``transfer_time_batch`` / ``min_transfer_time`` / ``send`` /
    ``uplink_stats`` / ``.uplinks`` / ``.cfg``).

    >>> cfg = HierLinkConfig(devices_per_cell=2, cells_per_metro=2,
    ...                      up_bps=100.0, down_bps=200.0, cell_bps=400.0,
    ...                      backbone_bps=800.0, access_latency_s=0.5,
    ...                      metro_latency_s=1.0, backbone_latency_s=2.0)
    >>> lm = HierarchicalLinkModel(cfg)
    >>> lm.transfer_time(0, 1, 100.0)        # same cell: 2x access
    2.5
    >>> lm.transfer_time(0, 2, 100.0)        # same metro: + 2x metro fabric
    5.0
    >>> lm.transfer_time(0, 4, 100.0)        # cross metro: + 2x backbone
    9.25
    """

    def __init__(self, cfg: HierLinkConfig):
        self.cfg = cfg
        self.uplinks: UplinkQueue | None = UplinkQueue() if cfg.queue else None
        self.tier_stats: dict[str, UplinkStats] = {
            t: UplinkStats() for t in _TIERS}

    # ------------------------------------------------------------- pricing
    def cell_of(self, device: np.ndarray | int) -> np.ndarray | int:
        return device // self.cfg.devices_per_cell

    def metro_of(self, device: np.ndarray | int) -> np.ndarray | int:
        return self.cell_of(device) // self.cfg.cells_per_metro

    def _tier_prices(self, bits: float) -> tuple[float, float, float]:
        """(access, metro, backbone) price components of one message that
        traverses the tier — each already counting both directions."""
        cfg = self.cfg
        access = (2.0 * cfg.access_latency_s
                  + bits / cfg.up_bps + bits / cfg.down_bps)
        metro = 2.0 * (cfg.metro_latency_s + bits / cfg.cell_bps)
        backbone = 2.0 * (cfg.backbone_latency_s + bits / cfg.backbone_bps)
        return access, metro, backbone

    def transfer_time_batch(self, src: np.ndarray, dst: np.ndarray,
                            payload_bits: float) -> np.ndarray:
        """Vectorized tiered price over parallel (src, dst) vectors."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        access, metro, backbone = self._tier_prices(payload_bits)
        cross = src != dst
        cross_cell = self.cell_of(src) != self.cell_of(dst)
        cross_metro = self.metro_of(src) != self.metro_of(dst)
        t = np.where(cross, access, 0.0)
        t = t + np.where(cross_cell, metro, 0.0)
        t = t + np.where(cross_metro, backbone, 0.0)
        return t

    def transfer_time(self, src: int, dst: int, payload_bits: float) -> float:
        """Scalar price, delegating to the batch path (bit-identical — the
        heap and fleet engines must agree on every message price)."""
        return float(self.transfer_time_batch(
            np.array([src]), np.array([dst]), payload_bits)[0])

    def min_transfer_time(self, payload_bits: float) -> float:
        """Cheapest cross-device price (a same-cell message)."""
        return self._tier_prices(payload_bits)[0]

    # ------------------------------------------------------------- sending
    def _account_tiers(self, src: int, dst: int, bits: float,
                       t_start: float) -> None:
        access, metro, backbone = self._tier_prices(bits)
        spans = [("access", access)]
        if self.cell_of(src) != self.cell_of(dst):
            spans.append(("metro", metro))
        if self.metro_of(src) != self.metro_of(dst):
            spans.append(("backbone", backbone))
        for tier, svc in spans:
            st = self.tier_stats[tier]
            st.sent += 1
            st.busy_s += svc
            st.t_first_start = min(st.t_first_start, t_start)
            st.t_last_done = max(st.t_last_done, t_start + svc)

    def record_batch(self, src: np.ndarray, dst: np.ndarray, bits: float,
                     t_start: np.ndarray) -> None:
        """Batched tier accounting for the fleet engine (which prices whole
        windows without going through ``send``). Counts and spans match the
        per-message path; ``busy_s`` accumulates as one product per tier
        rather than message-sequential adds, so it can differ from the heap
        engine's by float-association dust."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        t_start = np.asarray(t_start, dtype=np.float64)
        access, metro, backbone = self._tier_prices(bits)
        cross = src != dst
        masks = [("access", access, cross),
                 ("metro", metro, cross & (self.cell_of(src) != self.cell_of(dst))),
                 ("backbone", backbone,
                  cross & (self.metro_of(src) != self.metro_of(dst)))]
        for tier, svc, mask in masks:
            cnt = int(mask.sum())
            if cnt == 0:
                continue
            st = self.tier_stats[tier]
            st.sent += cnt
            st.busy_s += cnt * svc
            st.t_first_start = min(st.t_first_start, float(t_start[mask].min()))
            st.t_last_done = max(st.t_last_done,
                                 float(t_start[mask].max()) + svc)

    def send(self, src: int, dst: int, payload_bits: float,
             t_ready: float) -> float:
        """Arrival instant; FIFO-serialized on ``src``'s device uplink when
        ``cfg.queue``, else ``t_ready + transfer_time``."""
        return self.send_ex(src, dst, payload_bits, t_ready)[1]

    def send_ex(self, src: int, dst: int, payload_bits: float,
                t_ready: float) -> tuple[float, float]:
        """``(transmit_start, arrival)``; see ``LinkModel.send_ex``. Tier
        accounting is unchanged (priced at the transmit start)."""
        if src == dst:
            return t_ready, t_ready
        service = self.transfer_time(src, dst, payload_bits)
        if self.uplinks is None:
            self._account_tiers(src, dst, payload_bits, t_ready)
            return t_ready, t_ready + service
        t_start, t_done = self.uplinks.enqueue(src, t_ready, service)
        self._account_tiers(src, dst, payload_bits, t_start)
        return t_start, t_done

    def uplink_stats(self, device: int) -> UplinkStats | None:
        """Per-device contention accounting (None when queue=False or the
        device never sent)."""
        if self.uplinks is None:
            return None
        return self.uplinks.stats.get(device)
