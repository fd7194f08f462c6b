"""Link latency/bandwidth models pricing DFedRW payloads in virtual time.

A walk hand-off (Eq. 13) or an aggregation message (Eq. 14) costs

    latency_s + payload_bits / bandwidth_bps        (0 for a self-hop)

seconds of virtual time, optionally scaled by a mean-one lognormal jitter.
Payload bits come from the *segment wire format* of ``core/quantization``:
the flat engine ships one Eq. 12 tensor per model-pytree leaf, so a b-bit
payload costs ``sum_l (64 + b * d_l)`` bits and an fp32 one ``32 * d`` —
quantization therefore shortens transfers by the same factor it saves in
the Eq. 18 accounting, which is what makes QDFedRW *faster*, not just
cheaper, under a wall-clock deadline.

Shared-uplink contention (``LinkModelConfig(queue=True)``) routes every
cross-device message through the sender's FIFO transmit queue
(:class:`repro_torch.sim.events.UplinkQueue`): concurrent hop hand-offs and
aggregation broadcasts from one device serialize, and ``send`` returns the
queue-aware arrival instant instead of ``t_ready + transfer_time``. With
``queue=False`` (the default) ``send`` degenerates to exactly the
uncontended pricing — bit-identical draws and arithmetic — so contention is
a strict opt-in refinement of the Eq. 18 communication accounting.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.flatten import FlatSpec
from repro_torch.core.quantization import wire_bits
from repro_torch.sim.events import UplinkQueue, UplinkStats

__all__ = ["LinkModelConfig", "LinkModel", "segment_wire_bits",
           "segment_wire_bits_table", "make_link_model"]


def segment_wire_bits(spec: FlatSpec, bits: int) -> int:
    """Bits on the wire for ONE model-sized payload (hop hand-off or one
    aggregation message): a per-leaf sequence of Eq. 12 segments, each with
    its own 64-bit (s, ||w||) header; fp32 degenerates to 32*d."""
    return sum(wire_bits(size, bits) for size in spec.sizes)


def segment_wire_bits_table(spec: FlatSpec, widths) -> dict[int, int]:
    """Per-width payload pricing for an adaptive bits policy's dispatch
    table: ``{bits: segment_wire_bits(spec, bits)}`` — precomputed so a
    per-window width switch is a dict lookup on the hot path."""
    return {int(b): segment_wire_bits(spec, int(b)) for b in widths}


@dataclasses.dataclass(frozen=True)
class LinkModelConfig:
    """Wire model knobs.

    latency_s / bandwidth_bps / jitter_sigma price one message (see module
    docstring); ``queue=True`` adds shared-uplink FIFO contention — the
    per-sender transmit queues live in :class:`repro_torch.sim.events.UplinkQueue`
    and make ``LinkModel.send`` return queue-aware busy-time arrivals.

    >>> LinkModelConfig().queue          # contention is strictly opt-in
    False
    """

    latency_s: float = 0.0           # per-message fixed cost
    bandwidth_bps: float = math.inf  # bits/second
    jitter_sigma: float = 0.0        # lognormal sigma of a mean-one multiplier
    queue: bool = False              # shared-uplink FIFO contention
    seed: int = 0


class LinkModel:
    """Uniform (all-pairs) link model; self-transfers are free.

    ``transfer_time`` is the pure per-message price (latency + bits/bandwidth
    x jitter); ``send`` is what the event loop calls — it adds FIFO queueing
    on the sender's uplink when ``cfg.queue`` and is otherwise the identity
    ``t_ready + transfer_time``:

    >>> lm = LinkModel(LinkModelConfig(latency_s=0.5, bandwidth_bps=100.0))
    >>> lm.transfer_time(0, 1, 200.0)          # 0.5 + 200/100
    2.5
    >>> lm.send(0, 1, 200.0, t_ready=1.0)      # no queue: ready + price
    3.5
    >>> lm.transfer_time(0, 0, 1e9)            # self-hop is free
    0.0

    With contention on, a second concurrent message from the same sender
    waits for the first to clear the uplink:

    >>> q = LinkModel(LinkModelConfig(latency_s=0.5, bandwidth_bps=100.0,
    ...                               queue=True))
    >>> q.send(0, 1, 200.0, t_ready=0.0), q.send(0, 2, 200.0, t_ready=0.0)
    (2.5, 5.0)
    >>> q.uplinks.stats[0].queued_s            # the second waited 2.5s
    2.5
    """

    def __init__(self, cfg: LinkModelConfig):
        self.cfg = cfg
        self._rng = np.random.default_rng([cfg.seed, 2])
        self.uplinks: UplinkQueue | None = UplinkQueue() if cfg.queue else None

    def transfer_time(self, src: int, dst: int, payload_bits: float) -> float:
        if src == dst:
            return 0.0
        cfg = self.cfg
        t = cfg.latency_s
        if math.isfinite(cfg.bandwidth_bps):
            t += payload_bits / cfg.bandwidth_bps
        if cfg.jitter_sigma > 0.0:
            # mean-one multiplier: E[exp(N(-s^2/2, s))] = 1
            t *= math.exp(self._rng.normal(-0.5 * cfg.jitter_sigma**2,
                                           cfg.jitter_sigma))
        return t

    def send(self, src: int, dst: int, payload_bits: float,
             t_ready: float) -> float:
        """Arrival instant of a message ready to leave ``src`` at ``t_ready``.

        Uncontended (``cfg.queue=False``): exactly
        ``t_ready + transfer_time(src, dst, bits)`` — same jitter draw order,
        bit-identical to the queue-free pricing. Contended: the message
        enters ``src``'s FIFO uplink and its transfer_time becomes *service
        time*; arrival is when the uplink finishes serving it."""
        return self.send_ex(src, dst, payload_bits, t_ready)[1]

    def send_ex(self, src: int, dst: int, payload_bits: float,
                t_ready: float) -> tuple[float, float]:
        """``(transmit_start, arrival)`` — ``send``'s pricing with the FIFO
        admission instant exposed, so tracing can split a hand-off into
        ``queue_wait`` (``[t_ready, transmit_start]``) and ``transfer``
        (``[transmit_start, arrival]``) spans. Identical arithmetic and
        jitter-draw order to ``send``."""
        if src == dst:
            return t_ready, t_ready
        service = self.transfer_time(src, dst, payload_bits)
        if self.uplinks is None:
            return t_ready, t_ready + service
        return self.uplinks.enqueue(src, t_ready, service)

    def transfer_time_batch(self, src: np.ndarray, dst: np.ndarray,
                            payload_bits: float) -> np.ndarray:
        """Vectorized jitter-free ``transfer_time`` over parallel (src, dst)
        vectors (float-identical to the scalar path: the price is the same
        two f64 operations per message). Requires ``jitter_sigma == 0`` —
        jitter draws are ordered by event processing, which a batched price
        cannot reproduce."""
        if self.cfg.jitter_sigma > 0.0:
            raise ValueError(
                "transfer_time_batch requires jitter_sigma == 0 (per-message "
                "jitter draw order is event-serial)")
        src = np.asarray(src)
        dst = np.asarray(dst)
        t = self.cfg.latency_s
        if math.isfinite(self.cfg.bandwidth_bps):
            t = t + payload_bits / self.cfg.bandwidth_bps
        return np.where(src == dst, 0.0, t)

    def min_transfer_time(self, payload_bits: float) -> float:
        """Smallest possible cross-device price — the link contribution to
        the fleet engine's bucket width."""
        t = self.cfg.latency_s
        if math.isfinite(self.cfg.bandwidth_bps):
            t += payload_bits / self.cfg.bandwidth_bps
        return t

    def uplink_stats(self, device: int) -> UplinkStats | None:
        """Contention accounting for one sender (None when queue=False or
        the device never sent)."""
        if self.uplinks is None:
            return None
        return self.uplinks.stats.get(device)


def make_link_model(cfg):
    """Dispatch a link config to its model class: plain
    :class:`LinkModelConfig` to the uniform all-pairs :class:`LinkModel`,
    ``repro_torch.sim.hierarchy.HierLinkConfig`` to the tiered
    :class:`repro_torch.sim.hierarchy.HierarchicalLinkModel` (imported lazily to
    keep the module dependency one-way)."""
    if isinstance(cfg, LinkModelConfig):
        return LinkModel(cfg)
    from repro_torch.sim.hierarchy import HierLinkConfig, HierarchicalLinkModel
    if isinstance(cfg, HierLinkConfig):
        return HierarchicalLinkModel(cfg)
    raise TypeError(f"make_link_model: unknown link config {type(cfg)!r}")
