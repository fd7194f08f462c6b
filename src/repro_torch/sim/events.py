"""Heap-based discrete-event core of the virtual-time DFedRW simulator.

One :class:`EventQueue` instance is the whole engine: events are
``(time, seq)``-ordered records popped in nondecreasing virtual time, with
the monotone sequence number making ties FIFO-stable (two events scheduled
for the same instant resolve in scheduling order, so the simulation is
deterministic given its seeds). ``drain`` is the event loop: it dispatches
every event up to a horizon — the aggregation deadline — to a handler and
leaves later events untouched, which is exactly how a wall-clock deadline
truncates in-flight walks. Under the fully-asynchronous ``overlap`` policy
the queue persists across windows: the events left beyond one horizon are
the next window's in-flight chains.

:class:`UplinkQueue` is the shared-uplink contention model: each device owns
one FIFO transmit queue, so concurrent messages from the same sender — walk
hand-offs and aggregation broadcasts alike — serialize instead of sharing
the link for free. ``repro_torch.sim.links.LinkModel`` consults it when
``LinkModelConfig(queue=True)``; with ``queue=False`` transfers overlap
freely and pricing is bit-identical to the uncontended model.

The queue carries no protocol knowledge; kinds are plain strings owned by
the runner (repro_torch.sim.runner uses ``"hop"`` for a model arriving at a
device and ``"sgd"`` for a local step completing).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Any, Callable

__all__ = ["Event", "EventQueue", "UplinkQueue", "UplinkStats"]


@dataclasses.dataclass(frozen=True, order=True)
class Event:
    """One scheduled occurrence at a virtual-time instant.

    Ordering is by (time, seq) only; payload fields never participate in
    heap comparisons.
    """

    time: float
    seq: int
    kind: str = dataclasses.field(compare=False)
    chain: int = dataclasses.field(default=-1, compare=False)
    step: int = dataclasses.field(default=-1, compare=False)
    data: Any = dataclasses.field(default=None, compare=False)


class EventQueue:
    """Min-heap of :class:`Event` with a virtual clock.

    ``now`` is the time of the last popped event (virtual time never runs
    backwards: pushing into the past raises). Counters track total pushes
    and pops for the events/sec accounting of the benchmark lane.

    Same-instant events dispatch in scheduling order, and the horizon is
    inclusive — an event at exactly the deadline still lands inside the
    window:

    >>> q = EventQueue()
    >>> _ = q.push(2.0, "b"); _ = q.push(1.0, "a"); _ = q.push(2.0, "c")
    >>> seen = []
    >>> q.drain(lambda ev: seen.append(ev.kind), until=2.0)
    3
    >>> seen
    ['a', 'b', 'c']
    >>> _ = q.push(5.0, "later")
    >>> q.drain(lambda ev: None, until=4.0), len(q)   # beyond horizon: stays
    (0, 1)
    """

    def __init__(self) -> None:
        self._heap: list[Event] = []
        self._seq = 0
        self.now = 0.0
        self.pushed = 0
        self.popped = 0

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, time: float, kind: str, chain: int = -1, step: int = -1,
             data: Any = None) -> Event:
        if time < self.now:
            raise ValueError(f"event at t={time} is before now={self.now}")
        ev = Event(time=float(time), seq=self._seq, kind=kind, chain=chain,
                   step=step, data=data)
        self._seq += 1
        self.pushed += 1
        heapq.heappush(self._heap, ev)
        return ev

    def peek(self) -> Event | None:
        return self._heap[0] if self._heap else None

    def pop(self) -> Event:
        ev = heapq.heappop(self._heap)
        self.now = ev.time
        self.popped += 1
        return ev

    def clear(self, now: float = 0.0) -> None:
        """Reset for a new round: drop pending events, rewind the clock.
        (The overlap policy never calls this mid-run — pending events ARE
        the resumed chains.)"""
        self._heap.clear()
        self.now = now

    def drain(self, handler: Callable[[Event], None],
              until: float = math.inf) -> int:
        """The event loop: dispatch every event with ``time <= until`` in
        (time, seq) order. Handlers may push further events (also honored
        while they land inside the horizon). Returns the number of events
        processed; events beyond the horizon stay queued."""
        n = 0
        while self._heap and self._heap[0].time <= until:
            handler(self.pop())
            n += 1
        return n


@dataclasses.dataclass
class UplinkStats:
    """Per-uplink contention accounting.

    ``busy_s`` sums the pure service (transfer) times; the occupied span
    ``t_last_done - t_first_start`` additionally contains idle gaps, so for
    every uplink ``span >= busy_s`` — serialization can only slow a sender
    down, never speed it up (the contention property test,
    tests/test_sim_async.py). ``queued_s`` sums the time messages waited
    behind earlier traffic (0 everywhere = no contention happened).
    """

    sent: int = 0
    busy_s: float = 0.0
    queued_s: float = 0.0
    t_first_start: float = math.inf
    t_last_done: float = -math.inf

    @property
    def span_s(self) -> float:
        """Occupied span of this uplink (0.0 before any send)."""
        if self.sent == 0:
            return 0.0
        return self.t_last_done - self.t_first_start


class UplinkQueue:
    """Per-device FIFO transmit queues serializing concurrent sends.

    A message from device ``d`` ready at ``t_ready`` with service time
    ``service_s`` starts at ``max(t_ready, busy_until[d])`` and occupies the
    uplink until it completes; later messages from the same sender queue
    behind it in enqueue order (= event-processing order, so deterministic).

    >>> u = UplinkQueue()
    >>> u.enqueue(0, t_ready=0.0, service_s=2.0)   # uplink idle: starts now
    (0.0, 2.0)
    >>> u.enqueue(0, t_ready=1.0, service_s=2.0)   # queues behind the first
    (2.0, 4.0)
    >>> u.enqueue(1, t_ready=1.0, service_s=2.0)   # other sender: no wait
    (1.0, 3.0)
    >>> u.stats[0].busy_s, u.stats[0].queued_s, u.stats[0].span_s
    (4.0, 1.0, 4.0)
    """

    def __init__(self) -> None:
        self._busy_until: dict[int, float] = {}
        self.stats: dict[int, UplinkStats] = {}

    def busy_until(self, device: int) -> float:
        """Instant device ``device``'s uplink frees up (0.0 if never used)."""
        return self._busy_until.get(device, 0.0)

    def enqueue(self, device: int, t_ready: float,
                service_s: float) -> tuple[float, float]:
        """FIFO-admit one message; returns ``(t_start, t_done)``."""
        if service_s < 0.0:
            raise ValueError(f"negative service time {service_s}")
        t_start = max(t_ready, self._busy_until.get(device, 0.0))
        t_done = t_start + service_s
        self._busy_until[device] = t_done
        st = self.stats.setdefault(device, UplinkStats())
        st.sent += 1
        st.busy_s += service_s
        st.queued_s += t_start - t_ready
        st.t_first_start = min(st.t_first_start, t_start)
        st.t_last_done = max(st.t_last_done, t_done)
        return t_start, t_done

    def clear(self) -> None:
        """Forget all queue state (a fresh run on the same LinkModel)."""
        self._busy_until.clear()
        self.stats.clear()
