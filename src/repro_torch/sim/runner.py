"""Discrete-event asynchronous DFedRW: virtual wall-clock over the flat engine.

The port of ``repro.sim.runner``: the same event timeline, numpy for numpy
(timestamps, kill decisions, uplink stats and every protocol-rng draw come
out bit-identical to the reference's), over the port's eager flat engine
(``repro_torch.core.dfedrw``). A ``torch.Generator`` takes the place of the
JAX key: it draws the initial weights and then, for each quantized window,
its (K+1, 2) quantizer seed words, as ``core.metrics.train_loop`` does; at
bits < 32 a window is K launches of the hop kernel and one of the
aggregation kernel on the card.

The synchronous engine runs lockstep rounds; here a round is an *event
timeline*. Each chain's walk unrolls as alternating events on the virtual
clock — ``hop`` (the model arrives at a device, possibly waiting out a churn
interval) and ``sgd`` (a local step completes after the device's
rate-dependent step time, then pays the link model for the hand-off to the
next device). The aggregation trigger is a wall-clock deadline, not a round
barrier: when it fires, every chain contributes exactly the prefix of steps
that *completed in virtual time* (Eq. 11/14 partial-update aggregation), and
Eq. 18 comm accounting is charged for the hops that actually happened.

Windowed batching into the flat engine
--------------------------------------
The event loop decides only *which* (chain, step) work items land inside the
round's deadline window and *when*; the arithmetic is replayed through the
synchronous flat engine's round (core.dfedrw ``_round_flat``) in ONE engine
call per window. This is sound because chains are mutually independent
between aggregation triggers — step k of chain m reads nothing but chain m's
own state — so any execution order, in particular the batched step-major
order of the engine, produces bit-identical results to event-order execution.
Simulation therefore adds host-side bookkeeping, not per-event dispatch: the
round is the SAME one the synchronous engine runs, and with uniform rates and
no deadline the simulator reproduces the synchronous trajectory bit-exactly
(tests/test_torch_sim.py).

Straggler policies at the deadline:

* ``"partial"`` — the paper: truncated chains aggregate their completed
  prefix (their position device holds ``w^{t,last}`` of the prefix); the
  rest of the walk is discarded.
* ``"drop"``    — the FedAvg-style baseline the paper criticizes: chains
  that did not finish all K steps are discarded entirely, but their hops
  still pay Eq. 18 comm (the work happened, then got thrown away).
* ``"overlap"`` — fully asynchronous: a chain cut by the trigger still
  contributes its completed prefix (exactly like ``partial``) but is NOT
  discarded — the event queue persists across windows, so its in-flight
  events (a step mid-computation, a hand-off mid-transfer, a wait for a
  churned-out device) carry over, and the next window's planner samples
  fresh walks only into the slots that freed up. See "Overlap windows"
  below.

Overlap windows (``policy="overlap"``)
--------------------------------------
The runner keeps ``cfg.m_chains`` persistent chain *slots*. At each trigger
a slot is freed when its chain finished all K_m steps or was churn-killed;
live slots resume. The next window's flat-engine call still has fixed
(M, K) shapes: a resumed chain's row is its remaining planned trajectory,
prefixed with a masked *anchor column* — the device of its last completed
step, whose row the ``w^{t,last}`` scatter wrote. The masked column updates
nothing and scatters nothing; it exists purely so the start-of-window gather
``device_flat[devices[:, 0]]`` re-reads the chain's model. Two consequences,
both deliberate:

* a trigger *refreshes* in-flight work — if the anchor device aggregated
  (or another chain later overwrote its row), the resumed chain continues
  from that newer model, which is precisely the asynchronous-gossip
  semantics the overlap policy models; the TIMING of the in-flight events
  is meanwhile preserved exactly by the persistent queue;
* the in-flight hand-off is billed on arrival: mask-driven Eq. 18
  accounting charges edge (anchor -> first resumed step) in the window the
  destination step executes.

When no chain spans a window boundary every slot refills at once, the
planner draws are identical to the synchronous engine's, and the whole path
is bit-exact vs both ``partial`` and the synchronous engine — the parity
anchor that keeps every overlap result grounded.

Recorded traces
---------------
``run(record=True)`` captures each window's executed plan, batch indices,
aggregation plan and virtual-time bracket into a versioned JSONL trace
(``repro_torch.sim.trace``, the reference's schema: traces load in either
package); ``replay`` feeds a trace back through the flat engine with no
device/link/churn simulation and reproduces the recorded run bit-exactly.
``launch/sim.py --record/--replay`` is the CLI.
"""
from __future__ import annotations

import dataclasses
import math
import time as _time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.dfedrw import DFedRW, DFedRWConfig, DFedRWState, RoundMetrics
from repro_torch.core.graph import SparseTopology, Topology
from repro_torch.core.metrics import History
from repro_torch.core.walk import ChainResume, WalkPlan
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.models.fnn import SmallModel
from repro_torch.obs import VirtualClock
from repro_torch.sim.adapt import BitsObs
from repro_torch.sim.devices import DeviceFleet, DeviceModelConfig
from repro_torch.sim.events import Event, EventQueue
from repro_torch.sim.hierarchy import HierLinkConfig
from repro_torch.sim.links import (
    LinkModelConfig,
    make_link_model,
    segment_wire_bits,
    segment_wire_bits_table,
)
from repro_torch.sim.trace import SimTrace, WindowTrace, make_header

__all__ = ["SimConfig", "SimRoundRecord", "SimResult", "AsyncDFedRW"]

_POLICIES = ("partial", "drop", "overlap")
_ENGINES = ("heap", "fleet")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Wall-clock model wrapped around a DFedRWConfig.

    ``deadline_s`` is the aggregation-trigger period (None = the synchronous
    barrier: wait for every chain); ``policy`` picks what happens to chains
    the trigger cuts — see the module docstring. ``engine`` selects the
    timeline implementation: ``"heap"`` is this module's per-event reference
    loop, ``"fleet"`` the vectorized window-bucketing backend of
    ``repro_torch.sim.fleet`` (construct a ``FleetDFedRW`` — or let
    ``SimSetup.runner()`` dispatch — to use it). ``links`` accepts either
    the uniform :class:`repro_torch.sim.links.LinkModelConfig` or the tiered
    :class:`repro_torch.sim.hierarchy.HierLinkConfig`.

    ``bits_policy`` installs an adaptive quantization controller
    (``repro_torch.sim.adapt``): a callable invoked once per window with a
    :class:`repro_torch.sim.adapt.BitsObs` and returning the window's wire
    bit-width, drawn from its ``widths`` dispatch table (every width is
    validated at construction). None keeps the static
    ``DFedRWConfig.quant.bits``.

    >>> SimConfig().policy, SimConfig().deadline_s   # barrier + paper policy
    ('partial', None)
    >>> SimConfig(deadline_s=5.0, policy="overlap").policy
    'overlap'
    """

    devices: DeviceModelConfig = dataclasses.field(default_factory=DeviceModelConfig)
    links: LinkModelConfig | HierLinkConfig = dataclasses.field(
        default_factory=LinkModelConfig)
    deadline_s: float | None = None   # aggregation trigger period; None = the
                                      # synchronous barrier (wait for all chains)
    policy: str = "partial"           # "partial" | "drop" | "overlap"
    engine: str = "heap"              # "heap" | "fleet"
    bits_policy: Callable | None = None  # adaptive width controller (None =
                                         # static DFedRWConfig.quant.bits)


@dataclasses.dataclass
class _Slot:
    """One persistent chain slot of the asynchronous runner (host state)."""

    devices: np.ndarray        # (K,) full planned trajectory
    k_m: int                   # realized planned length (straggler model)
    bidx: np.ndarray           # (K, B) per-step batch indices drawn at birth
    ts: np.ndarray             # (K,) absolute completion instants (NaN=never)
    k_done: int = 0            # lifetime completed steps
    win_start: int = 0         # k_done when the current window opened
    killed: bool = False       # device churned out mid-step: chain is dead
    # trace timing (written only when tracing; NaN = never happened):
    t_arr: np.ndarray | None = None    # (K,) model arrived at step k's device
    t_up: np.ndarray | None = None     # (K,) churn wait ended / compute began
    t_send: np.ndarray | None = None   # (K,) uplink transmit start INTO step k


@dataclasses.dataclass
class SimRoundRecord:
    """Host-side timeline bookkeeping of one simulated window.

    Under ``policy="overlap"`` the per-chain columns describe the chain
    occupying each slot at this trigger: ``k_planned``/``k_done`` are
    lifetime totals (a resumed chain keeps accumulating), ``k_exec`` counts
    the steps executed in THIS window, and ``resumed`` marks chains that
    continue past the trigger."""

    round: int
    t_start: float
    t_compute_end: float              # deadline (or barrier) instant
    t_end: float                      # after aggregation messages land
    events: int                       # events dispatched this round
    host_loop_s: float                # wall time spent in the event loop
    k_planned: np.ndarray             # (M,) planned walk lengths
    k_done: np.ndarray                # (M,) lifetime steps completed in virtual time
    k_exec: np.ndarray                # (M,) steps aggregated this window (policy)
    killed: np.ndarray                # (M,) bool: device churned out mid-step
    agg_latency_s: float
    resumed: np.ndarray | None = None # (M,) bool: chain spans past this trigger
    bits: int | None = None           # wire width the window executed at
                                      # (None on pre-adaptive records)

    @property
    def truncated_chains(self) -> int:
        return int((self.k_done < self.k_planned).sum())

    @property
    def resumed_chains(self) -> int:
        return 0 if self.resumed is None else int(self.resumed.sum())

    @property
    def dropped_chains(self) -> int:
        res = (np.zeros_like(self.killed) if self.resumed is None
               else self.resumed)
        return int(((self.k_exec == 0) & (self.k_planned > 0) & ~res).sum())


@dataclasses.dataclass
class SimResult:
    history: History
    records: list
    state: Any
    virtual_time_s: float = 0.0
    events_total: int = 0
    host_loop_s: float = 0.0
    trace: SimTrace | None = None     # run(record=True) / replay provenance

    @property
    def events_per_sec(self) -> float:
        return self.events_total / max(self.host_loop_s, 1e-12)

    def final(self) -> dict:
        out = self.history.final()
        out.update(virtual_time_s=self.virtual_time_s,
                   events_total=self.events_total,
                   events_per_sec=self.events_per_sec)
        return out


class AsyncDFedRW:
    """Virtual-time asynchronous simulator over the flat DFedRW engine.

    ``topology_schedule`` optionally makes the graph time-varying: a sorted
    list of ``(t_from_s, Topology)`` entries; each round runs on the entry
    active at its start instant (partition-then-heal scenarios). All entries
    must keep the device count.

    The engine is the port's ``DFedRW`` on ``device`` (the card unless the
    caller passes ``device="cpu"``).

    A minimal run (uniform rates, free links, synchronous barrier — the
    configuration that reproduces the flat engine bit-exactly):

    >>> import numpy as np, torch
    >>> from repro_torch.core import DFedRWConfig, make_topology
    >>> from repro_torch.core.heterogeneity import partition_similarity
    >>> from repro_torch.data import FederatedDataset, synthetic_image_classification
    >>> from repro_torch.models import make_fnn
    >>> x, y = synthetic_image_classification(n_samples=200, seed=0)
    >>> part = partition_similarity(y, 4, 50, np.random.default_rng(0))
    >>> data = FederatedDataset.from_partition(x, y, part)
    >>> sim = AsyncDFedRW(make_fnn((16,)), data, make_topology("ring", 4),
    ...                   DFedRWConfig(m_chains=2, k_walk=2, batch_size=8),
    ...                   SimConfig(), device="cpu")
    >>> gen = torch.Generator().manual_seed(0)
    >>> state = sim.init_state(gen)
    >>> state, metrics, rec = sim.run_round(state, gen)
    >>> bool((rec.k_done == rec.k_planned).all())  # barrier: all completed
    True
    >>> rec.t_end                             # K steps x 1s at rate 1.0
    2.0
    """

    # which SimConfig.engine this class implements (the vectorized subclass
    # repro_torch.sim.fleet.FleetDFedRW overrides it)
    timeline_engine = "heap"

    def __init__(
        self,
        model: SmallModel,
        data: FederatedDataset,
        topo: Topology | SparseTopology,
        cfg: DFedRWConfig,
        sim: SimConfig,
        topology_schedule: list[tuple[float, Topology]] | None = None,
        device: str | torch.device = "cuda",
    ):
        assert cfg.engine == "flat", "the simulator batches into the flat engine"
        assert sim.policy in _POLICIES, sim.policy
        assert sim.engine in _ENGINES, sim.engine
        if sim.engine != self.timeline_engine:
            raise TypeError(
                f"SimConfig(engine={sim.engine!r}) but this class implements "
                f"{self.timeline_engine!r} — construct "
                "repro_torch.sim.fleet.FleetDFedRW for the vectorized backend (or "
                "let SimSetup.runner() dispatch on the config)")
        if sim.policy == "overlap" and cfg.chain_mode:
            raise NotImplementedError(
                "chain_mode chains already persist across rounds; overlap "
                "slots would need a second notion of chain identity")
        self.engine = DFedRW(model, data, topo, cfg, device=device)
        self.sim = sim
        self.fleet = DeviceFleet(topo.n, sim.devices)
        self.link = make_link_model(sim.links)
        # Adaptive quantization: the policy's dispatch table is validated by
        # the engine and pre-prices one payload size per width, so the
        # per-window width choice is pure data.
        self.bits_policy = sim.bits_policy
        self._base_bits = cfg.quant.bits
        self._hop_bits_table = {cfg.quant.bits: segment_wire_bits(
            self.engine.flat_spec, cfg.quant.bits)}
        if self.bits_policy is not None:
            widths = tuple(getattr(self.bits_policy, "widths", ()))
            if not widths:
                raise ValueError(
                    "bits_policy must expose a non-empty .widths dispatch "
                    "table (see repro_torch.sim.adapt.BitsPolicy)")
            self._hop_bits_table.update(
                segment_wire_bits_table(self.engine.flat_spec, widths))
            self.engine.prepare_bits(widths)
        self._window_bits = self._base_bits
        self.hop_bits = self._hop_bits_table[self._base_bits]
        self._uplink_prev = (0.0, 0.0, 0)    # queued_s, busy_s, sent totals
        self._last_metrics: RoundMetrics | None = None
        self.obs = None                      # repro_torch.obs.Recorder (attach_obs)
        self._obs_uplink_prev = (0.0, 0.0, 0)
        self._tracing = False                # causal span trees (attach_obs)
        self._trace_coarse = False
        self._chain_uid = np.zeros(cfg.m_chains, dtype=np.int64)
        self._uid_next = 0                   # next chain trace uid (slot fill)
        self._trace_agg_msgs: list | None = None
        self.queue = EventQueue()
        self.t = 0.0
        self._slots: list[_Slot | None] = [None] * cfg.m_chains
        self._trace: SimTrace | None = None
        if topology_schedule is not None:
            topology_schedule = sorted(topology_schedule, key=lambda e: e[0])
            assert all(tp.n == topo.n for _, tp in topology_schedule)
        self.topology_schedule = topology_schedule

    # ----------------------------------------------------------- topology
    def topo_at(self, t: float) -> Topology:
        topo = self.engine.topo
        if self.topology_schedule:
            for t_from, entry in self.topology_schedule:
                if t_from <= t:
                    topo = entry
        return topo

    # ------------------------------------------------------------ timeline
    # The four hooks below are the whole timeline-backend surface: the
    # vectorized fleet engine (repro_torch.sim.fleet) overrides them (plus
    # _fill_slots/_window_view/_agg_latency/_drop_down_aggregators/
    # _reset_timeline) while run_round stays this class's single shared
    # implementation of the window protocol.
    def _clear_board(self, t0: float) -> None:
        """Drop all chain slots and pending events (lockstep policies clear
        the board at every trigger; uplink busy-state deliberately persists
        — a contended transmit queue outlives the window that filled it)."""
        self._slots = [None] * self.engine.cfg.m_chains
        self.queue.clear(now=t0)

    def _advance_window(self, deadline: float) -> tuple[int, float]:
        """Advance the timeline to ``deadline`` (inclusive); returns
        (events dispatched, host seconds spent)."""
        t_host = _time.perf_counter()
        events = self.queue.drain(
            lambda ev: self._handle_event(self._slots, ev), until=deadline)
        return events, _time.perf_counter() - t_host

    def _timeline_now(self) -> float:
        """Latest instant the timeline has advanced to."""
        return self.queue.now

    def _release_slots(self, overlap: bool) -> None:
        """Free finished/killed slots after a trigger; live overlap chains
        keep their slot (and their pending event)."""
        for mi, slot in enumerate(self._slots):
            if not overlap or slot.killed or slot.k_done >= slot.k_m:
                self._slots[mi] = None

    def _handle_event(self, slots: list, ev: Event) -> None:
        """One event of the walk timeline (shared by run_round and the
        standalone timing probe). Freed slots never have pending events —
        a chain is only freed once it has nothing left in the queue
        (finished after its last sgd, or killed without a re-push)."""
        slot = slots[ev.chain]
        fleet, link, q = self.fleet, self.link, self.queue
        tracing = self._tracing
        mi, k = ev.chain, ev.step
        dev = int(slot.devices[k])
        if ev.kind == "hop":
            if tracing and np.isnan(slot.t_arr[k]):
                slot.t_arr[k] = ev.time    # first fire = wire arrival
            up = fleet.avail_at(dev, ev.time)
            if up > ev.time:          # wait out the down interval
                q.push(up, "hop", chain=mi, step=k)
                return
            if tracing:
                slot.t_up[k] = ev.time     # churn wait over: compute starts
            done_t = ev.time + fleet.step_time(dev)
            if fleet.down_during(dev, ev.time, done_t) is not None:
                slot.killed = True    # device lost mid-step: chain ends
                return                # with its completed prefix
            q.push(done_t, "sgd", chain=mi, step=k)
        else:  # "sgd": step k completed on dev at ev.time
            slot.k_done = k + 1
            slot.ts[k] = ev.time
            if k + 1 < slot.k_m:
                nxt = int(slot.devices[k + 1])
                if tracing:
                    t_send, t_arr = link.send_ex(dev, nxt, self.hop_bits,
                                                 ev.time)
                    slot.t_send[k + 1] = t_send
                else:
                    t_arr = link.send(dev, nxt, self.hop_bits, ev.time)
                q.push(t_arr, "hop", chain=mi, step=k + 1)

    def simulate_walk_timing(
        self, plan: WalkPlan, t0: float, deadline: float = math.inf
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int, float]:
        """Standalone timing probe: run a plan's hop/sgd event timeline (no
        compute, no slot persistence — it clears the shared event queue AND
        any uplink-contention backlog, so don't interleave with an overlap
        run in flight: the probe starts from an idle network).

        Returns ``(k_done, timestamps, killed, events, host_loop_s)`` where
        ``k_done[m]`` counts local steps chain m completed by ``deadline``,
        ``timestamps[m, k]`` is step k's completion instant (NaN if never),
        and ``killed[m]`` marks chains whose device churned out mid-step.
        """
        m = plan.m
        slots: list = [
            _Slot(devices=plan.devices[mi], k_m=int(plan.k_m[mi]),
                  bidx=np.zeros((plan.k_max, 0), dtype=np.int64),
                  ts=np.full(plan.k_max, np.nan),
                  t_arr=np.full(plan.k_max, np.nan),
                  t_up=np.full(plan.k_max, np.nan),
                  t_send=np.full(plan.k_max, np.nan))
            for mi in range(m)
        ]
        self.queue.clear(now=t0)
        if self.link.uplinks is not None:
            self.link.uplinks.clear()
        for mi in range(m):
            if slots[mi].k_m > 0:
                self.queue.push(t0, "hop", chain=mi, step=0)
        t_host = _time.perf_counter()
        events = self.queue.drain(
            lambda ev: self._handle_event(slots, ev), until=deadline)
        host_loop_s = _time.perf_counter() - t_host
        k_done = np.array([s.k_done for s in slots], dtype=np.int32)
        ts = np.stack([s.ts for s in slots])
        killed = np.array([s.killed for s in slots], dtype=bool)
        return k_done, ts, killed, events, host_loop_s

    def _agg_latency(self, agg: tuple, n: int, t_trigger: float) -> float:
        """Virtual time until the slowest Eq. 14 message lands (senders are
        the neighbors each aggregator lists; self-rows are free). Under
        shared-uplink contention each sender's messages serialize through
        its FIFO transmit queue — and keep it busy into the next window, so
        an aggregation burst congests the walks that follow."""
        agg_devices, agg_rows, agg_w = agg
        msgs: list | None = [] if self._tracing else None
        worst = t_trigger
        for a, row, w in zip(agg_devices, agg_rows, agg_w):
            if a >= n:
                continue  # pad slot
            for src, wi in zip(row, w):
                if wi > 0.0 and src != a:
                    if msgs is None:
                        t_done = self.link.send(
                            int(src), int(a), self.hop_bits, t_trigger)
                    else:
                        t_start, t_done = self.link.send_ex(
                            int(src), int(a), self.hop_bits, t_trigger)
                        msgs.append((int(src), int(a), t_start, t_done))
                    worst = max(worst, t_done)
        self._trace_agg_msgs = msgs
        return worst - t_trigger

    # -------------------------------------------------- adaptive bit-widths
    def _uplink_totals(self) -> tuple[float, float, int, float, float]:
        """Lifetime uplink-contention totals over all senders:
        (queued_s, busy_s, sent, t_first_start, t_last_done). Zeros/inf
        sentinels when contention is off. The fleet engine overrides this
        with its array-backed twin (value-identical on the parity suite)."""
        ups = getattr(self.link, "uplinks", None)
        if ups is None:
            return 0.0, 0.0, 0, math.inf, -math.inf
        queued = busy = 0.0
        sent = 0
        first, last = math.inf, -math.inf
        for st in ups.stats.values():
            queued += st.queued_s
            busy += st.busy_s
            sent += st.sent
            first = min(first, st.t_first_start)
            last = max(last, st.t_last_done)
        return queued, busy, sent, first, last

    def _set_window_bits(self, bits: int) -> None:
        """Switch the wire width for the window about to run: hop/aggregation
        pricing follows the precomputed table (the fleet engine additionally
        re-derives its bucket width). In-flight transfers keep the price they
        were admitted at — a message already on the wire has its width."""
        bits = int(bits)
        hb = self._hop_bits_table.get(bits)
        if hb is None:
            raise ValueError(
                f"bits_policy chose width {bits} outside its declared "
                f"dispatch table {sorted(self._hop_bits_table)}")
        self._window_bits = bits
        self.hop_bits = hb

    def _choose_bits(self, state: DFedRWState) -> int:
        """Ask the bits policy for the window's width (static width when no
        policy is installed). The observation is the PREVIOUS window's
        uplink-contention delta plus its comm/monitoring metrics;
        ``state.round`` counts completed windows, i.e. it indexes the window
        about to run."""
        if self.bits_policy is None:
            return self._base_bits
        queued, busy, sent, first, last = self._uplink_totals()
        pq, pb, ps = self._uplink_prev
        self._uplink_prev = (queued, busy, sent)
        m = self._last_metrics
        obs = BitsObs(
            window=int(state.round), t=self.t, bits_prev=self._window_bits,
            deadline_s=self.sim.deadline_s,
            queued_s=queued - pq, busy_s=busy - pb, sent=sent - ps,
            span_s=max(last - first, 0.0) if sent else 0.0,
            comm_bits_window=0.0 if m is None else m.comm_bits_round,
            comm_bits_total=state.comm_bits_total,
            train_loss=None if m is None else m.train_loss,
            gamma_hat=None if m is None else m.gamma_hat)
        return int(self.bits_policy(obs))

    # ------------------------------------------------------- window planner
    def _fill_slots(self, state: DFedRWState, topo: Topology,
                    t0: float) -> None:
        """Sample fresh walks into every free slot and push their initial
        hop events. With all M slots free (every non-overlap window, and
        overlap windows no chain spans) this is exactly the synchronous
        planner's draw order — the parity anchor."""
        free = [i for i, s in enumerate(self._slots) if s is None]
        if free:
            m = None if len(free) == self.engine.cfg.m_chains else len(free)
            plan, bidx = self.engine.plan_walks(state, topo=topo, m=m)
            for j, slot_i in enumerate(free):
                self._slots[slot_i] = _Slot(
                    devices=plan.devices[j], k_m=int(plan.k_m[j]),
                    bidx=bidx[j], ts=np.full(plan.k_max, np.nan),
                    t_arr=np.full(plan.k_max, np.nan),
                    t_up=np.full(plan.k_max, np.nan),
                    t_send=np.full(plan.k_max, np.nan))
                # trace uids in ascending free-slot order: the fleet engine
                # fills the same slots in the same order, so chain trace ids
                # agree across timeline backends
                self._chain_uid[slot_i] = self._uid_next + j
            self._uid_next += len(free)
        fresh = set(free)
        for slot_i, slot in enumerate(self._slots):
            slot.win_start = slot.k_done
            # resumed slots already carry exactly one pending event
            if slot_i in fresh and slot.k_m > 0:
                self.queue.push(t0, "hop", chain=slot_i, step=0)

    def _window_view(self, deadline_hit: bool) -> tuple:
        """Assemble the window's fixed-shape (M, K) engine view from the
        slots: fresh rows are their full planned trajectory with the
        executed prefix masked True; resumed rows lead with the masked
        anchor column (last completed step's device) followed by the
        remaining trajectory, padded by repeating the final entry (padding
        is masked out but keeps the monitoring-loss batch real)."""
        cfg = self.engine.cfg
        m_sl, k = cfg.m_chains, cfg.k_walk
        b = self._slots[0].bidx.shape[1]
        w_dev = np.zeros((m_sl, k), dtype=np.int32)
        w_mask = np.zeros((m_sl, k), dtype=bool)
        w_bidx = np.zeros((m_sl, k, b), dtype=np.int64)
        w_ts = np.full((m_sl, k), np.nan)
        k_planned = np.zeros(m_sl, dtype=np.int32)
        k_done = np.zeros(m_sl, dtype=np.int32)
        killed = np.zeros(m_sl, dtype=bool)
        finished = np.zeros(m_sl, dtype=bool)
        anchor = np.zeros(m_sl, dtype=np.int32)
        for mi, slot in enumerate(self._slots):
            j0, j1 = slot.win_start, slot.k_done
            shift = max(j0 - 1, 0)
            seg = slot.devices[shift:]
            bseg = slot.bidx[shift:]
            pad = k - seg.shape[0]
            if pad:
                seg = np.concatenate([seg, np.repeat(seg[-1:], pad)])
                bseg = np.concatenate([bseg, np.repeat(bseg[-1:], pad, axis=0)])
            w_dev[mi] = seg
            w_bidx[mi] = bseg
            w_mask[mi, j0 - shift:j1 - shift] = True
            exec_cols = np.arange(j0 - shift, j1 - shift)
            w_ts[mi, exec_cols] = slot.ts[j0:j1]
            k_planned[mi] = slot.k_m
            k_done[mi] = j1
            killed[mi] = slot.killed
            finished[mi] = j1 >= slot.k_m
            anchor[mi] = slot.devices[max(j1 - 1, 0)]
        live = (~finished & ~killed
                if (self.sim.policy == "overlap" and deadline_hit)
                else np.zeros(m_sl, dtype=bool))
        resume = ChainResume(live=live, k_done=k_done, anchor=anchor)
        return (w_dev, w_mask, w_bidx, w_ts, k_planned, killed, finished,
                resume)

    # ----------------------------------------------------------------- run
    def init_state(self, key: torch.Generator) -> DFedRWState:
        return self.engine.init_state(key)

    # ------------------------------------------------------------ telemetry
    def attach_obs(self, rec, trace: bool | str | None = None) -> None:
        """Attach a ``repro_torch.obs.Recorder``; an unbound ``VirtualClock`` is
        bound to this runner's virtual time, so spans/flushes are priced in
        virtual seconds and the recorded stream is a pure function of
        (scenario, seed) — same seed, identical stream, any host. The engine
        shares the recorder (``engine/*`` series land in the same stream).
        Host-side only: no event-loop, RNG or engine behavior changes.

        ``trace`` turns on causal span trees (``repro_torch.obs.trace``): ``None``
        inherits ``rec.trace_enabled``, ``True``/``False`` force it, and
        ``"full"``/``"coarse"`` additionally pin the emission granularity
        (default: coarsen past ``TRACE_COARSE_LIMIT`` chain-steps per
        window, logged as ``trace_coarse`` in the stream header)."""
        self.obs = rec
        if isinstance(rec.clock, VirtualClock) and not rec.clock.bound:
            rec.clock.bind(lambda: self.t)
        self.engine.attach_obs(rec)
        self._obs_uplink_prev = (0.0, 0.0, 0)
        mode = rec.trace_enabled if trace is None else trace
        self._tracing = bool(mode)
        if self._tracing:
            from repro_torch.obs.trace import TRACE_COARSE_LIMIT
            rec.trace_enabled = True
            cfg = self.engine.cfg
            est = cfg.m_chains * max(cfg.k_walk, 1)
            self._trace_coarse = (mode == "coarse" or
                                  (mode != "full" and est > TRACE_COARSE_LIMIT))
            if self._trace_coarse:
                rec.note_trace_coarse()

    def _obs_window(self, record: "SimRoundRecord", exec_plan: WalkPlan) -> None:
        """Per-window telemetry at the aggregation trigger (off-hot-path:
        after the engine call, before the next window). Deliberately
        excludes host wall times (``host_loop_s``) — event lines carry only
        virtual-time/count data, keeping the stream deterministic; wall-clock
        provenance lives in the stream header."""
        obs = self.obs
        obs.record_span("sim/window", record.t_start, record.t_end)
        obs.record_span("sim/walk", record.t_start, record.t_compute_end)
        obs.record_span("sim/aggregate", record.t_compute_end, record.t_end)
        obs.counter("sim/windows")
        obs.counter("sim/events", record.events)
        obs.counter("sim/chains_resumed", record.resumed_chains)
        obs.counter("sim/chains_truncated", record.truncated_chains)
        obs.counter("sim/chains_dropped", record.dropped_chains)
        obs.counter("sim/chains_killed", int(record.killed.sum()))
        obs.histogram("sim/window_steps", exec_plan.k_m)
        obs.gauge("sim/bits", float(record.bits))
        queued_s, busy_s, sent, _, _ = self._uplink_totals()
        pq, pb, ps = self._obs_uplink_prev
        self._obs_uplink_prev = (queued_s, busy_s, sent)
        dq, db, ds = queued_s - pq, busy_s - pb, sent - ps
        if ds:
            obs.counter("sim/uplink_sent", ds)
            obs.duration("sim/uplink_busy", db, t=record.t_end)
            obs.duration("sim/uplink_queued", dq, t=record.t_end)
        # the AdaptiveBits controller's input signal, window-local
        obs.gauge("sim/queue_pressure", dq / (dq + db) if (dq + db) > 0 else 0.0)
        if self._tracing:
            self._emit_trace_window(record)
        obs.flush(t=record.t_end)

    def _trace_arrays(self) -> tuple:
        """Stack the per-slot trace timing into the ``(M,)``/``(M, K)``
        arrays ``emit_walk_window`` consumes. The fleet engine overrides
        this with views of its native arrays — the emitter itself is shared,
        which is what makes heap and fleet traces identical by
        construction."""
        slots = self._slots
        return (self._chain_uid.copy(),
                np.stack([s.devices for s in slots]),
                np.array([s.win_start for s in slots], dtype=np.int64),
                np.array([s.k_done for s in slots], dtype=np.int64),
                np.stack([s.t_arr for s in slots]),
                np.stack([s.t_up for s in slots]),
                np.stack([s.ts for s in slots]),
                np.stack([s.t_send for s in slots]))

    def _emit_trace_window(self, record: "SimRoundRecord") -> None:
        """Emit the window's causal span trees (called at the aggregation
        trigger, before slot release — every completed step is emitted in
        exactly the window it completed in)."""
        from repro_torch.obs.trace import emit_walk_window
        uids, devices, j0, j1, t_arr, t_up, ts, t_send = self._trace_arrays()
        emit_walk_window(self.obs, record.round, uids=uids, devices=devices,
                         win_start=j0, k_done=j1, t_arr=t_arr, t_up=t_up,
                         ts=ts, t_send=t_send,
                         agg_msgs=self._trace_agg_msgs,
                         t_compute_end=record.t_compute_end,
                         t_end=record.t_end, coarse=self._trace_coarse)
        self._trace_agg_msgs = None

    def _reset_timeline(self) -> None:
        """Rewind the virtual timeline for a fresh run on this runner: the
        clock, the chain slots, pending events and uplink queue state all
        reset (a second run must not resume the previous run's chains
        against re-initialized params). NOTE the protocol/jitter RNG
        streams deliberately do NOT rewind — like the synchronous engine,
        a runner streams its host rng across everything it executes, so
        same-seed reproducibility means a fresh runner, not a reused one."""
        self.t = 0.0
        self._slots = [None] * self.engine.cfg.m_chains
        self._trace = None
        self.queue.clear(now=0.0)
        if self.link.uplinks is not None:
            self.link.uplinks.clear()
        # adaptive-control state rewinds with the timeline (policies are
        # stateless by contract: their position is the runner's window width)
        self._set_window_bits(self._base_bits)
        self._uplink_prev = (0.0, 0.0, 0)
        self._obs_uplink_prev = (0.0, 0.0, 0)
        self._last_metrics = None
        self._chain_uid[:] = 0
        self._uid_next = 0
        self._trace_agg_msgs = None

    def _drive(
        self,
        windows: int,
        key: torch.Generator,
        x_test: np.ndarray | None,
        y_test: np.ndarray | None,
        eval_every: int,
        callback: Callable | None,
        step: Callable,
        trace: SimTrace | None,
        qseeds=None,
        params=None,
    ) -> SimResult:
        """Shared run/replay driver: init, per-window step, eval cadence,
        result assembly — one implementation so the bit-identical-replay
        contract cannot drift between the two paths. ``key`` draws the
        initial weights (unless ``params``, a model tree, is given) and each
        quantized window's seed words (unless ``qseeds[r]`` gives window
        r's (K+1, 2) words)."""
        state = (self.init_state(key) if params is None
                 else self.engine.state_from_params(params))
        hist = History()
        records: list[SimRoundRecord] = []
        for r in range(windows):
            words = None if qseeds is None else qseeds[r]
            state, metrics, record_r = step(state, key, r, words)
            records.append(record_r)
            if x_test is not None and ((r + 1) % eval_every == 0
                                       or r == windows - 1):
                evald = self.engine.evaluate(state, x_test, y_test)
                hist.record(metrics, evald, state)
                if callback is not None:
                    callback(r, metrics, evald, record_r)
        return SimResult(
            history=hist,
            records=records,
            state=state,
            virtual_time_s=self.t,
            events_total=sum(rec.events for rec in records),
            host_loop_s=sum(rec.host_loop_s for rec in records),
            trace=trace,
        )

    def run_round(
        self, state: DFedRWState, key: torch.Generator | None, qseeds=None,
    ) -> tuple[DFedRWState, RoundMetrics, SimRoundRecord]:
        """One deadline window. A quantized window draws its (K+1, 2)
        quantizer seed words from ``key`` unless ``qseeds`` gives them."""
        sim = self.sim
        t0 = self.t
        topo = self.topo_at(t0)
        # adaptive quantization: pick the window's wire width BEFORE any
        # pricing — the whole window (hops, aggregation burst, compute,
        # Eq. 18 accounting) runs at one width
        self._set_window_bits(self._choose_bits(state))
        overlap = sim.policy == "overlap"
        if not overlap:
            # lockstep policies: every trigger clears the board — fresh
            # chains each window, no events carried over
            self._clear_board(t0)
        self._fill_slots(state, topo, t0)
        deadline = math.inf if sim.deadline_s is None else t0 + sim.deadline_s
        events, loop_s = self._advance_window(deadline)

        (w_dev, w_mask, w_bidx, w_ts, k_planned, killed, finished,
         resume) = self._window_view(math.isfinite(deadline))
        win_plan = WalkPlan(
            devices=w_dev, mask=w_mask,
            k_m=w_mask.sum(axis=1).astype(np.int32), timestamps=w_ts,
            resume=resume)
        if sim.policy == "drop":
            exec_mask = w_mask & finished[:, None]
            exec_plan = WalkPlan(devices=w_dev, mask=exec_mask,
                                 k_m=exec_mask.sum(axis=1).astype(np.int32),
                                 timestamps=w_ts, resume=resume)
        else:
            exec_plan = win_plan
        agg = self.engine.plan_aggregation(exec_plan, topo=topo)
        if self.fleet.cfg.has_churn:
            t_trigger = (deadline if math.isfinite(deadline)
                         else self._timeline_now())
            agg = self._drop_down_aggregators(agg, t_trigger)
        t_compute_end = deadline if math.isfinite(deadline) else max(
            self._timeline_now(), t0)
        agg_lat = self._agg_latency(agg, topo.n, t_compute_end)
        self.t = t_compute_end + agg_lat
        new_state, metrics = self.engine.execute_round(
            state, exec_plan, w_bidx, agg, key, account_plan=win_plan,
            bits=self._window_bits, qseeds=qseeds)
        self._last_metrics = metrics
        # records and traces read the cut-state from the plan's ChainResume
        record = SimRoundRecord(
            round=new_state.round, t_start=t0, t_compute_end=t_compute_end,
            t_end=self.t, events=events, host_loop_s=loop_s,
            k_planned=k_planned, k_done=resume.k_done,
            k_exec=exec_plan.k_m.copy(), killed=killed,
            agg_latency_s=agg_lat, resumed=resume.live,
            bits=self._window_bits)
        if self._trace is not None:
            self._trace.windows.append(WindowTrace(
                round=record.round, t_start=t0, t_compute_end=t_compute_end,
                t_end=self.t, agg_latency_s=agg_lat, events=events,
                host_loop_s=loop_s, k_planned=k_planned,
                k_done=resume.k_done, killed=killed, resumed=resume.live,
                devices=w_dev, exec_mask=exec_plan.mask, account_mask=w_mask,
                timestamps=w_ts, bidx=w_bidx, agg_devices=agg[0],
                agg_rows=agg[1], agg_weights=agg[2],
                bits=self._window_bits))
        if self.obs is not None:
            self._obs_window(record, exec_plan)
        # free finished/killed slots; live chains carry their pending event
        self._release_slots(overlap)
        return new_state, metrics, record

    def _drop_down_aggregators(self, agg: tuple, t: float) -> tuple:
        """An aggregator that is churned out when the trigger fires cannot
        apply Eq. 11/14: redirect its device id out of range, so the round
        drops it; shapes are unchanged. The offset ``n + M`` clears the
        chain-mode pad ids (``n .. n+M``), keeping every id unique."""
        agg_devices, agg_rows, agg_w = agg
        n = self.engine.topo.n
        out = agg_devices.copy()
        for i, a in enumerate(agg_devices):
            if a < n and not self.fleet.is_up(int(a), t):
                out[i] = n + self.engine.cfg.m_chains + a
        return out, agg_rows, agg_w

    def run(
        self,
        rounds: int,
        key: torch.Generator,
        x_test: np.ndarray | None = None,
        y_test: np.ndarray | None = None,
        eval_every: int = 1,
        callback: Callable | None = None,
        record: bool = False,
        qseeds=None,
        params=None,
    ) -> SimResult:
        """Drive ``rounds`` deadline windows; evaluates every ``eval_every``
        rounds when test data is given (generator handling matches
        core.metrics.train_loop, so seeded runs are comparable).
        ``record=True`` captures the run as a replayable
        :class:`repro_torch.sim.trace.SimTrace` on ``SimResult.trace``.
        ``qseeds`` (per window, (K+1, 2) uint32 words) and ``params`` (the
        initial model tree) replace the generator's draws, for holding a
        run against another package's."""
        cfg = self.engine.cfg
        self._reset_timeline()
        self._trace = SimTrace(header=make_header(
            n=self.engine.topo.n, m_chains=cfg.m_chains, k_walk=cfg.k_walk,
            batch_size=cfg.batch_size, bits=cfg.quant.bits,
            policy=self.sim.policy, deadline_s=self.sim.deadline_s,
            rounds=rounds, eval_every=eval_every)) if record else None
        return self._drive(
            rounds, key, x_test, y_test, eval_every, callback,
            step=lambda state, gen, r, words: self.run_round(state, gen, words),
            trace=self._trace, qseeds=qseeds, params=params)

    # -------------------------------------------------------------- replay
    def replay(
        self,
        trace: SimTrace,
        key: torch.Generator,
        x_test: np.ndarray | None = None,
        y_test: np.ndarray | None = None,
        eval_every: int = 1,
        callback: Callable | None = None,
        qseeds=None,
        params=None,
    ) -> SimResult:
        """Re-execute a recorded trace through the flat engine — no event
        loop, no device/link/churn models — reproducing the recorded run's
        ``SimResult`` bit-exactly (a generator seeded as the run's was
        required: it draws the same weights and per-window seed words as
        :meth:`run`; ``qseeds``/``params`` as in :meth:`run`). The engine this
        runner wraps must match the trace header's shapes/bits; the trace
        itself is integrity-validated (window shapes vs header, sequential
        rounds, in-range ids) up front, so a mismatched or corrupted trace
        raises a typed error here instead of a shape failure deep inside
        the flat engine."""
        from repro_torch.sim.trace import TraceIntegrityError

        h = trace.header
        cfg = self.engine.cfg
        expect = dict(n=self.engine.topo.n, m_chains=cfg.m_chains,
                      k_walk=cfg.k_walk, batch_size=cfg.batch_size,
                      bits=cfg.quant.bits)
        mismatched = {k_: (h.get(k_), v) for k_, v in expect.items()
                      if h.get(k_) != v}
        if mismatched:
            detail = "; ".join(f"{k_}: trace={hv} engine={ev}"
                               for k_, (hv, ev) in mismatched.items())
            raise TraceIntegrityError(
                f"trace header does not match this engine ({detail}); "
                f"replay needs the recording configuration — rebuild the "
                f"fleet from the trace header (launch/sim.py --replay does "
                f"this from the recorded scenario provenance)")
        trace.validate()
        self._reset_timeline()

        def step(state, gen, r, words):
            w = trace.windows[r]
            exec_plan = WalkPlan(
                devices=w.devices, mask=w.exec_mask,
                k_m=w.exec_mask.sum(axis=1).astype(np.int32),
                timestamps=w.timestamps)
            account_plan = WalkPlan(
                devices=w.devices, mask=w.account_mask,
                k_m=w.account_mask.sum(axis=1).astype(np.int32),
                timestamps=w.timestamps)
            agg = (w.agg_devices, w.agg_rows, w.agg_weights)
            # v2 windows carry their executed width (adaptive runs switch it
            # per window); v1 windows replay at the header's static width
            state, metrics = self.engine.execute_round(
                state, exec_plan, w.bidx, agg, gen, account_plan=account_plan,
                bits=w.bits, qseeds=words)
            self.t = w.t_end
            record_r = SimRoundRecord(
                round=w.round, t_start=w.t_start,
                t_compute_end=w.t_compute_end, t_end=w.t_end,
                events=w.events, host_loop_s=w.host_loop_s,
                k_planned=w.k_planned, k_done=w.k_done,
                k_exec=exec_plan.k_m.copy(), killed=w.killed,
                agg_latency_s=w.agg_latency_s, resumed=w.resumed,
                bits=w.bits)
            return state, metrics, record_r

        return self._drive(
            len(trace.windows), key, x_test, y_test, eval_every, callback,
            step=step, trace=trace, qseeds=qseeds, params=params)
