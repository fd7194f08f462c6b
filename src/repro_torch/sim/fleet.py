"""Vectorized fleet timeline: the scalable backend of ``repro_torch.sim``.

The port of ``repro.sim.fleet``: numpy for numpy the reference's arrays and
float operations, so the port's fleet timeline equals the reference's bit
for bit, and equals the port's heap engine wherever the reference's fleet
equals its heap.

The heap engine (``repro_torch.sim.runner``) dispatches one Python callback per
hop/sgd event — honest, and the bit-exact oracle, but bounded by per-event
interpreter overhead (~10^5 events/s). This module advances the SAME window
protocol as batched NumPy array programs: every chain's pending activity
lives in flat per-chain arrays (kind, step index, instant), and the
timeline advances by *sweeps* (process every pending hop, then every
pending sgd, repeat) instead of one event at a time. ``FleetDFedRW``
subclasses :class:`repro_torch.sim.runner.AsyncDFedRW` and overrides only the
timeline hooks — planning, window views, aggregation and the engine's compute
path are shared, so engine parity reduces to timing-state parity.

Correctness argument
--------------------
*Without* shared-uplink contention, chains interact through nothing but
deterministic per-device state (rates, churn traces), so events commute:
processing all pending hops, then all pending sgds, in any order produces
the exact per-event arithmetic of the heap loop — the fleet replicates each
float operation (``t + step_time``, ``t + transfer_time``,
``avail_at``/``down_during`` churn queries) verbatim, giving bit-identical
timestamps, kill decisions and event counts.

*With* contention (``queue=True``), cross-device sends serialize through
per-sender FIFO uplinks, so global admission order matters. The fleet
advances in **buckets** of width ``delta = min_step_time +
min_transfer_time``: starting from the earliest pending instant ``b0``,
each chain can emit at most ONE cross-device send before ``b0 + delta``
(a send's arrival costs >= min_transfer, the next local step >= min_step),
so sweeping ``[b0, b0+delta)`` to quiescence collects every send of the
bucket before any is admitted. Sends are admitted in ``(t_ready, chain)``
order — for every lockstep parity scenario this equals the heap's
``(time, seq)`` order, and it is the fleet's *deterministic tie contract*
in general (two sends from one sender at the exact same instant with
divergent histories may order differently than the heap's push sequence;
see docs/SIMULATOR.md). Per-sender FIFO recursion
``start_i = max(ready_i, done_{i-1})`` is evaluated sequentially inside
each same-sender group (and by a bit-exact prepended-base cumsum for
same-instant aggregation bursts), reproducing ``UplinkQueue.enqueue``'s
float arithmetic and stats exactly.

What the fleet engine refuses: ``jitter_sigma > 0`` (per-message jitter
draws are ordered by event processing, which batched pricing cannot
reproduce) — use the heap engine for jittered links.
"""
from __future__ import annotations

import dataclasses
import math
import time as _time

import numpy as np

from repro_torch.core.dfedrw import DFedRWConfig, DFedRWState
from repro_torch.core.graph import Topology
from repro_torch.core.walk import ChainResume, WalkPlan
from repro_torch.sim.events import UplinkStats
from repro_torch.sim.hierarchy import HierarchicalLinkModel
from repro_torch.sim.runner import AsyncDFedRW, SimConfig

__all__ = ["FleetDFedRW"]

# Pending-activity kinds (one slot per chain; inf time == nothing pending).
_NONE, _HOP, _SGD, _SEND = 0, 1, 2, 3


class FleetDFedRW(AsyncDFedRW):
    """Vectorized window-bucketing timeline over the flat DFedRW engine.

    Drop-in for :class:`repro_torch.sim.runner.AsyncDFedRW` with
    ``SimConfig(engine="fleet")`` — same constructor, same ``run`` /
    ``run_round`` / ``simulate_walk_timing`` surface, bit-identical
    ``SimResult`` on the parity suite (tests/test_torch_sim_fleet.py)."""

    timeline_engine = "fleet"

    def __init__(self, model, data, topo, cfg: DFedRWConfig, sim: SimConfig,
                 topology_schedule=None, device="cuda"):
        super().__init__(model, data, topo, cfg, sim,
                         topology_schedule=topology_schedule, device=device)
        if getattr(sim.links, "jitter_sigma", 0.0) > 0.0:
            raise ValueError(
                "fleet engine requires jitter_sigma == 0 (event-serial "
                "jitter draws); use SimConfig(engine='heap') for jittered "
                "links")
        if sim.devices.base_step_time <= 0.0:
            raise ValueError("fleet engine requires base_step_time > 0")
        m, k, b = cfg.m_chains, cfg.k_walk, cfg.batch_size
        self._alloc_chains(m, k, b)
        self._now = 0.0
        self._queue_on = self.link.uplinks is not None
        if self._queue_on:
            self._set_window_bits(self._window_bits)  # derives _bucket_delta
            if not self._bucket_delta > 0.0:
                raise ValueError(
                    "fleet engine with queue=True needs a positive bucket "
                    "width (min step time + min transfer time)")
        self._q_reset()

    def _set_window_bits(self, bits: int) -> None:
        """A width switch re-derives the bucket width: the correctness bound
        'at most one cross-device send per chain per bucket' must hold at
        the CURRENT window's transfer price, so delta shrinks and grows with
        the wire size."""
        super()._set_window_bits(bits)
        if getattr(self, "_queue_on", False):
            self._bucket_delta = (self.fleet.min_step_time
                                  + self.link.min_transfer_time(self.hop_bits))

    def _uplink_totals(self) -> tuple[float, float, int, float, float]:
        if not self._queue_on:
            return 0.0, 0.0, 0, math.inf, -math.inf
        return (float(self._q_queued.sum()), float(self._q_busy_s.sum()),
                int(self._q_sent.sum()), float(self._q_first.min()),
                float(self._q_last.max()))

    # ----------------------------------------------------- state management
    def _alloc_chains(self, m: int, k: int, b: int) -> None:
        self._f_dev = np.zeros((m, k), dtype=np.int32)
        self._f_bidx = np.zeros((m, k, b), dtype=np.int64)
        self._f_ts = np.full((m, k), np.nan)
        self._f_km = np.zeros(m, dtype=np.int32)
        self._f_kdone = np.zeros(m, dtype=np.int32)
        self._f_wstart = np.zeros(m, dtype=np.int32)
        self._f_killed = np.zeros(m, dtype=bool)
        self._f_occ = np.zeros(m, dtype=bool)
        self._f_kind = np.full(m, _NONE, dtype=np.int8)
        self._f_step = np.zeros(m, dtype=np.int32)
        self._f_time = np.full(m, np.inf)
        # trace timing twins of runner._Slot.t_arr/t_up/t_send (written only
        # when tracing; NaN = never happened)
        self._t_arr = np.full((m, k), np.nan)
        self._t_up = np.full((m, k), np.nan)
        self._t_send = np.full((m, k), np.nan)

    def _q_reset(self) -> None:
        """Reset uplink busy/stats state (the array twin of
        ``UplinkQueue.clear``)."""
        n = self.engine.topo.n
        if self._queue_on:
            self._q_busy = np.zeros(n)
            self._q_sent = np.zeros(n, dtype=np.int64)
            self._q_busy_s = np.zeros(n)
            self._q_queued = np.zeros(n)
            self._q_first = np.full(n, np.inf)
            self._q_last = np.full(n, -np.inf)

    def uplink_stats(self, device: int) -> UplinkStats | None:
        """Per-sender contention accounting (array-backed; value-identical
        to the heap engine's ``link.uplink_stats`` on the parity suite)."""
        if not self._queue_on or self._q_sent[device] == 0:
            return None
        return UplinkStats(
            sent=int(self._q_sent[device]),
            busy_s=float(self._q_busy_s[device]),
            queued_s=float(self._q_queued[device]),
            t_first_start=float(self._q_first[device]),
            t_last_done=float(self._q_last[device]))

    # ----------------------------------------------------- runner overrides
    def _clear_board(self, t0: float) -> None:
        self._f_occ[:] = False
        self._f_killed[:] = False
        self._f_kind[:] = _NONE
        self._f_time[:] = np.inf
        self._now = t0

    def _timeline_now(self) -> float:
        return self._now

    def _release_slots(self, overlap: bool) -> None:
        done = self._f_killed | (self._f_kdone >= self._f_km)
        if overlap:
            self._f_occ &= ~done
        else:
            self._f_occ[:] = False

    def _reset_timeline(self) -> None:
        super()._reset_timeline()
        cfg = self.engine.cfg
        self._alloc_chains(cfg.m_chains, cfg.k_walk, cfg.batch_size)
        self._now = 0.0
        self._q_reset()

    def _fill_slots(self, state: DFedRWState, topo: Topology,
                    t0: float) -> None:
        free = np.nonzero(~self._f_occ)[0]
        if free.size:
            m = (None if free.size == self.engine.cfg.m_chains
                 else int(free.size))
            plan, bidx = self.engine.plan_walks(state, topo=topo, m=m)
            self._f_dev[free] = plan.devices
            self._f_km[free] = plan.k_m
            self._f_bidx[free] = bidx
            self._f_ts[free] = np.nan
            self._f_kdone[free] = 0
            self._f_killed[free] = False
            self._f_occ[free] = True
            started = plan.k_m > 0
            self._f_kind[free] = np.where(started, _HOP, _NONE).astype(np.int8)
            self._f_step[free] = 0
            self._f_time[free] = np.where(started, t0, np.inf)
            self._t_arr[free] = np.nan
            self._t_up[free] = np.nan
            self._t_send[free] = np.nan
            # same ascending-slot uid order as the heap's _fill_slots
            self._chain_uid[free] = self._uid_next + np.arange(free.size)
            self._uid_next += int(free.size)
        self._f_wstart[:] = self._f_kdone

    # ------------------------------------------------------------- timeline
    def _advance_window(self, deadline: float) -> tuple[int, float]:
        t_host = _time.perf_counter()
        events = 0
        if not self._queue_on:
            events += self._sweep(deadline, strict=False)
        else:
            while True:
                t_min = self._f_time.min() if self._f_time.size else math.inf
                if t_min > deadline:
                    break
                b1 = t_min + self._bucket_delta
                limit, strict = ((deadline, False) if b1 > deadline
                                 else (b1, True))
                events += self._sweep(limit, strict)
                self._admit_sends(limit, strict)
                events += self._sweep(limit, strict)
        return events, _time.perf_counter() - t_host

    def _within(self, limit: float, strict: bool) -> np.ndarray:
        return (self._f_time < limit) if strict else (self._f_time <= limit)

    def _sweep(self, limit: float, strict: bool) -> int:
        """Process pending hops/sgds up to ``limit`` to quiescence. Returns
        the number processed (== heap event pops over the same span)."""
        total = 0
        while True:
            inside = self._within(limit, strict)
            hops = np.nonzero(inside & (self._f_kind == _HOP))[0]
            if hops.size:
                total += hops.size
                self._process_hops(hops)
                continue
            sgds = np.nonzero(inside & (self._f_kind == _SGD))[0]
            if sgds.size:
                total += sgds.size
                self._process_sgds(sgds)
                continue
            return total

    def _process_hops(self, idx: np.ndarray) -> None:
        t = self._f_time[idx]
        steps = self._f_step[idx]
        devs = self._f_dev[idx, steps].astype(np.int64)
        self._now = max(self._now, float(t.max()))
        if self._tracing:
            first = np.isnan(self._t_arr[idx, steps])
            self._t_arr[idx[first], steps[first]] = t[first]
        up = self.fleet.avail_at_many(devs, t)
        waited = up > t
        if waited.any():
            # wait out the down interval: stays a hop, counted like the
            # heap's re-pushed event
            self._f_time[idx[waited]] = up[waited]
        run = idx[~waited]
        if run.size == 0:
            return
        t_run = t[~waited]
        d_run = devs[~waited]
        done = t_run + self.fleet.step_times(d_run)
        dead = self.fleet.down_in_many(d_run, t_run, done)
        if dead.any():
            kill = run[dead]
            self._f_killed[kill] = True
            self._f_kind[kill] = _NONE
            self._f_time[kill] = np.inf
        live = run[~dead]
        self._f_kind[live] = _SGD
        self._f_time[live] = done[~dead]
        if self._tracing and run.size:
            self._t_up[run, self._f_step[run]] = t_run

    def _process_sgds(self, idx: np.ndarray) -> None:
        t = self._f_time[idx]
        k = self._f_step[idx]
        self._now = max(self._now, float(t.max()))
        self._f_kdone[idx] = k + 1
        self._f_ts[idx, k] = t
        cont = (k + 1) < self._f_km[idx]
        fin = idx[~cont]
        self._f_kind[fin] = _NONE
        self._f_time[fin] = np.inf
        go = idx[cont]
        if go.size == 0:
            return
        k_go = k[cont]
        cur = self._f_dev[go, k_go].astype(np.int64)
        nxt = self._f_dev[go, k_go + 1].astype(np.int64)
        self._f_step[go] = k_go + 1
        self_hop = cur == nxt
        # self-hop: the model is already there — next hop at this instant
        self._f_kind[go[self_hop]] = _HOP
        self._f_time[go[self_hop]] = t[cont][self_hop]
        if self._tracing and self_hop.any():
            self._t_send[go[self_hop], k_go[self_hop] + 1] = t[cont][self_hop]
        cross = go[~self_hop]
        if cross.size == 0:
            return
        if self._queue_on:
            # hold as a pending send; the bucket loop admits it in global
            # (t_ready, chain) order
            self._f_kind[cross] = _SEND
            self._f_time[cross] = t[cont][~self_hop]
        else:
            svc = self.link.transfer_time_batch(
                cur[~self_hop], nxt[~self_hop], self.hop_bits)
            t_ready = t[cont][~self_hop]
            if isinstance(self.link, HierarchicalLinkModel):
                self.link.record_batch(
                    cur[~self_hop], nxt[~self_hop], self.hop_bits, t_ready)
            self._f_kind[cross] = _HOP
            self._f_time[cross] = t_ready + svc
            if self._tracing:
                # uncontended: transmit starts the instant the step finished
                self._t_send[cross, k_go[~self_hop] + 1] = t_ready

    # ------------------------------------------------------------ contention
    def _fifo_serialize(self, src: np.ndarray, t_ready: np.ndarray,
                        svc: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """FIFO-admit sends (already in admission order) through the
        per-sender uplink arrays; returns each send's (t_start, t_done).
        Reproduces ``UplinkQueue.enqueue`` float arithmetic and stats exactly:
        same-sender groups run the sequential ``start = max(ready, done_prev)``
        recursion; distinct senders vectorize (their queues are independent)."""
        order = np.argsort(src, kind="stable")
        s = src[order]
        boundary = np.r_[True, s[1:] != s[:-1]]
        group_of = np.cumsum(boundary) - 1
        group_size = np.bincount(group_of)
        t_start = np.empty(src.shape[0])
        t_done = np.empty(src.shape[0])
        single = group_size[group_of] == 1
        pos_s = order[single]
        if pos_s.size:
            d = src[pos_s]
            start = np.maximum(t_ready[pos_s], self._q_busy[d])
            done = start + svc[pos_s]
            t_start[pos_s] = start
            t_done[pos_s] = done
            self._q_busy[d] = done
            self._q_sent[d] += 1
            self._q_busy_s[d] += svc[pos_s]
            self._q_queued[d] += start - t_ready[pos_s]
            self._q_first[d] = np.minimum(self._q_first[d], start)
            self._q_last[d] = np.maximum(self._q_last[d], done)
        if single.all():
            return t_start, t_done
        starts_at = np.nonzero(boundary)[0]
        for g in np.nonzero(group_size > 1)[0]:
            lo = starts_at[g]
            pos = order[lo:lo + group_size[g]]
            d = int(src[pos[0]])
            busy = float(self._q_busy[d])
            for p in pos:
                ready, s_p = float(t_ready[p]), float(svc[p])
                start = max(ready, busy)
                busy = start + s_p
                t_start[p] = start
                t_done[p] = busy
                self._q_sent[d] += 1
                self._q_busy_s[d] += s_p
                self._q_queued[d] += start - ready
                self._q_first[d] = min(self._q_first[d], start)
                self._q_last[d] = max(self._q_last[d], busy)
            self._q_busy[d] = busy
        return t_start, t_done

    def _admit_sends(self, limit: float, strict: bool) -> None:
        sel = self._within(limit, strict) & (self._f_kind == _SEND)
        if not sel.any():
            return
        idx = np.nonzero(sel)[0]
        t_ready = self._f_time[idx]
        order = np.lexsort((idx, t_ready))     # (t_ready, chain): the fleet's
        idx, t_ready = idx[order], t_ready[order]  # deterministic tie contract
        step = self._f_step[idx]
        src = self._f_dev[idx, step - 1].astype(np.int64)
        dst = self._f_dev[idx, step].astype(np.int64)
        svc = self.link.transfer_time_batch(src, dst, self.hop_bits)
        t_start, t_done = self._fifo_serialize(src, t_ready, svc)
        if isinstance(self.link, HierarchicalLinkModel):
            self.link.record_batch(src, dst, self.hop_bits, t_start)
        if self._tracing:
            self._t_send[idx, step] = t_start
        self._f_kind[idx] = _HOP
        self._f_time[idx] = t_done

    # ----------------------------------------------------------- aggregation
    def _agg_latency(self, agg: tuple, n: int, t_trigger: float) -> float:
        """Vectorized Eq. 14 fan-in latency; float-identical to the heap
        loop (row-major sender order, ``(t_trigger + svc) - t_trigger``
        arithmetic, prepended-base cumsum for the same-instant FIFO burst)."""
        agg_devices, agg_rows, agg_w = agg
        a_col = agg_devices[:, None].astype(np.int64)
        valid = (a_col < n) & (agg_w > 0.0) & (agg_rows != a_col)
        src = agg_rows.astype(np.int64)[valid]       # row-major == heap order
        dst = np.broadcast_to(a_col, agg_rows.shape)[valid]
        if src.size == 0:
            self._trace_agg_msgs = [] if self._tracing else None
            return 0.0
        svc = self.link.transfer_time_batch(src, dst, self.hop_bits)
        if isinstance(self.link, HierarchicalLinkModel):
            start_est = (np.maximum(np.full(src.shape, t_trigger),
                                    self._q_busy[src])
                         if self._queue_on else
                         np.full(src.shape, t_trigger))
            self.link.record_batch(src, dst, self.hop_bits, start_est)
        if not self._queue_on:
            if self._tracing:
                dones = t_trigger + svc
                self._trace_agg_msgs = list(zip(
                    src.tolist(), dst.tolist(),
                    [t_trigger] * src.shape[0], dones.tolist()))
            worst = max(t_trigger, float((t_trigger + svc).max()))
            return worst - t_trigger
        # Same-instant burst: every message is ready at t_trigger, so the
        # FIFO recursion degenerates to a running sum per sender — evaluate
        # it with a prepended-base cumsum (bit-identical to the sequential
        # recursion) while updating the uplink stats like enqueue would.
        worst = t_trigger
        order = np.argsort(src, kind="stable")
        s = src[order]
        boundary = np.r_[True, s[1:] != s[:-1]]
        starts_at = np.nonzero(boundary)[0]
        group_of = np.cumsum(boundary) - 1
        group_size = np.bincount(group_of)
        tracing = self._tracing
        if tracing:
            starts_full = np.empty(src.shape[0])
            dones_full = np.empty(src.shape[0])
        for g in range(group_size.shape[0]):
            pos = order[starts_at[g]:starts_at[g] + group_size[g]]
            d = int(src[pos[0]])
            base = max(t_trigger, float(self._q_busy[d]))
            dones = np.cumsum(np.concatenate(([base], svc[pos])))[1:]
            if tracing:
                # each message transmits when its predecessor lands (FIFO)
                starts_full[pos] = np.concatenate(([base], dones[:-1]))
                dones_full[pos] = dones
            worst = max(worst, float(dones[-1]))
            self._q_busy[d] = dones[-1]
            self._q_sent[d] += pos.shape[0]
            self._q_busy_s[d] = np.cumsum(
                np.concatenate(([self._q_busy_s[d]], svc[pos])))[-1]
            queued = np.concatenate(([base], dones[:-1])) - t_trigger
            self._q_queued[d] = np.cumsum(
                np.concatenate(([self._q_queued[d]], queued)))[-1]
            self._q_first[d] = min(self._q_first[d], base)
            self._q_last[d] = max(self._q_last[d], float(dones[-1]))
        if tracing:
            self._trace_agg_msgs = list(zip(
                src.tolist(), dst.tolist(),
                starts_full.tolist(), dones_full.tolist()))
        return worst - t_trigger

    def _drop_down_aggregators(self, agg: tuple, t: float) -> tuple:
        agg_devices, agg_rows, agg_w = agg
        n = self.engine.topo.n
        out = agg_devices.copy()
        real = np.nonzero(agg_devices < n)[0]
        if real.size:
            down = ~self.fleet.is_up_many(
                agg_devices[real].astype(np.int64), t)
            hit = real[down]
            out[hit] = n + self.engine.cfg.m_chains + agg_devices[hit]
        return out, agg_rows, agg_w

    # ----------------------------------------------------------- window view
    def _window_view(self, deadline_hit: bool) -> tuple:
        cfg = self.engine.cfg
        m_sl, k = cfg.m_chains, cfg.k_walk
        rows = np.arange(m_sl)[:, None]
        j0, j1 = self._f_wstart, self._f_kdone
        shift = np.maximum(j0 - 1, 0)
        cols = np.minimum(shift[:, None] + np.arange(k)[None, :], k - 1)
        w_dev = self._f_dev[rows, cols]
        w_bidx = self._f_bidx[rows, cols]
        rel = np.arange(k)[None, :]
        w_mask = ((rel >= (j0 - shift)[:, None])
                  & (rel < (j1 - shift)[:, None]))
        w_ts = np.where(w_mask, self._f_ts[rows, cols], np.nan)
        k_planned = self._f_km.copy()
        k_done = j1.copy()
        killed = self._f_killed.copy()
        finished = j1 >= self._f_km
        anchor = self._f_dev[np.arange(m_sl), np.maximum(j1 - 1, 0)]
        live = (~finished & ~killed
                if (self.sim.policy == "overlap" and deadline_hit)
                else np.zeros(m_sl, dtype=bool))
        resume = ChainResume(live=live, k_done=k_done,
                             anchor=anchor.astype(np.int32))
        return (w_dev, w_mask, w_bidx, w_ts, k_planned, killed, finished,
                resume)

    # -------------------------------------------------------- timing probe
    def simulate_walk_timing(self, plan: WalkPlan, t0: float,
                             deadline: float = math.inf):
        """Standalone timing probe (same caveats as the heap version: it
        resets the uplink backlog, so don't interleave with an overlap run
        in flight)."""
        m, k = plan.m, plan.k_max
        stash = (self._f_dev, self._f_bidx, self._f_ts, self._f_km,
                 self._f_kdone, self._f_wstart, self._f_killed, self._f_occ,
                 self._f_kind, self._f_step, self._f_time,
                 self._t_arr, self._t_up, self._t_send, self._now)
        self._alloc_chains(m, k, 0)
        self._q_reset()
        self._now = t0
        self._f_dev[:] = plan.devices
        self._f_km[:] = plan.k_m
        self._f_occ[:] = True
        started = plan.k_m > 0
        self._f_kind[:] = np.where(started, _HOP, _NONE).astype(np.int8)
        self._f_time[:] = np.where(started, t0, np.inf)
        events, host_loop_s = self._advance_window(deadline)
        k_done = self._f_kdone.copy()
        ts = self._f_ts.copy()
        killed = self._f_killed.copy()
        (self._f_dev, self._f_bidx, self._f_ts, self._f_km, self._f_kdone,
         self._f_wstart, self._f_killed, self._f_occ, self._f_kind,
         self._f_step, self._f_time,
         self._t_arr, self._t_up, self._t_send, self._now) = stash
        return k_done, ts, killed, events, host_loop_s

    # ------------------------------------------------------------- tracing
    def _trace_arrays(self) -> tuple:
        """The fleet's chain state already IS the arrays ``emit_walk_window``
        consumes — hand over views, no per-slot stacking."""
        return (self._chain_uid.copy(), self._f_dev,
                self._f_wstart.astype(np.int64),
                self._f_kdone.astype(np.int64),
                self._t_arr, self._t_up, self._f_ts, self._t_send)
