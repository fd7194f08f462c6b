"""Trace-driven metal execution: replay a recorded ``SimTrace`` on devices.

The port of ``repro.sim.metal``. ``repro_torch.sim`` proves its claims on a
virtual clock; this module runs the *same* recorded schedule on live
devices and holds the result to the simulator's trajectory:

  * ``SimTrace.schedule()`` compiles the trace into per-window
    :class:`~repro_torch.sim.trace.WindowSchedule` plans (fixed shapes,
    resolved bit-widths, cumulative lr step counts).
  * :class:`MetalReplay` drives each window through real devices: this
    shard's slice of the M chains walks on the process's local *positions*
    (the reference's ``shard_map`` over a ``"chains"`` mesh axis;
    ``launch/replay.py`` adds localhost processes on top through an
    :class:`Exchange`), then a replicated finalize applies the engine's
    winner-election scatter and Eq. 11/14 aggregation. The walk and the
    finalize are the flat engine's own two halves (``DFedRW._walk`` and
    ``DFedRW._finalize``), so at one position metal runs the simulator's
    code on the simulator's rows.
  * :class:`FaultInjector` re-derives the executed-step masks and dead
    aggregators from the trace's raw fault timeline (completion timestamps,
    churn kills, straggler deficits) instead of trusting the recorded
    masks, and so verifies that a live deployment under the same stalls and
    drops reaches the same partial aggregation the sim computed.

A position is an entry of ``devices``, each the engine's own device listed
once more (``[cpu, cpu]``, ``[cuda:0, cuda:0]``): every entry walks its own
contiguous block of the slice, one after the other. That is how one card,
or the CPU, runs a sharded walk (the reference gets the same from XLA's
virtual host devices).

Quantizer seed words. Each window takes (K+1, 2) uint32 words, as the
port's simulator does: K hop rows, then one aggregation row. At one
position the walk uses the hop rows unchanged, and metal is the simulator
bit for bit at every width. With several positions each position derives
its own hop words from the window's (:func:`position_seeds`), the port's
counterpart of the reference's ``fold_in(qkey, axis_index)``. The position
index is local to the process, as in the reference, whose processes each
see an unsharded local mesh: two processes' first positions share words,
and their rows differ. The aggregation row is used as it is: the finalize
is replicated.

Conformance. At fp32 each chain's walk reads only its own row, so the
chain slicing changes no arithmetic, except where the batched per-chain
gradient (``vmap(grad)``: batched GEMMs whose batch is the slice's chain
count) takes another algorithm for another batch; ``tests/test_torch_metal.py``
and ``chip_smoke.py`` hold metal at one and two positions and processes to
the simulator. At bits < 32 and several positions the hop words differ from
the simulator's, so metal is held to quantization tolerance: the
simulator's own spread under other seed words bounds the deviation.

Why not one collective program across processes: a DFedRW fleet exchanges
*messages*. The :class:`Exchange` seam models exactly that (per-process
compute + an explicit trajectory exchange); the trajectories travel as
numpy arrays, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from repro_torch.core.dfedrw import DFedRW, DFedRWState, RoundMetrics
from repro_torch.core.metrics import History
from repro_torch.core.walk import WalkPlan
from repro_torch.device import resolve_device
from repro_torch.sim.trace import (
    TRACE_SHAPE_KEYS,
    SimTrace,
    TraceIntegrityError,
    WindowSchedule,
)

__all__ = [
    "Exchange",
    "LocalExchange",
    "FaultInjector",
    "MetalConformanceError",
    "MetalReplay",
    "MetalResult",
    "CHAIN_SLICE_TOL",
    "conformance_diff",
    "position_seeds",
    "positions_for",
    "smallest_block",
]

_MASK64 = (1 << 64) - 1

# fp32 bound of a metal run against the simulator when a position walks a
# block of one chain: its per-chain gradient is then a lone matrix product,
# which a CPU with several threads runs through MKL's threaded gemm (the
# inner dimension split over the threads) where a batch of two or more runs
# one sequential gemm a matrix. Blocks of two or more chains agree bit for
# bit. The bound is the port's fp32 contract with the JAX package; measured
# on the CPU at n = 12: max|d| 8.9e-8, 2.1e-7 of the matrix's largest
# magnitude (tests/test_torch_metal.py).
CHAIN_SLICE_TOL = dict(rtol=1e-5, atol=1e-6)


class MetalConformanceError(RuntimeError):
    """The live execution diverged from the recorded schedule: a re-derived
    fault mask disagrees with the sim's, shards disagree with each other,
    or two trajectories that must match do not."""


# --------------------------------------------------------------------- comms
class Exchange:
    """Trajectory transport between the processes of a deployment.

    One deployment = ``n_shards`` processes, each computing a contiguous
    slice of the M chains; after the walk phase every process contributes
    its slice and receives everyone's (all-gather), then runs the identical
    replicated finalize. ``launch/replay.py`` provides the TCP socket
    implementation; tests and single-process runs use
    :class:`LocalExchange`.
    """

    n_shards: int = 1
    shard_id: int = 0

    def allgather(self, payload: Any) -> list:
        """Contribute this shard's payload; return all shards' payloads
        ordered by shard id (ours included)."""
        raise NotImplementedError

    def close(self) -> None:  # pragma: no cover - transport-specific
        pass


class LocalExchange(Exchange):
    """Single-process deployment: the all-gather is the identity."""

    n_shards = 1
    shard_id = 0

    def allgather(self, payload: Any) -> list:
        return [payload]


# ------------------------------------------------------------ fault injector
@dataclasses.dataclass
class FaultInjector:
    """Re-derive the sim's churn/straggler degradation from raw fault
    signals and (optionally) act it out in real time.

    The recorded ``exec_mask`` is the sim's *conclusion*; the injector
    recomputes it from the fault *evidence* the trace also carries — which
    steps have finite completion timestamps, which chains the churn model
    killed, which fell short of their planned length — and raises
    :class:`MetalConformanceError` if the live derivation disagrees with
    the recording. That closes the Eq. 11/14 loop: the metal side proves it
    reaches the same partial aggregation from the same faults, rather than
    replaying an answer.

    ``policy`` mirrors ``SimConfig.policy``: ``"partial"``/``"overlap"``
    aggregate whatever executed; ``"drop"`` discards any chain that did not
    finish its planned walk. ``stall_scale`` > 0 additionally sleeps
    ``stall_scale`` wall-seconds per missing step, turning the recorded
    straggler deficit into an actual process stall (off by default so test
    suites stay fast)."""

    policy: str = "partial"
    stall_scale: float = 0.0
    verify: bool = True
    stalls_injected: int = 0
    steps_stalled: int = 0
    aggregators_dropped: int = 0

    def derive_exec_mask(self, w: WindowSchedule) -> np.ndarray:
        """(M, K) bool — the steps a live fleet under the recorded fault
        timeline would aggregate: planned steps whose completion instant
        exists, minus (under ``drop``) every stalled chain entirely."""
        derived = np.asarray(w.account_mask) & np.isfinite(
            np.asarray(w.timestamps))
        if self.policy == "drop":
            derived = derived & ~np.asarray(w.stalled)[:, None]
        return derived

    def inject(self, w: WindowSchedule) -> np.ndarray:
        """Derive, verify against the recording, act out the stalls; returns
        the exec mask the window must run with."""
        derived = self.derive_exec_mask(w)
        if self.verify:
            recorded = np.asarray(w.exec_mask)
            if not np.array_equal(derived, recorded):
                bad = np.nonzero((derived != recorded).any(axis=1))[0]
                raise MetalConformanceError(
                    f"window round={w.round}: fault-derived exec mask "
                    f"disagrees with the recorded one on chain(s) "
                    f"{bad.tolist()} (policy={self.policy!r}) — the live "
                    f"degradation does not reproduce the sim's Eq. 11/14 "
                    f"partial aggregation")
        stalled = np.asarray(w.stalled)
        deficit = int(np.maximum(
            np.asarray(w.k_planned) - np.asarray(w.k_done), 0).sum())
        self.stalls_injected += int(stalled.sum())
        self.steps_stalled += deficit
        self.aggregators_dropped += int(w.dead_aggregators.size)
        if self.stall_scale > 0.0 and deficit:
            time.sleep(self.stall_scale * deficit)
        return derived


# ---------------------------------------------------------------- the result
@dataclasses.dataclass
class MetalResult:
    """What a metal replay produced (mirrors ``SimResult`` where the two
    overlap, so conformance checks compare like with like)."""

    history: History
    records: list
    state: DFedRWState
    virtual_time_s: float = 0.0
    windows: int = 0
    n_shards: int = 1
    fault: FaultInjector | None = None

    @property
    def device_matrix(self) -> np.ndarray:
        return self.state.device_params.detach().cpu().numpy()


def _as_float64(x: Any) -> np.ndarray:
    x = getattr(x, "state", x)
    x = getattr(x, "device_params", x)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def conformance_diff(a: Any, b: Any) -> float:
    """Max abs elementwise difference between two device matrices (accepts
    ``DFedRWState``/``MetalResult``/``SimResult``-likes, tensors or arrays).
    0.0 means bit-exact at fp32."""
    pa, pb = _as_float64(a), _as_float64(b)
    if pa.shape != pb.shape:
        raise MetalConformanceError(
            f"device matrices disagree in shape: {pa.shape} vs {pb.shape}")
    return float(np.max(np.abs(pa - pb))) if pa.size else 0.0


def _mix64(x: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit words."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _MASK64
    return x ^ (x >> 31)


def position_seeds(words, position: int) -> list[tuple[int, int]]:
    """The hop seed words of local position ``position``: each (w0, w1) pair
    of ``words`` mixed with the position into a new pair (splitmix64 of the
    64-bit word offset by the golden-ratio increment a position), so every
    position draws its own stochastic-rounding stream."""
    out = []
    for w0, w1 in np.asarray(words, dtype=np.int64).tolist():
        word = ((int(w0) & 0xFFFFFFFF) << 32) | (int(w1) & 0xFFFFFFFF)
        word = _mix64((word + (position + 1) * 0x9E3779B97F4A7C15) & _MASK64)
        out.append((word >> 32, word & 0xFFFFFFFF))
    return out


def positions_for(m_local: int, n_positions: int) -> int:
    """How many of ``n_positions`` walk a slice of ``m_local`` chains: the
    largest divisor of ``m_local`` that is at most ``n_positions``."""
    axis = 1
    for a in range(1, min(n_positions, max(m_local, 1)) + 1):
        if m_local % a == 0:
            axis = a
    return axis


def smallest_block(m: int, n_shards: int, n_positions: int) -> int:
    """The fewest chains one position walks when ``n_shards`` processes of
    ``n_positions`` positions each share ``m`` chains. A block of one chain
    is the one case where the walk's arithmetic may differ from the
    simulator's at fp32 (see :data:`CHAIN_SLICE_TOL`)."""
    sizes = [len(part) // positions_for(len(part), n_positions)
             for part in np.array_split(np.arange(m), n_shards) if len(part)]
    return min(sizes)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------- the runner
class MetalReplay:
    """Execute a recorded schedule on live devices.

    Wraps a :class:`~repro_torch.core.dfedrw.DFedRW` engine (flat only) for
    its spec, data binding, walk and finalize, Eq. 18 pricing and
    evaluation — but never calls its round: the walk runs on this shard's
    chain slice, split across the local positions, and the finalize
    (winner election + scatter + aggregation) runs replicated over the
    gathered trajectory, so every shard computes the same new device
    matrix.

    ``exchange`` splits the M chains across processes
    (``launch/replay.py``); the default :class:`LocalExchange` runs all
    chains here and keeps the trajectory on the device. ``devices`` lists
    the local positions, each the engine's device (default: one position);
    a window uses the largest divisor of its slice's chain count that is at
    most ``len(devices)`` of them, so no padding is ever needed.

    ``timings`` collects, a window of :meth:`run`, the host milliseconds of
    ``run_window`` and of its trajectory exchange (device-to-host copy,
    transport, host-to-device copy), both synchronized, and the bytes this
    shard contributed to the exchange (0 without one).
    """

    def __init__(
        self,
        engine: DFedRW,
        *,
        exchange: Exchange | None = None,
        devices: list | None = None,
    ):
        if not isinstance(engine, DFedRW) or engine.cfg.engine != "flat":
            raise ValueError("MetalReplay drives the flat DFedRW engine only")
        positions = [resolve_device(d) for d in devices] if devices else [engine.device]
        if any(d != engine.device for d in positions):
            raise ValueError(f"every position must be the engine's device {engine.device}, "
                             f"got {positions}")
        self.engine = engine
        self.exchange = exchange if exchange is not None else LocalExchange()
        self._n_positions = len(positions)
        self.t = 0.0                      # virtual clock (schedule time)
        self.obs = None
        self.positions_used = 0
        self.timings: list[dict] = []
        self._window_timing: dict = {}

    # ----------------------------------------------------------- telemetry
    def attach_obs(self, rec) -> None:
        """Attach a ``repro_torch.obs.Recorder``; an unbound ``VirtualClock``
        binds to the *schedule's* virtual time, so the metal stream is
        priced on the same clock as the sim stream it is diffed against
        (tools/obs_diff.py is the sim-vs-metal gate)."""
        from repro_torch.obs import VirtualClock
        self.obs = rec
        if isinstance(rec.clock, VirtualClock) and not rec.clock.bound:
            rec.clock.bind(lambda: self.t)

    # ----------------------------------------------------------------- walk
    def _walk_slice(self, device_flat, w: WindowSchedule, exec_mask: np.ndarray,
                    rows: np.ndarray, words) -> tuple[torch.Tensor, torch.Tensor]:
        """This shard's walk: its chain rows split into contiguous blocks,
        one a local position, each walked by the engine's ``_walk`` from
        chain starts gathered on the device. Returns the slice's (K, m,
        d_pad) trajectory and (K, m) squared gradient norms."""
        engine = self.engine
        dev = engine.device
        n_pos = positions_for(int(rows.size), self._n_positions)   # the reference's _local_mesh
        self.positions_used = max(self.positions_used, n_pos)
        chain0 = device_flat[torch.from_numpy(w.devices[rows, 0].astype(np.int64)).to(dev)]
        trajs, gsqs = [], []
        for p, block in enumerate(np.array_split(np.arange(rows.size), n_pos)):
            sel = rows[block]
            mask = torch.from_numpy(np.ascontiguousarray(exec_mask[sel])).to(dev)
            bidx_t = torch.from_numpy(
                np.ascontiguousarray(w.bidx[sel].swapaxes(0, 1))).to(dev)
            hop = None
            if w.bits < 32:
                hop = words[:-1] if n_pos == 1 else position_seeds(words[:-1], p)
            traj, gsq = engine._walk(chain0[block[0]:block[-1] + 1], mask, engine._x[bidx_t],
                                     engine._y[bidx_t], w.kbar0, w.bits, hop)
            trajs.append(traj)
            gsqs.append(gsq)
        if n_pos == 1:
            return trajs[0], gsqs[0]
        return torch.cat(trajs, dim=1), torch.cat(gsqs, dim=1)

    # ----------------------------------------------------------- execution
    def _check_trace(self, trace: SimTrace) -> None:
        h, cfg = trace.header, self.engine.cfg
        expect = dict(n=self.engine.topo.n, m_chains=cfg.m_chains,
                      k_walk=cfg.k_walk, batch_size=cfg.batch_size,
                      bits=cfg.quant.bits)
        mismatched = {k: (h.get(k), v) for k, v in expect.items()
                      if h.get(k) != v}
        if mismatched:
            detail = "; ".join(f"{k}: trace={hv} engine={ev}"
                               for k, (hv, ev) in mismatched.items())
            raise TraceIntegrityError(
                f"trace header does not match this engine ({detail}); "
                f"metal replay needs the recording configuration "
                f"(header keys {TRACE_SHAPE_KEYS})")

    def _shard_slice(self, m: int) -> np.ndarray:
        return np.array_split(np.arange(m), self.exchange.n_shards)[
            self.exchange.shard_id]

    def _gather(self, traj_loc, gsq_loc):
        """The trajectory exchange: numpy payloads through ``exchange``,
        concatenated in shard order and put back on the engine's device."""
        dev = self.engine.device
        _sync(dev)
        t0 = time.perf_counter()
        payload = (traj_loc.cpu().numpy(), gsq_loc.cpu().numpy())
        parts = self.exchange.allgather(payload)
        traj = torch.from_numpy(np.concatenate([p[0] for p in parts], axis=1)).to(dev)
        grad_sq = torch.from_numpy(np.concatenate([p[1] for p in parts], axis=1)).to(dev)
        _sync(dev)
        self._window_timing.update(
            exchange_ms=(time.perf_counter() - t0) * 1e3,
            exchange_bytes=int(payload[0].nbytes + payload[1].nbytes))
        return traj, grad_sq

    def run_window(
        self, state: DFedRWState, w: WindowSchedule, qseeds=None,
        fault: FaultInjector | None = None,
    ) -> tuple[DFedRWState, RoundMetrics]:
        """One window: shard-local walk, trajectory exchange, replicated
        finalize, Eq. 18 pricing — the metal twin of
        ``DFedRW.execute_round`` driving the recorded plans. ``qseeds`` is
        the window's (K+1, 2) seed words (needed at bits < 32)."""
        engine, cfg = self.engine, self.engine.cfg
        m, k = w.devices.shape
        exec_mask = np.asarray(w.exec_mask if fault is None else fault.inject(w))
        words = None
        if w.bits < 32:
            if qseeds is None:
                raise ValueError("a quantized window needs its (K+1, 2) seed words")
            words = [(int(a), int(b)) for a, b in np.asarray(qseeds).tolist()]
            if len(words) != k + 1:
                raise ValueError(f"qseeds needs {k + 1} rows, got {len(words)}")

        rows = self._shard_slice(m)
        dev = engine.device
        self._window_timing = dict(exchange_ms=0.0, exchange_bytes=0)
        if rows.size:
            traj_loc, gsq_loc = self._walk_slice(state.device_params, w, exec_mask, rows,
                                                 words)
        else:                              # more processes than chains
            traj_loc = torch.zeros((k, 0, engine.flat_spec.d_pad), device=dev)
            gsq_loc = torch.zeros((k, 0), device=dev)
        if self.exchange.n_shards == 1:
            traj, grad_sq = traj_loc, gsq_loc
        else:
            traj, grad_sq = self._gather(traj_loc, gsq_loc)
        if traj.shape[1] != m:
            raise MetalConformanceError(
                f"exchange returned {traj.shape[1]} chains, schedule has {m}")

        agg = (w.agg_devices, w.agg_rows, w.agg_weights)
        last = torch.from_numpy(np.ascontiguousarray(w.bidx[:, -1])).to(dev)
        new_params, loss, gamma_hat = engine._finalize(
            state.device_params, traj, grad_sq, w.devices, exec_mask, agg,
            (engine._x[last], engine._y[last]), w.bits, None if words is None else words[-1])

        account_plan = WalkPlan(
            devices=w.devices, mask=w.account_mask,
            k_m=w.account_mask.sum(axis=1).astype(np.int32),
            timestamps=w.timestamps)
        tot, busiest = engine._comm_cost_bits(
            account_plan, agg, engine.flat_spec.d, bits=w.bits)
        updated = (state.updated.copy() if state.updated is not None
                   else np.zeros(engine.topo.n, dtype=bool))
        updated[np.unique(w.devices[exec_mask])] = True
        updated[w.agg_devices[w.agg_devices < engine.topo.n]] = True
        new_state = DFedRWState(
            device_params=new_params,
            round=state.round + 1,
            global_step=state.global_step + cfg.k_walk,
            chain_starts=None,
            comm_bits_total=state.comm_bits_total + tot,
            comm_bits_busiest=state.comm_bits_busiest + busiest,
            updated=updated,
        )
        metrics = RoundMetrics(
            round=new_state.round, train_loss=float(loss),
            comm_bits_round=tot, comm_bits_busiest_round=busiest,
            gamma_hat=float(gamma_hat))
        return new_state, metrics

    def _obs_window(self, w: WindowSchedule, exec_mask: np.ndarray,
                    metrics: RoundMetrics) -> None:
        """Metal-side telemetry, series-for-series the sim's emission
        (``DFedRW.execute_round`` + ``AsyncDFedRW._obs_window``) priced on
        the schedule's virtual clock — so ``tools/obs_diff.py`` between a
        sim stream and a metal stream of the same trace is clean. Uplink
        contention series are sim-only (the metal side has no modeled
        uplink) and surface as diff *notes*, never failures."""
        from repro_torch.sim.runner import SimRoundRecord

        obs = self.obs
        obs.record_span("engine/execute_round", w.t_end, w.t_end)
        obs.counter("engine/rounds")
        obs.counter("engine/programs", 1, bits=w.bits)
        obs.counter("engine/comm_bits", metrics.comm_bits_round, bits=w.bits)
        obs.counter("engine/comm_bits_busiest",
                    metrics.comm_bits_busiest_round)
        obs.counter("engine/steps_executed", int(exec_mask.sum()))
        obs.flush()
        record = SimRoundRecord(
            round=w.round, t_start=w.t_start,
            t_compute_end=w.t_compute_end, t_end=w.t_end, events=w.events,
            host_loop_s=0.0, k_planned=w.k_planned, k_done=w.k_done,
            k_exec=exec_mask.sum(axis=1).astype(np.int32), killed=w.killed,
            agg_latency_s=w.t_end - w.t_compute_end, resumed=w.resumed,
            bits=w.bits)
        obs.record_span("sim/window", record.t_start, record.t_end)
        obs.record_span("sim/walk", record.t_start, record.t_compute_end)
        obs.record_span("sim/aggregate", record.t_compute_end, record.t_end)
        obs.counter("sim/windows")
        obs.counter("sim/events", record.events)
        obs.counter("sim/chains_resumed", record.resumed_chains)
        obs.counter("sim/chains_truncated", record.truncated_chains)
        obs.counter("sim/chains_dropped", record.dropped_chains)
        obs.counter("sim/chains_killed", int(record.killed.sum()))
        obs.histogram("sim/window_steps", record.k_exec)
        obs.gauge("sim/bits", float(w.bits))
        obs.gauge("sim/queue_pressure", 0.0)
        obs.flush(t=record.t_end)

    def run(
        self,
        trace: SimTrace | Iterable[WindowSchedule],
        key: torch.Generator,
        x_test: np.ndarray | None = None,
        y_test: np.ndarray | None = None,
        eval_every: int = 1,
        fault: FaultInjector | None = None,
        callback: Callable | None = None,
        qseeds=None,
        params=None,
    ) -> MetalResult:
        """Execute the whole schedule. The generator ``key`` is used as
        ``AsyncDFedRW.replay`` uses it: it draws the initial weights (unless
        ``params``, a model tree, is given) and then each quantized window's
        (K+1, 2) seed words (unless ``qseeds[r]`` gives window r's), so at
        one position the resulting ``state`` is bit-identical to the sim's.
        ``callback(r, metrics, evald, w)`` runs after each evaluation."""
        if isinstance(trace, SimTrace):
            self._check_trace(trace)
            sched = trace.schedule()
        else:
            sched = list(trace)
        engine = self.engine
        self.t = 0.0
        self.timings = []
        state = (engine.init_state(key) if params is None
                 else engine.state_from_params(params))
        hist = History()
        records: list[RoundMetrics] = []
        for r, w in enumerate(sched):
            if w.n != engine.topo.n:
                raise TraceIntegrityError(
                    f"window round={w.round}: schedule n={w.n} does not "
                    f"match engine n={engine.topo.n}")
            words = None if qseeds is None else qseeds[r]
            if words is None and w.bits < 32:
                words = torch.randint(0, 1 << 32, (engine.cfg.k_walk + 1, 2),
                                      generator=key, dtype=torch.int64)
            exec_mask = np.asarray(
                w.exec_mask if fault is None else fault.derive_exec_mask(w))
            t0 = time.perf_counter()
            state, metrics = self.run_window(state, w, words, fault=fault)
            _sync(engine.device)
            self.timings.append(dict(window_ms=(time.perf_counter() - t0) * 1e3,
                                     **self._window_timing))
            self.t = w.t_end
            records.append(metrics)
            if self.obs is not None:
                self._obs_window(w, exec_mask, metrics)
            if x_test is not None and ((r + 1) % eval_every == 0
                                       or r == len(sched) - 1):
                evald = engine.evaluate(state, x_test, y_test)
                hist.record(metrics, evald, state)
                if callback is not None:
                    callback(r, metrics, evald, w)
        return MetalResult(
            history=hist, records=records, state=state,
            virtual_time_s=self.t, windows=len(sched),
            n_shards=self.exchange.n_shards, fault=fault)
