"""Recorded event traces of the virtual-time DFedRW simulator.

A trace is the complete, replayable decision record of one simulated run:
for every aggregation window it stores WHAT the event timeline decided —
which (chain, step) items executed, on which devices, against which batch
indices, which devices aggregated with which weights, and when everything
happened on the virtual clock. Replaying a trace feeds those recorded plans
straight into the flat engine (``AsyncDFedRW.replay``), skipping the
device/link/churn simulation entirely, and reproduces the recorded
``SimResult`` bit-exactly — the same property that makes the trace a
deployment-independent *schedule*.

The port's copy of ``repro.sim.trace``: the same schema name and versions,
so a trace recorded by either package loads and replays in the other. The
deployment export is here too: ``SimTrace.schedule`` (per-window
``WindowSchedule`` plans) and ``SimTrace.gossip_flags``, which drives the
scheduled federated step (``dist.make_fed_train_step(scheduled=True)``).
The schedule drives the live executor (``repro_torch.sim.metal``).

JSONL schema (version 2)
------------------------
Line 1 is the header object; every further line is one window:

    {"schema": "repro.sim.trace", "version": 2,
     "n": ..., "m_chains": ..., "k_walk": ..., "batch_size": ...,
     "bits": ..., "policy": ..., "deadline_s": ...,
     ...optional launcher context: "scenario", "key_seed", "rounds",
     "eval_every", "build_overrides"...}

    {"round": 1, "t_start": 0.0, "t_compute_end": 5.0, "t_end": 5.1,
     "agg_latency_s": 0.1, "events": 40, "host_loop_s": ...,
     "bits": 8,
     "k_planned": [M], "k_done": [M], "killed": [M], "resumed": [M],
     "devices": [M][K], "exec_mask": [M][K], "account_mask": [M][K],
     "timestamps": [M][K] (null = never executed),
     "bidx": [M][K][B],
     "agg_devices": [A], "agg_rows": [A][n_agg], "agg_weights": [A][n_agg]}

Version 2 adds the per-window ``"bits"`` field: the wire bit-width the
window executed at (the adaptive controller's choice, or the static config
width). The reader accepts v1 files unchanged — a v1 window has no ``bits``
key, loads with ``bits=None``, and replays at the header's static width, so
every v1 trace still replays bit-exactly (tests/test_sim_adapt.py).

Numbers round-trip exactly: ints are ints, float64 timestamps serialize via
repr (shortest round-trip), and the float32 aggregation weights pass through
float64 losslessly. ``NaN`` timestamps are stored as ``null`` so the files
stay strict JSON for non-Python consumers.

>>> import numpy as np
>>> w = WindowTrace(round=1, t_start=0.0, t_compute_end=2.0, t_end=2.5,
...                 agg_latency_s=0.5, events=4, host_loop_s=0.0,
...                 k_planned=np.array([2]), k_done=np.array([2]),
...                 killed=np.array([False]), resumed=np.array([False]),
...                 devices=np.array([[0, 1]]),
...                 exec_mask=np.array([[True, True]]),
...                 account_mask=np.array([[True, True]]),
...                 timestamps=np.array([[1.0, 2.0]]),
...                 bidx=np.array([[[0], [1]]]),
...                 agg_devices=np.array([0]), agg_rows=np.array([[1]]),
...                 agg_weights=np.array([[1.0]], dtype=np.float32))
>>> t = SimTrace(header=make_header(n=2, m_chains=1, k_walk=2, batch_size=1,
...                                 bits=32, policy="partial",
...                                 deadline_s=None), windows=[w])
>>> t2 = SimTrace.from_lines(t.to_lines())          # JSONL round trip
>>> t2.header["version"] == TRACE_SCHEMA_VERSION
True
>>> bool(np.all(t2.windows[0].bidx == w.bidx))
True
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Iterable

import numpy as np

__all__ = [
    "TRACE_SCHEMA",
    "TRACE_SCHEMA_VERSION",
    "TRACE_COMPAT_VERSIONS",
    "TraceError",
    "TraceFormatError",
    "TraceSchemaError",
    "TraceIntegrityError",
    "WindowTrace",
    "WindowSchedule",
    "SimTrace",
    "make_header",
]

TRACE_SCHEMA = "repro.sim.trace"
TRACE_SCHEMA_VERSION = 2
# Versions from_lines still reads; v1 windows load with bits=None and replay
# at the header's static width.
TRACE_COMPAT_VERSIONS = (1, 2)

# Header fields that pin the engine shapes a replay/deployment must match.
TRACE_SHAPE_KEYS = ("n", "m_chains", "k_walk", "batch_size", "bits")


class TraceError(ValueError):
    """Base of every typed trace-loading failure (subclasses ValueError so
    pre-existing ``except ValueError`` callers keep working)."""


class TraceFormatError(TraceError):
    """The bytes are not a well-formed trace: truncated/corrupt JSONL, a
    non-object line, or a window record with missing/mistyped fields."""


class TraceSchemaError(TraceError):
    """A well-formed file of the wrong kind: foreign schema name or a
    version outside ``TRACE_COMPAT_VERSIONS``."""


class TraceIntegrityError(TraceError):
    """Structurally valid JSONL whose windows contradict the header or each
    other (shuffled/duplicated rounds, shape mismatches, out-of-range device
    ids, masks that disagree) — replaying it would silently mis-execute."""


def make_header(*, n: int, m_chains: int, k_walk: int, batch_size: int,
                bits: int, policy: str, deadline_s: float | None,
                **context: Any) -> dict:
    """Header line of a trace (current schema version). The named fields pin
    the engine shapes a replay must match — ``bits`` is the engine's STATIC
    config width (per-window adaptive choices live on the windows);
    ``context`` carries optional launcher provenance (scenario name, key
    seed, rounds, eval cadence, build overrides)."""
    head = {
        "schema": TRACE_SCHEMA,
        "version": TRACE_SCHEMA_VERSION,
        "n": int(n),
        "m_chains": int(m_chains),
        "k_walk": int(k_walk),
        "batch_size": int(batch_size),
        "bits": int(bits),
        "policy": str(policy),
        "deadline_s": None if deadline_s is None else float(deadline_s),
    }
    head.update(context)
    return head


def _ts_out(ts: np.ndarray) -> list:
    """(M, K) float64 with NaN holes -> nested lists with nulls."""
    return [[None if math.isnan(v) else v for v in row] for row in ts.tolist()]


def _ts_in(rows: list) -> np.ndarray:
    return np.array([[math.nan if v is None else v for v in row]
                     for row in rows], dtype=np.float64)


@dataclasses.dataclass
class WindowTrace:
    """One aggregation window of a recorded run (see module schema)."""

    round: int
    t_start: float
    t_compute_end: float
    t_end: float
    agg_latency_s: float
    events: int
    host_loop_s: float
    k_planned: np.ndarray       # (M,) planned walk lengths (absolute)
    k_done: np.ndarray          # (M,) completed steps (absolute, lifetime)
    killed: np.ndarray          # (M,) bool churn kills
    resumed: np.ndarray         # (M,) bool chains continuing past the trigger
    devices: np.ndarray         # (M, K) window trajectory view
    exec_mask: np.ndarray       # (M, K) steps the engine executed
    account_mask: np.ndarray    # (M, K) steps Eq. 18 charged (drop policy pays
                                #        for work it discards)
    timestamps: np.ndarray      # (M, K) completion instants (NaN = never)
    bidx: np.ndarray            # (M, K, B) batch indices
    agg_devices: np.ndarray     # (A,)
    agg_rows: np.ndarray        # (A, n_agg)
    agg_weights: np.ndarray     # (A, n_agg) float32
    bits: int | None = None     # wire width this window executed at (v2;
                                #        None on v1 windows = header width)

    def to_json(self) -> dict:
        out = {} if self.bits is None else {"bits": int(self.bits)}
        out.update({
            "round": int(self.round),
            "t_start": float(self.t_start),
            "t_compute_end": float(self.t_compute_end),
            "t_end": float(self.t_end),
            "agg_latency_s": float(self.agg_latency_s),
            "events": int(self.events),
            "host_loop_s": float(self.host_loop_s),
            "k_planned": np.asarray(self.k_planned).tolist(),
            "k_done": np.asarray(self.k_done).tolist(),
            "killed": np.asarray(self.killed).tolist(),
            "resumed": np.asarray(self.resumed).tolist(),
            "devices": np.asarray(self.devices).tolist(),
            "exec_mask": np.asarray(self.exec_mask).tolist(),
            "account_mask": np.asarray(self.account_mask).tolist(),
            "timestamps": _ts_out(np.asarray(self.timestamps)),
            "bidx": np.asarray(self.bidx).tolist(),
            "agg_devices": np.asarray(self.agg_devices).tolist(),
            "agg_rows": np.asarray(self.agg_rows).tolist(),
            "agg_weights": np.asarray(self.agg_weights, dtype=np.float64).tolist(),
        })
        return out

    @classmethod
    def from_json(cls, obj: dict) -> "WindowTrace":
        bits = obj.get("bits")
        return cls(
            bits=None if bits is None else int(bits),
            round=int(obj["round"]),
            t_start=float(obj["t_start"]),
            t_compute_end=float(obj["t_compute_end"]),
            t_end=float(obj["t_end"]),
            agg_latency_s=float(obj["agg_latency_s"]),
            events=int(obj["events"]),
            host_loop_s=float(obj["host_loop_s"]),
            k_planned=np.asarray(obj["k_planned"], dtype=np.int32),
            k_done=np.asarray(obj["k_done"], dtype=np.int32),
            killed=np.asarray(obj["killed"], dtype=bool),
            resumed=np.asarray(obj["resumed"], dtype=bool),
            devices=np.asarray(obj["devices"], dtype=np.int32),
            exec_mask=np.asarray(obj["exec_mask"], dtype=bool),
            account_mask=np.asarray(obj["account_mask"], dtype=bool),
            timestamps=_ts_in(obj["timestamps"]),
            bidx=np.asarray(obj["bidx"], dtype=np.int64),
            agg_devices=np.asarray(obj["agg_devices"], dtype=np.int32),
            agg_rows=np.asarray(obj["agg_rows"], dtype=np.int32),
            agg_weights=np.asarray(obj["agg_weights"], dtype=np.float32),
        )


@dataclasses.dataclass(frozen=True)
class WindowSchedule:
    """One window of a trace compiled into a deployment-ready plan.

    ``SimTrace.schedule()`` exports these: the per-window arrays of the
    recorded :class:`WindowTrace` plus everything a live executor needs
    resolved up front — the effective wire width (v1 windows inherit the
    header's static width), the cumulative global step ``kbar0`` the lr
    schedule continues from, and the header shape constants. Shapes are
    fixed across windows ((M, K) trajectories, padded aggregation plans), so
    one compiled program executes the whole schedule. The live executor
    (``repro_torch.sim.metal``) consumes this; the fault-injection views
    (``stalled``, ``dead_aggregators``) re-derive the sim's churn/straggler timeline so a
    live run can reproduce — and verify — the same Eq. 11/14 degradation.
    """

    round: int
    n: int                      # fleet size (header)
    kbar0: int                  # global step count before this window (lr)
    bits: int                   # effective wire width this window runs at
    t_start: float
    t_compute_end: float
    t_end: float
    events: int
    devices: np.ndarray         # (M, K)
    exec_mask: np.ndarray       # (M, K) steps the engine executed
    account_mask: np.ndarray    # (M, K) steps Eq. 18 charges
    timestamps: np.ndarray      # (M, K) completion instants (NaN = never)
    bidx: np.ndarray            # (M, K, B)
    agg_devices: np.ndarray     # (A,)  ids >= n are dropped by the scatter
    agg_rows: np.ndarray        # (A, n_agg)
    agg_weights: np.ndarray     # (A, n_agg) float32
    k_planned: np.ndarray       # (M,)
    k_done: np.ndarray          # (M,) lifetime completed steps
    killed: np.ndarray          # (M,) churn kills
    resumed: np.ndarray         # (M,) chains spanning past the trigger

    @property
    def m_chains(self) -> int:
        return int(self.devices.shape[0])

    @property
    def k_exec(self) -> np.ndarray:
        """(M,) steps each chain actually executed this window."""
        return self.exec_mask.sum(axis=1).astype(np.int32)

    @property
    def stalled(self) -> np.ndarray:
        """(M,) bool — chains the recorded timeline cut short (churn-killed
        or deadline-truncated): the fault injector's stall set."""
        return np.asarray(self.killed) | (
            np.asarray(self.k_done) < np.asarray(self.k_planned))

    @property
    def dead_aggregators(self) -> np.ndarray:
        """Original device ids of aggregators that were churned out when the
        trigger fired. The runner redirects a down aggregator's scatter id
        out of range as ``n + M + id`` (see ``_drop_down_aggregators``); this
        inverts that encoding."""
        ids = np.asarray(self.agg_devices)
        oob = ids >= self.n + self.m_chains
        return (ids[oob] - self.n - self.m_chains).astype(np.int32)


@dataclasses.dataclass
class SimTrace:
    """Header + per-window records; JSONL on disk (one object per line)."""

    header: dict
    windows: list = dataclasses.field(default_factory=list)

    def to_lines(self) -> list[str]:
        return [json.dumps(self.header)] + [
            json.dumps(w.to_json()) for w in self.windows
        ]

    @classmethod
    def from_lines(cls, lines: Iterable[str],
                   validate: bool = True) -> "SimTrace":
        numbered = [(i, l) for i, l in enumerate(lines, start=1) if l.strip()]
        if not numbered:
            raise TraceFormatError("empty trace: no header line")
        lineno, head_line = numbered[0]
        try:
            header = json.loads(head_line)
        except json.JSONDecodeError as e:
            raise TraceFormatError(
                f"line {lineno}: header is not valid JSON ({e})") from e
        if not isinstance(header, dict):
            raise TraceFormatError(
                f"line {lineno}: header must be a JSON object, "
                f"got {type(header).__name__}")
        if header.get("schema") != TRACE_SCHEMA:
            raise TraceSchemaError(
                f"not a {TRACE_SCHEMA} file: {header.get('schema')!r}")
        if header.get("version") not in TRACE_COMPAT_VERSIONS:
            raise TraceSchemaError(
                f"trace version {header.get('version')} not in "
                f"supported {TRACE_COMPAT_VERSIONS}")
        windows = []
        for lineno, line in numbered[1:]:
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                raise TraceFormatError(
                    f"line {lineno}: truncated or corrupt window record "
                    f"({e})") from e
            if not isinstance(obj, dict):
                raise TraceFormatError(
                    f"line {lineno}: window record must be a JSON object, "
                    f"got {type(obj).__name__}")
            try:
                windows.append(WindowTrace.from_json(obj))
            except (KeyError, TypeError, ValueError) as e:
                raise TraceFormatError(
                    f"line {lineno}: bad window record "
                    f"({type(e).__name__}: {e})") from e
        trace = cls(header=header, windows=windows)
        if validate:
            trace.validate()
        return trace

    def validate(self) -> "SimTrace":
        """Cross-check every window against the header and its neighbors;
        raises :class:`TraceIntegrityError` (or :class:`TraceFormatError`
        for missing header fields) instead of letting a corrupted trace
        silently mis-replay. Returns self so loads can chain."""
        h = self.header
        missing = [k for k in TRACE_SHAPE_KEYS if not isinstance(
            h.get(k), int)]
        if missing:
            raise TraceFormatError(
                f"trace header lacks integer shape field(s) {missing}; "
                f"cannot validate or replay")
        n, m, k, b = h["n"], h["m_chains"], h["k_walk"], h["batch_size"]

        def bad(i: int, w: WindowTrace, msg: str) -> TraceIntegrityError:
            return TraceIntegrityError(
                f"window {i} (round={w.round}): {msg}")

        prev_round = None
        for i, w in enumerate(self.windows):
            if prev_round is not None and w.round != prev_round + 1:
                raise bad(i, w, f"round ids not sequential (previous was "
                                f"{prev_round}; duplicated, shuffled or "
                                f"dropped windows?)")
            prev_round = w.round
            if w.devices.shape != (m, k):
                raise bad(i, w, f"devices shape {w.devices.shape} != header "
                                f"(m_chains, k_walk) = {(m, k)}")
            for name in ("exec_mask", "account_mask", "timestamps"):
                arr = getattr(w, name)
                if arr.shape != (m, k):
                    raise bad(i, w, f"{name} shape {arr.shape} != {(m, k)}")
            if w.bidx.shape != (m, k, b):
                raise bad(i, w, f"bidx shape {w.bidx.shape} != "
                                f"(m_chains, k_walk, batch_size) = {(m, k, b)}")
            for name in ("k_planned", "k_done", "killed", "resumed"):
                arr = getattr(w, name)
                if arr.shape != (m,):
                    raise bad(i, w, f"{name} shape {arr.shape} != ({m},)")
            if w.devices.min(initial=0) < 0 or w.devices.max(initial=0) >= n:
                raise bad(i, w, f"device id out of range [0, {n})")
            if (w.exec_mask & ~w.account_mask).any():
                raise bad(i, w, "exec_mask marks steps outside account_mask "
                                "(executed work that was never planned)")
            if w.bidx.min(initial=0) < 0:
                raise bad(i, w, "negative batch index")
            a = w.agg_devices.shape[0]
            if w.agg_rows.ndim != 2 or w.agg_rows.shape[0] != a \
                    or w.agg_weights.shape != w.agg_rows.shape:
                raise bad(i, w, f"aggregation plan shapes disagree: "
                                f"agg_devices ({a},), agg_rows "
                                f"{w.agg_rows.shape}, agg_weights "
                                f"{w.agg_weights.shape}")
            if w.agg_devices.min(initial=0) < 0 or \
                    w.agg_rows.min(initial=0) < 0:
                raise bad(i, w, "negative aggregation ids")
            if not np.isfinite(w.agg_weights).all() or \
                    (w.agg_weights < 0).any():
                raise bad(i, w, "aggregation weights must be finite and "
                                "non-negative")
            if not (w.t_start <= w.t_compute_end <= w.t_end) or \
                    not math.isfinite(w.t_end):
                raise bad(i, w, f"window times not ordered: t_start="
                                f"{w.t_start} t_compute_end={w.t_compute_end} "
                                f"t_end={w.t_end}")
            if w.bits is not None and not (1 <= int(w.bits) <= 32):
                raise bad(i, w, f"window bits {w.bits} outside [1, 32]")
        return self

    def schedule(self) -> list["WindowSchedule"]:
        """Compile the trace into per-window fixed-shape deployment plans
        (validates first — a corrupted trace raises instead of exporting).
        This is the contract between the simulator and the live executor
        (``repro_torch.sim.metal`` and ``launch/replay.py``)."""
        self.validate()
        h, k_walk = self.header, self.header["k_walk"]
        out, kbar0 = [], 0
        for w in self.windows:
            out.append(WindowSchedule(
                round=w.round, n=h["n"], kbar0=kbar0,
                bits=h["bits"] if w.bits is None else int(w.bits),
                t_start=w.t_start, t_compute_end=w.t_compute_end,
                t_end=w.t_end, events=w.events, devices=w.devices,
                exec_mask=w.exec_mask, account_mask=w.account_mask,
                timestamps=w.timestamps, bidx=w.bidx,
                agg_devices=w.agg_devices, agg_rows=w.agg_rows,
                agg_weights=w.agg_weights, k_planned=w.k_planned,
                k_done=w.k_done, killed=w.killed, resumed=w.resumed))
            kbar0 += k_walk   # execute_round advances global_step by k_walk
        return out

    def gossip_flags(self) -> np.ndarray:
        """(windows * k_walk,) bool — True at each window's final local
        step, i.e. the steps where the recorded timeline fired an
        aggregation trigger. This is the bridge onto the pod deployment:
        feed it to a schedule-driven ``make_fed_train_step`` (dist/steps.py,
        ``scheduled=True``) so the pods gossip exactly when the simulated
        fleet aggregated."""
        self.validate()
        k = self.header["k_walk"]
        flags = np.zeros(len(self.windows) * k, dtype=bool)
        if k:
            flags[k - 1::k] = True
        return flags

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("\n".join(self.to_lines()) + "\n")

    @classmethod
    def load(cls, path: str, validate: bool = True) -> "SimTrace":
        with open(path) as f:
            return cls.from_lines(f, validate=validate)
