"""Recorder core: counters, gauges, histograms and spans over a pluggable clock.

The port's copy of ``repro.obs.recorder``: one abstraction for every
engine. A ``Recorder`` aggregates
host-side measurements and appends a JSONL-able event list; *which* notion of
time prices the measurements is the clock's business:

* ``WallClock`` — plain ``time.perf_counter()`` (train loops, tools).
* ``PausableWallClock`` — wall time minus credited pauses; the active-time
  arithmetic that ``serve.EngineMetrics`` has always used (``note_pause``
  credits a deliberate sleep, e.g. a benchmark waiting out a CPU quota).
* ``VirtualClock`` — an adapter bound to the simulator's event-loop time, so
  sim spans (``sim/window``, ``sim/uplink_busy``) are priced in *virtual*
  seconds and the recorded stream is a pure function of the scenario + seed.

Everything here is **off the hot path by construction**: recording is plain
host Python, never a callback inside a device computation, and instrumented call
sites flush at window/step boundaries. A recorder never touches RNG state, so
instrumented runs are bit-exact with uninstrumented ones.

Counters are monotone; ``flush()`` emits the *delta* since the previous flush
so the event stream doubles as a time series. Histograms keep exact aggregate
moments (count/sum/min/max) plus a deterministic bounded sample reservoir
(strided thinning with stride doubling, so the kept ``< HIST_RESERVOIR``
samples cover the whole run) for percentile reporting.

``trace_span`` records *causal* spans — nodes of the per-chain / per-request
span trees built by ``repro_torch.obs.trace`` — carrying a trace id, a span id and
an optional parent id on top of the ``[t0, t1]`` interval.
"""
from __future__ import annotations

import contextlib
import operator
import time
import warnings
from typing import Any, Callable, Iterator

__all__ = [
    "WallClock",
    "PausableWallClock",
    "VirtualClock",
    "Recorder",
    "torch_profile",
    "HIST_RESERVOIR",
    "quantile_line",
]

HIST_RESERVOIR = 4096


class WallClock:
    """``time.perf_counter()`` — host wall time."""

    kind = "wall"

    def now(self) -> float:
        return time.perf_counter()


class PausableWallClock(WallClock):
    """Wall time minus credited pauses (serve's active-time semantics)."""

    kind = "wall-active"

    def __init__(self) -> None:
        self._pause_total = 0.0

    def now(self) -> float:
        return time.perf_counter() - self._pause_total

    def note_pause(self, dt: float) -> None:
        """Credit a deliberate pause (e.g. a benchmark sleeping off a CPU
        quota) so durations reflect active time only."""
        self._pause_total += dt


class VirtualClock:
    """Adapter over an external notion of time (the sim's event loop).

    Unbound it reads 0.0; ``bind(fn)`` points it at a time source, e.g.
    ``clock.bind(lambda: runner.t)`` (``AsyncDFedRW.attach_obs`` does this).
    """

    kind = "virtual"

    def __init__(self, fn: Callable[[], float] | None = None) -> None:
        self._fn = fn

    @property
    def bound(self) -> bool:
        return self._fn is not None

    def bind(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    def now(self) -> float:
        return 0.0 if self._fn is None else float(self._fn())


def _key(name: str, labels: dict[str, Any]) -> str:
    """Stable series key: ``name`` or ``name{k="v",...}`` with sorted labels."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


def _attr_value(v: Any):
    """Normalize a trace-span attribute to a JSON scalar (int, float or str),
    so event lines never depend on host-side numpy scalar reprs."""
    if isinstance(v, str):
        return v
    if isinstance(v, bool):
        return int(v)
    try:
        return operator.index(v)       # int and numpy integer types
    except TypeError:
        return float(v)


def quantile_line(base: str, q: str) -> str:
    """Splice ``quantile="q"`` into a Prometheus metric that may already carry
    a label set: ``m`` -> ``m{quantile="q"}``, ``m{a="b"}`` ->
    ``m{a="b",quantile="q"}``."""
    if base.endswith("}"):
        return f'{base[:-1]},quantile="{q}"}}'
    return f'{base}{{quantile="{q}"}}'


class _Hist:
    __slots__ = ("count", "total", "vmin", "vmax", "samples", "stride")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.samples: list[float] = []
        # Deterministic strided thinning: the reservoir holds exactly the
        # observations whose global index is ≡ 0 (mod stride); when it fills,
        # every other kept sample is dropped and the stride doubles. No RNG,
        # and percentiles cover the whole run instead of just its start.
        self.stride = 1

    def observe_many(self, values) -> None:
        vals = [float(v) for v in values]
        if not vals:
            return
        n_before = self.count
        self.count += len(vals)
        self.total += sum(vals)
        self.vmin = min(self.vmin, min(vals))
        self.vmax = max(self.vmax, max(vals))
        first = (-n_before) % self.stride
        self.samples.extend(vals[first::self.stride])
        while len(self.samples) >= HIST_RESERVOIR:
            self.samples = self.samples[::2]
            self.stride *= 2

    def summary(self) -> dict:
        if not self.count:
            return {"count": 0}
        s = sorted(self.samples)

        def q(p: float) -> float:
            return s[min(int(p * (len(s) - 1) + 0.5), len(s) - 1)]

        return {"count": self.count, "sum": self.total,
                "mean": self.total / self.count,
                "min": self.vmin, "max": self.vmax,
                "p50": q(0.50), "p90": q(0.90), "p99": q(0.99)}


class Recorder:
    """Host-side telemetry aggregator + event stream builder.

    >>> rec = Recorder(clock=VirtualClock(lambda: 3.0))
    >>> rec.counter("engine/rounds")
    >>> rec.counter("engine/comm_bits", 640, bits=8)
    >>> rec.gauge("sim/bits", 8.0)
    >>> rec.flush()
    >>> rec.value("engine/comm_bits", bits=8)
    640.0
    >>> rec.events[0]["counters"]['engine/comm_bits{bits="8"}']
    640.0
    """

    def __init__(self, clock: WallClock | VirtualClock | None = None,
                 trace: bool = False) -> None:
        self.clock = clock if clock is not None else WallClock()
        self.trace_enabled = bool(trace)
        self.events: list[dict] = []
        self._counters: dict[str, float] = {}
        self._flushed: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._gauges_dirty = False
        self._spans: dict[str, list[float]] = {}   # key -> [count, total_s]
        self._hists: dict[str, _Hist] = {}
        self._hists_dirty: set[str] = set()
        self._clock_unbound = False
        self._trace_coarse = False

    def _clock_check(self) -> None:
        """One-shot warning when spans are recorded against an unbound
        ``VirtualClock`` — every timestamp would silently read 0.0. The
        condition is also flagged as ``clock_unbound`` in the stream header."""
        if self._clock_unbound:
            return
        clk = self.clock
        if isinstance(clk, VirtualClock) and not clk.bound:
            self._clock_unbound = True
            warnings.warn(
                "Recorder clock is an unbound VirtualClock: span timestamps "
                "read 0.0. Bind it (clock.bind(lambda: runner.t) — "
                "AsyncDFedRW.attach_obs does this) before recording; the "
                "stream header will carry clock_unbound=true.",
                stacklevel=3)

    # -- counters / gauges / histograms ---------------------------------
    def counter(self, name: str, inc: float = 1, **labels: Any) -> None:
        """Increment a monotone counter (deltas are emitted on flush)."""
        k = _key(name, labels)
        self._counters[k] = self._counters.get(k, 0.0) + float(inc)

    def value(self, name: str, **labels: Any) -> float:
        """Current cumulative value of a counter series (0.0 if unseen)."""
        return self._counters.get(_key(name, labels), 0.0)

    def gauge(self, name: str, value: float, **labels: Any) -> None:
        """Set a point-in-time value (snapshotted on flush)."""
        self._gauges[_key(name, labels)] = float(value)
        self._gauges_dirty = True

    def histogram(self, name: str, value, **labels: Any) -> None:
        """Observe a value (or an array of values) into a distribution."""
        k = _key(name, labels)
        self._hists_dirty.add(k)
        h = self._hists.get(k)
        if h is None:
            h = self._hists[k] = _Hist()
        try:
            it = iter(value)
        except TypeError:
            it = (value,)
        h.observe_many(it)

    # -- spans -----------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **labels: Any) -> Iterator[None]:
        """Time a block on this recorder's clock; nests freely."""
        self._clock_check()
        t0 = self.clock.now()
        try:
            yield
        finally:
            self.record_span(name, t0, self.clock.now(), **labels)

    def record_span(self, name: str, t0: float, t1: float,
                    **labels: Any) -> None:
        """Record an explicit ``[t0, t1]`` interval (clock already read by the
        caller — how the sim prices windows in virtual seconds)."""
        self._clock_check()
        k = _key(name, labels)
        agg = self._spans.get(k)
        if agg is None:
            agg = self._spans[k] = [0, 0.0]
        agg[0] += 1
        agg[1] += t1 - t0
        self.events.append({"kind": "span", "name": k,
                            "t0": float(t0), "t1": float(t1)})

    def duration(self, name: str, seconds: float, t: float | None = None,
                 **labels: Any) -> None:
        """Record an elapsed duration without interval endpoints (e.g. uplink
        busy-time deltas, per-step serve timings)."""
        self._clock_check()
        k = _key(name, labels)
        agg = self._spans.get(k)
        if agg is None:
            agg = self._spans[k] = [0, 0.0]
        agg[0] += 1
        agg[1] += float(seconds)
        self.events.append({"kind": "dur", "name": k,
                            "t": float(self.clock.now() if t is None else t),
                            "dur": float(seconds)})

    # -- causal trace spans ----------------------------------------------
    def trace_span(self, kind: str, *, trace: str, span: str,
                   t0: float, t1: float, parent: str | None = None,
                   **attrs: Any) -> None:
        """Record one node of a causal span tree (``repro_torch.obs.trace``).

        ``trace`` groups spans into one tree (chain ``c<uid>``, aggregation
        window ``w<win>``, serve request ``r<rid>``); ``span`` is the node id
        and ``parent`` its causal predecessor within the same trace (``None``
        for roots). ``kind`` is one of ``repro_torch.obs.SPAN_KINDS``. Attrs are
        flattened onto the event line (ints/floats/strings only). Totals also
        aggregate into the ``trace/<kind>`` span series, so summaries and
        Prometheus dumps carry per-kind counts/seconds without replaying the
        event list.

        >>> rec = Recorder(clock=VirtualClock(lambda: 9.0), trace=True)
        >>> rec.trace_span("sgd", trace="c0", span="c0.s0", parent="c0.h0",
        ...                t0=1.0, t1=3.5, win=0, dev=4)
        >>> rec.events[-1]["span"], rec.summary()["spans"]["trace/sgd"]
        ('c0.s0', {'count': 1, 'total_s': 2.5})
        """
        self._clock_check()
        agg = self._spans.get(f"trace/{kind}")
        if agg is None:
            agg = self._spans[f"trace/{kind}"] = [0, 0.0]
        agg[0] += 1
        agg[1] += float(t1) - float(t0)
        ev: dict[str, Any] = {"kind": "tspan", "sk": str(kind),
                              "trace": str(trace), "span": str(span),
                              "t0": float(t0), "t1": float(t1)}
        if parent is not None:
            ev["parent"] = str(parent)
        for k in sorted(attrs):
            ev[k] = _attr_value(attrs[k])
        self.events.append(ev)

    def note_trace_coarse(self) -> None:
        """Flag that trace emission coarsened per-chain spans to window
        envelopes (fleet engine at scale); lands in the stream header."""
        self._trace_coarse = True

    # -- flush / export --------------------------------------------------
    def flush(self, t: float | None = None) -> None:
        """Emit one event with counter *deltas* since the previous flush and
        a snapshot of changed gauges. Call at window/step boundaries — never
        inside a device computation."""
        deltas = {}
        for k in self._counters:
            d = self._counters[k] - self._flushed.get(k, 0.0)
            # a series' first flush emits even a zero delta, so a stream cut
            # before the summary still knows the counter exists (the report
            # rebuild shows "0" rather than dropping the row)
            if d or k not in self._flushed:
                deltas[k] = d
                self._flushed[k] = self._counters[k]
        ev: dict[str, Any] = {}
        if deltas:
            ev["counters"] = {k: deltas[k] for k in sorted(deltas)}
        if self._gauges_dirty:
            ev["gauges"] = {k: self._gauges[k] for k in sorted(self._gauges)}
            self._gauges_dirty = False
        if self._hists_dirty:
            # Snapshot summaries of histograms touched since the last flush,
            # so a stream cut mid-run still rebuilds distribution tails.
            ev["hists"] = {k: self._hists[k].summary()
                           for k in sorted(self._hists_dirty)}
            self._hists_dirty.clear()
        if not ev:
            return
        ev["kind"] = "flush"
        ev["t"] = float(self.clock.now() if t is None else t)
        self._clock_check()
        self.events.append(ev)

    def summary(self) -> dict:
        """Aggregate totals across the whole recording (summary JSONL line)."""
        return {
            "kind": "summary",
            "counters": {k: self._counters[k] for k in sorted(self._counters)},
            "gauges": {k: self._gauges[k] for k in sorted(self._gauges)},
            "spans": {k: {"count": v[0], "total_s": v[1]}
                      for k, v in sorted(self._spans.items())},
            "hists": {k: h.summary() for k, h in sorted(self._hists.items())},
        }

    def to_stream(self, provenance: dict | None = None, **context: Any):
        """Freeze into an ``ObsStream`` (flushes pending counters first)."""
        from .stream import ObsStream, make_obs_header
        self.flush()
        flags: dict[str, Any] = {}
        if self.trace_enabled:
            flags["trace"] = True
        if self._trace_coarse:
            flags["trace_coarse"] = True
        if self._clock_unbound:
            flags["clock_unbound"] = True
        header = make_obs_header(clock=self.clock.kind,
                                 provenance=provenance, **flags, **context)
        return ObsStream(header=header, events=list(self.events),
                         summary=self.summary())

    def save(self, path: str, provenance: dict | None = None,
             **context: Any) -> None:
        self.to_stream(provenance=provenance, **context).save(path)

    def to_prometheus(self) -> str:
        """Prometheus text-exposition dump of the current aggregates."""
        def metric(k: str, suffix: str = "") -> str:
            name, brace, labels = k.partition("{")
            name = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
            return f"repro_{name}{suffix}{brace}{labels}"

        lines = []
        for k in sorted(self._counters):
            lines.append(f"{metric(k, '_total')} {self._counters[k]:g}")
        for k in sorted(self._gauges):
            lines.append(f"{metric(k)} {self._gauges[k]:g}")
        for k, v in sorted(self._spans.items()):
            lines.append(f"{metric(k, '_seconds_count')} {v[0]}")
            lines.append(f"{metric(k, '_seconds_sum')} {v[1]:g}")
        for k, h in sorted(self._hists.items()):
            lines.append(f"{metric(k, '_count')} {h.count}")
            lines.append(f"{metric(k, '_sum')} {h.total:g}")
            if h.count:
                s = h.summary()
                for q, key in (("0.5", "p50"), ("0.9", "p90"),
                               ("0.99", "p99")):
                    lines.append(f"{quantile_line(metric(k), q)} {s[key]:g}")
                lines.append(f"{metric(k, '_min')} {h.vmin:g}")
                lines.append(f"{metric(k, '_max')} {h.vmax:g}")
        return "\n".join(lines) + "\n"


@contextlib.contextmanager
def torch_profile(logdir: str | None) -> Iterator[None]:
    """Optional ``torch.profiler`` session around a block, its Chrome trace
    written under ``logdir``: a no-op when ``logdir`` is falsy or the
    profiler cannot start."""
    if not logdir:
        yield
        return
    try:
        import os

        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    except Exception:
        yield
        return
    try:
        yield
    finally:
        try:
            prof.__exit__(None, None, None)
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
        except Exception:
            pass
