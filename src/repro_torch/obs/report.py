"""Human run reports from recorded obs streams.

The port's copy of ``repro.obs.report``: the same sections and text, so a
stream renders byte for byte as the JAX package's ``tools/obs_report.py``
renders it, except for the provenance line, which names the port's keys
(``torch``, ``cuda``) where the reference names ``jax``.

``render_report`` turns an ``ObsStream`` into the operator's view of a run:
where the time went (per-phase span table), where the bits went (Eq. 18 comm
by wire width), whether the program table stayed stable (dispatch/retrace
audit), and how heavy the tails are (histogram percentiles — straggler walk
lengths, TTFT/TPOT). It prefers the trailing summary line but rebuilds the
same aggregates from the raw event lines when a stream was cut short.
"""
from __future__ import annotations

import re
from typing import Any

from .critical import render_critical
from .recorder import quantile_line

__all__ = ["render_report", "render_prometheus", "split_key"]

_KEY_RE = re.compile(r'^(?P<name>[^{]+)(?:\{(?P<labels>.*)\})?$')
_LABEL_RE = re.compile(r'(\w+)="([^"]*)"')


def split_key(key: str) -> tuple[str, dict[str, str]]:
    """``'engine/comm_bits{bits="8"}'`` -> ``('engine/comm_bits', {'bits': '8'})``."""
    m = _KEY_RE.match(key)
    if m is None:
        return key, {}
    labels = dict(_LABEL_RE.findall(m.group("labels") or ""))
    return m.group("name"), labels


def _aggregates(stream) -> dict:
    """Summary line if present, else the same shape rebuilt from events."""
    if stream.summary is not None:
        return stream.summary
    counters: dict[str, float] = {}
    gauges: dict[str, float] = {}
    spans: dict[str, dict] = {}
    hists: dict[str, dict] = {}
    for ev in stream.events:
        kind = ev.get("kind")
        if kind == "flush":
            for k, v in ev.get("counters", {}).items():
                counters[k] = counters.get(k, 0.0) + v
            gauges.update(ev.get("gauges", {}))
            # flush hist snapshots are cumulative: last one wins (schema v2)
            hists.update(ev.get("hists", {}))
        elif kind in ("span", "dur"):
            agg = spans.setdefault(ev["name"], {"count": 0, "total_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += (ev["t1"] - ev["t0"]) if kind == "span" else ev["dur"]
        elif kind == "tspan":
            agg = spans.setdefault("trace/" + ev["sk"],
                                   {"count": 0, "total_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += ev["t1"] - ev["t0"]
    return {"counters": counters, "gauges": gauges, "spans": spans,
            "hists": hists}


def _time_extent(stream, spans: dict) -> float:
    lo, hi = float("inf"), float("-inf")
    for ev in stream.events:
        if ev.get("kind") == "span":
            lo, hi = min(lo, ev["t0"]), max(hi, ev["t1"])
        elif "t" in ev:
            lo = min(lo, ev["t"] - ev.get("dur", 0.0))
            hi = max(hi, ev["t"])
    if hi <= lo:
        return max((v["total_s"] for v in spans.values()), default=0.0)
    return hi - lo


def _fmt(v: float) -> str:
    return f"{v:,.6g}"


def _table(rows: list[list[str]], head: list[str]) -> list[str]:
    widths = [max(len(r[i]) for r in [head] + rows) for i in range(len(head))]
    def line(r): return "  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
    return [line(head), line(["-" * w for w in widths])] + [line(r) for r in rows]


def render_report(stream) -> str:
    """Render the standard run report (see module docstring) as text."""
    agg = _aggregates(stream)
    counters, gauges = agg.get("counters", {}), agg.get("gauges", {})
    spans, hists = agg.get("spans", {}), agg.get("hists", {})
    h = stream.header
    clock = h.get("clock", "?")
    unit = "virtual s" if clock == "virtual" else "s"
    out: list[str] = []
    out.append(f"== repro.obs report (schema v{h.get('version')}, "
               f"clock={clock}) ==")
    ctx = {k: v for k, v in h.items()
           if k not in ("schema", "version", "clock", "provenance")}
    if ctx:
        out.append("run: " + " ".join(f"{k}={v}" for k, v in sorted(ctx.items())))
    prov = h.get("provenance")
    if prov:
        out.append("provenance: " + " ".join(
            f"{k}={prov[k]}" for k in ("git_rev", "torch", "cuda", "backend",
                                       "device_kind", "config_hash",
                                       "timestamp_utc") if k in prov))

    # -- time in phase ---------------------------------------------------
    extent = _time_extent(stream, spans)
    if spans:
        rows = []
        for k in sorted(spans, key=lambda k: -spans[k]["total_s"]):
            v = spans[k]
            mean_ms = 1e3 * v["total_s"] / max(v["count"], 1)
            pct = 100.0 * v["total_s"] / extent if extent > 0 else 0.0
            rows.append([k, str(v["count"]), f"{v['total_s']:.4f}",
                         f"{mean_ms:.3f}", f"{pct:5.1f}%"])
        out.append("")
        out.append(f"time in phase (extent {extent:.4f} {unit}; spans "
                   f"overlap, so %extent can exceed 100):")
        out += _table(rows, ["phase", "count", f"total_{unit.replace(' ', '_')}",
                             "mean_ms", "%extent"])

    # -- comm by wire width (Eq. 18) ------------------------------------
    comm = {}
    dispatch = {}
    for k, v in counters.items():
        name, labels = split_key(k)
        if name == "engine/comm_bits" and "bits" in labels:
            comm[int(labels["bits"])] = v
        elif name == "engine/programs" and "bits" in labels:
            dispatch[int(labels["bits"])] = v
    if comm:
        total = sum(comm.values())
        rows = [[str(b), _fmt(comm[b]), f"{comm[b] / 8e6:.3f}",
                 f"{100.0 * comm[b] / total:5.1f}%",
                 str(int(dispatch.get(b, 0)))]
                for b in sorted(comm)]
        out.append("")
        out.append("communication by wire width (Eq. 18 totals):")
        out += _table(rows, ["bits", "total_bits", "MB", "%comm", "rounds"])
        out.append(f"total: {_fmt(total)} bits ({total / 8e6:.3f} MB) over "
                   f"{int(sum(dispatch.values()))} rounds")

    # -- program table / retrace audit ----------------------------------
    if dispatch or "engine/retraces" in counters:
        retr = int(counters.get("engine/retraces", 0))
        out.append("")
        out.append(f"program table: {len(dispatch)} distinct width(s) "
                   f"dispatched {int(sum(dispatch.values()))}x; "
                   + (f"WARNING: {retr} retrace(s) — a plan shape is not "
                      f"stable across rounds" if retr else "no retraces"))

    # -- counters / gauges ----------------------------------------------
    plain = {k: v for k, v in counters.items()
             if split_key(k)[0] not in ("engine/comm_bits", "engine/programs")}
    if plain:
        out.append("")
        out.append("counters:")
        out += _table([[k, _fmt(v)] for k, v in sorted(plain.items())],
                      ["counter", "total"])
    if gauges:
        out.append("")
        out.append("gauges (last value):")
        out += _table([[k, _fmt(v)] for k, v in sorted(gauges.items())],
                      ["gauge", "value"])

    # -- distribution tails ---------------------------------------------
    nonempty = {k: v for k, v in hists.items() if v.get("count")}
    if nonempty:
        rows = [[k, str(v["count"]), _fmt(v["mean"]), _fmt(v["p50"]),
                 _fmt(v["p90"]), _fmt(v["p99"]), _fmt(v["max"])]
                for k, v in sorted(nonempty.items())]
        out.append("")
        out.append("distributions (straggler/latency tails):")
        out += _table(rows, ["histogram", "count", "mean", "p50", "p90",
                             "p99", "max"])

    # -- critical path (why was this window slow?) ----------------------
    crit = render_critical(stream)
    if crit:
        out.append("")
        out += crit
    return "\n".join(out) + "\n"


def render_prometheus(stream) -> str:
    """Prometheus text dump rebuilt from a saved stream's aggregates."""
    agg = _aggregates(stream)

    def metric(k: str, suffix: str = "") -> str:
        name, brace, labels = k.partition("{")
        name = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
        return f"repro_{name}{suffix}{brace}{labels}"

    lines = []
    for k in sorted(agg.get("counters", {})):
        lines.append(f"{metric(k, '_total')} {agg['counters'][k]:g}")
    for k in sorted(agg.get("gauges", {})):
        lines.append(f"{metric(k)} {agg['gauges'][k]:g}")
    for k in sorted(agg.get("spans", {})):
        v = agg["spans"][k]
        lines.append(f"{metric(k, '_seconds_count')} {v['count']}")
        lines.append(f"{metric(k, '_seconds_sum')} {v['total_s']:g}")
    for k in sorted(agg.get("hists", {})):
        v = agg["hists"][k]
        lines.append(f"{metric(k, '_count')} {v.get('count', 0)}")
        lines.append(f"{metric(k, '_sum')} {v.get('sum', 0.0):g}")
        if v.get("count"):
            for q, key in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99")):
                lines.append(f"{quantile_line(metric(k), q)} {v[key]:g}")
            lines.append(f"{metric(k, '_min')} {v['min']:g}")
            lines.append(f"{metric(k, '_max')} {v['max']:g}")
    return "\n".join(lines) + "\n"
