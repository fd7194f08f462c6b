"""Critical-path attribution over trace span trees: *why* was a window slow?

The port's copy of ``repro.obs.critical``, line for line the same
attribution and text.

Per aggregation window, the window's latency is the latest-finishing chain's
dependency chain (Eq. 14 waits for every selected chain) plus the
aggregation fan-in. Walks are linear, so the critical path through the
latest chain is exactly its own span sequence; this module sums that
chain's in-window spans by kind — compute (``sgd``), wire (``transfer``),
FIFO queueing (``queue_wait``), churn (``churn_wait``) — adds the
aggregation phase's critical message (``agg_transfer``/``agg_queue_wait``),
and reports the bottleneck kind and device per window plus a straggler
league table across the run.

Works on both emission modes: full per-step spans, or the fleet engine's
coarse window envelopes (whose attrs carry the same per-kind totals).
"""
from __future__ import annotations

import dataclasses

from .trace import TraceSpan, spans_of

__all__ = [
    "WindowCriticalPath",
    "critical_paths",
    "straggler_table",
    "render_critical",
]

#: Attribution buckets, in render order.
_KINDS = ("sgd", "transfer", "queue_wait", "churn_wait",
          "agg_transfer", "agg_queue_wait")

#: Human labels for the bottleneck column.
_LABEL = {"sgd": "compute", "transfer": "wire transfer",
          "queue_wait": "queue_wait on uplink",
          "churn_wait": "churn_wait on",
          "agg_transfer": "aggregation wire from",
          "agg_queue_wait": "aggregation queue_wait on uplink"}


@dataclasses.dataclass
class WindowCriticalPath:
    """Latency attribution of one aggregation window."""

    win: int
    t0: float                      # earliest span start in the window
    t1: float                      # aggregation end
    chain: str | None              # critical (latest-finishing) chain trace
    attribution: dict              # kind -> seconds on the critical path
    slack_s: float                 # window extent not on the critical path
    bottleneck_kind: str
    bottleneck_dev: int | None     # device of the largest bottleneck span
    device_seconds: dict           # device -> critical-path seconds

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def describe(self) -> str:
        """"61% queue_wait on uplink dev=42" — the report's bottleneck cell."""
        total = self.window_s
        share = (100.0 * self.attribution.get(self.bottleneck_kind, 0.0)
                 / total) if total > 0 else 0.0
        dev = "" if self.bottleneck_dev is None else f" dev={self.bottleneck_dev}"
        return f"{share:.0f}% {_LABEL[self.bottleneck_kind]}{dev}"


def _chain_attribution(spans: list[TraceSpan]):
    """(attribution, device_seconds, largest-span-per-kind) for one chain's
    in-window spans; understands both full and coarse emission."""
    attribution = {k: 0.0 for k in _KINDS}
    device_seconds: dict[int, float] = {}
    biggest: dict[str, tuple[float, int | None]] = {}

    def add(kind: str, dur: float, dev) -> None:
        if dur <= 0:
            return
        attribution[kind] += dur
        if dev is not None:
            dev = int(dev)
            device_seconds[dev] = device_seconds.get(dev, 0.0) + dur
        if dur > biggest.get(kind, (0.0, None))[0]:
            biggest[kind] = (dur, None if dev is None else int(dev))

    for s in spans:
        if "steps" in s.attrs:      # coarse envelope: totals live in attrs
            dev = s.attrs.get("dev")
            add("sgd", float(s.attrs.get("sgd_s", 0.0)), dev)
            add("transfer", float(s.attrs.get("transfer_s", 0.0)), dev)
            add("queue_wait", float(s.attrs.get("queue_s", 0.0)), dev)
            add("churn_wait", float(s.attrs.get("churn_s", 0.0)), dev)
        elif s.kind == "sgd":
            add("sgd", s.dur, s.attrs.get("dev"))
        elif s.kind == "transfer":
            add("transfer", s.dur, s.attrs.get("src"))
        elif s.kind == "queue_wait":
            add("queue_wait", s.dur, s.attrs.get("src"))
        elif s.kind == "churn_wait":
            add("churn_wait", s.dur, s.attrs.get("dev"))
    return attribution, device_seconds, biggest


def critical_paths(stream_or_spans) -> list[WindowCriticalPath]:
    """Attribute every aggregation window's latency along its critical path.

    Accepts an ``ObsStream`` (or raw events / parsed spans). Serve-side
    traces (``r<rid>``) carry no ``win`` attr and are ignored here.
    """
    spans = (stream_or_spans
             if stream_or_spans and isinstance(stream_or_spans, list)
             and isinstance(stream_or_spans[0], TraceSpan)
             else spans_of(stream_or_spans))
    by_win: dict[int, list[TraceSpan]] = {}
    for s in spans:
        win = s.attrs.get("win")
        if win is not None:
            by_win.setdefault(int(win), []).append(s)

    out = []
    for win in sorted(by_win):
        wspans = by_win[win]
        t0 = min(s.t0 for s in wspans)
        t1 = max(s.t1 for s in wspans)
        chains: dict[str, list[TraceSpan]] = {}
        agg: list[TraceSpan] = []
        for s in wspans:
            (agg if s.trace.startswith("w") else
             chains.setdefault(s.trace, [])).append(s)

        # Critical chain: latest-finishing; ties break on the lowest uid so
        # heap and fleet agree on every config.
        crit = None
        if chains:
            def sort_key(item):
                trace, ss = item
                uid = int(trace[1:]) if trace[1:].isdigit() else 0
                return (-max(s.t1 for s in ss), uid)
            crit = sorted(chains.items(), key=sort_key)[0]
        attribution, device_seconds, biggest = _chain_attribution(
            crit[1] if crit else [])

        # Aggregation phase: the latest message is the join's critical leg.
        agg_transfers = [s for s in agg if s.kind == "transfer"]
        if agg_transfers:
            crit_msg = sorted(agg_transfers,
                              key=lambda s: (-s.t1, s.span))[0]
            src = crit_msg.attrs.get("src")
            if crit_msg.dur > 0:
                attribution["agg_transfer"] = crit_msg.dur
                biggest["agg_transfer"] = (crit_msg.dur, src)
                if src is not None:
                    device_seconds[int(src)] = (
                        device_seconds.get(int(src), 0.0) + crit_msg.dur)
            qid = crit_msg.span.replace(".t", ".q")
            for s in agg:
                if s.span == qid and s.dur > 0:
                    attribution["agg_queue_wait"] = s.dur
                    biggest["agg_queue_wait"] = (s.dur, src)

        on_path = sum(attribution.values())
        bkind = max(_KINDS, key=lambda k: attribution[k])
        out.append(WindowCriticalPath(
            win=win, t0=t0, t1=t1,
            chain=crit[0] if crit else None,
            attribution={k: v for k, v in attribution.items() if v > 0},
            slack_s=max((t1 - t0) - on_path, 0.0),
            bottleneck_kind=bkind,
            bottleneck_dev=biggest.get(bkind, (0.0, None))[1],
            device_seconds=device_seconds))
    return out


def straggler_table(paths: list[WindowCriticalPath]) -> list[tuple]:
    """League table of critical-path seconds by device across all windows:
    ``[(dev, total_s, windows_on_path), ...]`` sorted worst-first."""
    totals: dict[int, float] = {}
    windows: dict[int, int] = {}
    for p in paths:
        for dev, s in p.device_seconds.items():
            totals[dev] = totals.get(dev, 0.0) + s
            windows[dev] = windows.get(dev, 0) + 1
    return sorted(((d, totals[d], windows[d]) for d in totals),
                  key=lambda row: (-row[1], row[0]))


def render_critical(stream_or_spans, max_rows: int = 12) -> list[str]:
    """The report section: per-window bottleneck table + straggler league."""
    paths = critical_paths(stream_or_spans)
    if not paths:
        return []
    out = ["critical path (latest-finishing chain per aggregation window):",
           f"  {'win':>4s}  {'chain':<8s} {'window_s':>10s}  bottleneck"]
    for p in paths[:max_rows]:
        out.append(f"  {p.win:4d}  {p.chain or '-':<8s} "
                   f"{p.window_s:10.4f}  {p.describe()}")
    if len(paths) > max_rows:
        out.append(f"  ... {len(paths) - max_rows} more windows")
    league = straggler_table(paths)
    if league:
        out.append("")
        out.append("straggler league (critical-path seconds by device):")
        out.append(f"  {'dev':>5s} {'total_s':>10s} {'windows':>8s}")
        for dev, total, wins in league[:max_rows]:
            out.append(f"  {dev:5d} {total:10.4f} {wins:8d}")
        if len(league) > max_rows:
            out.append(f"  ... {len(league) - max_rows} more devices")
    return out
