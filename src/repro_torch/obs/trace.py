"""Causal span trees over ``Recorder``: a random walk *is* a distributed trace.

The port's copy of ``repro.obs.trace``, byte for byte the same emission.

DFedRW's argument (Eq. 11/14) is about which chain, device or link delayed an
aggregation window — exactly the question a distributed trace answers. The
mapping is one-to-one:

* **trace** — one walk chain (``c<uid>``), one aggregation window's fan-in
  (``w<win>``), or one serve request (``r<rid>``);
* **span** — a hop, an SGD burst, a wire transfer, FIFO queue wait, churn
  wait, the Eq. 14 aggregation join, or a serve admit/prefill/decode step;
* **parent** — the causal predecessor: ``sgd`` hangs off its ``hop``, a
  ``hop`` off the ``transfer`` that delivered the model, a ``transfer`` off
  the previous hop, ``queue_wait`` off the transfer it delayed.

Both simulator engines route through ``emit_walk_window`` — the heap engine
records per-event timing into per-slot arrays, the fleet engine *is* those
arrays — so a heap trace and a fleet trace of the same config are identical
by construction (span ids, parents, and endpoints in virtual seconds).

Span ids are content-derived (``c<uid>.h<k>``: chain uid, step index), never
allocated from a counter at emission time, which is what lets a span emitted
in window 3 reference a parent emitted in window 2 and keeps streams
byte-deterministic.

At fleet scale (``m_chains * k_walk > TRACE_COARSE_LIMIT``) per-step spans
would dominate the stream, so emission coarsens to one envelope span per
chain per window whose attrs carry the per-kind totals (``sgd_s``,
``transfer_s``, ``queue_s``, ``churn_s``); the coarsening is flagged as
``trace_coarse`` in the stream header and understood by
``repro_torch.obs.critical``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable

import numpy as np

__all__ = [
    "SPAN_KINDS",
    "TRACE_COARSE_LIMIT",
    "TraceSpan",
    "TraceTree",
    "spans_of",
    "build_trees",
    "emit_walk_window",
]

#: Every span kind a v2 stream may carry.
SPAN_KINDS = ("hop", "sgd", "transfer", "queue_wait", "churn_wait",
              "aggregate", "admit", "prefill_chunk", "decode")

#: Above this many chain-steps per window (m_chains * k_walk), walk tracing
#: coarsens to per-chain window envelopes instead of per-step spans.
TRACE_COARSE_LIMIT = 20_000

_RESERVED = frozenset(("kind", "sk", "trace", "span", "parent", "t0", "t1"))


@dataclasses.dataclass(frozen=True)
class TraceSpan:
    """One parsed ``tspan`` event line."""

    kind: str
    trace: str
    span: str
    t0: float
    t1: float
    parent: str | None = None
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class TraceTree:
    """All spans of one trace id, indexed for parent/child walks."""

    trace: str
    spans: dict[str, TraceSpan]                 # span id -> span
    children: dict[str | None, list[str]]       # parent id (or None) -> ids

    @property
    def roots(self) -> list[TraceSpan]:
        """Spans whose parent is absent from this trace (incl. ``None``):
        a chain resumed across windows has one root per first-seen span."""
        out = [self.spans[s] for s in self.children.get(None, [])]
        out += [self.spans[s] for p, ids in self.children.items()
                if p is not None and p not in self.spans for s in ids]
        return out

    @property
    def t_end(self) -> float:
        return max(s.t1 for s in self.spans.values())


def spans_of(stream_or_events) -> list[TraceSpan]:
    """Parse every ``tspan`` event of an ``ObsStream`` (or raw event list)
    into ``TraceSpan`` objects, in stream order."""
    events = getattr(stream_or_events, "events", stream_or_events)
    out = []
    for ev in events:
        if ev.get("kind") != "tspan":
            continue
        out.append(TraceSpan(
            kind=ev["sk"], trace=ev["trace"], span=ev["span"],
            t0=float(ev["t0"]), t1=float(ev["t1"]), parent=ev.get("parent"),
            attrs={k: v for k, v in ev.items() if k not in _RESERVED}))
    return out


def build_trees(spans: Iterable[TraceSpan]) -> dict[str, TraceTree]:
    """Group spans by trace id into parent-indexed trees (insertion order)."""
    trees: dict[str, TraceTree] = {}
    for s in spans:
        tree = trees.get(s.trace)
        if tree is None:
            tree = trees[s.trace] = TraceTree(trace=s.trace, spans={},
                                              children={})
        tree.spans[s.span] = s
        tree.children.setdefault(s.parent, []).append(s.span)
    return trees


# ---------------------------------------------------------------- emission

def emit_walk_window(rec, win: int, *, uids, devices, win_start, k_done,
                     t_arr, t_up, ts, t_send, agg_msgs,
                     t_compute_end: float, t_end: float,
                     coarse: bool = False) -> int:
    """Emit the span trees of one aggregation window from timing arrays.

    This is the single code path behind heap-vs-fleet trace parity: both
    engines hand over the same eight per-chain arrays (shape ``(M,)`` or
    ``(M, K)``; ``nan`` marks never-happened) plus the window's aggregation
    messages, and every span id/parent/endpoint is derived from them alone.

    Per chain ``uid`` and step ``k`` in ``[win_start, k_done)``:

    * ``c<uid>.t<k>`` *transfer* ``[t_send[k], t_arr[k]]`` — the hand-off
      that delivered the model into step ``k`` (cross-device hops only),
      parented on the previous hop;
    * ``c<uid>.q<k>`` *queue_wait* ``[ts[k-1], t_send[k]]`` — FIFO uplink
      delay before that transfer started (child of the transfer);
    * ``c<uid>.h<k>`` *hop* ``[t_arr[k], ts[k]]`` — residency on the device,
      parented on the transfer (or previous hop for self-hops);
    * ``c<uid>.w<k>`` *churn_wait* ``[t_arr[k], t_up[k]]`` — waiting out a
      device's down window (child of the hop);
    * ``c<uid>.s<k>`` *sgd* ``[t_up[k], ts[k]]`` — the K-local-step compute
      burst (child of the hop).

    The window's Eq. 14 join is its own trace ``w<win>``: an ``aggregate``
    root ``[t_compute_end, t_end]`` with one *transfer* child per
    aggregation message (``w<win>.t<i>`` in row-major message order), each
    with a ``queue_wait`` child when the uplink FIFO delayed it.

    With ``coarse=True`` each chain collapses to one envelope ``hop`` span
    per window (``c<uid>.W<win>``) carrying per-kind totals in attrs, and
    only the latest-arriving aggregation message is emitted.

    Returns the number of spans emitted.
    """
    win = int(win)
    m = len(uids)
    n_spans = 0
    if coarse:
        n_spans += _emit_coarse_chains(rec, win, uids, devices, win_start,
                                       k_done, t_arr, t_up, ts, t_send)
    else:
        for mi in range(m):
            a, b = int(win_start[mi]), int(k_done[mi])
            if b <= a:
                continue
            cu = f"c{int(uids[mi])}"
            for k in range(a, b):
                parent = None if k == 0 else f"{cu}.h{k - 1}"
                if k >= 1 and int(devices[mi, k - 1]) != int(devices[mi, k]):
                    send = float(t_send[mi, k])
                    arr = float(t_arr[mi, k])
                    prev = float(ts[mi, k - 1])
                    tid = f"{cu}.t{k}"
                    if send > prev:
                        rec.trace_span("queue_wait", trace=cu,
                                       span=f"{cu}.q{k}", parent=tid,
                                       t0=prev, t1=send, win=win,
                                       src=int(devices[mi, k - 1]))
                        n_spans += 1
                    rec.trace_span("transfer", trace=cu, span=tid,
                                   parent=parent, t0=send, t1=arr, win=win,
                                   src=int(devices[mi, k - 1]),
                                   dst=int(devices[mi, k]))
                    n_spans += 1
                    parent = tid
                arr_k = float(t_arr[mi, k])
                up_k = float(t_up[mi, k])
                hid = f"{cu}.h{k}"
                rec.trace_span("hop", trace=cu, span=hid, parent=parent,
                               t0=arr_k, t1=float(ts[mi, k]), win=win,
                               dev=int(devices[mi, k]), k=k)
                n_spans += 1
                if up_k > arr_k:
                    rec.trace_span("churn_wait", trace=cu, span=f"{cu}.w{k}",
                                   parent=hid, t0=arr_k, t1=up_k, win=win,
                                   dev=int(devices[mi, k]))
                    n_spans += 1
                rec.trace_span("sgd", trace=cu, span=f"{cu}.s{k}",
                               parent=hid, t0=up_k, t1=float(ts[mi, k]),
                               win=win, dev=int(devices[mi, k]), k=k)
                n_spans += 1

    wt = f"w{win}"
    n_msgs = 0 if not agg_msgs else len(agg_msgs)
    rec.trace_span("aggregate", trace=wt, span=f"{wt}.agg",
                   t0=float(t_compute_end), t1=float(t_end), win=win,
                   msgs=n_msgs)
    n_spans += 1
    if agg_msgs:
        if coarse:
            crit = int(np.argmax([msg[3] for msg in agg_msgs]))
            sel = [(crit, agg_msgs[crit])]
        else:
            sel = list(enumerate(agg_msgs))
        for i, (src, dst, t0m, t1m) in sel:
            tid = f"{wt}.t{i}"
            if t0m > t_compute_end:
                rec.trace_span("queue_wait", trace=wt, span=f"{wt}.q{i}",
                               parent=tid, t0=float(t_compute_end),
                               t1=float(t0m), win=win, src=int(src))
                n_spans += 1
            rec.trace_span("transfer", trace=wt, span=tid,
                           parent=f"{wt}.agg", t0=float(t0m), t1=float(t1m),
                           win=win, src=int(src), dst=int(dst))
            n_spans += 1
    return n_spans


def _emit_coarse_chains(rec, win, uids, devices, win_start, k_done,
                        t_arr, t_up, ts, t_send) -> int:
    """Vectorized per-chain window envelopes (the fleet-scale path)."""
    devices = np.asarray(devices)
    win_start = np.asarray(win_start)
    k_done = np.asarray(k_done)
    m, k_cap = devices.shape
    cols = np.arange(k_cap)[None, :]
    step_mask = (cols >= win_start[:, None]) & (cols < k_done[:, None])
    live = np.nonzero(step_mask.any(axis=1))[0]
    if not live.size:
        return 0
    sgd_s = np.nansum(np.where(step_mask, ts - t_up, 0.0), axis=1)
    churn_s = np.nansum(np.where(step_mask, t_up - t_arr, 0.0), axis=1)
    in_mask = step_mask & (cols >= 1)    # hand-offs INTO steps k >= 1
    prev_ts = np.concatenate([np.full((m, 1), np.nan), ts[:, :-1]], axis=1)
    transfer_s = np.nansum(np.where(in_mask, t_arr - t_send, 0.0), axis=1)
    queue_s = np.nansum(np.where(in_mask, t_send - prev_ts, 0.0), axis=1)
    n = 0
    for mi in live:
        a, b = int(win_start[mi]), int(k_done[mi])
        t0 = float(t_arr[mi, a])
        if not np.isfinite(t0):
            t0 = float(t_up[mi, a])
        cu = f"c{int(uids[mi])}"
        rec.trace_span("hop", trace=cu, span=f"{cu}.W{win}",
                       t0=t0, t1=float(ts[mi, b - 1]), win=win,
                       dev=int(devices[mi, b - 1]), steps=b - a,
                       sgd_s=float(sgd_s[mi]), churn_s=float(churn_s[mi]),
                       transfer_s=float(transfer_s[mi]),
                       queue_s=float(queue_s[mi]))
        n += 1
    return n
