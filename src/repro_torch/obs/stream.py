"""Versioned JSONL telemetry streams (the obs analogue of ``sim/trace.py``).

JSONL schema (version 2)
------------------------
Line 1 is the header; every further line is one event; the final line is the
whole-recording summary:

    {"schema": "repro.obs", "version": 2, "clock": "virtual"|"wall"|...,
     ...optional: "provenance": {...}, launcher context ("workload",
     "scenario", "arch", ...), flags ("trace", "trace_coarse",
     "clock_unbound")...}

    {"kind": "span", "name": 'sim/window', "t0": 0.0, "t1": 9.3}
    {"kind": "dur", "name": 'sim/uplink_busy', "t": 9.3, "dur": 4.1}
    {"kind": "tspan", "sk": "sgd", "trace": "c3", "span": "c3.s2",
     "parent": "c3.h2", "t0": 4.1, "t1": 9.3, ...flat attrs ("win",
     "dev", ...)}
    {"kind": "flush", "t": 9.3, "counters": {delta...}, "gauges": {...},
     "hists": {name: summary-so-far...}}

    {"kind": "summary", "counters": {totals...}, "gauges": {...},
     "spans": {name: {"count": N, "total_s": S}}, "hists": {name: {...}}}

Version 2 adds (a) ``tspan`` causal trace spans (``repro_torch.obs.trace``) —
``trace`` is the trace id (chain ``c<uid>``, aggregation window ``w<win>``,
serve request ``r<rid>``), ``span``/``parent`` the span-tree edges, ``sk``
the span kind; (b) histogram snapshots on flush lines, so a stream cut
mid-run still rebuilds distribution tails; (c) the header flags above.
Version 1 streams (no tspans, no flush hists) stay readable.

Series names encode labels Prometheus-style: ``engine/comm_bits{bits="8"}``.
Timestamps are priced by the recorder's clock (see header ``clock``); for the
simulator that is *virtual* seconds, which is what makes a sim stream a pure
function of (scenario, seed) and therefore replay-testable.

The reader follows ``sim/trace.py``'s compat discipline: ``from_lines``
rejects foreign schemas and versions outside ``OBS_COMPAT_VERSIONS``; adding
a field is a version bump with the old version kept readable.

>>> from .recorder import Recorder, VirtualClock
>>> rec = Recorder(clock=VirtualClock(lambda: 1.0))
>>> rec.counter("engine/rounds"); rec.flush()
>>> s = ObsStream.from_lines(rec.to_stream(workload="sim").to_lines())
>>> s.header["version"] == OBS_SCHEMA_VERSION and s.header["workload"]
'sim'
>>> s.summary["counters"]["engine/rounds"]
1.0
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Iterable

__all__ = [
    "OBS_SCHEMA",
    "OBS_SCHEMA_VERSION",
    "OBS_COMPAT_VERSIONS",
    "ObsError",
    "ObsFormatError",
    "ObsSchemaError",
    "ObsStream",
    "make_obs_header",
]

OBS_SCHEMA = "repro.obs"
OBS_SCHEMA_VERSION = 2
# Versions from_lines still reads.
OBS_COMPAT_VERSIONS = (1, 2)


class ObsError(ValueError):
    """Base of every typed obs-stream loading failure (subclasses
    ValueError so pre-existing ``except ValueError`` callers keep working;
    mirrors ``repro_torch.sim.trace.TraceError``)."""


class ObsFormatError(ObsError):
    """Not a well-formed stream: truncated/corrupt JSONL, a non-object
    line, or an event line with no ``kind``."""


class ObsSchemaError(ObsError):
    """A well-formed file of the wrong kind: foreign schema name or a
    version outside ``OBS_COMPAT_VERSIONS``."""


def make_obs_header(*, clock: str, provenance: dict | None = None,
                    **context: Any) -> dict:
    """Header line of an obs stream. ``clock`` names the time base every
    event is priced in; ``provenance`` (see ``repro_torch.obs.provenance``) and
    ``context`` carry run identity — they live only on the header, so the
    event lines of a deterministic run are byte-identical across hosts."""
    head: dict[str, Any] = {
        "schema": OBS_SCHEMA,
        "version": OBS_SCHEMA_VERSION,
        "clock": str(clock),
    }
    if provenance:
        head["provenance"] = dict(provenance)
    head.update(context)
    return head


@dataclasses.dataclass
class ObsStream:
    """Header + event lines + optional trailing summary; JSONL on disk."""

    header: dict
    events: list = dataclasses.field(default_factory=list)
    summary: dict | None = None

    def to_lines(self) -> list[str]:
        lines = [json.dumps(self.header)]
        lines += [json.dumps(e) for e in self.events]
        if self.summary is not None:
            lines.append(json.dumps(self.summary))
        return lines

    @classmethod
    def from_lines(cls, lines: Iterable[str]) -> "ObsStream":
        numbered = [(i, l) for i, l in enumerate(lines, start=1) if l.strip()]
        if not numbered:
            raise ObsFormatError("empty obs stream: no header line")
        lineno, head_line = numbered[0]
        try:
            header = json.loads(head_line)
        except json.JSONDecodeError as e:
            raise ObsFormatError(
                f"line {lineno}: header is not valid JSON ({e})") from e
        if not isinstance(header, dict):
            raise ObsFormatError(
                f"line {lineno}: header must be a JSON object, "
                f"got {type(header).__name__}")
        if header.get("schema") != OBS_SCHEMA:
            raise ObsSchemaError(
                f"not a {OBS_SCHEMA} file: {header.get('schema')!r}")
        if header.get("version") not in OBS_COMPAT_VERSIONS:
            raise ObsSchemaError(
                f"obs stream version {header.get('version')} not in "
                f"supported {OBS_COMPAT_VERSIONS}")
        events = []
        for lineno, line in numbered[1:]:
            try:
                ev = json.loads(line)
            except json.JSONDecodeError as e:
                raise ObsFormatError(
                    f"line {lineno}: truncated or corrupt event line "
                    f"({e})") from e
            if not isinstance(ev, dict):
                raise ObsFormatError(
                    f"line {lineno}: event must be a JSON object, "
                    f"got {type(ev).__name__}")
            if not isinstance(ev.get("kind"), str):
                raise ObsFormatError(
                    f"line {lineno}: event line lacks a string 'kind'")
            events.append(ev)
        summary = None
        if events and events[-1].get("kind") == "summary":
            summary = events.pop()
        return cls(header=header, events=events, summary=summary)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("\n".join(self.to_lines()) + "\n")

    @classmethod
    def load(cls, path: str) -> "ObsStream":
        with open(path) as f:
            return cls.from_lines(f)
