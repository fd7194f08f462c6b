"""repro_torch.obs — telemetry for the port's round engine and simulator.

The port's copy of ``repro.obs``: one ``Recorder`` (counters / gauges /
histograms / spans) over a pluggable clock, streams serialized as versioned
JSONL (``ObsStream``, the same schema and version, so the JAX package's
``ObsStream``, ``tools/obs_report.py`` and ``tools/obs_diff.py`` read the
port's streams) with a provenance header, the causal span trees of the
simulator's ``--trace``, and the renderers: run reports, Prometheus text
and the critical-path section (``report.py``, ``critical.py``).

Quickstart::

    from repro_torch.obs import (ObsStream, Recorder, VirtualClock, provenance,
                                 render_report)
    rec = Recorder(clock=VirtualClock())
    runner.attach_obs(rec)            # AsyncDFedRW / FleetDFedRW / DFedRW
    runner.run(rounds, gen, x_test, y_test)
    rec.save("obs.jsonl", provenance=provenance())
    print(render_report(ObsStream.load("obs.jsonl")))
"""
from .critical import (WindowCriticalPath, critical_paths, render_critical,
                       straggler_table)
from .provenance import PROVENANCE_KEYS, config_hash, provenance
from .recorder import (HIST_RESERVOIR, PausableWallClock, Recorder,
                       VirtualClock, WallClock, quantile_line, torch_profile)
from .report import render_prometheus, render_report
from .stream import (OBS_COMPAT_VERSIONS, OBS_SCHEMA, OBS_SCHEMA_VERSION,
                     ObsError, ObsFormatError, ObsSchemaError, ObsStream,
                     make_obs_header)
from .trace import (SPAN_KINDS, TRACE_COARSE_LIMIT, TraceSpan, TraceTree,
                    build_trees, emit_walk_window, spans_of)

__all__ = [
    "Recorder",
    "WallClock",
    "PausableWallClock",
    "VirtualClock",
    "torch_profile",
    "HIST_RESERVOIR",
    "quantile_line",
    "ObsStream",
    "OBS_SCHEMA",
    "OBS_SCHEMA_VERSION",
    "OBS_COMPAT_VERSIONS",
    "ObsError",
    "ObsFormatError",
    "ObsSchemaError",
    "make_obs_header",
    "provenance",
    "config_hash",
    "PROVENANCE_KEYS",
    "render_report",
    "render_prometheus",
    "SPAN_KINDS",
    "TRACE_COARSE_LIMIT",
    "TraceSpan",
    "TraceTree",
    "spans_of",
    "build_trees",
    "emit_walk_window",
    "WindowCriticalPath",
    "critical_paths",
    "straggler_table",
    "render_critical",
]
