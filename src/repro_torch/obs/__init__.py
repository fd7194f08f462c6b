"""repro_torch.obs — telemetry for the port's round engine and simulator.

The port's copy of ``repro.obs``: one ``Recorder`` (counters / gauges /
histograms / spans) over a pluggable clock, streams serialized as versioned
JSONL (``ObsStream``, the same schema and version, so the JAX package's
``ObsStream``, ``tools/obs_report.py`` and ``tools/obs_diff.py`` read the
port's streams) with a provenance header, and the causal span trees of the
simulator's ``--trace``. The renderers (``report.py``, ``critical.py``) are
not ported yet (ROADMAP.md A9).

Quickstart::

    from repro_torch.obs import Recorder, VirtualClock, provenance
    rec = Recorder(clock=VirtualClock())
    runner.attach_obs(rec)            # AsyncDFedRW / FleetDFedRW / DFedRW
    runner.run(rounds, gen, x_test, y_test)
    rec.save("obs.jsonl", provenance=provenance())
"""
from .provenance import PROVENANCE_KEYS, config_hash, provenance
from .recorder import (HIST_RESERVOIR, PausableWallClock, Recorder,
                       VirtualClock, WallClock, quantile_line, torch_profile)
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
    "SPAN_KINDS",
    "TRACE_COARSE_LIMIT",
    "TraceSpan",
    "TraceTree",
    "spans_of",
    "build_trees",
    "emit_walk_window",
]
