"""repro_torch.sim: discrete-event asynchronous DFedRW simulator.

The port of ``repro.sim``. Virtual wall-clock device/link models + churn
over the port's flat round engine: the event loop (events.py) schedules
walk hops and local SGD steps on a virtual clock, deadlines truncate
in-flight walks into the paper's partial-update aggregation — or, under
``policy="overlap"``, let chains span multiple triggers through a
persistent event queue — and all compute replays through the synchronous
flat engine in one engine call per deadline window (K hop kernels and one
aggregation kernel on the card at bits < 32). Shared-uplink contention
(events.UplinkQueue via links.LinkModel) serializes concurrent transfers;
trace.py records runs as versioned JSONL timelines (the reference's schema)
that replay bit-exactly. scenarios.py is the registry the launcher
(repro_torch.launch.sim) and the tests share.

Two timeline engines share this window protocol: the per-event heap loop
(runner.py, the bit-exact oracle) and the vectorized fleet backend
(fleet.py, ``SimConfig(engine="fleet")``). Both are numpy copies of the
reference's, bit-identical timelines.

The trace's deployment export (``WindowSchedule``, ``SimTrace.schedule``,
``SimTrace.gossip_flags``) is here: the flags drive the scheduled federated
step of ``repro_torch.dist``, and the schedule drives the live executor
(metal.py: ``MetalReplay``, ``FaultInjector``, the ``Exchange`` seam and
``conformance_diff``; ``repro_torch.launch.replay`` is its CLI).
"""
from repro_torch.sim.adapt import (
    DEFAULT_WIDTHS,
    AdaptiveBits,
    BitsObs,
    BitsPolicy,
    PinnedBits,
    ScheduledBits,
)
from repro_torch.sim.devices import DeviceFleet, DeviceModelConfig
from repro_torch.sim.events import Event, EventQueue, UplinkQueue, UplinkStats
from repro_torch.sim.fleet import FleetDFedRW
from repro_torch.sim.hierarchy import HierarchicalLinkModel, HierLinkConfig
from repro_torch.sim.links import (
    LinkModel, LinkModelConfig, make_link_model, segment_wire_bits,
    segment_wire_bits_table)
from repro_torch.sim.metal import (
    CHAIN_SLICE_TOL,
    Exchange,
    FaultInjector,
    LocalExchange,
    MetalConformanceError,
    MetalReplay,
    MetalResult,
    conformance_diff,
    position_seeds,
    positions_for,
    smallest_block,
)
from repro_torch.sim.runner import AsyncDFedRW, SimConfig, SimResult, SimRoundRecord
from repro_torch.sim.scenarios import (
    SCENARIOS,
    SimScenario,
    SimSetup,
    build_scenario,
    get_scenario,
    list_scenarios,
    partitioned_topology,
    register_scenario,
)
from repro_torch.sim.trace import (
    TRACE_COMPAT_VERSIONS,
    TRACE_SCHEMA,
    TRACE_SCHEMA_VERSION,
    SimTrace,
    TraceError,
    TraceFormatError,
    TraceIntegrityError,
    TraceSchemaError,
    WindowSchedule,
    WindowTrace,
)

__all__ = [
    "Event", "EventQueue", "UplinkQueue", "UplinkStats",
    "DeviceFleet", "DeviceModelConfig",
    "LinkModel", "LinkModelConfig", "segment_wire_bits",
    "segment_wire_bits_table", "make_link_model",
    "HierLinkConfig", "HierarchicalLinkModel",
    "AsyncDFedRW", "SimConfig", "SimResult", "SimRoundRecord", "FleetDFedRW",
    "DEFAULT_WIDTHS", "BitsObs", "BitsPolicy", "PinnedBits", "ScheduledBits",
    "AdaptiveBits",
    "SCENARIOS", "SimScenario", "SimSetup", "build_scenario", "get_scenario",
    "list_scenarios", "partitioned_topology", "register_scenario",
    "TRACE_SCHEMA", "TRACE_SCHEMA_VERSION", "TRACE_COMPAT_VERSIONS",
    "SimTrace", "WindowTrace", "WindowSchedule",
    "TraceError", "TraceFormatError", "TraceSchemaError",
    "TraceIntegrityError",
    "Exchange", "LocalExchange", "FaultInjector", "MetalConformanceError",
    "MetalReplay", "MetalResult", "conformance_diff", "position_seeds",
    "positions_for", "smallest_block", "CHAIN_SLICE_TOL",
]
