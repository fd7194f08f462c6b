"""Continuous-batching inference over the slot-based ring-buffer cache, the
port of ``repro.serve``.

A slot-based engine that admits and retires requests per decode step over
the ring-buffer decode cache (`engine.ServeEngine`), a chunked batched
prefill planner that writes straight into the decode cache layout
(`prefill`), FCFS admission with per-request stop conditions
(`scheduler`), and TTFT/TPOT/throughput accounting (`metrics`). One
device, float32; on the card unless ``device="cpu"`` is given.
"""
from repro_torch.serve.engine import EngineConfig, ServeEngine
from repro_torch.serve.metrics import EngineMetrics, RequestMetrics
from repro_torch.serve.scheduler import FCFSScheduler, Phase, Request, RequestState

__all__ = [
    "EngineConfig",
    "ServeEngine",
    "EngineMetrics",
    "RequestMetrics",
    "FCFSScheduler",
    "Phase",
    "Request",
    "RequestState",
]
