"""Per-request TTFT/TPOT and engine throughput counters.

TTFT is measured from the moment a request became *eligible* (its arrival
step was reached — queueing delay included) to its first sampled token;
TPOT is the mean inter-token time over the remaining generated tokens.
Engine counters track how the work was batched: prefill chunks vs decode
steps vs idle steps, prompt tokens written and tokens generated.

The port of ``repro.serve.metrics``. The counters live on a shared
:class:`repro_torch.obs.Recorder` (``serve/*`` series) so a ``--obs`` run exports
them alongside per-step spans — but the surface and semantics here are
unchanged: attribute reads/``+=`` writes work as before (each
``EngineMetrics`` reads its counters relative to a construction-time
baseline, so ``ServeEngine.reset()`` still zeroes them while the recorder's
totals stay monotone), and the active-time clock is bit-for-bit the old
arithmetic — ``now() = perf_counter() - pause_total`` with ``note_pause``
crediting deliberate pauses (e.g. a benchmark sleeping off a CPU quota) —
now provided by :class:`repro_torch.obs.PausableWallClock`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.obs import PausableWallClock, Recorder

__all__ = ["RequestMetrics", "EngineMetrics"]


@dataclasses.dataclass
class RequestMetrics:
    rid: int
    prompt_len: int = 0
    n_generated: int = 0
    arrival_step: int = 0
    admit_step: int = -1
    finish_step: int = -1
    eligible_wall: float = 0.0
    first_token_wall: float = 0.0
    finish_wall: float = 0.0

    @property
    def ttft_s(self) -> float:
        return self.first_token_wall - self.eligible_wall

    @property
    def tpot_s(self) -> float:
        return (self.finish_wall - self.first_token_wall) / max(self.n_generated - 1, 1)


def _counter(name: str):
    """Attribute-style view of one ``serve/<name>`` recorder series,
    baseline-relative so a fresh EngineMetrics starts at 0 on a shared
    recorder. Supports the engine's ``metrics.x += n`` increments (monotone:
    counters never decrease within one EngineMetrics lifetime)."""
    key = f"serve/{name}"

    def get(self) -> int:
        return int(self._rec.value(key) - self._base[name])

    def set_(self, value) -> None:
        delta = value - (self._rec.value(key) - self._base[name])
        if delta < 0:
            raise ValueError(f"{name} is a monotone counter (got -{-delta})")
        if delta:
            self._rec.counter(key, delta)

    return property(get, set_)


class EngineMetrics:
    """Aggregates request records + engine step counters.

    ``recorder`` (optional) shares a ``repro_torch.obs.Recorder``: counters land
    there as ``serve/*`` series and finished requests feed the
    ``serve/ttft_s``/``serve/tpot_s`` histograms. Default is a private
    recorder on a fresh :class:`repro_torch.obs.PausableWallClock` — exactly the
    standalone behavior this class always had."""

    _COUNTERS = ("engine_steps", "prefill_chunks", "decode_steps",
                 "idle_steps", "prompt_tokens", "piggyback_tokens",
                 "generated_tokens")

    engine_steps = _counter("engine_steps")
    prefill_chunks = _counter("prefill_chunks")
    decode_steps = _counter("decode_steps")
    idle_steps = _counter("idle_steps")
    prompt_tokens = _counter("prompt_tokens")
    piggyback_tokens = _counter("piggyback_tokens")   # prompt tokens streamed
    generated_tokens = _counter("generated_tokens")   # via decode steps

    def __init__(self, recorder: Recorder | None = None):
        self.requests: dict[int, RequestMetrics] = {}
        self._rec = recorder if recorder is not None else Recorder(
            clock=PausableWallClock())
        # active-time clock: the recorder's, unless its clock can't credit
        # pauses (e.g. a shared VirtualClock would be nonsensical here)
        clk = self._rec.clock
        self._clock = clk if hasattr(clk, "note_pause") else PausableWallClock()
        self._base = {n: self._rec.value(f"serve/{n}") for n in self._COUNTERS}
        self._t0 = self.now()
        self._t_last = self._t0

    def now(self) -> float:
        """Active-time clock: wall time minus credited pauses."""
        return self._clock.now()

    def note_pause(self, dt: float) -> None:
        """Credit a deliberate pause (e.g. a benchmark sleeping off a CPU
        quota) so throughput/latency reflect active time only."""
        self._clock.note_pause(dt)

    def observe_request(self, rm: RequestMetrics) -> None:
        """Feed a finished request's latencies into the shared recorder."""
        self._rec.counter("serve/requests_finished")
        self._rec.histogram("serve/ttft_s", rm.ttft_s)
        self._rec.histogram("serve/tpot_s", rm.tpot_s)

    def start(self) -> None:
        self._t0 = self.now()
        self._t_last = self._t0

    def touch(self) -> None:
        self._t_last = self.now()

    @property
    def wall_s(self) -> float:
        return self._t_last - self._t0

    def summary(self) -> dict:
        done = [m for m in self.requests.values() if m.finish_wall > 0]
        wall = max(self.wall_s, 1e-9)
        return {
            "requests_finished": len(done),
            "engine_steps": self.engine_steps,
            "prefill_chunks": self.prefill_chunks,
            "decode_steps": self.decode_steps,
            "idle_steps": self.idle_steps,
            "prompt_tokens": self.prompt_tokens,
            "piggyback_tokens": self.piggyback_tokens,
            "generated_tokens": self.generated_tokens,
            "wall_s": wall,
            "tok_s": self.generated_tokens / wall,
            "total_tok_s": (self.prompt_tokens + self.generated_tokens) / wall,
            "mean_ttft_s": float(np.mean([m.ttft_s for m in done])) if done else 0.0,
            "p50_ttft_s": float(np.median([m.ttft_s for m in done])) if done else 0.0,
            "mean_tpot_s": float(np.mean([m.tpot_s for m in done])) if done else 0.0,
        }
