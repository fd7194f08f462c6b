"""Adaptive per-round quantization control (paper §IV-B / Eq. 18, ROADMAP
"Adaptive quantization as a control loop").

The paper proves a *sufficient condition* for when quantizing the random-walk
wire traffic balances communication cost against convergence; the static
``QuantConfig.bits`` knob leaves picking the operating point to the user. In
the serverless DFedRW setting no coordinator can pick a global width either —
the signal that matters is *local*: how long a device's FIFO uplink spends
queueing (``UplinkStats``). This module closes that loop inside the
simulator: a **bits policy** is a callable the runner invokes once per
aggregation window, observing the previous window's uplink contention and
Eq. 18 comm accounting (:class:`BitsObs`) and returning the wire bit-width
for the next window.

Mechanics (see docs/SIMULATOR.md "Adaptive quantization"):

* the engine validates up front every width the policy may request
  (``DFedRW.prepare_bits``; the port runs eagerly and compiles no program
  per width) and ``DFedRW.programs_run`` lists the widths that ran;
* link pricing follows along: the runner swaps ``hop_bits`` (and the fleet
  engine its bucket width) per window from a precomputed
  ``segment_wire_bits`` table;
* policies are **stateless**: the controller position is ``obs.bits_prev``
  (the width the previous window ran at), so a replayed or re-run controller
  cannot drift — all state lives on the runner and resets with the timeline.

The width decision is per-round (one width per window, all chains): the
window's compute is ONE fixed-shape engine call at one wire width (one B1
launch a hop and one B2 launch for the aggregation), as in the reference,
whose table design trades a per-device width for zero-retrace dispatch. Per-device
control still happens through time: each round's width reacts to the fleet's
aggregate queueing, which is dominated by the busiest uplinks.

>>> obs = BitsObs(window=3, t=4.8, bits_prev=8, deadline_s=1.6,
...               queued_s=3.0, busy_s=1.0, sent=12, span_s=1.5,
...               comm_bits_window=2.1e6, comm_bits_total=8.0e6,
...               train_loss=0.4, gamma_hat=0.9)
>>> round(obs.queue_pressure, 3)                    # 3s waiting vs 1s sending
0.75
>>> AdaptiveBits()(obs)                             # congested: step down
6
>>> PinnedBits(8)(obs), PinnedBits(8).widths        # parity fence
(8, (8,))
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.quantization import validate_wire_bits

__all__ = [
    "DEFAULT_WIDTHS",
    "BitsObs",
    "BitsPolicy",
    "PinnedBits",
    "ScheduledBits",
    "AdaptiveBits",
]

# Widths an adaptive policy dispatches over by default: every width the fused
# qdq kernels support at power-of-two-ish spacing, plus the fp32 passthrough.
DEFAULT_WIDTHS = (2, 4, 6, 8, 32)


@dataclasses.dataclass(frozen=True)
class BitsObs:
    """What a bits policy sees at a window boundary: the PREVIOUS window's
    uplink contention and comm accounting (deltas, not lifetime totals),
    plus the monitoring signals the engine already computes. On window 0
    everything except ``bits_prev``/``deadline_s`` is zero/None — a policy
    must hold its position until it has observed a window."""

    window: int                   # index of the window about to run
    t: float                      # virtual clock at the trigger
    bits_prev: int                # width the previous window ran at
                                  # (window 0: the engine's static width)
    deadline_s: float | None      # aggregation trigger period
    queued_s: float               # uplink seconds spent WAITING last window
    busy_s: float                 # uplink seconds spent SENDING last window
    sent: int                     # uplink messages admitted last window
    span_s: float                 # first-start .. last-done span last window
    comm_bits_window: float       # Eq. 18 bits charged last window
    comm_bits_total: float        # lifetime Eq. 18 bits
    train_loss: float | None      # last window's monitoring loss
    gamma_hat: float | None       # last window's Lemma-1 gradient ratio

    @property
    def queue_pressure(self) -> float:
        """Fraction of last window's uplink activity spent waiting,
        queued / (queued + busy) in [0, 1]; 0 when the links were idle."""
        tot = self.queued_s + self.busy_s
        return self.queued_s / tot if tot > 0.0 else 0.0


class BitsPolicy:
    """Interface: ``widths`` (the dispatch table the engine validates)
    and ``__call__(obs) -> bits`` (one of ``widths``). Subclassing is
    optional — any object with that surface works."""

    widths: tuple = DEFAULT_WIDTHS

    def __call__(self, obs: BitsObs) -> int:  # pragma: no cover - interface
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class PinnedBits(BitsPolicy):
    """Constant-width policy: the regression fence proving the control loop
    adds nothing to the numerics — a run pinned at B is bit-exact vs the
    static ``bits=B`` run (tests/test_sim_adapt.py)."""

    bits: int = 8

    @property
    def widths(self) -> tuple:
        return (validate_wire_bits(self.bits),)

    def __call__(self, obs: BitsObs) -> int:
        return self.bits


@dataclasses.dataclass(frozen=True)
class ScheduledBits(BitsPolicy):
    """Scripted per-window widths (last entry repeats): the test harness for
    multi-width dispatch — cycling a schedule across the program table must
    leave ``DFedRW.programs_run`` at the DISTINCT widths."""

    schedule: tuple = (8,)

    @property
    def widths(self) -> tuple:
        return tuple(sorted({validate_wire_bits(b) for b in self.schedule}))

    def __call__(self, obs: BitsObs) -> int:
        return self.schedule[min(obs.window, len(self.schedule) - 1)]


@dataclasses.dataclass(frozen=True)
class AdaptiveBits(BitsPolicy):
    """Hysteresis controller on uplink queue pressure with an Eq. 18 budget
    clamp.

    Each window it moves at most one step along ``widths`` from its current
    position (``obs.bits_prev``):

    * ``queue_pressure >= step_down`` — the fleet's uplinks spend that
      fraction of their active time *waiting*; transfers are the bottleneck,
      so halve-ish the wire (one width down).
    * ``queue_pressure <= step_up`` — links are (nearly) contention-free;
      spend the idle bandwidth on fidelity (one width up).
    * ``budget_bits_per_window`` (Eq. 18 semantics: total bits charged to
      the fleet per aggregation window, i.e. sum over devices of
      64 + b*d per message) — exceeding it forces a step down and vetoes
      stepping up, regardless of pressure. None disables the clamp.

    The dead band between the thresholds plus the one-step-per-window rate
    limit is what keeps the loop from oscillating against the queue it is
    itself shaping.

    The defaults are tuned on ``congested_uplink`` (n=20, 2 Mb/s shared
    uplinks): sustained pressure there sits near 0.2 at 8 bits, so
    ``step_down=0.15`` rides the width down to 4 — matching static 8-bit
    accuracy at roughly half its Eq. 18 comm (BENCH_sim_engine.json,
    "sim_adaptive_bits"). Width 2 is deliberately NOT in the default table:
    at 2 bits the quantizer noise collapses convergence on that scenario
    (final acc 0.25 vs 0.87), and the controller has no accuracy signal
    fast enough to back out — opt in explicitly via ``widths``."""

    widths: tuple = (4, 6, 8)
    step_down: float = 0.15
    step_up: float = 0.05
    budget_bits_per_window: float | None = None

    def __post_init__(self):
        ws = tuple(sorted({validate_wire_bits(b) for b in self.widths}))
        if not ws:
            raise ValueError("AdaptiveBits needs at least one width")
        object.__setattr__(self, "widths", ws)
        if not 0.0 <= self.step_up < self.step_down <= 1.0:
            raise ValueError(
                f"need 0 <= step_up < step_down <= 1, got "
                f"step_up={self.step_up} step_down={self.step_down}")

    def _position(self, bits_prev: int) -> int:
        """Index of the largest width <= bits_prev (the controller's current
        rung; a base width above the table clamps to the top)."""
        pos = 0
        for i, w in enumerate(self.widths):
            if w <= bits_prev:
                pos = i
        return pos

    def __call__(self, obs: BitsObs) -> int:
        pos = self._position(obs.bits_prev)
        if obs.window == 0:
            return self.widths[pos]      # nothing observed yet: hold
        over = (self.budget_bits_per_window is not None
                and obs.comm_bits_window > self.budget_bits_per_window)
        p = obs.queue_pressure
        if over or p >= self.step_down:
            pos -= 1
        elif p <= self.step_up:
            pos += 1
        return self.widths[max(0, min(pos, len(self.widths) - 1))]
