"""Request lifecycle and FCFS admission for the continuous-batching engine.

A `Request` is what callers submit; a `RequestState` is a request bound to
an engine slot, tracking prefill progress and generated tokens. The
`FCFSScheduler` holds the waiting queue: requests become *eligible* once
the engine reaches their `arrival_step` (logical arrivals keep synthetic
workloads and tests deterministic) and are admitted strictly in submission
order as slots free up. A copy of ``repro.serve.scheduler`` (numpy only).
"""
from __future__ import annotations

import dataclasses
import enum
import time
from collections import deque
from typing import Sequence

import numpy as np

__all__ = ["Request", "RequestState", "Phase", "FCFSScheduler", "stop_reason"]


class Phase(enum.Enum):
    PREFILL = "prefill"   # prompt tokens still being written into the cache
    DECODE = "decode"     # autoregressive generation
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    """One inference request. `arrival_step` gates admission (the engine's
    logical clock); `eos_id < 0` disables the EOS stop; `temperature <= 0`
    is greedy; `embeds` carries the frontend (encoder) embeddings
    `(frontend_tokens, d_model)` that enc-dec architectures require."""

    rid: int
    prompt: np.ndarray                 # (L,) int token ids, L >= 1
    max_tokens: int = 32
    eos_id: int = -1
    temperature: float = 0.0
    arrival_step: int = 0
    embeds: np.ndarray | None = None   # enc-dec frontends only

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_tokens < 1:
            raise ValueError(f"request {self.rid}: max_tokens must be >= 1")


@dataclasses.dataclass
class RequestState:
    """A request bound to slot `slot` of the engine's cache."""

    request: Request
    slot: int
    prompt_done: int = 0
    generated: list = dataclasses.field(default_factory=list)
    phase: Phase = Phase.PREFILL
    stop: str = ""                     # "eos" | "max_tokens" once finished

    @property
    def prompt_remaining(self) -> int:
        return len(self.request.prompt) - self.prompt_done


def stop_reason(req: Request, generated: Sequence[int]) -> str:
    """Stop condition after appending the latest token ('' = keep going)."""
    if req.eos_id >= 0 and generated and generated[-1] == req.eos_id:
        return "eos"
    if len(generated) >= req.max_tokens:
        return "max_tokens"
    return ""


class FCFSScheduler:
    """First-come-first-served admission over a waiting deque.

    Also stamps each request's *eligible* wall time (when its arrival step
    was first reached) so queueing delay counts toward TTFT even when all
    slots are busy."""

    def __init__(self):
        self._waiting: deque[Request] = deque()
        self.eligible_wall: dict[int, float] = {}

    def submit(self, req: Request) -> None:
        self._waiting.append(req)

    def __len__(self) -> int:
        return len(self._waiting)

    def next_arrival(self) -> int | None:
        """Earliest arrival step among waiting requests (None if empty)."""
        return min((r.arrival_step for r in self._waiting), default=None)

    def admit(self, free_slots: Sequence[int], now_step: int,
              wall_now: float | None = None) -> list[RequestState]:
        """Bind eligible requests to free slots, FCFS. Never reorders: a
        not-yet-arrived request at the queue head blocks later arrivals
        (strict FCFS is the paper-baseline policy; smarter policies slot in
        here). ``wall_now`` lets the engine stamp eligibility on its
        active-time clock."""
        now = time.perf_counter() if wall_now is None else wall_now
        for r in self._waiting:
            if r.arrival_step <= now_step:
                self.eligible_wall.setdefault(r.rid, now)
        admitted: list[RequestState] = []
        free = list(free_slots)
        while free and self._waiting and self._waiting[0].arrival_step <= now_step:
            req = self._waiting.popleft()
            admitted.append(RequestState(request=req, slot=free.pop(0)))
        return admitted
