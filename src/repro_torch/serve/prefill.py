"""Host-side chunk planning for the batched prefill step.

The device side is `repro_torch.models.transformer.prefill_chunk` (built
through `repro_torch.dist.steps.make_prefill_step`): a fixed-shape (B, C) call
that advances every prefilling slot by up to C prompt tokens, writing
k/v (or recurrent state) at each slot's own offset. This module packs the
ragged per-slot "next chunk of my prompt" views into that fixed buffer, so
one fixed-shape prefill call serves however prompts arrive, progress, or
retire. A copy of ``repro.serve.prefill`` (numpy only).
"""
from __future__ import annotations

from typing import Iterable

import numpy as np

from repro_torch.serve.scheduler import Phase, RequestState

__all__ = ["plan_chunk"]


def plan_chunk(states: Iterable[RequestState], batch: int, chunk: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """Pack the next prompt chunk of every PREFILL-phase state.

    Returns (tokens (batch, chunk) int32 right-padded with 0,
    n_valid (batch,) int32) — rows not in prefill get n_valid 0, which the
    device step treats as "leave this slot's cache untouched" (decoding
    neighbours and free slots ride along at zero semantic cost)."""
    tokens = np.zeros((batch, chunk), np.int32)
    n_valid = np.zeros((batch,), np.int32)
    for st in states:
        if st.phase is not Phase.PREFILL:
            continue
        m = min(chunk, st.prompt_remaining)
        if m <= 0:
            continue
        n_valid[st.slot] = m
        tokens[st.slot, :m] = st.request.prompt[st.prompt_done:st.prompt_done + m]
    return tokens, n_valid
