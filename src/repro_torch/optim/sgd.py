"""The paper's decreasing-step SGD schedule (the port of
``repro.optim.sgd.decreasing_lr``):

    eta^kbar = 1 / (R * kbar^q),  kbar = (t-1)K + k   (paper §VI-B, q=0.499)

which satisfies Assumption 2 for 1/2 < q < 1. The pod-scale optimizers
(momentum SGD, AdamW) come with the distribution slice (ROADMAP.md).
"""
from __future__ import annotations

import numpy as np

__all__ = ["decreasing_lr"]


def decreasing_lr(kbar: int, r: float = 5.0, q: float = 0.499) -> float:
    """eta^kbar = 1/(R * kbar^q); kbar counts global SGD steps from 1.

    Evaluated in float32 on the host, as the reference evaluates it in
    float32; returned as the exact Python value of that float32."""
    k = np.maximum(np.float32(kbar), np.float32(1.0))
    return float(np.float32(1.0) / (np.float32(r) * k ** np.float32(q)))
