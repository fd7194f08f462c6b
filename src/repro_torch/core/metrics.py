"""Shared experiment loop, history records and the latency model of the
paper's Table IV (the port of ``repro.core.metrics``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["History", "train_loop", "latency_fedavg", "latency_dfedrw"]


@dataclasses.dataclass
class History:
    rounds: list = dataclasses.field(default_factory=list)
    train_loss: list = dataclasses.field(default_factory=list)
    test_accuracy: list = dataclasses.field(default_factory=list)
    test_loss: list = dataclasses.field(default_factory=list)
    comm_bits: list = dataclasses.field(default_factory=list)
    comm_bits_busiest: list = dataclasses.field(default_factory=list)
    gamma_hat: list = dataclasses.field(default_factory=list)

    def record(self, metrics, evald: dict, state) -> None:
        self.rounds.append(metrics.round)
        self.train_loss.append(metrics.train_loss)
        self.test_accuracy.append(evald["accuracy"])
        self.test_loss.append(evald["loss"])
        self.comm_bits.append(state.comm_bits_total)
        self.comm_bits_busiest.append(state.comm_bits_busiest)
        self.gamma_hat.append(metrics.gamma_hat)

    def final(self) -> dict:
        return {
            "rounds": self.rounds[-1] if self.rounds else 0,
            "accuracy": self.test_accuracy[-1] if self.test_accuracy else 0.0,
            "best_accuracy": max(self.test_accuracy, default=0.0),
            "comm_mb_busiest": (self.comm_bits_busiest[-1] / 8e6) if self.comm_bits_busiest else 0.0,
        }


def train_loop(
    runner: Any,
    rounds: int,
    x_test: np.ndarray,
    y_test: np.ndarray,
    seed: int = 0,
    eval_every: int = 1,
    callback: Callable | None = None,
) -> History:
    """Initialize from ``seed`` and run ``rounds`` rounds, evaluating every
    ``eval_every`` rounds and after the last. One ``torch.Generator`` seeded
    with ``seed`` draws the initial weights and every round's quantizer
    seed words, in order."""
    key = torch.Generator().manual_seed(seed)
    state = runner.init_state(key)
    hist = History()
    for r in range(rounds):
        state, metrics = runner.run_round(state, key)
        if (r + 1) % eval_every == 0 or r == rounds - 1:
            evald = runner.evaluate(state, x_test, y_test)
            hist.record(metrics, evald, state)
            if callback is not None:
                callback(r, metrics, evald)
    return hist


def latency_fedavg(k_epochs: int, t_p: float, t_c: float) -> float:
    """Table IV: T_A = K*T_p + 2*T_c per round."""
    return k_epochs * t_p + 2.0 * t_c


def latency_dfedrw(k_epochs: int, t_p: float, t_c: float) -> float:
    """Table IV: T_R = K*T_p + (K+1)*T_c per round (walk hand-offs serialize)."""
    return k_epochs * t_p + (k_epochs + 1.0) * t_c
