"""The paper's language model (§VI-F), the port of ``repro.models.lstm_lm``:
embedding -> 2-layer LSTM -> FC over the vocabulary; the loss is the last
time step's next-word prediction; AccuracyTop1 metric.

Plain functions on tensors with the reference's layout, so weights carry
across unchanged (``repro_torch.convert.lm_params_from_numpy``): params is
``{"cells": [(wx, wh, b), ...], "embed": (V, E), "out_b": (V,),
"out_w": (H, V)}``, a cell's gates are i, f, g, o of ``x@wx + h@wh + b``,
and the forget gate is ``sigmoid(f + 1)``, a bias ``torch.nn.LSTM`` does
not have. The recurrence is a Python loop of tensor ops, not cuDNN's RNN,
so the round engine can take per-chain gradients of it under
``torch.func.vmap(torch.func.grad(...))``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.fnn import SmallModel

__all__ = ["make_lstm_lm"]


def _lstm_layer(cell, x: torch.Tensor) -> torch.Tensor:
    """One LSTM layer over x (B, T, d_in) -> hidden states (B, T, H)."""
    wx, wh, b = cell
    bsz, steps, _ = x.shape
    hidden = wh.shape[0]
    h = x.new_zeros(bsz, hidden)
    c = x.new_zeros(bsz, hidden)
    xw = x @ wx                     # every step's input product at once
    hs = []
    for t in range(steps):
        z = xw[:, t] + h @ wh + b
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def make_lstm_lm(vocab: int = 1000, embed: int = 128, hidden: int = 256,
                 layers: int = 2) -> SmallModel:
    def init(generator: torch.Generator, device: torch.device | str) -> dict:
        """The reference's scales, drawn on the CPU from ``generator`` (so a
        seed gives the same weights on every device): N(0, 0.1²) embedding
        and head, N(0, 1/d_in) and N(0, 1/H) cell weights, zero biases."""
        def normal(*shape, scale):
            w = torch.randn(*shape, generator=generator, dtype=torch.float32) * scale
            return w.to(device)

        params = {
            "embed": normal(vocab, embed, scale=0.1),
            "out_w": normal(hidden, vocab, scale=0.1),
            "out_b": torch.zeros(vocab, dtype=torch.float32, device=device),
            "cells": [],
        }
        d_in = embed
        for _ in range(layers):
            params["cells"].append((
                normal(d_in, 4 * hidden, scale=math.sqrt(1.0 / d_in)),
                normal(hidden, 4 * hidden, scale=math.sqrt(1.0 / hidden)),
                torch.zeros(4 * hidden, dtype=torch.float32, device=device),
            ))
            d_in = hidden
        return params

    def predict(params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, T) -> next-word logits (B, V) after the last step."""
        h = params["embed"][tokens.long()]                  # (B, T, E)
        for cell in params["cells"]:
            h = _lstm_layer(cell, h)
        return h[:, -1] @ params["out_w"] + params["out_b"]

    def loss_fn(params: dict, batch: tuple) -> torch.Tensor:
        tokens, next_tokens = batch
        target = next_tokens[:, -1] if next_tokens.dim() > 1 else next_tokens
        logp = torch.log_softmax(predict(params, tokens), dim=-1)
        return -torch.gather(logp, -1, target.long()[:, None]).mean()

    return SmallModel(name=f"lstm{layers}_{hidden}", init=init, loss_fn=loss_fn,
                      predict=predict)
