"""The paper's image-classification models (§VI-A), the port of
``repro.models.fnn``:

- 2FNN: 784 -> 100 -> 10, ReLU hidden, log-softmax output.
- 3FNN: 784 -> 200 -> 200 -> 10.

Plain functions on tensors: params is a list of (W, b), W of shape
(in, out) as in the reference, so weights carry across unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch

__all__ = ["SmallModel", "make_fnn"]


@dataclasses.dataclass(frozen=True)
class SmallModel:
    name: str
    init: Callable[..., list]                                  # (generator, device)
    loss_fn: Callable[[list, tuple], torch.Tensor]             # (params, (x, y)) -> scalar
    predict: Callable[[list, torch.Tensor], torch.Tensor]      # logits


def make_fnn(hidden: Sequence[int] = (100,), in_dim: int = 784, out_dim: int = 10) -> SmallModel:
    dims = [in_dim, *hidden, out_dim]

    def init(generator: torch.Generator, device: torch.device | str) -> list:
        """He-normal weights drawn on the CPU from ``generator`` (so a seed
        gives the same weights on every device), zero biases."""
        params = []
        for i in range(len(dims) - 1):
            w = torch.randn(dims[i], dims[i + 1], generator=generator,
                            dtype=torch.float32) * math.sqrt(2.0 / dims[i])
            params.append((w.to(device),
                           torch.zeros(dims[i + 1], dtype=torch.float32, device=device)))
        return params

    def predict(params: list, x: torch.Tensor) -> torch.Tensor:
        h = x.reshape(x.shape[0], -1)
        for i, (w, b) in enumerate(params):
            h = h @ w + b
            if i < len(params) - 1:
                h = torch.relu(h)
        return h

    def loss_fn(params: list, batch: tuple) -> torch.Tensor:
        x, y = batch
        logp = torch.log_softmax(predict(params, x), dim=-1)
        return -torch.gather(logp, -1, y[:, None]).mean()

    name = f"fnn{len(hidden) + 1}_{'x'.join(map(str, hidden))}"
    return SmallModel(name=name, init=init, loss_fn=loss_fn, predict=predict)
