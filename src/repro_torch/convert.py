"""Weights carried across from numpy (e.g. a JAX package's ``model.init`` or
device matrix, converted with ``np.asarray``) into the port's tensors."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["params_from_numpy", "flat_from_numpy", "lm_params_from_numpy"]


def params_from_numpy(params, device: str | torch.device = "cuda") -> list:
    """A list of (W, b) numpy arrays -> a list of (W, b) float32 tensors."""
    dev = resolve_device(device)
    return [tuple(torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)
                  for a in pair) for pair in params]


def flat_from_numpy(matrix, device: str | torch.device = "cuda") -> torch.Tensor:
    """An (n, d_pad) device matrix -> a float32 tensor on ``device``."""
    return torch.tensor(np.asarray(matrix), dtype=torch.float32,
                        device=resolve_device(device))


def lm_params_from_numpy(tree, device: str | torch.device = "cuda"):
    """A language model's nested dict/list/tuple of numpy arrays (a JAX
    ``init_params`` or LSTM ``init`` pytree after
    ``jax.tree_util.tree_map(np.asarray, ...)``) -> the same nesting, each
    list and tuple as it was, of float32 tensors on ``device``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return torch.tensor(np.asarray(node), dtype=torch.float32, device=dev)

    return conv(tree)
