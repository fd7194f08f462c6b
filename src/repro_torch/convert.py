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


def _leaf(a: np.ndarray) -> torch.Tensor:
    """A numpy array -> a CPU tensor of its dtype, on a copy of its data. A
    bfloat16 array (the ``ml_dtypes`` type that ``np.asarray`` of a JAX
    bf16 array has, which torch does not take) goes through its uint16
    view: bit for bit."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def lm_params_from_numpy(tree, device: str | torch.device = "cuda"):
    """A language model's nested dict/list/tuple of numpy arrays (a JAX
    ``init_params`` or LSTM ``init`` pytree after
    ``jax.tree_util.tree_map(np.asarray, ...)``) -> the same nesting, each
    list and tuple as it was, of tensors on ``device``, each leaf in its
    own dtype (a bf16 tree's float32 leaves, ``A_log``, ``D``, ``dt_bias``
    and a MoE ``router``, stay float32)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return _leaf(np.asarray(node)).to(dev)

    return conv(tree)
