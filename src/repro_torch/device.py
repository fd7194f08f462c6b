"""The one place the port turns a ``device`` argument into a torch device,
and the one place it sets the card's float32 precision.

Every entry point takes ``device="cuda"`` by default. Without a card that
raises: the port never carries on, on the CPU, unless the caller asks for
it with ``device="cpu"`` (as the tests do).

Float32 is full float32, as the JAX package computes it: TF32 is switched
off for matrix products and for cuDNN once, when this module is imported
(the round engine and the LM model import it first). A bf16 matrix product
sums in float32 to the end, as XLA's does: cuBLAS may otherwise reduce the
partial sums of a split-K product in bf16.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port's "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
