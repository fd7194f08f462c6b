"""Blockwise attention's entry point, the port of
``src/repro/kernels/block_attn/ops.py:16`` ``block_attention``."""
from __future__ import annotations

import torch

from repro_torch.kernels.block_attn.block_attn import block_attn
from repro_torch.kernels.block_attn.ref import block_attention_plain

__all__ = ["block_attention"]


def block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Lq, H, hd), k/v (B, Lk, KV, hd) with H % KV == 0 -> (B, Lq, H, hd),
    the reference's public layout. ``causal`` masks key j > query i by
    absolute index; ``window > 0`` also masks i - j >= window.

    A CUDA tensor launches the hand-written kernel, which reads K/V by group
    and masks ragged lengths itself (no repeat, no padding), or raises. A
    CPU tensor takes the plain version, and so does a meta tensor (shapes
    only, nothing computed: the dry run's count, ``launch/dryrun.py``); any
    other device is refused. The
    kernel's tiles (128 query rows, 64 keys) are its own: the reference's
    ``bq``/``bk`` and ``interpret`` have no counterpart."""
    if q.device.type == "cuda":
        return block_attn(q, k, v, causal=causal, window=window)
    if q.device.type not in ("cpu", "meta"):
        raise ValueError(f"block_attention takes CPU, CUDA or meta tensors, got {q.device}")
    return block_attention_plain(q, k, v, causal=causal, window=window)
