"""The whole-payload wire round trip around the fused qdq kernels (the port of
``payload_quantize_dequantize``, ``src/repro/kernels/quantize/ops.py:60``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quantize.quantize import (
    LANES,
    qdq_delta_rows_rng,
    qdq_rows_rng,
)

__all__ = ["payload_side_info", "payload_quantize_dequantize"]


def payload_side_info(payload: torch.Tensor, layout, *, per_message: bool,
                      bits: int, s: float | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row ``(s_rows, norm_rows)`` of a (B, d_pad) payload: each wire
    tensor's (s, ||w||) header, repeated over its 128-lane rows.

    Wire tensors are the per-leaf column blocks of ``layout`` (a
    ``FlatSpec``), either per message row (``per_message=True``, Eq. 14) or
    spanning all B rows (Eq. 13). ``s=None`` takes the adaptive grid
    s = max|w_v| / (||w_seg|| levels). Plain torch reductions, as the
    reference leaves them to XLA; their summation order differs, so a norm
    may differ from the reference's by a few ulps."""
    b, d_pad = payload.shape
    if d_pad != layout.d_pad:
        raise ValueError(f"payload width {d_pad} != layout d_pad {layout.d_pad}")
    levels = max((1 << (bits - 1)) - 1, 1)
    s_parts, n_parts = [], []
    for off, psize in zip(layout.offsets, layout.padded_sizes):
        blk = payload[:, off:off + psize]
        rows_l = psize // LANES
        if per_message:
            norm = torch.sqrt(torch.sum(blk * blk, dim=1))        # (B,)
            amax = blk.abs().amax(dim=1)
        else:
            norm = torch.sqrt(torch.sum(blk * blk)).expand(b)
            amax = blk.abs().amax().expand(b)
        if s is None:
            safe = torch.where(norm > 0, norm, torch.ones_like(norm))
            xmax = amax / safe
            s_leaf = torch.where(xmax > 0, xmax / levels, torch.ones_like(xmax))
        else:
            s_leaf = torch.full((b,), s, dtype=torch.float32, device=payload.device)
        s_parts.append(s_leaf[:, None].expand(b, rows_l))
        n_parts.append(norm[:, None].expand(b, rows_l))
    rows = b * layout.rows
    return (torch.cat(s_parts, dim=1).reshape(rows),
            torch.cat(n_parts, dim=1).reshape(rows))


def payload_quantize_dequantize(payload: torch.Tensor, layout, *,
                                per_message: bool, bits: int, seed,
                                s: float | None = None,
                                base: torch.Tensor | None = None) -> torch.Tensor:
    """Eq. 12/13/14 wire round trip for a whole (B, d_pad) float32 payload
    in ONE fused kernel call: ``deq(Q(payload))``, or ``base + deq(Q(payload))``
    with ``base`` (the receiver's reconstruction, fused into the same pass).

    ``seed`` is the pair of uint32 words salting the kernel's counter RNG
    (the reference derives them as ``key_data(key)[:2]``). The payload is a
    temporary the caller hands over: on the card the result is written over
    it."""
    s_rows, norm_rows = payload_side_info(payload, layout,
                                          per_message=per_message, bits=bits, s=s)
    b, d_pad = payload.shape
    w2d = payload.reshape(b * layout.rows, LANES)
    if base is None:
        out = qdq_rows_rng(w2d, seed, s_rows, norm_rows, bits=bits)
    else:
        out = qdq_delta_rows_rng(w2d, base.reshape(w2d.shape), seed, s_rows,
                                 norm_rows, bits=bits)
    return out.reshape(b, d_pad)
