"""Public wrappers around the quantize kernels: the port of
``src/repro/kernels/quantize/ops.py``.

- :func:`stochastic_quantize` / :func:`stochastic_dequantize`: the int8 wire
  format ``(indices, s, norm)`` of one tensor (paper §IV-B), any shape;
- :func:`segment_quantize_dequantize`: the wire round trip of a
  multi-tensor payload laid out as (R, 128) rows with one wire tensor per
  segment of rows;
- :func:`payload_quantize_dequantize`: the same for a whole (B, d_pad) flat
  payload whose segments are the leaves of a ``FlatSpec``, the form the
  round engine calls.

Torch cannot replay ``jax.random``, so where the reference draws uniforms
from a key these take the uniforms themselves, or a ``torch.Generator``,
or (for the counter-RNG kernels) the two uint32 seed words
``key_data(key)[:2]``. The wrappers pad a payload only to whole 128-lane
rows: the reference's 512-row tile is the TPU's and is not copied.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quantize.quantize import (
    LANES,
    dequantize,
    qdq_delta_rows,
    qdq_delta_rows_rng,
    qdq_rows,
    qdq_rows_rng,
    quantize,
)

__all__ = [
    "stochastic_quantize",
    "stochastic_dequantize",
    "segment_side_info",
    "segment_quantize_dequantize",
    "payload_side_info",
    "payload_quantize_dequantize",
]


def _rows2d(flat: torch.Tensor) -> torch.Tensor:
    """A flat tensor as (R, 128) rows, zero-padded to a whole last row."""
    pad = (-flat.shape[0]) % LANES
    return torch.nn.functional.pad(flat, (0, pad)).reshape(-1, LANES)


def stochastic_quantize(w: torch.Tensor, u: torch.Tensor | None = None, *, s: float,
                        bits: int = 8, generator: torch.Generator | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``w`` (float32 or bfloat16, read as float32) to
    ``(int8 indices shaped like w, norm)`` on the fixed grid ``s``: the wire
    format is ``(indices, s, norm)``, 64 + bits*d bits (paper §IV-B).

    The stochastic-rounding uniforms are ``u`` (w's shape, float32), or are
    drawn from ``generator`` when ``u`` is None. ``norm`` is ``||w||`` as a
    0-dim float32 tensor on w's device; a torch sum, in another order than
    XLA's, so it may differ from the reference's by a few ulps."""
    if (u is None) == (generator is None):
        raise ValueError("pass exactly one of u / generator")
    flat = w.reshape(-1).to(torch.float32)
    norm = torch.sqrt(torch.sum(flat * flat))
    if u is None:
        u = torch.rand(flat.shape, generator=generator, dtype=torch.float32,
                       device=flat.device)
    elif u.shape != w.shape:
        raise ValueError(f"u must have w's shape {tuple(w.shape)}, got {tuple(u.shape)}")
    u2d = _rows2d(u.reshape(-1).to(torch.float32))
    q2d = quantize(_rows2d(flat), u2d, norm, s=s, bits=bits)
    return q2d.reshape(-1)[: flat.shape[0]].reshape(w.shape), norm


def stochastic_dequantize(q: torch.Tensor, norm: torch.Tensor, *, s: float,
                          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q * s * norm`` in ``out_dtype`` (float32 or bfloat16), q's shape."""
    flat = q.reshape(-1).to(torch.int8)
    norm = torch.as_tensor(norm, dtype=torch.float32, device=q.device)
    out2d = dequantize(_rows2d(flat), norm, s=s, out_dtype=out_dtype)
    return out2d.reshape(-1)[: flat.shape[0]].reshape(q.shape)


def segment_side_info(w_rows: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
                      *, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row ``(s_rows, norm_rows)`` of an (R, 128) payload whose row r
    belongs to wire tensor ``seg_ids[r]`` (in ``[0, num_segments)``): each
    segment's norm ``||w_seg||`` and adaptive grid ``s = max|w_v| /
    (||w_seg|| levels)``, repeated over its rows.

    The norm is the segment sum of the rows' sums of squares through
    ``index_put_(accumulate=True)``, which adds each segment's rows in row
    order on the CPU and on the card alike, so two runs give the same bits
    (an atomic ``index_add_`` on the card would not). The sums are taken in
    float64 and the norm rounded once to float32: a segment of a thousand
    rows summed in float32 drifts by ~10 ulps with the order of its row
    sums, which differs between the CPU and the card. The reference sums
    in float32, so the norm may differ from its by a few ulps. The segment
    max is exact in any order."""
    levels = max((1 << (bits - 1)) - 1, 1)
    wf = w_rows.to(torch.float32)
    seg = seg_ids.to(device=wf.device, dtype=torch.int64)
    sq = torch.zeros(num_segments, dtype=torch.float64, device=wf.device)
    sq.index_put_((seg,), torch.sum(wf * wf, dim=1, dtype=torch.float64), accumulate=True)
    norm_seg = torch.sqrt(sq).to(torch.float32)
    amax_seg = torch.full((num_segments,), float("-inf"), device=wf.device)
    amax_seg = amax_seg.scatter_reduce(0, seg, wf.abs().amax(dim=1), reduce="amax")
    safe = torch.where(norm_seg > 0, norm_seg, torch.ones_like(norm_seg))
    xmax = amax_seg / safe
    s_seg = torch.where(xmax > 0, xmax / levels, torch.ones_like(xmax))
    return s_seg[seg], norm_seg[seg]


def segment_quantize_dequantize(w_rows: torch.Tensor, u_rows: torch.Tensor | None,
                                seg_ids: torch.Tensor, num_segments: int, *, bits: int,
                                base_rows: torch.Tensor | None = None,
                                seed=None) -> torch.Tensor:
    """Fused wire round trip ``deq(Q(w))`` of one multi-tensor payload
    (Eq. 12/13), or ``base + deq(Q(w))`` with ``base_rows``, in one kernel
    call; a new float32 (R, 128) tensor.

    ``seg_ids`` (R,) assigns every row of ``w_rows`` to one wire tensor,
    whose side information :func:`segment_side_info` gives. The uniforms
    are ``u_rows`` (R, 128), or, with ``u_rows=None``, the counter hash
    salted by ``seed``, a pair of uint32 words."""
    if (u_rows is None) == (seed is None):
        raise ValueError("pass exactly one of u_rows / seed")
    if w_rows.dim() != 2 or w_rows.shape[1] != LANES:
        raise ValueError(f"w_rows must have shape (R, {LANES}), got {tuple(w_rows.shape)}")
    s_rows, norm_rows = segment_side_info(w_rows, seg_ids, num_segments, bits=bits)
    # The kernels write over their payload: hand them a copy.
    work = w_rows.to(torch.float32, copy=True)
    if u_rows is None:
        if base_rows is None:
            return qdq_rows_rng(work, seed, s_rows, norm_rows, bits=bits)
        return qdq_delta_rows_rng(work, base_rows, seed, s_rows, norm_rows, bits=bits)
    u = u_rows.to(torch.float32).contiguous()
    if base_rows is None:
        return qdq_rows(work, u, s_rows, norm_rows, bits=bits)
    return qdq_delta_rows(work, base_rows, u, s_rows, norm_rows, bits=bits)


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
