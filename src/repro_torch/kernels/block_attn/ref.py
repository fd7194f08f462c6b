"""The plain PyTorch version of the blockwise-attention kernel: a
materialized float32 softmax over the whole score matrix, as the JAX
package's oracle ``src/repro/kernels/block_attn/ref.py:13`` computes it.

It is the CPU path of :func:`repro_torch.kernels.block_attn.block_attention`
and the kernel's oracle on the card, never a fallback for a CUDA tensor.
"""
from __future__ import annotations

import math

import torch

__all__ = ["block_attention_plain", "attention_pairs", "attention_lse_plain"]


def _allowed(lq: int, lk: int, causal: bool, window: int, device) -> torch.Tensor:
    """(Lq, Lk) bool: which key j each query i may attend, by absolute
    index: j <= i when causal, and i - j < window when window > 0."""
    i = torch.arange(lq, device=device)[:, None]
    j = torch.arange(lk, device=device)[None, :]
    ok = torch.ones(lq, lk, dtype=torch.bool, device=device)
    if causal:
        ok &= j <= i
    if window > 0:
        ok &= (i - j) < window
    return ok


def block_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Lq, H, hd), k/v (B, Lk, KV, hd) with H % KV == 0, float32 ->
    o (B, Lq, H, hd).

    Head h reads KV head h // (H/KV), by a grouped einsum with no repeat.
    Scores are q.k multiplied by 1/sqrt(hd), as the kernel scales them.
    Masked scores are -inf before the softmax, so they weigh exactly 0; a
    row that may attend no key (only possible with a window or Lq > Lk)
    comes out 0, as in the kernel. Without a gradient to take, the softmax
    works in place on the one (B, KV, H/KV, Lq, Lk) score tensor; with one,
    the same operations run out of place, so autograd differentiates them
    (the CPU's training path, and the backward kernels' oracle)."""
    b, lq, h, hd = q.shape
    lk, kv = k.shape[1], k.shape[2]
    if h % kv:
        raise ValueError(f"heads {h} not divisible by KV heads {kv}")
    qg = q.float().reshape(b, lq, kv, h // kv, hd)
    s = torch.einsum("bqgrh,bkgh->bgrqk", qg, k.float())
    masked = ~_allowed(lq, lk, causal, window, q.device)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        s = (s * (1.0 / math.sqrt(hd))).masked_fill(masked, float("-inf"))
        m = s.detach().amax(dim=-1, keepdim=True)
        s = (s - torch.where(torch.isfinite(m), m, torch.zeros_like(m))).exp()
        s = s / s.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    else:
        s.mul_(1.0 / math.sqrt(hd))
        s.masked_fill_(masked, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        # A fully masked row has max -inf: subtract a finite number instead,
        # so its weights are exp(-inf) = 0 and not nan.
        s.sub_(torch.where(torch.isfinite(m), m, torch.zeros_like(m))).exp_()
        s.div_(s.sum(dim=-1, keepdim=True).clamp_min(1e-30))
    out = torch.einsum("bgrqk,bkgh->bqgrh", s, v.float())
    return out.reshape(b, lq, h, hd).to(q.dtype)


def attention_pairs(lq: int, lk: int, *, causal: bool = True, window: int = 0) -> int:
    """The number of (query, key) pairs the mask allows, per (batch, head):
    the work of the function, 4 * hd FLOP a pair (q.k and p.v)."""
    total = 0
    for i in range(lq):
        hi = min(i, lk - 1) if causal else lk - 1
        lo = max(0, i - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """Each row's natural log-sum-exp of its scaled, masked scores, (B, H,
    Lq) float32 (-inf for a row that attends no key): what the forward
    kernel writes for the backward pass."""
    b, lq, h, hd = q.shape
    lk, kv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, lq, kv, h // kv, hd)
    s = torch.einsum("bqgrh,bkgh->bgrqk", qg, k.float()) * (1.0 / math.sqrt(hd))
    s = s.masked_fill(~_allowed(lq, lk, causal, window, q.device), float("-inf"))
    return torch.logsumexp(s, dim=-1).reshape(b, h, lq)
