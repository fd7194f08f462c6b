"""Plain PyTorch oracle of the fixed-interval quantize kernels (Eq. 12).

The port of ``repro.kernels.quantize.ref``: :func:`quantize_ref` and
:func:`dequantize_ref` compute what ``_quantize_kernel`` and
``_dequantize_kernel`` compute, for tensors of any shape, given the same
uniforms. They follow the reference as XLA compiles it on the CPU (inside
``jit``, the way every JAX path runs it), where the fixed grid interval
``s`` is a compile-time constant:

- ``x / s`` becomes ``x * rs`` with ``rs = float32(1) / float32(s)``, the
  reciprocal rounded once in float32 (:func:`reciprocal_f32`);
- ``q * s * norm`` becomes ``q * (s * norm)``, the constant folded into the
  scalar first.

Evaluated op by op (eagerly), the JAX oracle divides and multiplies in the
written order instead; the two forms give different indices on a few
percent of crafted inputs (``tests/test_torch_quantize_wire.py``).
"""
from __future__ import annotations

import torch

__all__ = ["quantize_ref", "dequantize_ref", "reciprocal_f32", "signed_index"]


def reciprocal_f32(s: float) -> float:
    """``float32(1) / float32(s)``, one IEEE float32 division: the constant
    XLA multiplies by where the reference divides by a fixed ``s``."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return float(one / torch.tensor(s, dtype=torch.float32))


def signed_index(w: torch.Tensor, u: torch.Tensor, s, norm, levels: int, *,
                 recip: bool = False) -> torch.Tensor:
    """``clip(floor(x/s) + [u < frac], 0, levels) * sign(w)`` as float32,
    with ``x = |w| / norm`` (norm 0 taken as 1). With ``recip``, ``s`` is
    the reciprocal and ``x/s`` is ``x*s``. ``s`` and ``norm`` broadcast
    against ``w``."""
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    x = w.abs() / safe
    q = x * s if recip else x / s
    ell = torch.floor(q)
    phi = q - ell
    idx = torch.clamp(ell + (u < phi).to(torch.float32), 0.0, float(levels))
    return idx * torch.sign(w)


def _scalar(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def quantize_ref(w: torch.Tensor, u: torch.Tensor, norm, *, s: float,
                 bits: int) -> torch.Tensor:
    """int8 ``idx * sign(w)`` of ``w`` (float32 or bfloat16, read as
    float32) on the grid ``s`` of ``|w| / norm``, rounding up where
    ``u < frac``."""
    wf = w.to(torch.float32)
    rs = _scalar(reciprocal_f32(s), wf.device)
    t = signed_index(wf, u, rs, _scalar(norm, wf.device), (1 << (bits - 1)) - 1,
                     recip=True)
    return t.to(torch.int8)


def dequantize_ref(q: torch.Tensor, norm, *, s: float,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q * (s * norm)`` in float32, rounded once to ``out_dtype``."""
    sn = _scalar(s, q.device) * _scalar(norm, q.device)
    return (q.to(torch.float32) * sn).to(out_dtype)
