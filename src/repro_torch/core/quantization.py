"""Stochastic quantization for communication (paper §IV-B, Eq. 12, Lemma 3).

The port of ``repro.core.quantization``: the per-leaf Eq. 12 oracle and the
wire-cost accounting. Quantizes the *normalized* components |w_v|/||w||
onto the grid {0, s, 2s, ..., (2^{b-1}-1) s} by unbiased stochastic
rounding; one bit of b is the sign. The wire format for a d-vector is
(Lambda, s, ||w||): b*d bits of indices+signs plus 32+32 bits of side
information, i.e. (64 + b*d) bits versus 32*d unquantized.

Torch cannot reproduce ``jax.random`` streams, so :func:`quantize` takes
its stochastic-rounding uniforms as an argument; handed the reference's
uniforms it gives the reference's indices. The flat engine does not call
this oracle: it runs the fused payload kernels of
``repro_torch.kernels.quantize``, whose segment wire format is the one
described in ``repro.core.quantization``.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "QuantConfig",
    "Quantized",
    "SUPPORTED_WIRE_WIDTHS",
    "validate_wire_bits",
    "quantize",
    "dequantize",
    "wire_bits",
]

# Bit-widths the Eq. 12 wire format can carry (the signed index must fit
# int8); 32 is the fp32 pass-through.
SUPPORTED_WIRE_WIDTHS = (2, 3, 4, 5, 6, 7, 8, 32)


def validate_wire_bits(bits: int) -> int:
    """Reject widths the wire format cannot carry (32 means "no
    quantization")."""
    if bits not in SUPPORTED_WIRE_WIDTHS:
        raise ValueError(
            f"unsupported wire bit-width {bits!r}; "
            f"supported: {SUPPORTED_WIRE_WIDTHS}")
    return int(bits)


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """b-bit stochastic quantization with interval s (Eq. 12).

    bits=32 means 'no quantization'. s=None (default) uses an ADAPTIVE
    per-tensor interval s = max_v |w_v|/||w|| / levels, so the grid spans
    the payload's actual dynamic range; the wire format transmits s.
    """

    bits: int = 8
    s: float | None = None

    @property
    def levels(self) -> int:
        return (1 << (self.bits - 1)) - 1  # sign bit reserved

    @property
    def enabled(self) -> bool:
        return self.bits < 32


@dataclasses.dataclass
class Quantized:
    """Wire representation of one quantized tensor: (Lambda, s, ||w||)."""

    indices: torch.Tensor  # int32 signed index: sgn(w_v) * ell'
    s: torch.Tensor        # scalar quantization interval (f32)
    norm: torch.Tensor     # scalar ||w|| (f32)
    shape: tuple = ()


def quantize(w: torch.Tensor, cfg: QuantConfig, u: torch.Tensor) -> Quantized:
    """Eq. 12: unbiased stochastic rounding of |w_v|/||w|| onto the s-grid,
    rounding up where ``u < phi`` (``u``: uniforms in [0, 1), w's shape)."""
    wf = w.to(torch.float32)
    norm = torch.linalg.vector_norm(wf.reshape(-1))
    safe_norm = torch.where(norm > 0, norm, torch.ones_like(norm))
    if cfg.s is None:
        # Adaptive per-tensor grid: cover [0, max|w_v|/||w||] exactly.
        xmax = wf.abs().max() / safe_norm
        s = torch.where(xmax > 0, xmax / max(cfg.levels, 1), torch.ones_like(xmax))
    else:
        s = torch.tensor(cfg.s, dtype=torch.float32, device=w.device)
    x = wf.abs() / safe_norm             # in [0, 1]
    ell = torch.floor(x / s)             # lower grid index
    phi = x / s - ell                    # relative position in the interval
    up = (u.to(torch.float32) < phi).to(torch.float32)
    idx = torch.clamp(ell + up, 0, cfg.levels).to(torch.int32)
    signed = idx * torch.sign(wf).to(torch.int32)
    return Quantized(indices=signed, s=s, norm=norm, shape=tuple(w.shape))


def dequantize(q: Quantized, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    w = q.indices.to(torch.float32) * q.s * q.norm
    return w.to(dtype).reshape(q.shape)


def wire_bits(d: int, bits: int) -> int:
    """Paper §IV-B: quantized vector costs 64 + b*d bits; fp32 costs 32*d."""
    if bits >= 32:
        return 32 * d
    return 64 + bits * d
