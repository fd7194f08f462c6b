"""Stochastic quantization for communication (paper §IV-B, Eq. 12, Lemma 3).

The port of ``repro.core.quantization``: the per-leaf Eq. 12 oracle and the
wire-cost accounting. Quantizes the *normalized* components |w_v|/||w||
onto the grid {0, s, 2s, ..., (2^{b-1}-1) s} by unbiased stochastic
rounding; one bit of b is the sign. The wire format for a d-vector is
(Lambda, s, ||w||): b*d bits of indices+signs plus 32+32 bits of side
information, i.e. (64 + b*d) bits versus 32*d unquantized.

Torch cannot reproduce ``jax.random`` streams, so :func:`quantize` takes
its stochastic-rounding uniforms as an argument; handed the reference's
uniforms it gives the reference's indices. :func:`quantize_rows` quantizes
each row of a tensor as its own wire tensor (the reference's vmapped
``quantize``), and the pytree codec (:func:`quantize_pytree`,
:func:`dequantize_pytree`, :func:`pytree_wire_bits`) one wire tensor a
leaf, leaves in the reference's order (sorted dict keys). The flat engine
does not call these oracles: it runs the fused payload kernels of
``repro_torch.kernels.quantize``, whose segment wire format is the one
described in ``repro.core.quantization``. The per-leaf seed engine
(``DFedRWConfig(engine="reference")``) calls them, plain PyTorch on
whatever device it runs on.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.flatten import tree_leaves, tree_map

__all__ = [
    "QuantConfig",
    "Quantized",
    "SUPPORTED_WIRE_WIDTHS",
    "validate_wire_bits",
    "quantize",
    "quantize_rows",
    "dequantize",
    "quantize_pytree",
    "dequantize_pytree",
    "wire_bits",
    "pytree_wire_bits",
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
    def interval(self) -> float:
        """Static fallback interval (used when s is fixed)."""
        return self.s if self.s is not None else 1.0 / max(self.levels, 1)

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
    return _round(wf, cfg, u, torch.linalg.vector_norm(wf.reshape(-1)), wf.abs().max())


def quantize_rows(w: torch.Tensor, cfg: QuantConfig, u: torch.Tensor) -> Quantized:
    """:func:`quantize` of each row ``w[r]`` on its own, with its own norm
    and grid, as row-wise reductions over the whole tensor: ``s`` and
    ``norm`` have shape (R, 1, ..., 1), so :func:`dequantize` takes the
    result as it is."""
    wf = w.to(torch.float32)
    flat = wf.reshape(wf.shape[0], -1)
    lead = (wf.shape[0],) + (1,) * (wf.dim() - 1)
    return _round(wf, cfg, u, torch.linalg.vector_norm(flat, dim=1).reshape(lead),
                  flat.abs().amax(dim=1).reshape(lead))


def _round(wf: torch.Tensor, cfg: QuantConfig, u: torch.Tensor, norm: torch.Tensor,
           absmax: torch.Tensor) -> Quantized:
    """The Eq. 12 grid and rounding of ``wf`` given its norm and max |w_v|
    (scalars, or one a row broadcast over the row)."""
    safe_norm = torch.where(norm > 0, norm, torch.ones_like(norm))
    if cfg.s is None:
        # Adaptive per-tensor grid: cover [0, max|w_v|/||w||] exactly.
        xmax = absmax / safe_norm
        s = torch.where(xmax > 0, xmax / max(cfg.levels, 1), torch.ones_like(xmax))
    else:
        s = torch.full_like(norm, cfg.s)
    x = wf.abs() / safe_norm             # in [0, 1]
    ell = torch.floor(x / s)             # lower grid index
    phi = x / s - ell                    # relative position in the interval
    up = (u.to(torch.float32) < phi).to(torch.float32)
    idx = torch.clamp(ell + up, 0, cfg.levels).to(torch.int32)
    signed = idx * torch.sign(wf).to(torch.int32)
    return Quantized(indices=signed, s=s, norm=norm, shape=tuple(wf.shape))


def dequantize(q: Quantized, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    w = q.indices.to(torch.float32) * q.s * q.norm
    return w.to(dtype).reshape(q.shape)


def quantize_pytree(tree, cfg: QuantConfig, *, uniforms=None,
                    generator: torch.Generator | None = None):
    """Each leaf of ``tree`` quantized as one wire tensor (:func:`quantize`);
    a tree of :class:`Quantized` of the same nesting. ``uniforms`` lists one
    tensor a leaf, in the reference's leaf order (sorted dict keys); without
    it the uniforms are drawn from ``generator`` on each leaf's device."""
    leaves = tree_leaves(tree)
    if uniforms is None:
        if generator is None:
            raise ValueError("quantize_pytree needs uniforms or a generator")
        uniforms = [torch.rand(leaf.shape, generator=generator, device=leaf.device)
                    for leaf in leaves]
    if len(uniforms) != len(leaves):
        raise ValueError(f"{len(uniforms)} uniforms for {len(leaves)} leaves")
    return tree_map(lambda leaf, u: quantize(leaf, cfg, u), tree, list(uniforms))


def dequantize_pytree(qtree, dtype: torch.dtype = torch.float32):
    return tree_map(lambda q: dequantize(q, dtype), qtree)


def wire_bits(d: int, bits: int) -> int:
    """Paper §IV-B: quantized vector costs 64 + b*d bits; fp32 costs 32*d."""
    if bits >= 32:
        return 32 * d
    return 64 + bits * d


def pytree_wire_bits(tree, bits: int) -> int:
    return sum(wire_bits(int(leaf.numel()), bits) for leaf in tree_leaves(tree))
