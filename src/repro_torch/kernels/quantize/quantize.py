"""Stochastic quantization kernels (paper Eq. 12-14, §IV-B) for Hopper.

Eight CUDA C++ kernels for ``sm_90a`` in ``csrc/qdq_rows.cu``, each the port
of one Pallas TPU kernel of ``src/repro/kernels/quantize/quantize.py``:

- :func:`qdq_delta_rows_rng` replaces ``_qdq_delta_rows_rng_kernel``
  (``:156``): the Eq. 13 hop hand-off, ``out = base + deq(Q(w))``;
- :func:`qdq_rows_rng` replaces ``_qdq_rows_rng_kernel`` (``:171``): the
  Eq. 14 aggregation payload, ``out = deq(Q(w))``;
- :func:`qdq_delta_rows` and :func:`qdq_rows` replace
  ``_qdq_delta_rows_kernel`` (``:115``) and ``_qdq_rows_kernel`` (``:99``):
  the same two with the uniforms given as an operand;
- :func:`quantize_rows` and :func:`dequantize_rows` replace
  ``_quantize_rows_kernel`` (``:81``) and ``_dequantize_rows_kernel``
  (``:94``): the int8 wire indices ``idx * sign(w)`` and back, per row;
- :func:`quantize` and :func:`dequantize` replace ``_quantize_kernel``
  (``:41``) and ``_dequantize_kernel`` (``:53``): the same with one norm
  and a fixed grid interval ``s``.

All take a ``(R, 128)`` payload; the per-row kernels one grid interval
``s`` and one norm per row. The ``*_rng`` kernels draw their
stochastic-rounding uniforms from a 32-bit counter hash of each element's
global index ``row*128 + col`` salted by two seed words
(:func:`counter_uniforms`, the reference's ``_counter_uniforms``); the
others read them from ``u2d``. They are memory bound: one read of each
operand, one write of the result; the design notes are in the ``.cu``
source.

A wrapper given CPU tensors runs the kernel's plain PyTorch version
(``*_plain``), and so does one given meta tensors (shapes only, nothing
computed: the dry run's count, ``launch/dryrun.py``); given CUDA tensors it
launches the kernel on the current stream, or raises. A float32 qdq result is written over ``w2d`` (the TPU
kernel aliases its payload to its output), so callers hand over a
temporary; a bfloat16 or int8 result goes to a new tensor. Each launch adds
one to :data:`LAUNCHES`; nothing here synchronises.

The shared library is built with ``nvcc`` at first use into ``_build/``
beside this file (listed in ``.gitignore``) and bound with ``ctypes``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import build_library
from repro_torch.kernels.quantize.ref import (
    dequantize_ref,
    quantize_ref,
    reciprocal_f32,
    signed_index,
)

__all__ = [
    "LANES",
    "LAUNCHES",
    "OUT_DTYPES",
    "reset_launch_counts",
    "build",
    "counter_uniforms",
    "qdq_delta_rows_rng",
    "qdq_rows_rng",
    "qdq_delta_rows",
    "qdq_rows",
    "quantize_rows",
    "dequantize_rows",
    "quantize",
    "dequantize",
    "qdq_delta_rows_rng_plain",
    "qdq_rows_rng_plain",
    "qdq_delta_rows_plain",
    "qdq_rows_plain",
    "quantize_rows_plain",
    "dequantize_rows_plain",
    "quantize_plain",
    "dequantize_plain",
]

LANES = 128
OUT_DTYPES = (torch.float32, torch.bfloat16)
_SRC = Path(__file__).parent / "csrc" / "qdq_rows.cu"

# Kernel launches by name, counted where each wrapper launches its kernel.
LAUNCHES = {name: 0 for name in (
    "qdq_delta_rows_rng", "qdq_rows_rng", "qdq_delta_rows", "qdq_rows",
    "quantize_rows", "dequantize_rows", "quantize", "dequantize")}

_lib = None
BUILD_INFO: dict = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> ctypes.CDLL:
    """Compile ``csrc/qdq_rows.cu`` (once per source and flag set) and load
    it. Records the seconds taken and the ``-Xptxas -v`` report in
    :data:`BUILD_INFO`."""
    global _lib
    if _lib is not None:
        return _lib
    lib = build_library(_SRC, BUILD_INFO)
    p, i64, u32, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32,
                             ctypes.c_int, ctypes.c_float)
    signatures = {
        "qdq_delta_rows_rng": [p, p, p, p, i64, u32, u32, i32, p],
        "qdq_rows_rng": [p, p, p, i64, u32, u32, i32, p],
        "qdq_delta_rows": [p, p, p, p, p, p, i32, i64, i32, p],
        "qdq_rows": [p, p, p, p, p, i32, i64, i32, p],
        "quantize_rows": [p, p, p, p, p, i64, i32, p],
        "quantize": [p, p, p, f32, p, i64, i32, p],
        "dequantize_rows": [p, p, p, p, i32, i64, p],
        "dequantize": [p, p, f32, p, i32, i64, p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


# ------------------------------------------------------------ plain versions


def counter_uniforms(rows: int, seed0: int, seed1: int,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    """(rows, 128) float32 uniforms: the reference's ``_counter_uniforms``
    hash in int64 arithmetic masked to 32 bits after every add and
    multiply (the low 32 bits of a wrapped int64 product are exact)."""
    m32 = 0xFFFFFFFF
    x = torch.arange(rows * LANES, dtype=torch.int64, device=device) & m32
    x = (x + seed0) & m32
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & m32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & m32
    x = x ^ (x >> 16)
    x = (x + seed1) & m32
    x = x ^ (x >> 16)
    x = (x * 0x27D4EB2F) & m32
    x = x ^ (x >> 15)
    u = (x >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u.reshape(rows, LANES)


def _levels(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def _deq_rows(w2d, u2d, s_rows, norm_rows, bits):
    """(idx * sign(w) * s, norm) with per-row s and norm as (R, 1)."""
    s, norm = s_rows[:, None], norm_rows[:, None]
    return signed_index(w2d, u2d, s, norm, _levels(bits)) * s, norm


def qdq_delta_rows_plain(w2d, base2d, u2d, s_rows, norm_rows, *, bits,
                         out_dtype=torch.float32):
    """Plain PyTorch version of :func:`qdq_delta_rows` (out of place).
    ``addcmul`` is one fused multiply-add, as XLA contracts the reference's
    ``base + idx*sign*s*norm``; written unfused it differs by 1 ulp on a
    few percent of the elements."""
    t, norm = _deq_rows(w2d, u2d, s_rows, norm_rows, bits)
    return torch.addcmul(base2d, t, norm).to(out_dtype)


def qdq_rows_plain(w2d, u2d, s_rows, norm_rows, *, bits, out_dtype=torch.float32):
    """Plain PyTorch version of :func:`qdq_rows` (out of place)."""
    t, norm = _deq_rows(w2d, u2d, s_rows, norm_rows, bits)
    return (t * norm).to(out_dtype)


def qdq_delta_rows_rng_plain(w2d, base2d, seed, s_rows, norm_rows, *, bits):
    """Plain PyTorch version of :func:`qdq_delta_rows_rng` (out of place)."""
    u = counter_uniforms(w2d.shape[0], seed[0], seed[1], w2d.device)
    return qdq_delta_rows_plain(w2d, base2d, u, s_rows, norm_rows, bits=bits)


def qdq_rows_rng_plain(w2d, seed, s_rows, norm_rows, *, bits):
    """Plain PyTorch version of :func:`qdq_rows_rng` (out of place)."""
    u = counter_uniforms(w2d.shape[0], seed[0], seed[1], w2d.device)
    return qdq_rows_plain(w2d, u, s_rows, norm_rows, bits=bits)


def quantize_rows_plain(w2d, u2d, s_rows, norm_rows, *, bits):
    """Plain PyTorch version of :func:`quantize_rows`."""
    t = signed_index(w2d, u2d, s_rows[:, None], norm_rows[:, None], _levels(bits))
    return t.to(torch.int8)


def dequantize_rows_plain(q2d, s_rows, norm_rows, *, out_dtype=torch.float32):
    """Plain PyTorch version of :func:`dequantize_rows`: ``(q * s) * norm``
    per row, in the reference's order, rounded once to ``out_dtype``."""
    return (q2d.to(torch.float32) * s_rows[:, None] * norm_rows[:, None]).to(out_dtype)


# The plain versions of :func:`quantize` and :func:`dequantize` are the
# reference oracles themselves (``ref.py``), which take any shape.
quantize_plain = quantize_ref
dequantize_plain = dequantize_ref


# ------------------------------------------------------------------ wrappers


def _check(bits, planes, vectors=(), scalars=(), out_dtype=None):
    """Refuse what the kernels do not take. ``planes``: (name, tensor,
    dtype) of the (R, 128) operands, the first fixing the device and R;
    ``vectors``: (name, tensor) of the (R,) float32 operands; ``scalars``:
    (name, tensor) of one-element float32 operands."""
    first = planes[0][1]
    device = first.device
    if device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"qdq kernels take CPU, CUDA or meta tensors, got {device}")
    if bits is not None and not 2 <= bits <= 8:
        raise ValueError(f"qdq kernels carry 2..8-bit wire widths, got {bits}")
    if out_dtype is not None and out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {OUT_DTYPES}, got {out_dtype}")
    rows = first.shape[0] if first.dim() == 2 else -1
    named = ([(n, t, d, (rows, LANES)) for n, t, d in planes]
             + [(n, t, torch.float32, (rows,)) for n, t in vectors]
             + [(n, t, torch.float32, None) for n, t in scalars])
    for name, t, dtype, shape in named:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {str(dtype).removeprefix('torch.')}, "
                            f"got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, {planes[0][0]} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if shape is None and t.numel() != 1:
            raise ValueError(f"{name} must hold one element, got shape {tuple(t.shape)}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if device.type == "cuda":
        for name, t, dtype in planes:
            align = 4 if dtype == torch.int8 else 16
            if t.data_ptr() % align:
                raise ValueError(f"{name} must be {align}-byte aligned on the card")


def _no_alias(base2d, w2d):
    if base2d.device.type != "meta" and base2d.data_ptr() == w2d.data_ptr():
        raise ValueError("base2d must not alias w2d")


def _launch(name, args, device):
    lib = build()
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError_t {err}")
    LAUNCHES[name] += 1


def qdq_delta_rows_rng(w2d: torch.Tensor, base2d: torch.Tensor, seed,
                       s_rows: torch.Tensor, norm_rows: torch.Tensor, *,
                       bits: int) -> torch.Tensor:
    """``base + deq(Q(w))`` over an (R, 128) payload, ``seed`` a pair of
    uint32 words. On the card the result is written over ``w2d`` and
    returned; on the CPU the plain version returns a new tensor."""
    f32 = torch.float32
    _check(bits, [("w2d", w2d, f32), ("base2d", base2d, f32)],
           [("s_rows", s_rows), ("norm_rows", norm_rows)])
    _no_alias(base2d, w2d)
    if w2d.device.type in ("cpu", "meta"):
        return qdq_delta_rows_rng_plain(w2d, base2d, seed, s_rows, norm_rows,
                                        bits=bits)
    _launch("qdq_delta_rows_rng",
            (w2d.data_ptr(), base2d.data_ptr(), s_rows.data_ptr(),
             norm_rows.data_ptr(), w2d.shape[0], int(seed[0]), int(seed[1]),
             _levels(bits)), w2d.device)
    return w2d


def qdq_rows_rng(w2d: torch.Tensor, seed, s_rows: torch.Tensor,
                 norm_rows: torch.Tensor, *, bits: int) -> torch.Tensor:
    """``deq(Q(w))`` over an (R, 128) payload, ``seed`` a pair of uint32
    words. On the card the result is written over ``w2d`` and returned; on
    the CPU the plain version returns a new tensor."""
    _check(bits, [("w2d", w2d, torch.float32)],
           [("s_rows", s_rows), ("norm_rows", norm_rows)])
    if w2d.device.type in ("cpu", "meta"):
        return qdq_rows_rng_plain(w2d, seed, s_rows, norm_rows, bits=bits)
    _launch("qdq_rows_rng",
            (w2d.data_ptr(), s_rows.data_ptr(), norm_rows.data_ptr(),
             w2d.shape[0], int(seed[0]), int(seed[1]), _levels(bits)),
            w2d.device)
    return w2d


def _qdq_out(w2d, out_dtype):
    """A float32 result goes over ``w2d``; a bfloat16 one to a new tensor."""
    if out_dtype == torch.float32:
        return w2d
    return torch.empty(w2d.shape, dtype=out_dtype, device=w2d.device)


def qdq_delta_rows(w2d: torch.Tensor, base2d: torch.Tensor, u2d: torch.Tensor,
                   s_rows: torch.Tensor, norm_rows: torch.Tensor, *, bits: int,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``base + deq(Q(w))`` over an (R, 128) payload with the uniforms
    ``u2d`` given. On the card a float32 result is written over ``w2d``; on
    the CPU the plain version returns a new tensor."""
    f32 = torch.float32
    _check(bits, [("w2d", w2d, f32), ("base2d", base2d, f32), ("u2d", u2d, f32)],
           [("s_rows", s_rows), ("norm_rows", norm_rows)], out_dtype=out_dtype)
    _no_alias(base2d, w2d)
    if w2d.device.type in ("cpu", "meta"):
        return qdq_delta_rows_plain(w2d, base2d, u2d, s_rows, norm_rows, bits=bits,
                                    out_dtype=out_dtype)
    out = _qdq_out(w2d, out_dtype)
    _launch("qdq_delta_rows",
            (w2d.data_ptr(), base2d.data_ptr(), u2d.data_ptr(), s_rows.data_ptr(),
             norm_rows.data_ptr(), out.data_ptr(), int(out_dtype != f32),
             w2d.shape[0], _levels(bits)), w2d.device)
    return out


def qdq_rows(w2d: torch.Tensor, u2d: torch.Tensor, s_rows: torch.Tensor,
             norm_rows: torch.Tensor, *, bits: int,
             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``deq(Q(w))`` over an (R, 128) payload with the uniforms ``u2d``
    given. On the card a float32 result is written over ``w2d``; on the CPU
    the plain version returns a new tensor."""
    f32 = torch.float32
    _check(bits, [("w2d", w2d, f32), ("u2d", u2d, f32)],
           [("s_rows", s_rows), ("norm_rows", norm_rows)], out_dtype=out_dtype)
    if w2d.device.type in ("cpu", "meta"):
        return qdq_rows_plain(w2d, u2d, s_rows, norm_rows, bits=bits,
                              out_dtype=out_dtype)
    out = _qdq_out(w2d, out_dtype)
    _launch("qdq_rows",
            (w2d.data_ptr(), u2d.data_ptr(), s_rows.data_ptr(), norm_rows.data_ptr(),
             out.data_ptr(), int(out_dtype != f32), w2d.shape[0], _levels(bits)),
            w2d.device)
    return out


def quantize_rows(w2d: torch.Tensor, u2d: torch.Tensor, s_rows: torch.Tensor,
                  norm_rows: torch.Tensor, *, bits: int) -> torch.Tensor:
    """The int8 wire indices ``idx * sign(w)`` of an (R, 128) payload, with
    per-row ``s`` and norm and the uniforms ``u2d`` given (a new tensor)."""
    f32 = torch.float32
    _check(bits, [("w2d", w2d, f32), ("u2d", u2d, f32)],
           [("s_rows", s_rows), ("norm_rows", norm_rows)])
    if w2d.device.type in ("cpu", "meta"):
        return quantize_rows_plain(w2d, u2d, s_rows, norm_rows, bits=bits)
    out = torch.empty(w2d.shape, dtype=torch.int8, device=w2d.device)
    _launch("quantize_rows",
            (w2d.data_ptr(), u2d.data_ptr(), s_rows.data_ptr(), norm_rows.data_ptr(),
             out.data_ptr(), w2d.shape[0], _levels(bits)), w2d.device)
    return out


def dequantize_rows(q2d: torch.Tensor, s_rows: torch.Tensor, norm_rows: torch.Tensor,
                    *, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q * s * norm`` per row of an (R, 128) int8 payload (a new tensor)."""
    _check(None, [("q2d", q2d, torch.int8)],
           [("s_rows", s_rows), ("norm_rows", norm_rows)], out_dtype=out_dtype)
    if q2d.device.type in ("cpu", "meta"):
        return dequantize_rows_plain(q2d, s_rows, norm_rows, out_dtype=out_dtype)
    out = torch.empty(q2d.shape, dtype=out_dtype, device=q2d.device)
    _launch("dequantize_rows",
            (q2d.data_ptr(), s_rows.data_ptr(), norm_rows.data_ptr(), out.data_ptr(),
             int(out_dtype != torch.float32), q2d.shape[0]), q2d.device)
    return out


def quantize(w2d: torch.Tensor, u2d: torch.Tensor, norm: torch.Tensor, *,
             s: float, bits: int) -> torch.Tensor:
    """The int8 wire indices of an (R, 128) float32 payload with one
    ``norm`` (a one-element tensor on w's device) and the fixed grid
    interval ``s`` (a new tensor)."""
    f32 = torch.float32
    _check(bits, [("w2d", w2d, f32), ("u2d", u2d, f32)], scalars=[("norm", norm)])
    if w2d.device.type in ("cpu", "meta"):
        return quantize_plain(w2d, u2d, norm.reshape(()), s=s, bits=bits)
    out = torch.empty(w2d.shape, dtype=torch.int8, device=w2d.device)
    _launch("quantize",
            (w2d.data_ptr(), u2d.data_ptr(), norm.data_ptr(), reciprocal_f32(s),
             out.data_ptr(), w2d.shape[0], _levels(bits)), w2d.device)
    return out


def dequantize(q2d: torch.Tensor, norm: torch.Tensor, *, s: float,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q * (s * norm)`` of an (R, 128) int8 payload with one ``norm`` (a
    one-element tensor on q's device) and the fixed ``s`` (a new tensor)."""
    _check(None, [("q2d", q2d, torch.int8)], scalars=[("norm", norm)],
           out_dtype=out_dtype)
    if q2d.device.type in ("cpu", "meta"):
        return dequantize_plain(q2d, norm.reshape(()), s=s, out_dtype=out_dtype)
    out = torch.empty(q2d.shape, dtype=out_dtype, device=q2d.device)
    # float(float32(s)): the constant the reference multiplies by.
    s32 = float(torch.tensor(s, dtype=torch.float32))
    _launch("dequantize",
            (q2d.data_ptr(), norm.data_ptr(), s32, out.data_ptr(),
             int(out_dtype != torch.float32), q2d.shape[0]), q2d.device)
    return out
