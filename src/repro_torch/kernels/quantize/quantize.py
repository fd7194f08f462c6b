"""Fused stochastic quantize -> dequantize kernels (paper Eq. 12-14) for Hopper.

Two CUDA C++ kernels for ``sm_90a`` in ``csrc/qdq_rows.cu``, each the port of
one Pallas TPU kernel of the flat round engine's path:

- :func:`qdq_delta_rows_rng` replaces ``_qdq_delta_rows_rng_kernel``
  (``src/repro/kernels/quantize/quantize.py:156``): the Eq. 13 hop
  hand-off, ``out = base + deq(Q(w))``;
- :func:`qdq_rows_rng` replaces ``_qdq_rows_rng_kernel``
  (``src/repro/kernels/quantize/quantize.py:171``): the Eq. 14 aggregation
  payload, ``out = deq(Q(w))``.

Both take a ``(R, 128)`` float32 payload with one grid interval ``s`` and
one norm per row, and draw their stochastic-rounding uniforms from a 32-bit
counter hash of each element's global index ``row*128 + col`` salted by two
seed words (:func:`counter_uniforms`, the reference's ``_counter_uniforms``).
They are memory bound: one read of w (and base), one write of the result;
the design notes are in the ``.cu`` source.

A wrapper given CPU tensors runs the kernel's plain PyTorch version
(``*_plain``); given CUDA tensors it launches the kernel on the current
stream, or raises. The kernel writes its result over ``w2d`` (the TPU kernel
aliases its payload to its output), so callers hand over a temporary. Each
launch adds one to :data:`LAUNCHES`; nothing here synchronises.

The shared library is built with ``nvcc`` at first use into ``_build/``
beside this file (listed in ``.gitignore``) and bound with ``ctypes``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import build_library

__all__ = [
    "LANES",
    "LAUNCHES",
    "reset_launch_counts",
    "build",
    "counter_uniforms",
    "qdq_delta_rows_rng",
    "qdq_rows_rng",
    "qdq_delta_rows_rng_plain",
    "qdq_rows_rng_plain",
]

LANES = 128
_SRC = Path(__file__).parent / "csrc" / "qdq_rows.cu"

# Kernel launches by name, counted where each wrapper launches its kernel.
LAUNCHES = {"qdq_delta_rows_rng": 0, "qdq_rows_rng": 0}

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
    ptr, i64, u32, i32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32,
                          ctypes.c_int)
    lib.qdq_delta_rows_rng.argtypes = [ptr, ptr, ptr, ptr, i64, u32, u32, i32, ptr]
    lib.qdq_delta_rows_rng.restype = ctypes.c_int
    lib.qdq_rows_rng.argtypes = [ptr, ptr, ptr, i64, u32, u32, i32, ptr]
    lib.qdq_rows_rng.restype = ctypes.c_int
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


def _grid_index(w2d, seed, s_rows, norm_rows, bits):
    """clip(floor(x/s) + (u < frac), 0, levels) * sign(w) * s, x = |w|/norm."""
    levels = (1 << (bits - 1)) - 1
    u = counter_uniforms(w2d.shape[0], seed[0], seed[1], w2d.device)
    s = s_rows[:, None]
    norm = norm_rows[:, None]
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    x = w2d.abs() / safe
    ell = torch.floor(x / s)
    phi = x / s - ell
    idx = torch.clamp(ell + (u < phi).to(torch.float32), 0.0, float(levels))
    return idx * torch.sign(w2d) * s, norm


def qdq_delta_rows_rng_plain(w2d, base2d, seed, s_rows, norm_rows, *, bits):
    """Plain PyTorch version of :func:`qdq_delta_rows_rng` (out of place).
    ``addcmul`` is one fused multiply-add, as XLA contracts the reference's
    ``base + idx*sign*s*norm``; written unfused it differs by 1 ulp on a
    few percent of the elements."""
    t, norm = _grid_index(w2d, seed, s_rows, norm_rows, bits)
    return torch.addcmul(base2d, t, norm)


def qdq_rows_rng_plain(w2d, seed, s_rows, norm_rows, *, bits):
    """Plain PyTorch version of :func:`qdq_rows_rng` (out of place)."""
    t, norm = _grid_index(w2d, seed, s_rows, norm_rows, bits)
    return t * norm


# ------------------------------------------------------------------ wrappers


def _check(w2d, base2d, s_rows, norm_rows, bits):
    if w2d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"qdq kernels take CPU or CUDA tensors, got {w2d.device}")
    if not 2 <= bits <= 8:
        raise ValueError(f"qdq kernels carry 2..8-bit wire widths, got {bits}")
    rows = w2d.shape[0] if w2d.dim() == 2 else -1
    tensors = {"w2d": w2d, "s_rows": s_rows, "norm_rows": norm_rows}
    if base2d is not None:
        tensors["base2d"] = base2d
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != w2d.device:
            raise ValueError(f"{name} is on {t.device}, w2d on {w2d.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("w2d", "base2d"):
        if name in tensors and tuple(tensors[name].shape) != (rows, LANES):
            raise ValueError(f"{name} must have shape (R, {LANES}), "
                             f"got {tuple(tensors[name].shape)}")
    for name in ("s_rows", "norm_rows"):
        if tuple(tensors[name].shape) != (rows,):
            raise ValueError(f"{name} must have shape ({rows},), "
                             f"got {tuple(tensors[name].shape)}")
    if base2d is not None and base2d.data_ptr() == w2d.data_ptr():
        raise ValueError("base2d must not alias w2d")
    if w2d.is_cuda and any(t.data_ptr() % 16 for t in (w2d, base2d)
                           if t is not None):
        raise ValueError("w2d and base2d must be 16-byte aligned on the card")


def _launch(name, args, w2d):
    lib = build()
    stream = ctypes.c_void_p(torch.cuda.current_stream(w2d.device).cuda_stream)
    with torch.cuda.device(w2d.device):
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
    _check(w2d, base2d, s_rows, norm_rows, bits)
    if w2d.device.type == "cpu":
        return qdq_delta_rows_rng_plain(w2d, base2d, seed, s_rows, norm_rows,
                                        bits=bits)
    _launch("qdq_delta_rows_rng",
            (w2d.data_ptr(), base2d.data_ptr(), s_rows.data_ptr(),
             norm_rows.data_ptr(), w2d.shape[0], int(seed[0]), int(seed[1]),
             (1 << (bits - 1)) - 1), w2d)
    return w2d


def qdq_rows_rng(w2d: torch.Tensor, seed, s_rows: torch.Tensor,
                 norm_rows: torch.Tensor, *, bits: int) -> torch.Tensor:
    """``deq(Q(w))`` over an (R, 128) payload, ``seed`` a pair of uint32
    words. On the card the result is written over ``w2d`` and returned; on
    the CPU the plain version returns a new tensor."""
    _check(w2d, None, s_rows, norm_rows, bits)
    if w2d.device.type == "cpu":
        return qdq_rows_rng_plain(w2d, seed, s_rows, norm_rows, bits=bits)
    _launch("qdq_rows_rng",
            (w2d.data_ptr(), s_rows.data_ptr(), norm_rows.data_ptr(),
             w2d.shape[0], int(seed[0]), int(seed[1]), (1 << (bits - 1)) - 1),
            w2d)
    return w2d
