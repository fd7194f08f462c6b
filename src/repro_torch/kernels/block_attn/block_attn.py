"""Blockwise softmax attention as a CUDA C++ kernel for ``sm_90a``.

:func:`block_attn` replaces the Pallas TPU kernel ``_attn_kernel``
(``src/repro/kernels/block_attn/block_attn.py:32``). One block of 8 warps
per (batch, head, 128-row query tile) loops over the 64-row K/V tiles up to
the diagonal, with an online softmax in registers. Both products (Q K^T and
P V) run on the tensor cores as ``mma.sync`` m16n8k8 TF32 tiles with a
3xTF32 split (big + small operands, three products into one float32
accumulator), which keeps float32-level error; the K/V tiles arrive through
a two-stage ``cp.async`` ring. Its bound is the 3xTF32 operation count at
the card's TF32 rate. The design notes (fragment and shared-memory layout,
the ring, the split's accuracy) are in ``csrc/block_attn.cu``. It takes
CUDA float32 tensors only; :func:`repro_torch.kernels.block_attn.block_attention`
is the entry point that sends a CPU tensor to the plain version instead.

The operands are ``(B, L, heads, hd)`` tensors, possibly strided views with
the last dimension contiguous; K/V are read by group (``H % KV == 0``), and
the output is allocated contiguous. Views whose rows are not 16-byte
aligned (``hd`` not a multiple of 4, an odd offset) take the kernel's
4-byte copies. There is no backward pass yet: inputs that require a
gradient are refused. Each launch adds one to :data:`LAUNCHES`; nothing
here synchronises.

The shared library is built with ``nvcc`` at first use into ``_build/``
beside this file (listed in ``.gitignore``) and bound with ``ctypes``;
:data:`BUILD_INFO` keeps the ``-Xptxas -v`` report (registers, spills).
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels._build import build_library

__all__ = ["LAUNCHES", "BUILD_INFO", "MAX_HEAD_DIM", "reset_launch_counts", "build",
           "block_attn"]

_SRC = Path(__file__).parent / "csrc" / "block_attn.cu"
MAX_HEAD_DIM = 128
QUERY_TILE = 128               # query rows of one block
MAX_QUERY_TILES = 65535        # the grid's y dimension

# Kernel launches, counted where the wrapper launches the kernel.
LAUNCHES = {"block_attn": 0}

_lib = None
BUILD_INFO: dict = {}


def reset_launch_counts() -> None:
    LAUNCHES["block_attn"] = 0


def build() -> ctypes.CDLL:
    """Compile ``csrc/block_attn.cu`` (once per source and flag set) and
    load it. Records the seconds taken and the ``-Xptxas -v`` report in
    :data:`BUILD_INFO`; a failed build raises."""
    global _lib
    if _lib is not None:
        return _lib
    lib = build_library(_SRC, BUILD_INFO)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.block_attn.argtypes = ([ptr] * 4 + [i64] * 12 + [i32] * 8
                               + [ctypes.c_float, ptr])
    lib.block_attn.restype = ctypes.c_int
    lib.block_attn_smem_bytes.argtypes = [i32]
    lib.block_attn_smem_bytes.restype = ctypes.c_longlong
    _lib = lib
    return lib


def _check(q, k, v, window):
    if q.device.type != "cuda":
        raise ValueError(f"block_attn takes CUDA tensors, got {q.device}")
    named = {"q": q, "k": k, "v": v}
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, L, heads, hd), got {tuple(t.shape)}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    bsz, lq, h, hd = q.shape
    lk, kv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (bsz, lk, kv, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must both be {(bsz, lk, kv, hd)}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if kv < 1 or h % kv:
        raise ValueError(f"heads {h} not divisible by KV heads {kv}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} outside 1..{MAX_HEAD_DIM}")
    if -(-lq // QUERY_TILE) > MAX_QUERY_TILES:
        raise ValueError(f"query length {lq} exceeds {MAX_QUERY_TILES} tiles of {QUERY_TILE}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in named.values()):
        raise RuntimeError("block_attn has no backward pass yet (ROADMAP.md B10): "
                           "call it under torch.no_grad() or inference_mode()")


def block_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Lq, H, hd), k/v (B, Lk, KV, hd) with H % KV == 0, all float32
    on one card -> o (B, Lq, H, hd), contiguous. Any Lq and Lk: the kernel
    masks the ragged last tiles itself."""
    _check(q, k, v, window)
    bsz, lq, h, hd = q.shape
    lk, kv = k.shape[1], k.shape[2]
    o = q.new_empty(bsz, lq, h, hd)
    lib = build()
    strides = [t.stride(i) for t in (q, k, v, o) for i in range(3)]
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):
        err = lib.block_attn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                             *strides, bsz, h, kv, lq, lk, hd, int(causal), int(window),
                             1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(
            f"block_attn launch failed with cudaError_t {err} (dynamic shared "
            f"memory {lib.block_attn_smem_bytes(hd)} bytes)")
    LAUNCHES["block_attn"] += 1
    return o
