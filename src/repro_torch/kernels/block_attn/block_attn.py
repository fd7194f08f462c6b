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
4-byte copies. Each launch adds one to :data:`LAUNCHES`; nothing here
synchronises.

Training: when a gradient is wanted (grad mode on and an input that
requires one), :func:`block_attn` goes through :class:`BlockAttnFunction`.
Its forward is the same kernel, which then also writes each row's
log-sum-exp (B, H, Lq); its backward is two more kernels of the same
source, FlashAttention-2's backward on the same 3xTF32 ``mma.sync``
fragments: ``attn_bwd_dot`` (D = rowsum(dO o O) and the log-sum-exp in
units of log2, once a row, into a (B, H, Lq, 2) scratch) and
``attn_bwd_dkdvq`` (per key tile, dK and dV with the keys in the
accumulators' rows, so that P^T and dS^T feed the next products from
registers, summed over the query heads of each KV group inside one block;
and each query tile's dQ added to a zeroed dq by float32 atomics, whose
order varies from run to run; design and bound in ``csrc/block_attn.cu``).
Each backward launch adds one to :data:`BWD_LAUNCHES`. No path
differentiates the plain version for a CUDA tensor.

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

__all__ = ["LAUNCHES", "BWD_LAUNCHES", "BUILD_INFO", "MAX_HEAD_DIM", "reset_launch_counts",
           "build", "block_attn", "block_attn_forward", "block_attn_backward",
           "BlockAttnFunction"]

_SRC = Path(__file__).parent / "csrc" / "block_attn.cu"
MAX_HEAD_DIM = 128
QUERY_TILE = 128               # query rows of one block
MAX_QUERY_TILES = 65535        # the grid's y dimension

# Kernel launches, counted where the wrapper launches the kernel.
LAUNCHES = {"block_attn": 0}
# The backward kernels, in launch order.
BWD_LAUNCHES = {"attn_bwd_dot": 0, "attn_bwd_dkdvq": 0}

_lib = None
BUILD_INFO: dict = {}


def reset_launch_counts() -> None:
    LAUNCHES["block_attn"] = 0
    for name in BWD_LAUNCHES:
        BWD_LAUNCHES[name] = 0


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
                               + [ptr, ctypes.c_float, ptr])
    lib.block_attn.restype = ctypes.c_int
    lib.block_attn_smem_bytes.argtypes = [i32]
    lib.block_attn_smem_bytes.restype = ctypes.c_longlong
    for name in BWD_LAUNCHES:
        fn = getattr(lib, f"block_{name}")
        fn.argtypes = [ptr, ptr, ptr, ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
    lib.block_attn_bwd_smem_bytes.argtypes = [i32, i32]
    lib.block_attn_bwd_smem_bytes.restype = ctypes.c_longlong
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


def block_attn_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: int = 0, with_lse: bool = False):
    """The forward kernel on checked operands -> (o, lse): o (B, Lq, H, hd)
    contiguous; lse (B, H, Lq) float32, each row's natural log-sum-exp of
    its scaled, masked scores (-inf for a row that attends no key), or None
    when ``with_lse`` is False (the kernel then writes none)."""
    _check(q, k, v, window)
    bsz, lq, h, hd = q.shape
    lk, kv = k.shape[1], k.shape[2]
    o = q.new_empty(bsz, lq, h, hd)
    lse = q.new_empty(bsz, h, lq) if with_lse else None
    lib = build()
    strides = [t.stride(i) for t in (q, k, v, o) for i in range(3)]
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):
        err = lib.block_attn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                             *strides, bsz, h, kv, lq, lk, hd, int(causal), int(window),
                             lse.data_ptr() if lse is not None else None,
                             1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(
            f"block_attn launch failed with cudaError_t {err} (dynamic shared "
            f"memory {lib.block_attn_smem_bytes(hd)} bytes)")
    LAUNCHES["block_attn"] += 1
    return o, lse


def block_attn_backward(q, k, v, o, lse, do, *, causal: bool = True, window: int = 0):
    """The two backward kernels -> (dq, dk, dv), contiguous; ``o`` and
    ``lse`` are the forward's, ``do`` the gradient of ``o``. dK and dV sum
    over the H/KV query heads of each group; dq is summed by float32
    atomics (its last bits vary from run to run). A failed launch raises."""
    if do.stride(3) != 1:
        do = do.contiguous()
    _check(q, k, v, window)
    bsz, lq, h, hd = q.shape
    lk, kv = k.shape[1], k.shape[2]
    if tuple(do.shape) != tuple(o.shape) or tuple(lse.shape) != (bsz, h, lq):
        raise ValueError(f"do {tuple(do.shape)} and lse {tuple(lse.shape)} do not match "
                         f"o {tuple(o.shape)}")
    if not lse.is_contiguous():
        raise ValueError("lse must be contiguous")
    dq = q.new_zeros(q.shape)                      # the kernel adds into it
    dk, dv = k.new_empty(k.shape), v.new_empty(v.shape)
    rows = q.new_empty(bsz, h, lq, 2)             # lse log2(e), D = rowsum(dO o O)
    lib = build()
    ptrs = (ctypes.c_void_p * 10)(*(t.data_ptr() for t in (q, k, v, o, do, lse, dq, dk, dv,
                                                           rows)))
    strides = (ctypes.c_longlong * 24)(*(t.stride(i) for t in (q, k, v, o, do, dq, dk, dv)
                                         for i in range(3)))
    dims = (ctypes.c_int * 8)(bsz, h, kv, lq, lk, hd, int(causal), int(window))
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):
        for i, name in enumerate(BWD_LAUNCHES):
            err = getattr(lib, f"block_{name}")(ptrs, strides, dims,
                                                1.0 / math.sqrt(hd), stream)
            if err != 0:
                raise RuntimeError(
                    f"block_attn's {name} kernel failed with cudaError_t {err} (dynamic "
                    f"shared memory {lib.block_attn_bwd_smem_bytes(i, hd)} bytes)")
            BWD_LAUNCHES[name] += 1
    return dq, dk, dv


class BlockAttnFunction(torch.autograd.Function):
    """Blockwise attention with its gradient from the backward kernels:
    the forward keeps q, k, v, o and the log-sum-exp; the backward launches
    ``attn_bwd_dot`` and ``attn_bwd_dkdvq``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        o, lse = block_attn_forward(q, k, v, causal=causal, window=window, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = block_attn_backward(q, k, v, o, lse, do, causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def block_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Lq, H, hd), k/v (B, Lk, KV, hd) with H % KV == 0, all float32
    on one card -> o (B, Lq, H, hd), contiguous. Any Lq and Lk: the kernel
    masks the ragged last tiles itself. When a gradient is wanted the call
    goes through :class:`BlockAttnFunction` (the backward kernels)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        _check(q, k, v, window)
        return BlockAttnFunction.apply(q, k, v, causal, window)
    return block_attn_forward(q, k, v, causal=causal, window=window)[0]
