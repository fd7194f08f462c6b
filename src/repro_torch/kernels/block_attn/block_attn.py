"""Blockwise softmax attention as CUDA C++ kernels for ``sm_90a``.

:func:`block_attn` replaces the Pallas TPU kernel ``_attn_kernel``
(``src/repro/kernels/block_attn/block_attn.py:32``) with two kernels, one a
dtype. float32 (``csrc/block_attn.cu``): one block of 8 warps per (batch,
head, 128-row query tile) loops over the 64-row K/V tiles up to the
diagonal, with an online softmax in registers; both products (Q K^T and
P V) run on the tensor cores as ``mma.sync`` m16n8k8 TF32 tiles with a
3xTF32 split (big + small operands, three products into one float32
accumulator), which keeps float32-level error; the K/V tiles arrive through
a two-stage ``cp.async`` ring. Its bound is the 3xTF32 operation count at
the card's TF32 rate. bf16 (``csrc/block_attn_bf16.cu``): one block of
three warpgroups per (batch, head, 128-row query tile), a producer
warpgroup issuing TMA loads of the Q tile and of 64-key K/V tiles into a
ring of stages with ``mbarrier`` barriers, and two consumer warpgroups of
64 query rows running ``wgmma`` on the bf16 tensor cores: S = Q K^T from shared
memory, the online softmax in float32 registers, and P V from P's two bf16
halves (hi = bf16(P), lo = bf16(P - hi)) in registers against V in shared
memory, each tile's P V in a zeroed accumulator; o is rounded once to
bf16. Its bound is the function's FLOP at the card's bf16 rate or its
bytes. The design notes are in the sources. All three operands are float32
or all bf16; bf16 launches also add one to :data:`BF16_LAUNCHES`.
:func:`repro_torch.kernels.block_attn.block_attention` is the entry point
that sends a CPU tensor to the plain version instead.

The operands are ``(B, L, heads, hd)`` tensors, possibly strided views with
the last dimension contiguous; K/V are read by group (``H % KV == 0``), and
the output is allocated contiguous. float32 views whose rows are not
16-byte aligned (``hd`` not a multiple of 4, an odd offset) take the
kernel's 4-byte copies. The bf16 kernel reads q, k and v through 4-D TMA
tensor maps over their own strides; an operand a map cannot describe
(:func:`tma_takes`: a base not 16-byte aligned, a stride not a multiple of
8 elements, ``hd`` not a multiple of 8) is first copied into a padded
contiguous tensor (:func:`repack_for_tma`), counted in
:data:`BF16_REPACKS`; no model path needs one. Each launch adds one to
:data:`LAUNCHES`; nothing here synchronises.

Training: when a gradient is wanted (grad mode on and an input that
requires one), :func:`block_attn` goes through :class:`BlockAttnFunction`.
Its forward is the float32 kernel, which then also writes each row's
log-sum-exp (B, H, Lq); its backward is two more kernels of
``csrc/block_attn.cu``, FlashAttention-2's backward on the same 3xTF32
``mma.sync`` fragments: ``attn_bwd_dot`` (D = rowsum(dO o O) and the
log-sum-exp in units of log2, once a row, into a (B, H, Lq, 2) scratch)
and ``attn_bwd_dkdvq`` (per key tile, dK and dV with the keys in the
accumulators' rows, so that P^T and dS^T feed the next products from
registers, summed over the query heads of each KV group inside one block;
and each query tile's dQ added to a zeroed dq by float32 atomics, whose
order varies from run to run; design and bound in ``csrc/block_attn.cu``).
Each backward launch adds one to :data:`BWD_LAUNCHES`. No path
differentiates the plain version for a CUDA tensor. The backward kernels
are float32: a bf16 input that requires a gradient raises
``NotImplementedError`` (the reference trains in float32; ROADMAP.md A11).

Each source is built with ``nvcc`` at first use into ``_build/`` beside
this file (listed in ``.gitignore``) and bound with ``ctypes``;
:data:`BUILD_INFO` and :data:`BF16_BUILD_INFO` keep the ``-Xptxas -v``
reports (registers, spills).
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels._build import build_library

__all__ = ["LAUNCHES", "BF16_LAUNCHES", "BF16_REPACKS", "BWD_LAUNCHES", "BUILD_INFO",
           "BF16_BUILD_INFO", "MAX_HEAD_DIM", "reset_launch_counts", "build", "build_bf16",
           "tma_takes", "repack_for_tma", "block_attn", "block_attn_forward",
           "block_attn_backward", "BlockAttnFunction"]

_SRC = Path(__file__).parent / "csrc" / "block_attn.cu"
_SRC_BF16 = Path(__file__).parent / "csrc" / "block_attn_bf16.cu"
MAX_HEAD_DIM = 128
QUERY_TILE = 128               # query rows of one block, in both kernels
MAX_QUERY_TILES = 65535        # the grid's y dimension
TMA_ALIGN = 16                 # bytes: a TMA map's base and its strides

# Kernel launches, counted where the wrapper launches the kernel: all of
# them, and those of the bf16 kernel. BF16_REPACKS counts the operands the
# bf16 path copied because TMA could not read them as they were.
LAUNCHES = {"block_attn": 0}
BF16_LAUNCHES = {"block_attn": 0}
BF16_REPACKS = {"block_attn": 0}
_TYPES = (torch.float32, torch.bfloat16)
# The backward kernels, in launch order.
BWD_LAUNCHES = {"attn_bwd_dot": 0, "attn_bwd_dkdvq": 0}

_lib = None
_lib_bf16 = None
BUILD_INFO: dict = {}
BF16_BUILD_INFO: dict = {}


def reset_launch_counts() -> None:
    LAUNCHES["block_attn"] = 0
    BF16_LAUNCHES["block_attn"] = 0
    BF16_REPACKS["block_attn"] = 0
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


def build_bf16() -> ctypes.CDLL:
    """Compile ``csrc/block_attn_bf16.cu`` (the bf16 kernel: ``wgmma`` fed by
    TMA) and load it, as :func:`build`; its report goes into
    :data:`BF16_BUILD_INFO`."""
    global _lib_bf16
    if _lib_bf16 is not None:
        return _lib_bf16
    lib = build_library(_SRC_BF16, BF16_BUILD_INFO)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.block_attn_bf16.argtypes = [ptr] * 4 + [i64] * 12 + [i32] * 9 + [ctypes.c_float, ptr]
    lib.block_attn_bf16.restype = ctypes.c_int
    lib.block_attn_bf16_smem_bytes.argtypes = [i32]
    lib.block_attn_bf16_smem_bytes.restype = ctypes.c_longlong
    _lib_bf16 = lib
    return lib


def tma_takes(t: torch.Tensor) -> bool:
    """Whether a (B, L, heads, hd) bf16 operand can be read by a TMA tensor
    map as it is: its base 16-byte aligned, hd a multiple of 8 (16-byte
    rows), and the batch, sequence and head strides multiples of 8 elements
    (a dimension of size 1 is never stepped over, so its stride does not
    matter). The last dimension is contiguous (checked by the caller)."""
    step = TMA_ALIGN // t.element_size()
    shape, strides = t.shape, t.stride()
    return (t.data_ptr() % TMA_ALIGN == 0 and shape[3] % step == 0
            and all(strides[i] % step == 0 or shape[i] == 1 for i in range(3)))


def repack_for_tma(t: torch.Tensor, width: int) -> torch.Tensor:
    """A contiguous (B, L, heads, width) copy of ``t`` whose columns past
    its own hd are zeros: a tensor TMA can read (:func:`tma_takes`)."""
    out = t.new_zeros(*t.shape[:3], width)
    out[..., :t.shape[-1]] = t
    return out


def _bf16_forward(q, k, v, o, causal, window):
    """Launches the bf16 kernel on checked operands, copying those TMA cannot
    read (:func:`tma_takes`) into padded contiguous tensors first."""
    hd = q.shape[3]
    step = TMA_ALIGN // q.element_size()
    width = -(-hd // step) * step
    ops = []
    for t in (q, k, v):
        if width != hd or not tma_takes(t):
            t = repack_for_tma(t, width)
            BF16_REPACKS["block_attn"] += 1
        ops.append(t)
    lib = build_bf16()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.block_attn_bf16(*(t.data_ptr() for t in (*ops, o)),
                                  *(t.stride(i) for t in (*ops, o) for i in range(3)),
                                  q.shape[0], q.shape[2], k.shape[2], q.shape[1], k.shape[1],
                                  width, hd, int(causal), int(window), 1.0 / math.sqrt(hd),
                                  stream)
    if err != 0:
        raise RuntimeError(
            f"block_attn's bf16 kernel failed with cudaError_t {err} (dynamic shared memory "
            f"{lib.block_attn_bf16_smem_bytes(width)} bytes; q, k, v "
            f"{[(tuple(t.shape), t.stride()) for t in ops]})")


def _check(q, k, v, window):
    if q.device.type != "cuda":
        raise ValueError(f"block_attn takes CUDA tensors, got {q.device}")
    named = {"q": q, "k": k, "v": v}
    if q.dtype not in _TYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in named.items():
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
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
    contiguous, in q's dtype; lse (B, H, Lq) float32, each row's natural
    log-sum-exp of its scaled, masked scores (-inf for a row that attends no
    key), or None when ``with_lse`` is False (the kernel then writes none;
    bf16 operands write none)."""
    _check(q, k, v, window)
    bsz, lq, h, hd = q.shape
    lk, kv = k.shape[1], k.shape[2]
    o = q.new_empty(bsz, lq, h, hd)
    if q.dtype == torch.bfloat16:
        if with_lse:
            raise ValueError("the log-sum-exp (the training path) is float32 only")
        _bf16_forward(q, k, v, o, causal, window)
        LAUNCHES["block_attn"] += 1
        BF16_LAUNCHES["block_attn"] += 1
        return o, None
    lse = torch.empty(bsz, h, lq, dtype=torch.float32, device=q.device) if with_lse else None
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
    if q.dtype != torch.float32:
        raise NotImplementedError(f"block_attn's backward kernels take float32, got {q.dtype} "
                                  f"(ROADMAP.md A11)")
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
    or all bf16 on one card -> o (B, Lq, H, hd) in their dtype, contiguous.
    Any Lq and Lk: the kernel masks the ragged last tiles itself. When a
    gradient is wanted the call goes through :class:`BlockAttnFunction`
    (the backward kernels, float32 only: bf16 raises)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        _check(q, k, v, window)
        if q.dtype == torch.bfloat16:
            raise NotImplementedError(
                "block_attn's backward kernels are float32: a bf16 input that requires a "
                "gradient has no backward (the reference trains in float32; ROADMAP.md A11)")
        return BlockAttnFunction.apply(q, k, v, causal, window)
    return block_attn_forward(q, k, v, causal=causal, window=window)[0]
