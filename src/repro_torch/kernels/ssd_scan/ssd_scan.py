"""The Mamba2 SSD chunked scan as four CUDA C++ kernels for ``sm_90a``.

:func:`ssd_scan` replaces the Pallas TPU kernel ``_ssd_kernel``
(``src/repro/kernels/ssd_scan/ssd_scan.py:32``), which walks the chunks in
order with the ``(N, P)`` state in VMEM. Here the same algebra runs
chunk-parallel as four kernels launched in order on the current stream
(:data:`STAGES`): ``chunk_cb`` (C·Bᵀ once per batch, group and chunk),
``chunk_state`` (each chunk's state update), ``state_pass`` (the states
carried across the chunks, the one sequential part) and ``chunk_scan`` (y).
Every product runs on the tensor cores as ``mma.sync`` m16n8k8 TF32 tiles
with a 3xTF32 split, which keeps float32-level error; the log-decay prefix
sums and their differences are float64. What bounds it is the 3xTF32
operation count at the card's TF32 rate; the design notes are in
``csrc/ssd_scan.cu``. It takes CUDA float32 tensors only;
:func:`repro_torch.kernels.ssd_scan.ssd_chunked` is the entry point that
sends a CPU tensor to the plain version instead.

The operands may be strided views (the last dimension contiguous), so the
model passes its ``(B, L, H, P)`` activations and ``(B, L, G, N)`` conv
outputs transposed, without copies; ``y`` is allocated in the layout of
``x``. The wrapper allocates the kernels' three scratches (C·Bᵀ, the
chunk states, the chunk decays; sizes in :func:`stage_report`). Each call
adds one to :data:`LAUNCHES` and each stage kernel one to
:data:`KERNEL_LAUNCHES` where it launches; nothing here synchronises.
There is no backward pass yet: inputs that require a gradient are refused.

The shared library is built with ``nvcc`` at first use into ``_build/``
beside this file (listed in ``.gitignore``) and bound with ``ctypes``;
:data:`BUILD_INFO` keeps the ``-Xptxas -v`` report (registers, spills).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import build_library

__all__ = ["LAUNCHES", "KERNEL_LAUNCHES", "STAGES", "BUILD_INFO", "reset_launch_counts",
           "build", "stage_report", "ssd_scan"]

_SRC = Path(__file__).parent / "csrc" / "ssd_scan.cu"
MAX_HEAD_DIM = 128
STAGES = ("chunk_cb", "chunk_state", "state_pass", "chunk_scan")

# Calls of the entry point, counted where it launches its kernels.
LAUNCHES = {"ssd_scan": 0}
# Launches of each stage kernel, counted where the wrapper launches it.
KERNEL_LAUNCHES = dict.fromkeys(STAGES, 0)

_lib = None
BUILD_INFO: dict = {}


def reset_launch_counts() -> None:
    LAUNCHES["ssd_scan"] = 0
    for name in STAGES:
        KERNEL_LAUNCHES[name] = 0


def build() -> ctypes.CDLL:
    """Compile ``csrc/ssd_scan.cu`` (once per source and flag set) and load
    it. Records the seconds taken and the ``-Xptxas -v`` report in
    :data:`BUILD_INFO`; a failed build raises."""
    global _lib
    if _lib is not None:
        return _lib
    lib = build_library(_SRC, BUILD_INFO)
    ptr = ctypes.c_void_p
    for name in STAGES:
        fn = getattr(lib, f"ssd_{name}")
        fn.argtypes = [ptr, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
    lib.ssd_stage_shape.argtypes = [ctypes.c_int, ptr, ptr]
    lib.ssd_stage_shape.restype = ctypes.c_int
    lib.ssd_scratch_elems.argtypes = [ptr, ptr]
    lib.ssd_scratch_elems.restype = ctypes.c_int
    _lib = lib
    return lib


def _dims(batch, heads, groups, seqlen, p, n, chunk):
    return (ctypes.c_int * 7)(batch, heads, groups, seqlen, p, n, chunk)


def stage_report(batch: int, heads: int, groups: int, seqlen: int, p: int, n: int,
                 chunk: int) -> dict:
    """What each stage kernel asks for at these sizes, from the library:
    ``{stage: {"smem_bytes", "blocks", "threads"}}``, and ``"scratch_bytes"``
    of the three scratches (C·Bᵀ, states, decays)."""
    lib = build()
    dims = _dims(batch, heads, groups, seqlen, p, n, chunk)
    report = {}
    out = (ctypes.c_longlong * 3)()
    for i, name in enumerate(STAGES):
        if lib.ssd_stage_shape(i, dims, out) != 0:
            raise ValueError(f"ssd_scan does not take {tuple(dims)}")
        report[name] = {"smem_bytes": out[0], "blocks": out[1], "threads": out[2]}
    lib.ssd_scratch_elems(dims, out)
    report["scratch_bytes"] = {k: 4 * v for k, v in zip(("cb", "states", "decay"), out)}
    return report


def _check(x, dt, a_log, b, c, chunk):
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan takes CUDA tensors, got {x.device}")
    named = {"x": x, "dt": dt, "a_log": a_log, "b": b, "c": c}
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dim() != 4 or b.dim() != 4 or c.dim() != 4 or dt.dim() != 3:
        raise ValueError("x must be (B,H,L,P), dt (B,H,L), b and c (B,G,L,N)")
    bsz, h, l, p = x.shape
    g, n = b.shape[1], b.shape[3]
    if tuple(dt.shape) != (bsz, h, l) or tuple(a_log.shape) != (h,):
        raise ValueError(f"dt must be {(bsz, h, l)} and a_log {(h,)}, got "
                         f"{tuple(dt.shape)} and {tuple(a_log.shape)}")
    if tuple(b.shape) != (bsz, g, l, n) or tuple(c.shape) != (bsz, g, l, n):
        raise ValueError(f"b and c must both be {(bsz, g, l, n)}, got "
                         f"{tuple(b.shape)} and {tuple(c.shape)}")
    if g < 1 or h % g:
        raise ValueError(f"heads {h} not divisible by groups {g}")
    if not 1 <= p <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {p} outside 1..{MAX_HEAD_DIM}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    for name in ("x", "b", "c"):
        if named[name].stride(3) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    if not a_log.is_contiguous():
        raise ValueError("a_log must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in named.values()):
        raise RuntimeError("ssd_scan has no backward pass yet (ROADMAP.md B9): "
                           "call it under torch.no_grad() or inference_mode()")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """x (B,H,L,P), dt (B,H,L) post-softplus, a_log (H,), b/c (B,G,L,N) with
    H % G == 0, all float32 on one card -> y (B,H,L,P). Any L: the kernels
    mask the ragged last chunk themselves. ``y`` is a (B,H,L,P) view of
    (B,L,H,P) memory when ``x`` is one, else contiguous."""
    _check(x, dt, a_log, b, c, chunk)
    bsz, h, l, p = x.shape
    g, n = b.shape[1], b.shape[3]
    if x.stride(2) > x.stride(1):      # heads inside the sequence: (B,L,H,P)
        y = x.new_empty(bsz, l, h, p).transpose(1, 2)
    else:
        y = x.new_empty(bsz, h, l, p)
    if y.numel() == 0:
        LAUNCHES["ssd_scan"] += 1
        return y
    lib = build()
    dims = _dims(bsz, h, g, l, p, n, chunk)
    elems = (ctypes.c_longlong * 3)()
    if lib.ssd_scratch_elems(dims, elems) != 0:
        raise ValueError(f"ssd_scan does not take {tuple(dims)}")
    cb, states, decay = (x.new_empty(k) for k in elems)
    ptrs = (ctypes.c_void_p * 9)(*(t.data_ptr() for t in (x, dt, a_log, b, c, y, cb,
                                                          states, decay)))
    strides = (ctypes.c_longlong * 15)(*(t.stride(i) for t in (x, dt, b, c, y)
                                         for i in range(3)))
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    with torch.cuda.device(x.device):
        for name in STAGES:
            err = getattr(lib, f"ssd_{name}")(ptrs, strides, dims, stream)
            if err != 0:
                report = stage_report(bsz, h, g, l, p, n, chunk)
                shapes = ", ".join(f"{k} {report[k]['smem_bytes']} bytes x "
                                   f"{report[k]['blocks']} blocks" for k in STAGES)
                raise RuntimeError(f"ssd_scan's {name} kernel failed with cudaError_t "
                                   f"{err} (dynamic shared memory a block: {shapes})")
            KERNEL_LAUNCHES[name] += 1
    LAUNCHES["ssd_scan"] += 1
    return y
