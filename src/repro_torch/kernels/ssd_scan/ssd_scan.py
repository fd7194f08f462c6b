"""The Mamba2 SSD chunked scan as a CUDA C++ kernel for ``sm_90a``.

:func:`ssd_scan` replaces the Pallas TPU kernel ``_ssd_kernel``
(``src/repro/kernels/ssd_scan/ssd_scan.py:32``): one block per (batch,
head) walks the chunks in order with the ``(N, P)`` float32 state in shared
memory; the design notes are in ``csrc/ssd_scan.cu``. It takes CUDA float32
tensors only; :func:`repro_torch.kernels.ssd_scan.ssd_chunked` is the entry
point that sends a CPU tensor to the plain version instead.

The operands may be strided views (the last dimension contiguous), so the
model passes its ``(B, L, H, P)`` activations and ``(B, L, G, N)`` conv
outputs transposed, without copies; ``y`` is allocated in the layout of
``x``. Each launch adds one to :data:`LAUNCHES`; nothing here synchronises.

The shared library is built with ``nvcc`` at first use into ``_build/``
beside this file (listed in ``.gitignore``) and bound with ``ctypes``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import build_library

__all__ = ["LAUNCHES", "BUILD_INFO", "reset_launch_counts", "build", "ssd_scan"]

_SRC = Path(__file__).parent / "csrc" / "ssd_scan.cu"
MAX_HEAD_DIM = 128

# Kernel launches, counted where the wrapper launches the kernel.
LAUNCHES = {"ssd_scan": 0}

_lib = None
BUILD_INFO: dict = {}


def reset_launch_counts() -> None:
    LAUNCHES["ssd_scan"] = 0


def build() -> ctypes.CDLL:
    """Compile ``csrc/ssd_scan.cu`` (once per source and flag set) and load
    it. Records the seconds taken and the ``-Xptxas -v`` report in
    :data:`BUILD_INFO`; a failed build raises."""
    global _lib
    if _lib is not None:
        return _lib
    lib = build_library(_SRC, BUILD_INFO)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                             i32, i32, i32, i32, i32, i32, i32, ptr]
    lib.ssd_scan.restype = ctypes.c_int
    lib.ssd_scan_smem_bytes.argtypes = [i32, i32, i32]
    lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
    _lib = lib
    return lib


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
    H % G == 0, all float32 on one card -> y (B,H,L,P). Any L: the kernel
    masks the ragged last chunk itself. ``y`` is a (B,H,L,P) view of
    (B,L,H,P) memory when ``x`` is one, else contiguous."""
    _check(x, dt, a_log, b, c, chunk)
    bsz, h, l, p = x.shape
    g, n = b.shape[1], b.shape[3]
    if x.stride(2) > x.stride(1):      # heads inside the sequence: (B,L,H,P)
        y = x.new_empty(bsz, l, h, p).transpose(1, 2)
    else:
        y = x.new_empty(bsz, h, l, p)
    lib = build()
    strides = (ctypes.c_longlong * 15)(*(t.stride(i) for t in (x, dt, b, c, y)
                                         for i in range(3)))
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    with torch.cuda.device(x.device):
        err = lib.ssd_scan(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
                           b.data_ptr(), c.data_ptr(), y.data_ptr(), strides,
                           bsz, h, g, l, p, n, chunk, stream)
    if err != 0:
        raise RuntimeError(
            f"ssd_scan launch failed with cudaError_t {err} (dynamic shared "
            f"memory {lib.ssd_scan_smem_bytes(p, n, chunk)} bytes)")
    LAUNCHES["ssd_scan"] += 1
    return y
