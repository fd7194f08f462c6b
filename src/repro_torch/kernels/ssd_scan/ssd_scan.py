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
``csrc/ssd_scan.cu``. It takes CUDA tensors: ``dt`` and ``a_log`` float32,
``x``, ``b`` and ``c`` float32 or all three bf16. bf16 has stage kernels of
its own in the same source: bf16 rows arrive by ``cp.async`` into bf16
tiles, every product runs on the bf16 tensor cores (``mma.sync``
m16n8k16, fragments by ``ldmatrix``), a bf16 operand enters as it is and a
float32 side as two bf16 halves (hi = bf16(v), lo = bf16(v - hi));
``state_pass`` hands the chunk states on already split; the scratches and
prefix sums are as in float32, and ``y`` is rounded once to bf16. Its
calls also add one to :data:`BF16_LAUNCHES`.
:func:`repro_torch.kernels.ssd_scan.ssd_chunked` is the entry point that
sends a CPU tensor to the plain version instead.

The operands may be strided views (the last dimension contiguous), so the
model passes its ``(B, L, H, P)`` activations and ``(B, L, G, N)`` conv
outputs transposed, without copies; ``y`` is allocated in the layout of
``x``. The wrapper allocates the kernels' three scratches (C·Bᵀ, the
chunk states, the chunk decays; sizes in :func:`stage_report`). Each call
adds one to :data:`LAUNCHES` and each stage kernel one to
:data:`KERNEL_LAUNCHES` where it launches; nothing here synchronises.

Training: when a gradient is wanted (grad mode on and an input that
requires one), :func:`ssd_scan` goes through :class:`SSDScanFunction`,
whose forward is the four stage kernels and keeps their ``states`` scratch
(the state entering each chunk, (B, H, nc, Np, Pp) float32), and whose
backward is six more kernels of the same source in the Mamba2 authors'
chunked matrix form, launched in order (:data:`BWD_STAGES`):
``bwd_chunk_cb`` (the forward's C·Bᵀ again), ``bwd_chunk_state`` (each
chunk's local state gradient), ``bwd_state_pass`` (the state's gradient
carried back over the chunks, the one sequential part), ``bwd_chunk_dc``
and ``bwd_chunk_db`` (dC, dB, dx and the terms of ddA, chunk-parallel on
3xTF32 ``mma.sync``) and ``bwd_ddt`` (ddA's float64 scans, ddt and
dA_log's parts; design and bound in ``csrc/ssd_scan.cu``). dB and dC are
sums over the heads of a group taken with float32 atomics, so their order
varies from run to run; dA_log is the sum of one float64 part a (batch,
head, chunk). Each backward launch adds one to :data:`BWD_LAUNCHES`. No
path differentiates the plain version for a CUDA tensor. The backward
takes N <= 128, and float32 only: a bf16 input that requires a gradient
raises ``NotImplementedError`` (the reference trains in float32; ROADMAP.md
A11).

The shared library is built with ``nvcc`` at first use into ``_build/``
beside this file (listed in ``.gitignore``) and bound with ``ctypes``;
:data:`BUILD_INFO` keeps the ``-Xptxas -v`` report (registers, spills).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import build_library

__all__ = ["LAUNCHES", "BF16_LAUNCHES", "KERNEL_LAUNCHES", "BWD_LAUNCHES", "STAGES",
           "BWD_STAGES",
           "BUILD_INFO", "reset_launch_counts", "build", "stage_report", "ssd_scan",
           "ssd_scan_forward", "ssd_scan_backward", "SSDScanFunction"]

_SRC = Path(__file__).parent / "csrc" / "ssd_scan.cu"
MAX_HEAD_DIM = 128
STAGES = ("chunk_cb", "chunk_state", "state_pass", "chunk_scan")
BWD_STAGES = ("bwd_chunk_cb", "bwd_chunk_state", "bwd_state_pass", "bwd_chunk_dc",
              "bwd_chunk_db", "bwd_ddt")
MAX_BWD_STATE_DIM = 128

# Calls of the entry point, counted where it launches its kernels: all of
# them, and those in bf16.
LAUNCHES = {"ssd_scan": 0}
BF16_LAUNCHES = {"ssd_scan": 0}
# Launches of each stage kernel, counted where the wrapper launches it.
KERNEL_LAUNCHES = dict.fromkeys(STAGES, 0)
# Launches of each backward kernel, counted where the wrapper launches it.
BWD_LAUNCHES = dict.fromkeys(BWD_STAGES, 0)

_lib = None
BUILD_INFO: dict = {}


def reset_launch_counts() -> None:
    LAUNCHES["ssd_scan"] = 0
    BF16_LAUNCHES["ssd_scan"] = 0
    for name in STAGES:
        KERNEL_LAUNCHES[name] = 0
    for name in BWD_STAGES:
        BWD_LAUNCHES[name] = 0


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
    for name in BWD_STAGES:
        fn = getattr(lib, f"ssd_{name}")
        fn.argtypes = [ptr, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
    lib.ssd_bwd_shape.argtypes = [ctypes.c_int, ptr, ptr]
    lib.ssd_bwd_shape.restype = ctypes.c_int
    lib.ssd_bwd_scratch_elems.argtypes = [ptr, ptr]
    lib.ssd_bwd_scratch_elems.restype = ctypes.c_int
    _lib = lib
    return lib


def _dims(batch, heads, groups, seqlen, p, n, chunk, bf16=False):
    return (ctypes.c_int * 8)(batch, heads, groups, seqlen, p, n, chunk, int(bf16))


def stage_report(batch: int, heads: int, groups: int, seqlen: int, p: int, n: int,
                 chunk: int, bf16: bool = False) -> dict:
    """What each stage kernel asks for at these sizes, from the library:
    ``{stage: {"smem_bytes", "blocks", "threads"}}``, and ``"scratch_bytes"``
    of the three scratches (C·Bᵀ, states, decays); ``bf16`` for the bf16
    mode's kernels."""
    lib = build()
    dims = _dims(batch, heads, groups, seqlen, p, n, chunk, bf16)
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
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in named.items():
        want = x.dtype if name in ("x", "b", "c") else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
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


def ssd_scan_forward(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor, *, chunk: int):
    """The four stage kernels on checked operands -> (y, states): ``y`` as
    :func:`ssd_scan` returns it, ``states`` the (B, H, nc, Np, Pp) scratch
    of the state entering each chunk (what the backward recomputes from)."""
    _check(x, dt, a_log, b, c, chunk)
    bsz, h, l, p = x.shape
    g, n = b.shape[1], b.shape[3]
    if x.stride(2) > x.stride(1):      # heads inside the sequence: (B,L,H,P)
        y = x.new_empty(bsz, l, h, p).transpose(1, 2)
    else:
        y = x.new_empty(bsz, h, l, p)
    if y.numel() == 0:
        LAUNCHES["ssd_scan"] += 1
        return y, x.new_empty(0)
    lib = build()
    bf16 = x.dtype == torch.bfloat16
    dims = _dims(bsz, h, g, l, p, n, chunk, bf16)
    elems = (ctypes.c_longlong * 3)()
    if lib.ssd_scratch_elems(dims, elems) != 0:
        raise ValueError(f"ssd_scan does not take {tuple(dims)[:7]}")
    cb, states, decay = (torch.empty(k, dtype=torch.float32, device=x.device) for k in elems)
    ptrs = (ctypes.c_void_p * 9)(*(t.data_ptr() for t in (x, dt, a_log, b, c, y, cb,
                                                          states, decay)))
    strides = (ctypes.c_longlong * 15)(*(t.stride(i) for t in (x, dt, b, c, y)
                                         for i in range(3)))
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    with torch.cuda.device(x.device):
        for name in STAGES:
            err = getattr(lib, f"ssd_{name}")(ptrs, strides, dims, stream)
            if err != 0:
                report = stage_report(bsz, h, g, l, p, n, chunk, bf16)
                shapes = ", ".join(f"{k} {report[k]['smem_bytes']} bytes x "
                                   f"{report[k]['blocks']} blocks" for k in STAGES)
                raise RuntimeError(f"ssd_scan's {name} kernel failed with cudaError_t "
                                   f"{err} (dynamic shared memory a block: {shapes})")
            KERNEL_LAUNCHES[name] += 1
    LAUNCHES["ssd_scan"] += 1
    if bf16:
        BF16_LAUNCHES["ssd_scan"] += 1
    return y, states


def ssd_scan_backward(x, dt, a_log, b, c, states, dy, *, chunk: int):
    """The six backward kernels -> (dx, ddt, da_log, db, dc), the gradients
    of the loss with respect to the operands of :func:`ssd_scan_forward`,
    given ``dy`` and the forward's ``states``. dx is laid out as x, the rest
    contiguous; db and dc sum over the heads of each group. A failed launch
    raises."""
    _check(x, dt, a_log, b, c, chunk)
    if x.dtype != torch.float32:
        raise NotImplementedError(f"ssd_scan's backward kernels take float32, got {x.dtype} "
                                  f"(ROADMAP.md A11)")
    bsz, h, l, p = x.shape
    g, n = b.shape[1], b.shape[3]
    if n > MAX_BWD_STATE_DIM:
        raise ValueError(f"the backward takes state dim <= {MAX_BWD_STATE_DIM}, got {n}")
    if dy.stride(3) != 1:
        dy = dy.contiguous()
    if x.stride(2) > x.stride(1):
        dx = x.new_empty(bsz, l, h, p).transpose(1, 2)
    else:
        dx = x.new_empty(bsz, h, l, p)
    ddt = x.new_empty(bsz, h, l)
    db = x.new_zeros(bsz, g, l, n)
    dc = x.new_zeros(bsz, g, l, n)
    if dx.numel() == 0:
        return dx, ddt, torch.zeros_like(a_log), db, dc
    lib = build()
    dims = _dims(bsz, h, g, l, p, n, chunk)
    elems = (ctypes.c_longlong * 6)()
    if lib.ssd_bwd_scratch_elems(dims, elems) != 0:
        raise ValueError(f"ssd_scan's backward does not take {tuple(dims)}")
    cb, gstates, decay, rowterms, colterms = (x.new_empty(k) for k in elems[:5])
    dalog = x.new_empty(elems[5], dtype=torch.float64)
    ptrs = (ctypes.c_void_p * 17)(*(t.data_ptr() for t in (
        x, dt, a_log, b, c, dy, states, cb, gstates, decay, rowterms, colterms, dalog, dx, ddt,
        db, dc)))
    strides = (ctypes.c_longlong * 27)(*(t.stride(i) for t in (x, dt, b, c, dy, dx, ddt,
                                                               db, dc) for i in range(3)))
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    with torch.cuda.device(x.device):
        for i, name in enumerate(BWD_STAGES):
            err = getattr(lib, f"ssd_{name}")(ptrs, strides, dims, stream)
            if err != 0:
                shape = (ctypes.c_longlong * 3)()
                lib.ssd_bwd_shape(i, dims, shape)
                raise RuntimeError(f"ssd_scan's {name} kernel failed with cudaError_t "
                                   f"{err} (dynamic shared memory {shape[0]} bytes x "
                                   f"{shape[1]} blocks)")
            BWD_LAUNCHES[name] += 1
    # One float64 part a (batch, head, chunk), summed in a fixed order.
    da_log = dalog.view(bsz, h, -1).sum((0, 2)).to(a_log.dtype)
    return dx, ddt, da_log, db, dc


class SSDScanFunction(torch.autograd.Function):
    """The SSD scan with its gradient from the backward kernels: the forward
    keeps the operands and the entering states; the backward launches the
    six kernels of :data:`BWD_STAGES`."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, chunk: int):
        y, states = ssd_scan_forward(x, dt, a_log, b, c, chunk=chunk)
        ctx.save_for_backward(x, dt, a_log, b, c, states)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, a_log, b, c, states = ctx.saved_tensors
        return (*ssd_scan_backward(x, dt, a_log, b, c, states, dy, chunk=ctx.chunk), None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """x (B,H,L,P), dt (B,H,L) post-softplus, a_log (H,), b/c (B,G,L,N) with
    H % G == 0, on one card: dt and a_log float32, x, b and c float32 or
    all bf16 -> y (B,H,L,P) in x's dtype. Any L: the kernels mask the
    ragged last chunk themselves. ``y`` is a (B,H,L,P) view of (B,L,H,P)
    memory when ``x`` is one, else contiguous. When a gradient is wanted the
    call goes through :class:`SSDScanFunction` (the backward kernels,
    float32 only: bf16 raises)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, a_log, b, c)):
        _check(x, dt, a_log, b, c, chunk)
        if x.dtype == torch.bfloat16:
            raise NotImplementedError(
                "ssd_scan's backward kernels are float32: a bf16 input that requires a "
                "gradient has no backward (the reference trains in float32; ROADMAP.md A11)")
        return SSDScanFunction.apply(x, dt, a_log, b, c, chunk)
    return ssd_scan_forward(x, dt, a_log, b, c, chunk=chunk)[0]
