#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and this checkout; exits
non-zero without them, and on any failed phase. It imports nothing of JAX
or of the JAX package ``repro``. Phases, in order:

1. the card (``nvidia-smi`` name and power limit) and the versions;
2. the build of the qdq kernels with ``nvcc`` (seconds, registers, spills);
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes and with the main path's own payloads and side
   information, at bits 2, 4 and 8: ``qdq_rows_rng`` with 0 differing
   elements, ``qdq_delta_rows_rng`` within 1 ulp; each kernel's time
   (CUDA events), its plain version's time and its bound;
4. the quantize wire kernels, see :func:`wire_phase`: the six given-uniform
   and int8 kernels against their plain versions on the aggregation
   payload of phase 3 (R = 99,776 rows) at bits 2, 4 and 8, with 0
   differing elements (``qdq_delta_rows`` within 1 ulp), timed; then the
   quantize package's entry points on the card (``stochastic_quantize``,
   ``stochastic_dequantize``, ``segment_quantize_dequantize`` with given
   uniforms, ``quantize_rows`` -> ``dequantize_rows``), one launch of each
   kernel, against the CPU; the segment side information twice, bit for
   bit;
5. a small configuration run on the CPU and on the card from the same
   weights and seed words, compared (fp32: rtol 1e-4; bits=8: within
   0.05 * scale + 1e-4, as tests/test_torch_dfedrw.py);
6. the main path through ``train_loop``: QDFedRW (bits=8) and DFedRW
   (bits=32), 5 rounds each, at the paper's 3FNN (784-200-200-10), n=100
   devices on a complete graph, 60,000 samples, M=K=8, B=50; ms per round,
   loss, accuracy, peak memory and the kernel launch counts, which must be
   K*rounds and rounds at bits=8 (and none of the wire kernels);
7. a profile of two rounds at bits=8 (device busy and idle share);
8. the launcher, ``repro_torch.launch.train.main``, on the card;
9. the Mamba2 slice (``configs.mamba2_130m`` as the registry gives it,
   float32, TF32 off), see :func:`mamba_phases`: the ``ssd_scan`` kernel against its
   plain version on layer 0's own inputs from a full-width forward, the
   SMOKE configuration on the CPU and the card, ``loss_fn`` at full width
   (8 x 2,048 tokens, 24 kernel launches a forward) and recurrent decode;
10. the dense GQA slice (``configs.yi_6b`` as the registry gives it, float32,
   TF32 off, after the Mamba2 state is freed), see :func:`dense_phases`: the
   ``block_attn`` kernel against its plain version on layer 0's own q/k/v
   of a full-width forward (B = 2, L = 4,096, 32 heads, 4 KV heads, hd 128)
   and at small shapes (ragged L, MQA, hd 64 and 16, non-causal, window
   512), timed beside its plain version and PyTorch's fp32
   ``scaled_dot_product_attention`` (GQA on the first backend that takes
   it, and the memory-efficient backend on K/V repeated to every head);
   the SMOKE configuration on the CPU and
   the card; ``loss_fn`` at full width (2 x 4,096 tokens, 32 kernel
   launches a forward) with a profile; greedy decode at batch 8 against the
   kernel forward;
11. one JSON line of kernel numbers (all ten kernels), and last the device
   line.

The three kernel sources are built at the start, one ``nvcc`` each, in
parallel.
"""
from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory bandwidth
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
# Integer and float operations per element of one qdq pass, counted from
# csrc/qdq_rows.cu: 18 for the counter hash, 14 for the grid arithmetic.
OPS_PER_ELEMENT = 32
LANES_BYTES = 128 * 4          # one 128-lane float32 row
REPLACES = {
    "qdq_delta_rows_rng": "src/repro/kernels/quantize/quantize.py:156 _qdq_delta_rows_rng_kernel",
    "qdq_rows_rng": "src/repro/kernels/quantize/quantize.py:171 _qdq_rows_rng_kernel",
}
SOURCE = "src/repro_torch/kernels/quantize/csrc/qdq_rows.cu"
WIRE_REPLACES = {
    "qdq_delta_rows": "src/repro/kernels/quantize/quantize.py:115 _qdq_delta_rows_kernel",
    "qdq_rows": "src/repro/kernels/quantize/quantize.py:99 _qdq_rows_kernel",
    "quantize_rows": "src/repro/kernels/quantize/quantize.py:81 _quantize_rows_kernel",
    "dequantize_rows": "src/repro/kernels/quantize/quantize.py:94 _dequantize_rows_kernel",
    "quantize": "src/repro/kernels/quantize/quantize.py:41 _quantize_kernel",
    "dequantize": "src/repro/kernels/quantize/quantize.py:53 _dequantize_kernel",
}
# Bytes each wire kernel must move: (float32 planes of 128 lanes read or
# written per row, int8 planes per row, bytes per row of the (s, norm)
# pair, bytes read once: the one float32 norm of quantize/dequantize).
WIRE_TRAFFIC = {
    "qdq_delta_rows": (4, 0, 8, 0),     # w, base, u in; out
    "qdq_rows": (3, 0, 8, 0),           # w, u in; out
    "quantize_rows": (2, 1, 8, 0),      # w, u in; int8 out
    "dequantize_rows": (1, 1, 8, 0),    # int8 in; out
    "quantize": (2, 1, 0, 4),
    "dequantize": (1, 1, 0, 4),
}
# Float operations per element, counted from csrc/qdq_rows.cu: 13 for the
# signed grid index, 2 more for deq (+ base in one FMA); 3 and 2 for the
# dequantize kernels (convert and multiplies).
WIRE_OPS = {"qdq_delta_rows": 15, "qdq_rows": 15, "quantize_rows": 13,
            "dequantize_rows": 3, "quantize": 13, "dequantize": 2}
ROUNDS = 5
SPIN_CYCLES = 200_000_000      # ~0.1 s at the H100's clock: longer than queuing a timing loop
SSD_REPLACES = "src/repro/kernels/ssd_scan/ssd_scan.py:32 _ssd_kernel"
SSD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
SSD_TOL = 2e-4                 # abs and rel: fp32 summed in another order (tests/test_kernels_ssd.py)
SMOKE_TOL = 1e-4               # abs and rel: the SMOKE model on the CPU and on the card
DECODE_TOL = 2e-3              # abs and rel: decode vs forward (tests/test_decode_consistency.py)
LM_BATCH, LM_SEQ, LM_FORWARDS = 8, 2048, 5
PROMPT, GENERATE = 64, 32
ATTN_REPLACES = "src/repro/kernels/block_attn/block_attn.py:32 _attn_kernel"
ATTN_SOURCE = "src/repro_torch/kernels/block_attn/csrc/block_attn.cu"
ATTN_TOL = 1e-4                # abs and rel: fp32, online vs materialized softmax
YI_BATCH, YI_SEQ, YI_FORWARDS = 2, 4096, 3     # Yi-6B's published context length
YI_DECODE_BATCH = 8
# (B, Lq, Lk, H, KV, hd, causal, window): ragged L, MQA, hd 64 and 16,
# non-causal, Lq != Lk, and the sliding window.
ATTN_SMALL = [
    (1, 1000, 1000, 8, 2, 128, True, 0),
    (2, 333, 333, 8, 1, 128, True, 0),
    (2, 256, 256, 4, 4, 64, True, 0),
    (1, 300, 300, 8, 8, 128, False, 0),
    (1, 77, 130, 4, 2, 16, False, 0),
    (1, 2048, 2048, 8, 2, 128, True, 512),
]


def _ulps(a, b):
    import torch

    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()


def _time_ms(fn, iters, warmup=3):
    """Device time per call. A spin kernel first keeps the card busy while
    the host queues every call, so the events bracket device work alone and
    not the host's launch overhead."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _profile(label, run, top=12):
    """Device busy time and idle share of ``run()`` under torch.profiler, and
    its largest device items by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device-side events only (kernels, copies, fills), busy time as the
    # union of their intervals; operator rows would count each kernel twice.
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((ev.time_range.start, ev.time_range.end))
            tot, cnt = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (tot + ev.time_range.elapsed_us(), cnt + 1)
    busy_us, reach = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy_us += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    if busy_us > 0:
        print(f"profile {label}: wall_us={wall_us:.1f} device_busy_us={busy_us:.1f} "
              f"idle_share={1 - busy_us / wall_us:.4f} device_events={len(spans)}")
        for name, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
            print(f"profile: {tot:10.1f} us x{cnt:<4d} {name[:100]}")
    else:
        print(f"profile {label}: no device time in the trace (not measured)")


def _fail(message):
    """A failed phase: the script prints the reason and exits with code 1."""
    raise SystemExit(f"FAIL: {message}")


def _tol_ratio(got, want, tol):
    """max |got - want| / (tol + tol |want|): at most 1 within ``tol`` abs+rel."""
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _first_call(module, attr, run):
    """Run ``run()`` with ``module.attr`` wrapped so that the arguments of
    its first call are kept. Returns (args, kwargs, number of calls)."""
    kept = []
    real = getattr(module, attr)

    def keep(*args, **kw):
        kept.append((args, kw) if not kept else None)
        return real(*args, **kw)

    setattr(module, attr, keep)
    try:
        run()
    finally:
        setattr(module, attr, real)
    return kept[0][0], kept[0][1], len(kept)


def _smoke_phase(arch_id, km, tag):
    """The SMOKE configuration on the CPU (plain versions) and on the card
    (kernel module ``km``) from the same weights: a (2, 80) forward and 16
    decode steps within SMOKE_TOL, and one launch a layer."""
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as T

    small = get_smoke(arch_id)
    (name,) = km.LAUNCHES
    on_cpu = T.init_params(small, torch.Generator().manual_seed(2), device="cpu")
    on_card = _tree_to(on_cpu, "cuda")
    toks = torch.randint(0, small.vocab, (2, 80), generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        want, _ = T.forward_train(small, on_cpu, toks)
        km.reset_launch_counts()
        got, _ = T.forward_train(small, on_card, toks.cuda())
        launches = km.LAUNCHES[name]
        caches = [T.init_cache(small, 2, 16, device="cpu"), T.init_cache(small, 2, 16)]
        worst_dec = 0.0
        for t in range(16):
            lg_cpu, caches[0] = T.decode_step(small, on_cpu, caches[0], toks[:, t:t + 1])
            lg_card, caches[1] = T.decode_step(small, on_card, caches[1], toks[:, t:t + 1].cuda())
            worst_dec = max(worst_dec, _tol_ratio(lg_card.cpu(), lg_cpu, SMOKE_TOL))
    fwd_ratio = _tol_ratio(got.cpu(), want, SMOKE_TOL)
    print(f"{small.name} {tag}: forward (2, 80) cpu-vs-card max|d|="
          f"{float((got.cpu() - want).abs().max()):.3e} ratio={fwd_ratio:.4f}; 16 decode steps "
          f"ratio={worst_dec:.4f} (tol {SMOKE_TOL}); {name} launches={launches}")
    if fwd_ratio > 1.0 or worst_dec > 1.0 or launches != small.n_layers:
        _fail(f"the SMOKE {arch_id} model disagrees between the CPU and the card")


def _forward_phase(cfg, params, batch, forwards, km, tag):
    """The main path: ``loss_fn`` at full width, ``forwards`` times (ms per
    forward, tokens/s, peak memory), which must launch the kernel of ``km``
    once a layer; then one forward under the profiler. Returns the
    launches."""
    import torch

    from repro_torch.models import transformer as T

    (name,) = km.LAUNCHES
    bsz, seq = batch["tokens"].shape
    torch.cuda.reset_peak_memory_stats()
    stamps, losses = [], []
    km.reset_launch_counts()
    with torch.inference_mode():
        for _ in range(forwards):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(T.loss_fn(cfg, params, batch))
            torch.cuda.synchronize()
            stamps.append((time.perf_counter() - t0) * 1e3)
    launches = km.LAUNCHES[name]
    peak = torch.cuda.max_memory_allocated()
    fwd_ms = statistics.median(stamps)
    losses = [float(x) for x in losses]
    print(f"{cfg.name} main path {tag}: loss_fn on {bsz}x{seq} tokens: ms/forward "
          f"median={fwd_ms:.3f} all={[round(x, 3) for x in stamps]} tokens/s="
          f"{bsz * seq / fwd_ms * 1e3:.1f} loss={losses[0]:.6f} "
          f"peak_memory_allocated={peak} bytes {name} launches={launches} "
          f"(want {cfg.n_layers} x {forwards})")
    if launches != cfg.n_layers * forwards or not all(math.isfinite(x) for x in losses):
        _fail(f"main path: {launches} {name} launches in {forwards} forwards "
              f"(want {cfg.n_layers * forwards}), losses {losses}")
    with torch.inference_mode():
        _profile(f"{cfg.name} loss_fn {bsz}x{seq} (1 forward) {tag}",
                 lambda: T.loss_fn(cfg, params, batch))
    return launches


def _decode_phase(cfg, params, prompts, n_params, km, tag):
    """Greedy decode at full width: PROMPT tokens of each prompt, then
    GENERATE greedy tokens, through ``decode_step`` (ms per step beside the
    weight-read bound), held against the kernel forward over the same
    sequence within DECODE_TOL; then 4 steps under the profiler."""
    import torch

    from repro_torch.models import transformer as T

    (name,) = km.LAUNCHES
    batch = prompts.shape[0]
    seqs = [prompts]
    step_ms, dec_logits = [], []
    with torch.inference_mode():
        cache = T.init_cache(cfg, batch, PROMPT + GENERATE)
        nxt = prompts[:, :1]
        for t in range(PROMPT + GENERATE):
            tok = prompts[:, t:t + 1] if t < PROMPT else nxt
            if t >= PROMPT:
                seqs.append(tok)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = T.decode_step(cfg, params, cache, tok)
            nxt = lg[:, -1].argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            dec_logits.append(lg[:, 0])
        km.reset_launch_counts()
        fwd_logits, _ = T.forward_train(cfg, params, torch.cat(seqs, dim=1))
        launches = km.LAUNCHES[name]
    dec = torch.stack(dec_logits, dim=1)
    ratio = _tol_ratio(dec, fwd_logits, DECODE_TOL)
    prompt_ratio = _tol_ratio(dec[:, :PROMPT], fwd_logits[:, :PROMPT], DECODE_TOL)
    step_med = statistics.median(step_ms[2:])
    weight_ms = 4 * n_params / HBM_BYTES_PER_S * 1e3
    print(f"{cfg.name} decode {tag}: {batch} prompts x {PROMPT} tokens + {GENERATE} greedy: "
          f"ms/step median={step_med:.3f} prompt={statistics.median(step_ms[2:PROMPT]):.3f} "
          f"generate={statistics.median(step_ms[PROMPT:]):.3f} (weight-read bound "
          f"{weight_ms:.3f} ms = {weight_ms / step_med:.3f} of it); decode vs kernel forward "
          f"({launches} {name} launches) max|d|={float((dec - fwd_logits).abs().max()):.3e} "
          f"ratio prompt={prompt_ratio:.4f} all {PROMPT + GENERATE}={ratio:.4f} "
          f"(tol {DECODE_TOL})")
    if ratio > 1.0 or not torch.isfinite(dec).all() or launches != cfg.n_layers:
        _fail(f"decode disagrees with the kernel forward at {cfg.name}'s full width")

    def decode_steps():
        c = cache
        for t in range(4):
            _, c = T.decode_step(cfg, params, c, prompts[:, t:t + 1])

    with torch.inference_mode():
        _profile(f"{cfg.name} decode batch {batch} (4 steps) {tag}", decode_steps)


def mamba_phases(smi):
    """The Mamba2 slice on the card. Returns the ``ssd_scan`` entry of the
    kernels line; a failed phase exits non-zero."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_plain, ssd_sequential_ref
    from repro_torch.models import transformer as T

    tag = f"[{smi}]"
    # The registry's config as a user gets it: the mixer sends every CUDA
    # tensor to the kernel, whatever use_pallas_ssd says.
    cfg = get_arch("mamba2-130m")
    s = cfg.ssm
    heads = s.expand * cfg.d_model // s.head_dim
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"mamba2 {tag}: {cfg.name} n_layers={cfg.n_layers} d_model={cfg.d_model} "
          f"heads={heads} P={s.head_dim} N={s.state_dim} G={s.n_groups} chunk={s.chunk} "
          f"vocab={cfg.vocab} params={n_params} (param_count {cfg.param_count()}) "
          f"init {time.perf_counter() - t0:.2f}s")
    tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_SEQ + 1),
                           generator=torch.Generator().manual_seed(1)).cuda()
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    # One forward whose first SSD call is kept: the kernel is then checked on
    # layer 0's own inputs, in the model's own strided layout.
    with torch.inference_mode():
        (x, dt, a_log, b, c), kw, calls = _first_call(
            ssd_ops, "ssd_chunked", lambda: T.loss_fn(cfg, params, batch))
    torch.cuda.synchronize()
    if calls != cfg.n_layers:
        _fail(f"the forward called ssd_chunked {calls} times, want {cfg.n_layers}")

    # -------------------------------------------- ssd_scan vs plain version
    chunk = kw["chunk"]
    bsz, h, l, p = x.shape
    g, n = b.shape[1], b.shape[3]
    with torch.inference_mode():
        got = sk.ssd_scan(x, dt, a_log, b, c, chunk=chunk)
        want, _ = ssd_chunked_plain(x, dt, a_log, b, c, chunk)
        seq = ssd_sequential_ref(x[:1, :1], dt[:1, :1], a_log[:1], b[:1, :1], c[:1, :1])
    torch.cuda.synchronize()
    diff = (got - want).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / want.abs()).nan_to_num(0.0, 0.0, 0.0).max())
    ratio = _tol_ratio(got, want, SSD_TOL)
    seq_abs = float((got[:1, :1] - seq).abs().max())
    seq_ratio = _tol_ratio(got[:1, :1], seq, SSD_TOL)
    print(f"ssd_scan {tag}: layer 0 x{tuple(x.shape)} strides {x.stride()} B/C{tuple(b.shape)} "
          f"chunk={chunk}: vs plain max|d|={max_abs:.3e} max rel={max_rel:.3e} "
          f"|d|/(tol+tol|y|)={ratio:.4f} (tol {SSD_TOL}); vs sequential at (b,h)=(0,0) "
          f"max|d|={seq_abs:.3e} ratio={seq_ratio:.4f}; max|y|={float(want.abs().max()):.3e}")
    if not (ratio <= 1.0 and seq_ratio <= 1.0 and torch.isfinite(got).all()):
        _fail(f"ssd_scan disagrees with its plain version (ratio {ratio:.4f}) "
              f"or the sequential recurrence (ratio {seq_ratio:.4f})")
    # The operations the function needs: C.B^T and (scores o L).xdt on the
    # causal pairs j <= i of each chunk only (the upper triangle is zero),
    # C.S_in and the state update on every row; each chunk at its own length.
    lens = [min(chunk, l - k) for k in range(0, l, chunk)]
    flop = bsz * h * sum(c * (c + 1) * (n + p) + 4 * c * n * p for c in lens)
    nbytes = 4 * (2 * bsz * h * l * p + bsz * h * l + 2 * bsz * g * l * n + h)
    bound_ops_ms = flop / FP32_OPS_PER_S * 1e3
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    with torch.inference_mode():
        ms = statistics.median(_time_ms(lambda: sk.ssd_scan(x, dt, a_log, b, c, chunk=chunk),
                                        iters=10) for _ in range(5))
        plain_ms = statistics.median(_time_ms(lambda: ssd_chunked_plain(x, dt, a_log, b, c, chunk),
                                              iters=3, warmup=1) for _ in range(3))
    bound_ms = max(bound_ops_ms, bound_bytes_ms)
    print(f"ssd_scan {tag}: dynamic shared memory "
          f"{sk.build().ssd_scan_smem_bytes(p, n, chunk)} bytes a block, {bsz * h} blocks")
    print(f"ssd_scan {tag}: ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
          f"(ops {flop} FLOP, {bound_ops_ms:.4f} ms at {FP32_OPS_PER_S:.0e}/s; bytes {nbytes}, "
          f"{bound_bytes_ms:.4f} ms) achieved {flop / ms / 1e9:.2f} TFLOP/s "
          f"= {bound_ms / ms:.3f} of the bound")
    del x, dt, b, c, got, want, seq, diff     # out of the main path's peak memory
    entry = {"name": "ssd_scan", "route": "cuda", "source": SSD_SOURCE,
             "replaces": SSD_REPLACES, "launches": None, "max_abs_err": max_abs,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": "operations" if bound_ops_ms >= bound_bytes_ms else "bytes",
             "library_ms": None}

    _smoke_phase("mamba2-130m", sk, tag)
    entry["launches"] = _forward_phase(cfg, params, batch, LM_FORWARDS, sk, tag)
    _decode_phase(cfg, params, tokens[:, :PROMPT], n_params, sk, tag)
    return entry


def _time_sdpa(q, k, v, want, backends=("FLASH_ATTENTION", "EFFICIENT_ATTENTION",
                                         "CUDNN_ATTENTION", "MATH")):
    """PyTorch's one call for the same function, timed as a yardstick only
    (the port never calls it): fp32 ``scaled_dot_product_attention`` with
    ``is_causal`` (and ``enable_gqa`` when K/V have fewer heads than q), on
    the first of ``backends`` that takes it. Returns (backend name, ms,
    max |d| against the kernel), or Nones."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    gqa = k.shape[2] != q.shape[2]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    for name in backends:
        backend = getattr(SDPBackend, name)

        def call():
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                      enable_gqa=gqa)
        try:
            with warnings.catch_warnings():     # each refusal warns why, at length
                warnings.simplefilter("ignore")
                out = call().transpose(1, 2)
        except RuntimeError:
            continue
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        del out
        ms = statistics.median(_time_ms(call, iters=5, warmup=1) for _ in range(3))
        return name, ms, err
    return None, None, None


def dense_phases(smi):
    """The dense GQA slice on the card at Yi-6B's full width. Returns the
    ``block_attn`` entry of the kernels line; a failed phase exits non-zero."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.block_attn import block_attn as ba
    from repro_torch.kernels.block_attn import ops as attn_ops
    from repro_torch.kernels.block_attn.ref import attention_pairs, block_attention_plain
    from repro_torch.models import transformer as T

    tag = f"[{smi}]"
    cfg = get_arch("yi-6b")
    hd = cfg.head_dim_
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"yi-6b {tag}: n_layers={cfg.n_layers} d_model={cfg.d_model} heads={cfg.n_heads} "
          f"kv_heads={cfg.n_kv_heads} hd={hd} d_ff={cfg.d_ff} vocab={cfg.vocab} "
          f"rope_theta={cfg.rope_theta} params={n_params} ({4 * n_params} bytes float32; "
          f"param_count {cfg.param_count()}) init on the card {time.perf_counter() - t0:.2f}s")
    tokens = torch.randint(0, cfg.vocab, (YI_BATCH, YI_SEQ + 1),
                           generator=torch.Generator().manual_seed(1)).cuda()
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    # One forward whose first attention call is kept: the kernel is then
    # checked on layer 0's own q/k/v.
    with torch.inference_mode():
        (q, k, v), kw, calls = _first_call(attn_ops, "block_attention",
                                           lambda: T.loss_fn(cfg, params, batch))
    torch.cuda.synchronize()
    if calls != cfg.n_layers:
        _fail(f"the forward called block_attention {calls} times, want {cfg.n_layers}")

    # ------------------------------------------ block_attn vs plain version
    if kw != {"causal": True, "window": 0}:
        _fail(f"layer 0 called block_attention with {kw}")
    bsz, l, h, _ = q.shape
    with torch.inference_mode():
        got = ba.block_attn(q, k, v, causal=True)
        want = block_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    ratio = _tol_ratio(got, want, ATTN_TOL)
    print(f"block_attn {tag}: layer 0 q{tuple(q.shape)} k/v{tuple(k.shape)} strides "
          f"{q.stride()}/{k.stride()} causal: vs plain max|d|={max_abs:.3e} "
          f"|d|/(tol+tol|o|)={ratio:.4f} (tol {ATTN_TOL}); max|o|={float(want.abs().max()):.3e}")
    if not (ratio <= 1.0 and torch.isfinite(got).all()):
        _fail(f"block_attn disagrees with its plain version at Yi-6B's shapes (ratio {ratio:.4f})")
    gen = torch.Generator("cuda").manual_seed(4)
    for b_, lq, lk, h_, kv_, hd_, causal, window in ATTN_SMALL:
        qs, ks, vs = (torch.randn(b_, n, heads, hd_, generator=gen, device="cuda")
                      for n, heads in ((lq, h_), (lk, kv_), (lk, kv_)))
        with torch.inference_mode():
            o = ba.block_attn(qs, ks, vs, causal=causal, window=window)
            ref = block_attention_plain(qs, ks, vs, causal=causal, window=window)
        torch.cuda.synchronize()
        r = _tol_ratio(o, ref, ATTN_TOL)
        print(f"block_attn {tag}: B={b_} Lq={lq} Lk={lk} H={h_} KV={kv_} hd={hd_} "
              f"causal={causal} window={window}: max|d|={float((o - ref).abs().max()):.3e} "
              f"ratio={r:.4f}")
        if not (r <= 1.0 and torch.isfinite(o).all()):
            _fail(f"block_attn disagrees with its plain version at B={b_} Lq={lq} Lk={lk} "
                  f"H={h_} KV={kv_} hd={hd_} causal={causal} window={window}")

    # The function's work: 4 hd FLOP per allowed (i, j) pair, and one read
    # of q, k, v and one write of o.
    flop = 4 * hd * attention_pairs(l, l, causal=True) * bsz * h
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    bound_ops_ms = flop / FP32_OPS_PER_S * 1e3
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(bound_ops_ms, bound_bytes_ms)
    with torch.inference_mode():
        ms = statistics.median(_time_ms(lambda: ba.block_attn(q, k, v), iters=10)
                               for _ in range(5))
        plain_ms = statistics.median(_time_ms(lambda: block_attention_plain(q, k, v),
                                              iters=3, warmup=1) for _ in range(3))
        backend, library_ms, library_err = _time_sdpa(q, k, v, got)
        # A fused fp32 yardstick beside it: the memory-efficient backend
        # refuses fp32 GQA, so it gets K/V repeated to every query head
        # (the repeat is not timed).
        kx, vx = (t.repeat_interleave(h // k.shape[2], dim=2) for t in (k, v))
        _, fused_ms, fused_err = _time_sdpa(q, kx, vx, got, ("EFFICIENT_ATTENTION",))
        del kx, vx
    print(f"block_attn {tag}: dynamic shared memory {ba.build().block_attn_smem_bytes(hd)} "
          f"bytes a block, {bsz * h * -(-l // 64)} blocks")
    print(f"block_attn {tag}: ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
          f"(ops {flop} FLOP, {bound_ops_ms:.4f} ms at {FP32_OPS_PER_S:.0e}/s; bytes {nbytes}, "
          f"{bound_bytes_ms:.4f} ms) achieved {flop / ms / 1e9:.2f} TFLOP/s "
          f"= {bound_ms / ms:.3f} of the bound")
    print(f"block_attn {tag}: library fp32 scaled_dot_product_attention(is_causal, enable_gqa) "
          f"backend={backend} ms={library_ms} max|d| vs kernel={library_err}")
    print(f"block_attn {tag}: fp32 scaled_dot_product_attention(is_causal) on K/V repeated "
          f"to {h} heads, backend=EFFICIENT_ATTENTION ms={fused_ms} "
          f"max|d| vs kernel={fused_err}")
    del q, k, v, got, want
    entry = {"name": "block_attn", "route": "cuda", "source": ATTN_SOURCE,
             "replaces": ATTN_REPLACES, "launches": None, "max_abs_err": max_abs,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": "operations" if bound_ops_ms >= bound_bytes_ms else "bytes",
             "library_ms": library_ms}

    _smoke_phase("yi-6b", ba, tag)
    entry["launches"] = _forward_phase(cfg, params, batch, YI_FORWARDS, ba, tag)
    prompts = tokens[:, :YI_DECODE_BATCH // YI_BATCH * PROMPT].reshape(YI_DECODE_BATCH, PROMPT)
    _decode_phase(cfg, params, prompts, n_params, ba, tag)
    return entry



def _differs(got, want):
    """(elements that differ, most ulps apart): float32 and bfloat16 by
    their bits, int8 by value."""
    import torch

    if got.dtype == torch.int8:
        d = (got.int() - want.int()).abs()
    else:
        bits_as = torch.int32 if got.dtype == torch.float32 else torch.int16
        d = (got.view(bits_as).long() - want.view(bits_as).long()).abs()
    return int((d > 0).sum()), int(d.max())


def wire_phase(w2d, spec, n_msgs, tag):
    """The six quantize wire kernels on the card, on the main path's own
    Eq. 14 aggregation payload ``w2d`` (``n_msgs`` messages of ``spec``),
    with ``payload_side_info``'s per-row (s, norm), uniforms and a base
    drawn by ``torch.Generator("cuda")``; the fixed-s kernels on the same
    elements as one tensor with one norm. Each against its plain version at
    bits 2, 4 and 8 and timed; then the quantize package's entry points
    with the counts from 0, against the CPU. Returns the six entries of the
    kernels line; a failed check exits non-zero."""
    import torch

    from repro_torch.kernels.quantize import ops, payload_side_info
    from repro_torch.kernels.quantize import quantize as qk

    rows = w2d.shape[0]
    gen = torch.Generator("cuda").manual_seed(5)
    u = torch.rand(w2d.shape, generator=gen, device="cuda")
    base = torch.randn(w2d.shape, generator=gen, device="cuda")
    total = torch.sqrt(torch.sum(w2d * w2d))
    bf16 = torch.bfloat16
    entries = {}
    for bits in (2, 4, 8):
        s_rows, n_rows = payload_side_info(w2d.reshape(n_msgs, spec.d_pad), spec,
                                           per_message=True, bits=bits)
        fixed = 1.0 / ((1 << (bits - 1)) - 1)
        q_rows = qk.quantize_rows_plain(w2d, u, s_rows, n_rows, bits=bits)
        q_one = qk.quantize_plain(w2d, u, total, s=fixed, bits=bits)
        # name: (kernel on a payload it may write over, plain version,
        # ulps allowed, the same with a bfloat16 result or None)
        cases = {
            "qdq_delta_rows": (
                lambda w: qk.qdq_delta_rows(w, base, u, s_rows, n_rows, bits=bits),
                lambda: qk.qdq_delta_rows_plain(w2d, base, u, s_rows, n_rows, bits=bits),
                1, None),
            "qdq_rows": (
                lambda w: qk.qdq_rows(w, u, s_rows, n_rows, bits=bits),
                lambda: qk.qdq_rows_plain(w2d, u, s_rows, n_rows, bits=bits), 0, None),
            "quantize_rows": (
                lambda w: qk.quantize_rows(w, u, s_rows, n_rows, bits=bits),
                lambda: qk.quantize_rows_plain(w2d, u, s_rows, n_rows, bits=bits), 0, None),
            "dequantize_rows": (
                lambda w: qk.dequantize_rows(q_rows, s_rows, n_rows),
                lambda: qk.dequantize_rows_plain(q_rows, s_rows, n_rows), 0,
                (lambda: qk.dequantize_rows(q_rows, s_rows, n_rows, out_dtype=bf16),
                 lambda: qk.dequantize_rows_plain(q_rows, s_rows, n_rows, out_dtype=bf16))),
            "quantize": (
                lambda w: qk.quantize(w, u, total, s=fixed, bits=bits),
                lambda: qk.quantize_plain(w2d, u, total, s=fixed, bits=bits), 0, None),
            "dequantize": (
                lambda w: qk.dequantize(q_one, total, s=fixed),
                lambda: qk.dequantize_plain(q_one, total, s=fixed), 0,
                (lambda: qk.dequantize(q_one, total, s=fixed, out_dtype=bf16),
                 lambda: qk.dequantize_plain(q_one, total, s=fixed, out_dtype=bf16))),
        }
        for name, (kern, plain, limit, bf16_pair) in cases.items():
            got = kern(w2d.clone())
            want = plain()
            torch.cuda.synchronize()
            differs, max_ulps = _differs(got, want)
            max_abs = float((got.float() - want.float()).abs().max())
            bf16_note = ""
            if bf16_pair is not None:
                b_differs, _ = _differs(bf16_pair[0](), bf16_pair[1]())
                bf16_note = f" bf16_differs={b_differs}"
                differs_bf16 = b_differs
            else:
                differs_bf16 = 0
            f32_planes, i8_planes, per_row, once = WIRE_TRAFFIC[name]
            nbytes = rows * (f32_planes * LANES_BYTES + i8_planes * 128 + per_row) + once
            bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            bound_ops_ms = rows * 128 * WIRE_OPS[name] / FP32_OPS_PER_S * 1e3
            scratch = w2d.clone()
            ms = _time_ms(lambda: kern(scratch), iters=200)
            plain_ms = _time_ms(plain, iters=20)
            library_ms = None
            if name == "dequantize":
                # One PyTorch call for the same function: q * (s*norm), the
                # scalar formed beforehand (the port never calls it).
                sn = torch.tensor(fixed, dtype=torch.float32, device="cuda") * total
                lib_differs, _ = _differs(torch.mul(q_one, sn), got)
                library_ms = _time_ms(lambda: torch.mul(q_one, sn), iters=200)
                bf16_note += f" library_ms={library_ms:.4f} library_differs={lib_differs}"
            print(f"wire kernel {name:15s} {tag} R={rows} bits={bits}: differs={differs} "
                  f"max_ulps={max_ulps} max|d|={max_abs:.3e}{bf16_note} ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={max(bound_bytes_ms, bound_ops_ms):.4f} "
                  f"(bytes {nbytes}, {bound_bytes_ms:.4f} ms; ops {bound_ops_ms:.4f} ms)")
            ok = max_ulps <= limit and not differs_bf16
            if not ok or not torch.isfinite(got.float()).all():
                _fail(f"{name} at bits={bits} disagrees with its plain version "
                      f"({differs} elements, max {max_ulps} ulps, allowed {limit}; "
                      f"bfloat16 {differs_bf16})")
            if bits == 8:
                entries[name] = {
                    "name": name, "route": "cuda", "source": SOURCE,
                    "replaces": WIRE_REPLACES[name], "launches": None,
                    "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": max(bound_bytes_ms, bound_ops_ms),
                    "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
                    "library_ms": library_ms,
                }

    # ---------------------------- the quantize package's entry points
    # One wire tensor per (message, leaf), as the Eq. 14 payload is laid out.
    leaf = torch.as_tensor(spec.row_leaf_ids(), dtype=torch.int64, device="cuda")
    msg = torch.arange(n_msgs, device="cuda").repeat_interleave(spec.rows)
    seg_ids = msg * spec.n_leaves + leaf.repeat(n_msgs)
    num = n_msgs * spec.n_leaves
    s8, n8 = payload_side_info(w2d.reshape(n_msgs, spec.d_pad), spec, per_message=True, bits=8)
    qk.reset_launch_counts()
    q, norm = ops.stochastic_quantize(w2d, u, s=1 / 127, bits=8)
    deq = ops.stochastic_dequantize(q, norm, s=1 / 127)
    seg_out = ops.segment_quantize_dequantize(w2d, u, seg_ids, num, bits=8)
    seg_base = ops.segment_quantize_dequantize(w2d, u, seg_ids, num, bits=8, base_rows=base)
    wire = qk.dequantize_rows(qk.quantize_rows(w2d, u, s8, n8, bits=8), s8, n8)
    torch.cuda.synchronize()
    counts = {name: qk.LAUNCHES[name] for name in WIRE_REPLACES}
    print(f"wire path {tag}: stochastic_quantize -> stochastic_dequantize, "
          f"segment_quantize_dequantize(u_rows) with and without base ({num} segments), "
          f"quantize_rows -> dequantize_rows on {rows} rows: launches={counts}")
    if any(n != 1 for n in counts.values()):
        _fail(f"the wire entry points launched {counts}, want one launch of each")
    for name in counts:
        entries[name]["launches"] = counts[name]

    # The same entry points on the CPU (plain versions), same inputs.
    w_cpu, u_cpu, base_cpu, seg_cpu = (t.cpu() for t in (w2d, u, base, seg_ids))
    q_cpu, norm_cpu = ops.stochastic_quantize(w_cpu, u_cpu, s=1 / 127, bits=8)
    norm_ulps = _differs(norm.cpu().reshape(1), norm_cpu.reshape(1))[1]
    q_step = int((q.cpu().int() - q_cpu.int()).abs().max())
    q_given = _differs(qk.quantize_plain(w_cpu, u_cpu, norm.cpu(), s=1 / 127, bits=8),
                       q.cpu())[0]
    deq_differs = _differs(deq.cpu(), ops.stochastic_dequantize(q.cpu(), norm.cpu(),
                                                               s=1 / 127))[0]
    s_cpu, n_cpu = ops.segment_side_info(w_cpu, seg_cpu, num, bits=8)
    side = [ops.segment_side_info(w2d, seg_ids, num, bits=8) for _ in range(2)]
    repeat = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                 for a, b in zip(*side))
    side_ulps = max(_differs(side[0][i].cpu(), t)[1] for i, t in enumerate((s_cpu, n_cpu)))
    # |card - CPU| over one grid cell s*norm (a segment of zeros has a cell
    # of 0, where both must give 0)
    cell = (s_cpu * n_cpu)[:, None] * (1 + 1e-5)
    seg_worst = 0.0
    for got, b in ((seg_out, None), (seg_base, base_cpu)):
        d = (got.cpu() - ops.segment_quantize_dequantize(w_cpu, u_cpu, seg_cpu, num, bits=8,
                                                         base_rows=b)).abs()
        ratio = torch.where(d > 0, d / cell, torch.zeros_like(d))
        seg_worst = max(seg_worst, float(ratio.max()))
    fused = qk.qdq_rows_plain(w_cpu, u_cpu, s8.cpu(), n8.cpu(), bits=8)
    wire_ok = torch.allclose(wire.cpu(), fused, rtol=1e-6, atol=1e-7)
    print(f"wire path {tag}: card vs CPU: norm {norm_ulps} ulps, indices at most {q_step} "
          f"apart ({q_given} differ given the card's norm), dequantize differs={deq_differs}; "
          f"segment side information {side_ulps} ulps, identical in two card runs: {repeat}; "
          f"segment |d| at most {seg_worst:.4f} grid cells; quantize_rows -> dequantize_rows "
          f"vs qdq_rows (rtol 1e-6): {wire_ok}")
    finite = all(torch.isfinite(t).all() for t in (deq, seg_out, seg_base, wire))
    if not (norm_ulps <= 4 and q_step <= 1 and q_given == 0 and deq_differs == 0
            and repeat and side_ulps <= 4 and seg_worst <= 1.0 and wire_ok and finite
            and q.shape == w2d.shape and q.dtype == torch.int8):
        _fail("the quantize wire entry points disagree between the card and the CPU")
    return entries


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import (
        DFedRW, DFedRWConfig, QuantConfig, make_topology, train_loop,
    )
    from repro_torch.core.heterogeneity import partition_similarity
    from repro_torch.data import FederatedDataset, synthetic_image_classification
    from repro_torch.kernels.quantize import ops, payload_side_info
    from repro_torch.kernels.block_attn import block_attn as ba
    from repro_torch.kernels.quantize import quantize as qk
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.launch.train import main as launch_main
    from repro_torch.models import make_fnn
    from repro_torch.models import transformer  # noqa: F401  (imported before the card is touched)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        for done in [pool.submit(qk.build), pool.submit(sk.build), pool.submit(ba.build)]:
            done.result()
    print(f"build: three sources in parallel, {time.perf_counter() - t0:.2f}s wall")
    for info in (qk.BUILD_INFO, sk.BUILD_INFO, ba.BUILD_INFO):
        print(f"build: {info['seconds']:.2f}s {info['path']}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas: {line.strip()}")

    # ------------------------------------------------------ configuration
    t0 = time.perf_counter()
    x, y = synthetic_image_classification(n_samples=60000, seed=0, noise=2.0)
    xt, yt = synthetic_image_classification(n_samples=10000, seed=1, noise=2.0)
    data = FederatedDataset.from_partition(
        x, y, partition_similarity(y, 100, 50, np.random.default_rng(7)))
    topo = make_topology("complete", 100)
    model = make_fnn((200, 200))
    print(f"data: x{tuple(x.shape)} {x.nbytes / 1e6:.1f} MB, 100 devices, "
          f"set-up {time.perf_counter() - t0:.2f}s")

    def config(bits):
        return DFedRWConfig(m_chains=8, k_walk=8, batch_size=50,
                            quant=QuantConfig(bits=bits), seed=0)

    # One bits=8 round whose first hop and aggregation payloads are kept:
    # the kernels are then checked on the main path's own inputs.
    captured = {}

    def keep(name, real):
        def call(*args, **kw):
            if name not in captured:
                captured[name] = ([a.clone() if torch.is_tensor(a) else a for a in args], kw)
            return real(*args, **kw)
        return call

    runner = DFedRW(model, data, topo, config(8))
    spec = runner.flat_spec
    real = (ops.qdq_delta_rows_rng, ops.qdq_rows_rng)
    ops.qdq_delta_rows_rng = keep("qdq_delta_rows_rng", real[0])
    ops.qdq_rows_rng = keep("qdq_rows_rng", real[1])
    try:
        key = torch.Generator().manual_seed(0)
        runner.run_round(runner.init_state(key), key)
    finally:
        ops.qdq_delta_rows_rng, ops.qdq_rows_rng = real
    torch.cuda.synchronize()
    print(f"model: d={spec.d} d_pad={spec.d_pad} rows={spec.rows}")

    # -------------------------------------------- kernels vs plain versions
    m, k = runner.cfg.m_chains, runner.cfg.k_walk
    hop_args, _ = captured["qdq_delta_rows_rng"]
    agg_args, _ = captured["qdq_rows_rng"]
    hop_w, hop_base, hop_seed = hop_args[0], hop_args[1], hop_args[2]
    agg_w, agg_seed = agg_args[0], agg_args[1]
    results = {}
    for bits in (2, 4, 8):
        for name, w2d, per_message, b in (("qdq_delta_rows_rng", hop_w, False, m),
                                          ("qdq_rows_rng", agg_w, True, k * m)):
            s_rows, n_rows = payload_side_info(w2d.reshape(b, spec.d_pad), spec,
                                               per_message=per_message, bits=bits)
            if name == "qdq_delta_rows_rng":
                args = (hop_base, hop_seed, s_rows, n_rows)
                kern = lambda w: qk.qdq_delta_rows_rng(w, *args, bits=bits)
                plain = lambda w: qk.qdq_delta_rows_rng_plain(w, *args, bits=bits)
                limit = 1
            else:
                args = (agg_seed, s_rows, n_rows)
                kern = lambda w: qk.qdq_rows_rng(w, *args, bits=bits)
                plain = lambda w: qk.qdq_rows_rng_plain(w, *args, bits=bits)
                limit = 0
            got = kern(w2d.clone())
            want = plain(w2d)
            torch.cuda.synchronize()
            ulps = _ulps(got, want)
            differs = int((ulps > 0).sum())
            max_abs = float((got - want).abs().max())
            rows = w2d.shape[0]
            bytes_moved = rows * LANES_BYTES * (3 if name == "qdq_delta_rows_rng" else 2) + rows * 8
            bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
            bound_ops_ms = rows * 128 * OPS_PER_ELEMENT / FP32_OPS_PER_S * 1e3
            scratch = w2d.clone()
            ms = _time_ms(lambda: kern(scratch), iters=200)
            plain_ms = _time_ms(lambda: plain(w2d), iters=20)
            print(f"kernel {name:18s} R={rows} bits={bits}: differs={differs} "
                  f"max_ulps={int(ulps.max())} max|d|={max_abs:.3e} ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={max(bound_bytes_ms, bound_ops_ms):.4f} "
                  f"(bytes {bytes_moved}, {bound_bytes_ms:.4f} ms; ops {bound_ops_ms:.4f} ms)")
            if int(ulps.max()) > limit or not torch.isfinite(got).all():
                print(f"FAIL: {name} at bits={bits} disagrees with its plain version "
                      f"(max {int(ulps.max())} ulps, allowed {limit})", file=sys.stderr)
                return 1
            if bits == 8:
                results[name] = {
                    "name": name, "route": "cuda", "source": SOURCE,
                    "replaces": REPLACES[name], "launches": None,
                    "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": max(bound_bytes_ms, bound_ops_ms),
                    "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
                    "library_ms": None,
                }

    wire = wire_phase(agg_w, spec, k * m, f"[{smi}]")

    # --------------------------------------------- small CPU-vs-card check
    xs, ys = synthetic_image_classification(n_samples=2000, seed=0, noise=1.0)
    small = FederatedDataset.from_partition(
        xs, ys, partition_similarity(ys, 10, 50, np.random.default_rng(0)))
    small_model = make_fnn((64,))
    params = [tuple(t.numpy() for t in p)
              for p in small_model.init(torch.Generator().manual_seed(3), "cpu")]
    for bits in (32, 8):
        cfg = DFedRWConfig(m_chains=4, k_walk=3, batch_size=32, quant=QuantConfig(bits=bits))
        pair = []
        for d in ("cpu", "cuda"):
            r = DFedRW(small_model, small, make_topology("complete", 10), cfg, device=d)
            pair.append([r, r.state_from_params(params_from_numpy(params, device=d))])
        seeds = torch.Generator().manual_seed(11)
        worst = 0.0
        for _ in range(3):
            qseeds = torch.randint(0, 1 << 32, (cfg.k_walk + 1, 2), generator=seeds)
            losses = []
            for entry in pair:
                r, s = entry
                plan, bidx = r.plan_walks(s)
                entry[1], met = r.execute_round(s, plan, bidx, r.plan_aggregation(plan),
                                                None, qseeds=qseeds)
                losses.append(met.train_loss)
            a, b = pair[0][1].device_params, pair[1][1].device_params.cpu()
            diff = float((a - b).abs().max())
            worst = max(worst, diff)
            ok = (torch.allclose(b, a, rtol=1e-4, atol=1e-5) if bits == 32
                  else diff < 0.05 * float(a.abs().max()) + 1e-4)
            if not ok or not torch.isfinite(b).all():
                print(f"FAIL: CPU and card disagree at bits={bits}: max|d|={diff:.3e}",
                      file=sys.stderr)
                return 1
        print(f"small cpu-vs-card bits={bits}: max|d matrix|={worst:.3e} "
              f"losses cpu={losses[0]:.6f} card={losses[1]:.6f}")

    # --------------------------------------------------------- main path
    launches = {}
    for bits in (8, 32):
        runner = DFedRW(model, data, topo, config(bits))
        stamps, log = [], []

        def cb(r, metrics, evald):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            log.append((metrics.train_loss, evald["accuracy"], evald["loss"]))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        qk.reset_launch_counts()
        stamps.append(time.perf_counter())
        hist = train_loop(runner, ROUNDS, xt, yt, seed=0, callback=cb)
        torch.cuda.synchronize()
        counts = dict(qk.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        per_round = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        print(f"main path bits={bits}: ms/round (planning, round, eval) "
              f"median={statistics.median(per_round):.3f} "
              f"all={[round(t, 3) for t in per_round]}")
        print(f"main path bits={bits}: loss={[round(l, 5) for l, _, _ in log]} "
              f"test_acc={[round(a, 4) for _, a, _ in log]} "
              f"test_loss={[round(t, 4) for _, _, t in log]}")
        print(f"main path bits={bits}: peak_memory_allocated={peak} bytes "
              f"launches={counts}")
        want = dict.fromkeys(qk.LAUNCHES, 0)
        if bits < 32:
            want.update(qdq_delta_rows_rng=k * ROUNDS, qdq_rows_rng=ROUNDS)
        finite = all(np.isfinite(v) for row in log for v in row)
        if counts != want or not finite or len(hist.rounds) != ROUNDS:
            print(f"FAIL: main path bits={bits}: launches {counts} (want {want}), "
                  f"finite={finite}", file=sys.stderr)
            return 1
        if bits < 32:
            launches = counts
            profile_runner = runner

    # ------------------------------------------------------------ profile
    state = profile_runner.init_state(torch.Generator().manual_seed(1))
    key = torch.Generator().manual_seed(1)
    state, _ = profile_runner.run_round(state, key)
    torch.cuda.synchronize()

    def two_rounds():
        nonlocal state
        for _ in range(2):
            state, _ = profile_runner.run_round(state, key)

    _profile("bits=8 (2 rounds)", two_rounds)

    # ----------------------------------------------------------- launcher
    qk.reset_launch_counts()
    launch_main(["protocol", "--algo", "dfedrw", "--rounds", "2", "--bits", "8"])
    torch.cuda.synchronize()
    print(f"launcher bits=8: launches={dict(qk.LAUNCHES)}")
    if min(qk.LAUNCHES["qdq_delta_rows_rng"], qk.LAUNCHES["qdq_rows_rng"]) <= 0:
        print("FAIL: the launcher did not go through both kernels", file=sys.stderr)
        return 1

    for name in results:
        results[name]["launches"] = launches[name]
    ssd = mamba_phases(smi)
    gc.collect()                         # the Mamba2 weights and caches go first
    torch.cuda.empty_cache()
    attn = dense_phases(smi)
    print(json.dumps({"kernels": [results["qdq_delta_rows_rng"], results["qdq_rows_rng"],
                                  *wire.values(), ssd, attn]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
