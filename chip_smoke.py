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
4. a small configuration run on the CPU and on the card from the same
   weights and seed words, compared (fp32: rtol 1e-4; bits=8: within
   0.05 * scale + 1e-4, as tests/test_torch_dfedrw.py);
5. the main path through ``train_loop``: QDFedRW (bits=8) and DFedRW
   (bits=32), 5 rounds each, at the paper's 3FNN (784-200-200-10), n=100
   devices on a complete graph, 60,000 samples, M=K=8, B=50; ms per round,
   loss, accuracy, peak memory and the kernel launch counts, which must be
   K*rounds and rounds at bits=8;
6. a profile of two rounds at bits=8 (device busy and idle share);
7. the launcher, ``repro_torch.launch.train.main``, on the card;
8. the Mamba2 slice (``configs.mamba2_130m`` as the registry gives it,
   float32, TF32 off), see :func:`mamba_phases`: the ``ssd_scan`` kernel against its
   plain version on layer 0's own inputs from a full-width forward, the
   SMOKE configuration on the CPU and the card, ``loss_fn`` at full width
   (8 x 2,048 tokens, 24 kernel launches a forward) and recurrent decode;
9. one JSON line of kernel numbers (all three kernels), and last the device
   line.

Both kernel sources are built at the start, one ``nvcc`` each, in parallel.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
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
ROUNDS = 5
SPIN_CYCLES = 200_000_000      # ~0.1 s at the H100's clock: longer than queuing a timing loop
SSD_REPLACES = "src/repro/kernels/ssd_scan/ssd_scan.py:32 _ssd_kernel"
SSD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
SSD_TOL = 2e-4                 # abs and rel: fp32 summed in another order (tests/test_kernels_ssd.py)
SMOKE_TOL = 1e-4               # abs and rel: the SMOKE model on the CPU and on the card
DECODE_TOL = 2e-3              # abs and rel: decode vs forward (tests/test_decode_consistency.py)
LM_BATCH, LM_SEQ, LM_FORWARDS = 8, 2048, 5
PROMPT, GENERATE = 64, 32


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


def mamba_phases(smi):
    """The Mamba2 slice on the card. Returns the ``ssd_scan`` entry of the
    kernels line; a failed phase exits non-zero."""
    import torch

    from repro_torch.configs import get_arch, get_smoke
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
    captured = []
    real = ssd_ops.ssd_chunked

    def keep(*args, **kw):
        captured.append((args, kw) if not captured else None)
        return real(*args, **kw)

    ssd_ops.ssd_chunked = keep
    try:
        with torch.inference_mode():
            T.loss_fn(cfg, params, batch)
    finally:
        ssd_ops.ssd_chunked = real
    torch.cuda.synchronize()
    if len(captured) != cfg.n_layers:
        _fail(f"the forward called ssd_chunked {len(captured)} times, want {cfg.n_layers}")

    # -------------------------------------------- ssd_scan vs plain version
    (x, dt, a_log, b, c), kw = captured[0]
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
    del captured, x, dt, b, c, got, want, seq, diff     # out of the main path's peak memory
    entry = {"name": "ssd_scan", "route": "cuda", "source": SSD_SOURCE,
             "replaces": SSD_REPLACES, "launches": None, "max_abs_err": max_abs,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": "operations" if bound_ops_ms >= bound_bytes_ms else "bytes",
             "library_ms": None}

    # ------------------------------------------- SMOKE: the CPU and the card
    small = get_smoke("mamba2-130m")
    on_cpu = T.init_params(small, torch.Generator().manual_seed(2), device="cpu")
    on_card = _tree_to(on_cpu, "cuda")
    toks = torch.randint(0, small.vocab, (2, 80), generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        want, _ = T.forward_train(small, on_cpu, toks)
        sk.reset_launch_counts()
        got, _ = T.forward_train(small, on_card, toks.cuda())
        smoke_launches = sk.LAUNCHES["ssd_scan"]
        caches = [T.init_cache(small, 2, 16, device="cpu"), T.init_cache(small, 2, 16)]
        worst_dec = 0.0
        for t in range(16):
            lg_cpu, caches[0] = T.decode_step(small, on_cpu, caches[0], toks[:, t:t + 1])
            lg_card, caches[1] = T.decode_step(small, on_card, caches[1], toks[:, t:t + 1].cuda())
            worst_dec = max(worst_dec, _tol_ratio(lg_card.cpu(), lg_cpu, SMOKE_TOL))
    fwd_ratio = _tol_ratio(got.cpu(), want, SMOKE_TOL)
    print(f"mamba2 smoke {tag}: forward (2, 80) cpu-vs-card max|d|="
          f"{float((got.cpu() - want).abs().max()):.3e} ratio={fwd_ratio:.4f}; 16 decode steps "
          f"ratio={worst_dec:.4f} (tol {SMOKE_TOL}); ssd_scan launches={smoke_launches}")
    if fwd_ratio > 1.0 or worst_dec > 1.0 or smoke_launches != small.n_layers:
        _fail("the SMOKE Mamba2 model disagrees between the CPU and the card")

    # --------------------------------------- main path: loss_fn, full width
    torch.cuda.reset_peak_memory_stats()
    stamps, losses = [], []
    sk.reset_launch_counts()
    with torch.inference_mode():
        for _ in range(LM_FORWARDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(T.loss_fn(cfg, params, batch))
            torch.cuda.synchronize()
            stamps.append((time.perf_counter() - t0) * 1e3)
    launches = sk.LAUNCHES["ssd_scan"]
    peak = torch.cuda.max_memory_allocated()
    fwd_ms = statistics.median(stamps)
    losses = [float(v) for v in losses]
    print(f"mamba2 main path {tag}: loss_fn on {LM_BATCH}x{LM_SEQ} tokens: ms/forward "
          f"median={fwd_ms:.3f} all={[round(v, 3) for v in stamps]} tokens/s="
          f"{LM_BATCH * LM_SEQ / fwd_ms * 1e3:.1f} loss={losses[0]:.6f} "
          f"peak_memory_allocated={peak} bytes ssd_scan launches={launches} "
          f"(want {cfg.n_layers} x {LM_FORWARDS})")
    if launches != cfg.n_layers * LM_FORWARDS or not all(math.isfinite(v) for v in losses):
        _fail(f"main path: {launches} ssd_scan launches in {LM_FORWARDS} forwards "
              f"(want {cfg.n_layers * LM_FORWARDS}), losses {losses}")
    entry["launches"] = launches

    # ---------------------------------------------- decode at full width
    prompts = tokens[:, :PROMPT]
    seqs = [prompts]
    step_ms, dec_logits = [], []
    with torch.inference_mode():
        cache = T.init_cache(cfg, LM_BATCH, PROMPT + GENERATE)
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
        fed = torch.cat(seqs, dim=1)
        fwd_logits, _ = T.forward_train(cfg, params, fed)
    dec = torch.stack(dec_logits, dim=1)
    dec_ratio = _tol_ratio(dec, fwd_logits, DECODE_TOL)
    prompt_ratio = _tol_ratio(dec[:, :PROMPT], fwd_logits[:, :PROMPT], DECODE_TOL)
    print(f"mamba2 decode {tag}: {LM_BATCH} prompts x {PROMPT} tokens + {GENERATE} greedy: "
          f"ms/step median={statistics.median(step_ms[2:]):.3f} "
          f"prompt={statistics.median(step_ms[2:PROMPT]):.3f} "
          f"generate={statistics.median(step_ms[PROMPT:]):.3f}; decode vs kernel forward "
          f"max|d|={float((dec - fwd_logits).abs().max()):.3e} ratio prompt={prompt_ratio:.4f} "
          f"all {PROMPT + GENERATE}={dec_ratio:.4f} (tol {DECODE_TOL})")
    if prompt_ratio > 1.0 or dec_ratio > 1.0 or not torch.isfinite(dec).all():
        _fail("decode disagrees with the kernel forward at full width")

    # ------------------------------------------------------------ profile
    def decode_steps():
        c = cache
        for t in range(4):
            _, c = T.decode_step(cfg, params, c, prompts[:, t:t + 1])

    with torch.inference_mode():
        _profile(f"mamba2 loss_fn {LM_BATCH}x{LM_SEQ} (1 forward) {tag}",
                 lambda: T.loss_fn(cfg, params, batch))
        _profile(f"mamba2 decode batch {LM_BATCH} (4 steps) {tag}", decode_steps)
    return entry


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
    with ThreadPoolExecutor(2) as pool:
        for done in [pool.submit(qk.build), pool.submit(sk.build)]:
            done.result()
    print(f"build: both sources in parallel, {time.perf_counter() - t0:.2f}s wall")
    for info in (qk.BUILD_INFO, sk.BUILD_INFO):
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
        want = ({"qdq_delta_rows_rng": k * ROUNDS, "qdq_rows_rng": ROUNDS} if bits < 32
                else {"qdq_delta_rows_rng": 0, "qdq_rows_rng": 0})
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
    if min(qk.LAUNCHES.values()) <= 0:
        print("FAIL: the launcher did not go through both kernels", file=sys.stderr)
        return 1

    for name in results:
        results[name]["launches"] = launches[name]
    ssd = mamba_phases(smi)
    print(json.dumps({"kernels": [results["qdq_delta_rows_rng"], results["qdq_rows_rng"], ssd]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
