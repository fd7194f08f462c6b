#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --backward-ab OTHER   # B9b and B10b against OTHER's, in turns;
                                                # the float32 forwards bit for bit
    python3 -m torch.distributed.run --standalone --nproc-per-node 2 \
        chip_smoke.py --tp-train                # phase (r)'s ranks alone

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
8b. (s) the seed engine (``DFedRWConfig(engine="reference")``) beside the
   flat engine at the main path's configuration, see
   :func:`seed_engine_phase`: one warm and SEED_ROUNDS timed rounds of each
   from the same init and plans at bits 32 and 8 (ms a round, no claim),
   their parameters held after every round (bits 32 within rtol 1e-6, the
   count of differing elements printed; bits 8 within 0.05 * scale +
   1e-4), Eq. 18 bits equal, no kernel launched by the seed engine, and
   its card round against its CPU round;
9. the baselines (§VI-B), see :func:`baselines_phase`: FedAvg, DFedAvg,
   DFedAvgM and DSGD on a small configuration on the CPU and on the card;
   then at the main path's setting (3FNN, n=100), bits 32 and 8, ms per
   round, test accuracy and launch counts (one ``qdq_rows_rng`` a quantized
   decentralized round); ``qdq_rows_rng`` against its plain version on
   QDFedAvg's 779,500-row payload;
10. LSTM chain mode (§VI-F) at the published width with the 50K
   vocabulary, see :func:`lstm_phase`: d = 20,169,552, 64 devices (a 5.16
   GB device matrix), M=10, K=3, bits 8 and 32; ms per round, idle share,
   peak memory, chain starts and launch counts (K ``qdq_delta_rows_rng``
   and one ``qdq_rows_rng`` a quantized round); both kernels against their
   plain versions on that run's payloads (1,575,750 and 4,727,250 rows);
   then the checkpoint phase, the trained params saved from the card and
   loaded into a template on the card, bit for bit;
10b. the virtual-time simulator (``repro_torch.sim``), see
   :func:`sim_phases`: (a) ``straggler_tail`` on the CPU and the card from
   the same weights and seed words (equal records, params within the bits-8
   contract, K hop and one aggregation launch a window), then
   ``congested_uplink`` under the adaptive controller with both kernels held
   against their plain versions at every width it picked and at 2, 4, 6 and
   8; (b) ``fleet_metro`` at n = 200 and 1,000, heap against fleet with
   telemetry and causal traces (equal records and counters, byte-identical
   ``tspan`` lines at n = 200); (c) the
   acceptance-scale ``fleet_metro`` on the fleet engine at n = 100,000
   (10,000 chains, 2 windows): ms a window split into host timeline,
   engine and evaluation, the idle share of one profiled window, peak
   memory, the launch counts, and both kernels held against their plain
   versions on that run's payloads (70,000 and 560,000 rows); (d) record
   and replay on the card, bit for bit; (e) ``straggler_tail`` partial
   against drop at the scenario's defaults (n = 20, 40 windows);
11. the Mamba2 slice (``configs.mamba2_130m`` as the registry gives it,
   float32, TF32 off), see :func:`mamba_phases`: ``ssd_scan`` (four stage
   kernels a call: ``chunk_cb``, ``chunk_state``, ``state_pass``,
   ``chunk_scan``) against its plain version and the sequential recurrence
   on layer 0's own inputs from a full-width forward, and against its plain
   version at the small shapes of ``SSD_SMALL``; each stage's registers,
   spills, shared memory, blocks and device ms (profiler), the scratch
   bytes, its time beside its plain version and its bounds (3xTF32 on the
   tensor cores, and the earlier per-head counts); the SMOKE configuration
   on the CPU and the card, ``loss_fn`` at full width (8 x 2,048 tokens, 24
   calls and 24 launches of each stage kernel a forward) and recurrent
   decode;
12. the dense GQA slice (``configs.yi_6b`` as the registry gives it, float32,
   TF32 off, after the Mamba2 state is freed), see :func:`dense_phases`: the
   ``block_attn`` kernel against its plain version on layer 0's own q/k/v
   of a full-width forward (B = 2, L = 4,096, 32 heads, 4 KV heads, hd 128)
   and at small shapes (ragged L, MQA, hd 64, 18 and 16, non-causal, Lk
   under one tile, windows of 17 and 512, a ragged last query tile, a K
   view at an unaligned offset), its registers and spills, timed beside
   its plain version, both of its bounds (3xTF32 on the tensor cores, the
   float32 SIMT rate) and PyTorch's fp32
   ``scaled_dot_product_attention`` (GQA on the first backend that takes
   it, and the memory-efficient backend on K/V repeated to every head);
   the SMOKE configuration on the CPU and
   the card; ``loss_fn`` at full width (2 x 4,096 tokens, 32 kernel
   launches a forward) with a profile; greedy decode at batch 8 against the
   kernel forward;
13. the slices that MoE and the vision stub open, each freeing the one
   before it: (a) ``internvl2-1b`` at full width and depth (24 layers,
   0.63 B parameters) with the vision stub, see :func:`vlm_phase`: SMOKE
   on the CPU and the card, layer 0's own attention (n_rep 7) against the
   plain version, ``loss_fn`` on 4 x (256 stub embeddings + 1,792 tokens)
   with 24 ``block_attn`` calls a forward and a profile, text decode of 8
   prompts against the kernel forward; (b) ``grok-1-314b`` at full width
   with its depth cut 64 -> 2 (11.45 B parameters), see
   :func:`grok_phase`: SMOKE on the CPU and the card with equal routing,
   layer 0 (n_rep 6), ``loss_fn`` on 2 x 2,048 tokens with each MoE
   layer's aux loss, load by row and expert and dropped choices, 2 calls a
   forward, decode at ``capacity_factor = e / k``; (c) ``jamba-1.5-large-
   398b`` SMOKE on the CPU and the card (one ``ssd_scan`` and one
   ``block_attn`` call a forward, equal routing); (d) the telemetry path,
   see :func:`obs_phase`: ``launch.train --obs --trace`` on the card beside
   the run without it, rendered with the port's ``render_report``, and the
   traced ``fleet_metro`` stream of 10b with ``render_critical``; (e)
   ``seamless-m4t-large-v2`` at full width and depth (24 + 24 layers,
   2.03 B parameters), see :func:`seamless_phase`: SMOKE on the CPU and the
   card, ``block_attn`` held against its plain version on layer 0's own
   inputs in each mode the encoder-decoder calls it in (non-causal encoder,
   causal decoder, cross-attention, the encoder and cross calls at 1,000
   frames, decode's cross call at Lq = 1), each timed beside fp32
   ``scaled_dot_product_attention``; ``loss_fn`` on 4 x 1,024 tokens over
   4 x 1,024 stub frames (72 calls a forward), decode of 8 prompts over the
   encoder's output against the kernel forward (24 launches a step), and
   the share of a step spent recomputing the cross K/V; then training,
   see :func:`backward_phase`, :func:`train_smoke_phase` and
   :func:`pod_phase`: (g) the backward kernels (B10's two on 3xTF32
   ``mma.sync``, ``attn_bwd_dot`` and ``attn_bwd_dkdvq``, dQ by atomics;
   B9's six in the chunked matrix form, ``bwd_chunk_cb``,
   ``bwd_chunk_state``, ``bwd_state_pass``, ``bwd_chunk_dc``,
   ``bwd_chunk_db`` and ``bwd_ddt``) against autograd through their plain
   versions, gradient by gradient within GRAD_TOL of its largest
   magnitude, at Yi-6B's layer 0 (causal GQA), Seamless's encoder,
   decoder and cross shapes (Lk 1,000) and a window of 64, and at
   mamba2-130m's layer, a ragged L, G = 4 and dt |A| of 10-15 a step
   (|cum| in the thousands); each timed beside its plain version's
   backward and fp32 SDPA's (B10), each kernel's profiler ms, with its
   3xTF32 bound and the float32 SIMT one beside it; (h) the SMOKE ``mamba2``, ``yi-6b``,
   ``seamless``, ``jamba`` and ``deepseek`` trained on the CPU and on the
   card from the same weights and batches: one gradient and three
   ``make_train_step`` steps (TRAIN_TOL; MoE routing equal), the kernels'
   forward launched twice a layer (remat) and their backward once; (i)
   ``launch.train pod`` at full width and depth through ``launch_main``:
   ``mamba2-130m`` at 8 x 2,048 and ``seamless-m4t-large-v2`` at 2 x 1,024
   over its 1,024 stub frames, POD_STEPS steps each: ms a step, training
   tokens/s, peak memory, a profiled step, the launches a step (B9 48
   forward calls and 24 backward, 6 kernels each; B10 144 and 72, 2
   kernels each) and layer 0's backward call on
   its own inputs against the plain version; (l) the DFedRW pod
   deployment, see :func:`fed_phase`: B5 (``quantize_rows``) and B6
   (``dequantize_rows``) at the gossip payload of ``mamba2-130m`` on 4 pods
   (515,933,952 elements) against their plain versions (0 differing
   elements) and their memory bounds; ``gossip_mix`` stacked on that payload
   (B5 = B6 = 2 launches a gossip at bits 8, the pod mean kept at bits 32)
   and at SMOKE size against the CPU; ``launch.train pod --fed`` at full
   width through ``launch_main``, ``mamba2-130m`` on 4 pods at 4 x 1,024,
   bits 8 and 32, and ``internvl2-1b`` on 2 pods at 2 x (256 + 768), bits
   8: ms a step and a gossip, wire bytes, peak memory, the launches a step
   (B9/B9b 24 a pod, B10/B10b 24 a pod, B5/B6 one an offset), a profiled
   step; the scheduled step on ``gossip_flags()`` of a trace recorded on the
   card, against the static step and the CPU; (m) the sim-to-metal
   deployment, see :func:`metal_phase`: traces of ``straggler_tail`` (n =
   100, bits 32 and 8) and ``churn_dropout`` recorded on the card and
   replayed by ``MetalReplay`` in process (one position bit for bit, five
   within the chain-slice bound or the quantization band, the faults
   verified, B1 and B2 on the first quantized window's payloads), by
   ``launch.replay --processes 2 --check`` (two workers on the card, equal
   digests, fp32 bit for bit), and ``fleet_metro`` at n = 100,000 (bits 8,
   2 windows) by two workers with ``--fault-inject``: ms a window, the
   exchange's ms and bytes, peak memory, conformance; (n) tensor-parallel
   serving, see :func:`tp_phase`: ``yi-6b`` and ``seamless-m4t-large-v2``
   at full width and depth in bf16 (TP_RUNS, 8 requests on 8 slots each)
   served unsharded in this process (ms a decode step and a prefill chunk,
   each step's top-2 logit gaps), B10 held against its plain version on
   rank 0's heads (H/2, KV/2) of the engine's first call of each serve mode
   and of Yi's layer 0, beside the whole-head call; then ``launch.serve
   --full --mesh-model 2`` under ``torchrun``, two ranks on the one card
   over gloo: equal digests, the unsharded token streams up to a bf16
   near-tie (BF16_TIE), the unsharded counters, and per rank the ms a decode
   step and a prefill chunk, the collectives' ms and bytes a step, peak
   memory, the backend and B10's launches; (o) data-parallel training,
   see :func:`dp_phase`: layer 0's B9 forward and B9b backward calls at
   one rank's shape (4 x 2,048 of ``mamba2-130m``) against their plain
   versions, timed beside them with their bounds; then ``launch.train
   pod`` under ``torchrun --nproc-per-node 2`` on (i)'s Mamba2 run (8 x
   2,048, POD_STEPS steps), two ranks on the one card over gloo: equal
   digests of the ranks' gathered parameters, rank 0's reference lines,
   its losses against (i)'s (DP_LOSS_RTOL), and per rank the ms a step,
   the data collectives' calls, ms and bytes a step, peak memory, the
   backend and B9/B9b's launches (48 and 24 a step); (p) data-parallel
   serving slots, see :func:`dp_serve_phase`, on (n)'s Seamless workload
   and its unsharded run (not served again): B10 bf16 held against its
   plain version on (n)'s prefill-cross (4, 64 x 1,024) and decode-cross
   (4, 1 x 1,024) calls cut to a data rank's 4 rows, all 16 heads and
   model rank 0's 8, beside its bound and bf16 SDPA; then ``launch.serve
   --full`` under ``torchrun`` on a (2, 1) mesh (two ranks, 4 slots each)
   and a (2, 2) mesh (four ranks, 4 slots and 8 heads each), the ranks on
   the one card over gloo: equal digests on every rank, the unsharded
   token streams up to BF16_TIE, the unsharded counters, and per rank the
   ms a decode step and a prefill chunk, each axis's collectives (calls, ms
   and bytes a step), peak memory and B10's launches (float32, the
   encoder at admission on the data row that holds the slot: 24 an
   admission summed over the data ranks; bf16: 24 a prefill chunk and a
   decode step on every rank); (q) pods with a data axis, see
   :func:`pod_data_phase`: B5/B6 at a rank's block payload, then
   ``launch.train pod --fed --pods 2`` under ``torchrun`` on four ranks,
   against the pods stacked; (r) tensor-parallel training, see
   :func:`tp_train_phase`: B10b held against its plain version at a rank's
   8 of Seamless's 16 heads in each mode (encoder, decoder, cross at 1,024
   frames), timed beside its bound and fp32 SDPA's backward; then this
   script's ``--tp-train`` worker under ``torch.distributed.run`` on two
   ranks of the one card over gloo, ``make_train_step(cfg,
   make_host_mesh(1, 2))`` on (i)'s Seamless run for TP_TRAIN_STEPS steps:
   rank 0's losses against (i)'s (DP_LOSS_RTOL), each leaf's update norm
   against (i)'s (TP_NORM_RTOL), equal digests of the parameters gathered
   whole, and per rank the ms a step, the model axis's calls, ms and bytes
   in the forward, the backward and the update apart, the ``enter``
   adjoints run, peak memory and B10/B10b's launches (144 and 72 a step,
   on 8 heads); (j) serving, see
   :func:`serve_smoke_phase` and :func:`serve_phase`: the SMOKE
   ``mamba2``, ``jamba`` and ``deepseek`` served on the CPU and on the card
   (equal token streams and ``EngineMetrics`` counters; ``mamba_prefill``
   bit for bit the decode step on the card), then
   ``seamless-m4t-large-v2`` and ``yi-6b`` at full width, their depth cut
   by SERVE_F32_DEPTH_CUT in float32 (bf16 serves them in (k4)), through
   ``ServeEngine`` (16 requests, 8 slots, SERVE_RUNS), SERVE_TIMED timed
   runs with nothing wrapped: gen and total tokens/s, TTFT, TPOT and their
   spread, the counters, peak memory, B10's launches (24 an admission, 24
   a prefill chunk and a decode step for Seamless); then, in a run that is
   not timed, the shortest request against ``sequential_reference`` token for token (a
   near-tie aside), B10 held on the engine's first call of each serve mode
   (encoder, prefill cross at Lq = chunk, decode cross), and the idle
   share of a profiled window of engine steps; (f)
   ``deepseek-v2-lite-16b`` at full width and depth (27 layers, 16.21 B
   parameters, 64.84 GB), last, see :func:`deepseek_phase`: SMOKE on the
   CPU and the card with equal routing, MLA layer 0 on the card against the
   CPU, each MoE layer's aux, load and drops, ``loss_fn`` on 2 x 2,048
   tokens (no kernel: MLA is plain torch, as in the reference), decode at
   ``capacity_factor = e / k``;
   (k) the bf16 slice, ``launch.serve --full``'s dtype, each model's
   weights drawn in bf16 on the card: (k1) ``ssd_scan``'s bf16 stage
   kernels on ``mamba2-130m``'s layer 0 and at SSD_SMALL against their
   plain bf16 version (within 1 bf16 ulp, :func:`_bf16_ulps`), timed beside
   the float32 kernel on the same values, with their registers and spills
   (a spill fails), and ``loss_fn`` at 8 x 2,048 in bf16 held against the
   float32 forward at the same weights (BF16_LOSS_RTOL, BF16_RMS_TOL); (k2)
   ``block_attn``'s bf16 kernel (``wgmma`` fed by TMA) on Yi-6B's layer 0
   and at ATTN_SMALL, an odd hd and an unaligned K (the operands TMA cannot
   read, copied: BF16_REPACKS), beside bf16
   ``scaled_dot_product_attention``, with its registers and spills, and
   Yi's bf16 forward the same way; every model phase of (k) fails if it
   copied an operand for TMA;
   (k3) Seamless's bf16 encoder, decoder and cross calls and its bf16
   forward; (k4) ``serve_phase`` in bf16 for SERVE_RUNS, their depth cut
   by SERVE_BF16_DEPTH_CUT (the encoder at
   admission in float32, the cross layers in bf16; tokens against
   ``sequential_reference`` up to a bf16 near-tie, BF16_TIE); (k5)
   ``qwen2.5-32b`` at full width and depth (65.53 GB), last: layer 0,
   ``loss_fn`` on 1 x 2,048 with its peak memory, decode against the
   forward, and serving;
13b. (t) the dry run, see :func:`dryrun_phase`: ``python -m
   repro_torch.launch.dryrun`` for DRYRUN_RUNS in subprocesses that see no
   card, started together: each exits 0, the ``--fed`` gossip program makes
   pod-axis exchanges alone, its bits-8 bytes are the int8 wire of the
   rank's blocks; the three roofline terms of each;
14. one JSON line of kernel numbers (all ten kernels, and the bf16 modes of
   ``ssd_scan`` and ``block_attn`` as ``ssd_scan (bf16)`` and
   ``block_attn (bf16)`` with their launches on the bf16 paths; B1 and B2 with their
   launches on each path, ``ssd_scan`` and ``block_attn`` with theirs on
   each LM path, training's included, ``block_attn`` with each
   encoder-decoder mode and serve mode; ``ssd_scan`` and ``block_attn`` with a
   ``backward`` object: its kernels' ms, bound, plain and library ms at the
   main shape, its launches on each training path and every case of (g));
   ``quantize_rows`` and ``dequantize_rows`` with their launches on the
   wire path and on each fed run, and their numbers at the gossip payload;
   B1 and B2 with their launches on the metal paths, in process and in the
   workers; ``block_attn`` with each rank's launches of (n), and its
   local-head modes of (n) beside the whole-head ones, each rank's
   launches of (p) and its modes at a data rank's rows; ``ssd_scan`` with
   each rank's launches of (o), forward and backward, and (o)'s layer-0
   calls at a rank's shape under ``data_parallel``; ``block_attn`` with each
   rank's launches of (r), forward and backward, and (r)'s backward cases at
   a rank's heads among its ``backward`` cases), and last the device line.

The four kernel sources start building at the start, one ``nvcc`` each, in
parallel; the phases up to the simulator need only ``qdq_rows`` and run
while ``ssd_scan`` and ``block_attn`` go on building. Each phase ends with
an ``elapsed after ...`` line.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory bandwidth
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 494.7e12      # H100 SXM dense TF32 on the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 on the tensor cores
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
# The baselines of §VI-B at the main path's setting: (label, class in
# repro_torch.core.baselines, config fields).
BASELINES = [
    ("fedavg", "FedAvg", dict(n_selected=8, local_epochs=8)),
    ("dfedavg", "DFedAvg", dict(n_selected=100, local_epochs=8, n_agg=5)),
    ("dfedavgm", "DFedAvg", dict(n_selected=100, local_epochs=8, n_agg=5, momentum=0.9)),
    ("dsgd", "DSGD", dict(n_selected=100, local_epochs=8, n_agg=5)),
]
BASELINE_ROUNDS = 5
LSTM_VOCAB = 50_000            # the paper's §VI-F vocabulary
LSTM_ROUNDS = 3
# The simulator (repro_torch.sim): windows of each of its phases, see
# sim_phases. SIM_FLEET_N is the README's acceptance-scale fleet_metro run.
SIM_WINDOWS = 3
SIM_ADAPTIVE_WINDOWS = 6
SIM_CROSS_N = (200, 1_000)
SIM_FLEET_N = 100_000
SIM_FLEET_WINDOWS = 2
METAL_N = 100                  # (m1), (m2): straggler_tail and churn_dropout at n = 100
METAL_WINDOWS = 4
METAL_POSITIONS = 5            # one chain a position at M = 5 (two would run as one)
METAL_KEY = 7
METAL_FLEET_N = 100_000        # (m3): fleet_metro as sim (c)
METAL_FLEET_WINDOWS = 2
METAL_TOLERANCE = 4.0          # bits < 32: x the simulator's spread under other seed words
SIM_RECORD_FIELDS = ("round", "t_start", "t_compute_end", "t_end", "events", "k_planned",
                     "k_done", "k_exec", "killed", "agg_latency_s", "resumed", "bits")
SPIN_CYCLES = 200_000_000      # ~0.1 s at the H100's clock: longer than queuing a timing loop
SSD_REPLACES = "src/repro/kernels/ssd_scan/ssd_scan.py:32 _ssd_kernel"
SSD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
SSD_TOL = 2e-4                 # abs and rel: fp32 summed in another order (tests/test_kernels_ssd.py)
SSD_TF32_PASSES = 3            # TF32 products the ssd_scan kernels run for each product term
# (B, H, L, P, N, chunk, G): the shapes the chunk-parallel tiling can get
# wrong: a chunk not a multiple of the 64-row tile, L under one chunk, one
# whole chunk, P = 128, P = 18 (x rows not 16-byte multiples: 4-byte
# copies), N = 48, N = 50 (the same for B and C), G = H; then G < H with a
# ragged chunk, a chunk under one tile.
SSD_SMALL = [
    (1, 4, 330, 64, 128, 100, 2),
    (2, 4, 90, 64, 128, 256, 1),
    (1, 4, 256, 64, 128, 256, 4),
    (1, 2, 300, 128, 128, 128, 1),
    (2, 3, 200, 18, 64, 64, 3),
    (1, 6, 260, 32, 48, 128, 2),
    (1, 4, 200, 64, 50, 64, 2),
    (2, 6, 300, 64, 128, 128, 6),
    (1, 8, 300, 32, 64, 128, 2),
    (2, 6, 96, 16, 16, 32, 1),
]
SMOKE_TOL = 1e-4               # abs and rel: the SMOKE model on the CPU and on the card
DECODE_TOL = 2e-3              # abs and rel: decode vs forward (tests/test_decode_consistency.py)
# A routing flip between decode and the forward (ROADMAP.md C) is taken as
# the card's own choice only where the k-th and (k+1)-th router
# probabilities are this close in both runs: a near-tie that the two GEMM
# shapes' summation orders split either way.
FLIP_GAP = 1e-5
# A bf16 near-tie of served logits: a top-2 gap below 2 bf16 ulps of the top
# logit (the head's bf16 product rounds each logit to 8 bits of mantissa, so
# two entries can be equal).
BF16_TIE = 2 * 2.0 ** -8
LM_BATCH, LM_SEQ, LM_FORWARDS = 8, 2048, 5
PROMPT, GENERATE = 64, 32
ATTN_REPLACES = "src/repro/kernels/block_attn/block_attn.py:32 _attn_kernel"
ATTN_SOURCE = "src/repro_torch/kernels/block_attn/csrc/block_attn.cu"
ATTN_TOL = 1e-4                # abs and rel: 3xTF32 + online vs fp32 materialized softmax
ATTN_TF32_PASSES = 3           # TF32 products the kernel runs for each product term
ATTN_BF16_PASSES = 1.5         # bf16: Q K^T once, P V twice (P's bf16 halves), bf16 rate
YI_BATCH, YI_SEQ, YI_FORWARDS = 2, 4096, 3     # Yi-6B's published context length
YI_DECODE_BATCH = 8
# (B, Lq, Lk, H, KV, hd, causal, window): ragged L, MQA, hd 64 and 16,
# non-causal, Lq != Lk, and the sliding window; then hd 18 (rows not
# 16-byte multiples: the kernel's 4-byte copies), Lk under one 64-key tile,
# a window under one tile, a 2-row ragged last 128-row query tile, and the
# head ratios of Grok-1 (n_rep 6 at hd 128) and InternVL2 (n_rep 7 at hd 64).
ATTN_SMALL = [
    (1, 1000, 1000, 8, 2, 128, True, 0),
    (2, 333, 333, 8, 1, 128, True, 0),
    (2, 256, 256, 4, 4, 64, True, 0),
    (1, 300, 300, 8, 8, 128, False, 0),
    (1, 77, 130, 4, 2, 16, False, 0),
    (1, 2048, 2048, 8, 2, 128, True, 512),
    (2, 200, 200, 3, 3, 18, True, 0),
    (1, 150, 40, 4, 2, 64, True, 0),
    (1, 300, 300, 4, 1, 128, True, 17),
    (2, 130, 130, 8, 2, 128, True, 0),
    (1, 300, 300, 12, 2, 128, True, 0),
    (2, 257, 257, 14, 2, 64, True, 0),
]
# InternVL2-1B: 4 rows of 256 stub embeddings + 1,792 text tokens (L = 2,048).
VLM_BATCH, VLM_TEXT, VLM_FORWARDS = 4, 1792, 3
# Grok-1 at full width with its depth cut 64 -> 2 (three layers would be
# 65.5 GB of float32 weights alone).
GROK_DEPTH, GROK_BATCH, GROK_SEQ, GROK_FORWARDS = 2, 2, 2048, 3
# SeamlessM4T-Large-v2 at full width and depth: 4 rows of the config's 1,024
# stub frames through the encoder and 1,024 text tokens through the decoder;
# the ragged frame count B10 is also held at.
SEAMLESS_BATCH, SEAMLESS_TEXT, SEAMLESS_FORWARDS = 4, 1024, 3
RAGGED_FRAMES = 1000
# DeepSeek-V2-Lite at full width and depth (64.84 GB of float32 weights).
DEEPSEEK_BATCH, DEEPSEEK_SEQ, DEEPSEEK_FORWARDS = 2, 2048, 3
# Training. The backward kernels are held against autograd through the
# plain versions gradient by gradient, max|d| / max|want|: each gradient is
# a sum over the sequence whose float32 terms cancel, so its error scales
# with the terms, not with the element.
GRAD_TOL = 2e-4
ATTN_BWD_PRODUCTS = 5          # S, dP, dV, dK, dQ: 2 hd FLOP each per allowed pair
# FLOP per state element a position that B9's gradient needs in its
# recurrent form: S recomputed 3, dC 2, dB 2, dxdt 2, G 3; the bound at the
# float32 SIMT rate beside the chunked form's at 3xTF32 (_ssd_bwd_flop).
SSD_BWD_FLOP_PER_NP = 12
# (label, B, Lq, Lk, H, KV, hd, causal, window)
BWD_ATTN_CASES = [
    ("yi-6b layer 0", 2, 4096, 4096, 32, 4, 128, True, 0),
    ("seamless encoder", 2, 1024, 1024, 16, 16, 64, False, 0),
    ("seamless decoder", 2, 1024, 1024, 16, 16, 64, True, 0),
    ("seamless cross Lk 1000", 2, 1024, 1000, 16, 16, 64, False, 0),
    ("window 64", 2, 300, 300, 8, 2, 64, True, 64),
]
# (label, B, H, L, P, N, chunk, G, dt |A| a step from 10 to 15: |cum| in
# the thousands, L underflowing a few positions off the diagonal)
BWD_SSD_CASES = [
    ("mamba2-130m layer", 8, 24, 2048, 64, 128, 256, 1, False),
    ("ragged L 1000", 2, 24, 1000, 64, 128, 256, 1, False),
    ("G 4", 2, 8, 512, 64, 128, 256, 4, False),
    ("large |cum|", 2, 24, 1024, 64, 128, 256, 1, True),
]
# B9's backward kernels, as the profiler names them, and their BWD_STAGES names.
SSD_BWD_KERNELS = {"chunk_cb_kernel": "bwd_chunk_cb", "chunk_state_kernel": "bwd_chunk_state",
                   "bwd_state_pass": "bwd_state_pass", "bwd_chunk_dc": "bwd_chunk_dc",
                   "bwd_chunk_db": "bwd_chunk_db", "bwd_ddt": "bwd_ddt"}
TRAIN_ARCHS = ("mamba2-130m", "yi-6b", "seamless-m4t-large-v2", "jamba-1.5-large-398b",
               "deepseek-v2-lite-16b")
TRAIN_SMOKE_SEQ, TRAIN_SMOKE_STEPS = 64, 3
TRAIN_LOSS_TOL = 1e-4          # relative: the SMOKE loss on the CPU and on the card
TRAIN_TOL = 2e-4               # max|d| / max|want| of each gradient, parameter, velocity leaf
# train pod at full width and depth: (arch, --batch, --seq); POD_STEPS steps
# each (the first warms up, the last runs under the profiler).
POD_RUNS = [("mamba2-130m", 8, 2048), ("seamless-m4t-large-v2", 2, 1024)]
POD_STEPS = 4
# (l) the DFedRW pod deployment: the gossip payload of FED_PAYLOAD's model
# copied to FED_PAYLOAD_PODS pods, and train pod --fed at full width:
# (arch, --pods, --batch, --seq, --steps, the --bits of each run), gossip
# every step on the ring. The scheduled step runs the SMOKE FED_SMOKE over
# FED_SMOKE_PODS pods, on the gossip flags of FED_TRACE_WINDOWS recorded windows.
FED_PAYLOAD, FED_PAYLOAD_PODS = "mamba2-130m", 4
FED_RUNS = [("mamba2-130m", 4, 4, 1024, 4, (8, 32)), ("internvl2-1b", 2, 2, 768, 3, (8,))]
FED_SMOKE, FED_SMOKE_PODS, FED_TRACE_WINDOWS = "mamba2-130m", 3, 2
FED_SHARE = 1e-3               # elements a wire code flip may move, card against CPU
# Serving, launch.serve's workload at temperature 0 with --mixed: (arch,
# --requests, --max-concurrency, --prompt-len, --gen, --chunk, --arrival).
# The SMOKE models run Yi-6B's workload on the CPU and on the card; the
# full-width workloads run SERVE_TIMED times with nothing wrapped (tokens/s,
# TTFT, TPOT and their spread), then once more, not timed, keeping each
# step's top-2 logit gaps: its SERVE_VERIFIED shortest requests are held
# against sequential_reference; SERVE_PROFILED_STEPS engine steps after the first
# SERVE_WARM_STEPS run under the profiler.
SERVE_RUNS = [("seamless-m4t-large-v2", 16, 8, 256, 64, 64, 0.5),
              ("yi-6b", 16, 8, 512, 64, 128, 0.5)]
# The float32 serving runs, an earlier path since launch.serve --full serves
# bf16 (phase (k4) runs SERVE_RUNS in bf16), keep their widths and workloads
# with the depth cut by this factor: Yi-6B 32 -> 4 layers, Seamless 24 + 24
# -> 3 + 3 (cut from 4 to 8 when phase (n) came); the script stays inside
# its time limit.
SERVE_F32_DEPTH_CUT = 8
# The bf16 serving runs of (k4), launch.serve --full's dtype, keep their
# widths and workloads with the depth cut by this factor: Yi-6B 32 -> 8
# layers, Seamless 24 + 24 -> 6 + 6 (whole until phase (q) came: the
# script took 1,156.6 s of its 1,200 with them whole; a host-bound serve
# step costs its layers' launches; cut from 2 to 4 when a whole run of the
# script with (q) went past 1,200 s on another machine).
SERVE_BF16_DEPTH_CUT = 4
SERVE_SMOKE = ("mamba2-130m", "jamba-1.5-large-398b", "deepseek-v2-lite-16b")
SERVE_VERIFIED = 1             # cut from 2 when phase (m) came: the script's time limit
SERVE_TIMED = 2                # cut from 3 with SERVE_BF16_DEPTH_CUT: the time limit
SERVE_WARM_STEPS, SERVE_PROFILED_STEPS = 8, 16
# The bf16 slice (launch.serve --full's dtype): a bf16 forward is held against
# the float32 forward at the same (bf16) weights, and Qwen2.5-32B's bf16
# decode against its bf16 kernel forward, by the loss, a mean over every
# position, within BF16_LOSS_RTOL, and normwise by the logits, rms(d) /
# rms(want), within each model's limit. The dense models read 0.01727 (Yi),
# 0.01743 (Seamless) and 0.02679 (Qwen's decode), the same to four digits on
# three machines: each limit is twice its reading. tools/bf16_fault_study.py
# plants bf16-only faults at cut widths: a dropped QKV bias reads ~1.3, an
# fp8 cast of the frame embeddings or of the decode cache 2.8-2.9 times the
# sound drift, all caught; a norm or a softmax P computed in bf16 reads
# 1.02-1.2 times it, which no normwise limit separates (the kernels' 1-ulp
# holds and the CPU parity tests cover those). Mamba2's random weights
# amplify each rounding: the reference's own bf16 forward of mamba2-130m is
# 0.218 of rms(want) from its float32 forward (the port reads 0.2028;
# tests/test_torch_bf16.py holds the port's drift to the reference's), so
# its limit is a sanity bound that uncorrelated logits (~1.4) cannot meet.
BF16_RMS_TOL = {"mamba2-130m": 0.5, "yi-6b": 0.035, "seamless-m4t-large-v2": 0.035}
QWEN_DECODE_RMS_TOL = 0.055
BF16_LOSS_RTOL = 1e-3
# Qwen2.5-32B at full width and depth in bf16 (65.53 GB of weights): a 1 x
# 2,048 forward keeps its bf16 logits (0.62 GB) and the loss's float32
# log-softmax (1.25 GB) beside them; decode of 4 prompts; a smaller serving
# workload than SERVE_RUNS' (each of its steps reads 65.5 GB of weights).
QWEN_BATCH, QWEN_SEQ, QWEN_FORWARDS = 1, 2048, 3
QWEN_DECODE_BATCH, QWEN_PROMPT, QWEN_GENERATE = 4, 32, 16
QWEN_SERVE_RUN = ("qwen2.5-32b", 8, 8, 256, 32, 128, 0.5)
# (n) Tensor-parallel serving, ``launch.serve --full --mesh-model TP_RANKS``
# under torchrun: the ranks share the one card, so their collectives go
# through gloo (NCCL refuses two ranks on one device). Each run is
# launch.serve's workload (arch, --requests, --max-concurrency,
# --prompt-len, --gen, --chunk, --arrival) at full width and depth in bf16,
# served first unsharded in this process from the same seeded weights; the
# prompts and budgets are SERVE_RUNS' cut to 128 and 32 tokens (every
# row-parallel sum of a prefill chunk crosses gloo in float32: the phase's
# time).
TP_RANKS = 2
TP_RUNS = [("yi-6b", 8, 8, 128, 32, 64, 0.5),
           ("seamless-m4t-large-v2", 8, 8, 128, 32, 64, 0.5)]
TP_TIMEOUT = 420
# (o) Data-parallel training, ``launch.train pod`` under torchrun: DP_RANKS
# ranks share the one card over gloo, on POD_RUNS' first run (mamba2-130m, 8
# x 2,048, POD_STEPS steps), each rank on its 4 rows. Rank 0's losses are held
# against (i)'s unsharded run from the same weights and batches within
# DP_LOSS_RTOL, relative: the gradient is averaged over the ranks in another
# order of sums, and B9b's dB/dC and the embedding's gradient add by atomics.
DP_RANKS = 2
DP_TIMEOUT = 300
DP_LOSS_RTOL = 1e-4
# (p) Data-parallel serving slots, ``launch.serve --full`` under torchrun on
# (n)'s Seamless run (8 requests on 8 slots) over each (data, model) mesh
# here, its ranks sharing the one card over gloo: (2, 1) gives each data rank
# 4 slots, (2, 2) 4 slots and 8 of the 16 heads. Held against (n)'s
# unsharded run of the same weights and workload, which is not served again.
DP_SERVE_MESHES = [(2, 1), (2, 2)]
DP_SERVE_TIMEOUT = 300
# (q) Pods with a data axis, ``launch.train pod --fed --pods POD_DATA_RUN's
# pods`` under torchrun with POD_DATA_RANKS ranks on the one card over gloo:
# the reference's (pods, ranks // pods, 1) mesh, each pod data-parallel over
# its ranks, the pods gossiping every step on the ring between the ranks of
# one data index, each rank's blocks its own wire tensors. (arch, --pods,
# --batch (a pod's rows), --seq, --steps); one run at each of POD_DATA_BITS.
# Bits 32 is held within DP_LOSS_RTOL of the same pods stacked on the card
# (data = 1) from the same weights and batches, run in this process.
POD_DATA_RUN = ("mamba2-130m", 2, 4, 1024, 3)
POD_DATA_RANKS = 4
POD_DATA_BITS = (32, 8)
POD_DATA_TIMEOUT = 300
# (r) Tensor-parallel training: make_train_step(cfg, make_host_mesh(1, TP_RANKS))
# in this script's --tp-train worker under torchrun, the ranks on the one card
# over gloo, as the reference's dry run calls its step (launch.train pod has no
# model-axis flag): (i)'s Seamless run (the same seeded weights and batches, at
# launch.train pod's default --lr_r), remat on, float32, TF32 off,
# TP_TRAIN_STEPS steps. Rank 0's losses are held against (i)'s within
# DP_LOSS_RTOL, and each leaf's update norm after the steps, ||p_3 - p_0|| in
# float64, against (i)'s within TP_NORM_RTOL (relative): a missing or doubled
# adjoint moves some leaf's by 1.5x or more.
TP_TRAIN_RUN = POD_RUNS[1]
TP_TRAIN_STEPS = 3
TP_TRAIN_LR_R = 100.0
TP_TRAIN_TIMEOUT = 300
TP_NORM_RTOL = 1e-3
SERVE_COUNTERS = ("requests_finished", "engine_steps", "prefill_chunks", "decode_steps",
                  "idle_steps", "prompt_tokens", "piggyback_tokens", "generated_tokens")


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
    its largest device items by name. Only device activity is traced: host
    operator events would add their recording to the wall time and their
    post-processing to the script's. Returns the idle share (None when the
    trace holds no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device-side events only (kernels, copies, fills), busy time as the
    # union of their intervals.
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
              f"idle_share={1 - busy_us / wall_us:.4f} device_events={len(spans)} "
              f"(trace read in {time.perf_counter() - t0 - wall_us / 1e6:.2f}s)")
        for name, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
            print(f"profile: {tot:10.1f} us x{cnt:<4d} {name[:100]}")
        return 1 - busy_us / wall_us
    print(f"profile {label}: no device time in the trace (not measured)")
    return None


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


def _kept_calls(module, attr, run, keep=(0,)):
    """Run ``run()`` with ``module.attr`` wrapped so that the arguments of
    the calls numbered in ``keep`` (from 0) are kept. Returns ({number:
    (args, kwargs)}, number of calls)."""
    kept, count = {}, [0]
    real = getattr(module, attr)

    def spy(*args, **kw):
        if count[0] in keep:
            kept[count[0]] = (args, kw)
        count[0] += 1
        return real(*args, **kw)

    setattr(module, attr, spy)
    try:
        run()
    finally:
        setattr(module, attr, real)
    return kept, count[0]


def _first_call(module, attr, run):
    """The arguments of the first call of ``module.attr`` in ``run()``:
    (args, kwargs, number of calls)."""
    kept, calls = _kept_calls(module, attr, run)
    return (*kept[0], calls)


@contextlib.contextmanager
def _routing():
    """Keep the output of every ``layers.moe_route`` call made inside: one
    (gate_vals, gate_idx, slot, keep, cap, aux, gap) a MoE slot, in order,
    where ``gap`` (b, l) is each token's k-th minus (k+1)-th router
    probability, recomputed beside the call."""
    import torch

    from repro_torch.models import layers as L

    kept, real = [], L.moe_route

    def keep(p, x, cfg):
        out = real(p, x, cfg)
        top = torch.sort(torch.softmax(x.float() @ p["router"], dim=-1), dim=-1,
                         descending=True).values
        k = cfg.moe.top_k
        kept.append((*out, top[..., k - 1] - top[..., k]))
        return out

    L.moe_route = keep
    try:
        yield kept
    finally:
        L.moe_route = real


def _kernel_calls(cfg):
    """Calls a forward makes of each LM kernel: one ``block_attention`` a
    GQA attention slot (MLA attends in plain torch), plus, in an
    encoder-decoder, one an encoder layer and one a cross layer; one
    ``ssd_scan`` (four stage kernels) a Mamba2 slot."""
    gqa = sum(k == "attn" for k in cfg.block_pattern) if cfg.attn_type == "gqa" else 0
    attn = cfg.n_blocks * gqa + (cfg.n_enc_layers + cfg.n_blocks if cfg.enc_dec else 0)
    return {"block_attn": attn,
            "ssd_scan": cfg.n_blocks * sum(k == "mamba" for k in cfg.block_pattern)}


def _smoke_phase(arch_id, tag):
    """The SMOKE configuration on the CPU (plain versions) and on the card
    from the same weights: a (2, 80) forward (after the vision stub's
    embeddings, or over the audio stub's frames in the encoder, where the
    model has one) and its aux loss, and 16 decode steps (an
    encoder-decoder's over the encoder's output), within SMOKE_TOL; every
    MoE slot routes every token to the same experts and drops the same
    choices on both; the kernel calls of :func:`_kernel_calls`. Returns the
    card forward's calls by kernel."""
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.kernels.block_attn import block_attn as ba
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.models import transformer as T

    small = get_smoke(arch_id)
    on_cpu = T.init_params(small, torch.Generator().manual_seed(2), device="cpu")
    on_card = _tree_to(on_cpu, "cuda")
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, small.vocab, (2, 80), generator=gen)
    emb = (torch.randn(2, small.frontend_tokens, small.d_model, generator=gen)
           if small.frontend != "none" else None)
    with torch.inference_mode():
        with _routing() as on_cpu_routes:
            want, want_aux = T.forward_train(small, on_cpu, toks, emb)
        ba.reset_launch_counts()
        sk.reset_launch_counts()
        with _routing() as on_card_routes:
            got, got_aux = T.forward_train(small, on_card, toks.cuda(),
                                           None if emb is None else emb.cuda())
        torch.cuda.synchronize()
        launches = {"block_attn": ba.LAUNCHES["block_attn"], "ssd_scan": sk.LAUNCHES["ssd_scan"]}
        stages = _stage_counts(sk)
        caches = [T.init_cache(small, 2, 16, device="cpu"), T.init_cache(small, 2, 16)]
        if small.enc_dec:
            caches[0]["enc_out"] = T._run_encoder(small, on_cpu, emb)
            caches[1]["enc_out"] = T._run_encoder(small, on_card, emb.cuda())
        worst_dec = 0.0
        for t in range(16):
            lg_cpu, caches[0] = T.decode_step(small, on_cpu, caches[0], toks[:, t:t + 1])
            lg_card, caches[1] = T.decode_step(small, on_card, caches[1], toks[:, t:t + 1].cuda())
            worst_dec = max(worst_dec, _tol_ratio(lg_card.cpu(), lg_cpu, SMOKE_TOL))
    fwd_ratio = _tol_ratio(got.cpu(), want, SMOKE_TOL)
    aux_ratio = _tol_ratio(got_aux.cpu(), want_aux, SMOKE_TOL)
    choices = sum(r[1].numel() for r in on_cpu_routes)
    same = sum(int((a[1] == b[1].cpu()).sum()) for a, b in zip(on_cpu_routes, on_card_routes))
    same_drops = all(torch.equal(a[3], b[3].cpu()) for a, b in zip(on_cpu_routes, on_card_routes))
    share = same / choices if choices else 1.0
    want_calls = _kernel_calls(small)
    routing = (f"; {len(on_cpu_routes)} MoE slots: equal gate_idx share={share:.6f} of "
               f"{choices}, same drops={same_drops} "
               f"({sum(int((~r[3]).sum()) for r in on_cpu_routes)} dropped), aux cpu="
               f"{float(want_aux):.8f} card={float(got_aux):.8f} ratio={aux_ratio:.4f}"
               if choices else "")
    front = ("" if emb is None else f" over 2 x {small.frontend_tokens} stub frames in the encoder"
             if small.enc_dec else f" after 2 x {small.frontend_tokens} stub embeddings")
    print(f"{small.name} {tag}: forward (2, 80){front} cpu-vs-card max|d|="
          f"{float((got.cpu() - want).abs().max()):.3e} ratio={fwd_ratio:.4f}; 16 decode steps "
          f"ratio={worst_dec:.4f} (tol {SMOKE_TOL}); calls {launches} (want {want_calls})"
          f"{f' stage kernels {stages}' if launches['ssd_scan'] else ''}{routing}")
    if (fwd_ratio > 1.0 or worst_dec > 1.0 or aux_ratio > 1.0 or share != 1.0
            or not same_drops or len(on_cpu_routes) != len(on_card_routes)
            or launches != want_calls
            or any(v != want_calls["ssd_scan"] for v in stages.values())):
        _fail(f"the SMOKE {arch_id} model disagrees between the CPU and the card (routing "
              f"share {share}), or launched {launches} calls and stage kernels {stages} "
              f"(want {want_calls})")
    return launches


def _first_flips(dec_routes, fwd_routes, seq):
    """Each row's first (position, layer) where a decode step's MoE routing
    (one list of :func:`_routing` entries a step) chose other experts than
    the forward's at that position, with both runs' k-th/(k+1)-th gaps
    there. Returns {row: (position, layer, forward gap, decode gap)}."""
    import torch

    flips = {}
    for t in range(seq):
        for layer, fwd in enumerate(fwd_routes):
            f_idx, f_gap = fwd[1], fwd[6]
            d_idx, d_gap = dec_routes[t][layer][1], dec_routes[t][layer][6]
            differ = (torch.sort(f_idx[:, t], -1).values
                      != torch.sort(d_idx[:, 0], -1).values).any(-1)
            for row in differ.nonzero().flatten().tolist():
                if row not in flips:
                    flips[row] = (t, layer, float(f_gap[row, t]), float(d_gap[row, 0]))
    return flips


def _stage_counts(km):
    """The stage kernels' launch counts of a kernel module that launches
    several kernels a call (``ssd_scan``'s four), else {}."""
    return dict(getattr(km, "KERNEL_LAUNCHES", {}))


def _kernel_device_ms(run, names, tries=3):
    """Device ms a launch of each kernel whose name contains one of
    ``names``, from ``torch.profiler`` over ``run()``: the mean over the
    launches the trace holds (it can miss the first ones), the run repeated
    up to ``tries`` times while some name has no launch in it; None for a
    name with no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        totals, counts, seen = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0), {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                seen[ev.name] = seen.get(ev.name, 0.0) + ev.time_range.elapsed_us()
                for name in names:
                    if name in ev.name:
                        totals[name] += ev.time_range.elapsed_us()
                        counts[name] += 1
        if all(counts.values()):
            break
        top = sorted(seen.items(), key=lambda kv: -kv[1])[:4]
        print(f"profiler: not all of {names} in the trace; its largest device items "
              f"{[(n[:60], round(us, 1)) for n, us in top]}")
    return {k: (totals[k] / counts[k] / 1e3 if counts[k] else None) for k in names}


def _forward_phase(cfg, params, batch, forwards, km, tag):
    """The main path: ``loss_fn`` at full width, ``forwards`` times (ms per
    forward, tokens/s, peak memory), which must launch the kernel of ``km``
    once a layer; then one forward under the profiler. Returns the
    launches."""
    import torch

    from repro_torch.models import transformer as T

    (name,) = km.LAUNCHES
    bsz, seq = batch["tokens"].shape
    n_front = batch["embeds"].shape[1] if "embeds" in batch else 0
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
    stages = _stage_counts(km)
    peak = torch.cuda.max_memory_allocated()
    fwd_ms = statistics.median(stamps)
    losses = [float(x) for x in losses]
    front = (f" {'with' if cfg.enc_dec else 'after'} {n_front} stub "
             f"{'frames a row through the encoder' if cfg.enc_dec else 'embeddings a row'} "
             f"(counted in tokens/s)" if n_front else "")
    print(f"{cfg.name} main path {tag}: loss_fn on {bsz}x{seq} tokens{front}: ms/forward "
          f"median={fwd_ms:.3f} all={[round(x, 3) for x in stamps]} tokens/s="
          f"{bsz * (n_front + seq) / fwd_ms * 1e3:.1f} loss={losses[0]:.6f} "
          f"peak_memory_allocated={peak} bytes {name} launches={launches} "
          f"(want {_kernel_calls(cfg)[name]} x {forwards})"
          f"{f' stage kernels {stages}' if stages else ''}")
    want = _kernel_calls(cfg)[name] * forwards
    if (launches != want or any(v != want for v in stages.values())
            or not all(math.isfinite(x) for x in losses)):
        _fail(f"main path: {launches} {name} launches and stage kernels {stages} in "
              f"{forwards} forwards (want {want} of each), losses {losses}")
    with torch.inference_mode():
        _profile(f"{cfg.name} loss_fn {bsz}x{seq} (1 forward) {tag}",
                 lambda: T.loss_fn(cfg, params, batch))
    return launches


def _decode_phase(cfg, params, prompts, n_params, km, tag, embeds=None, step_flop=None):
    """Greedy decode at full width: PROMPT tokens of each prompt, then
    GENERATE greedy tokens, through ``decode_step`` (ms per step beside the
    weight-read bound and, given ``step_flop``, the float32 compute bound),
    held against the kernel forward over the same sequence within
    DECODE_TOL; then 4 steps under the profiler. An encoder-decoder's cache
    holds ``_run_encoder`` over ``embeds``, and its steps must launch the
    kernel once a cross layer. Returns the medians of the step (ms) and the
    steps' kernel launches."""
    import torch

    from repro_torch.models import transformer as T

    (name,) = km.LAUNCHES
    batch = prompts.shape[0]
    seqs = [prompts]
    step_ms, dec_logits = [], []
    with torch.inference_mode():
        if cfg.enc_dec:
            cache = T.init_cache(cfg, batch, PROMPT + GENERATE, enc_len=embeds.shape[1])
            cache["enc_out"] = T._run_encoder(cfg, params, embeds)
        else:
            cache = T.init_cache(cfg, batch, PROMPT + GENERATE)
        nxt = prompts[:, :1]
        km.reset_launch_counts()
        dec_routes = []
        for t in range(PROMPT + GENERATE):
            tok = prompts[:, t:t + 1] if t < PROMPT else nxt
            if t >= PROMPT:
                seqs.append(tok)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _routing() as routes:
                lg, cache = T.decode_step(cfg, params, cache, tok)
            nxt = lg[:, -1].argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            dec_logits.append(lg[:, 0])
            dec_routes.append(routes)
        step_launches = km.LAUNCHES[name]
        km.reset_launch_counts()
        with _routing() as fwd_routes:
            fwd_logits, _ = T.forward_train(cfg, params, torch.cat(seqs, dim=1),
                                            embeds if cfg.enc_dec else None)
        launches = km.LAUNCHES[name]
        stages = _stage_counts(km)
    dec = torch.stack(dec_logits, dim=1)
    # MoE routing flips (ROADMAP.md C): a row is held up to its first
    # position whose routing differs from the forward's, and each such flip
    # must be a near-tie of the router in both runs.
    seq = PROMPT + GENERATE
    flips = _first_flips(dec_routes, fwd_routes, seq) if fwd_routes else {}
    held = torch.arange(seq, device=dec.device)[None, :] < torch.tensor(
        [flips.get(r, (seq,))[0] for r in range(batch)], device=dec.device)[:, None]
    near_ties = all(max(f[2], f[3]) < FLIP_GAP for f in flips.values())
    diff = torch.where(held[..., None], dec - fwd_logits, torch.zeros_like(dec))
    ratio = _tol_ratio(diff + fwd_logits, fwd_logits, DECODE_TOL)
    prompt_ratio = _tol_ratio(diff[:, :PROMPT] + fwd_logits[:, :PROMPT],
                              fwd_logits[:, :PROMPT], DECODE_TOL)
    step_med = statistics.median(step_ms[2:])
    gen_med = statistics.median(step_ms[PROMPT:])
    weight_ms = 4 * n_params / HBM_BYTES_PER_S * 1e3
    compute = ("" if step_flop is None else
               f"; float32 compute bound {step_flop:.4g} FLOP at {FP32_OPS_PER_S:.0e}/s = "
               f"{step_flop / FP32_OPS_PER_S * 1e3:.3f} ms")
    want_steps = (cfg.n_blocks if cfg.enc_dec and name == "block_attn" else 0) * len(step_ms)
    print(f"{cfg.name} decode {tag}: {batch} prompts x {PROMPT} tokens + {GENERATE} greedy: "
          f"ms/step median={step_med:.3f} prompt={statistics.median(step_ms[2:PROMPT]):.3f} "
          f"generate={gen_med:.3f} (weight-read bound "
          f"{weight_ms:.3f} ms = {weight_ms / step_med:.3f} of it{compute}); {step_launches} "
          f"{name} launches in {len(step_ms)} steps (want {want_steps}); decode vs kernel "
          f"forward ({launches} {name} launches) max|d|={float(diff.abs().max()):.3e} "
          f"ratio prompt={prompt_ratio:.4f} all {seq}={ratio:.4f} (tol {DECODE_TOL}) over "
          f"{int(held.sum())} of {held.numel()} (row, position) pairs")
    for row, (t, layer, f_gap, d_gap) in sorted(flips.items()):
        print(f"{cfg.name} decode {tag}: routing flip in row {row} at position {t}, MoE layer "
              f"{layer}: k-th minus (k+1)-th router probability {f_gap:.3e} in the forward, "
              f"{d_gap:.3e} in decode (a near-tie below {FLIP_GAP}: {max(f_gap, d_gap) < FLIP_GAP}); "
              f"the row is held before it, max|d| from there "
              f"{float((dec - fwd_logits)[row, t:].abs().max()):.3e}")
    want = _kernel_calls(cfg)[name]
    if (ratio > 1.0 or not torch.isfinite(dec).all() or launches != want or not near_ties
            or step_launches != want_steps or any(v != want for v in stages.values())):
        _fail(f"decode disagrees with the kernel forward at {cfg.name}'s full width (routing "
              f"flips {flips}), or the forward launched {launches} calls and stage kernels "
              f"{stages}, the steps {step_launches} (want {want_steps})")

    def decode_steps():
        c = cache
        for t in range(4):
            _, c = T.decode_step(cfg, params, c, prompts[:, t:t + 1])

    with torch.inference_mode():
        _profile(f"{cfg.name} decode batch {batch} (4 steps) {tag}", decode_steps)
    return {"step_ms": step_med, "generate_ms": gen_med, "launches": step_launches}


def _ssd_fwd_work(bsz, h, g, l, p, n, chunk):
    """(FLOP, bytes) of the scan's forward: C.B^T once per (batch, group,
    chunk) and (scores o L).xdt on the causal pairs j <= i of each chunk
    (the upper triangle is zero), C.S_in and the state update on every row,
    each chunk at its own length; x, dt, B, C read once, y written once."""
    lens = [min(chunk, l - k) for k in range(0, l, chunk)]
    flop = (bsz * g * sum(c_ * (c_ + 1) * n for c_ in lens)
            + bsz * h * sum(c_ * (c_ + 1) * p + 4 * c_ * n * p for c_ in lens))
    return flop, 4 * (2 * bsz * h * l * p + bsz * h * l + 2 * bsz * g * l * n + h)


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
    gen = torch.Generator("cuda").manual_seed(6)
    for b_, h_, l_, p_, n_, chunk_, g_ in SSD_SMALL:
        xs = torch.randn(b_, h_, l_, p_, generator=gen, device="cuda") * 0.8
        dts = torch.nn.functional.softplus(torch.randn(b_, h_, l_, generator=gen, device="cuda"))
        als = torch.log(torch.linspace(1.0, 16.0, h_, device="cuda"))
        bs, cs = (torch.randn(b_, g_, l_, n_, generator=gen, device="cuda") * 0.5
                  for _ in range(2))
        sk.reset_launch_counts()
        with torch.inference_mode():
            ys = sk.ssd_scan(xs, dts, als, bs, cs, chunk=chunk_)
            ref, _ = ssd_chunked_plain(xs, dts, als, bs, cs, chunk_)
        torch.cuda.synchronize()
        r = _tol_ratio(ys, ref, SSD_TOL)
        stages = _stage_counts(sk)
        print(f"ssd_scan {tag}: B={b_} H={h_} L={l_} P={p_} N={n_} chunk={chunk_} G={g_}: "
              f"max|d|={float((ys - ref).abs().max()):.3e} ratio={r:.4f} stage kernels {stages}")
        if not (r <= 1.0 and torch.isfinite(ys).all()
                and all(v == 1 for v in stages.values())):
            _fail(f"ssd_scan disagrees with its plain version at B={b_} H={h_} L={l_} P={p_} "
                  f"N={n_} chunk={chunk_} G={g_} (ratio {r:.4f}), or launched {stages}")
    del xs, dts, bs, cs, ys, ref

    # The operations the function needs: C.B^T once per (batch, group,
    # chunk) and (scores o L).xdt on the causal pairs j <= i of each chunk
    # (the upper triangle is zero), C.S_in and the state update on every
    # row; each chunk at its own length. The kernels run each product as
    # three TF32 products on the tensor cores: the bound is those at the
    # TF32 rate. Beside it, the earlier counts with C.B^T per head, at the
    # float32 SIMT rate and at the 3xTF32 rate.
    lens = [min(chunk, l - k) for k in range(0, l, chunk)]
    flop, nbytes = _ssd_fwd_work(bsz, h, g, l, p, n, chunk)
    flop_per_head = bsz * h * sum(c_ * (c_ + 1) * (n + p) + 4 * c_ * n * p for c_ in lens)
    bound_ops_ms = SSD_TF32_PASSES * flop / TF32_OPS_PER_S * 1e3
    old_simt_ms = flop_per_head / FP32_OPS_PER_S * 1e3
    old_tf32_ms = SSD_TF32_PASSES * flop_per_head / TF32_OPS_PER_S * 1e3
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    with torch.inference_mode():
        ms = statistics.median(_time_ms(lambda: sk.ssd_scan(x, dt, a_log, b, c, chunk=chunk),
                                        iters=10) for _ in range(5))
        plain_ms = statistics.median(_time_ms(lambda: ssd_chunked_plain(x, dt, a_log, b, c, chunk),
                                              iters=3, warmup=1) for _ in range(3))

        def five_calls():
            for _ in range(5):
                sk.ssd_scan(x, dt, a_log, b, c, chunk=chunk)

        stage_ms = _kernel_device_ms(five_calls, [f"{s_}_kernel" for s_ in sk.STAGES])
    bound_ms = max(bound_ops_ms, bound_bytes_ms)
    report = sk.stage_report(bsz, h, g, l, p, n, chunk)
    ptxas = _ptxas_report(sk.BUILD_INFO.get("log", ""))
    for name in sk.STAGES:
        shape = report[name]
        dev = stage_ms[f"{name}_kernel"]
        print(f"ssd_scan {tag}: stage {name}: {shape['smem_bytes']} bytes of dynamic shared "
              f"memory a block, {shape['blocks']} blocks of {shape['threads']} threads; "
              f"device ms a call (profiler) {'not measured' if dev is None else f'{dev:.4f}'}")
        for fn, regs, st, ld in ptxas:
            if f"{name}_kernel" in fn:
                print(f"ssd_scan {tag}: ptxas {fn}: {regs} registers, spill stores {st} bytes, "
                      f"spill loads {ld} bytes")
    print(f"ssd_scan {tag}: scratch bytes {report['scratch_bytes']} "
          f"({sum(report['scratch_bytes'].values())} in all, beside the function's {nbytes})")
    print(f"ssd_scan {tag}: ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
          f"(3xTF32 bound: {SSD_TF32_PASSES} x {flop} FLOP, C.B^T per group, at "
          f"{TF32_OPS_PER_S:.4g}/s = {bound_ops_ms:.4f} ms; earlier bounds with C.B^T per "
          f"head, {flop_per_head} FLOP: float32 SIMT {old_simt_ms:.4f} ms, 3xTF32 "
          f"{old_tf32_ms:.4f} ms; bytes {nbytes}, {bound_bytes_ms:.4f} ms) achieved "
          f"{flop / ms / 1e9:.2f} TFLOP/s of the function = {bound_ms / ms:.3f} of the bound, "
          f"{old_simt_ms / ms:.3f} of the old SIMT one")
    del x, dt, b, c, got, want, seq, diff     # out of the main path's peak memory
    entry = {"name": "ssd_scan", "route": "cuda", "source": SSD_SOURCE,
             "replaces": SSD_REPLACES, "launches": None, "max_abs_err": max_abs,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": "operations" if bound_ops_ms >= bound_bytes_ms else "bytes",
             "library_ms": None}

    _smoke_phase("mamba2-130m", tag)
    entry["launches"] = _forward_phase(cfg, params, batch, LM_FORWARDS, sk, tag)
    _decode_phase(cfg, params, tokens[:, :PROMPT], n_params, sk, tag)
    return entry


def _time_sdpa(q, k, v, want, backends=("FLASH_ATTENTION", "EFFICIENT_ATTENTION",
                                         "CUDNN_ATTENTION", "MATH"), causal=True):
    """PyTorch's one call for the same function, timed as a yardstick only
    (the port never calls it): fp32 ``scaled_dot_product_attention`` with
    ``is_causal=causal`` (and ``enable_gqa`` when K/V have fewer heads than
    q), on the first of ``backends`` that takes it. Returns (backend name,
    ms, max |d| against the kernel), or Nones."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    gqa = k.shape[2] != q.shape[2]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    for name in backends:
        backend = getattr(SDPBackend, name)

        def call():
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
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
    from repro_torch.kernels.block_attn.ref import attention_pairs, block_attention_plain

    tag = f"[{smi}]"
    cfg = get_arch("yi-6b")
    hd = cfg.head_dim_
    params, n_params = _init_on_card(cfg, tag)
    tokens = torch.randint(0, cfg.vocab, (YI_BATCH, YI_SEQ + 1),
                           generator=torch.Generator().manual_seed(1)).cuda()
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    # ------------------------------------------ block_attn vs plain version
    q, k, v, got, want = _hold_layer0_attention(cfg, params, batch, tag)
    bsz, l, h, _ = q.shape
    max_abs = float((got - want).abs().max())
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
    # K one float into its storage (not 16-byte aligned): the 4-byte copies
    # at hd 128, one launch.
    qs, vs = (torch.randn(1, 500, n, hd, generator=gen, device="cuda") for n in (8, 2))
    ks = torch.randn(500 * 2 * hd + 1, generator=gen, device="cuda")[1:].view(1, 500, 2, hd)
    ba.reset_launch_counts()
    with torch.inference_mode():
        o = ba.block_attn(qs, ks, vs, causal=True)
        ref = block_attention_plain(qs, ks, vs, causal=True)
    torch.cuda.synchronize()
    r = _tol_ratio(o, ref, ATTN_TOL)
    print(f"block_attn {tag}: K at byte offset {ks.data_ptr() % 16} mod 16, B=1 L=500 H=8 KV=2 "
          f"hd={hd}: max|d|={float((o - ref).abs().max()):.3e} ratio={r:.4f} "
          f"launches={ba.LAUNCHES['block_attn']}")
    if not (r <= 1.0 and torch.isfinite(o).all() and ba.LAUNCHES["block_attn"] == 1):
        _fail("block_attn disagrees with its plain version on an unaligned K view")
    del qs, ks, vs, o, ref

    # The function's work: 4 hd FLOP per allowed (i, j) pair, and one read
    # of q, k, v and one write of o. The kernel runs each product as three
    # TF32 products on the tensor cores: its bound is those at the TF32
    # rate; the float32 SIMT bound (no tensor cores) is printed beside it.
    flop = 4 * hd * attention_pairs(l, l, causal=True) * bsz * h
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    bound_ops_ms = ATTN_TF32_PASSES * flop / TF32_OPS_PER_S * 1e3
    bound_simt_ms = flop / FP32_OPS_PER_S * 1e3
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
          f"bytes a block (of 232,448), {bsz * h * -(-l // ba.QUERY_TILE)} blocks")
    for fn, regs, st, ld in _ptxas_report(ba.BUILD_INFO.get("log", "")):
        print(f"block_attn {tag}: ptxas {fn}: {regs} registers, spill stores {st} bytes, "
              f"spill loads {ld} bytes")
    print(f"block_attn {tag}: ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
          f"(3xTF32 bound: {ATTN_TF32_PASSES} x {flop} FLOP at {TF32_OPS_PER_S:.4g}/s = "
          f"{bound_ops_ms:.4f} ms; float32 SIMT bound: {flop} FLOP at {FP32_OPS_PER_S:.0e}/s = "
          f"{bound_simt_ms:.4f} ms; bytes {nbytes}, {bound_bytes_ms:.4f} ms) "
          f"achieved {flop / ms / 1e9:.2f} TFLOP/s of the function "
          f"= {bound_ms / ms:.3f} of the 3xTF32 bound, {bound_simt_ms / ms:.3f} of the SIMT one")
    print(f"block_attn {tag}: library fp32 scaled_dot_product_attention(is_causal, enable_gqa) "
          f"backend={backend} ms={library_ms} max|d| vs kernel={library_err}")
    print(f"block_attn {tag}: fp32 scaled_dot_product_attention(is_causal) on K/V repeated "
          f"to {h} heads, backend=EFFICIENT_ATTENTION ms={fused_ms} "
          f"max|d| vs kernel={fused_err}; kernel / fused = "
          f"{ms / fused_ms if fused_ms else float('nan'):.3f}")
    del q, k, v, got, want
    entry = {"name": "block_attn", "route": "cuda", "source": ATTN_SOURCE,
             "replaces": ATTN_REPLACES, "launches": None, "max_abs_err": max_abs,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": "operations" if bound_ops_ms >= bound_bytes_ms else "bytes",
             "library_ms": library_ms}

    _smoke_phase("yi-6b", tag)
    entry["launches"] = _forward_phase(cfg, params, batch, YI_FORWARDS, ba, tag)
    prompts = tokens[:, :YI_DECODE_BATCH // YI_BATCH * PROMPT].reshape(YI_DECODE_BATCH, PROMPT)
    _decode_phase(cfg, params, prompts, n_params, ba, tag)
    return entry



def _hold_layer0_attention(cfg, params, batch, tag):
    """One ``loss_fn`` whose first ``block_attention`` call is kept: the
    forward must call it once an attention slot, and the kernel on layer 0's
    own q/k/v must agree with its plain version within ATTN_TOL; its time at
    that shape beside the plain version's. Returns (q, k, v, kernel output,
    plain output)."""
    import torch

    from repro_torch.kernels.block_attn import block_attn as ba
    from repro_torch.kernels.block_attn import ops as attn_ops
    from repro_torch.kernels.block_attn.ref import block_attention_plain
    from repro_torch.models import transformer as T

    with torch.inference_mode():
        (q, k, v), kw, calls = _first_call(attn_ops, "block_attention",
                                           lambda: T.loss_fn(cfg, params, batch))
        want_calls = _kernel_calls(cfg)["block_attn"]
        if calls != want_calls or kw != {"causal": True, "window": cfg.sliding_window}:
            _fail(f"{cfg.name}: the forward called block_attention {calls} times (want "
                  f"{want_calls}), layer 0 with {kw}")
        got = ba.block_attn(q, k, v, causal=True)
        want = block_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        ratio = _tol_ratio(got, want, ATTN_TOL)
        ms = statistics.median(_time_ms(lambda: ba.block_attn(q, k, v), iters=10)
                               for _ in range(3))
        plain_ms = _time_ms(lambda: block_attention_plain(q, k, v), iters=2, warmup=1)
    print(f"block_attn {tag}: {cfg.name} layer 0 q{tuple(q.shape)} k/v{tuple(k.shape)} "
          f"strides {q.stride()}/{k.stride()} n_rep {q.shape[2] // k.shape[2]} causal: vs "
          f"plain max|d|={float((got - want).abs().max()):.3e} ratio={ratio:.4f} (tol "
          f"{ATTN_TOL}); max|o|={float(want.abs().max()):.3e}; ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f}; {calls} calls a forward")
    if not (ratio <= 1.0 and torch.isfinite(got).all()):
        _fail(f"block_attn disagrees with its plain version on {cfg.name}'s layer 0 "
              f"(ratio {ratio:.4f})")
    return q, k, v, got, want


def _init_on_card(cfg, tag, note="", dtype=None):
    """Random weights drawn on the card from a seed, float32 unless
    ``dtype`` says bf16. Returns (params, parameter count)."""
    import torch

    from repro_torch.models import transformer as T

    dtype = dtype or torch.float32
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator("cuda").manual_seed(0), dtype)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    moe = "" if cfg.moe is None else (
        f" experts={cfg.moe.n_experts} top_k={cfg.moe.top_k} d_expert={cfg.moe.d_expert} "
        f"capacity_factor={cfg.moe.capacity_factor}")
    print(f"{cfg.name} {tag}: n_layers={cfg.n_layers}{note} d_model={cfg.d_model} "
          f"heads={cfg.n_heads} kv_heads={cfg.n_kv_heads} hd={cfg.head_dim_} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab} qkv_bias={cfg.qkv_bias} frontend={cfg.frontend}{moe} "
          f"params={n_params} ({n_bytes} bytes, {str(dtype).split('.')[-1]}; param_count "
          f"{cfg.param_count()}) init on the card {time.perf_counter() - t0:.2f}s "
          f"memory_allocated={torch.cuda.memory_allocated()} bytes "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()} bytes")
    return params, n_params


def vlm_phase(smi):
    """(a) InternVL2-1B (``configs.internvl2_1b``) at full width and depth,
    random weights: the SMOKE configuration on the CPU and the card, then
    ``loss_fn`` on VLM_BATCH rows of the vision stub's 256 embeddings drawn
    N(0, 1) (as the reference's ``pod_main`` draws them) and VLM_TEXT text
    tokens, held as the Yi-6B path is (layer 0 against the plain version,
    24 calls a forward), and text decode of 8 prompts against the kernel
    forward. Returns the ``block_attn`` calls of the main path."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.block_attn import block_attn as ba

    tag = f"[{smi}]"
    _smoke_phase("internvl2-1b", tag)
    cfg = get_arch("internvl2-1b")
    params, n_params = _init_on_card(cfg, tag)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (VLM_BATCH, VLM_TEXT + 1), generator=gen)
    embeds = torch.randn(VLM_BATCH, cfg.frontend_tokens, cfg.d_model, generator=gen)
    batch = {"tokens": tokens[:, :-1].cuda(), "labels": tokens[:, 1:].cuda(),
             "embeds": embeds.cuda()}
    _hold_layer0_attention(cfg, params, batch, tag)
    launches = _forward_phase(cfg, params, batch, VLM_FORWARDS, ba, tag)
    per_row = YI_DECODE_BATCH // VLM_BATCH * PROMPT
    prompts = tokens[:, :per_row].reshape(YI_DECODE_BATCH, PROMPT).cuda()
    _decode_phase(cfg, params, prompts, n_params, ba, tag)
    return launches


def grok_phase(smi):
    """(b) Grok-1 (``configs.grok_1_314b``) at full width with its depth cut
    to GROK_DEPTH layers, random weights: the SMOKE configuration on the CPU
    and the card; ``loss_fn`` on GROK_BATCH x GROK_SEQ tokens with each MoE
    layer's aux loss, load per row and expert, and dropped choices (at
    capacity factor 1 the expected load equals the capacity, so choices
    drop); layer 0's attention (n_rep 6) against the plain version; decode
    of 8 prompts against the kernel forward at ``capacity_factor = e / k``,
    where the forward drops nothing either. Returns the ``block_attn``
    calls of the main path."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels.block_attn import block_attn as ba
    from repro_torch.models import transformer as T

    tag = f"[{smi}]"
    _smoke_phase("grok-1-314b", tag)
    full = get_arch("grok-1-314b")
    cfg = dataclasses.replace(full, n_layers=GROK_DEPTH)
    params, n_params = _init_on_card(
        cfg, tag, f" (of {full.n_layers}; {full.param_count()} parameters at full depth)")
    tokens = torch.randint(0, cfg.vocab, (GROK_BATCH, GROK_SEQ + 1),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens[:, :-1].cuda(), "labels": tokens[:, 1:].cuda()}
    _hold_layer0_attention(cfg, params, batch, tag)

    mo = cfg.moe
    with torch.inference_mode(), _routing() as routes:
        loss = T.loss_fn(cfg, params, batch)
        torch.cuda.synchronize()
    for layer, (_, gate_idx, _, keep, cap, aux, _) in enumerate(routes):
        load = F.one_hot(gate_idx, mo.n_experts).sum(dim=(1, 2))     # (rows, experts)
        print(f"{cfg.name} {tag}: MoE layer {layer}: aux={float(aux):.8f} cap={cap} "
              f"(expected load {GROK_SEQ * mo.top_k // mo.n_experts} a row and expert) "
              f"load by row and expert {load.tolist()} dropped choices "
              f"{int((~keep).sum())} of {keep.numel()}")
    if len(routes) != GROK_DEPTH or not math.isfinite(float(loss)):
        _fail(f"{cfg.name}: {len(routes)} MoE layers routed, loss {float(loss)}")
    print(f"{cfg.name} {tag}: loss_fn={float(loss):.6f} aux total="
          f"{sum(float(r[5]) for r in routes):.8f}")
    launches = _forward_phase(cfg, params, batch, GROK_FORWARDS, ba, tag)
    no_drops = dataclasses.replace(cfg, moe=dataclasses.replace(
        mo, capacity_factor=mo.n_experts / mo.top_k))
    print(f"{cfg.name} {tag}: decode against the forward at capacity_factor = "
          f"{mo.n_experts}/{mo.top_k} = {no_drops.moe.capacity_factor}: the forward's "
          f"capacity is at least its length, so it drops nothing, as decode (one token "
          f"a group, capacity 8) never does; at capacity factor 1 they differ by design")
    prompts = tokens[:, :YI_DECODE_BATCH // GROK_BATCH * PROMPT].reshape(
        YI_DECODE_BATCH, PROMPT).cuda()
    _decode_phase(no_drops, params, prompts, n_params, ba, tag)
    return launches


def _bf16_ulps(got, want, scale):
    """The largest |got - want| of two bf16 tensors in bf16 ulps, each at
    the element's magnitude but no finer than at 2^-8 * ``scale`` (the
    operands' largest magnitude): an output that cancels below that is set
    by the order of the float32 sums, not by the one rounding."""
    import torch

    g, w = got.float(), want.float()
    mag = torch.clamp_min(torch.maximum(g.abs(), w.abs()), 2.0 ** -8 * scale)
    return float(((g - w).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())


def _attn_bound(q, k, causal, window=0):
    """(bound ms, bound_by, FLOP, bytes, ops ms, design ms) of block_attn on
    these shapes: the function's 4 hd FLOP a pair the mask allows, and one
    read of q, k, v and one write of o in their dtype. float32: the FLOP at
    the rate of the 3 TF32 products the kernel issues for each (its
    3xTF32 design, tighter than the card's float32 peak). bf16: the FLOP at
    the card's dense bf16 peak; the design's rate (one TF32 product for
    Q K^T, two for P V: 1.5 a FLOP at the bf16 rate) is returned beside it
    as information only."""
    from repro_torch.kernels.block_attn.ref import attention_pairs

    bsz, lq, h, hd = q.shape
    flop = 4 * hd * attention_pairs(lq, k.shape[1], causal=causal, window=window) * bsz * h
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    if q.element_size() == 4:
        ops_ms = design_ms = ATTN_TF32_PASSES * flop / TF32_OPS_PER_S * 1e3
    else:
        ops_ms = flop / BF16_OPS_PER_S * 1e3
        design_ms = ATTN_BF16_PASSES * flop / BF16_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes", flop,
            nbytes, ops_ms, design_ms)


def _hold_attn_mode(label, q, k, v, causal, tag):
    """``block_attn`` on one call's own q/k/v against its plain version
    (float32: within ATTN_TOL; bf16: within 1 bf16 ulp, :func:`_bf16_ulps`),
    timed beside the plain version and ``scaled_dot_product_attention`` in
    the same dtype on the same shapes (the library yardstick) and, for
    bf16, the float32 kernel on the same values, with its bound
    (:func:`_attn_bound`). Returns the mode's entry of the kernels line."""
    import torch

    from repro_torch.kernels.block_attn import block_attn as ba
    from repro_torch.kernels.block_attn.ref import block_attention_plain

    bf16 = q.dtype == torch.bfloat16
    with torch.inference_mode():
        ba.reset_launch_counts()
        got = ba.block_attn(q, k, v, causal=causal)
        _no_repacks(label)
        want = block_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ratio = (_bf16_ulps(got, want, float(v.float().abs().max())) if bf16
                 else _tol_ratio(got, want, ATTN_TOL))
        ms = statistics.median(_time_ms(lambda: ba.block_attn(q, k, v, causal=causal),
                                        iters=10) for _ in range(3))
        plain_ms = _time_ms(lambda: block_attention_plain(q, k, v, causal=causal),
                            iters=2, warmup=1)
        backend, library_ms, library_err = _time_sdpa(q, k, v, got, causal=causal)
        f32_ms = None
        if bf16:
            qf, kf, vf = (t.float() for t in (q, k, v))
            f32_ms = statistics.median(_time_ms(lambda: ba.block_attn(qf, kf, vf, causal=causal),
                                                iters=10) for _ in range(3))
            del qf, kf, vf
    bound_ms, bound_by, flop, nbytes, ops_ms, design_ms = _attn_bound(q, k, causal)
    max_abs = float((got.float() - want.float()).abs().max())
    held = f"ulps={ratio:.3f} (at most 1)" if bf16 else f"ratio={ratio:.4f} (tol {ATTN_TOL})"
    ops = (f"{flop} FLOP at the bf16 peak {BF16_OPS_PER_S:.4g}/s = {ops_ms:.4f} ms; for "
           f"information, the design's {ATTN_BF16_PASSES} bf16 products a FLOP = "
           f"{design_ms:.4f} ms" if bf16 else
           f"{ATTN_TF32_PASSES} x {flop} FLOP at TF32 {TF32_OPS_PER_S:.4g}/s = {ops_ms:.4f} ms")
    print(f"block_attn {tag}: {label} {str(q.dtype).split('.')[-1]} q{tuple(q.shape)} "
          f"k/v{tuple(k.shape)} causal={causal}: vs plain max|d|={max_abs:.3e} {held}; "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} (by {bound_by}; "
          f"operations {ops}; bytes {nbytes} = "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms) = {bound_ms / ms:.3f} of it"
          f"{f'; float32 kernel on the same values ms={f32_ms:.4f}' if bf16 else ''}; library "
          f"scaled_dot_product_attention backend={backend} ms={library_ms} max|d| vs "
          f"kernel={library_err}")
    if not (ratio <= 1.0 and torch.isfinite(got).all()):
        _fail(f"block_attn disagrees with its plain version on {label} ({held})")
    entry = {"q": list(q.shape), "kv": list(k.shape), "causal": causal,
             "dtype": str(q.dtype).split(".")[-1], "max_abs_err": max_abs,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": library_ms, "library_backend": backend}
    if bf16:
        entry["float32_ms"] = f32_ms
    return entry


def seamless_phase(smi):
    """(e) SeamlessM4T-Large-v2 (``configs.seamless_m4t_large_v2``) at full
    width and depth, random weights, the audio stub's frames drawn N(0, 1):
    the SMOKE configuration on the CPU and the card; ``block_attn`` in the
    modes the encoder-decoder opens, each on layer 0's own inputs from a
    full-width forward (the encoder's non-causal call, the decoder's causal
    call, the cross call; the encoder and cross calls again at
    RAGGED_FRAMES frames; decode's cross call at Lq = 1), see
    :func:`_hold_attn_mode`; ``loss_fn`` on SEAMLESS_BATCH x SEAMLESS_TEXT
    tokens over as many rows of 1,024 frames (72 calls a forward: 24 of
    each mode); decode of 8 prompts over the encoder's output against the
    kernel forward, with the step's float32 FLOP and the time of the cross
    layers' K/V projections, which every step recomputes as the reference
    does. Returns (the forward's launches, the decode steps' launches, the
    modes' entries)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.block_attn import block_attn as ba
    from repro_torch.kernels.block_attn import ops as attn_ops
    from repro_torch.models import transformer as T

    tag = f"[{smi}]"
    _smoke_phase("seamless-m4t-large-v2", tag)
    cfg = get_arch("seamless-m4t-large-v2")
    params, n_params = _init_on_card(cfg, tag)
    gen = torch.Generator().manual_seed(1)
    frames = cfg.frontend_tokens
    tokens = torch.randint(0, cfg.vocab, (SEAMLESS_BATCH, SEAMLESS_TEXT + 1), generator=gen)
    embeds = torch.randn(SEAMLESS_BATCH, frames, cfg.d_model, generator=gen).cuda()
    batch = {"tokens": tokens[:, :-1].cuda(), "labels": tokens[:, 1:].cuda(), "embeds": embeds}
    n_enc = cfg.n_enc_layers
    want_calls = _kernel_calls(cfg)["block_attn"]

    def layer0(run_batch):
        kept, calls = _kept_calls(attn_ops, "block_attention",
                                  lambda: T.loss_fn(cfg, params, run_batch),
                                  keep=(0, n_enc, n_enc + 1))
        kws = [kept[i][1] for i in (0, n_enc, n_enc + 1)]
        if calls != want_calls or kws != [{"causal": False, "window": 0},
                                          {"causal": True, "window": 0},
                                          {"causal": False, "window": 0}]:
            _fail(f"{cfg.name}: the forward called block_attention {calls} times (want "
                  f"{want_calls}), layer 0 with {kws}")
        return [kept[i][0] for i in (0, n_enc, n_enc + 1)]

    with torch.inference_mode():
        enc, dec, cross = layer0(batch)
        ragged = {**batch, "embeds": embeds[:, :RAGGED_FRAMES]}
        r_enc, _, r_cross = layer0(ragged)
    modes = {"encoder": _hold_attn_mode("encoder layer 0 (non-causal)", *enc, False, tag),
             "decoder": _hold_attn_mode("decoder layer 0 (causal)", *dec, True, tag),
             "cross": _hold_attn_mode("cross layer 0", *cross, False, tag),
             "encoder_ragged": _hold_attn_mode(f"encoder layer 0 at {RAGGED_FRAMES} frames",
                                               *r_enc, False, tag),
             "cross_ragged": _hold_attn_mode(f"cross layer 0 at {RAGGED_FRAMES} frames",
                                             *r_cross, False, tag)}
    del enc, dec, cross, r_enc, r_cross, ragged
    print(f"{cfg.name} {tag}: block_attention calls a forward: {n_enc} encoder (non-causal, "
          f"Lq = Lk = {frames}), {cfg.n_blocks} decoder (causal, Lq = Lk = {SEAMLESS_TEXT}), "
          f"{cfg.n_blocks} cross (non-causal, Lq = {SEAMLESS_TEXT}, Lk = {frames})")
    launches = _forward_phase(cfg, params, batch, SEAMLESS_FORWARDS, ba, tag)

    per_row = YI_DECODE_BATCH // SEAMLESS_BATCH * PROMPT
    prompts = tokens[:, :per_row].reshape(YI_DECODE_BATCH, PROMPT).cuda()
    dec_embeds = embeds.repeat_interleave(YI_DECODE_BATCH // SEAMLESS_BATCH, dim=0)
    with torch.inference_mode():
        cache = T.init_cache(cfg, YI_DECODE_BATCH, PROMPT + GENERATE, enc_len=frames)
        cache["enc_out"] = T._run_encoder(cfg, params, dec_embeds)
        kept, calls = _kept_calls(attn_ops, "block_attention",
                                  lambda: T.decode_step(cfg, params, cache, prompts[:, :1]))
    if calls != cfg.n_blocks or kept[0][1] != {"causal": False, "window": 0}:
        _fail(f"{cfg.name}: a decode step called block_attention {calls} times (want "
              f"{cfg.n_blocks}), the first with {kept[0][1]}")
    modes["decode_cross"] = _hold_attn_mode("decode cross layer 0 (Lq = 1)", *kept[0][0],
                                            False, tag)
    # A step's float32 work: the decoder's weights (blocks, cross layers,
    # head) once a row; every cross layer's K/V projections of the whole
    # encoder output; attention over the encoder frames and the cache.
    d, hd, h = cfg.d_model, cfg.head_dim_, cfg.n_heads
    dec_weights = sum(t.numel() for part in ("blocks", "cross", "head")
                      for t in _leaves(params[part]))
    kv_flop = cfg.n_blocks * 2 * (2 * YI_DECODE_BATCH * frames * d * d)
    attn_flop = 4 * hd * h * YI_DECODE_BATCH * cfg.n_blocks * (frames + PROMPT + GENERATE)
    step_flop = 2 * YI_DECODE_BATCH * dec_weights + kv_flop + attn_flop
    cross_wk, cross_wv = params["cross"]["mixer"]["wk"], params["cross"]["mixer"]["wv"]
    enc_out = cache["enc_out"]
    del kept, cache

    def cross_kv():
        for i in range(cfg.n_blocks):
            enc_out @ cross_wk[i]
            enc_out @ cross_wv[i]

    with torch.inference_mode():
        kv_ms = statistics.median(_time_ms(cross_kv, iters=3, warmup=1) for _ in range(3))
    decode = _decode_phase(cfg, params, prompts, n_params, ba, tag, embeds=dec_embeds,
                           step_flop=step_flop)
    print(f"{cfg.name} decode {tag}: the cross layers' K/V projections of the encoder output "
          f"({cfg.n_blocks} x 2 products of ({YI_DECODE_BATCH * frames} x {d}) @ ({d} x {d}), "
          f"{kv_flop} FLOP, recomputed every step as the reference does) take {kv_ms:.3f} ms "
          f"= {kv_ms / decode['generate_ms']:.3f} of the generate step's "
          f"{decode['generate_ms']:.3f} ms")
    return launches, decode["launches"], modes


def _deepseek_forward_flop(cfg, bsz, seq):
    """The float32 FLOP of one DeepSeek forward as the port computes it:
    every projection (the absorbed w_uk/w_uv per token and head too), the
    latent attention over all L^2 pairs as the reference materializes them,
    the router, the expert slots at the forward's capacity and the shared
    experts, and the head."""
    m, mo = cfg.mla, cfg.moe
    d, h, tokens = cfg.d_model, cfg.n_heads, bsz * seq
    mixer = (d * h * (m.qk_nope_dim + m.qk_rope_dim) + d * (m.kv_lora_rank + m.qk_rope_dim)
             + m.kv_lora_rank * h * (m.qk_nope_dim + m.v_head_dim) + h * m.v_head_dim * d)
    attn = 2 * bsz * h * seq * seq * (2 * m.kv_lora_rank + m.qk_rope_dim)
    width = min(max(8, int(seq * mo.top_k * mo.capacity_factor / mo.n_experts)), seq)
    experts = 2 * bsz * mo.n_experts * width * 3 * d * mo.d_expert
    shared = 2 * tokens * 3 * d * mo.n_shared * mo.d_expert
    layer = 2 * tokens * mixer + attn + 2 * tokens * d * mo.n_experts + experts + shared
    return cfg.n_layers * layer + 2 * tokens * d * cfg.vocab


def deepseek_phase(smi):
    """(f) DeepSeek-V2-Lite (``configs.deepseek_v2_lite_16b``) at full width
    and depth, random weights, run last, when every earlier phase's tensors
    are freed (64.84 GB of float32 weights): the SMOKE configuration on the
    CPU and the card (equal routing, no kernel: MLA attends in plain torch);
    MLA layer 0 of a full-width forward on the card against the same layer
    on the CPU (plain torch on the host), within SMOKE_TOL; each MoE layer's
    aux loss, capacity, load and drops; ``loss_fn`` on DEEPSEEK_BATCH x
    DEEPSEEK_SEQ tokens (no ``block_attn`` launch); decode at
    ``capacity_factor = e / k`` against the forward. Returns the forward's
    ``block_attn`` launches (0)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels.block_attn import block_attn as ba
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    tag = f"[{smi}]"
    launches = _smoke_phase("deepseek-v2-lite-16b", tag)
    if launches["block_attn"]:
        _fail(f"the DeepSeek SMOKE forward launched block_attn {launches['block_attn']} times")
    cfg = get_arch("deepseek-v2-lite-16b")
    print(f"{cfg.name} {tag}: before init memory_allocated={torch.cuda.memory_allocated()} "
          f"bytes (the earlier phases freed)")
    params, n_params = _init_on_card(cfg, tag, f" mla={cfg.mla}")
    tokens = torch.randint(0, cfg.vocab, (DEEPSEEK_BATCH, DEEPSEEK_SEQ + 1),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens[:, :-1].cuda(), "labels": tokens[:, 1:].cuda()}

    mo = cfg.moe
    with torch.inference_mode(), _routing() as routes:
        (p, h, _, cos, sin), _, calls = _first_call(
            L, "mla_train", lambda: T.loss_fn(cfg, params, batch))
        torch.cuda.synchronize()
    if calls != cfg.n_layers or len(routes) != cfg.n_layers:
        _fail(f"{cfg.name}: {calls} mla_train calls and {len(routes)} MoE layers a forward "
              f"(want {cfg.n_layers})")
    drops = []
    for layer, (_, gate_idx, _, keep, cap, aux, _) in enumerate(routes):
        load = F.one_hot(gate_idx, mo.n_experts).sum(dim=(1, 2))     # (rows, experts)
        drops.append(int((~keep).sum()))
        print(f"{cfg.name} {tag}: MoE layer {layer}: aux={float(aux):.8f} cap={cap} (expected "
              f"load {DEEPSEEK_SEQ * mo.top_k // mo.n_experts}) load by row and expert "
              f"min={int(load.min())} max={int(load.max())} dropped choices {drops[-1]} of "
              f"{keep.numel()}")
    print(f"{cfg.name} {tag}: aux total={sum(float(r[5]) for r in routes):.8f} dropped "
          f"{sum(drops)} of {cfg.n_layers * routes[0][3].numel()} choices")
    del routes
    with torch.inference_mode():
        got = L.mla_train(p, h, cfg, cos, sin)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = L.mla_train(_tree_to(p, "cpu"), h.cpu(), cfg, cos.cpu(), sin.cpu())
        cpu_s = time.perf_counter() - t0
        ms = statistics.median(_time_ms(lambda: L.mla_train(p, h, cfg, cos, sin), iters=3)
                               for _ in range(3))
    ratio = _tol_ratio(got.cpu(), want, SMOKE_TOL)
    print(f"{cfg.name} {tag}: MLA layer 0 on x{tuple(h.shape)} (rank {cfg.mla.kv_lora_rank}, "
          f"scale 1/sqrt({cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim})): card vs CPU max|d|="
          f"{float((got.cpu() - want).abs().max()):.3e} ratio={ratio:.4f} (tol {SMOKE_TOL}); "
          f"max|y|={float(want.abs().max()):.3e}; card ms={ms:.3f}, CPU {cpu_s:.2f}s")
    if not (ratio <= 1.0 and torch.isfinite(got).all()):
        _fail(f"{cfg.name}: MLA layer 0 disagrees between the card and the CPU")
    del p, h, cos, sin, got, want
    flop = _deepseek_forward_flop(cfg, DEEPSEEK_BATCH, DEEPSEEK_SEQ)
    print(f"{cfg.name} {tag}: a forward's float32 work {flop:.4g} FLOP (latent attention over "
          f"all L^2 pairs, expert slots at capacity {mo.capacity_factor})")
    launches = _forward_phase(cfg, params, batch, DEEPSEEK_FORWARDS, ba, tag)
    no_drops = dataclasses.replace(cfg, moe=dataclasses.replace(
        mo, capacity_factor=mo.n_experts / mo.top_k))
    prompts = tokens[:, :YI_DECODE_BATCH // DEEPSEEK_BATCH * PROMPT].reshape(
        YI_DECODE_BATCH, PROMPT).cuda()
    _decode_phase(no_drops, params, prompts, n_params, ba, tag)
    return launches


def _serve_workload(run, cfg):
    """``launch.serve.build_requests`` for one of SERVE_RUNS: the
    reference's numpy draws from seed 0 (an encoder-decoder's frame
    embeddings too), temperature 0, no EOS."""
    import argparse

    from repro_torch.launch.serve import build_requests

    _, requests, _, prompt_len, gen, _, arrival = run
    return build_requests(argparse.Namespace(
        seed=0, requests=requests, prompt_len=prompt_len, gen=gen, mixed=True,
        arrival=arrival, eos_id=-1, temperature=0.0), cfg)


def _serve_config(run, dtype=None):
    import torch

    from repro_torch.serve import EngineConfig

    _, _, slots, prompt_len, gen, chunk, _ = run
    return EngineConfig(max_concurrency=slots, max_len=prompt_len + gen, chunk=chunk,
                        dtype=dtype or torch.float32)


def _serve_counters(eng):
    summary = eng.metrics.summary()
    return {key: summary[key] for key in SERVE_COUNTERS}


def _hold_mamba_prefill(cfg, params, tag):
    """``mamba_prefill`` over a chunk on the card against ``mamba_decode``
    token at a time on the same rows (n_valid 128, 37 and 0): outputs and
    state equal, bit for bit."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    slot = cfg.block_pattern.index("mamba")
    p = {k: v[0].cuda() for k, v in params["blocks"][f"slot{slot}"]["mixer"].items()}
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(3, 128, cfg.d_model, generator=gen).cuda()
    cache = {k: torch.randn(v[0].shape, generator=gen).cuda() for k, v in
             T.init_cache(cfg, 3, 8, device="cpu")["slots"][f"slot{slot}"].items()}
    n_valid = torch.tensor([128, 37, 0], device="cuda")
    with torch.inference_mode():
        y, got = L.mamba_prefill(p, x, cache, n_valid, cfg)
        same, want = True, cache
        for t in range(x.shape[1]):
            yt, want = L.mamba_decode(p, x[:, t:t + 1].clone(), want, cfg, active=t < n_valid)
            same &= torch.equal(y[:, t], yt[:, 0])
    same &= all(torch.equal(got[k], want[k]) for k in got)
    print(f"{cfg.name} serve smoke {tag}: mamba_prefill over 128 tokens (n_valid 128, 37, 0) "
          f"against mamba_decode token at a time on the card: bit for bit {same}")
    if not same:
        _fail(f"{cfg.name}: mamba_prefill differs from the decode step on the card")


def serve_smoke_phase(arch_id, tag):
    """A SMOKE model served on the CPU and on the card from the same weights,
    Yi-6B's workload of SERVE_RUNS: the token streams and the
    ``EngineMetrics`` counters must be equal."""
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine

    run = SERVE_RUNS[-1]
    small = get_smoke(arch_id)
    on_cpu = T.init_params(small, torch.Generator().manual_seed(2), device="cpu")
    reqs = _serve_workload(run, small)
    if "mamba" in small.block_pattern:
        _hold_mamba_prefill(small, on_cpu, tag)
    out = {}
    for dev, params in (("cpu", on_cpu), ("cuda", _tree_to(on_cpu, "cuda"))):
        eng = ServeEngine(small, params, _serve_config(run), device=dev)
        t0 = time.perf_counter()
        streams = [st.generated for st in eng.run(reqs)]
        out[dev] = (streams, _serve_counters(eng), time.perf_counter() - t0)
    same = out["cpu"][0] == out["cuda"][0]
    differ = sum(a != b for a, b in zip(out["cpu"][0], out["cuda"][0]))
    print(f"{small.name} serve smoke {tag}: {len(reqs)} requests, {run[2]} slots, prompts "
          f"<= {run[3]}, gen <= {run[4]}, chunk {run[5]}: counters cpu {out['cpu'][1]} card "
          f"{out['cuda'][1]}; token streams equal={same} ({differ} of {len(reqs)} differ; "
          f"{sum(map(len, out['cuda'][0]))} tokens); wall cpu {out['cpu'][2]:.2f}s card "
          f"{out['cuda'][2]:.2f}s")
    if not same or out["cpu"][1] != out["cuda"][1]:
        _fail(f"serving the SMOKE {arch_id} differs between the CPU and the card")


def serve_phase(run, smi, dtype=None, params=None, depth_cut=1):
    """One of SERVE_RUNS (or QWEN_SERVE_RUN) at full width, and at full depth
    unless ``depth_cut`` divides it, random weights drawn on the card (or
    ``params``) in ``dtype`` (float32 by default; bf16 is what ``launch.serve
    --full`` serves in): the workload through ``ServeEngine``, SERVE_TIMED
    times with nothing wrapped, each with the
    kernel counts from 0: gen and total tokens/s, mean TTFT and TPOT, the
    engine's counters, peak memory and B10's launches (an encoder-decoder:
    n_enc_layers a request's admission and n_blocks cross calls a prefill
    chunk and a decode step; attention over the cache is plain torch, as
    the reference's), each run's and their median, least and most; every
    run must give the same tokens and counters. Then one run that is not
    timed, with B10's calls counted by mode and each step's top-2 logit
    gaps kept: the SERVE_VERIFIED shortest requests against
    ``sequential_reference`` token for token (a difference only at a
    near-tie: the top-2 logit gap in either run at the first differing
    position below FLIP_GAP in float32, below BF16_TIE times the top logit
    in bf16); in bf16, the encoder at an admission runs the float32 kernel
    (float32 frame embeddings, as the reference's engine) and the cross
    layers its bf16 mode; ``block_attn`` held against its plain version on
    the engine's own first call of each mode (the encoder at an admission,
    a prefill chunk's cross layer, a decode step's cross layer); the idle
    share of a profiled window of engine steps. Returns (B10's launches in
    the first timed run, the modes' entries, the runs' numbers)."""
    import statistics

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.block_attn import block_attn as ba
    from repro_torch.kernels.block_attn import ops as attn_ops
    from repro_torch.launch.serve import sequential_reference
    from repro_torch.serve import ServeEngine
    from repro_torch.serve import engine as serve_engine

    tag = f"[{smi}]"
    cfg = get_arch(run[0])
    note = ""
    if depth_cut > 1:
        note = (f" (depth cut {cfg.n_layers} -> {cfg.n_layers // depth_cut}"
                f"{f', encoder {cfg.n_enc_layers} -> {cfg.n_enc_layers // depth_cut}' if cfg.enc_dec else ''})")
        cfg = dataclasses.replace(cfg, n_layers=cfg.n_layers // depth_cut,
                                  n_enc_layers=cfg.n_enc_layers // depth_cut)
    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    if params is None:
        params, _ = _init_on_card(cfg, tag, note, dtype=dtype)
    reqs = _serve_workload(run, cfg)
    econf = _serve_config(run, dtype)
    eng = ServeEngine(cfg, params, econf)
    timed, streams = [], None
    for i in range(SERVE_TIMED):
        if i:
            eng.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ba.reset_launch_counts()
        t0 = time.perf_counter()
        results = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, bf16_launches = ba.LAUNCHES["block_attn"], ba.BF16_LAUNCHES["block_attn"]
        summary, counters = eng.metrics.summary(), _serve_counters(eng)
        cross = (cfg.n_blocks * (counters["prefill_chunks"] + counters["decode_steps"])
                 if cfg.enc_dec else 0)
        want = (cfg.n_enc_layers * len(reqs) if cfg.enc_dec else 0) + cross
        timed.append({"wall_s": wall, "gen_tok_s": summary["tok_s"],
                      "total_tok_s": summary["total_tok_s"],
                      "mean_ttft_ms": summary["mean_ttft_s"] * 1e3,
                      "p50_ttft_ms": summary["p50_ttft_s"] * 1e3,
                      "mean_tpot_ms": summary["mean_tpot_s"] * 1e3,
                      "peak_memory_allocated": torch.cuda.max_memory_allocated(),
                      "block_attn_launches": launches,
                      "block_attn_bf16_launches": bf16_launches})
        print(f"{cfg.name} serve {tag}: timed run {i + 1} of {SERVE_TIMED}: {len(reqs)} requests "
              f"(prompts {run[3] // 2}-{run[3]}, gen {max(run[4] // 4, 1)}-{run[4]}, Poisson "
              f"{run[6]} a step), {run[2]} slots, chunk {eng.chunk}, max_len {econf.max_len}: "
              f"{timed[-1]}; {counters} (block_attn launches want {want}, in bf16 "
              f"{cross if bf16 else 0})")
        got = [st.generated for st in results]
        if streams is None:
            streams, first_counters = got, counters
        _no_repacks(f"{cfg.name} serve")
        if (got != streams or counters != first_counters or launches != want
                or bf16_launches != (cross if bf16 else 0)
                or counters["requests_finished"] != len(reqs)):
            _fail(f"{cfg.name} serve: timed run {i + 1} finished {counters['requests_finished']} "
                  f"of {len(reqs)}, with {launches} block_attn launches (want {want}), its "
                  f"tokens and counters equal to run 1's: {got == streams}, "
                  f"{counters == first_counters}")
    spread = {key: {"median": statistics.median(r[key] for r in timed),
                    "min": min(r[key] for r in timed), "max": max(r[key] for r in timed)}
              for key in ("gen_tok_s", "total_tok_s", "mean_ttft_ms", "mean_tpot_ms", "wall_s")}
    print(f"{cfg.name} serve {tag}: over the {SERVE_TIMED} timed runs {spread}")

    first, calls, step_gaps, step_tops, emitted = {}, dict.fromkeys(
        ("encoder", "prefill_cross", "decode_cross"), 0), [], [], {}
    want_calls = ({"encoder": cfg.n_enc_layers * len(reqs),
                   "prefill_cross": cfg.n_blocks * first_counters["prefill_chunks"],
                   "decode_cross": cfg.n_blocks * first_counters["decode_steps"]}
                  if cfg.enc_dec else dict.fromkeys(calls, 0))
    real_attn, real_greedy = attn_ops.block_attention, serve_engine._greedy_tokens
    real_emit = ServeEngine._emit_token

    def attn_spy(q, k, v, **kw):
        mode = ("decode_cross" if q.shape[1] == 1 else "encoder" if q.shape[0] == 1
                else "prefill_cross")
        calls[mode] += 1
        first.setdefault(mode, (q, k, v, kw))
        return real_attn(q, k, v, **kw)

    def greedy_spy(logits):                 # each step's top-2 gaps, left on the card
        top = torch.topk(logits, 2, dim=-1).values
        step_gaps.append(top[:, 0] - top[:, 1])
        step_tops.append(top[:, 0].abs())
        return real_greedy(logits)

    def emit_spy(self, st, tok, finished, first=False):
        emitted.setdefault(st.request.rid, []).append((len(step_gaps) - 1, st.slot))
        return real_emit(self, st, tok, finished, first)

    eng.reset()
    attn_ops.block_attention, serve_engine._greedy_tokens = attn_spy, greedy_spy
    ServeEngine._emit_token = emit_spy
    try:
        results = eng.run(reqs)
    finally:
        attn_ops.block_attention, serve_engine._greedy_tokens = real_attn, real_greedy
        ServeEngine._emit_token = real_emit
    same = [st.generated for st in results] == streams
    print(f"{cfg.name} serve {tag}: the run that keeps gaps (not timed): block_attn calls "
          f"{calls} (want {want_calls}); tokens equal to the timed runs' {same}")
    if calls != want_calls or not same:
        _fail(f"{cfg.name} serve: block_attn calls {calls} (want {want_calls}), tokens equal "
              f"to the timed runs' {same}")
    stats = {"requests": len(reqs), "slots": run[2], "prompt_len": run[3], "gen": run[4],
             "chunk": eng.chunk, "arrival": run[6], "dtype": str(dtype).split(".")[-1],
             "timed_runs": timed, "spread": spread, **first_counters,
             "block_attn_calls": calls}

    gaps, tops = torch.stack(step_gaps).cpu(), torch.stack(step_tops).cpu()
    by_rid = {st.request.rid: st for st in results}
    shortest = sorted(reqs, key=lambda r: (len(r.prompt) + r.max_tokens, r.rid))
    with torch.inference_mode():
        for req in shortest[:SERVE_VERIFIED]:
            seq_gaps = []
            t0 = time.perf_counter()
            want = sequential_reference(cfg, eng.params, req, econf.max_len, "cuda", seq_gaps)
            got = by_rid[req.rid].generated
            eng_gaps = [float(gaps[step, slot]) for step, slot in emitted[req.rid]]
            eng_tops = [float(tops[step, slot]) for step, slot in emitted[req.rid]]
            diff = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
            limit = (BF16_TIE * eng_tops[diff] if bf16 and diff is not None else FLIP_GAP)
            tie = diff is not None and min(seq_gaps[diff], eng_gaps[diff]) < limit
            print(f"{cfg.name} serve verify {tag}: request {req.rid} (prompt {len(req.prompt)}, "
                  f"{req.max_tokens} tokens) against sequential_reference "
                  f"({time.perf_counter() - t0:.2f}s): "
                  + ("equal token for token" if diff is None and len(got) == len(want) else
                     f"first difference at {diff}: top-2 gaps {seq_gaps[diff]:.3e} "
                     f"(sequential), {eng_gaps[diff]:.3e} (engine), a near-tie below "
                     f"{limit:.3e}: {tie}")
                  + f"; smallest top-2 gap before it {min(seq_gaps[:diff] or [math.inf]):.3e}")
            if len(got) != len(want) or (diff is not None and not tie):
                _fail(f"{cfg.name} serve: request {req.rid} differs from the sequential "
                      f"decode away from a near-tie")

    modes = {}
    for mode in ("encoder", "prefill_cross", "decode_cross"):
        if mode in first:
            q, k, v, kw = first[mode]
            modes[f"serve_{mode}"] = _hold_attn_mode(f"serve {mode} (the engine's first call)",
                                                     q, k, v, kw["causal"], tag)
    first.clear()

    eng.reset()
    for req in reqs:
        eng.submit(req)
    eng.metrics.start()
    with torch.inference_mode():
        for _ in range(SERVE_WARM_STEPS):
            eng.step()
        torch.cuda.synchronize()

        def window():
            for _ in range(SERVE_PROFILED_STEPS):
                eng.step()

        before = eng.metrics.prefill_chunks, eng.metrics.decode_steps
        stats["idle_share"] = _profile(
            f"{cfg.name} serve engine steps {SERVE_WARM_STEPS}-"
            f"{SERVE_WARM_STEPS + SERVE_PROFILED_STEPS - 1} {tag}", window)
    stats["profiled"] = {"prefill_chunks": eng.metrics.prefill_chunks - before[0],
                         "decode_steps": eng.metrics.decode_steps - before[1]}
    print(f"{cfg.name} serve {tag}: the profiled window ran {stats['profiled']}")
    del eng, params
    return timed[0]["block_attn_bf16_launches" if bf16 else "block_attn_launches"], modes, stats


def _tree_float(tree):
    """The tree with every leaf in float32 (a bf16 model's weights, exactly)."""
    if isinstance(tree, dict):
        return {k: _tree_float(v) for k, v in tree.items()}
    return tree.float()


def _rel_rms(got, want):
    """rms(got - want) / rms(want), in float64 sums."""
    d = (got.double() - want.double()).square().mean().sqrt()
    return float(d / want.double().square().mean().sqrt())


def _hold_bf16_forward(cfg, params, batch, tag):
    """The bf16 forward against the float32 forward at the same weights (the
    bf16 ones, exact in float32): the logits within the model's BF16_RMS_TOL
    of rms(want)
    and the loss within BF16_LOSS_RTOL; prints max|d| and the share of
    positions whose argmax agrees."""
    import torch

    from repro_torch.models import transformer as T

    params32 = _tree_float(params)
    with torch.inference_mode():
        got, _ = T.forward_train(cfg, params, batch["tokens"], batch.get("embeds"))
        loss = float(T.loss_fn(cfg, params, batch))
        want, _ = T.forward_train(cfg, params32, batch["tokens"], batch.get("embeds"))
        want_loss = float(T.loss_fn(cfg, params32, batch))
    del params32
    rel, tol = _rel_rms(got, want), BF16_RMS_TOL[cfg.name]
    max_abs = float((got.float() - want).abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    loss_rel = abs(loss - want_loss) / abs(want_loss)
    print(f"{cfg.name} bf16 forward {tag}: logits{tuple(got.shape)} {got.dtype} against the "
          f"float32 forward at the same weights: rms(d)/rms(want)={rel:.4e} (tol "
          f"{tol:.4e}) max|d|={max_abs:.4e} max|want|={float(want.abs().max()):.4e} "
          f"argmax agrees at {agree:.4f} of positions; loss bf16 {loss:.6f} float32 "
          f"{want_loss:.6f} rel {loss_rel:.3e} (tol {BF16_LOSS_RTOL})")
    del got, want
    if not (rel <= tol and loss_rel <= BF16_LOSS_RTOL and math.isfinite(loss)):
        _fail(f"{cfg.name}: the bf16 forward strays from the float32 one (rms {rel:.4e}, "
              f"loss rel {loss_rel:.3e})")


def _bf16_forward_run(cfg, params, batch, forwards, km, tag):
    """:func:`_forward_phase` on a bf16 model, whose kernel launches must all
    be its bf16 mode. Returns the launches."""
    from repro_torch.kernels.block_attn import block_attn as ba

    ba.reset_launch_counts()
    launches = _forward_phase(cfg, params, batch, forwards, km, tag)
    _no_repacks(cfg.name)
    (name,) = km.LAUNCHES
    if km.BF16_LAUNCHES[name] != km.LAUNCHES[name]:     # the profiled forward's too
        _fail(f"{cfg.name}: {km.BF16_LAUNCHES[name]} of {km.LAUNCHES[name]} {name} launches "
              f"in bf16")
    return launches


def _no_repacks(label):
    """Fails if a model path copied a bf16 attention operand for TMA
    (``BF16_REPACKS``): every model's q, k and v go to the kernel as they
    are."""
    from repro_torch.kernels.block_attn import block_attn as ba

    if ba.BF16_REPACKS["block_attn"]:
        _fail(f"{label}: {ba.BF16_REPACKS['block_attn']} bf16 operands repacked for TMA on a "
              f"model path")


def bf16_mamba_phase(smi):
    """(k1) ``ssd_scan``'s bf16 mode at ``mamba2-130m``'s full width (bf16
    weights drawn on the card): the kernel on layer 0's own bf16 inputs
    against its plain bf16 version (within 1 bf16 ulp, :func:`_bf16_ulps`),
    timed beside the plain version and the float32 kernel on the same
    values, with its bound (the bytes of bf16 x, B, C and y and float32 dt;
    the function's FLOP at the card's bf16 peak; the design's rate, one bf16
    product a C B^T term and two for the others, printed beside it), and its
    stage kernels' registers and spills; the SSD_SMALL shapes in
    bf16; ``loss_fn`` on LM_BATCH x LM_SEQ tokens in bf16 (24 calls a
    forward, all in bf16), held against the float32 forward at the same
    weights. Returns (the kernels line's ``ssd_scan (bf16)`` entry)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_plain
    from repro_torch.models import transformer as T

    tag = f"[{smi}]"
    cfg = get_arch("mamba2-130m")
    params, _ = _init_on_card(cfg, tag, dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_SEQ + 1),
                           generator=torch.Generator().manual_seed(1)).cuda()
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    with torch.inference_mode():
        (x, dt, a_log, b, c), kw, calls = _first_call(
            ssd_ops, "ssd_chunked", lambda: T.loss_fn(cfg, params, batch))
    if calls != cfg.n_layers or x.dtype != torch.bfloat16 or dt.dtype != torch.float32:
        _fail(f"the bf16 forward called ssd_chunked {calls} times (want {cfg.n_layers}) "
              f"with x {x.dtype}, dt {dt.dtype}")
    chunk = kw["chunk"]
    bsz, h, l, p = x.shape
    g, n = b.shape[1], b.shape[3]
    with torch.inference_mode():
        got = sk.ssd_scan(x, dt, a_log, b, c, chunk=chunk)
        want, _ = ssd_chunked_plain(x, dt, a_log, b, c, chunk)
        torch.cuda.synchronize()
        ulps = _bf16_ulps(got, want, float(want.float().abs().max()))
        max_abs = float((got.float() - want.float()).abs().max())
        ms = statistics.median(_time_ms(lambda: sk.ssd_scan(x, dt, a_log, b, c, chunk=chunk),
                                        iters=10) for _ in range(5))
        xf, bf, cf = x.float(), b.float(), c.float()
        f32_ms = statistics.median(_time_ms(lambda: sk.ssd_scan(xf, dt, a_log, bf, cf,
                                                                chunk=chunk), iters=10)
                                   for _ in range(5))
        del xf, bf, cf
        plain_ms = statistics.median(_time_ms(lambda: ssd_chunked_plain(x, dt, a_log, b, c, chunk),
                                              iters=3, warmup=1) for _ in range(3))

        def five_calls():
            for _ in range(5):
                sk.ssd_scan(x, dt, a_log, b, c, chunk=chunk)

        stage_ms = _kernel_device_ms(five_calls, [f"{s_}_bf16_kernel" for s_ in sk.STAGES])
    report = sk.stage_report(bsz, h, g, l, p, n, chunk, bf16=True)
    print(f"ssd_scan bf16 {tag}: stage kernels (dynamic shared memory bytes, blocks, threads) "
          f"{ {k: tuple(v.values()) for k, v in report.items() if k in sk.STAGES} }")
    lens = [min(chunk, l - k_) for k_ in range(0, l, chunk)]
    flop_cb = bsz * g * sum(c_ * (c_ + 1) * n for c_ in lens)
    flop_rest = bsz * h * sum(c_ * (c_ + 1) * p + 4 * c_ * n * p for c_ in lens)
    nbytes = 2 * (2 * bsz * h * l * p + 2 * bsz * g * l * n) + 4 * (bsz * h * l + h)
    ops_ms = (flop_cb + flop_rest) / BF16_OPS_PER_S * 1e3
    design_ms = (flop_cb + 2 * flop_rest) / BF16_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    print(f"ssd_scan bf16 {tag}: layer 0 x{tuple(x.shape)} {x.dtype} strides {x.stride()} "
          f"B/C{tuple(b.shape)} chunk={chunk}: vs plain max|d|={max_abs:.3e} ulps={ulps:.3f} "
          f"(at most 1); ms={ms:.4f} float32 kernel on the same values ms={f32_ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} (operations: {flop_cb} C.B^T + "
          f"{flop_rest} FLOP at the bf16 peak {BF16_OPS_PER_S:.4g}/s = {ops_ms:.4f} ms; for "
          f"information, the design's one bf16 product a C.B^T FLOP and two for the others = "
          f"{design_ms:.4f} ms; bytes {nbytes} = {bytes_ms:.4f} ms) = "
          f"{bound_ms / ms:.3f} of it; stage device ms {stage_ms}")
    _print_registers("ssd_scan bf16", sk.BUILD_INFO, tag, "bf16")
    if not (ulps <= 1.0 and torch.isfinite(got.float()).all()):
        _fail(f"ssd_scan's bf16 mode disagrees with its plain version ({ulps:.3f} ulps)")
    del x, dt, b, c, got, want
    gen = torch.Generator("cuda").manual_seed(6)
    for b_, h_, l_, p_, n_, chunk_, g_ in SSD_SMALL:
        xs = (torch.randn(b_, h_, l_, p_, generator=gen, device="cuda") * 0.8).bfloat16()
        dts = torch.nn.functional.softplus(torch.randn(b_, h_, l_, generator=gen, device="cuda"))
        als = torch.log(torch.linspace(1.0, 16.0, h_, device="cuda"))
        bs, cs = ((torch.randn(b_, g_, l_, n_, generator=gen, device="cuda") * 0.5).bfloat16()
                  for _ in range(2))
        sk.reset_launch_counts()
        with torch.inference_mode():
            ys = sk.ssd_scan(xs, dts, als, bs, cs, chunk=chunk_)
            ref, _ = ssd_chunked_plain(xs, dts, als, bs, cs, chunk_)
        torch.cuda.synchronize()
        u = _bf16_ulps(ys, ref, float(ref.float().abs().max()))
        print(f"ssd_scan bf16 {tag}: B={b_} H={h_} L={l_} P={p_} N={n_} chunk={chunk_} G={g_}: "
              f"max|d|={float((ys.float() - ref.float()).abs().max()):.3e} ulps={u:.3f} "
              f"bf16 launches {sk.BF16_LAUNCHES['ssd_scan']}")
        if not (u <= 1.0 and sk.BF16_LAUNCHES["ssd_scan"] == 1):
            _fail(f"ssd_scan's bf16 mode disagrees with its plain version at B={b_} H={h_} "
                  f"L={l_} P={p_} N={n_} chunk={chunk_} G={g_} ({u:.3f} ulps)")
    del xs, dts, bs, cs, ys, ref
    entry = {"name": "ssd_scan (bf16)", "route": "cuda", "source": SSD_SOURCE,
             "replaces": SSD_REPLACES, "launches": None, "max_abs_err": max_abs,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": None,
             "float32_ms": f32_ms}
    launches = _bf16_forward_run(cfg, params, batch, LM_FORWARDS, sk, tag)
    _hold_bf16_forward(cfg, params, batch, tag)
    return entry, launches


def _attn_cases_bf16(tag):
    """``block_attn``'s bf16 mode at the ATTN_SMALL shapes, an odd head dim
    and a K view one element off 16-byte alignment (the operands TMA cannot
    read, copied first: three and one BF16_REPACKS), each within 1 bf16 ulp
    of its plain version."""
    import torch

    from repro_torch.kernels.block_attn import block_attn as ba
    from repro_torch.kernels.block_attn.ref import block_attention_plain

    gen = torch.Generator("cuda").manual_seed(4)
    cases = [(*case, False) for case in ATTN_SMALL] + [(1, 300, 300, 4, 2, 17, True, 0, False),
                                                      (1, 500, 500, 8, 2, 128, True, 0, True)]
    for b_, lq, lk, h_, kv_, hd_, causal, window, shifted in cases:
        qs, vs = (torch.randn(b_, n, heads, hd_, generator=gen, device="cuda").bfloat16()
                  for n, heads in ((lq, h_), (lk, kv_)))
        ks = torch.randn(b_ * lk * kv_ * hd_ + 1, generator=gen, device="cuda").bfloat16()
        ks = ks[1:] if shifted else ks[:-1]
        ks = ks.view(b_, lk, kv_, hd_)
        ba.reset_launch_counts()
        with torch.inference_mode():
            o = ba.block_attn(qs, ks, vs, causal=causal, window=window)
            ref = block_attention_plain(qs, ks, vs, causal=causal, window=window)
        torch.cuda.synchronize()
        u = _bf16_ulps(o, ref, float(vs.float().abs().max()))
        repacks = 3 if hd_ % 8 else int(shifted)
        print(f"block_attn bf16 {tag}: B={b_} Lq={lq} Lk={lk} H={h_} KV={kv_} hd={hd_} "
              f"causal={causal} window={window}{' K one element off 16 bytes' if shifted else ''}"
              f": max|d|={float((o.float() - ref.float()).abs().max()):.3e} ulps={u:.3f} "
              f"bf16 launches {ba.BF16_LAUNCHES['block_attn']} repacks "
              f"{ba.BF16_REPACKS['block_attn']} (want {repacks})")
        if not (u <= 1.0 and torch.isfinite(o.float()).all()
                and ba.BF16_LAUNCHES["block_attn"] == 1
                and ba.BF16_REPACKS["block_attn"] == repacks):
            _fail(f"block_attn's bf16 mode disagrees with its plain version at B={b_} Lq={lq} "
                  f"Lk={lk} H={h_} KV={kv_} hd={hd_} causal={causal} window={window} "
                  f"({u:.3f} ulps)")


def _layer0_attention(cfg, params, batch):
    """(q, k, v) of the first ``block_attention`` call of one ``loss_fn``."""
    import torch

    from repro_torch.kernels.block_attn import ops as attn_ops
    from repro_torch.models import transformer as T

    with torch.inference_mode():
        (q, k, v), kw, calls = _first_call(attn_ops, "block_attention",
                                           lambda: T.loss_fn(cfg, params, batch))
    if calls != _kernel_calls(cfg)["block_attn"] or q.dtype != torch.bfloat16:
        _fail(f"{cfg.name}: the bf16 forward called block_attention {calls} times (want "
              f"{_kernel_calls(cfg)['block_attn']}) with {q.dtype}")
    return q, k, v, kw


def bf16_dense_phase(smi):
    """(k2) ``block_attn``'s bf16 mode at ``yi-6b``'s full width (bf16
    weights drawn on the card): layer 0's own bf16 q/k/v (B 2, L 4,096, 32/4
    heads, hd 128) against the plain bf16 version, timed beside the float32
    kernel on the same values, bf16 ``scaled_dot_product_attention`` (the
    library yardstick) and the plain version (:func:`_hold_attn_mode`); the
    small shapes (:func:`_attn_cases_bf16`); ``loss_fn`` on YI_BATCH x
    YI_SEQ tokens in bf16 (32 bf16 launches a forward), held against the
    float32 forward at the same weights. Returns (the kernels line's
    ``block_attn (bf16)`` entry, the forward's launches)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.block_attn import block_attn as ba

    tag = f"[{smi}]"
    cfg = get_arch("yi-6b")
    params, _ = _init_on_card(cfg, tag, dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab, (YI_BATCH, YI_SEQ + 1),
                           generator=torch.Generator().manual_seed(1)).cuda()
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    q, k, v, _ = _layer0_attention(cfg, params, batch)
    mode = _hold_attn_mode("yi-6b layer 0 (bf16)", q, k, v, True, tag)
    del q, k, v
    _attn_cases_bf16(tag)
    _print_registers("block_attn bf16", ba.BF16_BUILD_INFO, tag)
    print(f"block_attn bf16 {tag}: dynamic shared memory "
          f"{ba.build_bf16().block_attn_bf16_smem_bytes(128)} bytes a block at hd 128 (float32: "
          f"{ba.build().block_attn_smem_bytes(128)})")
    entry = {"name": "block_attn (bf16)", "route": "cuda", "source": ATTN_SOURCE,
             "replaces": ATTN_REPLACES, "launches": None,
             **{key: mode[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms", "float32_ms")},
             "modes": {"yi-6b layer 0": mode}}
    launches = _bf16_forward_run(cfg, params, batch, YI_FORWARDS, ba, tag)
    _hold_bf16_forward(cfg, params, batch, tag)
    return entry, launches


def bf16_seamless_phase(smi):
    """(k3) ``seamless-m4t-large-v2`` at full width and depth in bf16: B10's
    bf16 mode on layer 0's own encoder, decoder and cross calls
    (:func:`_hold_attn_mode`); ``loss_fn`` on SEAMLESS_BATCH x SEAMLESS_TEXT
    tokens over as many rows of float32 stub frames (cast to bf16 before the
    encoder, as the reference's forward does; 72 bf16 launches a forward),
    held against the float32 forward at the same weights. Returns (the
    modes' entries, the forward's launches)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.block_attn import block_attn as ba
    from repro_torch.kernels.block_attn import ops as attn_ops
    from repro_torch.models import transformer as T

    tag = f"[{smi}]"
    cfg = get_arch("seamless-m4t-large-v2")
    params, _ = _init_on_card(cfg, tag, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (SEAMLESS_BATCH, SEAMLESS_TEXT + 1), generator=gen)
    embeds = torch.randn(SEAMLESS_BATCH, cfg.frontend_tokens, cfg.d_model, generator=gen).cuda()
    batch = {"tokens": tokens[:, :-1].cuda(), "labels": tokens[:, 1:].cuda(), "embeds": embeds}
    n_enc = cfg.n_enc_layers
    with torch.inference_mode():
        kept, calls = _kept_calls(attn_ops, "block_attention",
                                  lambda: T.loss_fn(cfg, params, batch),
                                  keep=(0, n_enc, n_enc + 1))
    if calls != _kernel_calls(cfg)["block_attn"]:
        _fail(f"{cfg.name}: the bf16 forward called block_attention {calls} times")
    modes = {f"bf16 {name}": _hold_attn_mode(f"{name} layer 0 (bf16)", *kept[i][0],
                                             kept[i][1]["causal"], tag)
             for name, i in (("encoder", 0), ("decoder", n_enc), ("cross", n_enc + 1))}
    del kept
    launches = _bf16_forward_run(cfg, params, batch, SEAMLESS_FORWARDS, ba, tag)
    _hold_bf16_forward(cfg, params, batch, tag)
    return modes, launches


def qwen_phase(smi):
    """(k5) ``qwen2.5-32b`` at full width and depth (64 layers, 40/8 heads, hd
    128, 32,763,876,352 parameters, 65.53 GB in bf16; float32 would not fit
    one card), bf16 weights drawn on the card: B10's bf16 mode on layer 0's
    own q/k/v; ``loss_fn`` on QWEN_BATCH x QWEN_SEQ tokens (64 bf16 launches
    a forward), peak memory; greedy decode of QWEN_DECODE_BATCH prompts of
    QWEN_PROMPT tokens and QWEN_GENERATE more, held against the kernel
    forward over the same sequence within QWEN_DECODE_RMS_TOL; then serving
    (QWEN_SERVE_RUN, :func:`serve_phase` in bf16). Returns (layer 0's mode
    entry, the forward's launches, the serve numbers)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.block_attn import block_attn as ba
    from repro_torch.models import transformer as T

    tag = f"[{smi}]"
    cfg = get_arch("qwen2.5-32b")
    print(f"{cfg.name} {tag}: before init memory_allocated={torch.cuda.memory_allocated()} bytes")
    torch.cuda.reset_peak_memory_stats()
    params, _ = _init_on_card(cfg, tag, dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab, (QWEN_BATCH, QWEN_SEQ + 1),
                           generator=torch.Generator().manual_seed(1)).cuda()
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    q, k, v, _ = _layer0_attention(cfg, params, batch)
    mode = _hold_attn_mode("qwen2.5-32b layer 0 (bf16)", q, k, v, True, tag)
    del q, k, v
    launches = _bf16_forward_run(cfg, params, batch, QWEN_FORWARDS, ba, tag)

    prompts = tokens[0, :QWEN_DECODE_BATCH * QWEN_PROMPT].reshape(QWEN_DECODE_BATCH, QWEN_PROMPT)
    seq, step_ms, logits = [prompts], [], []
    with torch.inference_mode():
        cache = T.init_cache(cfg, QWEN_DECODE_BATCH, QWEN_PROMPT + QWEN_GENERATE, torch.bfloat16)
        nxt = None
        for t in range(QWEN_PROMPT + QWEN_GENERATE):
            tok = prompts[:, t:t + 1] if t < QWEN_PROMPT else nxt
            if t >= QWEN_PROMPT:
                seq.append(tok)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = T.decode_step(cfg, params, cache, tok)
            nxt = lg[:, -1].float().argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            logits.append(lg[:, 0])
        del cache
        fwd, _ = T.forward_train(cfg, params, torch.cat(seq, dim=1))
    dec = torch.stack(logits, dim=1)
    rel = _rel_rms(dec, fwd)
    agree = float((dec.argmax(-1) == fwd.argmax(-1)).float().mean())
    weight_ms = sum(t.numel() * t.element_size() for t in _leaves(params)) / HBM_BYTES_PER_S * 1e3
    print(f"{cfg.name} decode {tag}: {QWEN_DECODE_BATCH} prompts x {QWEN_PROMPT} tokens + "
          f"{QWEN_GENERATE} greedy, bf16: ms/step median={statistics.median(step_ms[2:]):.3f} "
          f"(bf16 weight-read bound {weight_ms:.3f} ms); decode vs kernel forward "
          f"rms(d)/rms(want)={rel:.4e} (tol {QWEN_DECODE_RMS_TOL:.4e}) "
          f"max|d|={float((dec.float() - fwd.float()).abs().max()):.4e} argmax agrees at "
          f"{agree:.4f}; peak_memory_allocated since init {torch.cuda.max_memory_allocated()} "
          f"bytes")
    if not (rel <= QWEN_DECODE_RMS_TOL and torch.isfinite(dec.float()).all()):
        _fail(f"{cfg.name}: bf16 decode strays from the kernel forward (rms {rel:.4e})")
    del dec, fwd, logits
    gc.collect()
    torch.cuda.empty_cache()
    _, _, serving = serve_phase(QWEN_SERVE_RUN, smi, torch.bfloat16, params)
    return mode, launches, serving


def obs_phase(tag, fleet_stream):
    """(d) The telemetry path on the card: ``launch.train protocol --obs P
    --trace`` beside the same run without ``--obs`` (same final line), the
    stream read back with the port's ``ObsStream`` and rendered with its
    ``render_report``; then the traced ``fleet_metro`` stream of
    :func:`sim_phases` rendered with ``render_critical`` and
    ``render_report`` (the critical-path section and the straggler league)."""
    import torch

    from repro_torch.kernels.quantize import quantize as qk
    from repro_torch.launch.train import main as launch_main
    from repro_torch.obs import ObsStream, critical_paths, render_critical, render_report

    argv = ["protocol", "--algo", "dfedrw", "--rounds", "2", "--bits", "8"]
    finals = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train_obs.jsonl")
        for extra in ([], ["--obs", path, "--trace"]):
            buf = io.StringIO()
            qk.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                launch_main(argv + extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            finals.append([line for line in buf.getvalue().splitlines()
                           if line.startswith("final:")])
            print(f"obs {tag}: launch.train {' '.join(argv + extra[:1] + extra[2:])}: "
                  f"{wall:.2f}s {finals[-1]} launches={dict(qk.LAUNCHES)}")
            if min(qk.LAUNCHES["qdq_delta_rows_rng"], qk.LAUNCHES["qdq_rows_rng"]) <= 0:
                _fail("the launcher did not go through both qdq kernels")
        stream = ObsStream.load(path)
    report = render_report(stream)
    for line in report.splitlines():
        print(f"obs {tag}: report | {line}")
    header = stream.header
    if (not finals[0] or finals[0] != finals[1] or header.get("trace") is not True
            or header["provenance"]["backend"] != "cuda"
            or "communication by wire width" not in report
            or "engine/execute_round" not in report):
        _fail(f"the --obs --trace run: final lines {finals}, header {header}")

    crit = render_critical(fleet_stream)
    for line in crit:
        print(f"obs {tag}: fleet_metro critical | {line}")
    full = render_report(fleet_stream)
    if (len(critical_paths(fleet_stream)) != 2 or not crit
            or not crit[0].startswith("critical path")
            or not any(line.startswith("straggler league") for line in crit)
            or "\n".join(crit) not in full):
        _fail("the traced fleet_metro stream lacks its critical-path section or "
              "straggler league")
    print(f"obs {tag}: fleet_metro report {len(full.splitlines())} lines, critical path of "
          f"{len(critical_paths(fleet_stream))} windows")



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


def _capture_first(captured, name, real):
    """``real`` wrapped so that the arguments of its first call are kept
    (tensors cloned) under ``captured[name]``."""
    import torch

    def call(*args, **kw):
        if name not in captured:
            captured[name] = ([a.clone() if torch.is_tensor(a) else a for a in args], kw)
        return real(*args, **kw)
    return call


def _hold_kernel(name, args, bits, label):
    """One counter-RNG qdq kernel on a payload captured from a path, with the
    path's own side information and seed words: against its plain version
    (0 differing elements for ``qdq_rows_rng``, <= 1 ulp for
    ``qdq_delta_rows_rng``), timed beside its plain version and its bound.
    These launches are not the path's. Prints one line and returns the
    numbers; a disagreement exits non-zero."""
    import torch

    from repro_torch.kernels.quantize import quantize as qk

    kern, plain = getattr(qk, name), getattr(qk, name + "_plain")
    w2d, rest = args[0], args[1:]
    rows = w2d.shape[0]
    got = kern(w2d.clone(), *rest, bits=bits)
    want = plain(w2d, *rest, bits=bits)
    torch.cuda.synchronize()
    differs, max_ulps = _differs(got, want)
    finite = bool(torch.isfinite(got).all())
    del got, want
    limit = 1 if name == "qdq_delta_rows_rng" else 0
    nbytes = rows * LANES_BYTES * (3 if name == "qdq_delta_rows_rng" else 2) + rows * 8
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = rows * 128 * OPS_PER_ELEMENT / FP32_OPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    scratch = w2d.clone()
    ms = statistics.median(_time_ms(lambda: kern(scratch, *rest, bits=bits), iters=20)
                           for _ in range(3))
    del scratch
    plain_ms = _time_ms(lambda: plain(w2d, *rest, bits=bits), iters=2, warmup=1)
    print(f"kernel {name} at {label}: R={rows} ({rows * LANES_BYTES} payload bytes) "
          f"bits={bits}: differs={differs} max_ulps={max_ulps} us={ms * 1e3:.2f} "
          f"plain_ms={plain_ms:.4f} bound_us={bound_ms * 1e3:.2f} (bytes {nbytes}, "
          f"{bound_bytes_ms * 1e3:.2f} us; ops {bound_ops_ms * 1e3:.2f} us) = "
          f"{bound_ms / ms:.3f} of the bound")
    if max_ulps > limit or not finite:
        _fail(f"{name} disagrees with its plain version at {label} (max {max_ulps} ulps, "
              f"allowed {limit}), or gave a non-finite value")
    return {"rows": rows, "ms": ms, "bound_ms": bound_ms, "plain_ms": plain_ms}


def baselines_phase(model, data, topo, xt, yt, tag):
    """The paper's baselines (§VI-B) at the main path's setting: the 3FNN,
    100 devices on a complete graph, the 60,000-sample data. First each
    algorithm on a small configuration on the CPU and on the card from the
    same weights and seed words (fp32: rtol 1e-4; bits=8: within 0.05 *
    scale + 1e-4); then each at full size, bits 32 and 8, one warm-up
    round and BASELINE_ROUNDS timed ones with the counts from 0: one
    ``qdq_rows_rng`` launch a quantized decentralized round, none for
    FedAvg, which sends unquantized models; two DFedAvg rounds at each
    width under the profiler. QDFedAvg's first aggregation
    payload (R = 500 messages x 1,559 rows) then holds the kernel against
    its plain version. Returns the quantized rounds' launches by kernel."""
    import numpy as np
    import torch

    from repro_torch.core import BaselineConfig, QuantConfig, make_topology
    from repro_torch.core import baselines as bl
    from repro_torch.core.heterogeneity import partition_similarity
    from repro_torch.data import FederatedDataset, synthetic_image_classification
    from repro_torch.kernels.quantize import ops
    from repro_torch.kernels.quantize import quantize as qk
    from repro_torch.models import make_fnn

    xs, ys = synthetic_image_classification(n_samples=2000, seed=0, noise=1.0)
    small = FederatedDataset.from_partition(
        xs, ys, partition_similarity(ys, 10, 50, np.random.default_rng(0)))
    small_model = make_fnn((64,))
    params = small_model.init(torch.Generator().manual_seed(3), "cpu")
    for label, cls_name, fields in BASELINES:
        small_fields = {**fields, "n_selected": min(fields["n_selected"], 10),
                        "local_epochs": 3, "n_agg": 3}
        for bits in (32, 8):
            cfg = BaselineConfig(batch_size=32, quant=QuantConfig(bits=bits), **small_fields)
            pair = [getattr(bl, cls_name)(small_model, small, make_topology("complete", 10),
                                          cfg, device=d) for d in ("cpu", "cuda")]
            states = [r.state_from_params(params) for r in pair]
            seeds = torch.Generator().manual_seed(11)
            worst = 0.0
            for _ in range(3):
                qseed = torch.randint(0, 1 << 32, (2,), generator=seeds)
                for i, r in enumerate(pair):
                    states[i], _ = r.run_round(states[i], None, qseed=qseed)
                a, b = states[0].device_params, states[1].device_params.cpu()
                diff = float((a - b).abs().max())
                worst = max(worst, diff)
                ok = (torch.allclose(b, a, rtol=1e-4, atol=1e-5) if bits == 32
                      else diff < 0.05 * float(a.abs().max()) + 1e-4)
                if not ok or not torch.isfinite(b).all():
                    _fail(f"{label} bits={bits}: the CPU and the card disagree, "
                          f"max|d|={diff:.3e}")
            print(f"baselines {tag}: small cpu-vs-card {label} bits={bits}: "
                  f"max|d matrix|={worst:.3e}")

    captured, counts = {}, dict.fromkeys(qk.LAUNCHES, 0)
    for label, cls_name, fields in BASELINES:
        for bits in (32, 8):
            cfg = BaselineConfig(batch_size=50, quant=QuantConfig(bits=bits), **fields)
            runner = getattr(bl, cls_name)(model, data, topo, cfg)
            key = torch.Generator().manual_seed(0)
            state = runner.init_state(key)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            real = ops.qdq_rows_rng
            if bits < 32 and label == "dfedavg":
                ops.qdq_rows_rng = _capture_first(captured, "qdq_rows_rng", real)
                payload_rows = cfg.n_selected * cfg.n_agg * runner.flat_spec.rows
            qk.reset_launch_counts()
            stamps, losses = [], []
            try:
                for _ in range(1 + BASELINE_ROUNDS):
                    t0 = time.perf_counter()
                    state, met = runner.run_round(state, key)
                    torch.cuda.synchronize()
                    stamps.append((time.perf_counter() - t0) * 1e3)
                    losses.append(met.train_loss)
            finally:
                ops.qdq_rows_rng = real
            got = dict(qk.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            evald = runner.evaluate(state, xt, yt)
            want = dict.fromkeys(qk.LAUNCHES, 0)
            if bits < 32 and label != "fedavg":
                want["qdq_rows_rng"] = 1 + BASELINE_ROUNDS
            print(f"baselines {tag}: {label} bits={bits} {fields}: ms/round (run_round) "
                  f"median={statistics.median(stamps[1:]):.3f} "
                  f"all={[round(t, 3) for t in stamps[1:]]} (warm-up {stamps[0]:.3f}) "
                  f"loss={[round(x, 5) for x in losses]} test_acc={evald['accuracy']:.4f} "
                  f"peak_memory_allocated={peak} bytes launches={got}")
            finite = all(math.isfinite(x) for x in losses + [evald["loss"]])
            if got != want or not finite:
                _fail(f"baselines {label} bits={bits}: launches {got} (want {want}), "
                      f"finite={finite}")
            for name, n in got.items():
                counts[name] += n
            if label == "dfedavg":

                def two_rounds():
                    nonlocal state
                    for _ in range(2):
                        state, _ = runner.run_round(state, key)

                _profile(f"{label} bits={bits} (2 rounds) {tag}", two_rounds)
            del runner, state

    args, kw = captured["qdq_rows_rng"]
    if args[0].shape[0] != payload_rows:
        _fail(f"the QDFedAvg payload has {args[0].shape[0]} rows, want {payload_rows}")
    _hold_kernel("qdq_rows_rng", args, kw["bits"], "QDFedAvg's aggregation payload")
    del captured
    return counts


def lstm_phase(tag):
    """The paper's language-model experiment (§VI-F) in chain mode at the
    published width: ``LSTM(vocab=50_000)`` (embedding 128, 2 layers of
    hidden 256, d = 20,169,552) on ``synthetic_token_stream`` at
    ``benchmarks/fig13_language_model.py``'s shape with the full vocabulary,
    64 devices on a complete graph, M = 10 chains, K = 3, B = 32, lr_r 0.5;
    bits 8 and 32, one warm-up round and LSTM_ROUNDS timed ones with the
    counts from 0: K ``qdq_delta_rows_rng`` launches and one
    ``qdq_rows_rng`` launch a quantized round. One quantized round is
    profiled. The first hop and aggregation payloads of the quantized run
    then hold both kernels against their plain versions at these shapes.
    Last, the checkpoint phase: the trained params saved from the card and
    loaded into a template on the card, bit for bit. Returns the quantized
    run's launches by kernel."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs.lstm_reddit import LSTM
    from repro_torch.core import DFedRW, DFedRWConfig, QuantConfig, make_topology
    from repro_torch.core.flatten import tree_leaves, unflatten_tree
    from repro_torch.core.heterogeneity import Partition
    from repro_torch.data import FederatedDataset, synthetic_token_stream
    from repro_torch.kernels.quantize import ops
    from repro_torch.kernels.quantize import quantize as qk

    n = 64
    toks, nxt, client = synthetic_token_stream(n_clients=n, seq_len=12, seqs_per_client=48,
                                               vocab=LSTM_VOCAB, client_vocab=60, seed=0)
    idxs = [np.nonzero(client == c)[0] for c in range(n)]
    data = FederatedDataset.from_partition(toks, nxt[:, -1], Partition(idxs, n))
    topo = make_topology("complete", n)
    model = LSTM(vocab=LSTM_VOCAB)
    xt, yt = toks[:768], nxt[:768, -1]
    captured, counts, params = {}, None, None
    for bits in (8, 32):
        cfg = DFedRWConfig(m_chains=10, k_walk=3, batch_size=32, chain_mode=True, lr_r=0.5,
                           quant=QuantConfig(bits=bits))
        runner = DFedRW(model, data, topo, cfg)
        spec = runner.flat_spec
        key = torch.Generator().manual_seed(0)
        state = runner.init_state(key)
        torch.cuda.synchronize()
        print(f"lstm chain mode {tag}: {model.name} vocab={LSTM_VOCAB} d={spec.d} "
              f"d_pad={spec.d_pad} rows={spec.rows} leaves={spec.shapes} devices={n} "
              f"device matrix {state.device_params.numel() * 4} bytes; M={cfg.m_chains} "
              f"K={cfg.k_walk} B={cfg.batch_size} bits={bits}")
        torch.cuda.reset_peak_memory_stats()
        real = (ops.qdq_delta_rows_rng, ops.qdq_rows_rng)
        if bits < 32:
            ops.qdq_delta_rows_rng = _capture_first(captured, "qdq_delta_rows_rng", real[0])
            ops.qdq_rows_rng = _capture_first(captured, "qdq_rows_rng", real[1])
        qk.reset_launch_counts()
        stamps, losses, starts = [], [], [state.chain_starts.tolist()]
        try:
            for _ in range(1 + LSTM_ROUNDS):
                t0 = time.perf_counter()
                state, met = runner.run_round(state, key)
                torch.cuda.synchronize()
                stamps.append((time.perf_counter() - t0) * 1e3)
                losses.append(met.train_loss)
                starts.append(state.chain_starts.tolist())
        finally:
            ops.qdq_delta_rows_rng, ops.qdq_rows_rng = real
        got = dict(qk.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        evald = runner.evaluate(state, xt, yt)
        want = dict.fromkeys(qk.LAUNCHES, 0)
        if bits < 32:
            want.update(qdq_delta_rows_rng=cfg.k_walk * (1 + LSTM_ROUNDS),
                        qdq_rows_rng=1 + LSTM_ROUNDS)
        print(f"lstm chain mode {tag} bits={bits}: ms/round (run_round) "
              f"median={statistics.median(stamps[1:]):.3f} "
              f"all={[round(t, 3) for t in stamps[1:]]} (warm-up {stamps[0]:.3f}) "
              f"loss={[round(x, 5) for x in losses]} test_top1={evald['accuracy']:.4f} "
              f"test_loss={evald['loss']:.4f} peak_memory_allocated={peak} bytes "
              f"launches={got}")
        print(f"lstm chain mode {tag} bits={bits}: chain starts by round {starts}")
        finite = all(math.isfinite(x) for x in losses + [evald["loss"]])
        if got != want or not finite:
            _fail(f"lstm chain mode bits={bits}: launches {got} (want {want}), "
                  f"finite={finite}, chain starts {starts}")
        if bits < 32:
            counts = got

            def one_round():
                nonlocal state
                state, _ = runner.run_round(state, key)

            _profile(f"lstm chain mode bits=8 (1 round) {tag}", one_round)
        else:
            params = unflatten_tree(state.device_params[0].clone(), spec)
        del runner, state
        gc.collect()
        torch.cuda.empty_cache()

    for name in ("qdq_delta_rows_rng", "qdq_rows_rng"):
        args, kw = captured.pop(name)
        _hold_kernel(name, args, kw["bits"], "the LSTM chain-mode payload")
        del args

    # ---------------------------------------------------------- checkpoint
    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(zeros(v) for v in tree)
        return torch.zeros_like(tree)

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=root, prefix="_ckpt_") as ckpt:
        t0 = time.perf_counter()
        path = save_checkpoint(ckpt, 1 + LSTM_ROUNDS, params, metrics={"vocab": LSTM_VOCAB})
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        back, meta = load_checkpoint(ckpt, zeros(params))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    pairs = list(zip(tree_leaves(params), tree_leaves(back)))
    same = all(b.device == a.device and b.dtype == a.dtype and torch.equal(a, b)
               for a, b in pairs)
    print(f"checkpoint {tag}: the LSTM's params ({len(pairs)} leaves) saved from the card "
          f"in {save_s:.2f}s ({size} bytes), loaded into a template on the card in "
          f"{load_s:.2f}s: bit-identical={same} meta={meta}")
    if not same or meta["step"] != 1 + LSTM_ROUNDS:
        _fail("the checkpoint did not restore the LSTM's params bit for bit")
    return counts


def _same_records(a, b, host=False):
    """Two simulator results' window records equal field by field (the host
    wall time too when ``host``)."""
    import numpy as np

    fields = SIM_RECORD_FIELDS + (("host_loop_s",) if host else ())
    return len(a.records) == len(b.records) and all(
        np.array_equal(np.asarray(getattr(ra, f)), np.asarray(getattr(rb, f)))
        for ra, rb in zip(a.records, b.records) for f in fields)


def _timed_method(obj, attr, sink):
    """Shadow ``obj.attr`` with a wrapper that appends each call's wall
    seconds, ending in a synchronize, to ``sink``; ``delattr`` undoes it."""
    import torch

    real = getattr(obj, attr)

    def call(*args, **kw):
        t0 = time.perf_counter()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        sink.append(time.perf_counter() - t0)
        return out
    setattr(obj, attr, call)


def _hold_at_widths(captured, spec, m, k, widths, label):
    """Both counter-RNG kernels on a simulator path's captured hop and
    aggregation payloads, at each wire width of ``widths``, with the side
    information recomputed for that width."""
    from repro_torch.kernels.quantize import payload_side_info

    held = {}
    for bits in widths:
        for name, b, per_message in (("qdq_delta_rows_rng", m, False),
                                     ("qdq_rows_rng", k * m, True)):
            args, _ = captured[name]
            s_rows, n_rows = payload_side_info(args[0].reshape(b, spec.d_pad), spec,
                                               per_message=per_message, bits=bits)
            held[(name, bits)] = _hold_kernel(name, (*args[:-2], s_rows, n_rows), bits,
                                              f"{label} width {bits}")
    return held


def sim_phases(tag):
    """The virtual-time simulator (``repro_torch.sim``) on the card, through
    ``build_scenario(...).runner()`` and ``run``/``replay`` as a user calls
    them, with the counts from 0 before each run:

    (a) ``straggler_tail`` (n = 20, the 2NN, bits 8, SIM_WINDOWS windows) on
        the CPU and the card from the same weights and seed words: equal
        records and Eq. 18 bits, params within 0.05 * scale + 1e-4, K hop
        and one aggregation launch a window; then ``congested_uplink`` with
        ``bits="adaptive"`` (SIM_ADAPTIVE_WINDOWS windows), its hop and
        aggregation payloads holding both kernels against their plain
        versions at every width the controller picked and at every width of
        ``DEFAULT_WIDTHS`` below 32 (6 included);
    (b) ``fleet_metro`` at n = 200 and 1,000 on the heap and the fleet
        engine with a telemetry recorder and causal traces: equal records,
        counters and virtual-time spans, params within the bits-8 contract,
        byte-identical ``tspan`` lines at n = 200 (at n = 1,000 the fleet's
        tie order puts some same-instant sends in another queue order, as
        in the JAX package);
    (c) ``fleet_metro`` on the fleet engine at n = SIM_FLEET_N, bits 8,
        SIM_FLEET_WINDOWS windows: ms a window split into host timeline,
        engine (``execute_round``) and evaluation, one more window under the
        profiler, peak memory, the launch counts (K + 1 a window), and both
        kernels on that run's payloads against their plain versions, timed
        beside their bounds;
    (d) the n = 1,000 heap run of (b) recorded and replayed on the card:
        params, records and history bit for bit;
    (e) ``straggler_tail`` at its defaults (n = 20, 40 windows), policy
        partial against drop: the accuracies.

    Returns the launches of every simulator run on the card by kernel, the
    fleet payloads' kernel numbers, and the traced n = 200 fleet run's
    telemetry stream (for :func:`obs_phase`)."""
    import numpy as np
    import torch

    from repro_torch.kernels.quantize import ops
    from repro_torch.kernels.quantize import quantize as qk
    from repro_torch.obs import Recorder, VirtualClock
    from repro_torch.sim import DEFAULT_WIDTHS, SimTrace, build_scenario

    counts = dict.fromkeys(qk.LAUNCHES, 0)

    def launches(windows_quantized, k, label):
        got = dict(qk.LAUNCHES)
        want = dict.fromkeys(qk.LAUNCHES, 0)
        want.update(qdq_delta_rows_rng=k * windows_quantized, qdq_rows_rng=windows_quantized)
        if got != want:
            _fail(f"sim {label}: launches {got}, want {want}")
        for name, n in got.items():
            counts[name] += n
        return got

    def capture():
        captured = {}
        real = (ops.qdq_delta_rows_rng, ops.qdq_rows_rng)
        ops.qdq_delta_rows_rng = _capture_first(captured, "qdq_delta_rows_rng", real[0])
        ops.qdq_rows_rng = _capture_first(captured, "qdq_rows_rng", real[1])

        def restore():
            ops.qdq_delta_rows_rng, ops.qdq_rows_rng = real
        return captured, restore

    # ----------------------------------------------- (a) CPU against the card
    setup = build_scenario("straggler_tail", n=20, seed=0, bits=8)
    k = setup.cfg.k_walk
    gen = torch.Generator().manual_seed(21)
    qseeds = [torch.randint(0, 1 << 32, (k + 1, 2), generator=gen) for _ in range(SIM_WINDOWS)]
    params = setup.model.init(torch.Generator().manual_seed(4), "cpu")
    res = {}
    for dev in ("cpu", "cuda"):
        runner = setup.runner(device=dev)
        qk.reset_launch_counts()
        t0 = time.perf_counter()
        res[dev] = runner.run(SIM_WINDOWS, torch.Generator().manual_seed(0), setup.x_test,
                              setup.y_test, eval_every=1, qseeds=qseeds,
                              params=[(w.to(dev), b.to(dev)) for w, b in params])
        if dev == "cuda":
            torch.cuda.synchronize()
            got = launches(SIM_WINDOWS, k, "straggler_tail")
        wall = (time.perf_counter() - t0) * 1e3
        print(f"sim {tag}: straggler_tail n=20 bits=8 {dev}: {SIM_WINDOWS} windows "
              f"{wall:.1f} ms, acc={[round(a, 4) for a in res[dev].history.test_accuracy]} "
              f"loss={[round(v, 5) for v in res[dev].history.train_loss]}"
              + (f" launches={got}" if dev == "cuda" else ""))
    a = res["cpu"].state.device_params
    b = res["cuda"].state.device_params.cpu()
    diff = float((a - b).abs().max())
    if (not _same_records(res["cpu"], res["cuda"])
            or res["cpu"].history.comm_bits != res["cuda"].history.comm_bits
            or not diff < 0.05 * float(a.abs().max()) + 1e-4 or not torch.isfinite(b).all()):
        _fail(f"sim straggler_tail: the CPU and the card disagree (max|d|={diff:.3e})")
    print(f"sim {tag}: straggler_tail cpu-vs-card: records and Eq. 18 bits equal, "
          f"max|d matrix|={diff:.3e}")

    setup = build_scenario("congested_uplink", n=20, seed=0, bits="adaptive")
    runner = setup.runner()
    captured, restore = capture()
    qk.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        ares = runner.run(SIM_ADAPTIVE_WINDOWS, torch.Generator().manual_seed(0),
                          setup.x_test, setup.y_test, eval_every=SIM_ADAPTIVE_WINDOWS)
    finally:
        restore()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    picked = [r.bits for r in ares.records]
    quantized = sum(w < 32 for w in picked)
    got = launches(quantized, setup.cfg.k_walk, "congested_uplink adaptive")
    print(f"sim {tag}: congested_uplink n=20 bits=adaptive "
          f"{setup.sim.bits_policy.widths}: widths by window {picked}, programs_run "
          f"{runner.engine.programs_run}, {SIM_ADAPTIVE_WINDOWS} windows {wall:.1f} ms, "
          f"acc={ares.history.test_accuracy[-1]:.4f} launches={got}")
    if runner.engine.programs_run != tuple(sorted(set(picked))):
        _fail("sim congested_uplink: programs_run disagrees with the windows' widths")
    widths = sorted({w for w in (*DEFAULT_WIDTHS, *picked) if w < 32})
    _hold_at_widths(captured, runner.engine.flat_spec, setup.cfg.m_chains, setup.cfg.k_walk,
                    widths, "congested_uplink payload")
    del captured, runner

    # -------------------------------------- (b) heap against fleet, traced
    # The fleet admits same-instant sends of one sender in (t_ready, chain)
    # order, the heap in push order (the fleet's tie contract,
    # docs/SIMULATOR.md): the JAX package's own heap and fleet write the
    # same tspan lines at n = 200 and differ in the queue order of such ties
    # at n = 1,000, with equal records. The uplink duration totals differ in
    # float association (the fleet sums a window at a time).
    for n in SIM_CROSS_N:
        cross = {}
        for engine in ("heap", "fleet"):
            setup = build_scenario("fleet_metro", n=n, seed=0)
            runner = setup.runner(engine=engine)
            rec = Recorder(clock=VirtualClock(), trace=True)
            runner.attach_obs(rec, trace=True)
            qk.reset_launch_counts()
            t0 = time.perf_counter()
            result = runner.run(2, torch.Generator().manual_seed(0), setup.x_test,
                                setup.y_test, eval_every=2, record=engine == "heap")
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            got = launches(2, setup.cfg.k_walk, f"fleet_metro n={n} {engine}")
            tspans = [json.dumps(e) for e in rec.events if e["kind"] == "tspan"]
            print(f"sim {tag}: fleet_metro n={n} {engine}: 2 windows {wall:.1f} ms "
                  f"events={result.events_total} tspans={len(tspans)} "
                  f"virtual_time={result.virtual_time_s!r} "
                  f"acc={result.history.test_accuracy[-1]:.4f} launches={got}")
            stream = rec.to_stream()
            cross[engine] = (setup, result, tspans, stream.summary)
            if n == SIM_CROSS_N[0] and engine == "fleet":
                traced = stream                  # rendered by obs_phase
        (hsetup, hres, htsp, hsum), (_, fres, ftsp, fsum) = cross["heap"], cross["fleet"]
        a, b = hres.state.device_params, fres.state.device_params
        diff = float((a - b).abs().max())
        spans = [name for name in hsum["spans"] if not name.startswith("sim/uplink")]
        tied = len(set(htsp) - set(ftsp))
        if (not _same_records(hres, fres) or not htsp or len(htsp) != len(ftsp)
                or (n == SIM_CROSS_N[0] and htsp != ftsp)
                or hsum["counters"] != fsum["counters"]
                or any(hsum["spans"][k] != fsum["spans"][k] for k in spans)
                or not diff < 0.05 * float(a.abs().max()) + 1e-4):
            _fail(f"sim fleet_metro n={n}: heap and fleet disagree (max|d|={diff:.3e}, "
                  f"{tied} tspan lines apart)")
        print(f"sim {tag}: fleet_metro n={n} heap-vs-fleet: records, counters and "
              f"virtual-time spans identical; {len(htsp)} tspan lines, byte-identical="
              f"{htsp == ftsp}, {tied} apart by the fleet's tie order; params "
              f"bit-identical={bool(torch.equal(a, b))} max|d|={diff:.3e}")

    # ------------------------------------------------ (d) record and replay
    runner = hsetup.runner(engine="heap")
    qk.reset_launch_counts()
    rep = runner.replay(SimTrace.from_lines(hres.trace.to_lines()),
                        torch.Generator().manual_seed(0), hsetup.x_test, hsetup.y_test,
                        eval_every=2)
    torch.cuda.synchronize()
    got = launches(2, hsetup.cfg.k_walk, "replay")
    same = (torch.equal(rep.state.device_params, hres.state.device_params)
            and _same_records(rep, hres, host=True)
            and rep.history.train_loss == hres.history.train_loss
            and rep.history.test_accuracy == hres.history.test_accuracy)
    print(f"sim {tag}: record/replay on the card ({len(hres.trace.windows)} windows, "
          f"{len(hres.trace.to_lines())} trace lines): bit-identical={same} launches={got}")
    if not same:
        _fail("sim: the replay on the card is not bit-identical to the run")
    del cross, hres, fres, rep, runner
    gc.collect()
    torch.cuda.empty_cache()

    # -------------------------------------------- (c) the acceptance-scale fleet
    t0 = time.perf_counter()
    setup = build_scenario("fleet_metro", n=SIM_FLEET_N, seed=0, bits=8)
    runner = setup.runner(engine="fleet")
    cfg, eng = setup.cfg, runner.engine
    print(f"sim {tag}: fleet_metro n={SIM_FLEET_N}: M={cfg.m_chains} K={cfg.k_walk} "
          f"B={cfg.batch_size} d={eng.flat_spec.d} d_pad={eng.flat_spec.d_pad} "
          f"rows={eng.flat_spec.rows} aggregators={max(1, round(SIM_FLEET_N * cfg.agg_fraction))} "
          f"set-up {time.perf_counter() - t0:.2f}s")
    engine_s, eval_s, init_s, stamps = [], [], [], []
    _timed_method(eng, "execute_round", engine_s)
    _timed_method(eng, "evaluate", eval_s)
    _timed_method(runner, "init_state", init_s)

    def stamp(r, metrics, evald, record):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    captured, restore = capture()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    qk.reset_launch_counts()
    t_run = time.perf_counter()
    try:
        result = runner.run(SIM_FLEET_WINDOWS, torch.Generator().manual_seed(0), setup.x_test,
                            setup.y_test, eval_every=1, callback=stamp)
    finally:
        restore()
        for obj, attr in ((eng, "execute_round"), (eng, "evaluate"), (runner, "init_state")):
            delattr(obj, attr)
    torch.cuda.synchronize()
    got = launches(SIM_FLEET_WINDOWS, cfg.k_walk, f"fleet_metro n={SIM_FLEET_N}")
    peak = torch.cuda.max_memory_allocated()
    starts = [t_run + init_s[0]] + stamps[:-1]
    walls = [(b - a) * 1e3 for a, b in zip(starts, stamps)]
    for i, rec in enumerate(result.records):
        e_ms, v_ms = engine_s[i] * 1e3, eval_s[i] * 1e3
        print(f"sim {tag}: fleet_metro n={SIM_FLEET_N} window {rec.round}: ms={walls[i]:.1f} "
              f"(host timeline {walls[i] - e_ms - v_ms:.1f}, of it the event sweeps "
              f"{rec.host_loop_s * 1e3:.1f}; engine {e_ms:.1f}; evaluation {v_ms:.1f}) "
              f"events={rec.events} truncated={rec.truncated_chains} "
              f"killed={int(rec.killed.sum())} t_end={rec.t_end!r}")
    print(f"sim {tag}: fleet_metro n={SIM_FLEET_N}: init {init_s[0] * 1e3:.1f} ms, "
          f"ms/window median={statistics.median(walls):.1f} "
          f"loss={[round(v, 5) for v in result.history.train_loss]} "
          f"acc={[round(v, 4) for v in result.history.test_accuracy]} "
          f"peak_memory_allocated={peak} bytes launches={got}")
    if not all(math.isfinite(v) for v in result.history.train_loss):
        _fail(f"sim fleet_metro n={SIM_FLEET_N}: a non-finite loss")
    state = result.state
    gen = torch.Generator().manual_seed(1)

    def one_window():
        nonlocal state
        state, _, _ = runner.run_round(state, gen)

    _profile(f"fleet_metro n={SIM_FLEET_N} (1 window) {tag}", one_window)
    spec = eng.flat_spec
    held = {}
    for name, rows in (("qdq_delta_rows_rng", cfg.m_chains * spec.rows),
                       ("qdq_rows_rng", cfg.k_walk * cfg.m_chains * spec.rows)):
        args, kw = captured[name]
        if args[0].shape[0] != rows:
            _fail(f"sim fleet_metro: the {name} payload has {args[0].shape[0]} rows, want {rows}")
        held[name] = _hold_kernel(name, args, kw["bits"], f"fleet_metro n={SIM_FLEET_N} payload")
    del captured, runner, result, state
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------ (e) partial against drop
    accs = {}
    for policy in ("partial", "drop"):
        setup = build_scenario("straggler_tail", n=20, seed=0, policy=policy)
        runner = setup.runner()
        qk.reset_launch_counts()
        t0 = time.perf_counter()
        result = runner.run(setup.rounds, torch.Generator().manual_seed(0), setup.x_test,
                            setup.y_test, eval_every=10)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches(0, setup.cfg.k_walk, f"straggler_tail {policy}")
        accs[policy] = result.history.test_accuracy[-1]
        print(f"sim {tag}: straggler_tail n=20 policy={policy} {setup.rounds} windows: "
              f"acc={[round(v, 4) for v in result.history.test_accuracy]} "
              f"truncated={sum(r.truncated_chains for r in result.records)} "
              f"dropped={sum(r.dropped_chains for r in result.records)} "
              f"ms/window={wall / setup.rounds:.2f}")
    print(f"sim {tag}: straggler_tail final accuracy partial={accs['partial']:.4f} "
          f"drop={accs['drop']:.4f}")
    return counts, held, traced


# ------------------------------------------------------------- training
def _normwise(got, want):
    """max |got - want| / max |want| (0 for an all-zero ``want``)."""
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    return err / scale if scale > 0 else err


def _grads_agree(names, got, want, tag, label):
    """Each gradient of ``got`` within GRAD_TOL of ``want``, normwise;
    prints one line and fails the run otherwise. Returns the largest
    absolute difference."""
    import torch

    parts, worst, bad = [], 0.0, []
    for name, g, w in zip(names, got, want):
        r = _normwise(g, w)
        worst = max(worst, float((g - w).abs().max()) if w.numel() else 0.0)
        parts.append(f"{name} {r:.2e}")
        if not (r <= GRAD_TOL and bool(torch.isfinite(g).all())):
            bad.append(name)
    print(f"{label} {tag}: max|d|/max|want| {', '.join(parts)} (tol {GRAD_TOL:g})")
    if bad:
        _fail(f"{label}: {bad} disagree with autograd through the plain version")
    return worst


def _bwd_attn_inputs(bsz, lq, lk, h, kv, hd):
    """(q, k, v, dO) of a BWD_ATTN_CASES case on the card, N(0, 1) from
    seeds of its shape."""
    import torch

    gen = torch.Generator("cuda").manual_seed(hd + lq)
    q, k, v = (torch.randn(bsz, n_, heads, hd, generator=gen, device="cuda")
               for n_, heads in ((lq, h), (lk, kv), (lk, kv)))
    gen = torch.Generator("cuda").manual_seed(lq + lk)
    return q, k, v, torch.randn(q.shape, generator=gen, device="cuda")


def _bwd_attn_case(label, q, k, v, do, causal, window, tag):
    """B10's backward on (q, k, v) with upstream gradient ``do`` against
    autograd through the plain version; the backward kernels timed alone
    beside the plain version's backward and fp32 SDPA's (memory-efficient
    backend, K/V repeated to every query head), each kernel's profiler ms;
    its bound from the five products on the pairs the mask allows, at
    3xTF32. Returns the case's entry."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.block_attn import block_attn as ba
    from repro_torch.kernels.block_attn.ref import attention_pairs, block_attention_plain

    bsz, lq, h, hd = q.shape
    lk, kv = k.shape[1], k.shape[2]
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    ba.reset_launch_counts()
    got = torch.autograd.grad(ba.block_attn(*ins, causal=causal, window=window), ins, do)
    torch.cuda.synchronize()
    counts = dict(ba.BWD_LAUNCHES)
    o_plain = block_attention_plain(*ins, causal=causal, window=window)
    want = torch.autograd.grad(o_plain, ins, do, retain_graph=True)
    max_abs = _grads_agree(("dq", "dk", "dv"), got, want, tag, f"block_attn backward {label}")
    if counts != dict.fromkeys(ba.BWD_LAUNCHES, 1):
        _fail(f"block_attn backward {label}: launched {counts}")
    with torch.no_grad():
        o, lse = ba.block_attn_forward(q, k, v, causal=causal, window=window, with_lse=True)

    def backward():
        return ba.block_attn_backward(q, k, v, o, lse, do, causal=causal, window=window)

    ms = statistics.median(_time_ms(backward, iters=5, warmup=1) for _ in range(3))
    kernel_ms = _kernel_device_ms(lambda: [backward() for _ in range(3)], list(ba.BWD_LAUNCHES))
    plain_ms = _time_ms(lambda: torch.autograd.grad(o_plain, ins, do, retain_graph=True),
                        iters=2, warmup=1)
    del o_plain, want, got
    # The library's backward alone: fp32 SDPA on K/V repeated to H heads.
    qt, kt, vt = (t.detach().repeat_interleave(h // t.shape[2], dim=2).transpose(1, 2)
                  .requires_grad_() for t in (q, k, v))
    mask = None
    if window > 0:
        i = torch.arange(lq, device="cuda")[:, None]
        j = torch.arange(lk, device="cuda")[None, :]
        mask = (j <= i) & (i - j < window) if causal else (i - j < window)
    try:
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            o_lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                   is_causal=causal and mask is None)
            do_t = do.transpose(1, 2)
            library_ms = statistics.median(_time_ms(
                lambda: torch.autograd.grad(o_lib, (qt, kt, vt), do_t, retain_graph=True),
                iters=5, warmup=1) for _ in range(3))
    except RuntimeError as err:
        print(f"block_attn backward {label} {tag}: fp32 SDPA refused ({str(err)[:80]})")
        library_ms = None
    del qt, kt, vt, mask
    pairs = attention_pairs(lq, lk, causal=causal, window=window) * bsz * h
    flop = ATTN_BWD_PRODUCTS * 2 * hd * pairs
    nbytes = 4 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel() + 2 * q.numel() + lse.numel())
    bound_ops_ms = ATTN_TF32_PASSES * flop / TF32_OPS_PER_S * 1e3
    bound_simt_ms = flop / FP32_OPS_PER_S * 1e3
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(bound_ops_ms, bound_bytes_ms)
    print(f"block_attn backward {label} {tag}: q{tuple(q.shape)} k/v{tuple(k.shape)} "
          f"causal={causal} window={window}: ms={ms:.4f} ({' + '.join(ba.BWD_LAUNCHES)}; "
          f"profiler ms each {_fmt_ms(kernel_ms)}; attn_bwd_dkdvq "
          f"{ba.build().block_attn_bwd_smem_bytes(1, hd)} bytes of shared memory a block) "
          f"plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms} (fp32 SDPA backward, EFFICIENT_ATTENTION, K/V repeated to "
          f"{h} heads) bound_ms={bound_ms:.4f} (3xTF32 on the tensor cores, the kernels' "
          f"arithmetic: {ATTN_TF32_PASSES} x {ATTN_BWD_PRODUCTS} products x 2 hd x {pairs} "
          f"pairs = {ATTN_TF32_PASSES} x {flop} FLOP at {TF32_OPS_PER_S:.4g}/s = "
          f"{bound_ops_ms:.4f} ms; float32 SIMT {bound_simt_ms:.4f} ms; bytes {nbytes} = "
          f"{bound_bytes_ms:.4f} ms) = {bound_ms / ms:.3f} of it")
    return {"q": list(q.shape), "kv": list(k.shape), "causal": causal, "window": window,
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if bound_ops_ms >= bound_bytes_ms else "bytes",
            "library_ms": library_ms, "kernel_ms": kernel_ms}


def _fmt_ms(kernel_ms):
    return ", ".join(f"{k} {v:.4f}" if v is not None else f"{k} none"
                     for k, v in kernel_ms.items())


def _ssd_bwd_flop(bsz, h, l, p, n, chunk, g):
    """(FLOP of B9's gradient in the chunked matrix form, the products
    counted): per (batch, head) chunk of length c, dS^loc, B G_c, dy S_c^T
    and xdt G_c^T at 2 c N P each, and R, (CB o L)^T dy, R B and R^T C on the
    c (c + 1) / 2 causal pairs at 2 P, 2 P, 2 N and 2 N; C B^T once per
    (batch, group) chunk on the causal pairs, 2 N."""
    lens = [min(chunk, l - c0) for c0 in range(0, l, chunk)]
    per_head = sum(8 * c * n * p + 4 * (c * (c + 1) // 2) * (p + n) for c in lens)
    per_group = sum(2 * (c * (c + 1) // 2) * n for c in lens)
    return (bsz * h * per_head + bsz * g * per_group,
            "dS^loc, B G_c, dy S_c^T, xdt G_c^T (2 c N P each), R and (CB o L)^T dy "
            "(2 P a causal pair), R B and R^T C (2 N a pair), C B^T per group (2 N a pair)")


def _ssd_bwd_inputs(bsz, h, l, p, n, g, large):
    """(x, dt, A_log, B, C, dy) of a BWD_SSD_CASES case on the card, from a
    seed of its shape; x, dt, B and C in the model's (B, L, heads, .)
    layout as transposed views (``large``: dt |A| from 10 to 15 a step)."""
    import torch

    gen = torch.Generator("cuda").manual_seed(l + p)
    x = (torch.randn(bsz, l, h, p, generator=gen, device="cuda") * 0.8).transpose(1, 2)
    dt = torch.nn.functional.softplus(torch.randn(bsz, l, h, generator=gen,
                                                  device="cuda")).transpose(1, 2)
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device="cuda"))
    if large:
        dt = ((10.0 + 5.0 * torch.rand(bsz, l, h, generator=gen, device="cuda"))
              / torch.exp(a_log)).transpose(1, 2)
    b, c = ((torch.randn(bsz, l, g, n, generator=gen, device="cuda") * 0.5).transpose(1, 2)
            for _ in range(2))
    return x, dt, a_log, b, c, torch.randn(bsz, h, l, p, generator=gen, device="cuda")


def _ssd_bwd_case(label, bsz, h, l, p, n, chunk, g, large, tag):
    """B9's backward at (B, H, L, P, N, chunk, G) on
    :func:`_ssd_bwd_inputs`, against autograd through
    ``ssd_chunked_plain``; the six
    kernels timed alone beside the plain version's backward, each kernel's
    profiler ms; its bound the smaller of the chunked form's FLOP at 3xTF32
    and the recurrent form's at the float32 SIMT rate, beside the bytes.
    Returns the case's entry."""
    import torch

    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_plain

    x, dt, a_log, b, c, dy = _ssd_bwd_inputs(bsz, h, l, p, n, g, large)
    ins = [t.detach().requires_grad_() for t in (x, dt, a_log, b, c)]
    sk.reset_launch_counts()
    got = torch.autograd.grad(sk.ssd_scan(*ins, chunk=chunk), ins, dy)
    torch.cuda.synchronize()
    counts = dict(sk.BWD_LAUNCHES)
    y_plain = ssd_chunked_plain(*ins, chunk)[0]
    want = torch.autograd.grad(y_plain, ins, dy, retain_graph=True)
    max_abs = _grads_agree(("dx", "ddt", "da_log", "db", "dc"), got, want, tag,
                           f"ssd_scan backward {label}")
    if counts != dict.fromkeys(sk.BWD_STAGES, 1):
        _fail(f"ssd_scan backward {label}: launched {counts}")
    with torch.no_grad():
        _, states = sk.ssd_scan_forward(x, dt, a_log, b, c, chunk=chunk)

    def backward():
        return sk.ssd_scan_backward(x, dt, a_log, b, c, states, dy, chunk=chunk)

    ms = statistics.median(_time_ms(backward, iters=5, warmup=1) for _ in range(3))
    kernel_ms = _kernel_device_ms(lambda: [backward() for _ in range(3)], list(SSD_BWD_KERNELS))
    kernel_ms = {SSD_BWD_KERNELS[k]: v for k, v in kernel_ms.items()}
    shape, dims = (ctypes.c_longlong * 3)(), (ctypes.c_int * 7)(bsz, h, g, l, p, n, chunk)
    shapes = []
    for i, name in enumerate(sk.BWD_STAGES):
        sk.build().ssd_bwd_shape(i, dims, shape)
        shapes.append(f"{name} {shape[0]} B x {shape[1]} blocks of {shape[2]}")
    plain_ms = _time_ms(lambda: torch.autograd.grad(y_plain, ins, dy, retain_graph=True),
                        iters=2, warmup=1)
    del y_plain, want, got, states
    bound_ms, bound_by, counted = _ssd_bwd_bound(bsz, h, l, p, n, chunk, g)
    print(f"ssd_scan backward {label} {tag}: x{(bsz, h, l, p)} B/C{(bsz, g, l, n)} "
          f"chunk={chunk}{' dt|A| 10-15' if large else ''}: ms={ms:.4f} "
          f"({' + '.join(sk.BWD_STAGES)}; profiler ms each {_fmt_ms(kernel_ms)}; "
          f"shared memory a block: {', '.join(shapes)}) "
          f"plain_ms={plain_ms:.4f} library_ms=None (no one call computes the scan's gradient) "
          f"bound_ms={bound_ms:.4f} ({counted}) = {bound_ms / ms:.3f} of it")
    return {"x": [bsz, h, l, p], "bc": [bsz, g, l, n], "chunk": chunk, "large_cum": large,
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "kernel_ms": kernel_ms}


def _ssd_bwd_bound(bsz, h, l, p, n, chunk, g):
    """(bound ms, "operations" or "bytes", how it was counted) of B9's
    backward: the smaller of the chunked form's FLOP at 3xTF32 and the
    recurrent form's at the float32 SIMT rate, beside the bytes (x, dt, B,
    C, dy read, dx, ddt, dB, dC written, A_log and its gradient)."""
    flop_rec = SSD_BWD_FLOP_PER_NP * n * p * bsz * h * l
    flop, counted = _ssd_bwd_flop(bsz, h, l, p, n, chunk, g)
    nbytes = 4 * (3 * bsz * h * l * p + 2 * bsz * h * l + 4 * bsz * g * l * n + 2 * h)
    bound_tf32_ms = SSD_TF32_PASSES * flop / TF32_OPS_PER_S * 1e3
    bound_simt_ms = flop_rec / FP32_OPS_PER_S * 1e3
    bound_ops_ms = min(bound_tf32_ms, bound_simt_ms)
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    text = (f"the smaller of: the chunked form at 3xTF32, {SSD_TF32_PASSES} x {flop} FLOP at "
            f"{TF32_OPS_PER_S:.4g}/s = {bound_tf32_ms:.4f} ms, counting {counted}; the "
            f"recurrent form at float32 SIMT, {SSD_BWD_FLOP_PER_NP} N P FLOP a position = "
            f"{flop_rec} FLOP at {FP32_OPS_PER_S:.4g}/s = {bound_simt_ms:.4f} ms; bytes "
            f"{nbytes} = {bound_bytes_ms:.4f} ms")
    return (max(bound_ops_ms, bound_bytes_ms),
            "operations" if bound_ops_ms >= bound_bytes_ms else "bytes", text)


def backward_phase(smi):
    """(g) The backward kernels against autograd through their plain
    versions on the card, timed: B10 in BWD_ATTN_CASES, B9 in
    BWD_SSD_CASES. Returns ({label: entry} of B10, of B9)."""
    import torch

    tag = f"[{smi}]"
    attn, ssd = {}, {}
    for label, bsz, lq, lk, h, kv, hd, causal, window in BWD_ATTN_CASES:
        q, k, v, do = _bwd_attn_inputs(bsz, lq, lk, h, kv, hd)
        attn[label] = _bwd_attn_case(label, q, k, v, do, causal, window, tag)
        del q, k, v, do
        gc.collect()
        torch.cuda.empty_cache()
    for label, *shape in BWD_SSD_CASES:
        ssd[label] = _ssd_bwd_case(label, *shape, tag)
        gc.collect()
        torch.cuda.empty_cache()
    return attn, ssd


def _train_grads(cfg, params, batch):
    """(loss, gradient leaves) of ``T.loss_fn`` with remat, the leaves in
    ``_leaves`` order."""
    import torch

    from repro_torch.models import transformer as T

    leaves = list(_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    loss = T.loss_fn(cfg, params, batch, remat=True)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return loss.detach(), grads


def train_smoke_phase(arch_id, tag):
    """(h) The SMOKE configuration's training on the CPU (plain versions)
    and on the card (the kernels, forward and backward) from the same
    weights and batches: one gradient, then TRAIN_SMOKE_STEPS steps of
    ``dist.make_train_step``; losses within TRAIN_LOSS_TOL (relative), the
    gradient and the parameters and velocity after the steps within
    TRAIN_TOL of each leaf's largest magnitude. A MoE model is compared
    where every MoE slot routed every token alike on both (the gradient
    pass must; the steps are compared up to the first that does not).
    Returns the card gradient pass's launches by kernel."""
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.dist import make_train_step
    from repro_torch.kernels.block_attn import block_attn as ba
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.models import transformer as T
    from repro_torch.optim import momentum_init

    small = get_smoke(arch_id)
    on_cpu = T.init_params(small, torch.Generator().manual_seed(7), device="cpu")
    on_card = _tree_to(on_cpu, "cuda")
    gen = torch.Generator().manual_seed(8)

    def batch():
        toks = torch.randint(0, small.vocab, (2, TRAIN_SMOKE_SEQ + 1), generator=gen)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if small.frontend != "none":
            out["embeds"] = torch.randn(2, small.frontend_tokens, small.d_model, generator=gen)
        return out

    def to(b, device):
        return {k: v.to(device) for k, v in b.items()}

    one = batch()
    with _routing() as r_cpu:
        loss_cpu, g_cpu = _train_grads(small, on_cpu, one)
    ba.reset_launch_counts()
    sk.reset_launch_counts()
    with _routing() as r_card:
        loss_card, g_card = _train_grads(small, on_card, to(one, "cuda"))
    torch.cuda.synchronize()
    launches = {"block_attn": ba.LAUNCHES["block_attn"], "ssd_scan": sk.LAUNCHES["ssd_scan"],
                **ba.BWD_LAUNCHES, **sk.BWD_LAUNCHES}
    calls = _kernel_calls(small)
    want = {"block_attn": 2 * calls["block_attn"], "ssd_scan": 2 * calls["ssd_scan"],
            **dict.fromkeys(ba.BWD_LAUNCHES, calls["block_attn"]),
            **dict.fromkeys(sk.BWD_STAGES, calls["ssd_scan"])}
    same = all(torch.equal(a[1], b[1].cpu()) and torch.equal(a[3], b[3].cpu())
               for a, b in zip(r_cpu, r_card)) and len(r_cpu) == len(r_card)
    loss_r = abs(float(loss_card) - float(loss_cpu)) / abs(float(loss_cpu))
    names = list(_leaf_names(on_cpu))
    grad_r, grad_leaf = _worst_leaf(g_card, g_cpu, names)
    print(f"{small.name} train {tag}: one gradient on 2x{TRAIN_SMOKE_SEQ} tokens, cpu-vs-card "
          f"loss {float(loss_cpu):.7f} / {float(loss_card):.7f} rel {loss_r:.2e} (tol "
          f"{TRAIN_LOSS_TOL}), worst leaf {grad_leaf} max|d|/max|want| {grad_r:.2e} (TRAIN_TOL "
          f"{TRAIN_TOL}) over {len(g_cpu)} leaves; {len(r_cpu)} MoE routings, equal={same}; "
          f"launches {launches} (want {want}: forward twice with remat)")
    if not (same and loss_r <= TRAIN_LOSS_TOL and grad_r <= TRAIN_TOL and launches == want
            and all(bool(torch.isfinite(g).all()) for g in g_card)):
        _fail(f"SMOKE {arch_id}: the card's gradient disagrees with the CPU's, its routing "
              f"differs, or it launched {launches} (want {want})")
    del g_cpu, g_card

    steps = make_train_step(small, lr_r=20.0)
    vel = [momentum_init(on_cpu).velocity, momentum_init(on_card).velocity]
    losses, compared = [], 0
    for step in range(TRAIN_SMOKE_STEPS):
        b = batch()
        with _routing() as r_cpu:
            on_cpu, vel[0], l_cpu = steps(on_cpu, vel[0], b, step)
        with _routing() as r_card:
            on_card, vel[1], l_card = steps(on_card, vel[1], to(b, "cuda"), step)
        losses.append((float(l_cpu), float(l_card)))
        if not all(torch.equal(a[1], c[1].cpu()) for a, c in zip(r_cpu, r_card)):
            break
        compared += 1
    loss_r = max(abs(c - w) / abs(w) for w, c in losses[:compared]) if compared else 0.0
    param = _worst_leaf(list(_leaves(on_card)), list(_leaves(on_cpu)), names)
    velocity = _worst_leaf(list(_leaves(vel[1])), list(_leaves(vel[0])), names)
    print(f"{small.name} train {tag}: {TRAIN_SMOKE_STEPS} make_train_step steps (lr_r 20), "
          f"losses cpu/card {[(round(a, 6), round(c, 6)) for a, c in losses]}; routing equal "
          f"in {compared} of them; worst loss rel {loss_r:.2e}; worst params leaf {param[1]} "
          f"{param[0]:.2e}, velocity leaf {velocity[1]} {velocity[0]:.2e} (TRAIN_TOL {TRAIN_TOL})")
    finite = all(math.isfinite(c) for _, c in losses)
    if not finite or loss_r > TRAIN_LOSS_TOL or (
            compared == TRAIN_SMOKE_STEPS and max(param[0], velocity[0]) > TRAIN_TOL):
        _fail(f"SMOKE {arch_id}: the card's training steps disagree with the CPU's")
    return launches


def pod_phase(arch_id, bsz, seq, steps, tag):
    """(i) ``launch.train pod`` at full width through ``launch_main``, on
    the card: ``steps`` steps of ``dist.make_train_step`` with remat, float32,
    TF32 off. Each step is timed (host clock, synchronized) and its kernel
    launches counted (the forward's twice a layer with remat, the backward's
    once); the last step runs under the profiler; the backward of layer 0's
    kernel call (the last backward call of the first step) is held on its
    own captured inputs and upstream gradient against autograd through the
    plain version; after TP_TRAIN_STEPS steps each leaf's update norm
    ||p - p_0|| in float64 is kept for phase (r). Returns ({kernel: launches
    counted over the steps}, the step's numbers)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.dist import steps as dist_steps
    from repro_torch.kernels.block_attn import block_attn as ba
    from repro_torch.kernels.block_attn.ref import block_attention_plain
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_plain
    from repro_torch.launch.train import main as launch_main

    cfg = get_arch(arch_id)
    calls = _kernel_calls(cfg)
    want = {"block_attn": 2 * calls["block_attn"], "ssd_scan": 2 * calls["ssd_scan"],
            **dict.fromkeys(ba.BWD_LAUNCHES, calls["block_attn"]),
            **dict.fromkeys(sk.BWD_STAGES, calls["ssd_scan"])}
    record = {"ms": [], "loss": [], "launches": [], "bwd_args": {}}
    real_make, real_attn_bwd, real_ssd_bwd = (dist_steps.make_train_step,
                                              ba.block_attn_backward, sk.ssd_scan_backward)

    def keep_last(name, real):
        def spy(*args, **kw):
            if not record["ms"]:                    # the first step's calls
                record["bwd_args"][name] = (args, kw)
            return real(*args, **kw)
        return spy

    def timed_make(cfg_, **kw):
        step_fn = real_make(cfg_, **kw)

        def timed(params, vel, batch, step):
            out = None

            def run():
                nonlocal out
                out = step_fn(params, vel, batch, step)

            if step == 0:
                record["p0"] = [t.detach().clone() for t in _leaves(params)]
            ba.reset_launch_counts()
            sk.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if step == steps - 1:
                _profile(f"{cfg_.name} train step {bsz}x{seq} {tag}", run)
            else:
                run()
            torch.cuda.synchronize()
            record["ms"].append((time.perf_counter() - t0) * 1e3)
            if step == TP_TRAIN_STEPS - 1:
                record["update_norms"] = dict(zip(_leaf_names(params), (
                    float(torch.linalg.vector_norm(p.double() - q.double()))
                    for p, q in zip(_leaves(params), record.pop("p0")))))
            record["loss"].append(float(out[2]))
            record["launches"].append({"block_attn": ba.LAUNCHES["block_attn"],
                                       "ssd_scan": sk.LAUNCHES["ssd_scan"],
                                       **ba.BWD_LAUNCHES, **sk.BWD_LAUNCHES})
            return out

        return timed

    dist_steps.make_train_step = timed_make
    ba.block_attn_backward = keep_last("block_attn", real_attn_bwd)
    sk.ssd_scan_backward = keep_last("ssd_scan", real_ssd_bwd)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        launch_main(["pod", "--arch", arch_id, "--batch", str(bsz), "--seq", str(seq),
                     "--steps", str(steps)])
    finally:
        dist_steps.make_train_step = real_make
        ba.block_attn_backward, sk.ssd_scan_backward = real_attn_bwd, real_ssd_bwd
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_front = cfg.frontend_tokens if cfg.frontend != "none" else 0
    step_ms = statistics.median(record["ms"][1:-1])     # warm-up and profiled steps out
    tokens = bsz * (seq + n_front)
    print(f"{cfg.name} train pod {tag}: --batch {bsz} --seq {seq} --steps {steps} "
          f"(n_layers {cfg.n_layers}{f', {cfg.n_enc_layers} encoder layers over {n_front} stub frames' if cfg.enc_dec else ''}; "
          f"remat, float32, TF32 off): ms/step median of steps 1..{steps - 2}={step_ms:.2f} "
          f"all={[round(x, 2) for x in record['ms']]} training tokens/s="
          f"{tokens / step_ms * 1e3:.1f} ({bsz}x{seq} text{f' + {bsz}x{n_front} frames' if n_front else ''} a step) "
          f"losses={[round(x, 5) for x in record['loss']]} peak_memory_allocated={peak} bytes; "
          f"launcher wall {wall:.1f}s (init and first-step warm-up included); launches a step "
          f"{record['launches'][0]} (want {want})")
    if (not all(math.isfinite(x) for x in record["loss"])
            or any(lc != want for lc in record["launches"])):
        _fail(f"train pod {arch_id}: losses {record['loss']} or launches {record['launches']} "
              f"(want {want} a step)")
    # Layer 0's backward call on its own inputs and upstream gradient.
    for name, (args, kw) in record["bwd_args"].items():
        if name == "block_attn":
            q, k, v, o, lse, do = args
            got = real_attn_bwd(q, k, v, o, lse, do, **kw)
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            want_g = torch.autograd.grad(block_attention_plain(ins[0], ins[1], ins[2], **kw),
                                         ins, do)
            label = (f"layer 0 (the last backward call) q{tuple(q.shape)} k/v{tuple(k.shape)} "
                     f"{kw}")
            _grads_agree(("dq", "dk", "dv"), got, want_g, tag,
                         f"{cfg.name} train pod block_attn backward {label}")
        else:
            x, dt, a_log, b, c, states, dy = args
            got = real_ssd_bwd(x, dt, a_log, b, c, states, dy, **kw)
            ins = [t.detach().requires_grad_() for t in (x, dt, a_log, b, c)]
            want_g = torch.autograd.grad(ssd_chunked_plain(*ins, kw["chunk"])[0], ins, dy)
            _grads_agree(("dx", "ddt", "da_log", "db", "dc"), got, want_g, tag,
                         f"{cfg.name} train pod ssd_scan backward layer 0 x{tuple(x.shape)} "
                         f"chunk {kw['chunk']}")
        del got, want_g, ins
    counted = {k: sum(lc[k] for lc in record["launches"]) for k in want}
    losses, norms = record["loss"], record["update_norms"]
    record.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return counted, {"ms_per_step": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
                     "peak_bytes": peak, "losses": losses, "update_norms": norms}


def _fed_pods(arch_id, pods):
    """``arch_id`` at full width drawn on the card, copied to ``pods`` pods
    (``convert.stack_pods``), each pod then scaled by its own perturbation
    1 + 0.01 N(0, 1) so that the pods differ."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.convert import stack_pods
    from repro_torch.models import transformer as T

    gen = torch.Generator("cuda").manual_seed(0)
    params = stack_pods(T.init_params(get_arch(arch_id), gen), pods, "cuda")
    for leaf in _leaves(params):
        for p in range(pods):
            leaf[p].mul_(1 + 0.01 * torch.randn(leaf.shape[1:], generator=gen, device="cuda"))
    return params


def _wire_numbers(name, rows, ms, plain_ms, differs, max_abs):
    """One kernel's line of numbers at the gossip payload, with its bound."""
    f32_planes, i8_planes, per_row, _ = WIRE_TRAFFIC[name]
    nbytes = rows * (f32_planes * LANES_BYTES + i8_planes * 128 + per_row)
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = rows * 128 * WIRE_OPS[name] / FP32_OPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    return {"rows": rows, "differs": differs, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bytes": nbytes,
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"}


def _hold_wire_pair(w2d, u2d, s_rows, n_rows, label, tag):
    """B5 (``quantize_rows``) at bits 8 and B6 (``dequantize_rows``) on the
    codes it made, each against its plain version on the same (R, 128)
    payload, uniforms and per-row (s, norm) (0 differing elements), timed
    beside its plain version and its memory bound; fails on a difference.
    Returns {kernel: its numbers}."""
    import torch

    from repro_torch.kernels.quantize import quantize as qk

    rows = w2d.shape[0]
    numbers = {}
    codes = qk.quantize_rows(w2d, u2d, s_rows, n_rows, bits=8)
    want = qk.quantize_rows_plain(w2d, u2d, s_rows, n_rows, bits=8)
    torch.cuda.synchronize()
    differs, _ = _differs(codes, want)
    del want
    ms = statistics.median(_time_ms(lambda: qk.quantize_rows(w2d, u2d, s_rows, n_rows, bits=8),
                                    iters=10) for _ in range(3))
    plain_ms = _time_ms(lambda: qk.quantize_rows_plain(w2d, u2d, s_rows, n_rows, bits=8),
                        iters=2, warmup=1)
    numbers["quantize_rows"] = _wire_numbers("quantize_rows", rows, ms, plain_ms, differs, 0.0)
    deq = qk.dequantize_rows(codes, s_rows, n_rows)
    want = qk.dequantize_rows_plain(codes, s_rows, n_rows)
    torch.cuda.synchronize()
    differs, _ = _differs(deq, want)
    max_abs = float((deq - want).abs().max())
    del deq, want
    ms = statistics.median(_time_ms(lambda: qk.dequantize_rows(codes, s_rows, n_rows), iters=10)
                           for _ in range(3))
    plain_ms = _time_ms(lambda: qk.dequantize_rows_plain(codes, s_rows, n_rows), iters=2,
                        warmup=1)
    numbers["dequantize_rows"] = _wire_numbers("dequantize_rows", rows, ms, plain_ms, differs,
                                               max_abs)
    del codes
    for name, entry in numbers.items():
        print(f"fed wire kernel {name} {tag}: {label}: differs={entry['differs']} "
              f"max|d|={entry['max_abs_err']:.3e} ms={entry['ms']:.4f} "
              f"plain_ms={entry['plain_ms']:.4f} bound_ms={entry['bound_ms']:.4f} "
              f"({entry['bytes']} bytes, {entry['bound_by']}) = "
              f"{entry['bound_ms'] / entry['ms']:.3f} of the bound")
        if entry["differs"]:
            _fail(f"{name} disagrees with its plain version at the {label}")
    return numbers


def fed_wire_phase(tag):
    """(l0) B5 (``quantize_rows``) and B6 (``dequantize_rows``) at the
    gossip payload of FED_PAYLOAD on FED_PAYLOAD_PODS pods (every leaf of
    every pod, one wire tensor a (pod, leaf)) against their plain versions
    on the card, 0 differing elements given the same (s, norm) and
    uniforms, each timed beside its plain version and its memory bound;
    then ``gossip_mix`` stacked on that payload: the launches of a gossip
    (B5 = B6 = the offsets at bits 8, none at 32), the pod mean kept at
    bits 32 within float32 rounding, and the wire bytes of a gossip against
    float32. These launches are not the fed path's. Returns {kernel: its
    numbers}."""
    import torch

    from repro_torch.core.flatten import flatten_tree, make_flat_spec, tree_leaves
    from repro_torch.dist.gossip import GossipConfig, gossip_mix, gossip_wire_bits
    from repro_torch.kernels.quantize import payload_side_info
    from repro_torch.kernels.quantize import quantize as qk

    pods = FED_PAYLOAD_PODS
    params = _fed_pods(FED_PAYLOAD, pods)
    spec = make_flat_spec(_first_pod(params))
    flat = flatten_tree(params, spec)
    w2d = flat.view(-1, 128)
    rows = w2d.shape[0]
    gen = torch.Generator("cuda").manual_seed(3)
    u2d = torch.rand(w2d.shape, generator=gen, device="cuda")
    s_rows, n_rows = payload_side_info(flat, spec, per_message=True, bits=8)
    numbers = _hold_wire_pair(
        w2d, u2d, s_rows, n_rows, f"gossip payload of {FED_PAYLOAD} x {pods} pods, "
        f"{spec.n_leaves} leaves a pod, d={spec.d} a pod ({spec.d * pods} elements, "
        f"{rows} rows)", tag)
    del u2d, flat, w2d
    torch.cuda.empty_cache()
    mean = [leaf.mean(0) for leaf in tree_leaves(params)]
    for bits in (32, 8):
        cfg = GossipConfig(quant_bits=bits)
        offsets = len(cfg.offsets(pods))
        qk.reset_launch_counts()
        mixed = gossip_mix(params, cfg, generator=gen)
        torch.cuda.synchronize()
        launches = {k: qk.LAUNCHES[k] for k in ("quantize_rows", "dequantize_rows")}
        others = sum(qk.LAUNCHES.values()) - sum(launches.values())
        want_n = offsets if bits < 32 else 0
        kept = max(float((leaf.mean(0) - m).abs().max() / m.abs().max().clamp_min(1e-30))
                   for leaf, m in zip(tree_leaves(mixed), mean))
        wire = gossip_wire_bits(spec, pods, cfg) / 8
        f32 = gossip_wire_bits(spec, pods, GossipConfig()) / 8
        print(f"fed gossip_mix {tag}: {FED_PAYLOAD} x {pods} pods ring bits={bits}: launches "
              f"{launches} (want {want_n} each), others {others}; pod mean kept within "
              f"{kept:.2e} of its largest magnitude; wire bytes a gossip {wire:.0f} "
              f"({wire / f32:.4f} of float32's {f32:.0f})")
        if launches != dict.fromkeys(launches, want_n) or others or (bits == 32 and kept > 1e-6):
            _fail(f"gossip_mix at bits {bits}: launches {launches} or the pod mean moved {kept}")
        del mixed
    del params, mean
    gc.collect()
    torch.cuda.empty_cache()
    return numbers


def _first_pod(tree):
    if isinstance(tree, dict):
        return {k: _first_pod(v) for k, v in tree.items()}
    return tree[0]


def fed_gossip_card_vs_cpu(tag):
    """(l0) ``gossip_mix`` stacked at SMOKE size on the card and on the CPU
    with the same uniforms, at bits 32 (bit for bit) and 8: within one grid
    cell times the mixing weight an offset, where a norm summed in another
    order rounds a code the other way, on at most FED_SHARE of the elements
    beyond 1e-6 of their leaf's largest magnitude (that norm's ulp moves
    every element of its wire tensor by about an ulp)."""
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.convert import stack_pods
    from repro_torch.core.flatten import tree_leaves
    from repro_torch.dist.gossip import GossipConfig, gossip_mix, mixing_weights
    from repro_torch.models import transformer as T

    pods = 4
    base = T.init_params(get_smoke("yi-6b"), torch.Generator().manual_seed(0), device="cpu")
    on_cpu = stack_pods(base, pods, "cpu")
    gen = torch.Generator().manual_seed(1)
    for leaf in _leaves(on_cpu):
        leaf.mul_(1 + 0.05 * torch.randn(leaf.shape, generator=gen))
    on_card = _tree_to(on_cpu, "cuda")
    shapes = [leaf.shape[1:] for leaf in tree_leaves(on_cpu)]

    def uniforms(li, oi, pod):
        g = torch.Generator().manual_seed(1000 * li + 100 * oi + pod)
        return torch.rand(shapes[li], generator=g)

    for topo in ("ring", "all"):
        for bits in (32, 8):
            cfg = GossipConfig(topology=topo, quant_bits=bits)
            got = gossip_mix(on_card, cfg, uniforms=uniforms)
            want = gossip_mix(on_cpu, cfg, uniforms=uniforms)
            w = mixing_weights(pods, cfg)[1][1] * len(cfg.offsets(pods))
            worst, differ, moved, total = 0.0, 0, 0, 0
            for g_leaf, w_leaf in zip(tree_leaves(got), tree_leaves(want)):
                d = (g_leaf.cpu() - w_leaf).abs()
                scale = float(w_leaf.abs().max())
                worst = max(worst, float(d.max()) / (scale / 127 * w) if bits < 32
                            else float(d.max()))
                differ += int((d > 0).sum())
                moved += int((d > 1e-6 * scale).sum())
                total += d.numel()
            print(f"fed gossip_mix SMOKE yi-6b x {pods} pods {topo} bits={bits} {tag}: card vs "
                  f"CPU {'max|d|' if bits == 32 else 'max|d| in grid cells x weights'} "
                  f"{worst:.3e}; of {total} elements {differ} differ, {moved} by more than "
                  f"1e-6 of their leaf's largest magnitude (a code rounded the other way)")
            if (bits == 32 and differ) or worst > 1 + 1e-5 or moved > FED_SHARE * total:
                _fail(f"gossip_mix {topo} bits {bits}: the card and the CPU disagree")


def fed_pod_run(arch_id, pods, bsz, seq, steps, bits, tag, profile=True):
    """(l1, l2) ``launch.train pod --fed`` at full width through
    ``launch_main``: ``pods`` pods stacked on the card, float32, no remat,
    gossip every step on the ring at ``bits``. Each step is timed (host
    clock, synchronized), and so is its gossip (``dist.steps.mix_into``);
    its kernel launches are counted; with ``profile`` the last step runs
    under the profiler. Returns ({kernel: launches over the steps}, the
    run's numbers, each step's loss among them)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.flatten import make_flat_spec
    from repro_torch.dist import steps as dist_steps
    from repro_torch.dist.gossip import GossipConfig, gossip_wire_bits
    from repro_torch.kernels.block_attn import block_attn as ba
    from repro_torch.kernels.quantize import quantize as qk
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.launch.train import main as launch_main
    from repro_torch.models import transformer as T

    cfg = get_arch(arch_id)
    calls = _kernel_calls(cfg)
    offsets = len(GossipConfig().offsets(pods))
    wire_n = offsets if bits < 32 else 0
    want = {"block_attn": pods * calls["block_attn"], "ssd_scan": pods * calls["ssd_scan"],
            **dict.fromkeys(ba.BWD_LAUNCHES, pods * calls["block_attn"]),
            **dict.fromkeys(sk.BWD_STAGES, pods * calls["ssd_scan"]),
            "quantize_rows": wire_n, "dequantize_rows": wire_n}
    record = {"ms": [], "gossip_ms": [], "loss": [], "launches": []}
    real_make, real_mix = dist_steps.make_fed_train_step, dist_steps.mix_into

    def timed_mix(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_mix(*args, **kw)
        torch.cuda.synchronize()
        record["gossip_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def timed_make(cfg_, mesh, gossip, **kw):
        step_fn, p_specs, fed_abstract = real_make(cfg_, mesh, gossip, **kw)

        def timed(params, vel, batch, step, **kw_):
            out = None

            def run():
                nonlocal out
                out = step_fn(params, vel, batch, step, **kw_)

            for module in (ba, sk, qk):
                module.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if profile and step == steps - 1:
                _profile(f"{cfg_.name} fed step {pods} pods {bsz}x{seq} bits={bits} {tag}", run)
            else:
                run()
            torch.cuda.synchronize()
            record["ms"].append((time.perf_counter() - t0) * 1e3)
            record["loss"].append(float(out[2]))
            record["launches"].append({
                "block_attn": ba.LAUNCHES["block_attn"], "ssd_scan": sk.LAUNCHES["ssd_scan"],
                **ba.BWD_LAUNCHES, **sk.BWD_LAUNCHES,
                "quantize_rows": qk.LAUNCHES["quantize_rows"],
                "dequantize_rows": qk.LAUNCHES["dequantize_rows"]})
            return out

        return timed, p_specs, fed_abstract

    dist_steps.make_fed_train_step, dist_steps.mix_into = timed_make, timed_mix
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            launch_main(["pod", "--arch", arch_id, "--fed", "--pods", str(pods), "--batch",
                         str(bsz), "--seq", str(seq), "--steps", str(steps), "--bits", str(bits),
                         "--gossip-every", "1"])
    finally:
        dist_steps.make_fed_train_step, dist_steps.mix_into = real_make, real_mix
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    printed = out.getvalue().strip().splitlines()
    print("\n".join(f"  launcher: {line}" for line in printed))
    spread = float(printed[-1].split("=")[1].rstrip(")"))
    spec = make_flat_spec(T.abstract_params(cfg, torch.float32))
    wire = gossip_wire_bits(spec, pods, GossipConfig(quant_bits=bits)) / 8
    f32 = gossip_wire_bits(spec, pods, GossipConfig()) / 8
    step_ms = statistics.median(record["ms"][1:-1] or record["ms"][1:])
    gossip_ms = statistics.median(record["gossip_ms"][1:])
    n_front = cfg.frontend_tokens if cfg.frontend != "none" else 0
    tokens = pods * bsz * (seq + n_front)
    print(f"{cfg.name} train pod --fed {tag}: --pods {pods} --batch {bsz} --seq {seq} --steps "
          f"{steps} --bits {bits} --gossip-every 1 (ring, {offsets} offsets; n_layers "
          f"{cfg.n_layers}{f', {n_front} stub embeddings' if n_front else ''}; float32, no "
          f"remat, TF32 off): ms/step median after the first={step_ms:.2f} "
          f"all={[round(x, 2) for x in record['ms']]}{' (the last profiled)' * profile} "
          f"gossip ms median "
          f"after the first={gossip_ms:.3f} all={[round(x, 3) for x in record['gossip_ms']]} "
          f"training tokens/s={tokens / step_ms * 1e3:.1f} losses="
          f"{[round(x, 5) for x in record['loss']]} inter-pod spread={spread} wire bytes a "
          f"gossip={wire:.0f} ({wire / f32:.4f} of float32's {f32:.0f}) "
          f"peak_memory_allocated={peak} bytes; launcher wall {wall:.1f}s; launches a step "
          f"{record['launches'][0]} (want {want})")
    if (not all(math.isfinite(x) for x in record["loss"]) or len(record["ms"]) != steps
            or any(lc != want for lc in record["launches"]) or not math.isfinite(spread)):
        _fail(f"train pod --fed {arch_id} bits {bits}: losses {record['loss']} or launches "
              f"{record['launches']} (want {want} a step)")
    counted = {k: sum(lc[k] for lc in record["launches"]) for k in want}
    gc.collect()
    torch.cuda.empty_cache()
    return counted, {"ms_per_step": step_ms, "gossip_ms": gossip_ms, "wire_bytes": wire,
                     "float32_wire_bytes": f32, "peak_bytes": peak, "spread": spread,
                     "tokens_per_s": tokens / step_ms * 1e3, "losses": record["loss"]}


def fed_scheduled_phase(tag):
    """(l3) The scheduled federated step driven by ``gossip_flags()`` of a
    short trace recorded by the port's simulator on the card. On the CPU,
    with its deterministic kernels, it equals the static step of period
    k_walk bit for bit. On the card it gossips at the same steps as the
    static step, and both are held against the CPU: losses within
    TRAIN_LOSS_TOL, each leaf within TRAIN_TOL of its largest magnitude plus
    a grid cell a gossip offset where a wire code rounded the other way
    (at most FED_SHARE of the elements beyond TRAIN_TOL). Two card runs are
    not bit for bit: B9b's dB/dC and B10b's dQ add by float32 atomics in
    run-to-run order."""
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.convert import stack_pods
    from repro_torch.core.flatten import tree_leaves
    from repro_torch.dist import GossipConfig, make_fed_train_step, mixing_weights
    from repro_torch.dist import steps as dist_steps
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import momentum_init
    from repro_torch.sim import build_scenario

    setup = build_scenario("straggler_tail", n=12, seed=0, bits=8)
    trace = setup.runner(device="cuda").run(
        FED_TRACE_WINDOWS, torch.Generator().manual_seed(0), record=True).trace
    flags = trace.gossip_flags()
    k = trace.header["k_walk"]
    cfg, pods = get_smoke(FED_SMOKE), FED_SMOKE_PODS
    gossip = GossipConfig(every=k, quant_bits=8)
    base = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, cfg.vocab, size=(pods, 2, 65)) for _ in flags]
    real_mix = dist_steps.mix_into

    def run(device, scheduled):
        dev = torch.device(device)
        step_fn, _, _ = make_fed_train_step(cfg, make_pod_mesh(pods, device=dev), gossip,
                                            lr_r=20.0, remat=False, scheduled=scheduled)
        params = stack_pods(base, pods, dev)
        vel = momentum_init(params).velocity
        shapes = [leaf.shape[1:] for leaf in tree_leaves(params)]
        losses, gossiped = [], []

        def counted(*args, **kw):
            gossiped[-1] = True
            return real_mix(*args, **kw)

        dist_steps.mix_into = counted
        try:
            for step, (toks, flag) in enumerate(zip(batches, flags)):
                def uniforms(li, oi, pod, step=step):
                    g = torch.Generator().manual_seed(10 ** 6 * step + 1000 * li + 100 * oi + pod)
                    return torch.rand(shapes[li], generator=g)
                batch = {"tokens": torch.as_tensor(toks[..., :-1], device=dev),
                         "labels": torch.as_tensor(toks[..., 1:], device=dev)}
                gossiped.append(False)
                extra = (bool(flag),) if scheduled else ()
                params, vel, loss = step_fn(params, vel, batch, step, *extra, uniforms=uniforms)
                losses.append(float(loss))
        finally:
            dist_steps.mix_into = real_mix
        return losses, params, gossiped

    def held(got, want):
        """(losses rel, the largest leaf's share of its bound, elements beyond TRAIN_TOL,
        elements)."""
        loss_r = max(abs(a - b) / abs(b) for a, b in zip(got[0], want[0]))
        worst, moved, total = 0.0, 0, 0
        for g, w in zip(tree_leaves(got[1]), tree_leaves(want[1])):
            d = (g.cpu() - w.cpu()).abs()
            scale = float(w.abs().max())
            worst = max(worst, float(d.max()) / (TRAIN_TOL * scale + per_cell * scale / 127))
            moved += int((d > TRAIN_TOL * scale).sum())
            total += d.numel()
        return loss_r, worst, moved, total

    per_cell = int(flags.sum()) * len(gossip.offsets(pods)) * mixing_weights(pods, gossip)[1][1]
    torch.use_deterministic_algorithms(True)
    try:
        cpu_sched, cpu_static = run("cpu", True), run("cpu", False)
    finally:
        torch.use_deterministic_algorithms(False)
    card_sched, card_static = run("cuda", True), run("cuda", False)
    cpu_equal = cpu_sched[0] == cpu_static[0] and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(cpu_sched[1]), tree_leaves(cpu_static[1])))
    same_steps = (card_sched[2] == card_static[2] == cpu_sched[2] == cpu_static[2]
                  == [bool(f) for f in flags])
    checks = {"card scheduled vs CPU": held(card_sched, cpu_sched),
              "card static vs CPU": held(card_static, cpu_sched),
              "card scheduled vs card static": held(card_sched, card_static)}
    print(f"fed scheduled {tag}: {FED_SMOKE} SMOKE x {pods} pods, bits 8, {len(flags)} steps on "
          f"gossip_flags() of {FED_TRACE_WINDOWS} windows recorded on the card (k_walk {k}, "
          f"gossips at steps {[i for i, f in enumerate(flags) if f]}): scheduled == static "
          f"every {k} on the CPU bit for bit: {cpu_equal}; the same gossip steps on both "
          f"devices: {same_steps}; " + "; ".join(
              f"{label}: losses rel {r:.2e}, leaves at most {w:.3f} of their bound, {m} of {t} "
              f"beyond TRAIN_TOL" for label, (r, w, m, t) in checks.items()))
    if not (cpu_equal and same_steps) or any(
            r > TRAIN_LOSS_TOL or w > 1 or m > FED_SHARE * t for r, w, m, t in checks.values()):
        _fail("the scheduled federated step disagrees with the static one or with the CPU")


def _launcher_lines(cmd, label, timeout):
    """Run a launcher of the port (``python -m ...``) in a process of its own
    from this checkout's root with this checkout's ``src`` first on its
    path; echo its output; fail on a non-zero exit. Returns its stdout."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(root, "src")] + [
        p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *cmd], cwd=root, env=env, capture_output=True,
                          text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        print(f"{label}: {line}")
    print(f"{label}: exit {proc.returncode} in {wall:.1f} s")
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        _fail(f"{label}: exit code {proc.returncode}")
    return proc.stdout


def _metal_replay_run(trace_path, extra, label, want_launches, tag, timeout=600):
    """``python -m repro_torch.launch.replay --trace T --processes 2 --check``
    (and ``extra``) on the card: both workers share it. Fails unless it
    exits 0, both ranks print equal digests, the conformance check passes
    and each rank's launches (its own process, counted from 0, before the
    check) are ``want_launches``. Returns {rank: timing}, the conformance
    line and the fault lines."""
    out = _launcher_lines(["repro_torch.launch.replay", "--trace", trace_path, "--processes",
                           "2", "--check", *extra], f"metal {tag} {label}", timeout)
    digests = dict(re.findall(r"metal\[(\d)\]: shards agree digest=(\w+)", out))
    timing = {int(r): json.loads(t) for r, t in re.findall(r"metal\[(\d)\]: timing (.*)", out)}
    conform = [ln for ln in out.splitlines() if ln.startswith("conformance:")]
    if sorted(digests) != ["0", "1"] or len(set(digests.values())) != 1:
        _fail(f"metal {label}: the ranks' digests differ or are missing: {digests}")
    if len(conform) != 1 or not conform[0].endswith("-> OK"):
        _fail(f"metal {label}: conformance {conform}")
    for rank, t in timing.items():
        if want_launches is not None and t["launches"] != want_launches:
            _fail(f"metal {label}: rank {rank} launched {t['launches']}, want {want_launches}")
    if sorted(timing) != [0, 1]:
        _fail(f"metal {label}: timing lines of ranks {sorted(timing)}")
    faults = [ln for ln in out.splitlines() if "faults verified" in ln]
    return timing, conform[0], faults


def metal_phase(smi, device="cuda"):
    """(m) The sim-to-metal deployment (``repro_torch.sim.metal``,
    ``launch.replay``) on the card, the counts from 0 before each metal run:

    (m1) ``straggler_tail`` at n = METAL_N (the scenario's 2NN, d = 79,510,
        M = K = 5), bits 32 and 8, METAL_WINDOWS windows recorded on the
        card, then replayed in process: one position bit for bit the
        recorded run; METAL_POSITIONS positions on the one card (one chain
        each; two would run as one, the divisor rule) bit for bit or within
        ``CHAIN_SLICE_TOL`` at bits 32, within METAL_TOLERANCE x the
        simulator's spread under other seed words at bits 8; K B1 launches a
        position and one B2 launch a quantized window; B1's hop and B2's
        aggregation payload of the first quantized window against their
        plain versions; ``churn_dropout`` under ``FaultInjector``, bit for
        bit with the counters;
    (m2) (m1)'s fp32 trace through ``launch.replay --processes 2 --check``:
        two workers on the one card, equal digests, conformance 0.0;
    (m3) ``fleet_metro`` at n = METAL_FLEET_N, bits 8, METAL_FLEET_WINDOWS
        windows, recorded with ``launch.sim --engine fleet --record``, then
        ``launch.replay --processes 2 --check --fault-inject``: ms a window
        on each rank, the exchange's ms and bytes, peak memory, conformance
        and the fault counters.

    Returns the in-process metal runs' launches by kernel, the workers'
    launches by kernel, and the numbers of (m3). ``device="cpu"`` rehearses
    the phase without a card at a cut ``METAL_FLEET_N`` (the workers are
    processes of their own, which no patch of this one reaches)."""
    import numpy as np
    import torch

    from repro_torch.core import DFedRW
    from repro_torch.kernels.quantize import ops
    from repro_torch.kernels.quantize import quantize as qk
    from repro_torch.launch.sim import main as sim_main
    from repro_torch.sim import (CHAIN_SLICE_TOL, FaultInjector, MetalReplay, build_scenario,
                                 conformance_diff)

    tag = f"[{smi}]"
    counts = dict.fromkeys(qk.LAUNCHES, 0)
    worker_counts = dict.fromkeys(qk.LAUNCHES, 0)

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    def metal_run(setup, trace, positions, label, windows_q, fault=None, keep=None):
        engine = DFedRW(setup.model, setup.data, setup.topo, setup.cfg, device=device)
        metal = MetalReplay(engine, devices=[device] * positions)
        real = (ops.qdq_delta_rows_rng, ops.qdq_rows_rng)
        if keep is not None:
            ops.qdq_delta_rows_rng = _capture_first(keep, "qdq_delta_rows_rng", real[0])
            ops.qdq_rows_rng = _capture_first(keep, "qdq_rows_rng", real[1])
        sync()
        qk.reset_launch_counts()
        try:
            res = metal.run(trace, torch.Generator().manual_seed(METAL_KEY), setup.x_test,
                            setup.y_test, eval_every=METAL_WINDOWS, fault=fault)
        finally:
            ops.qdq_delta_rows_rng, ops.qdq_rows_rng = real
        sync()
        got = dict(qk.LAUNCHES)
        want = dict.fromkeys(qk.LAUNCHES, 0)
        want.update(qdq_delta_rows_rng=setup.cfg.k_walk * metal.positions_used * windows_q,
                    qdq_rows_rng=windows_q)
        if got != want and device != "cpu":       # the CPU takes the plain versions
            _fail(f"metal {label}: launches {got}, want {want}")
        for name, n in got.items():
            counts[name] += n
        ms = [t["window_ms"] for t in metal.timings]
        print(f"metal {tag} {label}: positions={metal.positions_used} ms/window "
              f"{[round(v, 2) for v in ms]} loss={[round(v, 5) for v in res.history.train_loss]} "
              f"acc={[round(v, 4) for v in res.history.test_accuracy]} launches={got}")
        return res

    def record(scenario, bits):
        setup = build_scenario(scenario, n=METAL_N, seed=0, bits=bits, rounds=METAL_WINDOWS)
        runner = setup.runner(device=device)
        sim = runner.run(METAL_WINDOWS, torch.Generator().manual_seed(METAL_KEY), setup.x_test,
                         setup.y_test, eval_every=METAL_WINDOWS, record=True)
        sim.trace.header.update(scenario=scenario, build_seed=0, key_seed=METAL_KEY,
                                eval_every=METAL_WINDOWS,
                                build_overrides={"bits": bits, "rounds": METAL_WINDOWS})
        return setup, runner, sim

    # ------------------------------------------------------------------- (m1)
    traces = {}
    for bits in (32, 8):
        setup, runner, sim = record("straggler_tail", bits)
        k = setup.cfg.k_walk
        wq = METAL_WINDOWS if bits < 32 else 0
        kept = {} if bits < 32 else None
        one = metal_run(setup, sim.trace, 1, f"straggler_tail n={METAL_N} bits={bits} "
                        "one position", wq, keep=kept)
        if not (torch.equal(one.state.device_params, sim.state.device_params)
                and one.history.train_loss == sim.history.train_loss
                and one.history.comm_bits == sim.history.comm_bits):
            _fail(f"metal straggler_tail bits={bits}: one position is not the recorded run "
                  f"bit for bit (max|d|={conformance_diff(sim, one):.3e})")
        many = metal_run(setup, sim.trace, METAL_POSITIONS, f"straggler_tail n={METAL_N} "
                         f"bits={bits} {METAL_POSITIONS} positions", wq)
        diff = conformance_diff(sim, many)
        scale = float(sim.state.device_params.abs().max())
        if bits == 32:
            tol = CHAIN_SLICE_TOL["atol"] + CHAIN_SLICE_TOL["rtol"] * scale
            basis = "chain-slice bound atol {atol} + rtol {rtol} x max|w|".format(
                **CHAIN_SLICE_TOL)
        else:
            params = setup.model.init(torch.Generator().manual_seed(METAL_KEY),
                                      runner.engine.device)
            alt = setup.runner(device=device).replay(
                sim.trace, torch.Generator().manual_seed(METAL_KEY + 104729), params=params)
            spread = conformance_diff(sim, alt)
            tol = METAL_TOLERANCE * spread
            basis = f"{METAL_TOLERANCE}x the simulator's other-words spread {spread:.3e}"
        print(f"metal {tag} straggler_tail bits={bits}: one position bit for bit; "
              f"{METAL_POSITIONS} positions max|d|={diff:.3e} ({diff / scale:.3e} of "
              f"max|w| {scale:.4f}; bit for bit: {diff == 0.0}) tolerance={tol:.3e} ({basis})")
        if not diff <= tol or not torch.isfinite(many.state.device_params).all():
            _fail(f"metal straggler_tail bits={bits}: {METAL_POSITIONS} positions "
                  f"max|d|={diff:.3e} > {tol:.3e}")
        if bits < 32:
            spec = runner.engine.flat_spec
            for name, rows in (("qdq_delta_rows_rng", setup.cfg.m_chains * spec.rows),
                               ("qdq_rows_rng", k * setup.cfg.m_chains * spec.rows)):
                args, kw = kept[name]
                if args[0].shape[0] != rows:
                    _fail(f"metal: the {name} payload has {args[0].shape[0]} rows, want {rows}")
                if device != "cpu":
                    _hold_kernel(name, args, kw["bits"], f"metal straggler_tail n={METAL_N}")
        traces[bits] = (setup, sim)

    setup, runner, sim = record("churn_dropout", 32)
    fault = FaultInjector(policy=setup.sim.policy)
    res = metal_run(setup, sim.trace, 1, f"churn_dropout n={METAL_N} fault-injected", 0,
                    fault=fault)
    print(f"metal {tag} churn_dropout: faults verified stalls={fault.stalls_injected} "
          f"steps_stalled={fault.steps_stalled} aggregators_dropped={fault.aggregators_dropped}"
          f" max|d|={conformance_diff(sim, res):.3e}")
    if not torch.equal(res.state.device_params, sim.state.device_params) or not (
            fault.stalls_injected and fault.steps_stalled):
        _fail("metal churn_dropout: the fault-injected replay is not the recorded run")
    del runner, sim, res

    # ------------------------------------------------------------------- (m2)
    workdir = tempfile.mkdtemp(prefix="metal_")
    fp32 = os.path.join(workdir, "straggler_tail_fp32.jsonl")
    traces[32][1].trace.save(fp32)
    dev_flag = ["--device", device]
    timing, conform, _ = _metal_replay_run(fp32, dev_flag, "m2 straggler_tail bits=32 x2",
                                           dict.fromkeys(qk.LAUNCHES, 0), tag)
    for rank, t in sorted(timing.items()):
        print(f"metal {tag} m2 rank {rank}: ms/window {[round(v, 2) for v in t['window_ms']]} "
              f"exchange ms {[round(v, 2) for v in t['exchange_ms']]} exchange bytes "
              f"{t['exchange_bytes']}")
    if "max_abs_diff=0.000e+00" not in conform:
        _fail(f"metal m2: the two-process fp32 run is not the simulator bit for bit: {conform}")
    del traces
    gc.collect()

    # ------------------------------------------------------------------- (m3)
    big = os.path.join(workdir, "fleet_metro.jsonl")
    t0 = time.perf_counter()
    qk.reset_launch_counts()
    sim_main(["--scenario", "fleet_metro", "--engine", "fleet", "--n", str(METAL_FLEET_N),
              "--rounds", str(METAL_FLEET_WINDOWS), "--bits", "8", "--eval-every",
              str(METAL_FLEET_WINDOWS), "--record", big, "--device", device])
    sync()
    recorded = dict(qk.LAUNCHES)
    print(f"metal {tag} m3: fleet_metro n={METAL_FLEET_N} recorded in "
          f"{time.perf_counter() - t0:.1f} s ({os.path.getsize(big)} bytes of trace), "
          f"launches {recorded}")
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    k = 8
    want = dict.fromkeys(qk.LAUNCHES, 0)
    want.update(qdq_delta_rows_rng=k * METAL_FLEET_WINDOWS, qdq_rows_rng=METAL_FLEET_WINDOWS)
    timing, conform, faults = _metal_replay_run(
        big, ["--fault-inject", *dev_flag], f"m3 fleet_metro n={METAL_FLEET_N} bits=8 x2",
        want if device != "cpu" else None, tag, timeout=900)
    for rank, t in sorted(timing.items()):
        for name, n in t["launches"].items():
            worker_counts[name] += n
        print(f"metal {tag} m3 rank {rank}: ms/window {[round(v, 1) for v in t['window_ms']]} "
              f"exchange ms {[round(v, 1) for v in t['exchange_ms']]} exchange bytes "
              f"{t['exchange_bytes']} sent {t['bytes_sent']} received {t['bytes_received']} "
              f"peak device {t.get('peak_device_bytes')} host rss {t['peak_rss_bytes']}")
    summary = {"ranks": timing, "conformance": conform, "faults": faults}
    print(f"metal summary {tag}: {json.dumps(summary)}")
    for path in (fp32, big):
        os.remove(path)
    os.rmdir(workdir)
    return counts, worker_counts, summary


def _timed_steps(eng):
    """Wrap the engine's two step methods (the step call and the sampling
    of its tokens, as ``launch.serve``'s ranks time them): each call timed
    with the card synchronised before and after. Returns {"decode": [ms],
    "prefill": [ms]}."""
    import torch

    calls = {"decode": [], "prefill": []}

    def timed(fn, kind):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            calls[kind].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    eng._decode = timed(eng._decode, "decode")
    eng._prefill = timed(eng._prefill, "prefill")
    return calls


def _rank_heads(q, k, v, ranks=TP_RANKS):
    """Rank 0's share of an attention call on a model axis of ``ranks``: its
    H/ranks query heads and KV/ranks K/V heads, laid out as the rank's own
    projections give them (contiguous)."""
    return (q[:, :, :q.shape[2] // ranks].contiguous(),
            k[:, :, :k.shape[2] // ranks].contiguous(),
            v[:, :, :v.shape[2] // ranks].contiguous())


def _layer0_qkv(cfg, params, prompt):
    """Layer 0's own q/k/v (RoPE applied) over one prompt, whole heads."""
    import torch

    from repro_torch.models import layers as L

    p = {key: leaf[0] for key, leaf in params["blocks"]["slot0"]["mixer"].items()}
    tokens = torch.as_tensor(prompt, device="cuda")[None]
    with torch.inference_mode():
        x = L.rms_norm(params["embed"][tokens], params["blocks"]["slot0"]["norm1"][0],
                       cfg.norm_eps)
        q, k, v = L._qkv(L._heads(p, cfg), x, cfg)
        cos, sin = L.rope_freqs(torch.arange(tokens.shape[1], device="cuda"), cfg.head_dim_,
                                cfg.rope_theta)
        return L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin), v


def tp_serve_run(run, smi):
    """(n) One of TP_RUNS: the workload served unsharded here (bf16, weights
    drawn on the card from seed 0, each step timed, each step's top-2 logit
    gaps kept, B10's first call of each serve mode kept), B10 held against
    its plain version on rank 0's share of those calls (and of Yi's layer 0
    over the longest prompt: Yi serves through no B10 call) beside the
    whole-head call; then, the weights freed, ``launch.serve --full
    --mesh-model TP_RANKS`` under torchrun, its ranks on this card. Fails
    unless both ranks end with equal digests, on gloo, with rank 0's token
    streams equal to the unsharded ones up to a bf16 near-tie (at the first
    difference, the top-2 logit gap in either run below BF16_TIE times the
    unsharded top logit, as :func:`serve_phase` holds the engine),
    the unsharded counters, and B10 launched as the engine's modes want on
    each rank. Returns ({path: float32 launches}, {path: bf16 launches},
    {mode: entry} float32, {mode: entry} bf16, the run's numbers, and the
    unsharded run for phase (p): its token streams, margins, counters and
    B10's first cross calls)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.block_attn import ops as attn_ops
    from repro_torch.serve import ServeEngine

    tag = f"[{smi}]"
    arch, requests, slots, prompt_len, gen, chunk, arrival = run
    cfg = get_arch(arch)
    params, _ = _init_on_card(cfg, tag, " (n) unsharded", dtype=torch.bfloat16)
    reqs = _serve_workload(run, cfg)
    eng = ServeEngine(cfg, params, _serve_config(run, torch.bfloat16), margins=True)
    steps = _timed_steps(eng)
    first = {}
    real_attn = attn_ops.block_attention

    def attn_spy(q, k, v, **kw):
        mode = ("decode_cross" if q.shape[1] == 1 else "encoder" if q.shape[0] == 1
                else "prefill_cross")
        first.setdefault(mode, (q, k, v, kw))
        return real_attn(q, k, v, **kw)

    attn_ops.block_attention = attn_spy
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        results = eng.run(reqs)
    finally:
        attn_ops.block_attention = real_attn
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counters = _serve_counters(eng)
    unsharded = {"wall_s": wall, "decode_ms": statistics.median(steps["decode"]),
                 "prefill_ms": statistics.median(steps["prefill"]),
                 "peak_memory_allocated": torch.cuda.max_memory_allocated(),
                 "digest": eng.digest, **counters}
    print(f"tp {arch} {tag}: unsharded bf16, {len(reqs)} requests, {slots} slots, chunk "
          f"{eng.chunk}: {unsharded}")
    want_tokens = {st.request.rid: st.generated for st in results}
    margins = eng.margins

    modes16, modes32 = {}, {}
    first_calls = dict(first)
    calls = dict(first)
    if not cfg.enc_dec:
        longest = max(reqs, key=lambda r: len(r.prompt))
        calls["layer0"] = (*_layer0_qkv(cfg, params, longest.prompt), {"causal": True})
    for mode, (q, k, v, kw) in calls.items():
        for share, qkv in (("whole heads", (q, k, v)), (f"rank 0 of {TP_RANKS}",
                                                       _rank_heads(q, k, v))):
            entry = _hold_attn_mode(f"(n) {arch} {mode}, {share}", *qkv, kw["causal"], tag)
            entry["heads"] = share
            key = f"tp{TP_RANKS} {arch} {mode} {'local' if share != 'whole heads' else 'whole'}"
            (modes16 if qkv[0].dtype == torch.bfloat16 else modes32)[key] = entry
    first.clear()
    calls.clear()
    del eng, params, results
    gc.collect()
    torch.cuda.empty_cache()
    print(f"tp {arch} {tag}: the unsharded model freed, memory_allocated="
          f"{torch.cuda.memory_allocated()} bytes")

    reference = {"tokens": want_tokens, "margins": margins, "counters": counters,
                 "calls": {mode: first_calls[mode] for mode in ("prefill_cross", "decode_cross")
                           if mode in first_calls}}
    timing, flips, sharded_counters, digests = _mesh_serve_launch(
        run, TP_RANKS, TP_RANKS, f"tp {arch}", reference, tag, TP_TIMEOUT)
    want_f32 = cfg.n_enc_layers * len(reqs) if cfg.enc_dec else 0
    want_bf16 = (cfg.n_blocks * (counters["prefill_chunks"] + counters["decode_steps"])
                 if cfg.enc_dec else 0)
    f32_paths, bf16_paths = {}, {}
    for rank, t in sorted(timing.items()):
        f32 = t["block_attn_launches"] - t["block_attn_bf16_launches"]
        if f32 != want_f32 or t["block_attn_bf16_launches"] != want_bf16:
            _fail(f"tp {arch}: rank {rank} launched block_attn {f32} + "
                  f"{t['block_attn_bf16_launches']} times, want {want_f32} + {want_bf16}")
        f32_paths[f"{arch} serve tp{TP_RANKS} rank {rank}"] = f32
        bf16_paths[f"{arch} serve tp{TP_RANKS} rank {rank} bf16"] = \
            t["block_attn_bf16_launches"]
    stats = {"unsharded": unsharded, "ranks": timing, "flips": flips,
             "digest": digests[0], "counters": sharded_counters}
    return f32_paths, bf16_paths, modes32, modes16, stats, reference


def tp_phase(smi):
    """(n) Tensor-parallel serving: :func:`tp_serve_run` for each of
    TP_RUNS. Returns the merged ({path: float32 launches}, {path: bf16
    launches}, float32 modes, bf16 modes, {arch: numbers}, {arch: unsharded
    run})."""
    merged = ({}, {}, {}, {}, {}, {})
    for run in TP_RUNS:
        *parts, stats, reference = tp_serve_run(run, smi)
        for into, part in zip(merged, parts):
            into.update(part)
        merged[4][run[0]] = stats
        merged[5][run[0]] = reference
        gc.collect()
    print(f"tp summary [{smi}]: {json.dumps(merged[4])}")
    return merged


def _mesh_serve_launch(run, nproc, mesh_model, label, reference, tag, timeout):
    """``launch.serve --full --mesh-model mesh_model`` under ``torchrun
    --nproc-per-node nproc`` on ``run``'s workload, its ranks on this card,
    a (nproc / mesh_model, mesh_model) mesh. Fails unless every rank prints
    its lines on that mesh, the digests are equal on every rank, ranks that
    share the card use gloo, the counters are ``reference``'s and each
    token stream is ``reference``'s up to a bf16 near-tie (at the first
    difference, the top-2 logit gap in either run below BF16_TIE times the
    unsharded top logit). Prints each rank's step times, each axis's
    collectives a step, peak memory and B10's launches. Returns ({rank:
    timing}, the flips, the counters, {rank: digest})."""
    import torch

    arch, requests, slots, prompt_len, gen, chunk, arrival = run
    workdir = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    tokens_path, json_path = (os.path.join(workdir, name) for name in ("tokens", "summary"))
    out = _launcher_lines(
        ["torch.distributed.run", "--standalone", "--nproc-per-node", str(nproc),
         "-m", "repro_torch.launch.serve", "--arch", arch, "--full", "--mesh-model",
         str(mesh_model), "--requests", str(requests), "--max-concurrency", str(slots),
         "--prompt-len", str(prompt_len), "--gen", str(gen), "--chunk", str(chunk),
         "--arrival", str(arrival), "--mixed", "--tokens", tokens_path, "--json", json_path],
        label, timeout)
    with open(tokens_path) as f:
        served = {int(rid): got for rid, got in json.load(f).items()}
    with open(json_path) as f:
        summary = json.load(f)
    for path in (tokens_path, json_path):
        os.remove(path)
    os.rmdir(workdir)
    mesh = f"{{'data': {nproc // mesh_model}, 'model': {mesh_model}}}"
    heads = {int(r): (b, m, d) for r, b, m, d in re.findall(
        r"rank (\d+): backend=(\w+) mesh=(\{.*?\}) device=(\S+)", out)}
    timing = {int(r): json.loads(t) for r, t in re.findall(r"rank (\d+): timing (.*)", out)}
    digests = {int(r): d for r, d in re.findall(r"rank (\d+): digest=(\w+)", out)}
    ranks = list(range(nproc))
    if sorted(heads) != ranks or sorted(timing) != ranks or sorted(digests) != ranks:
        _fail(f"{label}: the launcher's rank lines are missing: {heads}, timing "
              f"{sorted(timing)}, digests {digests}")
    one_card = torch.cuda.device_count() < nproc
    if len(set(digests.values())) != 1 or any(m != mesh for _, m, _ in heads.values()) or (
            one_card and {b for b, _, _ in heads.values()} != {"gloo"}):
        _fail(f"{label}: digests {digests}, ranks {heads} (want the mesh {mesh})")
    counters = {key: summary[key] for key in SERVE_COUNTERS}
    if counters != reference["counters"]:
        _fail(f"{label}: counters {counters}, unsharded {reference['counters']}")
    flips = []
    for rid, want in reference["tokens"].items():
        got = served.get(rid, {}).get("tokens")
        if got == want:
            continue
        diff = next((i for i, (a, b) in enumerate(zip(got or [], want)) if a != b), None)
        if got is None or diff is None:
            _fail(f"{label}: request {rid} served {got}, unsharded {want}")
        gap, top = reference["margins"][rid][diff]
        sharded_gap = served[rid]["margins"][diff][0]
        flips.append({"rid": rid, "at": diff, "gap": gap, "sharded_gap": sharded_gap,
                      "limit": BF16_TIE * top})
        if min(gap, sharded_gap) >= BF16_TIE * top:
            _fail(f"{label}: request {rid} differs at token {diff} away from a near-tie "
                  f"(top-2 gaps {gap:.4e} unsharded, {sharded_gap:.4e} sharded; limit "
                  f"{BF16_TIE * top:.4e})")
    for rank, t in sorted(timing.items()):
        f32 = t["block_attn_launches"] - t["block_attn_bf16_launches"]
        axes = "; ".join(
            f"{kind} {t[kind]['ms']:.2f} ms, " + ", ".join(
                f"{name} axis {a['calls']:.0f} calls {a['ms']:.2f} ms {a['bytes']:.0f} bytes"
                for name, a in t[kind]["axes"].items())
            for kind in ("decode", "prefill"))
        print(f"{label} {tag} rank {rank}: backend {t['backend']} device {t['device']}: "
              f"a step median ({axes}); peak {t['peak_bytes']} bytes; block_attn launches "
              f"{f32} float32 + {t['block_attn_bf16_launches']} bf16")
    print(f"{label} {tag}: {len(reference['tokens'])} requests, "
          f"{len(reference['tokens']) - len(flips)} token streams equal to the unsharded ones, "
          f"{len(flips)} first differing at a bf16 near-tie {flips}; counters {counters}; "
          f"digests {digests}")
    return timing, flips, counters, digests


def dp_serve_phase(smi, reference):
    """(p) Data-parallel serving slots on (n)'s Seamless workload: B10 bf16
    held against its plain version on (n)'s first prefill-cross and
    decode-cross calls cut to data rank 0's rows (and at (2, 2) to model
    rank 0's heads), beside its bound and bf16 SDPA; then ``launch.serve
    --full`` under torchrun on each mesh of DP_SERVE_MESHES, its ranks on
    this card (:func:`_mesh_serve_launch`, held against (n)'s unsharded run
    ``reference``). Fails unless B10's float32 launches (the encoder at
    admission, on the ranks of the data row that holds the slot) sum over
    each model index's data ranks to 24 an admission, and every rank
    launches B10 bf16 24 times a prefill chunk and a decode step (the cross
    layers on its rows). Returns ({path: float32 launches}, {path: bf16
    launches}, {mode: bf16 entry}, {mesh: numbers})."""
    from repro_torch.configs import get_arch

    tag = f"[{smi}]"
    run = next(r for r in TP_RUNS if r[0] == "seamless-m4t-large-v2")
    arch, requests, slots = run[:3]
    cfg = get_arch(arch)
    modes16, f32_paths, bf16_paths, stats = {}, {}, {}, {}
    for data, model in DP_SERVE_MESHES:
        name = f"dp{data}x{model}"
        rows = slots // data
        for mode, (q, k, v, kw) in reference["calls"].items():
            qkv = tuple(t[:rows].contiguous() for t in (q, k, v))
            share = f"data rank 0 of {data} ({rows} rows)"
            if model > 1:
                qkv = _rank_heads(*qkv, ranks=model)
                share += f", model rank 0 of {model} (local heads)"
            entry = _hold_attn_mode(f"(p) {arch} {mode}, {share}", *qkv, kw["causal"], tag)
            entry["share"] = share
            modes16[f"{name} {arch} {mode} local"] = entry
        timing, flips, counters, digests = _mesh_serve_launch(
            run, data * model, model, f"{name} {arch}", reference, tag, DP_SERVE_TIMEOUT)
        want_bf16 = cfg.n_blocks * (counters["prefill_chunks"] + counters["decode_steps"])
        by_model = {}
        for rank, t in sorted(timing.items()):
            f32 = t["block_attn_launches"] - t["block_attn_bf16_launches"]
            by_model[rank % model] = by_model.get(rank % model, 0) + f32
            if t["block_attn_bf16_launches"] != want_bf16:
                _fail(f"{name} {arch}: rank {rank} launched block_attn bf16 "
                      f"{t['block_attn_bf16_launches']} times, want {want_bf16}")
            f32_paths[f"{arch} serve {name} rank {rank}"] = f32
            bf16_paths[f"{arch} serve {name} rank {rank} bf16"] = t["block_attn_bf16_launches"]
        want_f32 = cfg.n_enc_layers * requests
        if any(got != want_f32 for got in by_model.values()):
            _fail(f"{name} {arch}: block_attn float32 launches summed over the data ranks "
                  f"{by_model} (by model index), want {want_f32}: {cfg.n_enc_layers} an "
                  f"admission")
        print(f"{name} {arch} {tag}: block_attn float32 launches summed over the data ranks "
              f"{by_model} (want {want_f32}), bf16 {want_bf16} a rank")
        stats[name] = {"ranks": timing, "flips": flips, "digest": digests[0],
                       "counters": counters, "unsharded": reference["counters"]}
        gc.collect()
    print(f"dp serve summary {tag}: {json.dumps(stats)}")
    return f32_paths, bf16_paths, modes16, stats


def _dp_layer0(arch_id, bsz, seq, tag):
    """(o) Layer 0's B9 forward and B9b backward call at one data-parallel
    rank's shape: one gradient of ``T.loss_fn`` (remat) on rank 0's rows of
    the launcher's first global batch (``default_rng(0)``, ``bsz //
    DP_RANKS`` of its ``bsz`` rows) from the launcher's weights, the first
    forward call and the last backward call kept; each held against its
    plain version on the same inputs (SSD_TOL; GRAD_TOL gradient by
    gradient) and timed beside it, with its bound. Returns {"forward":
    entry, "backward": entry}."""
    import numpy as np
    import torch
    from torch.utils._pytree import tree_leaves

    from repro_torch.configs import get_arch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_plain
    from repro_torch.models import transformer as T

    cfg = get_arch(arch_id)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, size=(bsz, seq + 1))
    toks = torch.as_tensor(toks[:bsz // DP_RANKS], device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    leaves, last, real_bwd = tree_leaves(params), [], sk.ssd_scan_backward

    def keep_last(*args, **kw):
        last[:] = [(args, kw)]
        return real_bwd(*args, **kw)

    sk.ssd_scan_backward = keep_last
    for leaf in leaves:
        leaf.requires_grad_(True)
    try:
        fwd_args, kw, calls = _first_call(ssd_ops, "ssd_chunked", lambda: torch.autograd.grad(
            T.loss_fn(cfg, params, batch, remat=True), leaves))
    finally:
        sk.ssd_scan_backward = real_bwd
        for leaf in leaves:
            leaf.requires_grad_(False)
    del params, leaves
    chunk = kw["chunk"]
    x, dt, a_log, b, c = (t.detach() for t in fwd_args)
    b_, h, l, p = x.shape
    g, n = b.shape[1], b.shape[3]
    label = f"(o) {arch_id} layer 0 at a rank's rows x{(b_, h, l, p)} B/C{(b_, g, l, n)} chunk={chunk}"
    if calls != 2 * _kernel_calls(cfg)["ssd_scan"]:
        _fail(f"{label}: one gradient called ssd_chunked {calls} times")
    with torch.no_grad():
        got = sk.ssd_scan(x, dt, a_log, b, c, chunk=chunk)
        want, _ = ssd_chunked_plain(x, dt, a_log, b, c, chunk)
        ms = statistics.median(_time_ms(lambda: sk.ssd_scan(x, dt, a_log, b, c, chunk=chunk),
                                        iters=10) for _ in range(3))
        plain_ms = _time_ms(lambda: ssd_chunked_plain(x, dt, a_log, b, c, chunk), iters=3,
                            warmup=1)
    ratio = _tol_ratio(got, want, SSD_TOL)
    flop, nbytes = _ssd_fwd_work(b_, h, g, l, p, n, chunk)
    ops_ms = SSD_TF32_PASSES * flop / TF32_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    forward = {"x": [b_, h, l, p], "bc": [b_, g, l, n], "chunk": chunk,
               "max_abs_err": float((got - want).abs().max()), "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": None}
    print(f"ssd_scan {label} {tag}: vs plain max|d|={forward['max_abs_err']:.3e} "
          f"|d|/(tol+tol|y|)={ratio:.4f} (tol {SSD_TOL}); ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={forward['bound_ms']:.4f} ({SSD_TF32_PASSES} x {flop} FLOP at 3xTF32 "
          f"{ops_ms:.4f} ms; bytes {nbytes} {bytes_ms:.4f} ms)")
    if not (ratio <= 1.0 and torch.isfinite(got).all()):
        _fail(f"ssd_scan {label}: disagrees with its plain version (ratio {ratio:.4f})")
    del got, want
    args, kw = last[0]
    got = real_bwd(*args, **kw)
    ins = [t.detach().requires_grad_() for t in args[:5]]
    y_plain = ssd_chunked_plain(*ins, kw["chunk"])[0]
    want = torch.autograd.grad(y_plain, ins, args[6], retain_graph=True)
    max_abs = _grads_agree(("dx", "ddt", "da_log", "db", "dc"), got, want, tag,
                           f"ssd_scan backward {label}")
    ms = statistics.median(_time_ms(lambda: real_bwd(*args, **kw), iters=5, warmup=1)
                           for _ in range(3))
    plain_ms = _time_ms(lambda: torch.autograd.grad(y_plain, ins, args[6], retain_graph=True),
                        iters=2, warmup=1)
    bound_ms, bound_by, counted = _ssd_bwd_bound(b_, h, l, p, n, chunk, g)
    backward = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}
    print(f"ssd_scan backward {label} {tag}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({counted}) = {bound_ms / ms:.3f} of it")
    return {"forward": forward, "backward": backward}


def dp_phase(smi, unsharded_losses):
    """(o) Data-parallel training: layer 0's B9 and B9b at a rank's shape
    (:func:`_dp_layer0`), then ``launch.train pod`` under ``torchrun
    --nproc-per-node DP_RANKS`` on POD_RUNS' first run (the weights and
    global batches of phase (i)), its ranks on this card. Fails unless
    every rank prints its lines, the digests of their gathered parameters
    are equal, the ranks share the card over gloo, rank 0 prints the
    reference's lines, every rank's losses are rank 0's and within
    DP_LOSS_RTOL of (i)'s ``unsharded_losses``, and each rank launched B9
    twice a Mamba2 layer a step (remat) and B9b once. Returns ({path: B9
    launches}, {path: B9b launches}, the layer-0 entries, the run's
    numbers)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.ssd_scan import ssd_scan as sk

    tag = f"[{smi}]"
    arch_id, bsz, seq = POD_RUNS[0]
    held = _dp_layer0(arch_id, bsz, seq, tag)
    gc.collect()
    torch.cuda.empty_cache()
    out = _launcher_lines(
        ["torch.distributed.run", "--standalone", "--nproc-per-node", str(DP_RANKS), "-m",
         "repro_torch.launch.train", "pod", "--arch", arch_id, "--batch", str(bsz), "--seq",
         str(seq), "--steps", str(POD_STEPS)], f"dp {arch_id}", DP_TIMEOUT)
    heads = {int(r): (b, m, d) for r, b, m, d in re.findall(
        r"rank (\d+): backend=(\w+) mesh=(\{.*?\}) device=(\S+)", out)}
    timing = {int(r): json.loads(t) for r, t in re.findall(r"rank (\d+): timing (.*)", out)}
    digests = {int(r): d for r, d in re.findall(r"rank (\d+): digest=(\w+)", out)}
    lines = [line for line in out.splitlines() if not line.startswith("rank ")]
    ranks = list(range(DP_RANKS))
    if sorted(heads) != ranks or sorted(timing) != ranks or sorted(digests) != ranks:
        _fail(f"dp {arch_id}: the launcher's rank lines are missing: {sorted(heads)}, "
              f"{sorted(timing)}, {digests}")
    mesh = f"{{'data': {DP_RANKS}, 'model': 1}}"
    one_card = torch.cuda.device_count() < DP_RANKS
    if len(set(digests.values())) != 1 or any(m != mesh for _, m, _ in heads.values()) or (
            one_card and {b for b, _, _ in heads.values()} != {"gloo"}):
        _fail(f"dp {arch_id}: digests {digests}, ranks {heads}")
    if (len(lines) != POD_STEPS + 1 or lines[-1] != "done"
            or not all(re.fullmatch(rf"step {i:3d} loss=\d+\.\d{{4}} \(\d+\.\d\ds\)", line)
                       for i, line in enumerate(lines[:-1]))):
        _fail(f"dp {arch_id}: rank 0's lines are not the reference's: {lines}")
    losses = timing[0]["losses"]
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses, unsharded_losses))
    if (any(t["losses"] != losses for t in timing.values()) or len(losses) != POD_STEPS
            or worst > DP_LOSS_RTOL):
        _fail(f"dp {arch_id}: losses {[t['losses'] for t in timing.values()]} against the "
              f"unsharded {unsharded_losses} (rtol {DP_LOSS_RTOL})")
    calls = _kernel_calls(get_arch(arch_id))["ssd_scan"] * POD_STEPS
    want = {"ssd_scan": 2 * calls, **dict.fromkeys(sk.BWD_STAGES, calls)}
    fwd_paths, bwd_paths, ranks_out = {}, {}, {}
    for rank, t in sorted(timing.items()):
        got = {k: t["launches"][k] for k in want}
        step_ms = statistics.median(t["ms"][1:]) if len(t["ms"]) > 1 else t["ms"][0]
        coll = t["collectives"][1:] or t["collectives"]
        ranks_out[rank] = {
            "backend": t["backend"], "device": t["device"], "ms_per_step": step_ms,
            "ms": t["ms"], "collective_ms_per_step": statistics.median(c["ms"] for c in coll),
            "collective_bytes_per_step": statistics.median(c["bytes"] for c in coll),
            "collectives_per_step": statistics.median(c["calls"] for c in coll),
            "peak_bytes": t["peak_bytes"], "launches": got}
        print(f"dp {arch_id} {tag} rank {rank}: backend {t['backend']} device {t['device']}: "
              f"ms a step (median of steps 1..{POD_STEPS - 1}) {step_ms:.2f}, all "
              f"{[round(x, 2) for x in t['ms']]}; data collectives a step "
              f"{ranks_out[rank]['collectives_per_step']:.0f} calls, "
              f"{ranks_out[rank]['collective_ms_per_step']:.2f} ms, "
              f"{ranks_out[rank]['collective_bytes_per_step']:.0f} bytes; peak "
              f"{t['peak_bytes']} bytes; launches {got} (want {want})")
        if got != want:
            _fail(f"dp {arch_id}: rank {rank} launched {got}, want {want}")
        path = f"{arch_id} train pod dp{DP_RANKS} rank {rank}"
        fwd_paths[path], bwd_paths[path] = got["ssd_scan"], got["bwd_chunk_dc"]
    stats = {"ranks": ranks_out, "losses": losses, "unsharded_losses": unsharded_losses,
             "max_rel_loss_diff": worst, "digest": digests[0]}
    print(f"dp summary {tag}: {json.dumps(stats)}")
    return fwd_paths, bwd_paths, held, stats


def _rank_blocks(cfg, mesh, rank):
    """The element count of each of ``rank``'s blocks of ``cfg``'s
    parameters on the ``(data, model)`` mesh ``mesh`` (``param_specs``)."""
    from repro_torch.core.flatten import tree_leaves
    from repro_torch.dist.sharding import block_slices, param_specs, zip_specs
    from repro_torch.models import transformer as T

    abstract = T.abstract_params(cfg)
    return tree_leaves(zip_specs(
        lambda leaf, spec: math.prod(c.stop - c.start
                                     for c in block_slices(leaf.shape, spec, mesh, rank)),
        abstract, param_specs(abstract, mesh)))


def pod_data_phase(smi):
    """(q) Pods with a data axis: B5 and B6 held against their plain
    versions on one rank's block payload at bits 8 (rank 0 of the pod's
    data axis: its blocks of every leaf, one wire tensor a (block, leaf)),
    beside their memory bounds; then the same pods stacked on the card at
    bits 32 (:func:`fed_pod_run`, data = 1), and ``launch.train pod --fed
    --pods P`` under ``torchrun --nproc-per-node POD_DATA_RANKS`` at each of
    POD_DATA_BITS, the ranks sharing the card over gloo. Fails unless every
    rank prints its lines, the digests are equal within each pod (at bits
    32 the two pods' ring average makes them equal across pods too), rank 0
    prints the reference's lines, each rank's
    losses are the same and, at bits 32, within DP_LOSS_RTOL of the stacked
    run's, each rank launches B9 and B9b once a layer a step (no remat) and,
    at bits 8, B5 and B6 once a gossip offset a step (none at 32), and each
    rank's gossip sends, a step, the sum over its blocks of 64 + 8 d bits
    at bits 8 (32 d at 32). Returns ({path: B9 launches}, {path: B9b
    launches}, {path: {B5/B6: launches}}, B5/B6 numbers at the block
    payload, the runs' numbers); the stacked run's launches are among the
    paths."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.flatten import flatten_tree, make_flat_spec
    from repro_torch.dist.gossip import GossipConfig
    from repro_torch.dist.sharding import param_specs, shard_tree
    from repro_torch.kernels.quantize import payload_side_info
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.models import transformer as T

    tag = f"[{smi}]"
    arch_id, pods, bsz, seq, steps = POD_DATA_RUN
    data = POD_DATA_RANKS // pods
    host = {"data": data, "model": 1}
    cfg = get_arch(arch_id)
    blocks = shard_tree(T.init_params(cfg, torch.Generator("cuda").manual_seed(0)),
                        param_specs(T.abstract_params(cfg), host), host, 0)
    spec = make_flat_spec(blocks)
    flat = flatten_tree(blocks, spec)[None]
    del blocks
    w2d = flat.view(-1, 128)
    u2d = torch.rand(w2d.shape, generator=torch.Generator("cuda").manual_seed(3),
                     device="cuda")
    s_rows, n_rows = payload_side_info(flat, spec, per_message=True, bits=8)
    payload = _hold_wire_pair(
        w2d, u2d, s_rows, n_rows, f"block payload of {arch_id} on data rank 0 of {data} "
        f"({spec.n_leaves} leaves, d={spec.d}, {w2d.shape[0]} rows)", tag)
    del flat, w2d, u2d, s_rows, n_rows
    gc.collect()
    torch.cuda.empty_cache()
    counted, stacked = fed_pod_run(arch_id, pods, bsz, seq, steps, 32, tag, profile=False)
    gc.collect()
    torch.cuda.empty_cache()
    path = f"{arch_id} train pod --fed --pods {pods} stacked bits 32 (q)"
    fwd_paths, bwd_paths = {path: counted["ssd_scan"]}, {path: counted["bwd_chunk_dc"]}
    wire_paths = {path: {k: counted[k] for k in ("quantize_rows", "dequantize_rows")}}
    offsets = len(GossipConfig().offsets(pods))
    calls = _kernel_calls(cfg)["ssd_scan"] * steps
    runs = {}
    for bits in POD_DATA_BITS:
        label = f"pod-data {arch_id} bits {bits}"
        out = _launcher_lines(
            ["torch.distributed.run", "--standalone", "--nproc-per-node", str(POD_DATA_RANKS),
             "-m", "repro_torch.launch.train", "pod", "--arch", arch_id, "--fed", "--pods",
             str(pods), "--batch", str(bsz), "--seq", str(seq), "--steps", str(steps),
             "--bits", str(bits), "--gossip-every", "1"], label, POD_DATA_TIMEOUT)
        heads = {int(r): (b, m, int(p), int(d)) for r, b, m, p, d in re.findall(
            r"rank (\d+): backend=(\w+) mesh=(\{.*?\}) pod=(\d+) data=(\d+) device=\S+", out)}
        timing = {int(r): json.loads(t) for r, t in re.findall(r"rank (\d+): timing (.*)", out)}
        digests = {int(r): d for r, d in re.findall(r"rank (\d+): digest=(\w+)", out)}
        lines = [line for line in out.splitlines() if not line.startswith("rank ")]
        ranks = list(range(POD_DATA_RANKS))
        if sorted(heads) != ranks or sorted(timing) != ranks or sorted(digests) != ranks:
            _fail(f"{label}: the launcher's rank lines are missing: {sorted(heads)}, "
                  f"{sorted(timing)}, {digests}")
        mesh = f"{{'pod': {pods}, 'data': {data}, 'model': 1}}"
        if any((m, p, d) != (mesh, r // data, r % data) for r, (_, m, p, d) in heads.items()):
            _fail(f"{label}: the ranks' places {heads}")
        by_pod = [{digests[r] for r in ranks if r // data == p} for p in range(pods)]
        if any(len(group) != 1 for group in by_pod):
            _fail(f"{label}: digests {digests}: not equal within each pod")
        want_lines = [f"fed pod mode: {pods} pods x data={data} ({data} ranks a pod) "
                      f"topology=ring every=1 bits={bits}"]
        if (len(lines) != steps + 2 or lines[0] != want_lines[0]
                or not re.fullmatch(r"done \(inter-pod param spread=\d+\.\d{5}\)", lines[-1])
                or not all(re.fullmatch(rf"step {i:3d} loss=\d+\.\d{{4}} \(\d+\.\d\ds\)", line)
                           for i, line in enumerate(lines[1:-1]))):
            _fail(f"{label}: rank 0's lines are not the reference's: {lines}")
        losses = timing[0]["losses"]
        worst = max(abs(a - b) / abs(b) for a, b in zip(losses, stacked["losses"]))
        if (any(t["losses"] != losses for t in timing.values()) or len(losses) != steps
                or not all(math.isfinite(x) for x in losses)
                or (bits == 32 and worst > DP_LOSS_RTOL)):
            _fail(f"{label}: losses {[t['losses'] for t in timing.values()]} against the "
                  f"stacked {stacked['losses']} (rtol {DP_LOSS_RTOL} at bits 32)")
        wire_n = offsets * steps if bits < 32 else 0
        want = {"ssd_scan": calls, **dict.fromkeys(sk.BWD_STAGES, calls),
                "quantize_rows": wire_n, "dequantize_rows": wire_n}
        ranks_out = {}
        for rank, t in sorted(timing.items()):
            sizes = _rank_blocks(cfg, host, rank % data)
            sent = (sum(64 + 8 * d for d in sizes) if bits < 32
                    else sum(32 * d for d in sizes)) // 8 * offsets
            got = {k: t["launches"][k] for k in want}
            step_ms = statistics.median(t["ms"][1:]) if len(t["ms"]) > 1 else t["ms"][0]
            per = {axis: {key: statistics.median(c[key] for c in t[axis][1:] or t[axis])
                          for key in ("calls", "ms", "bytes")} for axis in ("data", "gossip")}
            ranks_out[rank] = {"pod": t["pod"], "backend": t["backend"], "device": t["device"],
                               "ms_per_step": step_ms, "ms": t["ms"], **per,
                               "peak_bytes": t["peak_bytes"], "launches": got}
            print(f"{label} {tag} rank {rank} (pod {t['pod']}, data {rank % data}): backend "
                  f"{t['backend']}: ms a step (median of steps 1..{steps - 1}) {step_ms:.2f}, "
                  f"all {[round(x, 2) for x in t['ms']]}; data axis a step "
                  f"{per['data']['calls']:.0f} calls, {per['data']['ms']:.2f} ms, "
                  f"{per['data']['bytes']:.0f} bytes; gossip a step {per['gossip']['calls']:.0f} "
                  f"calls, {per['gossip']['ms']:.2f} ms, {per['gossip']['bytes']:.0f} bytes (want "
                  f"{sent}); peak {t['peak_bytes']} bytes; launches {got} (want {want})")
            if got != want:
                _fail(f"{label}: rank {rank} launched {got}, want {want}")
            if any(c["bytes"] != sent for c in t["gossip"]):
                _fail(f"{label}: rank {rank}'s gossip sent {[c['bytes'] for c in t['gossip']]} "
                      f"bytes a step, want {sent}")
            path = f"{arch_id} train pod --fed --pods {pods} data{data} bits {bits} rank {rank}"
            fwd_paths[path], bwd_paths[path] = got["ssd_scan"], got["bwd_chunk_dc"]
            wire_paths[path] = {k: got[k] for k in ("quantize_rows", "dequantize_rows")}
        runs[label] = {"ranks": ranks_out, "losses": losses, "stacked_losses": stacked["losses"],
                       "max_rel_loss_diff": worst, "digests": sorted(set(digests.values())),
                       "spread": float(lines[-1].split("=")[1].rstrip(")"))}
        print(f"{label} {tag}: losses {losses}, stacked (data = 1) {stacked['losses']}, max rel "
              f"{worst:.3e}; digests {by_pod}")
        gc.collect()
    print(f"pod-data summary {tag}: {json.dumps({'stacked': stacked, **runs})}")
    return fwd_paths, bwd_paths, wire_paths, payload, runs


def _tp_train_batches(cfg, bsz, seq, device):
    """launch.train pod's global batches, in its order of draws: tokens,
    then the stub frames, from ``default_rng(0)`` (phase (i)'s)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    while True:
        toks = rng.integers(0, cfg.vocab, size=(bsz, seq + 1))
        batch = {"tokens": torch.as_tensor(toks[..., :-1], device=device),
                 "labels": torch.as_tensor(toks[..., 1:], device=device)}
        if cfg.frontend != "none":
            batch["embeds"] = torch.as_tensor(rng.normal(
                size=(bsz, cfg.frontend_tokens, cfg.d_model)), dtype=torch.float32,
                device=device)
        yield batch


def _axis_delta(before, after):
    return {"calls": after["calls"] - before["calls"],
            "ms": (after["seconds"] - before["seconds"]) * 1e3,
            "bytes": after["bytes"] - before["bytes"]}


def tp_train_worker() -> int:
    """``--tp-train``: one rank of phase (r) under ``torch.distributed.run``.
    Joins the ranks' group (gloo when they share the card), draws
    TP_TRAIN_RUN's weights on the card from (i)'s seed, keeps its blocks by
    ``make_train_step(cfg, make_host_mesh(1, W))``'s ``p_specs`` and runs
    TP_TRAIN_STEPS steps on (i)'s batches. Prints, as ``rank r: tp-train
    {json}``, the ms of each step, the model axis's calls, ms and bytes in
    the forward, the backward (remat's recomputed forwards included) and
    the update apart, the ``enter`` adjoints run, each step's loss and B10
    and B10b launches, the heads each ``block_attention`` call took, peak
    memory, the backend and each leaf's update norm ||p - p_0|| in float64
    (its blocks' squares summed over the axis); then ``rank r: digest=`` of
    the parameters gathered whole over the model axis."""
    import hashlib

    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    from repro_torch.configs import get_arch
    from repro_torch.convert import shard_lm_params
    from repro_torch.dist import parallel
    from repro_torch.dist.steps import make_train_step
    from repro_torch.kernels.block_attn import block_attn as ba
    from repro_torch.kernels.block_attn import ops as attn_ops
    from repro_torch.launch.mesh import join_torchrun, make_host_mesh
    from repro_torch.launch.train import _say_all
    from repro_torch.models import transformer as T
    from repro_torch.optim import momentum_init

    arch_id, bsz, seq = TP_TRAIN_RUN
    cfg = get_arch(arch_id)
    dev, backend = join_torchrun(torch.device("cuda"))
    mesh = make_host_mesh(1, dist.get_world_size(), device=dev, group=dist.group.WORLD)
    axis, rank = mesh.axis, mesh.rank
    step_fn, p_specs = make_train_step(cfg, mesh, lr_r=TP_TRAIN_LR_R)
    whole = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    params = shard_lm_params(whole, p_specs, mesh, dev)
    del whole
    vel = momentum_init(params).velocity
    p0 = [t.clone() for t in _leaves(params)]
    batches = _tp_train_batches(cfg, bsz, seq, dev)

    marks, heads, enters = {}, set(), [0]
    real_grad, real_attn = torch.autograd.grad, attn_ops.block_attention
    real_enter = parallel._AxisEnter.backward

    def grad(*args, **kw):
        marks["forward"] = dict(axis.stats)
        out = real_grad(*args, **kw)
        marks["backward"] = dict(axis.stats)
        return out

    def attn(q, k, v, **kw):
        heads.add((q.shape[2], k.shape[2]))
        return real_attn(q, k, v, **kw)

    def enter_backward(ctx, g):
        enters[0] += 1
        return real_enter(ctx, g)

    torch.autograd.grad, attn_ops.block_attention = grad, attn
    parallel._AxisEnter.backward = staticmethod(enter_backward)
    timing = {"rank": rank, "backend": backend, "device": str(dev), "mesh": mesh.shape,
              "ms": [], "forward": [], "backward": [], "update": [], "enters": [],
              "losses": [], "launches": []}
    torch.cuda.reset_peak_memory_stats(dev)
    for step in range(TP_TRAIN_STEPS):
        batch = next(batches)
        ba.reset_launch_counts()
        enters[0] = 0
        torch.cuda.synchronize(dev)
        before = dict(axis.stats)
        t0 = time.perf_counter()
        params, vel, loss = step_fn(params, vel, batch, step)
        loss = float(loss)
        torch.cuda.synchronize(dev)
        timing["ms"].append((time.perf_counter() - t0) * 1e3)
        timing["forward"].append(_axis_delta(before, marks["forward"]))
        timing["backward"].append(_axis_delta(marks["forward"], marks["backward"]))
        timing["update"].append(_axis_delta(marks["backward"], dict(axis.stats)))
        timing["enters"].append(enters[0])
        timing["losses"].append(loss)
        timing["launches"].append({**ba.LAUNCHES, **ba.BWD_LAUNCHES})
    torch.autograd.grad, attn_ops.block_attention = real_grad, real_attn
    parallel._AxisEnter.backward = staticmethod(real_enter)
    timing["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    timing["heads"] = sorted(heads)
    specs = list(_leaves(p_specs))
    split = torch.tensor(["model" in spec for spec in specs], device=dev)
    squares = torch.stack([(p.double() - q.double()).square().sum()
                           for p, q in zip(_leaves(params), p0)])
    del p0
    parts = axis.all_gather(squares[None], 0)
    norms = torch.where(split, parts.sum(0), parts[0]).sqrt()
    timing["update_norms"] = dict(zip(_leaf_names(params), norms.tolist()))
    _say_all(rank, f"tp-train {json.dumps(timing)}")
    digest = hashlib.sha256()
    for leaf, spec in zip(_leaves(params), specs):
        full = axis.all_gather(leaf, spec.index("model")) if "model" in spec else leaf
        digest.update(full.cpu().contiguous().view(torch.uint8).numpy().tobytes())
        del full
    _say_all(rank, f"digest={digest.hexdigest()[:16]}")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def tp_train_phase(smi, unsharded):
    """(r) Tensor-parallel training: B10b held against autograd through its
    plain version at a rank's heads (H / TP_RANKS) on Seamless's layer-0
    shapes in each mode (encoder, decoder, cross at Lk = the frames), timed
    beside its plain version, fp32 SDPA's backward and its bound; then
    :func:`tp_train_worker` on TP_RANKS ranks under ``torch.distributed.run``.
    Fails unless every rank prints its lines, the ranks share the card over
    gloo on a (1, TP_RANKS) mesh, every rank's losses are rank 0's and
    within DP_LOSS_RTOL of (i)'s ``unsharded["losses"]``, each leaf's update
    norm is within TP_NORM_RTOL of (i)'s ``unsharded["update_norms"]``, the
    digests of the parameters gathered whole are equal, and each rank
    launched B10 twice a layer a step (remat) and B10b once, on H /
    TP_RANKS heads. Returns ({path: B10 launches}, {path: B10b calls}, {case:
    B10b entry}, the run's numbers)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.block_attn import block_attn as ba

    tag = f"[{smi}]"
    arch_id, bsz, seq = TP_TRAIN_RUN
    cfg = get_arch(arch_id)
    h, hd, frames = cfg.n_heads // TP_RANKS, cfg.head_dim_, cfg.frontend_tokens
    cases = {}
    for mode, lq, lk, causal in (("encoder", frames, frames, False), ("decoder", seq, seq, True),
                                 (f"cross Lk {frames}", seq, frames, False)):
        q, k, v, do = _bwd_attn_inputs(bsz, lq, lk, h, h, hd)
        label = f"(r) {arch_id} {mode} at a rank's {h} heads"
        cases[label] = _bwd_attn_case(label, q, k, v, do, causal, 0, tag)
        del q, k, v, do
    gc.collect()
    torch.cuda.empty_cache()
    out = _launcher_lines(
        ["torch.distributed.run", "--standalone", "--nproc-per-node", str(TP_RANKS),
         os.path.abspath(__file__), "--tp-train"], f"tp train {arch_id}", TP_TRAIN_TIMEOUT)
    timing = {int(r): json.loads(t) for r, t in re.findall(r"rank (\d+): tp-train (.*)", out)}
    digests = {int(r): d for r, d in re.findall(r"rank (\d+): digest=(\w+)", out)}
    ranks = list(range(TP_RANKS))
    if sorted(timing) != ranks or sorted(digests) != ranks:
        _fail(f"tp train {arch_id}: the ranks' lines are missing: {sorted(timing)}, {digests}")
    one_card = torch.cuda.device_count() < TP_RANKS
    mesh = {"data": 1, "model": TP_RANKS}
    if len(set(digests.values())) != 1 or any(t["mesh"] != mesh for t in timing.values()) or (
            one_card and {t["backend"] for t in timing.values()} != {"gloo"}):
        _fail(f"tp train {arch_id}: digests {digests}, meshes and backends "
              f"{[(t['mesh'], t['backend']) for t in timing.values()]}")
    losses = timing[0]["losses"]
    want_losses = unsharded["losses"][:TP_TRAIN_STEPS]
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
    if (any(t["losses"] != losses for t in timing.values()) or len(losses) != TP_TRAIN_STEPS
            or worst > DP_LOSS_RTOL):
        _fail(f"tp train {arch_id}: losses {[t['losses'] for t in timing.values()]} against "
              f"the unsharded {want_losses} (rtol {DP_LOSS_RTOL})")
    norms, want_norms = timing[0]["update_norms"], unsharded["update_norms"]
    if sorted(norms) != sorted(want_norms):
        _fail(f"tp train {arch_id}: update norms of {sorted(norms)}, (i) kept "
              f"{sorted(want_norms)}")
    rel = {name: abs(norms[name] - w) / w if w else abs(norms[name])
           for name, w in want_norms.items()}
    leaf = max(rel, key=rel.get)
    print(f"tp train {arch_id} {tag}: losses {losses} against (i)'s {want_losses}, worst rel "
          f"{worst:.3e} (DP_LOSS_RTOL {DP_LOSS_RTOL}); update norms after {TP_TRAIN_STEPS} "
          f"steps over {len(rel)} leaves, worst {leaf} {norms[leaf]} against "
          f"{want_norms[leaf]} rel {rel[leaf]:.3e} (TP_NORM_RTOL {TP_NORM_RTOL}); "
          f"digests {digests}")
    if not all(math.isfinite(x) for x in norms.values()) or rel[leaf] > TP_NORM_RTOL:
        _fail(f"tp train {arch_id}: update norms {norms} against (i)'s {want_norms}")
    calls = _kernel_calls(cfg)["block_attn"]
    want = {"block_attn": 2 * calls, **dict.fromkeys(ba.BWD_LAUNCHES, calls)}
    fwd_paths, bwd_paths, ranks_out = {}, {}, {}
    for rank, t in sorted(timing.items()):
        got = [{k: lc[k] for k in want} for lc in t["launches"]]
        ranks_out[rank] = {
            "backend": t["backend"], "device": t["device"],
            "ms_per_step": statistics.median(t["ms"][1:]), "ms": t["ms"],
            "peak_bytes": t["peak_bytes"], "enters_per_step": t["enters"],
            **{f"{part}_collectives_per_step": {
                key: statistics.median(c[key] for c in t[part][1:])
                for key in ("calls", "ms", "bytes")} for part in ("forward", "backward", "update")},
            "launches_per_step": got[0], "heads": t["heads"]}
        out_r = ranks_out[rank]
        print(f"tp train {arch_id} {tag} rank {rank}: backend {t['backend']} device "
              f"{t['device']}: ms a step (median of steps 1..{TP_TRAIN_STEPS - 1}) "
              f"{out_r['ms_per_step']:.2f}, all {[round(x, 2) for x in t['ms']]}; model-axis "
              f"collectives a step: forward {out_r['forward_collectives_per_step']}, backward "
              f"(remat's forwards and {t['enters']} enters) "
              f"{out_r['backward_collectives_per_step']}, update "
              f"{out_r['update_collectives_per_step']}; peak {t['peak_bytes']} bytes; launches "
              f"a step {got} (want {want}); (q, k/v) heads a call {t['heads']}")
        if any(lc != want for lc in got) or t["heads"] != [[h, h]]:
            _fail(f"tp train {arch_id}: rank {rank} launched {got} on heads {t['heads']}, "
                  f"want {want} a step on {h}")
        path = f"{arch_id} train tp{TP_RANKS} rank {rank}"
        fwd_paths[path] = sum(lc["block_attn"] for lc in got)
        bwd_paths[path] = sum(lc["attn_bwd_dkdvq"] for lc in got)
    stats = {"ranks": ranks_out, "losses": losses, "unsharded_losses": want_losses,
             "max_rel_loss_diff": worst, "max_rel_norm_diff": rel[leaf], "digest": digests[0]}
    print(f"tp train summary {tag}: {json.dumps(stats)}")
    return fwd_paths, bwd_paths, cases, stats


def fed_phase(smi):
    """(l) The DFedRW pod deployment: B5/B6 at the gossip payload and
    ``gossip_mix`` on the card (l0), ``launch.train pod --fed`` at full
    width for FED_RUNS (l1: mamba2-130m, l2: internvl2-1b), the scheduled
    step (l3). Returns (the B5/B6 numbers at the payload, {path: {kernel:
    launches}}, {run: numbers})."""
    tag = f"[{smi}]"
    payload = fed_wire_phase(tag)
    fed_gossip_card_vs_cpu(tag)
    by_path, runs = {}, {}
    for arch_id, pods, bsz, seq, steps, bits_list in FED_RUNS:
        for bits in bits_list:
            label = f"{arch_id} train pod --fed bits {bits}"
            by_path[label], runs[label] = fed_pod_run(arch_id, pods, bsz, seq, steps, bits, tag)
    fed_scheduled_phase(tag)
    return payload, by_path, runs


def _ptxas_report(log):
    """(kernel, registers, spill store bytes, spill load bytes) for each
    entry function of an ``-Xptxas -v`` report."""
    import re

    rows, name, spills = [], None, (None, None)
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", line)
        if hit:
            name = hit.group(1)
        hit = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if hit:
            spills = (int(hit.group(1)), int(hit.group(2)))
        hit = re.search(r"Used (\d+) registers", line)
        if hit and name:
            rows.append((name, int(hit.group(1)), *spills))
            name, spills = None, (None, None)
    return rows


def _print_registers(label, info, tag, only=""):
    """Each entry function of a build's ``-Xptxas -v`` report whose name
    holds ``only``: registers and spill bytes. Fails on a spill."""
    for name, regs, stores, loads in _ptxas_report(info["log"]):
        if only in name:
            print(f"{label} {tag}: kernel {name}: {regs} registers, spill stores {stores} "
                  f"bytes, spill loads {loads} bytes")
            if stores or loads:
                _fail(f"{label}: {name} spills ({stores} bytes stored, {loads} loaded)")


SEED_ROUNDS = 3                # timed rounds of each engine in (s), after one warm round
DRYRUN_RUNS = [                # (t): (label, arguments, REPRO_FED_BITS)
    ("yi-6b train_4k", ["--arch", "yi-6b", "--shape", "train_4k"], None),
    ("mamba2-130m train_4k multi-pod", ["--arch", "mamba2-130m", "--shape", "train_4k",
                                        "--multi-pod"], None),
    ("mamba2-130m train_4k multi-pod fed bits 32", ["--arch", "mamba2-130m", "--shape",
                                                    "train_4k", "--multi-pod", "--fed"], "32"),
    ("mamba2-130m train_4k multi-pod fed bits 8", ["--arch", "mamba2-130m", "--shape",
                                                   "train_4k", "--multi-pod", "--fed"], "8"),
]


def _seed_uniforms(spec, m, k, rows, gen):
    """The seed engine's uniforms of one quantized round, drawn on the CPU
    from ``gen`` (``execute_round(uniforms=)``'s nesting)."""
    import torch

    return {"hop": [[torch.rand((m, *shape), generator=gen) for shape in spec.shapes]
                    for _ in range(k)],
            "agg": [torch.rand((rows, *shape), generator=gen) for shape in spec.shapes]}


def seed_engine_phase(model, data, topo, tag):
    """(s) The seed engine, ``DFedRWConfig(engine="reference")``, on the card
    at the main path's configuration (n = 100, complete graph, 3FNN, M = K
    = 8, B = 50, seed 0), beside the flat engine from the same init and
    plans: one warm and SEED_ROUNDS timed rounds of each, in turns, at bits
    32 and 8. Holds the two engines' device parameters after every round
    (bits 32: rtol 1e-6 / atol 1e-7, with the count of elements that differ
    at all; bits 8: within 0.05 * scale + 1e-4, their uniforms differing by
    design), Eq. 18 bits equal, and no kernel launched by the seed engine
    (it runs the plain quantizer, as the reference's seed engine runs the
    ``jnp`` one); then one seed-engine round on the CPU and on the card
    from the same init, plans and uniforms, within the flat engine's
    card-vs-CPU tolerance (bits 32: rtol 1e-4 / atol 1e-5; bits 8: 0.05 *
    scale + 1e-4). Prints ms a round of each engine, the median and spread
    of the timed rounds (no claim). Returns the flat rounds' launches."""
    import numpy as np
    import torch

    from repro_torch.convert import params_from_numpy
    from repro_torch.core import DFedRW, DFedRWConfig, QuantConfig
    from repro_torch.core.flatten import tree_leaves
    from repro_torch.kernels.quantize import quantize as qk

    params = model.init(torch.Generator().manual_seed(0), "cpu")
    flat_launches = dict.fromkeys(qk.LAUNCHES, 0)
    for bits in (32, 8):
        cfg = DFedRWConfig(m_chains=8, k_walk=8, batch_size=50, quant=QuantConfig(bits=bits),
                           seed=0)
        runners = {e: DFedRW(model, data, topo, dataclasses.replace(cfg, engine=e))
                   for e in ("reference", "flat")}
        states = {e: r.state_from_params(params) for e, r in runners.items()}
        keys = {e: torch.Generator().manual_seed(1) for e in runners}
        times = {e: [] for e in runners}
        worst, differ = 0.0, 0
        for i in range(1 + SEED_ROUNDS):
            met = {}
            for e, r in runners.items():
                before = dict(qk.LAUNCHES)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                states[e], met[e] = r.run_round(states[e], keys[e])
                torch.cuda.synchronize()
                if i:
                    times[e].append((time.perf_counter() - t0) * 1e3)
                launched = {n: qk.LAUNCHES[n] - before[n] for n in before}
                if e == "reference" and any(launched.values()):
                    _fail(f"the seed engine launched kernels at bits={bits}: {launched}")
                if e == "flat":
                    for n, c in launched.items():
                        flat_launches[n] += c
            if (met["reference"].comm_bits_round != met["flat"].comm_bits_round
                    or met["reference"].comm_bits_busiest_round
                    != met["flat"].comm_bits_busiest_round):
                _fail(f"seed and flat engines bill different Eq. 18 bits at bits={bits}")
            seed = tree_leaves(runners["reference"].params_pytree(states["reference"]))
            flat = tree_leaves(runners["flat"].params_pytree(states["flat"]))
            scale = max(float(a.abs().max()) for a in flat)
            diff = max(float((a - b).abs().max()) for a, b in zip(seed, flat))
            worst = max(worst, diff)
            differ = max(differ, sum(int((a != b).sum()) for a, b in zip(seed, flat)))
            ok = (all(torch.allclose(a, b, rtol=1e-6, atol=1e-7) for a, b in zip(seed, flat))
                  if bits == 32 else diff < 0.05 * scale + 1e-4)
            if not ok or not all(torch.isfinite(a).all() for a in seed):
                _fail(f"seed engine against flat engine at bits={bits}, round {i + 1}: "
                      f"max|d|={diff:.3e} scale={scale:.3e}")
        for e, ms in times.items():
            print(f"seed engine phase {tag} bits={bits} {e}: ms/round "
                  f"median={statistics.median(ms):.3f} min={min(ms):.3f} max={max(ms):.3f} "
                  f"all={[round(t, 3) for t in ms]}")
        print(f"seed engine phase {tag} bits={bits}: seed vs flat max|d|={worst:.3e} "
              f"elements differing (most in a round)={differ} "
              f"loss seed={met['reference'].train_loss:.6f} flat={met['flat'].train_loss:.6f}")
        # the seed engine's card round against its CPU round
        np_params = [tuple(t.numpy() for t in p) for p in params]
        pair = []
        for d in ("cpu", "cuda"):
            r = DFedRW(model, data, topo, dataclasses.replace(cfg, engine="reference"),
                       device=d)
            pair.append([r, r.state_from_params(params_from_numpy(np_params, device=d))])
        plans = [r.plan_walks(s) for r, s in pair]
        aggs = [r.plan_aggregation(p) for (r, _), (p, _) in zip(pair, plans)]
        uniforms = None
        if bits < 32:
            uniforms = _seed_uniforms(pair[0][0].flat_spec, cfg.m_chains, cfg.k_walk,
                                      aggs[0][1].size, torch.Generator().manual_seed(2))
        out = []
        for (r, s), (plan, bidx), agg, d in zip(pair, plans, aggs, ("cpu", "cuda")):
            u = None if uniforms is None else {
                "hop": [[t.to(d) for t in step] for step in uniforms["hop"]],
                "agg": [t.to(d) for t in uniforms["agg"]]}
            s, _ = r.execute_round(s, plan, bidx, agg, None, uniforms=u)
            out.append([t.cpu() for t in tree_leaves(s.device_params)])
        scale = max(float(a.abs().max()) for a in out[0])
        diff = max(float((a - b).abs().max()) for a, b in zip(*out))
        ok = (all(torch.allclose(b, a, rtol=1e-4, atol=1e-5) for a, b in zip(*out))
              if bits == 32 else diff < 0.05 * scale + 1e-4)
        print(f"seed engine phase {tag} bits={bits}: card vs CPU round max|d|={diff:.3e}")
        if not ok:
            _fail(f"the seed engine's card and CPU rounds disagree at bits={bits}: "
                  f"max|d|={diff:.3e}")
    return flat_launches


def dryrun_phase(tag):
    """(t) The dry run (``python -m repro_torch.launch.dryrun``) in
    subprocesses that see no card (``CUDA_VISIBLE_DEVICES`` empty), started
    together, each with a timeout: DRYRUN_RUNS, ``pod_gossip_roofline.py``'s
    variants. Holds that each exits 0, that the ``--fed`` programs count
    only exchanges on the pod axis (no gather, no sum: the DFedRW claim),
    and that bits 8's gossip bytes are the int8 wire of the rank's blocks
    from the leaf shapes exactly (a code a live element, a float32 s and
    norm a leaf). Prints each run's three roofline terms (the H100's
    published peaks)."""
    import torch

    from repro_torch.core.flatten import tree_leaves
    from repro_torch.dist.sharding import param_specs, shard_tree
    from repro_torch.launch import dryrun as D
    from repro_torch.models import transformer as T

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    cfg = D.resolve_cfg("mamba2-130m", "train_4k")
    mesh = D.ShapePodMesh(2, 16, 16)
    base = T.abstract_params(cfg, torch.float32)
    blocks = tree_leaves(shard_tree(base, param_specs(base, mesh), mesh, 0))
    int8_wire = sum(b.numel() for b in blocks) + 8 * len(blocks)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = []
        for i, (label, argv, fed_bits) in enumerate(DRYRUN_RUNS):
            env = dict(os.environ, PYTHONPATH=src, CUDA_VISIBLE_DEVICES="",
                       OMP_NUM_THREADS="1")
            if fed_bits is not None:
                env["REPRO_FED_BITS"] = fed_bits
            path = os.path.join(tmp, f"run{i}.json")
            procs.append((path, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", *argv, "--json", path],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)))
        try:
            outs = [proc.communicate(timeout=240) for _, proc in procs]
        except subprocess.TimeoutExpired:
            _fail("a dry run made no exit within 240 s")
        finally:
            for _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        print(f"dry run {tag}: {len(procs)} runs in parallel, "
              f"{time.perf_counter() - t0:.1f}s")
        for (label, _, fed_bits), (path, proc), (out, err) in zip(DRYRUN_RUNS, procs, outs):
            if proc.returncode != 0:
                _fail(f"dry run {label}: exit {proc.returncode}\n{out[-2000:]}{err[-2000:]}")
            res = json.load(open(path))[0]
            rl = res["roofline"]
            print(f"dry run {tag} {label}: meta run {res['lower_compile_s']:.1f}s "
                  f"compute={rl['compute_s'] * 1e3:.3f}ms memory={rl['memory_s'] * 1e3:.3f}ms "
                  f"collective={rl['collective_s'] * 1e3:.3f}ms dominant={rl['dominant']} "
                  f"flops/chip={rl['hlo_flops_per_chip']:.4e} "
                  f"bytes/chip={rl['hlo_bytes_per_chip']:.4e} "
                  f"collectives={rl['collectives']} calls={res['collective_calls']} "
                  f"peak={res['bytes_per_device']['peak']}")
            if fed_bits is not None:
                if set(res["collective_calls"]) != {"gossip/exchange"}:
                    _fail(f"dry run {label}: the gossip program makes "
                          f"{res['collective_calls']}, not pod-axis exchanges alone")
                if fed_bits == "8" and rl["collectives"]["gossip/exchange"] != int8_wire:
                    _fail(f"dry run {label}: gossip bytes "
                          f"{rl['collectives']['gossip/exchange']} != the int8 wire's "
                          f"{int8_wire}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _leaf_names(tree, prefix=""):
    """The paths of ``_leaves(tree)``, in the same order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_names(v, f"{prefix}/{k}")
    else:
        yield prefix


def _worst_leaf(got, want, names):
    """(the largest max|d|/max|want| over the leaves, that leaf's name)."""
    return max((_normwise(g.cpu(), w), n) for g, w, n in zip(got, want, names))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside this script (looked in {src}); run it "
              "from the root of a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, src)
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
    started = time.perf_counter()

    def elapsed(label):
        print(f"elapsed after {label}: {time.perf_counter() - started:.1f}s")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # ---------------------------------------------------------------- build
    # The four sources start building together, one nvcc each. The phases up
    # to the simulator launch only qdq_rows' kernels, so they run once it is
    # built while ssd_scan and block_attn go on building beside them; the
    # rest are waited for before the first phase that launches them.
    t0 = time.perf_counter()
    builder = ThreadPoolExecutor(4)
    builds = [builder.submit(fn) for fn in (qk.build, sk.build, ba.build, ba.build_bf16)]
    built = [qk.BUILD_INFO, sk.BUILD_INFO, ba.BUILD_INFO, ba.BF16_BUILD_INFO]

    def report_builds(done):
        for info in done:
            print(f"build: {info['seconds']:.2f}s {info['path']}")
            for line in info["log"].splitlines():
                if "registers" in line or "spill" in line or "Compiling" in line:
                    print(f"ptxas: {line.strip()}")

    builds[0].result()
    print(f"build: qdq_rows built {time.perf_counter() - t0:.2f}s after the four sources "
          "started in parallel")
    elapsed("build")
    report_builds(built[:1])

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
    runner = DFedRW(model, data, topo, config(8))
    spec = runner.flat_spec
    real = (ops.qdq_delta_rows_rng, ops.qdq_rows_rng)
    ops.qdq_delta_rows_rng = _capture_first(captured, "qdq_delta_rows_rng", real[0])
    ops.qdq_rows_rng = _capture_first(captured, "qdq_rows_rng", real[1])
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
    elapsed("the wire phase")

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

    # --------------------------------------------------- (s) the seed engine
    seed_flat = seed_engine_phase(model, data, topo, f"[{smi}]")
    elapsed("the seed engine")

    # ------------------------------------- baselines, LSTM chain mode, checkpoint
    by_path = {"3fnn_dfedrw": launches, "seed engine phase (flat rounds)": seed_flat,
               "baselines": baselines_phase(model, data, topo, xt, yt, f"[{smi}]")}
    del profile_runner, state, runner
    gc.collect()
    torch.cuda.empty_cache()
    by_path["lstm_chain_mode"] = lstm_phase(f"[{smi}]")
    gc.collect()                         # the LSTM's state goes before the LM phases
    torch.cuda.empty_cache()
    by_path["simulator"], sim_held, fleet_stream = sim_phases(f"[{smi}]")
    elapsed("the simulator")
    gc.collect()
    torch.cuda.empty_cache()

    for name in results:
        results[name]["launches"] = sum(counts[name] for counts in by_path.values())
        results[name]["launches_by_path"] = {path: counts[name]
                                             for path, counts in by_path.items()}
        results[name]["fleet_metro_n100000"] = {
            key: sim_held[name][key] for key in ("rows", "ms", "bound_ms", "plain_ms")}
    t0 = time.perf_counter()
    for done in builds[1:]:
        done.result()
    builder.shutdown()
    print(f"build: ssd_scan and block_attn waited for {time.perf_counter() - t0:.2f}s after "
          "the simulator")
    report_builds(built[1:])
    elapsed("the other builds")
    ssd = mamba_phases(smi)
    elapsed("mamba2")
    gc.collect()                         # the Mamba2 weights and caches go first
    torch.cuda.empty_cache()
    attn = dense_phases(smi)
    elapsed("yi-6b")
    gc.collect()                         # Yi-6B's weights go before InternVL2's
    torch.cuda.empty_cache()
    attn_by_path = {"yi-6b": attn["launches"], "internvl2-1b": vlm_phase(smi)}
    gc.collect()
    torch.cuda.empty_cache()
    attn_by_path["grok-1-314b (depth 2)"] = grok_phase(smi)
    gc.collect()                         # Grok's 45.8 GB go before the rest
    torch.cuda.empty_cache()
    jamba = _smoke_phase("jamba-1.5-large-398b", f"[{smi}]")   # (c) both LM kernels
    attn_by_path["jamba-smoke"] = jamba["block_attn"]
    ssd_by_path = {"mamba2-130m": ssd["launches"], "jamba-smoke": jamba["ssd_scan"]}
    fwd, steps, attn["modes"] = seamless_phase(smi)                 # (e)
    elapsed("seamless")
    attn_by_path["seamless-m4t-large-v2"] = fwd
    attn_by_path["seamless-m4t-large-v2 decode"] = steps
    gc.collect()                         # Seamless's 8.14 GB go before DeepSeek's 64.84 GB
    torch.cuda.empty_cache()
    bwd_attn, bwd_ssd = backward_phase(smi)                          # (g)
    elapsed("the backward kernels")
    train_launches = {arch: train_smoke_phase(arch, f"[{smi}]") for arch in TRAIN_ARCHS}  # (h)
    pods = {arch: pod_phase(arch, b_, s_, POD_STEPS, f"[{smi}]")   # (i)
            for arch, b_, s_ in POD_RUNS}
    elapsed("training")
    gc.collect()
    torch.cuda.empty_cache()
    bwd_by_path = {"attn": {}, "ssd": {}}
    for arch, counts in train_launches.items():
        for kernel, paths, by_path, bwd in (("block_attn", attn_by_path, bwd_by_path["attn"],
                                             "attn_bwd_dkdvq"),
                                            ("ssd_scan", ssd_by_path, bwd_by_path["ssd"],
                                             "bwd_chunk_dc")):
            if counts[kernel]:
                paths[f"{arch} train smoke"] = counts[kernel]
                by_path[f"{arch} train smoke"] = counts[bwd]
    payload, fed_by_path, fed_runs = fed_phase(smi)                 # (l)
    elapsed("fed pods")
    gc.collect()
    torch.cuda.empty_cache()
    metal, metal_workers, _ = metal_phase(smi)                      # (m)
    elapsed("metal")
    gc.collect()
    torch.cuda.empty_cache()
    tp_f32, tp_bf16, tp_modes32, tp_modes16, _, tp_served = tp_phase(smi)  # (n)
    elapsed("tensor-parallel serving")
    torch.cuda.empty_cache()
    dp_fwd, dp_bwd, ssd["data_parallel"], _ = dp_phase(smi, pods[POD_RUNS[0][0]][1]["losses"])
    elapsed("data-parallel training")                               # (o)
    gc.collect()
    torch.cuda.empty_cache()
    dp_serve_f32, dp_serve_bf16, dp_serve_modes16, _ = dp_serve_phase(
        smi, tp_served["seamless-m4t-large-v2"])                    # (p)
    del tp_served
    elapsed("data-parallel serving")
    gc.collect()
    torch.cuda.empty_cache()
    pd_fwd, pd_bwd, pd_wire, pd_payload, _ = pod_data_phase(smi)   # (q)
    elapsed("pods with a data axis")
    gc.collect()
    torch.cuda.empty_cache()
    tp_fwd, tp_bwd, tp_cases, _ = tp_train_phase(smi, pods[TP_TRAIN_RUN[0]][1])   # (r)
    elapsed("tensor-parallel training")
    gc.collect()
    torch.cuda.empty_cache()
    attn_by_path.update(tp_fwd)
    bwd_by_path["attn"].update(tp_bwd)
    bwd_attn.update(tp_cases)
    ssd_by_path.update(dp_fwd)
    bwd_by_path["ssd"].update(dp_bwd)
    ssd_by_path.update(pd_fwd)
    bwd_by_path["ssd"].update(pd_bwd)
    for name in results:
        for path, counted in (("metal replay", metal), ("metal replay workers", metal_workers)):
            results[name]["launches"] += counted[name]
            results[name]["launches_by_path"][path] = counted[name]
    pod_paths = {f"{arch} train pod": counted for arch, (counted, _) in pods.items()}
    for path, counted in {**pod_paths, **fed_by_path}.items():
        for kernel, paths, by_path, bwd in (("block_attn", attn_by_path, bwd_by_path["attn"],
                                             "attn_bwd_dkdvq"),
                                            ("ssd_scan", ssd_by_path, bwd_by_path["ssd"],
                                             "bwd_chunk_dc")):
            if counted[kernel]:
                paths[path] = counted[kernel]
                by_path[path] = counted[bwd]
    for name, numbers in payload.items():
        fed = {path: counted[name] for path, counted in {**fed_by_path, **pd_wire}.items()}
        wire[name]["launches_by_path"] = {"wire path": wire[name]["launches"], **fed}
        wire[name]["launches"] += sum(fed.values())
        wire[name]["gossip_payload"] = {key: numbers[key] for key in ("rows", "ms", "bound_ms",
                                                                      "plain_ms")}
        wire[name]["block_payload"] = {key: pd_payload[name][key]
                                       for key in ("rows", "ms", "bound_ms", "plain_ms")}
    print(f"fed pods summary [{smi}]: {json.dumps(fed_runs)}")
    for entry, cases, main_case, by_path, kernels in (
            (attn, bwd_attn, "yi-6b layer 0", bwd_by_path["attn"], ", ".join(ba.BWD_LAUNCHES)),
            (ssd, bwd_ssd, "mamba2-130m layer", bwd_by_path["ssd"], ", ".join(sk.BWD_STAGES))):
        main = cases[main_case]
        entry["backward"] = {
            "kernels": kernels, "shape": main_case,
            **{key: main[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms", "kernel_ms")},
            "launches": sum(by_path.values()), "launches_by_path": by_path, "cases": cases}
    entry_train = {arch: stats for arch, (_, stats) in pods.items()}
    print(f"train pod summary [{smi}]: {json.dumps(entry_train)}")
    obs_phase(f"[{smi}]", fleet_stream)
    elapsed("obs")
    gc.collect()
    torch.cuda.empty_cache()
    for arch in SERVE_SMOKE:                                         # (j) serving
        serve_smoke_phase(arch, f"[{smi}]")
    serving = {}
    for run in SERVE_RUNS:
        served, serve_modes, serving[run[0]] = serve_phase(run, smi,
                                                           depth_cut=SERVE_F32_DEPTH_CUT)
        attn["modes"].update(serve_modes)
        if served:
            attn_by_path[f"{run[0]} serve (depth / {SERVE_F32_DEPTH_CUT})"] = served
        gc.collect()                     # each model goes before the next
        torch.cuda.empty_cache()
        elapsed(f"float32 serving of {run[0]}")
    print(f"serve summary [{smi}]: {json.dumps(serving)}")
    elapsed("float32 serving")
    attn_by_path["deepseek-v2-lite-16b"] = deepseek_phase(smi)    # (f): 64.84 GB
    elapsed("deepseek")
    gc.collect()
    torch.cuda.empty_cache()
    # (k) the bf16 slice, Qwen2.5-32B last: the largest.
    ssd16, launches16 = bf16_mamba_phase(smi)                       # (k1)
    elapsed("mamba2 bf16")
    ssd16_by_path = {"mamba2-130m bf16": launches16}
    gc.collect()
    torch.cuda.empty_cache()
    attn16, launches16 = bf16_dense_phase(smi)                      # (k2)
    elapsed("yi-6b bf16")
    attn16_by_path = {"yi-6b bf16": launches16}
    gc.collect()
    torch.cuda.empty_cache()
    modes16, attn16_by_path["seamless-m4t-large-v2 bf16"] = bf16_seamless_phase(smi)  # (k3)
    attn16["modes"].update(modes16)
    elapsed("seamless bf16")
    gc.collect()
    torch.cuda.empty_cache()
    serving16 = {}
    for run in SERVE_RUNS:                                           # (k4) launch.serve --full
        served, serve_modes, serving16[run[0]] = serve_phase(run, smi, torch.bfloat16,
                                                             depth_cut=SERVE_BF16_DEPTH_CUT)
        attn16["modes"].update({f"bf16 {key}": val for key, val in serve_modes.items()})
        if served:
            attn16_by_path[f"{run[0]} serve bf16 (depth / {SERVE_BF16_DEPTH_CUT})"] = served
        gc.collect()
        torch.cuda.empty_cache()
        elapsed(f"bf16 serving of {run[0]}")
    attn16["modes"]["qwen2.5-32b layer 0"], attn16_by_path["qwen2.5-32b bf16"], \
        serving16["qwen2.5-32b"] = qwen_phase(smi)                  # (k5)
    print(f"serve bf16 summary [{smi}]: {json.dumps(serving16)}")
    elapsed("bf16 serving and qwen2.5-32b")
    attn_by_path.update(tp_f32)                                      # (n)'s ranks
    attn16_by_path.update(tp_bf16)
    attn["modes"].update(tp_modes32)
    attn16["modes"].update(tp_modes16)
    attn_by_path.update(dp_serve_f32)                                # (p)'s ranks
    attn16_by_path.update(dp_serve_bf16)
    attn16["modes"].update(dp_serve_modes16)
    for entry, paths in ((attn, attn_by_path), (ssd, ssd_by_path), (attn16, attn16_by_path),
                         (ssd16, ssd16_by_path)):
        entry["launches"] = sum(paths.values())
        entry["launches_by_path"] = paths
    dryrun_phase(f"[{smi}]")                                          # (t)
    elapsed("the dry run")
    print(json.dumps({"kernels": [results["qdq_delta_rows_rng"], results["qdq_rows_rng"],
                                  *wire.values(), ssd, attn, ssd16, attn16]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


# (label, B, Lq, Lk, H, KV, hd, causal) and (label, B, H, L, P, N, chunk, G) of
# the before-and-after timing: BWD_ATTN_CASES's first four, BWD_SSD_CASES's first three.
AB_ATTN = [case[:8] for case in BWD_ATTN_CASES[:4]]
AB_SSD = [case[:8] for case in BWD_SSD_CASES[:3]]


def time_backward(src):
    """``--time-backward SRC``: the ms a call of ``block_attn_backward`` and
    ``ssd_scan_backward`` as the package under SRC (this checkout's or
    another's ``src``) has them, at AB_ATTN and AB_SSD, on the inputs that
    phase (g) checks (:func:`_bwd_attn_inputs`, :func:`_ssd_bwd_inputs`),
    and a SHA-256 of the float32 forward kernels' outputs there (o and the
    log-sum-exp, y and the states: deterministic, so two checkouts whose
    float32 forwards agree bit for bit give equal digests); one JSON line.
    The functions take the same arguments in every checkout that has them."""
    import hashlib

    sys.path.insert(0, os.path.abspath(src))
    from repro_torch.kernels.block_attn import block_attn as ba
    from repro_torch.kernels.ssd_scan import ssd_scan as sk

    digest = hashlib.sha256()
    out = {"src": src, "attn": {}, "ssd": {}}
    for label, bsz, lq, lk, h, kv, hd, causal in AB_ATTN:
        q, k, v, do = _bwd_attn_inputs(bsz, lq, lk, h, kv, hd)
        o, lse = ba.block_attn_forward(q, k, v, causal=causal, with_lse=True)
        for t in (o, lse, ba.block_attn_forward(q, k, v, causal=causal)[0]):
            digest.update(t.detach().cpu().numpy().tobytes())
        out["attn"][label] = statistics.median(_time_ms(
            lambda: ba.block_attn_backward(q, k, v, o, lse, do, causal=causal), iters=5,
            warmup=1) for _ in range(3))
        del q, k, v, do, o, lse
    for label, bsz, h, l, p, n, chunk, g in AB_SSD:
        x, dt, a_log, b, c, dy = _ssd_bwd_inputs(bsz, h, l, p, n, g, False)
        y, states = sk.ssd_scan_forward(x, dt, a_log, b, c, chunk=chunk)
        for t in (y, states):
            digest.update(t.detach().cpu().numpy().tobytes())
        out["ssd"][label] = statistics.median(_time_ms(
            lambda: sk.ssd_scan_backward(x, dt, a_log, b, c, states, dy, chunk=chunk), iters=5,
            warmup=1) for _ in range(3))
        del x, dt, a_log, b, c, dy, states
    out["float32_forward_sha256"] = digest.hexdigest()
    print(json.dumps(out))
    return 0


def backward_ab(other):
    """``--backward-ab OTHER``: :func:`time_backward` of OTHER's ``src`` (a
    ``git archive`` of another commit) and of this checkout's, in turns
    (other, this, this, other), each in a process of its own, on one card;
    prints the card, the four JSON lines and whether the float32 forward
    digests are all equal; exits 1 if they are not."""
    here = os.path.dirname(os.path.abspath(__file__))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    order = [os.path.join(other, "src"), os.path.join(here, "src"),
             os.path.join(here, "src"), os.path.join(other, "src")]
    digests = set()
    for src in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-backward", src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-2000:], file=sys.stderr)
            return 1
        line = proc.stdout.strip().splitlines()[-1]
        digests.add(json.loads(line)["float32_forward_sha256"])
        print(line)
    print(f"float32 forward outputs bit-identical across the four runs: {len(digests) == 1}")
    return 0 if len(digests) == 1 else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-train"]:
        sys.exit(tp_train_worker())
    if sys.argv[1:2] == ["--time-backward"]:
        sys.exit(time_backward(sys.argv[2]))
    if sys.argv[1:2] == ["--backward-ab"]:
        sys.exit(backward_ab(sys.argv[2]))
    sys.exit(main())
