"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked ``gpu`` and skips where there is no card (a CUDA
kernel has no CPU mode); the decision is made inside a fixture, never at
import. This file imports neither ``jax`` nor ``repro``, so it runs on a
machine with the card alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Contracts: ``qdq_rows_rng`` and the wire kernels ``qdq_rows``,
``quantize_rows``, ``dequantize_rows``, ``quantize`` and ``dequantize``
equal their plain versions bit for bit (bfloat16 results too);
``qdq_delta_rows_rng`` and ``qdq_delta_rows`` within 1 ulp (both fuse
base + t*norm into one FMA);
``ssd_scan`` within 2e-4 absolute and relative of ``ssd_chunked_plain``
(3xTF32 tensor-core products in four chunk-parallel kernels, summed in
another order; the tolerance tests/test_kernels_ssd.py holds the TPU
kernel to), each of its four stage kernels launched once a call; ``block_attn`` within 1e-4 absolute and relative
of ``block_attention_plain`` (3xTF32 tensor-core products and an online
softmax against a materialized float32 softmax; also non-causal over 1,000
frames, as cross-attention and at Lq = 1), and the SMOKE Yi, DeepSeek (MLA)
and Seamless (encoder-decoder) models on the card within 2e-4 of the CPU. QDFedAvg's rounds and quantized LSTM
chain-mode rounds on the card stay within 0.05 * scale + 1e-4 of the CPU's
(tests/test_flat_engine.py's bound).

The bf16 modes of ``block_attn`` and ``ssd_scan`` are held within 1 bf16
ulp of their plain bf16 versions (both compute in float32 and round once;
ulps are taken no finer than at 2^-8 of the operands' largest magnitude,
below which the order of the float32 sums decides); a bf16 input that
requires a gradient raises; the SMOKE bf16 models on the card stay within
0.05 absolute and relative of the CPU.

The backward kernels of ``block_attn`` and ``ssd_scan`` are held against
autograd through the plain versions, gradient by gradient, within
``GRAD_TOL`` of the largest magnitude of that gradient: each gradient is a
sum over the sequence whose terms cancel, so its float32 error scales with
the terms and not with the element (ddt reaches ~1e3 at mamba2-130m's
layer), and dQ, dB and dC are summed with atomics in a varying order.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.block_attn import block_attention
from repro_torch.kernels.block_attn import block_attn as bk
from repro_torch.kernels.block_attn.ref import block_attention_plain
from repro_torch.kernels.quantize import quantize as qk
from repro_torch.kernels.ssd_scan import ssd_chunked
from repro_torch.kernels.ssd_scan import ssd_scan as sk
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_plain

pytestmark = pytest.mark.gpu

GRAD_TOL = 2e-4


def _assert_grads_close(got, want, names):
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        assert err <= GRAD_TOL * scale + 1e-6, f"{name}: max|d|={err:.3e} max|want|={scale:.3e}"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(rows, seed, device):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(rows, qk.LANES, generator=g) * 0.03
    w[3] = 0.0                                      # an all-zero row: norm 0
    w[0, :5] = 0.0                                  # sign(0) = 0
    base = torch.randn(rows, qk.LANES, generator=g)
    norm = w.double().pow(2).sum(1).sqrt().float()
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    s = torch.where(norm > 0, w.abs().amax(1) / safe / 3.0, torch.ones_like(norm))
    return [t.to(device) for t in (w, base, s, norm)]


def _ulps(a, b):
    if a.dtype == torch.bfloat16:
        return (a.view(torch.int16).long() - b.view(torch.int16).long()).abs()
    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()


def _launched():
    """The quantize kernels launched since the last reset, with their counts."""
    return {name: n for name, n in qk.LAUNCHES.items() if n}


@pytest.mark.parametrize("rows", [1, 7, 1559 * 8])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_kernels_match_plain(cuda, bits, rows):
    w, base, s, norm = _inputs(max(rows, 8), bits, cuda)
    w, base, s, norm = w[:rows].contiguous(), base[:rows].contiguous(), s[:rows], norm[:rows]
    seed = (0x1234, 0xABCDEF01)
    qk.reset_launch_counts()
    buf = w.clone()
    got = qk.qdq_rows_rng(buf, seed, s, norm, bits=bits)
    got_d = qk.qdq_delta_rows_rng(w.clone(), base, seed, s, norm, bits=bits)
    torch.cuda.synchronize()
    assert got.data_ptr() == buf.data_ptr()          # written in place over w
    assert _launched() == {"qdq_delta_rows_rng": 1, "qdq_rows_rng": 1}
    assert torch.equal(got, qk.qdq_rows_rng_plain(w, seed, s, norm, bits=bits))
    want_d = qk.qdq_delta_rows_rng_plain(w, base, seed, s, norm, bits=bits)
    assert int(_ulps(got_d, want_d).max()) <= 1


def test_kernel_rejects_misaligned_views(cuda):
    w, base, s, norm = _inputs(16, 0, cuda)
    flat = torch.zeros(16 * qk.LANES + 1, device=cuda)
    shifted = flat[1:].view(16, qk.LANES)            # 4-byte offset
    with pytest.raises(ValueError, match="aligned"):
        qk.qdq_rows_rng(shifted, (1, 2), s, norm, bits=8)


@pytest.mark.parametrize("rows", [1, 7, 1559 * 8])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_wire_kernels_match_plain(cuda, bits, rows):
    """The six given-uniform and int8 wire kernels against their plain
    versions: 0 differing elements, qdq_delta_rows within 1 ulp (one FMA on
    both sides), float32 and bfloat16 results."""
    w, base, s, norm = _inputs(max(rows, 8), bits, cuda)
    w, base, s, norm = w[:rows].contiguous(), base[:rows].contiguous(), s[:rows], norm[:rows]
    u = torch.rand(w.shape, generator=torch.Generator(cuda).manual_seed(bits), device=cuda)
    levels = (1 << (bits - 1)) - 1
    total = torch.sqrt(torch.sum(w * w))
    qk.reset_launch_counts()
    for od in (torch.float32, torch.bfloat16):
        buf = w.clone()
        got = qk.qdq_delta_rows(buf, base, u, s, norm, bits=bits, out_dtype=od)
        assert (got.data_ptr() == buf.data_ptr()) == (od == torch.float32)
        want = qk.qdq_delta_rows_plain(w, base, u, s, norm, bits=bits, out_dtype=od)
        assert got.dtype == od and int(_ulps(got, want).max()) <= 1
        got = qk.qdq_rows(w.clone(), u, s, norm, bits=bits, out_dtype=od)
        assert torch.equal(got, qk.qdq_rows_plain(w, u, s, norm, bits=bits, out_dtype=od))
    q = qk.quantize_rows(w, u, s, norm, bits=bits)
    assert q.dtype == torch.int8
    assert torch.equal(q, qk.quantize_rows_plain(w, u, s, norm, bits=bits))
    q7 = qk.quantize(w, u, total, s=1.0 / levels, bits=bits)
    assert torch.equal(q7, qk.quantize_plain(w, u, total, s=1.0 / levels, bits=bits))
    for od in (torch.float32, torch.bfloat16):
        got = qk.dequantize_rows(q, s, norm, out_dtype=od)
        assert torch.equal(got, qk.dequantize_rows_plain(q, s, norm, out_dtype=od))
        got = qk.dequantize(q7, total, s=1.0 / levels, out_dtype=od)
        assert torch.equal(got, qk.dequantize_plain(q7, total, s=1.0 / levels, out_dtype=od))
    torch.cuda.synchronize()
    assert _launched() == {"qdq_delta_rows": 2, "qdq_rows": 2, "quantize_rows": 1,
                           "dequantize_rows": 2, "quantize": 1, "dequantize": 2}


@pytest.mark.parametrize("s,bits", [(1 / 127, 8), (1 / 7, 4)])
def test_quantize_kernel_multiplies_by_the_reciprocal(cuda, s, bits):
    """Inputs where x/s and x*float32(1/s) give other indices: the kernel
    takes the reciprocal, as its plain version and the reference do."""
    gen = torch.Generator().manual_seed(1)
    levels = (1 << (bits - 1)) - 1
    sf = torch.tensor(s, dtype=torch.float32)
    rs = torch.tensor(1.0) / sf
    x = torch.rand(64 * qk.LANES, generator=gen) * levels * sf
    q_div, q_mul = x / sf, x * rs
    phi_div, phi_mul = q_div - q_div.floor(), q_mul - q_mul.floor()
    u = torch.rand(x.shape, generator=gen)
    differ = q_div != q_mul
    u[differ] = torch.minimum(phi_div, phi_mul)[differ]
    w, u = (t.reshape(-1, qk.LANES).to(cuda) for t in (x, u))
    one = torch.ones((), device=cuda)
    got = qk.quantize(w, u, one, s=s, bits=bits)
    assert torch.equal(got, qk.quantize_plain(w, u, one, s=s, bits=bits))
    by_division = torch.clamp(q_div.floor() + (u.cpu().reshape(-1) < phi_div), 0, levels)
    assert int((by_division.to(torch.int8) != got.cpu().reshape(-1)).sum()) > 0


def test_wire_kernels_reject_misaligned_views(cuda):
    w, _, s, norm = _inputs(16, 0, cuda)
    flat = torch.zeros(16 * qk.LANES + 1, device=cuda)
    shifted = flat[1:].view(16, qk.LANES)            # 4-byte offset
    with pytest.raises(ValueError, match="aligned"):
        qk.qdq_rows(w.clone(), shifted, s, norm, bits=8)
    with pytest.raises(ValueError, match="aligned"):
        qk.quantize_rows(shifted, w, s, norm, bits=8)
    q = torch.zeros(16 * qk.LANES + 1, dtype=torch.int8, device=cuda)[1:].view(16, qk.LANES)
    with pytest.raises(ValueError, match="aligned"):
        qk.dequantize_rows(q, s, norm)
    with pytest.raises(ValueError, match="aligned"):
        qk.dequantize(q, norm[:1], s=0.01)


def test_wire_ops_on_card_match_cpu(cuda):
    """stochastic_quantize -> stochastic_dequantize and
    segment_quantize_dequantize(u_rows) on the card against the CPU, from
    the same inputs: the norms within 4 ulps, every element within one grid
    cell; the segment side information repeats bit for bit."""
    from repro_torch.kernels.quantize import ops

    gen = torch.Generator().manual_seed(7)
    w = torch.randn(300, 77, generator=gen)
    u = torch.rand(w.shape, generator=gen)
    qk.reset_launch_counts()
    q, norm = ops.stochastic_quantize(w.to(cuda), u.to(cuda), s=1 / 127, bits=8)
    q_cpu, norm_cpu = ops.stochastic_quantize(w, u, s=1 / 127, bits=8)
    assert int(_ulps(norm.cpu(), norm_cpu)) <= 4
    assert int((q.cpu().int() - q_cpu.int()).abs().max()) <= 1
    deq = ops.stochastic_dequantize(q, norm, s=1 / 127, out_dtype=torch.bfloat16)
    assert deq.shape == w.shape and deq.dtype == torch.bfloat16
    assert torch.equal(deq.cpu(), ops.stochastic_dequantize(q.cpu(), norm.cpu(), s=1 / 127,
                                                            out_dtype=torch.bfloat16))
    rows = torch.randn(40, qk.LANES, generator=gen) * 0.05
    ur = torch.rand(rows.shape, generator=gen)
    base = torch.randn(rows.shape, generator=gen)
    seg = torch.arange(40) % 6
    got = ops.segment_quantize_dequantize(rows.to(cuda), ur.to(cuda), seg.to(cuda), 7,
                                          bits=4, base_rows=base.to(cuda))
    want = ops.segment_quantize_dequantize(rows, ur, seg, 7, bits=4, base_rows=base)
    s_rows, n_rows = ops.segment_side_info(rows, seg, 7, bits=4)
    assert (got.cpu() - want).abs().le(s_rows[:, None] * n_rows[:, None] * (1 + 1e-5)).all()
    first = ops.segment_side_info(rows.to(cuda), seg.to(cuda), 7, bits=4)
    again = ops.segment_side_info(rows.to(cuda), seg.to(cuda), 7, bits=4)
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(first, again))
    assert int(_ulps(first[1].cpu(), n_rows).max()) <= 4
    torch.cuda.synchronize()
    assert _launched() == {"qdq_delta_rows": 1, "quantize": 1, "dequantize": 1}


def test_engine_on_card_matches_cpu(cuda):
    """Three QDFedRW rounds from the same weights and seed words on the CPU
    (plain versions) and on the card (kernels): within the bits=8 engine
    contract of tests/test_torch_dfedrw.py."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import DFedRW, DFedRWConfig, QuantConfig, make_topology
    from repro_torch.core.heterogeneity import partition_similarity
    from repro_torch.data import FederatedDataset, synthetic_image_classification
    from repro_torch.models import make_fnn

    x, y = synthetic_image_classification(n_samples=2000, seed=0, noise=1.0)
    data = FederatedDataset.from_partition(
        x, y, partition_similarity(y, 10, 50, np.random.default_rng(0)))
    model = make_fnn((64,))
    params = [tuple(t.numpy() for t in p)
              for p in model.init(torch.Generator().manual_seed(3), "cpu")]
    cfg = DFedRWConfig(m_chains=4, k_walk=3, batch_size=32, quant=QuantConfig(bits=8))
    runs = []
    for device in ("cpu", cuda):
        r = DFedRW(model, data, make_topology("complete", 10), cfg, device=device)
        runs.append([r, r.state_from_params(params_from_numpy(params, device=device))])
    seeds = torch.Generator().manual_seed(11)
    qk.reset_launch_counts()
    for _ in range(3):
        qseeds = torch.randint(0, 1 << 32, (cfg.k_walk + 1, 2), generator=seeds)
        for run in runs:
            r, state = run
            plan, bidx = r.plan_walks(state)
            run[1], _ = r.execute_round(state, plan, bidx, r.plan_aggregation(plan), None,
                                        qseeds=qseeds)
        a, b = runs[0][1].device_params, runs[1][1].device_params.cpu()
        assert float((a - b).abs().max()) < 0.05 * float(a.abs().max()) + 1e-4
    assert _launched() == {"qdq_delta_rows_rng": 9, "qdq_rows_rng": 3}


def test_qdfedavg_on_card_matches_cpu(cuda):
    """Three QDFedAvg rounds (DFedAvg at bits=8) from the same weights and
    seed words on the CPU (plain version) and on the card: within the bits=8
    contract of tests/test_torch_baselines.py, through one ``qdq_rows_rng``
    launch a round and no other kernel."""
    from repro_torch.core import BaselineConfig, DFedAvg, QuantConfig, make_topology
    from repro_torch.core.heterogeneity import partition_similarity
    from repro_torch.data import FederatedDataset, synthetic_image_classification
    from repro_torch.models import make_fnn

    x, y = synthetic_image_classification(n_samples=2000, seed=0, noise=1.0)
    data = FederatedDataset.from_partition(
        x, y, partition_similarity(y, 10, 50, np.random.default_rng(0)))
    model = make_fnn((64,))
    params = model.init(torch.Generator().manual_seed(3), "cpu")
    cfg = BaselineConfig(n_selected=10, local_epochs=3, n_agg=3, batch_size=32,
                         quant=QuantConfig(bits=8))
    runs = []
    for device in ("cpu", cuda):
        r = DFedAvg(model, data, make_topology("complete", 10), cfg, device=device)
        runs.append([r, r.state_from_params(params)])
    seeds = torch.Generator().manual_seed(11)
    qk.reset_launch_counts()
    for _ in range(3):
        qseed = torch.randint(0, 1 << 32, (2,), generator=seeds)
        for run in runs:
            run[1], _ = run[0].run_round(run[1], None, qseed=qseed)
        a, b = runs[0][1].device_params, runs[1][1].device_params.cpu()
        assert float((a - b).abs().max()) < 0.05 * float(a.abs().max()) + 1e-4
    assert _launched() == {"qdq_rows_rng": 3}


def test_chain_mode_round_on_card_matches_cpu(cuda):
    """Two quantized chain-mode rounds of a small LSTM (§VI-F) on the CPU and
    on the card from the same weights and seed words: the same chain starts,
    the matrix within 0.05 * scale + 1e-4, and K hop launches and one
    aggregation launch a round."""
    from repro_torch.core import DFedRW, DFedRWConfig, QuantConfig, make_topology
    from repro_torch.core.heterogeneity import Partition
    from repro_torch.data import FederatedDataset, synthetic_token_stream
    from repro_torch.models import make_lstm_lm

    toks, nxt, client = synthetic_token_stream(n_clients=8, seq_len=6, seqs_per_client=16,
                                               vocab=200, client_vocab=20, seed=0)
    idxs = [np.nonzero(client == c)[0] for c in range(8)]
    data = FederatedDataset.from_partition(toks, nxt[:, -1], Partition(idxs, 8))
    model = make_lstm_lm(vocab=200, embed=32, hidden=64)
    params = model.init(torch.Generator().manual_seed(3), "cpu")
    cfg = DFedRWConfig(m_chains=4, k_walk=3, batch_size=8, lr_r=0.5, chain_mode=True,
                       quant=QuantConfig(bits=8))
    runs = []
    for device in ("cpu", cuda):
        r = DFedRW(model, data, make_topology("complete", 8), cfg, device=device)
        runs.append([r, r.state_from_params(params)])
    seeds = torch.Generator().manual_seed(11)
    qk.reset_launch_counts()
    for _ in range(2):
        qseeds = torch.randint(0, 1 << 32, (cfg.k_walk + 1, 2), generator=seeds)
        for run in runs:
            r, state = run
            plan, bidx = r.plan_walks(state)
            run[1], _ = r.execute_round(state, plan, bidx, r.plan_aggregation(plan), None,
                                        qseeds=qseeds)
        np.testing.assert_array_equal(runs[0][1].chain_starts, runs[1][1].chain_starts)
        a, b = runs[0][1].device_params, runs[1][1].device_params.cpu()
        assert float((a - b).abs().max()) < 0.05 * float(a.abs().max()) + 1e-4
    assert _launched() == {"qdq_delta_rows_rng": 6, "qdq_rows_rng": 2}


def _ssd_inputs(b, h, l, p, n, g, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, l, p, generator=gen) * 0.8
    dt = torch.logaddexp(torch.randn(b, h, l, generator=gen), torch.zeros(()))
    a_log = torch.log(torch.linspace(1.0, 16.0, h))
    bb = torch.randn(b, g, l, n, generator=gen) * 0.5
    cc = torch.randn(b, g, l, n, generator=gen) * 0.5
    return [t.to(device) for t in (x, dt, a_log, bb, cc)]


@pytest.mark.parametrize("b,h,l,p,n,chunk,g", [
    (2, 4, 512, 64, 128, 256, 4),      # the main path's P, N and chunk
    (1, 8, 300, 32, 64, 128, 2),       # L not a chunk multiple, G < H
    (2, 6, 96, 16, 16, 32, 1),         # chunk under one 64-row tile, G = 1
    (1, 4, 330, 64, 128, 100, 2),      # chunk not a multiple of the 64-row tile
    (2, 4, 90, 64, 128, 256, 1),       # L under one chunk
    (1, 4, 256, 64, 128, 256, 4),      # a single whole chunk
    (1, 2, 300, 128, 128, 128, 1),     # P = 128
    (2, 3, 200, 18, 64, 64, 3),        # P = 18: x rows not 16-byte multiples
    (1, 6, 260, 32, 48, 128, 2),       # N = 48
    (1, 4, 200, 64, 50, 64, 2),        # N = 50: B/C rows not 16-byte multiples
    (2, 6, 300, 64, 128, 128, 6),      # G = H
])
def test_ssd_scan_matches_plain(cuda, b, h, l, p, n, chunk, g):
    x, dt, a_log, bb, cc = _ssd_inputs(b, h, l, p, n, g, cuda)
    sk.reset_launch_counts()
    got = ssd_chunked(x, dt, a_log, bb, cc, chunk=chunk)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["ssd_scan"] == 1          # a CUDA tensor never takes the plain path
    assert sk.KERNEL_LAUNCHES == dict.fromkeys(sk.STAGES, 1)
    want, _ = ssd_chunked_plain(x, dt, a_log, bb, cc, chunk)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)


def test_ssd_scan_takes_the_models_layout(cuda):
    """(B,L,H,P) activations and (B,L,G,N) B/C passed as transposed views:
    read by strides, and y comes back in (B,L,H,P) memory."""
    x, dt, a_log, bb, cc = _ssd_inputs(2, 4, 200, 64, 128, 2, cuda)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (x, dt, bb, cc)]
    sk.reset_launch_counts()
    got = ssd_chunked(views[0], views[1], a_log, views[2], views[3], chunk=64)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["ssd_scan"] == 1
    assert sk.KERNEL_LAUNCHES == dict.fromkeys(sk.STAGES, 1)
    assert got.transpose(1, 2).is_contiguous()
    want, _ = ssd_chunked_plain(x, dt, a_log, bb, cc, 64)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_mamba_smoke_on_card_matches_cpu(cuda):
    """The SMOKE Mamba2 forward through the kernel on the card against the
    plain version on the CPU, from the same weights: n_layers launches with
    the registry's config as it is (use_pallas_ssd=False)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as T

    cfg = get_smoke("mamba2-130m")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 80), generator=torch.Generator().manual_seed(1))
    want, _ = T.forward_train(cfg, params, tokens)
    on_card = _to(params, cuda)
    sk.reset_launch_counts()
    with torch.inference_mode():
        got, _ = T.forward_train(cfg, on_card, tokens.to(cuda))
    torch.cuda.synchronize()
    assert sk.LAUNCHES["ssd_scan"] == cfg.n_layers
    assert sk.KERNEL_LAUNCHES == dict.fromkeys(sk.STAGES, cfg.n_layers)
    torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("b,lq,lk,h,kv,hd,causal,window", [
    (1, 64, 64, 2, 2, 32, True, 0),
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 96, 96, 4, 1, 32, True, 0),         # MQA, L not a tile multiple
    (2, 256, 256, 8, 8, 128, True, 0),      # hd = 128
    (1, 100, 100, 2, 2, 32, True, 0),
    (1, 64, 64, 2, 2, 32, False, 0),        # bidirectional
    (1, 77, 130, 4, 2, 16, False, 0),       # Lq != Lk
    (2, 300, 300, 8, 4, 128, True, 64),     # sliding window
    (1, 40, 40, 2, 2, 24, True, 0),         # hd not a multiple of 16
    (2, 200, 200, 3, 3, 18, True, 0),       # hd 18: rows not 16-byte multiples, 4-byte copies
    (1, 150, 40, 4, 2, 64, True, 0),        # Lk shorter than one K/V tile
    (1, 300, 300, 4, 1, 128, True, 17),     # window shorter than a tile
    (2, 130, 130, 8, 2, 128, True, 0),      # a 2-row ragged last query tile of 128
    (1, 100, 60, 2, 1, 32, False, 20),      # non-causal window: rows 79+ see no key
    (2, 1000, 1000, 16, 16, 64, False, 0),  # an encoder over 1,000 frames (ragged)
    (2, 96, 1000, 16, 16, 64, False, 0),    # cross-attention over them
    (8, 1, 1024, 16, 16, 64, False, 0),     # decode's cross-attention, Lq = 1
])
def test_block_attn_matches_plain(cuda, b, lq, lk, h, kv, hd, causal, window):
    gen = torch.Generator().manual_seed(lq + hd)
    q, k, v = (torch.randn(b, n, heads, hd, generator=gen).to(cuda)
               for n, heads in ((lq, h), (lk, kv), (lk, kv)))
    bk.reset_launch_counts()
    got = block_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["block_attn"] == 1        # a CUDA tensor never takes the plain path
    want = block_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_block_attn_takes_strided_views(cuda):
    """q/k/v as views of one fused (B, L, heads, hd) projection: read by
    strides, no copy."""
    gen = torch.Generator().manual_seed(1)
    fused = torch.randn(2, 200, 8 + 2 + 2, 64, generator=gen).to(cuda)
    q, k, v = fused[:, :, :8], fused[:, :, 8:10], fused[:, :, 10:]
    assert not q.is_contiguous()
    got = block_attention(q, k, v)
    want = block_attention_plain(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", ["fused_hd18", "k_shifted_one_float"])
def test_block_attn_takes_unaligned_views(cuda, case):
    """Views whose K rows are not 16-byte aligned take the kernel's 4-byte
    copies: K at byte offset 216 of a fused hd-18 projection, or K one float
    into its storage at hd 64 (q and v aligned)."""
    gen = torch.Generator().manual_seed(2)
    if case == "fused_hd18":
        fused = torch.randn(2, 150, 3 + 1 + 1, 18, generator=gen).to(cuda)
        q, k, v = fused[:, :, :3], fused[:, :, 3:4], fused[:, :, 4:]
    else:
        q, v = (torch.randn(2, 150, n, 64, generator=gen).to(cuda) for n in (4, 2))
        k = torch.randn(2 * 150 * 2 * 64 + 1, generator=gen).to(cuda)[1:].view(2, 150, 2, 64)
    assert k.data_ptr() % 16 != 0
    bk.reset_launch_counts()
    got = block_attention(q, k, v)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["block_attn"] == 1
    want = block_attention_plain(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_block_attn_refuses_what_it_cannot_take(cuda):
    q = torch.zeros(1, 8, 2, 160, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        block_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 32, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        block_attention(q.double(), q.double(), q.double())
    w = torch.zeros(1, 8, 2, 32, device=cuda, requires_grad=True)
    bk.reset_launch_counts()
    out = block_attention(w, w, w)
    out.sum().backward()
    torch.cuda.synchronize()
    # Inputs that require a gradient run the forward with its log-sum-exp
    # and then the two backward kernels, never the plain version.
    assert bk.LAUNCHES["block_attn"] == 1
    assert bk.BWD_LAUNCHES == {"attn_bwd_dot": 1, "attn_bwd_dkdvq": 1}
    assert w.grad is not None and torch.isfinite(w.grad).all()


def test_dense_smoke_on_card_matches_cpu(cuda):
    """The SMOKE Yi forward and decode through the kernel on the card
    against the plain version on the CPU, from the same weights."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as T

    cfg = get_smoke("yi-6b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 80), generator=torch.Generator().manual_seed(1))
    want, _ = T.forward_train(cfg, params, tokens)
    on_card = _to(params, cuda)
    bk.reset_launch_counts()
    with torch.inference_mode():
        got, _ = T.forward_train(cfg, on_card, tokens.to(cuda))
        cache = T.init_cache(cfg, 2, 8)
        for t in range(8):
            step, cache = T.decode_step(cfg, on_card, cache, tokens[:, t:t + 1].to(cuda))
    torch.cuda.synchronize()
    assert bk.LAUNCHES["block_attn"] == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=2e-4)
    want8, _ = T.forward_train(cfg, params, tokens[:, :8])
    torch.testing.assert_close(step[:, 0].cpu(), want8[:, -1], atol=2e-3, rtol=2e-3)


def test_simulator_on_card_matches_cpu(cuda):
    """The heap simulator on ``congested_uplink`` (n=12, bits 8, overlap
    windows) on the CPU and the card from the same weights and seed words:
    equal records and Eq. 18 bits, params within 0.05 * scale + 1e-4, K hop
    launches and one aggregation launch a window on the card."""
    from repro_torch.sim import build_scenario

    setup = build_scenario("congested_uplink", n=12, seed=0, bits=8)
    k, windows = setup.cfg.k_walk, 3
    gen = torch.Generator().manual_seed(5)
    qseeds = [torch.randint(0, 1 << 32, (k + 1, 2), generator=gen) for _ in range(windows)]
    params = setup.model.init(torch.Generator().manual_seed(2), "cpu")
    res = {}
    for dev in ("cpu", cuda):
        qk.reset_launch_counts()
        res[str(dev)] = setup.runner(device=dev).run(
            windows, torch.Generator().manual_seed(0), setup.x_test, setup.y_test,
            eval_every=1, qseeds=qseeds, params=[(w.to(dev), b.to(dev)) for w, b in params])
    torch.cuda.synchronize()
    assert qk.LAUNCHES["qdq_delta_rows_rng"] == k * windows
    assert qk.LAUNCHES["qdq_rows_rng"] == windows
    a, b = res["cpu"], res[str(cuda)]
    for ra, rb in zip(a.records, b.records):
        for f in ("t_end", "events", "k_done", "k_exec", "killed", "resumed", "bits"):
            assert np.array_equal(np.asarray(getattr(ra, f)), np.asarray(getattr(rb, f))), f
    assert a.history.comm_bits == b.history.comm_bits
    want, got = a.state.device_params, b.state.device_params.cpu()
    assert float((want - got).abs().max()) < 0.05 * float(want.abs().max()) + 1e-4


@pytest.mark.parametrize("arch_id", ["deepseek-v2-lite-16b", "seamless-m4t-large-v2"])
def test_mla_and_encdec_smoke_on_card_match_cpu(cuda, arch_id):
    """The SMOKE DeepSeek (MLA in plain torch: no kernel) and Seamless (three
    ``block_attn`` launches a block: encoder, decoder, cross) forwards and
    decodes on the card against the CPU, from the same weights."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as T

    cfg = get_smoke(arch_id)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 40), generator=gen)
    emb = torch.randn(2, cfg.frontend_tokens, cfg.d_model, generator=gen) if cfg.enc_dec else None
    want, _ = T.forward_train(cfg, params, tokens, emb)
    on_card = _to(params, cuda)
    card_emb = None if emb is None else emb.to(cuda)
    bk.reset_launch_counts()
    with torch.inference_mode():
        got, _ = T.forward_train(cfg, on_card, tokens.to(cuda), card_emb)
        torch.cuda.synchronize()
        assert bk.LAUNCHES["block_attn"] == (3 * cfg.n_layers if cfg.enc_dec else 0)
        cache = T.init_cache(cfg, 2, 8)
        if cfg.enc_dec:
            cache["enc_out"] = T._run_encoder(cfg, on_card, card_emb)
        for t in range(8):
            step, cache = T.decode_step(cfg, on_card, cache, tokens[:, t:t + 1].to(cuda))
    torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=2e-4)
    # Over 8 tokens a MoE forward's capacity (at least 8) drops nothing either.
    want8, _ = T.forward_train(cfg, params, tokens[:, :8], emb)
    torch.testing.assert_close(step[:, 0].cpu(), want8[:, -1], atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("b,lq,lk,h,kv,hd,causal,window", [
    (2, 256, 256, 8, 2, 128, True, 0),      # causal GQA at hd 128
    (2, 200, 200, 4, 4, 64, False, 0),      # non-causal (an encoder), ragged
    (2, 200, 200, 4, 4, 64, True, 0),       # causal (a decoder), ragged
    (2, 96, 1000, 16, 16, 64, False, 0),    # cross-attention, Lk 1,000
    (1, 300, 300, 4, 1, 32, True, 17),      # window shorter than a tile, MQA
    (2, 130, 130, 6, 2, 18, True, 40),      # hd 18, window
    (1, 150, 40, 4, 2, 64, True, 0),        # Lq > Lk causal
    (1, 100, 60, 2, 1, 32, False, 20),      # non-causal window: rows 79+ see no key
    (2, 333, 333, 8, 2, 128, True, 100),    # GQA at hd 128 with a window, ragged
])
def test_block_attn_backward_matches_autograd_of_plain(cuda, b, lq, lk, h, kv, hd, causal,
                                                       window):
    """The backward kernels against autograd through the plain version, in
    every mode the forward takes; the forward's log-sum-exp against the
    plain one (-inf where a row attends no key)."""
    from repro_torch.kernels.block_attn.ref import attention_lse_plain

    gen = torch.Generator().manual_seed(lq + hd + 1)
    q, k, v = (torch.randn(b, n, heads, hd, generator=gen).to(cuda).requires_grad_()
               for n, heads in ((lq, h), (lk, kv), (lk, kv)))
    do = torch.randn(b, lq, h, hd, generator=gen).to(cuda)
    bk.reset_launch_counts()
    got = torch.autograd.grad(block_attention(q, k, v, causal=causal, window=window),
                              (q, k, v), do)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["block_attn"] == 1
    assert bk.BWD_LAUNCHES == {"attn_bwd_dot": 1, "attn_bwd_dkdvq": 1}
    want = torch.autograd.grad(block_attention_plain(q, k, v, causal=causal, window=window),
                               (q, k, v), do)
    _assert_grads_close(got, want, ("dq", "dk", "dv"))
    with torch.no_grad():
        _, lse = bk.block_attn_forward(q, k, v, causal=causal, window=window, with_lse=True)
        want_lse = attention_lse_plain(q, k, causal=causal, window=window)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("b,h,l,p,n,chunk,g", [
    (2, 4, 512, 64, 128, 256, 1),      # the main path's P, N and chunk
    (1, 8, 300, 32, 64, 128, 2),       # L not a chunk multiple, G > 1
    (2, 6, 96, 16, 16, 32, 3),         # P under one warp's lanes
    (1, 2, 300, 128, 128, 128, 1),     # P = 128
    (2, 3, 200, 18, 50, 64, 3),        # P 18, N 50, G = H
    (2, 4, 90, 64, 128, 256, 2),       # L under one chunk
    (2, 8, 700, 64, 128, 256, 4),      # ragged L over three chunks, G = 4
])
def test_ssd_scan_backward_matches_autograd_of_plain(cuda, b, h, l, p, n, chunk, g):
    """The six backward kernels against autograd through ``ssd_chunked_plain``,
    with the model's transposed (B, L, H, P) views as operands."""
    ops_in = _ssd_inputs(b, h, l, p, n, g, cuda)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) if t.dim() > 1 else t.clone()
             for t in ops_in]
    for t in views:
        t.requires_grad_()
    dy = torch.randn(b, h, l, p, generator=torch.Generator().manual_seed(5)).to(cuda)
    sk.reset_launch_counts()
    got = torch.autograd.grad(ssd_chunked(*views, chunk=chunk), views, dy)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["ssd_scan"] == 1
    assert sk.BWD_LAUNCHES == dict.fromkeys(sk.BWD_STAGES, 1)
    plain_in = [t.detach().clone().requires_grad_() for t in ops_in]
    want = torch.autograd.grad(ssd_chunked_plain(*plain_in, chunk)[0], plain_in, dy)
    _assert_grads_close(got, want, ("dx", "ddt", "da_log", "db", "dc"))


@pytest.mark.parametrize("l,chunk", [(512, 256), (300, 128)])
def test_ssd_scan_backward_with_underflowing_decay(cuda, l, chunk):
    """dt |A| of 10 to 15 a step: exp(cum_i - cum_j) underflows a few
    positions off the diagonal and |cum| reaches thousands inside a chunk.
    Every gradient, dA_log included, within GRAD_TOL of autograd through
    ``ssd_chunked_plain``."""
    b, h, p, n, g = 2, 4, 64, 128, 1
    x, _, a_log, bb, cc = _ssd_inputs(b, h, l, p, n, g, cuda, seed=3)
    gen = torch.Generator().manual_seed(4)
    dt = ((10.0 + 5.0 * torch.rand(b, h, l, generator=gen)).to(cuda)
          / torch.exp(a_log)[None, :, None])
    ins = [t.clone().requires_grad_() for t in (x, dt, a_log, bb, cc)]
    dy = torch.randn(b, h, l, p, generator=gen).to(cuda)
    sk.reset_launch_counts()
    got = torch.autograd.grad(ssd_chunked(*ins, chunk=chunk), ins, dy)
    torch.cuda.synchronize()
    assert sk.BWD_LAUNCHES == dict.fromkeys(sk.BWD_STAGES, 1)
    plain_in = [t.detach().clone().requires_grad_() for t in ins]
    want = torch.autograd.grad(ssd_chunked_plain(*plain_in, chunk)[0], plain_in, dy)
    _assert_grads_close(got, want, ("dx", "ddt", "da_log", "db", "dc"))


# ----------------------------------------------------------------- bf16
def _bf16_ulps(got, want, scale):
    """The largest |got - want| of two bf16 tensors in bf16 ulps, each at
    the element's magnitude but no finer than at 2^-8 * ``scale`` (the
    operands' largest magnitude): below that the float32 sums' order, not
    the one rounding, decides."""
    g, w = got.float(), want.float()
    mag = torch.maximum(torch.maximum(g.abs(), w.abs()),
                        torch.full_like(g, 2.0 ** -8 * scale))
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((g - w).abs() / ulp).max())


@pytest.mark.parametrize("b,lq,lk,h,kv,hd,causal,window", [
    (2, 300, 300, 8, 2, 128, True, 0),      # hd 128 (two TMA boxes), ragged L
    (1, 1000, 1000, 16, 2, 128, True, 0),   # GQA 8:1, L 1,000: ragged query and key tiles
    (1, 96, 96, 4, 1, 64, True, 0),         # MQA
    (2, 300, 300, 8, 8, 64, True, 0),       # MHA at hd 64
    (1, 77, 130, 4, 2, 16, False, 0),       # Lq != Lk, non-causal, hd 16 (a zero-filled box)
    (2, 200, 200, 3, 3, 24, True, 0),       # hd 24: rows of 48 bytes
    (2, 200, 200, 3, 3, 18, True, 0),       # hd 18: repacked to 24
    (1, 100, 100, 2, 2, 17, True, 0),       # odd hd: repacked to 24
    (2, 300, 300, 8, 4, 128, True, 64),     # sliding window
    (1, 300, 300, 4, 1, 128, True, 17),     # window shorter than a tile
    (1, 100, 60, 2, 1, 32, False, 20),      # non-causal window: rows 79+ see no key
    (2, 1000, 1000, 16, 16, 64, False, 0),  # an encoder over 1,000 frames
    (2, 96, 1000, 16, 16, 64, False, 0),    # cross-attention over them
    (8, 64, 1024, 16, 16, 64, False, 0),    # serve's prefill-cross chunk of 64 rows
    (8, 1, 1024, 16, 16, 64, False, 0),     # decode's cross-attention, Lq = 1
    (2, 130, 130, 8, 2, 128, True, 0),      # a 2-row ragged last query tile
    (8, 64, 1024, 8, 8, 64, False, 0),      # a model-axis rank's heads (model = 2):
    (8, 1, 1024, 8, 8, 64, False, 0),       # Seamless's serve cross calls,
    (1, 512, 512, 16, 2, 128, True, 0),     # Yi's layer 0
])
def test_block_attn_bf16_matches_plain(cuda, b, lq, lk, h, kv, hd, causal, window):
    """Within 1 bf16 ulp: both compute in float32 and round o once. Only hd
    not a multiple of 8 is repacked."""
    gen = torch.Generator().manual_seed(lq + hd)
    q, k, v = (torch.randn(b, n, heads, hd, generator=gen).to(cuda, torch.bfloat16)
               for n, heads in ((lq, h), (lk, kv), (lk, kv)))
    bk.reset_launch_counts()
    got = block_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["block_attn"] == 1 and bk.BF16_LAUNCHES["block_attn"] == 1
    assert bk.BF16_REPACKS["block_attn"] == (0 if hd % 8 == 0 else 3)
    want = block_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    assert _bf16_ulps(got, want, float(v.float().abs().max())) <= 1


@pytest.mark.parametrize("case", ["fused_qkv", "k_shifted_one_element", "fused_hd17"])
def test_block_attn_bf16_takes_views(cuda, case):
    """Views of a fused (B, L, H + 2 KV, hd) projection go to TMA as they are;
    a K one element off 16 bytes, and every operand at an odd hd, are copied
    first (BF16_REPACKS); each within 1 bf16 ulp of the plain version."""
    gen = torch.Generator().manual_seed(3)
    hd = 17 if case == "fused_hd17" else 128
    fused = torch.randn(2, 300, 8 + 2 + 2, hd, generator=gen).to(cuda, torch.bfloat16)
    q, k, v = fused[:, :, :8], fused[:, :, 8:10], fused[:, :, 10:]
    repacks = {"fused_qkv": 0, "k_shifted_one_element": 1, "fused_hd17": 3}[case]
    if case == "k_shifted_one_element":
        k = torch.randn(2 * 300 * 2 * hd + 1, generator=gen).to(cuda, torch.bfloat16)[1:]
        k = k.view(2, 300, 2, hd)
    bk.reset_launch_counts()
    got = block_attention(q, k, v)
    torch.cuda.synchronize()
    assert bk.BF16_LAUNCHES["block_attn"] == 1
    assert bk.BF16_REPACKS["block_attn"] == repacks
    want = block_attention_plain(q.contiguous(), k.contiguous(), v.contiguous())
    assert _bf16_ulps(got, want, float(v.float().abs().max())) <= 1


@pytest.mark.parametrize("b,h,l,p,n,chunk,g,large", [
    (2, 4, 512, 64, 128, 256, 4, False),     # the main path's P, N and chunk, G = 4
    (1, 8, 300, 32, 64, 128, 2, False),      # L not a chunk multiple, G < H
    (2, 4, 1000, 64, 128, 256, 1, False),    # a ragged last chunk of 232 rows
    (1, 2, 300, 128, 128, 128, 1, False),    # P = 128
    (2, 6, 96, 8, 16, 32, 1, False),         # P = 8: one n-tile; chunk under one 64-row tile
    (2, 3, 200, 18, 64, 64, 3, False),       # P = 18: x rows loaded an element at a time
    (1, 4, 200, 64, 50, 64, 2, False),       # N = 50: B/C rows loaded an element at a time
    (2, 4, 512, 64, 128, 256, 1, True),      # dt |A| of 10 to 15 a step: |cum| in the thousands
])
def test_ssd_scan_bf16_matches_plain(cuda, b, h, l, p, n, chunk, g, large):
    """Within 1 bf16 ulp: both compute in float32 and round y once."""
    x, dt, a_log, bb, cc = _ssd_inputs(b, h, l, p, n, g, cuda)
    if large:
        gen = torch.Generator().manual_seed(4)
        dt = ((10.0 + 5.0 * torch.rand(b, h, l, generator=gen)).to(cuda)
              / torch.exp(a_log)[None, :, None])
    x, bb, cc = (t.to(torch.bfloat16) for t in (x, bb, cc))
    sk.reset_launch_counts()
    got = ssd_chunked(x, dt, a_log, bb, cc, chunk=chunk)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["ssd_scan"] == 1 and sk.BF16_LAUNCHES["ssd_scan"] == 1
    assert sk.KERNEL_LAUNCHES == dict.fromkeys(sk.STAGES, 1)
    want, _ = ssd_chunked_plain(x, dt, a_log, bb, cc, chunk)
    assert got.dtype == torch.bfloat16
    assert _bf16_ulps(got, want, float(want.float().abs().max())) <= 1


def test_bf16_inputs_that_need_a_gradient_raise(cuda):
    """The backward kernels are float32: bf16 raises, naming ROADMAP A11,
    and nothing falls back."""
    q = torch.zeros(1, 8, 2, 32, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="A11"):
        block_attention(q, q, q)
    x, dt, a_log, bb, cc = _ssd_inputs(1, 2, 64, 16, 16, 1, cuda)
    x = x.to(torch.bfloat16).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="A11"):
        ssd_chunked(x, dt, a_log, bb.to(torch.bfloat16), cc.to(torch.bfloat16), chunk=32)
    with torch.no_grad():
        ssd_chunked(x, dt, a_log, bb.to(torch.bfloat16), cc.to(torch.bfloat16), chunk=32)


@pytest.mark.parametrize("arch_id", ["mamba2-130m", "yi-6b", "seamless-m4t-large-v2"])
def test_bf16_smoke_on_card_matches_cpu(cuda, arch_id):
    """The SMOKE model in bf16 on the card against the CPU, from the same
    weights: logits within 0.05 absolute and relative (each device rounds
    its bf16 products at other places), through the kernels' bf16 modes."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as T

    cfg = get_smoke(arch_id)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), torch.bfloat16, device="cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=gen)
    embeds = (torch.randn(2, cfg.frontend_tokens, cfg.d_model, generator=gen)
              if cfg.enc_dec else None)
    with torch.no_grad():
        want, _ = T.forward_train(cfg, params, tokens, embeds)
        bk.reset_launch_counts()
        sk.reset_launch_counts()
        got, _ = T.forward_train(cfg, _to(params, cuda), tokens.to(cuda),
                                 None if embeds is None else embeds.to(cuda))
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert bk.BF16_LAUNCHES["block_attn"] + sk.BF16_LAUNCHES["ssd_scan"] > 0
    torch.testing.assert_close(got.float().cpu(), want.float(), atol=0.05, rtol=0.05)
