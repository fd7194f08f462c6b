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
softmax against a materialized float32 softmax), and the SMOKE Yi model on
the card within 2e-4 of the CPU.
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
    with pytest.raises(RuntimeError, match="backward"):
        block_attention(w, w, w)


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
