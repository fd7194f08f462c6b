"""The port's blockwise attention against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both sides. On CPU
tensors ``repro_torch.kernels.block_attn.block_attention`` takes its plain
version (a materialized float32 softmax); the JAX side is the Pallas kernel
``block_attention(interpret=True)`` over the shape sweep of
tests/test_kernels_block_attn.py, and the model's ``_sdpa`` with
``_causal_mask(l, window)`` for a sliding window, which the TPU kernel
does not take.

Tolerance 1e-5 absolute and relative: both sides are float32 and differ
only in the order of the sums (online against materialized softmax) and in
the scale (the kernel and the port multiply by 1/sqrt(hd), ``_sdpa``
divides by sqrt(hd)): a few ulps, 2.4e-7 at most on these inputs.

The card's kernel computes both products on the tensor cores with a 3xTF32
split (csrc/block_attn.cu). :func:`_attention_tf32` emulates that
arithmetic here, tile for tile as the kernel walks the keys, and the
``tf32`` tests hold it to the kernel's own tolerance, 1e-4 absolute and
relative, and show that one TF32 product a term does not meet it. The bf16
kernel (csrc/block_attn_bf16.cu) is emulated by :func:`_attention_bf16`
and held within 1 bf16 ulp of the JAX kernel on bf16 inputs, where one
bf16 rounding of P is not; the host's decision of what TMA can read
(``tma_takes``) and the repack are tested on tensor metadata.
"""
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.block_attn import block_attention as j_block_attention
from repro.models import layers as JL

from repro_torch.kernels.block_attn import block_attention
from repro_torch.kernels.block_attn import block_attn as bk
from repro_torch.kernels.block_attn.ref import attention_pairs, block_attention_plain
from _torch_threads import torch_threads  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
KERNEL_TOL = 1e-4       # abs and rel: the card's kernel against the fp32 versions


def _qkv(b, lq, lk, h, kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * 0.7).astype(np.float32)
            for shape in ((b, lq, h, hd), (b, lk, kv, hd), (b, lk, kv, hd))]


def _port(arrays, **kw):
    bk.reset_launch_counts()
    out = block_attention(*(torch.from_numpy(a) for a in arrays), **kw)
    assert bk.LAUNCHES["block_attn"] == 0          # CPU tensors take the plain version
    return out.numpy()


@pytest.mark.parametrize("b,l,h,kv,hd,bq,bk_", [
    (1, 64, 2, 2, 32, 16, 16),
    (2, 128, 4, 2, 64, 32, 32),
    (1, 96, 4, 1, 32, 32, 16),    # MQA + uneven L vs blocks
    (2, 256, 8, 8, 128, 64, 64),  # hd = 128, Yi-6B's head width
    (1, 100, 2, 2, 32, 32, 32),   # L not a block multiple
])
def test_causal_matches_jax_kernel(b, l, h, kv, hd, bq, bk_):
    arrays = _qkv(b, l, l, h, kv, hd)
    want = j_block_attention(*map(jnp.asarray, arrays), bq=bq, bk=bk_, causal=True,
                             interpret=True)
    np.testing.assert_allclose(_port(arrays, causal=True), np.asarray(want), **TOL)


@pytest.mark.parametrize("l,hd", [(64, 32), (128, 64)])
def test_bidirectional_matches_jax_kernel(l, hd):
    """Non-causal at block multiples: the JAX wrapper's zero padding is not
    masked without the causal mask (its docstring: pre-pad yourself)."""
    arrays = _qkv(1, l, l, 2, 2, hd, seed=3)
    want = j_block_attention(*map(jnp.asarray, arrays), bq=32, bk=32, causal=False,
                             interpret=True)
    np.testing.assert_allclose(_port(arrays, causal=False), np.asarray(want), **TOL)


@pytest.mark.parametrize("l,h,kv,hd,window", [
    (64, 4, 2, 32, 8),
    (100, 4, 1, 64, 33),          # MQA, window not a divisor of L
    (40, 2, 2, 16, 64),           # window longer than L: plain causal
])
def test_sliding_window_matches_model_sdpa(l, h, kv, hd, window):
    arrays = _qkv(2, l, l, h, kv, hd, seed=7)
    q, k, v = map(jnp.asarray, arrays)
    want = JL._sdpa(q, k, v, JL._causal_mask(l, window), h // kv)
    np.testing.assert_allclose(_port(arrays, window=window), np.asarray(want), **TOL)


def test_causal_matches_model_sdpa():
    """The model path's own attention (additive -1e30 mask, divide by
    sqrt(hd)) at window 0, GQA."""
    arrays = _qkv(2, 64, 64, 4, 2, 32, seed=9)
    q, k, v = map(jnp.asarray, arrays)
    want = JL._sdpa(q, k, v, JL._causal_mask(64, 0), 2)
    np.testing.assert_allclose(_port(arrays), np.asarray(want), **TOL)


def test_rows_without_keys_are_zero():
    """A query that may attend no key (Lq > Lk with a window) comes out 0,
    as the kernel writes it, not nan."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 12, 4, 2, 1, 8))
    out = block_attention_plain(q, k, v, causal=True, window=3)
    assert torch.isfinite(out).all()
    assert torch.equal(out[:, 6:], torch.zeros_like(out[:, 6:]))
    assert attention_pairs(12, 4, causal=True, window=3) == 1 + 2 + 3 + 3 + 2 + 1


@pytest.mark.parametrize("lq,lk,causal,window", [
    (7, 7, True, 0), (9, 5, True, 0), (6, 6, False, 0), (10, 10, True, 4), (5, 8, False, 2),
])
def test_attention_pairs_counts_the_mask(lq, lk, causal, window):
    i = np.arange(lq)[:, None]
    j = np.arange(lk)[None, :]
    ok = np.ones((lq, lk), bool)
    if causal:
        ok &= j <= i
    if window:
        ok &= (i - j) < window
    assert attention_pairs(lq, lk, causal=causal, window=window) == int(ok.sum())


def test_other_devices_are_refused():
    """A CPU tensor takes the plain version, and a meta tensor its shapes
    (the dry run's count, nothing computed); any device other than the CPU,
    a card or meta is refused, not computed."""
    q, k, v = (torch.from_numpy(a).to("meta") for a in _qkv(1, 8, 8, 2, 2, 8))
    o = block_attention(q, k, v)
    assert o.device.type == "meta" and o.shape == q.shape and o.dtype == q.dtype
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="CPU, CUDA or meta"):
        block_attention(other, k, v)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on float32: the magnitude rounded to 10 mantissa
    bits, ties away from zero, by adding half of the dropped 13 bits' unit
    and clearing them."""
    bits = x.view(torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (mag | (bits & ~0x7FFFFFFF)).view(torch.float32)


def _mm_tf32(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the tensor cores compute it from TF32 operands (a product of
    two TF32 values is exact in float32, the sums are float32): one pass
    big.big, or the kernel's three, small.big + big.small + big.big."""
    a_big, b_big = _tf32(a), _tf32(b)
    if passes == 1:
        return a_big @ b_big
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _attention_tf32(q, k, v, *, causal, window, passes, q_tile=128, k_tile=64):
    """The kernel's arithmetic on CPU tensors: per (batch, head, 128-row
    query tile) the 64-key tiles from the window's first to the diagonal,
    scores scaled by log2(e)/sqrt(hd), masked to -inf before exp2, an
    online softmax, and both products through :func:`_mm_tf32`."""
    b, lq, h, hd = q.shape
    lk, group = k.shape[1], h // k.shape[2]
    scale_log2 = torch.tensor(1.0 / math.sqrt(hd) * math.log2(math.e), dtype=torch.float32)
    out = torch.zeros_like(q)
    for bi in range(b):
        for hh in range(h):
            qh, kh, vh = q[bi, :, hh], k[bi, :, hh // group], v[bi, :, hh // group]
            for q0 in range(0, lq, q_tile):
                rows = torch.arange(q0, min(q0 + q_tile, lq))
                k_end = min(lk, int(rows[-1]) + 1) if causal else lk
                k_begin = max(0, q0 - window + 1) if window > 0 else 0
                m = torch.full((len(rows),), -math.inf)
                l = torch.zeros(len(rows))
                acc = torch.zeros(len(rows), hd)
                for t in range(k_begin // k_tile, -(-k_end // k_tile)):
                    cols = torch.arange(t * k_tile, min(t * k_tile + k_tile, lk))
                    s = _mm_tf32(qh[rows], kh[cols].T, passes) * scale_log2
                    ok = torch.ones(len(rows), len(cols), dtype=torch.bool)
                    if causal:
                        ok &= cols[None] <= rows[:, None]
                    if window > 0:
                        ok &= (rows[:, None] - cols[None]) < window
                    s = s.masked_fill(~ok, -math.inf)
                    m_new = torch.maximum(m, s.amax(1))
                    alpha = torch.where(m == -math.inf, 0.0, torch.exp2(m - m_new))
                    p = torch.where(s == -math.inf, 0.0, torch.exp2(s - m_new[:, None]))
                    l = l * alpha + p.sum(1)
                    m = m_new
                    acc = acc * alpha[:, None] + _mm_tf32(p, vh[cols], passes)
                out[bi, rows, hh] = torch.where(l[:, None] > 0, acc / l[:, None], 0.0)
    return out


def _tol_ratio(got, want):
    """max |got - want| / (tol + tol |want|): at most 1 meets the tolerance."""
    return float(((got - want).abs() / (KERNEL_TOL + KERNEL_TOL * want.abs())).max())


def test_tf32_rounding_is_rna():
    """Ties go away from zero on both signs; below a tie rounds down; the
    split's big + small is within 2^-22 of x."""
    tie, below = 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 - 2.0 ** -23
    x = torch.tensor([tie, -tie, below, -below, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, -1.0, 3.0, 0.0])
    assert torch.equal(_tf32(x), want)
    r = torch.from_numpy(np.random.default_rng(2).standard_normal(4096).astype(np.float32))
    big = _tf32(r)
    small = _tf32(r - big)
    assert torch.equal(_tf32(big), big) and torch.equal(_tf32(small), small)
    assert bool(((r - (big + small)).abs() <= 2.0 ** -22 * r.abs()).all())


# hd = 128 (Yi-6B's head width) at two lengths, plain causal and a sliding
# window shorter than a query tile. q is drawn twice as wide as k and v, so
# the scores have a standard deviation of about 1 (a trained model's
# order): one TF32 product then errs by ~2^-11 of each score, several
# times the tolerance in the output, while the split's error stays well
# under it.
TF32_CASES = [(256, 0), (512, 0), (256, 100), (512, 100)]


def _tf32_inputs(l, seed):
    q, k, v = _qkv(1, l, l, 4, 2, 128, seed=seed)
    return q * 2.0, k, v


@pytest.mark.parametrize("l,window", TF32_CASES)
def test_tf32_split_meets_the_kernel_tolerance(l, window):
    """The kernel's 3xTF32 arithmetic within 1e-4 of the JAX reference (the
    Pallas kernel in interpret mode; the model's ``_sdpa`` for a window)
    and of the fp32 plain version."""
    arrays = _tf32_inputs(l, seed=11)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    if window == 0:
        want = j_block_attention(*map(jnp.asarray, arrays), bq=64, bk=64, causal=True,
                                 interpret=True)
    else:
        jq, jk, jv = map(jnp.asarray, arrays)
        want = JL._sdpa(jq, jk, jv, JL._causal_mask(l, window), 2)
    got = _attention_tf32(q, k, v, causal=True, window=window, passes=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_TOL, rtol=KERNEL_TOL)
    plain = block_attention_plain(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got, plain, atol=KERNEL_TOL, rtol=KERNEL_TOL)


@pytest.mark.parametrize("l,window", TF32_CASES)
def test_single_pass_tf32_breaks_the_kernel_tolerance(l, window):
    """One TF32 product a term, on the same inputs, is more than twice the
    tolerance away from the fp32 plain version: the test above can tell the
    kernel's split from plain TF32."""
    q, k, v = (torch.from_numpy(a) for a in _tf32_inputs(l, seed=11))
    plain = block_attention_plain(q, k, v, causal=True, window=window)
    one_pass = _attention_tf32(q, k, v, causal=True, window=window, passes=1)
    three = _attention_tf32(q, k, v, causal=True, window=window, passes=3)
    assert _tol_ratio(one_pass, plain) > 2.0
    assert _tol_ratio(three, plain) < 0.5


# ------------------------------------------------------------- the backward
GRAD_TOL = 2e-4          # of each gradient's largest magnitude, as the card holds it


def _mm_tf32_bwd(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """:func:`_mm_tf32` as the backward kernels take it: the B operand's
    small part goes to the tensor core unrounded, which reads its top 19
    bits (a truncation)."""
    if passes == 1:
        return _mm_tf32(a, b, 1)
    a_big, b_big = _tf32(a), _tf32(b)
    a_small = _tf32(a - a_big)
    b_small = ((b - b_big).view(torch.int32) & ~0x1FFF).view(torch.float32)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _attention_backward_tf32(q, k, v, do, *, causal, window, passes):
    """The backward kernels' arithmetic on CPU tensors (csrc/block_attn.cu):
    D = rowsum(dO o O) and lse log2(e) once a row (attn_bwd_dot), P =
    exp2(S scale log2(e) - lse log2(e)) masked before the exp and 0 for a
    row that attends no key, dS = P (dP - D), and all five products (S, dP,
    dV, dK, dQ) through :func:`_mm_tf32_bwd`; dK and dV summed over each KV
    group. O and the log-sum-exp are the plain forward's."""
    from repro_torch.kernels.block_attn.ref import attention_lse_plain

    b, lq, h, hd = q.shape
    lk, group = k.shape[1], h // k.shape[2]
    o = block_attention_plain(q, k, v, causal=causal, window=window)
    lse2 = attention_lse_plain(q, k, causal=causal, window=window) * math.log2(math.e)
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    scale_log2 = torch.tensor(1.0 / math.sqrt(hd) * math.log2(math.e), dtype=torch.float32)
    i, j = torch.arange(lq)[:, None], torch.arange(lk)[None, :]
    ok = torch.ones(lq, lk, dtype=torch.bool)
    if causal:
        ok &= j <= i
    if window > 0:
        ok &= (i - j) < window
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for bi in range(b):
        for hh in range(h):
            qh, doh = q[bi, :, hh], do[bi, :, hh]
            kh, vh = k[bi, :, hh // group], v[bi, :, hh // group]
            d = (doh * o[bi, :, hh]).sum(-1)
            l2 = lse2[bi, hh][:, None]
            live = ok & (l2 != -math.inf)
            s = _mm_tf32_bwd(qh, kh.T, passes) * scale_log2
            p = torch.where(live, torch.exp2(s - torch.where(live, l2, 0.0)), 0.0)
            ds = p * (_mm_tf32_bwd(doh, vh.T, passes) - d[:, None])
            dv[bi, :, hh // group] += _mm_tf32_bwd(p.T, doh, passes)
            dk[bi, :, hh // group] += _mm_tf32_bwd(ds.T, qh, passes) * scale
            dq[bi, :, hh] = _mm_tf32_bwd(ds, kh, passes) * scale
    return dq, dk, dv


def _grad_ratio(got, want):
    """The worst over the gradients of max|got - want| / max|want|."""
    return max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))


# (Lq, Lk, causal, window): Yi-6B's hd 128 causal and with a window, and a
# non-causal cross-attention with rows past the window that attend no key.
BWD_TF32_CASES = [(256, 256, True, 0), (256, 256, True, 100), (96, 200, False, 0),
                  (120, 60, False, 24)]


def _bwd_tf32_inputs(lq, lk, seed):
    q, k, v = _qkv(1, lq, lk, 4, 2, 128, seed=seed)
    do = np.random.default_rng(seed + 1).standard_normal(q.shape).astype(np.float32)
    return [torch.from_numpy(a) for a in (q * 2.0, k, v, do)]


@pytest.mark.parametrize("lq,lk,causal,window", BWD_TF32_CASES)
def test_backward_tf32_split_meets_the_grad_tolerance(lq, lk, causal, window):
    """The backward kernels' 3xTF32 arithmetic within a tenth of GRAD_TOL
    of autograd through the fp32 plain version, gradient by gradient."""
    q, k, v, do = _bwd_tf32_inputs(lq, lk, seed=13)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(block_attention_plain(*ins, causal=causal, window=window), ins, do)
    got = _attention_backward_tf32(q, k, v, do, causal=causal, window=window, passes=3)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert _grad_ratio(got, want) < 0.1 * GRAD_TOL


@pytest.mark.parametrize("lq,lk,causal,window", BWD_TF32_CASES)
def test_backward_single_pass_tf32_breaks_the_grad_tolerance(lq, lk, causal, window):
    """One TF32 product a term misses GRAD_TOL on the same inputs: the
    backward kernels keep the 3xTF32 split."""
    q, k, v, do = _bwd_tf32_inputs(lq, lk, seed=13)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(block_attention_plain(*ins, causal=causal, window=window), ins, do)
    got = _attention_backward_tf32(q, k, v, do, causal=causal, window=window, passes=1)
    assert _grad_ratio(got, want) > GRAD_TOL


# ------------------------------------------------------------ the bf16 kernel
# csrc/block_attn_bf16.cu: bf16 q, k, v on the bf16 tensor cores. S = Q K^T
# is exact products summed in float32; P stays float32 for the row sums and
# enters P V as two bf16 halves, hi = bf16(P) and lo = bf16(P - hi), each
# 64-key tile's P V summed apart and added to the float32 output with the
# online softmax's rescale; o is rounded once. The contract is the plain bf16
# version's: within 1 bf16 ulp of the JAX kernel (tests/test_torch_bf16.py).
BF = torch.bfloat16


def _bf16_ulps(want, got, scale):
    """The largest |got - want| in bf16 ulps, each at the element's magnitude
    but no finer than at 2^-8 * ``scale`` (tests/test_torch_bf16.py)."""
    w, g = np.asarray(want, np.float32), np.asarray(got, np.float32)
    mag = np.maximum(np.maximum(np.abs(w), np.abs(g)), 2.0 ** -8 * scale)
    return float((np.abs(g - w) / 2.0 ** (np.floor(np.log2(mag)) - 7)).max())


def _attention_bf16(q, k, v, *, causal, window=0, split=True, k_tile=64):
    """The bf16 kernel's arithmetic on CPU tensors (bf16 in, bf16 out): per
    (batch, head) the 64-key tiles in order, raw scores masked to -inf, the
    running max m of the scores times c = float32(1/sqrt(hd)) *
    float32(log2 e), P = 2^(s c - m) with one rounding (the kernel's fma),
    l summed from float32 P, each tile's P V from P's two bf16 halves
    (``split``) or from one bf16 rounding of P, and o = acc * (1 / l). A
    tile that masks every key of a row leaves the row as it was, so the
    query tiling does not enter."""
    b, lq, h, hd = q.shape
    lk, group = k.shape[1], h // k.shape[2]
    scale_log2 = (torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
                  * torch.tensor(math.log2(math.e), dtype=torch.float32))
    rows = torch.arange(lq)[:, None]
    out = torch.zeros(b, lq, h, hd, dtype=BF)
    for bi in range(b):
        for hh in range(h):
            qh, kh, vh = (t.float() for t in (q[bi, :, hh], k[bi, :, hh // group],
                                               v[bi, :, hh // group]))
            m = torch.full((lq,), -math.inf)
            l = torch.zeros(lq)
            acc = torch.zeros(lq, hd)
            for t0 in range(0, lk, k_tile):
                cols = torch.arange(t0, min(t0 + k_tile, lk))[None]
                s = qh @ kh[t0:t0 + k_tile].T
                ok = torch.ones(lq, cols.shape[1], dtype=torch.bool)
                if causal:
                    ok &= cols <= rows
                if window > 0:
                    ok &= (rows - cols) < window
                s = s.masked_fill(~ok, -math.inf)
                m_new = torch.maximum(m, s.amax(1) * scale_log2)
                alpha = torch.where(m == -math.inf, 0.0, torch.exp2(m - m_new))
                arg = (s.double() * scale_log2.double() - m_new[:, None].double()).float()
                p = torch.where(s == -math.inf, 0.0, torch.exp2(arg))
                l = l * alpha + p.sum(1)
                hi = p.to(BF).float()
                vt = vh[t0:t0 + k_tile]
                pv = (p - hi).to(BF).float() @ vt + hi @ vt if split else hi @ vt
                acc = acc * alpha[:, None] + pv
                m = m_new
            inv = torch.where(l > 0, 1.0 / l, 0.0)
            out[bi, :, hh] = (acc * inv[:, None]).to(BF)
    return out


BF16_ATTN_CASES = [  # (B, L, H, KV, hd, causal, window): JAX's blocks of 32
    (2, 96, 4, 2, 32, True, 0),
    (1, 64, 2, 2, 32, False, 0),
    (2, 64, 4, 1, 16, True, 0),
    (1, 128, 8, 2, 64, True, 0),
    (1, 256, 4, 2, 128, True, 0),     # Yi-6B's head width, four key tiles
    (1, 256, 4, 2, 128, True, 100),   # a window: against the plain version
]


@pytest.mark.parametrize("case", BF16_ATTN_CASES)
def test_bf16_kernel_arithmetic_within_one_ulp_of_jax(case):
    """The bf16 kernel's tile walk and split P V within 1 bf16 ulp of the
    port's plain bf16 version and, without a window (which the Pallas kernel
    does not take), of the Pallas kernel on bf16 inputs in interpret mode."""
    b, l, h, kv, hd, causal, window = case
    rng = np.random.default_rng(sum(case))
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, l, h, hd), (b, l, kv, hd), (b, l, kv, hd)))
    tq, tk, tv = (torch.from_numpy(a).to(BF) for a in (q, k, v))
    got = _attention_bf16(tq, tk, tv, causal=causal, window=window).float().numpy()
    scale = float(np.abs(v).max())
    plain = block_attention_plain(tq, tk, tv, causal=causal, window=window)
    assert _bf16_ulps(plain.float().numpy(), got, scale) <= 1
    if window == 0:
        want = j_block_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), bq=32,
                                 bk=32, causal=causal, interpret=True)
        assert _bf16_ulps(np.asarray(want, np.float32), got, scale) <= 1


def _rounding_biased_case(seed=5, lk=1024, hd=64):
    """One query over 1,024 keys whose weights all lie in (0.6, 1] (small
    scores), and v_j = +1 where bf16(P_j) rounds P_j up, -1 where it rounds
    down: every weight's rounding error adds to o's, and o itself is small
    (the signs are as good as random)."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy((0.1 * rng.standard_normal((1, 1, 1, hd))).astype(np.float32)).to(BF)
    k = torch.from_numpy((0.1 * rng.standard_normal((1, lk, 1, hd))).astype(np.float32)).to(BF)
    scale_log2 = (torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
                  * torch.tensor(math.log2(math.e), dtype=torch.float32))
    s = q[0, :, 0].float() @ k[0, :, 0].float().T
    p = torch.exp2((s.double() * scale_log2.double() - float(s.amax() * scale_log2)).float())[0]
    v = torch.where(p.to(BF).float() >= p, 1.0, -1.0)
    return q, k, v.reshape(1, lk, 1, 1).expand(1, lk, 1, hd).contiguous().to(BF)


def test_one_bf16_rounding_of_p_breaks_the_contract():
    """On the rounding-biased case, P rounded once to bf16 puts o more than
    one bf16 ulp from the JAX reference, while the kernel's two halves stay
    within 1: the kernel keeps P_lo."""
    q, k, v = _rounding_biased_case()
    want = np.asarray(j_block_attention(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                          for t in (q, k, v)), bq=32, bk=32, causal=False,
                                        interpret=True), np.float32)
    one = _attention_bf16(q, k, v, causal=False, split=False)
    two = _attention_bf16(q, k, v, causal=False, split=True)
    assert _bf16_ulps(want, one.float().numpy(), 1.0) > 2.0
    assert _bf16_ulps(want, two.float().numpy(), 1.0) <= 1


@pytest.mark.parametrize("shape,strides_of,offset,takes", [
    ((2, 300, 8, 128), None, 0, True),          # contiguous
    ((2, 300, 8, 128), (300 * 12 * 128, 12 * 128, 128, 1), 0, True),   # a fused-QKV view
    ((2, 300, 8, 128), None, 1, False),         # one element off 16 bytes
    ((2, 300, 8, 17), None, 0, False),          # hd not a multiple of 8
    ((2, 300, 8, 24), (300 * 8 * 24 + 4, 8 * 24, 24, 1), 0, False),  # a batch stride off 8
    ((1, 1, 8, 64), (5, 3, 64, 1), 0, True),    # size-1 batch and sequence: strides unused
])
def test_tma_takes_what_a_tensor_map_can_read(shape, strides_of, offset, takes):
    """The host's decision: base 16-byte aligned, hd a multiple of 8, the
    strides of dimensions longer than 1 multiples of 8 elements."""
    strides = strides_of or tuple(int(np.prod(shape[i + 1:])) for i in range(4))
    size = offset + sum((n - 1) * st for n, st in zip(shape, strides)) + 1
    t = torch.zeros(size + 8, dtype=BF)[offset:].as_strided(shape, strides)
    assert bk.tma_takes(t) is takes


def test_repack_for_tma_keeps_the_values():
    """The repack is a contiguous copy, the columns past hd zeros, which TMA
    takes; the kernel reads it hd_in wide and writes o hd wide."""
    base = torch.from_numpy(np.random.default_rng(0).standard_normal(2 * 50 * 3 * 17 + 1)
                            .astype(np.float32)).to(BF)
    t = base[1:].view(2, 50, 3, 17)
    packed = bk.repack_for_tma(t, 24)
    assert packed.shape == (2, 50, 3, 24) and packed.is_contiguous()
    assert torch.equal(packed[..., :17], t) and not packed[..., 17:].any()
    assert bk.tma_takes(packed) and not bk.tma_takes(t)
