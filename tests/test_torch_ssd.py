"""The port's SSD chunked scan against the JAX package's, on the CPU.

``repro_torch.kernels.ssd_scan.ssd_chunked`` on a CPU tensor takes its plain
version (``ssd_chunked_plain``); it is held against the Pallas kernel in
interpret mode (``repro.kernels.ssd_scan.ssd_chunked(..., interpret=True)``)
and against the reference's sequential recurrence, over the shape sweep of
tests/test_kernels_ssd.py plus a grouped B/C case (G < H) and a padded one
(L = 50, chunk 16). The port's own ``ssd_sequential_ref`` is held to the
reference's too.

Tolerance: 2e-4 absolute and relative, as tests/test_kernels_ssd.py holds
the TPU kernel. Every side is float32, summed in another order.

The CUDA kernels are held against the plain version on the card by
tests/test_torch_gpu.py. They compute every product on the tensor cores
with a 3xTF32 split (csrc/ssd_scan.cu); :func:`_ssd_tf32` emulates that
arithmetic here stage for stage (C B^T per group, the chunk states, the
sequential state pass, the chunk scan, float64 prefix sums), and the
``tf32`` tests hold it within half the tolerance, 1e-4, of the Pallas
kernel, and show that one TF32 product a term does not meet 2e-4.
The six backward kernels' arithmetic (the chunked matrix form of the
gradient, tests/test_torch_train.py ``_ssd_backward_as_the_kernels``) runs
with every product through :func:`_mm_tf32`, held within GRAD_TOL of
autograd through the plain version, where one TF32 product a term is not.
The bf16 stage kernels' arithmetic (bf16 operands exact, each float32 side
as two bf16 halves) is :func:`_ssd_bf16`, held within the bf16 plain
version's tolerance of the Pallas kernel and within 1 bf16 ulp of the plain
version.
"""
import functools
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from repro.kernels.ssd_scan import ssd_chunked as j_ssd_chunked
from repro.kernels.ssd_scan.ref import ssd_sequential_ref as j_sequential

from repro_torch.kernels.ssd_scan import ssd_chunked
from repro_torch.kernels.ssd_scan.ref import ssd_sequential_ref
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_plain
from repro_torch.kernels.ssd_scan.ssd_scan import (
    KERNEL_LAUNCHES, LAUNCHES, STAGES, reset_launch_counts,
)

from test_torch_train import _ssd_backward_as_the_kernels

TOL = dict(atol=2e-4, rtol=2e-4)

CASES = {                        # b, h, l, p, n, chunk, groups
    "sweep-1x1x16": (1, 1, 16, 8, 8, 8, 1),
    "sweep-2x4x64": (2, 4, 64, 32, 16, 16, 4),
    "sweep-2x2x128": (2, 2, 128, 64, 32, 32, 2),
    "sweep-1x8x96": (1, 8, 96, 16, 16, 32, 8),
    "sweep-p64-n128": (2, 4, 64, 64, 128, 16, 4),
    "grouped-g2-h8": (2, 8, 32, 16, 16, 16, 2),
    "padded-l50-c16": (1, 2, 50, 16, 8, 16, 2),
}


def _inputs(b, h, l, p, n, g, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, h, l, p)) * 0.8).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, h, l)), 0.0).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 8.0, h)).astype(np.float32)
    bb = (rng.standard_normal((b, g, l, n)) * 0.5).astype(np.float32)
    cc = (rng.standard_normal((b, g, l, n)) * 0.5).astype(np.float32)
    return x, dt, a_log, bb, cc


@pytest.mark.parametrize("case", list(CASES))
def test_ssd_chunked_matches_jax(case):
    b, h, l, p, n, chunk, g = CASES[case]
    arrays = _inputs(b, h, l, p, n, g)
    x, dt, a_log, bb, cc = arrays
    reset_launch_counts()
    got = ssd_chunked(*map(torch.from_numpy, arrays), chunk=chunk)
    assert LAUNCHES["ssd_scan"] == 0            # a CPU tensor never reaches the kernels
    assert KERNEL_LAUNCHES == dict.fromkeys(STAGES, 0)
    assert got.shape == (b, h, l, p) and got.dtype == torch.float32

    y_ker = np.asarray(j_ssd_chunked(*map(jnp.asarray, arrays), chunk=chunk, interpret=True))
    np.testing.assert_allclose(got.numpy(), y_ker, **TOL)

    rep = h // g
    b_full, c_full = np.repeat(bb, rep, axis=1), np.repeat(cc, rep, axis=1)
    y_seq = np.asarray(j_sequential(*map(jnp.asarray, (x, dt, a_log, b_full, c_full))))
    np.testing.assert_allclose(got.numpy(), y_seq, **TOL)
    mine_seq = ssd_sequential_ref(*map(torch.from_numpy, (x, dt, a_log, b_full, c_full)))
    np.testing.assert_allclose(mine_seq.numpy(), y_seq, **TOL)


def test_ssd_chunked_refuses_other_devices():
    """The plain version runs only because the tensor lies on the CPU."""
    meta = [torch.from_numpy(a).to("meta") for a in _inputs(1, 2, 16, 8, 8, 1)]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ssd_chunked(*meta, chunk=8)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on float32: the magnitude rounded to 10 mantissa
    bits, ties away from zero."""
    bits = x.view(torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (mag | (bits & ~0x7FFFFFFF)).view(torch.float32)


def _truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of a float32 register given as .tf32: its
    top 19 bits, the low 13 mantissa bits dropped."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b from TF32 operands, float32 sums: one pass big.big, or the
    kernels' three, small.big + big.small + big.big, with big = rna(x) and
    small = x - big as the tensor core reads it (truncated)."""
    a_big, b_big = _tf32(a), _tf32(b)
    if passes == 1:
        return a_big @ b_big
    a_small, b_small = _truncate_tf32(a - a_big), _truncate_tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _ssd_tf32(x, dt, a_log, b, c, chunk, passes):
    """The four kernels' arithmetic on CPU tensors, every product through
    :func:`_mm_tf32`: C B^T once per group (chunk_cb); dS_c = (B o w)^T x
    with w = dt exp(cum_last - cum) (chunk_state); S_c carried in order
    (state_pass); exp(cum_i) (C S_c)_i + (C B^T o L o dt_j) x with L masked
    before the exp (chunk_scan). cum is float64 and in units of log2 (times
    log2(e)); each difference and each cum is rounded to float32 once, then
    raised with exp2."""
    bsz, h, l, p = x.shape
    g, n = b.shape[1], b.shape[3]
    pad = (-l) % chunk                                  # zero rows with dt = 0
    x, b, c = (F.pad(t, (0, 0, 0, pad)) for t in (x, b, c))
    dt = F.pad(dt, (0, pad))
    nc = (l + pad) // chunk
    dtc = dt.reshape(bsz, h, nc, chunk)
    cum = torch.cumsum((dtc * -torch.exp(a_log)[:, None, None]).double(), -1)
    cum = cum * math.log2(math.e)
    bc, cc = (t.reshape(bsz, g, nc, chunk, n) for t in (b, c))
    group = torch.arange(h) // (h // g)
    xc = x.reshape(bsz, h, nc, chunk, p)

    cb = _mm_tf32(cc, bc.transpose(-1, -2), passes)                    # (b, g, nc, C, C)
    last = cum[..., -1:]
    w = dtc * torch.exp2((last - cum).float())
    ds = _mm_tf32((bc[:, group] * w[..., None]).transpose(-1, -2), xc, passes)
    decay = torch.exp2(last[..., 0].float())
    state, entering = torch.zeros(bsz, h, n, p), []
    for z in range(nc):
        entering.append(state)
        state = decay[:, :, z, None, None] * state + ds[:, :, z]
    y = torch.exp2(cum.float())[..., None] * _mm_tf32(cc[:, group], torch.stack(entering, 2),
                                                     passes)
    mask = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    diff = (cum[..., :, None] - cum[..., None, :]).float().masked_fill(~mask, float("-inf"))
    y = y + _mm_tf32(cb[:, group] * torch.exp2(diff) * dtc[..., None, :], xc, passes)
    return y.reshape(bsz, h, nc * chunk, p)[:, :, :l]


def _tol_ratio(got, want):
    """max |got - want| / (tol + tol |want|) at 2e-4: at most 1 meets it."""
    return float(((got - want).abs() / (2e-4 + 2e-4 * want.abs())).max())


@pytest.mark.parametrize("case", list(CASES))
def test_tf32_split_meets_half_the_tolerance(case):
    """The kernels' 3xTF32 arithmetic within 1e-4 (half of 2e-4) of the
    Pallas kernel in interpret mode and of the plain version."""
    b, h, l, p, n, chunk, g = CASES[case]
    arrays = _inputs(b, h, l, p, n, g)
    tensors = [torch.from_numpy(a) for a in arrays]
    got = _ssd_tf32(*tensors, chunk, passes=3)
    y_ker = np.asarray(j_ssd_chunked(*map(jnp.asarray, arrays), chunk=chunk, interpret=True))
    np.testing.assert_allclose(got.numpy(), y_ker, atol=1e-4, rtol=1e-4)
    plain, _ = ssd_chunked_plain(*tensors, chunk)
    torch.testing.assert_close(got, plain, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_single_pass_tf32_breaks_the_tolerance(case):
    """One TF32 product a term, on the same inputs, is more than 2e-4 away
    from the Pallas kernel (2.2 to 16 times the tolerance over the sweep),
    while the split stays under a tenth of it: the kernels keep 3xTF32."""
    b, h, l, p, n, chunk, g = CASES[case]
    arrays = _inputs(b, h, l, p, n, g)
    tensors = [torch.from_numpy(a) for a in arrays]
    y_ker = torch.tensor(np.asarray(
        j_ssd_chunked(*map(jnp.asarray, arrays), chunk=chunk, interpret=True)))
    assert _tol_ratio(_ssd_tf32(*tensors, chunk, passes=1), y_ker) > 2.0
    assert _tol_ratio(_ssd_tf32(*tensors, chunk, passes=3), y_ker) < 0.1


# The backward (B, H, L, P, N, G, chunk, large): "large" draws dt |A| from 10
# to 15 a step, so |cum| reaches thousands inside a chunk and L underflows a
# few positions off the diagonal.
BWD_CASES = {
    "small": (1, 2, 64, 16, 16, 1, 32, False),
    "ragged-g2": (2, 4, 80, 8, 16, 2, 32, False),
    "p64-n128": (1, 2, 96, 64, 128, 1, 32, False),
    "large-cum": (1, 2, 256, 8, 16, 1, 256, True),
    "large-cum-2-chunks": (1, 3, 512, 16, 32, 1, 256, True),
}
GRAD_TOL = 2e-4          # of each gradient's largest magnitude, as the card holds it


def _bwd_inputs(case):
    b, h, l, p, n, g, chunk, large = BWD_CASES[case]
    x, dt, a_log, bb, cc = (torch.from_numpy(a) for a in _inputs(b, h, l, p, n, g, seed=5))
    if large:
        gen = torch.Generator().manual_seed(1)
        dt = (10.0 + 5.0 * torch.rand(b, h, l, generator=gen)) / torch.exp(a_log)[None, :, None]
    dy = torch.from_numpy(np.random.default_rng(9).standard_normal((b, h, l, p))
                          .astype(np.float32))
    return (x, dt, a_log, bb, cc, dy), chunk


def _bwd_ratio(case, passes):
    """The worst over dx, ddt, dA_log, dB, dC of max|d| / max|want| against
    autograd through ``ssd_chunked_plain`` (float32)."""
    (x, dt, a_log, bb, cc, dy), chunk = _bwd_inputs(case)
    ins = [t.clone().requires_grad_() for t in (x, dt, a_log, bb, cc)]
    want = torch.autograd.grad(ssd_chunked_plain(*ins, chunk)[0], ins, dy)
    got = _ssd_backward_as_the_kernels(x, dt, a_log, bb, cc, dy, chunk,
                                       mm=functools.partial(_mm_tf32, passes=passes))
    assert all(bool(torch.isfinite(g).all()) for g in got)
    return max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))


def test_large_cum_case_reaches_thousands():
    (_, dt, a_log, *_), chunk = _bwd_inputs("large-cum")
    cum = torch.cumsum((dt * -torch.exp(a_log)[None, :, None]).double()[..., :chunk], -1)
    assert float(cum.abs().max()) > 2000.0


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_backward_tf32_split_meets_the_grad_tolerance(case):
    """The backward kernels' 3xTF32 arithmetic within a tenth of GRAD_TOL
    of autograd through the plain version, every gradient, dA_log too."""
    assert _bwd_ratio(case, passes=3) < 0.1 * GRAD_TOL


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_backward_single_pass_tf32_breaks_the_grad_tolerance(case):
    """One TF32 product a term misses GRAD_TOL on the same inputs: the
    backward kernels keep the 3xTF32 split."""
    assert _bwd_ratio(case, passes=1) > GRAD_TOL


# ------------------------------------------------------------ the bf16 mode
# ssd_scan.cu's bf16 stage kernels: bf16 x, B and C on the bf16 tensor cores.
# A product of two bf16 values is exact in float32; C B^T is one product, and
# each float32 side (the masked scores, the chunk states, B o w) goes in as
# two bf16 halves, hi = bf16(v) and lo = bf16(v - hi). The states and the
# prefix sums stay as in float32; y is rounded once to bf16.
BF = torch.bfloat16
BF16_SSD_TOL = dict(atol=1e-2, rtol=1e-2)   # tests/test_torch_bf16.py's SSD_TOL


def _halves(v: torch.Tensor) -> tuple:
    hi = v.to(BF).float()
    return hi, (v - hi).to(BF).float()


def _mm_split(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with a float32 split into bf16 halves and b exact in bf16: the
    lo product, then the hi one, summed in float32."""
    hi, lo = _halves(a)
    return lo @ b + hi @ b


def _ssd_bf16(x, dt, a_log, b, c, chunk):
    """The bf16 stage kernels' arithmetic on CPU tensors (x, b, c bf16): C B^T
    per group, one product (chunk_cb); dS_c = (B o w)^T x with B o w split
    (chunk_state); S_c carried in float32 and handed on split (state_pass);
    exp(cum_i) (C S_c)_i with S_c split, plus the split masked scores C B^T o
    L o dt_j times x (chunk_scan); cum float64 in units of log2, each cum and
    difference rounded to float32 once; y rounded once to bf16."""
    bsz, h, l, p = x.shape
    g, n = b.shape[1], b.shape[3]
    pad = (-l) % chunk
    x, b, c = (F.pad(t.float(), (0, 0, 0, pad)) for t in (x, b, c))
    dt = F.pad(dt, (0, pad))
    nc = (l + pad) // chunk
    dtc = dt.reshape(bsz, h, nc, chunk)
    cum = torch.cumsum((dtc * -torch.exp(a_log)[:, None, None]).double(), -1)
    cum = cum * math.log2(math.e)
    bc, cc = (t.reshape(bsz, g, nc, chunk, n) for t in (b, c))
    group = torch.arange(h) // (h // g)
    xc = x.reshape(bsz, h, nc, chunk, p)

    cb = cc @ bc.transpose(-1, -2)
    last = cum[..., -1:]
    w = dtc * torch.exp2((last - cum).float())
    ds = _mm_split((bc[:, group] * w[..., None]).transpose(-1, -2), xc)
    decay = torch.exp2(last[..., 0].float())
    state, entering = torch.zeros(bsz, h, n, p), []
    for z in range(nc):
        entering.append(state)
        state = decay[:, :, z, None, None] * state + ds[:, :, z]
    s_hi, s_lo = _halves(torch.stack(entering, 2))
    cg = cc[:, group]
    y = torch.exp2(cum.float())[..., None] * (cg @ s_lo + cg @ s_hi)
    mask = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    diff = (cum[..., :, None] - cum[..., None, :]).float().masked_fill(~mask, float("-inf"))
    y = y + _mm_split(cb[:, group] * torch.exp2(diff) * dtc[..., None, :], xc)
    return y.reshape(bsz, h, nc * chunk, p)[:, :, :l].to(BF)


BF16_CASES = {  # (B, H, L, P, N, G, chunk)
    "two_groups": (1, 2, 64, 32, 16, 2, 16),
    "ragged": (2, 4, 50, 16, 8, 2, 16),          # L not a chunk multiple
    "one_group": (2, 8, 96, 64, 32, 1, 32),      # one group for eight heads
    "main_widths": (1, 4, 300, 64, 128, 2, 128),  # mamba2-130m's P and N, three chunks
}


@pytest.mark.parametrize("case", list(BF16_CASES))
def test_bf16_kernel_arithmetic_matches_jax(case):
    """The bf16 kernels' arithmetic within the bf16 plain version's tolerance
    (1e-2) of the Pallas kernel on bf16 inputs in interpret mode, and within
    1 bf16 ulp of the port's plain bf16 version (the card's contract; ulps no
    finer than at 2^-8 of y's largest magnitude)."""
    bsz, h, l, p, n, g, chunk = BF16_CASES[case]
    rng = np.random.default_rng(sum(BF16_CASES[case]))
    x = (0.8 * rng.standard_normal((bsz, h, l, p))).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, h, l)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 8.0, h)).astype(np.float32)
    b = (0.5 * rng.standard_normal((bsz, g, l, n))).astype(np.float32)
    c = (0.5 * rng.standard_normal((bsz, g, l, n))).astype(np.float32)
    want = j_ssd_chunked(jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt), jnp.asarray(a_log),
                         jnp.asarray(b, jnp.bfloat16), jnp.asarray(c, jnp.bfloat16),
                         chunk=chunk, interpret=True)
    tx, tb, tc = (torch.from_numpy(a).to(BF) for a in (x, b, c))
    tdt, ta = torch.from_numpy(dt), torch.from_numpy(a_log)
    got = _ssd_bf16(tx, tdt, ta, tb, tc, chunk)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16_SSD_TOL)
    plain, _ = ssd_chunked_plain(tx, tdt, ta, tb, tc, chunk)
    g32, p32 = got.float(), plain.float()
    mag = torch.clamp_min(torch.maximum(g32.abs(), p32.abs()), 2.0 ** -8 * float(p32.abs().max()))
    assert float(((g32 - p32).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max()) <= 1
