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
"""
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
