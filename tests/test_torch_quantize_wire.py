"""The port's int8 wire format and given-uniform qdq kernels against the JAX
package's, on the CPU (the port's plain versions; the JAX side in interpret
mode), with inputs made from a numpy seed.

Contracts:
- ``qdq_delta_rows`` (kernel 3): bit-exact. XLA contracts the reference's
  ``base + idx*sign*s*norm`` into one FMA, and the plain version's
  ``addcmul`` is one FMA too; written unfused, ~2,000 of 65,536 elements
  differ by 1 ulp (checked below, so the test can tell the two apart);
- ``qdq_rows``, ``quantize_rows``, ``dequantize_rows``, ``quantize``,
  ``dequantize`` (kernels 4-8): bit-exact, bfloat16 results included. The
  reference's qdq calls alias their payload to a float32 output, so they
  refuse a bfloat16 one; the port's bfloat16 result is held to the
  reference's float32 result rounded once;
- ``quantize`` divides by its fixed ``s`` as XLA does: ``x * (1/s)`` with
  the reciprocal rounded once in float32, not IEEE ``x / s`` (a crafted
  case tells the two apart); ``dequantize`` multiplies ``q * (s*norm)``;
- the ops wrappers: bit-exact given the reference's side information;
  otherwise the norm and ``s`` within 4 ulps (torch sums in another order
  than XLA) and every element within one grid cell (``ROADMAP.md`` C).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.flatten import flatten_tree, make_flat_spec as j_make_spec, unflatten_tree
from repro.core.quantization import QuantConfig as JQuant
from repro.core.quantization import dequantize as j_dequantize, quantize as j_quantize
from repro.kernels.quantize import segment_quantize_dequantize as j_segment
from repro.kernels.quantize import stochastic_dequantize as j_sdeq
from repro.kernels.quantize import stochastic_quantize as j_sq
from repro.kernels.quantize.quantize import (
    dequantize_kernel_call,
    dequantize_rows_kernel_call,
    qdq_rows_kernel_call,
    quantize_kernel_call,
    quantize_rows_kernel_call,
)
from repro.kernels.quantize.ref import dequantize_ref as j_dequantize_ref
from repro.kernels.quantize.ref import quantize_ref as j_quantize_ref
from repro.models import make_fnn as j_make_fnn

from repro_torch.core.flatten import make_flat_spec
from repro_torch.core.quantization import QuantConfig, dequantize as t_dequantize
from repro_torch.core.quantization import quantize as t_quantize
from repro_torch.kernels.quantize import (
    ref,
    segment_quantize_dequantize,
    stochastic_dequantize,
    stochastic_quantize,
)
from repro_torch.kernels.quantize.ops import segment_side_info
from repro_torch.kernels.quantize.quantize import (
    LANES,
    LAUNCHES,
    dequantize,
    dequantize_rows,
    qdq_delta_rows,
    qdq_rows,
    quantize,
    quantize_rows,
    reset_launch_counts,
)
from _torch_threads import torch_threads  # noqa: F401

ROWS = [37, 512]                  # a ragged count, and a multiple of the TPU's 512-row tile
BITS = [2, 4, 8]
SHAPES = [(64,), (1000,), (128, 128), (64, 129), (3, 5, 7), (65536,), (2048, 33)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _ulps(a, b):
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


def _bf16(a):
    """A float32 array rounded once to bfloat16, back in float32."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _rows(r, bits, seed=0):
    """w (a zero row, zeros in row 0), base, u and each row's adaptive
    (s, norm), as the segment path gives them."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(r, LANES)) * 0.03).astype(np.float32)
    w[min(3, r - 1)] = 0.0
    w[0, :5] = 0.0
    base = rng.normal(size=(r, LANES)).astype(np.float32)
    u = rng.random(size=(r, LANES)).astype(np.float32)
    norm = np.sqrt((w.astype(np.float64) ** 2).sum(1)).astype(np.float32)
    levels = (1 << (bits - 1)) - 1
    safe = np.where(norm > 0, norm, 1).astype(np.float32)
    s = np.where(norm > 0, np.abs(w).max(1) / safe / levels, 1.0).astype(np.float32)
    return w, base, u, s, norm


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ----------------------------------------------------------- kernels 3 and 4


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("rows", ROWS)
def test_qdq_delta_rows_bit_exact(rows, bits):
    w, base, u, s, norm = _rows(rows, bits, seed=bits)
    jw, jbase, ju, js, jn = _j(w, base, u, s, norm)
    want = np.asarray(qdq_rows_kernel_call(jw, ju, js, jn, bits=bits, base2d=jbase,
                                           interpret=True))
    got = qdq_delta_rows(_t(w.copy()), _t(base), _t(u), _t(s), _t(norm), bits=bits)
    np.testing.assert_array_equal(got.numpy(), want)
    # the reference contracts base + t*norm into one FMA: unfused differs
    t = qdq_rows(_t(w.copy()), _t(u), _t(s), _t(norm), bits=bits).numpy()
    assert (_t(base).numpy() + t != want).any()
    bf = qdq_delta_rows(_t(w.copy()), _t(base), _t(u), _t(s), _t(norm), bits=bits,
                        out_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf.float().numpy(), _bf16(want))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("rows", ROWS)
def test_qdq_rows_bit_exact(rows, bits):
    w, _, u, s, norm = _rows(rows, bits, seed=10 + bits)
    jw, ju, js, jn = _j(w, u, s, norm)
    want = np.asarray(qdq_rows_kernel_call(jw, ju, js, jn, bits=bits, interpret=True))
    got = qdq_rows(_t(w.copy()), _t(u), _t(s), _t(norm), bits=bits)
    np.testing.assert_array_equal(got.numpy(), want)
    bf = qdq_rows(_t(w.copy()), _t(u), _t(s), _t(norm), bits=bits, out_dtype=torch.bfloat16)
    np.testing.assert_array_equal(bf.float().numpy(), _bf16(want))


def test_reference_refuses_a_bfloat16_qdq_result():
    """Why the bfloat16 qdq results above are held to the rounded float32
    result: the reference aliases its float32 payload to its output."""
    w, _, u, s, norm = _rows(8, 8)
    with pytest.raises(ValueError, match="input_output_aliases"):
        qdq_rows_kernel_call(*_j(w, u, s, norm), bits=8, out_dtype=jnp.bfloat16,
                             interpret=True)


# ----------------------------------------------------------- kernels 5 and 6


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("rows", ROWS)
def test_quantize_rows_bit_exact(rows, bits):
    w, _, u, s, norm = _rows(rows, bits, seed=20 + bits)
    want = np.asarray(quantize_rows_kernel_call(*_j(w, u, s, norm), bits=bits,
                                                interpret=True))
    got = quantize_rows(_t(w), _t(u), _t(s), _t(norm), bits=bits)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("rows", ROWS)
def test_dequantize_rows_bit_exact(rows, bits, out_dtype):
    rng = np.random.default_rng(30 + bits)
    levels = (1 << (bits - 1)) - 1
    q = rng.integers(-levels, levels + 1, size=(rows, LANES)).astype(np.int8)
    s = rng.uniform(1e-4, 1e-2, rows).astype(np.float32)
    norm = rng.uniform(0.5, 3.0, rows).astype(np.float32)
    norm[0] = 0.0
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(dequantize_rows_kernel_call(*_j(q, s, norm), out_dtype=jdt,
                                                  interpret=True).astype(jnp.float32))
    got = dequantize_rows(_t(q), _t(s), _t(norm), out_dtype=out_dtype)
    assert got.dtype == out_dtype
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("rows", ROWS)
def test_rows_round_trip_equals_qdq_rows(rows):
    """quantize_rows -> dequantize_rows reproduces the fused qdq_rows, as
    test_rows_wire_kernels_match_fused_qdq holds the reference's."""
    rng = np.random.default_rng(2)
    w = rng.normal(size=(rows, LANES)).astype(np.float32) * 0.1
    u = rng.random(size=(rows, LANES)).astype(np.float32)
    s = rng.uniform(1e-4, 1e-2, rows).astype(np.float32)
    norm = rng.uniform(0.5, 3.0, rows).astype(np.float32)
    q = quantize_rows(_t(w), _t(u), _t(s), _t(norm), bits=8)
    assert (q.abs() <= 127).all()
    deq = dequantize_rows(q, _t(s), _t(norm))
    fused = qdq_rows(_t(w.copy()), _t(u), _t(s), _t(norm), bits=8)
    torch.testing.assert_close(deq, fused, rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------- kernels 7 and 8


def _pad512(a):
    """The reference's fixed-s calls take whole 512-row tiles: pad, then the
    caller slices its rows back."""
    return np.pad(a, ((0, (-a.shape[0]) % 512), (0, 0)))


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("rows", ROWS)
def test_quantize_bit_exact(rows, bits, w_dtype):
    rng = np.random.default_rng(40 + bits)
    w = (rng.normal(size=(rows, LANES)) * 2.3).astype(np.float32)
    w[0, :7] = 0.0
    jw = jnp.asarray(_pad512(w)).astype(w_dtype)
    wf = np.asarray(jw.astype(jnp.float32))[:rows]          # what the kernel reads
    u = rng.random(size=(rows, LANES)).astype(np.float32)
    norm = np.float32(np.linalg.norm(wf.astype(np.float64)))
    s = 1.0 / ((1 << (bits - 1)) - 1)
    want = np.asarray(quantize_kernel_call(jw, jnp.asarray(_pad512(u)), jnp.asarray(norm),
                                           s=s, bits=bits, interpret=True))[:rows]
    got = quantize(_t(wf), _t(u), torch.tensor(norm), s=s, bits=bits)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("rows", ROWS)
def test_dequantize_bit_exact(rows, bits, out_dtype):
    rng = np.random.default_rng(50 + bits)
    levels = (1 << (bits - 1)) - 1
    q = rng.integers(-levels, levels + 1, size=(rows, LANES)).astype(np.int8)
    norm = np.float32(rng.uniform(0.3, 40.0))
    s = 1.0 / levels
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(dequantize_kernel_call(jnp.asarray(_pad512(q)), jnp.asarray(norm), s=s,
                                             out_dtype=jdt, interpret=True)
                      .astype(jnp.float32))[:rows]
    got = dequantize(_t(q), torch.tensor(norm), s=s, out_dtype=out_dtype)
    assert got.dtype == out_dtype
    np.testing.assert_array_equal(got.float().numpy(), want)


def _crafted(s, bits, seed=1):
    """|w| (norm 1) where x/s and x*float32(1/s) differ, with u set between
    the two fractions so that the grid index tells them apart."""
    rng = np.random.default_rng(seed)
    levels = (1 << (bits - 1)) - 1
    sf = np.float32(s)
    rs = np.float32(1) / sf
    x = (rng.random(512 * LANES) * levels * sf).astype(np.float32)
    q_div, q_mul = x / sf, (x * rs).astype(np.float32)
    phi_div, phi_mul = q_div - np.floor(q_div), q_mul - np.floor(q_mul)
    u = rng.random(x.shape).astype(np.float32)
    differ = q_div != q_mul
    u[differ] = np.minimum(phi_div, phi_mul)[differ]
    sign = np.where(rng.random(x.shape) < 0.5, -1, 1).astype(np.float32)
    w = (x * sign).reshape(-1, LANES)
    idx_div = (np.clip(np.floor(q_div) + (u < phi_div), 0, levels) * sign).astype(np.int8)
    return w, u.reshape(-1, LANES), idx_div.reshape(-1, LANES)


@pytest.mark.parametrize("s,bits", [(1 / 127, 8), (1 / 7, 4), (0.0123, 8), (1 / 3, 2)])
def test_quantize_multiplies_by_the_float32_reciprocal(s, bits):
    """x/s and x*(1/s) give other indices on these inputs; the reference
    (jitted, and its kernel) takes the reciprocal rounded once in float32,
    float32(1)/float32(s), which for 1/7 is not float32(1/7 in float64)."""
    w, u, idx_div = _crafted(s, bits)
    norm = np.float32(1.0)
    want = np.asarray(quantize_kernel_call(*_j(w, u, norm), s=s, bits=bits, interpret=True))
    got = quantize(_t(w), _t(u), torch.tensor(norm), s=s, bits=bits).numpy()
    np.testing.assert_array_equal(got, want)
    assert (idx_div != want).sum() > 100                    # IEEE division would not do
    jitted = jax.jit(lambda a, b, n: j_quantize_ref(a, b, n, s=s, bits=bits))
    np.testing.assert_array_equal(ref.quantize_ref(_t(w), _t(u), norm, s=s, bits=bits).numpy(),
                                  np.asarray(jitted(*_j(w, u, norm))))


@pytest.mark.parametrize("s", [1 / 127, 1 / 7, 0.0123])
def test_ref_matches_jitted_reference(s):
    """The port's oracle computes as the JAX oracle does inside jit."""
    rng = np.random.default_rng(5)
    q = rng.integers(-127, 128, size=(64, LANES)).astype(np.int8)
    norm = np.float32(3.7)
    for od, jod in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        jitted = jax.jit(lambda a, n: j_dequantize_ref(a, n, s=s, out_dtype=jod))
        want = np.asarray(jitted(*_j(q, norm)).astype(jnp.float32))
        got = ref.dequantize_ref(_t(q), torch.tensor(norm), s=s, out_dtype=od)
        assert got.dtype == od
        np.testing.assert_array_equal(got.float().numpy(), want)
    # XLA folds the constant into the float32 scalar: q * (s*norm), not (q*s)*norm
    assert ((q.astype(np.float32) * np.float32(s)) * norm != want).any()


# ------------------------------------------------------------- ops wrappers


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [4, 8])
def test_stochastic_quantize_dequantize(shape, dtype, bits):
    """The shapes and dtypes of test_kernels_quantize.py, with the
    reference's own uniforms: norm within 4 ulps, indices within one grid
    cell, and bit-exact given the reference's norm; dequantize bit-exact."""
    key = jax.random.PRNGKey(hash((shape, bits)) % (2 ** 31))
    jw = (jax.random.normal(key, shape, jnp.float32) * 2.3).astype(dtype)
    s = 1.0 / ((1 << (bits - 1)) - 1)
    jq, jnorm = j_sq(jw, key, s=s, bits=bits, interpret=True)
    u = np.asarray(jax.random.uniform(key, (int(np.prod(shape)),), dtype=jnp.float32))
    w = _t(np.asarray(jw.astype(jnp.float32))).to(getattr(torch, dtype))
    q, norm = stochastic_quantize(w, _t(u.reshape(shape)), s=s, bits=bits)
    assert q.shape == shape and q.dtype == torch.int8 and norm.shape == ()
    assert _ulps(norm.numpy(), np.asarray(jnorm)).max() <= 4
    assert np.abs(q.numpy().astype(np.int32) - np.asarray(jq, np.int32)).max() <= 1
    exact = quantize(_rows2d(w.float()), _rows2d(_t(u)), torch.tensor(np.asarray(jnorm)),
                     s=s, bits=bits)
    np.testing.assert_array_equal(exact.reshape(-1)[:u.size].reshape(shape).numpy(),
                                  np.asarray(jq))
    for od, jod in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(j_sdeq(jq, jnorm, s=s, out_dtype=jod, interpret=True)
                          .astype(jnp.float32))
        got = stochastic_dequantize(_t(np.asarray(jq)), torch.tensor(np.asarray(jnorm)),
                                    s=s, out_dtype=od)
        assert got.shape == shape and got.dtype == od
        np.testing.assert_array_equal(got.float().numpy(), want)


def _rows2d(flat):
    flat = flat.reshape(-1)
    return torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % LANES)).reshape(-1, LANES)


@pytest.mark.parametrize("bits", [4, 8])
def test_stochastic_quantize_from_a_generator(bits):
    """Without the reference's uniforms: torch draws them; the round trip
    stays within one grid cell, and the same generator seed repeats."""
    w = torch.from_numpy(np.random.default_rng(0).normal(size=(33, 17)).astype(np.float32))
    s = 1.0 / ((1 << (bits - 1)) - 1)
    q, norm = stochastic_quantize(w, s=s, bits=bits, generator=torch.Generator().manual_seed(3))
    q2, _ = stochastic_quantize(w, s=s, bits=bits, generator=torch.Generator().manual_seed(3))
    assert torch.equal(q, q2)
    deq = stochastic_dequantize(q, norm, s=s)
    assert float((deq - w).abs().max()) <= s * float(norm) * (1 + 1e-5)
    with pytest.raises(ValueError, match="exactly one"):
        stochastic_quantize(w, s=s, bits=bits)
    with pytest.raises(ValueError, match="shape"):
        stochastic_quantize(w, torch.zeros(w.numel()), s=s, bits=bits)


def _payload(b, seed=0, scale=0.05):
    jmodel = j_make_fnn((23,), in_dim=17, out_dim=5)
    params = jmodel.init(jax.random.PRNGKey(0))
    jspec = j_make_spec(params)
    spec = make_flat_spec([tuple(torch.tensor(np.asarray(t)) for t in p) for p in params])
    rng = np.random.default_rng(seed)
    flat = rng.normal(size=(b, spec.d_pad)).astype(np.float32) * scale
    live = np.zeros(spec.d_pad, np.float32)
    for off, size in zip(spec.offsets, spec.sizes):
        live[off:off + size] = 1.0
    flat *= live
    flat[1] = 0.0                                      # an all-zero message
    return flat, jspec, spec


def test_row_leaf_ids_match():
    _, jspec, spec = _payload(2)
    ids = spec.row_leaf_ids()
    assert ids.dtype == np.int32
    np.testing.assert_array_equal(ids, jspec.row_leaf_ids())


def _j_side_info(w_rows, seg_ids, num_segments, bits):
    """The reference's side information, as ops.py:161-171 writes it."""
    levels = max((1 << (bits - 1)) - 1, 1)
    wf = jnp.asarray(w_rows)
    ids = jnp.asarray(seg_ids)
    norm_seg = jnp.sqrt(jax.ops.segment_sum(jnp.sum(wf * wf, axis=1), ids,
                                            num_segments=num_segments))
    amax = jax.ops.segment_max(jnp.max(jnp.abs(wf), axis=1), ids, num_segments=num_segments)
    xmax = amax / jnp.where(norm_seg > 0, norm_seg, 1.0)
    s_seg = jnp.where(xmax > 0, xmax / levels, 1.0).astype(jnp.float32)
    return np.asarray(s_seg[ids]), np.asarray(norm_seg[ids])


@pytest.mark.parametrize("per_message", [False, True])
@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("bits", BITS)
def test_segment_quantize_dequantize(bits, with_base, per_message):
    """Given u_rows: side information within 4 ulps, every element within
    one grid cell of the reference, and bit-exact given its side
    information. Segments per leaf spanning all messages, or per
    (message, leaf); one segment id with no rows."""
    b = 3
    flat, jspec, spec = _payload(b, seed=bits)
    rows = b * spec.rows
    w_rows = flat.reshape(rows, LANES)
    leaf = np.tile(spec.row_leaf_ids(), b)
    if per_message:
        seg_ids = (np.repeat(np.arange(b), spec.rows) * spec.n_leaves + leaf).astype(np.int32)
        num = b * spec.n_leaves + 1
    else:
        seg_ids, num = leaf, spec.n_leaves + 1
    rng = np.random.default_rng(60 + bits)
    u = rng.random(size=w_rows.shape).astype(np.float32)
    base = rng.normal(size=w_rows.shape).astype(np.float32) if with_base else None
    want = np.asarray(j_segment(jnp.asarray(w_rows), jnp.asarray(u), jnp.asarray(seg_ids), num,
                                bits=bits, base_rows=None if base is None else jnp.asarray(base),
                                interpret=True))
    w_t = _t(w_rows)
    got = segment_quantize_dequantize(w_t, _t(u), _t(seg_ids), num, bits=bits,
                                      base_rows=None if base is None else _t(base))
    assert torch.equal(w_t, _t(w_rows))                    # the input is left alone
    s_ref, n_ref = _j_side_info(w_rows, seg_ids, num, bits)
    s_rows, n_rows = segment_side_info(w_t, _t(seg_ids), num, bits=bits)
    assert _ulps(n_rows.numpy(), n_ref).max() <= 4
    assert _ulps(s_rows.numpy(), s_ref).max() <= 4
    cell = (s_ref * n_ref)[:, None]
    assert (np.abs(got.numpy() - want) <= cell * (1 + 1e-5)).all()
    exact = (qdq_rows(_t(w_rows.copy()), _t(u), _t(s_ref), _t(n_ref), bits=bits)
             if base is None else
             qdq_delta_rows(_t(w_rows.copy()), _t(base), _t(u), _t(s_ref), _t(n_ref), bits=bits))
    np.testing.assert_array_equal(exact.numpy(), want)


@pytest.mark.parametrize("bits", [4, 8])
def test_segment_counter_rng_path(bits):
    """Given seed words instead of uniforms: the counter-RNG kernels, within
    one grid cell of the reference's key path."""
    flat, jspec, spec = _payload(2, seed=7)
    rows = 2 * spec.rows
    w_rows = flat.reshape(rows, LANES)
    seg_ids = np.tile(spec.row_leaf_ids(), 2)
    base = np.random.default_rng(8).normal(size=w_rows.shape).astype(np.float32)
    key = jax.random.PRNGKey(bits)
    seed = tuple(int(v) for v in np.asarray(jax.random.key_data(key)).reshape(-1)[:2])
    want = np.asarray(j_segment(jnp.asarray(w_rows), None, jnp.asarray(seg_ids), spec.n_leaves,
                                bits=bits, base_rows=jnp.asarray(base), key=key,
                                interpret=True))
    reset_launch_counts()
    got = segment_quantize_dequantize(_t(w_rows), None, _t(seg_ids), spec.n_leaves,
                                      bits=bits, base_rows=_t(base), seed=seed)
    assert not any(LAUNCHES.values())                      # CPU tensors: plain versions
    s_ref, n_ref = _j_side_info(w_rows, seg_ids, spec.n_leaves, bits)
    assert (np.abs(got.numpy() - want) <= (s_ref * n_ref)[:, None] * (1 + 1e-5)).all()
    with pytest.raises(ValueError, match="exactly one"):
        segment_quantize_dequantize(_t(w_rows), None, _t(seg_ids), spec.n_leaves, bits=bits)


def test_segment_matches_per_leaf_oracle():
    """With the per-leaf draws of the reference's uniforms, the fused
    segment pass is the per-leaf oracle (repro_torch.core.quantization) and
    the JAX one: as test_segment_qdq_matches_per_leaf_oracle_given_same_uniforms
    holds the reference's (atol 1e-6, rtol 1e-5), and within one grid cell."""
    flat, jspec, spec = _payload(3)
    flat[1] = np.random.default_rng(4).normal(size=spec.d_pad).astype(np.float32) * 0.05
    live = np.zeros(spec.d_pad, np.float32)
    for off, size in zip(spec.offsets, spec.sizes):
        live[off:off + size] = 1.0
    flat *= live
    keys = jax.random.split(jax.random.PRNGKey(42), spec.n_leaves)
    cfg, jcfg = QuantConfig(bits=8), JQuant(bits=8)
    tree = unflatten_tree(jnp.asarray(flat), jspec)
    jleaves = jax.tree_util.tree_leaves(tree)
    j_oracle = np.asarray(flatten_tree(jax.tree_util.tree_unflatten(
        jspec.treedef, [j_dequantize(j_quantize(leaf, jcfg, k), dtype=leaf.dtype)
                        for leaf, k in zip(jleaves, keys)]), jspec))
    segs, oracle = [], np.zeros_like(flat)
    for l, (leaf, k) in enumerate(zip(jleaves, keys)):
        u = np.asarray(jax.random.uniform(k, (3, spec.sizes[l]), dtype=jnp.float32))
        u_leaf = np.asarray(jax.random.uniform(k, leaf.shape, dtype=jnp.float32))
        qt = t_quantize(_t(np.asarray(leaf)), cfg, _t(u_leaf))
        off = spec.offsets[l]
        oracle[:, off:off + spec.sizes[l]] = t_dequantize(qt).reshape(3, -1).numpy()
        segs.append(np.pad(u, ((0, 0), (0, spec.padded_sizes[l] - spec.sizes[l]))))
    u_flat = np.concatenate(segs, axis=1)
    rows = 3 * spec.rows
    seg_ids = np.tile(spec.row_leaf_ids(), 3)
    got = segment_quantize_dequantize(_t(flat.reshape(rows, LANES)),
                                      _t(u_flat.reshape(rows, LANES)), _t(seg_ids),
                                      spec.n_leaves, bits=8).reshape(3, spec.d_pad).numpy()
    np.testing.assert_allclose(got, oracle, atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(got, j_oracle, atol=1e-6, rtol=1e-5)
    s_rows, n_rows = segment_side_info(_t(flat.reshape(rows, LANES)), _t(seg_ids),
                                       spec.n_leaves, bits=8)
    cell = np.repeat((s_rows * n_rows).numpy().reshape(3, -1), LANES, axis=1)
    assert (np.abs(got - oracle) <= cell * (1 + 1e-5)).all()
