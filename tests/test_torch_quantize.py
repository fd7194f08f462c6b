"""The port's wire format and qdq kernels against the JAX package's.

Contracts:
- ``qdq_rows_rng`` (plain version, CPU): bit-exact against the reference's
  ``qdq_rows_kernel_call(seed=..., interpret=True)`` given the same
  per-row (s, norm) and seed words;
- ``qdq_delta_rows_rng``: the same, held to at most 1 ulp because the base
  fusion is one FMA (``addcmul``) where XLA contracts one, and an unfused
  sum would round twice; in practice it is exact;
- ``payload_quantize_dequantize`` end to end: every element within one grid
  cell s*norm of the reference. The per-leaf norms are torch sums in
  another order than XLA's: they differ by up to 2 ulps on these inputs,
  and s = amax/norm/levels, two more roundings on top, by up to 3. The
  test holds both to 4 ulps. So a few stochastic-rounding decisions move
  by one cell;
- ``wire_bits`` and the per-leaf oracle's indices: identical.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.flatten import make_flat_spec as j_make_spec
from repro.core.quantization import QuantConfig as JQuant
from repro.core.quantization import quantize as j_quantize, wire_bits as j_wire_bits
from repro.kernels.quantize import payload_quantize_dequantize as j_payload
from repro.kernels.quantize.quantize import qdq_rows_kernel_call
from repro.models import make_fnn as j_make_fnn

from repro_torch.core.flatten import make_flat_spec
from repro_torch.core.quantization import (
    SUPPORTED_WIRE_WIDTHS,
    QuantConfig,
    dequantize,
    quantize,
    validate_wire_bits,
    wire_bits,
)
from repro_torch.kernels.quantize import payload_quantize_dequantize, payload_side_info
from repro_torch.kernels.quantize.quantize import (
    LANES,
    LAUNCHES,
    counter_uniforms,
    qdq_delta_rows_rng,
    qdq_rows_rng,
    reset_launch_counts,
)
from _torch_threads import torch_threads  # noqa: F401

SEEDS = [(0, 0), (12345, 0xDEADBEEF), (0xFFFFFFFF, 7)]


def _rows(r, seed=0, zero_rows=()):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(r, LANES)) * 0.03).astype(np.float32)
    w[list(zero_rows)] = 0.0
    w[0, :5] = 0.0                                     # sign(0) = 0
    base = rng.normal(size=(r, LANES)).astype(np.float32)
    norm = np.sqrt((w.astype(np.float64) ** 2).sum(1)).astype(np.float32)
    amax = np.abs(w).max(1)
    s = np.where(norm > 0, amax / np.where(norm > 0, norm, 1) / 3.0, 1.0).astype(np.float32)
    return w, base, s, norm


def _jax_qdq(w, base, s, norm, seed, bits):
    out = qdq_rows_kernel_call(
        jnp.asarray(w), None, jnp.asarray(s), jnp.asarray(norm), bits=bits,
        base2d=None if base is None else jnp.asarray(base),
        seed=jnp.asarray(np.array(seed, np.uint32)), interpret=True)
    return np.asarray(out)


def _ulps(a, b):
    ai = a.view(np.int32).astype(np.int64)
    bi = b.view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_qdq_rows_rng_bit_exact(bits, seed):
    w, _, s, norm = _rows(40, zero_rows=(3,))
    want = _jax_qdq(w, None, s, norm, seed, bits)
    got = qdq_rows_rng(torch.from_numpy(w.copy()), seed, torch.from_numpy(s),
                       torch.from_numpy(norm), bits=bits).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_qdq_delta_rows_rng_within_one_ulp(bits, seed):
    w, base, s, norm = _rows(40, seed=1, zero_rows=(5,))
    want = _jax_qdq(w, base, s, norm, seed, bits)
    got = qdq_delta_rows_rng(torch.from_numpy(w.copy()), torch.from_numpy(base), seed,
                             torch.from_numpy(s), torch.from_numpy(norm), bits=bits).numpy()
    assert _ulps(got, want).max() <= 1


def test_counter_uniforms_in_unit_interval_and_seeded():
    u = counter_uniforms(64, 1, 2)
    assert u.shape == (64, LANES) and u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01
    assert not torch.equal(u, counter_uniforms(64, 1, 3))


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


def _ref_side_info(flat, jspec, per_message, bits, s):
    """The reference's per-row (s, norm), written out as ops.py:87-110."""
    levels = max((1 << (bits - 1)) - 1, 1)
    b = flat.shape[0]
    s_parts, n_parts = [], []
    for off, psize in zip(jspec.offsets, jspec.padded_sizes):
        blk = jnp.asarray(flat[:, off:off + psize])
        if per_message:
            norm = jnp.sqrt(jnp.sum(blk * blk, axis=1))
            amax = jnp.max(jnp.abs(blk), axis=1)
        else:
            norm = jnp.broadcast_to(jnp.sqrt(jnp.sum(blk * blk)), (b,))
            amax = jnp.broadcast_to(jnp.max(jnp.abs(blk)), (b,))
        safe = jnp.where(norm > 0, norm, 1.0)
        s_leaf = (jnp.where(amax / safe > 0, amax / safe / levels, 1.0) if s is None
                  else jnp.full((b,), s, jnp.float32))
        s_parts.append(jnp.broadcast_to(s_leaf[:, None], (b, psize // LANES)))
        n_parts.append(jnp.broadcast_to(norm[:, None], (b, psize // LANES)))
    return (np.asarray(jnp.concatenate(s_parts, 1)).reshape(-1),
            np.asarray(jnp.concatenate(n_parts, 1)).reshape(-1))


@pytest.mark.parametrize("fixed_s", [False, True])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("per_message", [True, False])
@pytest.mark.parametrize("with_base", [False, True])
def test_payload_within_one_grid_cell(per_message, bits, fixed_s, with_base):
    s = 0.05 if fixed_s else None
    flat, jspec, spec = _payload(6, seed=bits)
    base = np.random.default_rng(9).normal(size=flat.shape).astype(np.float32) if with_base else None
    key = jax.random.PRNGKey(bits)
    want = np.asarray(j_payload(jnp.asarray(flat), jspec, per_message=per_message, bits=bits,
                                key=key, s=s,
                                base=None if base is None else jnp.asarray(base)))
    seed = tuple(int(v) for v in np.asarray(jax.random.key_data(key)).reshape(-1)[:2])
    s_ref, n_ref = _ref_side_info(flat, jspec, per_message, bits, s)
    s_rows, n_rows = payload_side_info(torch.from_numpy(flat), spec, per_message=per_message,
                                       bits=bits, s=s)
    assert _ulps(n_rows.numpy(), n_ref).max() <= 4
    assert _ulps(s_rows.numpy(), s_ref).max() <= 4
    got = payload_quantize_dequantize(
        torch.from_numpy(flat.copy()), spec, per_message=per_message, bits=bits, seed=seed,
        s=s, base=None if base is None else torch.from_numpy(base)).numpy()
    assert got.shape == flat.shape
    cell = np.repeat((s_ref * n_ref).reshape(flat.shape[0], -1), LANES, axis=1)
    assert (np.abs(got - want) <= cell * (1 + 1e-5)).all()
    # given the reference's side information the kernel function is exact
    exact = (qdq_rows_rng(torch.from_numpy(flat.reshape(-1, LANES).copy()), seed,
                          torch.tensor(s_ref), torch.tensor(n_ref), bits=bits)
             if base is None else
             qdq_delta_rows_rng(torch.from_numpy(flat.reshape(-1, LANES).copy()),
                                torch.from_numpy(base.reshape(-1, LANES)), seed,
                                torch.tensor(s_ref), torch.tensor(n_ref), bits=bits))
    np.testing.assert_array_equal(
        exact.numpy(), _jax_qdq(flat.reshape(-1, LANES), None if base is None
                                else base.reshape(-1, LANES), s_ref, n_ref, seed, bits))


@pytest.mark.parametrize("bits", SUPPORTED_WIRE_WIDTHS)
def test_wire_bits_identical(bits):
    for d in (1, 1000, 199210):
        assert wire_bits(d, bits) == j_wire_bits(d, bits)
    assert validate_wire_bits(bits) == bits
    with pytest.raises(ValueError):
        validate_wire_bits(bits + 100)


@pytest.mark.parametrize("s", [None, 0.1])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_per_leaf_oracle_matches(bits, s):
    """Given the reference's uniforms, the per-leaf oracle's indices are the
    reference's; s and norm within 1 ulp."""
    key = jax.random.PRNGKey(bits)
    w = np.random.default_rng(bits).normal(size=(37, 11)).astype(np.float32)
    jq = j_quantize(jnp.asarray(w), JQuant(bits=bits, s=s), key)
    u = np.asarray(jax.random.uniform(key, w.shape, dtype=jnp.float32))
    q = quantize(torch.from_numpy(w), QuantConfig(bits=bits, s=s), torch.tensor(u))
    np.testing.assert_array_equal(q.indices.numpy(), np.asarray(jq.indices))
    assert _ulps(np.float32(q.norm.item()), np.float32(jq.norm)) <= 1
    assert _ulps(np.float32(q.s.item()), np.float32(jq.s)) <= 1
    deq = dequantize(q)
    assert deq.shape == w.shape
    cell = float(q.s) * float(q.norm)
    assert float((deq - torch.from_numpy(w)).abs().max()) <= cell * (1 + 1e-5)


def test_wrappers_reject_bad_inputs_and_count_only_launches():
    w = torch.zeros(4, LANES)
    s = torch.ones(4)
    n = torch.ones(4)
    reset_launch_counts()
    qdq_rows_rng(w.clone(), (1, 2), s, n, bits=8)      # CPU: plain version, no launch
    assert {"qdq_delta_rows_rng", "qdq_rows_rng"} <= set(LAUNCHES)
    assert not any(LAUNCHES.values())
    with pytest.raises(ValueError, match="shape"):
        qdq_rows_rng(torch.zeros(4, 64), (1, 2), s, n, bits=8)
    with pytest.raises(ValueError, match="shape"):
        qdq_rows_rng(w, (1, 2), torch.ones(5), n, bits=8)
    with pytest.raises(TypeError, match="float32"):
        qdq_rows_rng(w.double(), (1, 2), s, n, bits=8)
    with pytest.raises(ValueError, match="contiguous"):
        qdq_rows_rng(torch.zeros(LANES, 4).t(), (1, 2), s, n, bits=8)
    with pytest.raises(ValueError, match="bit"):
        qdq_rows_rng(w, (1, 2), s, n, bits=32)
    with pytest.raises(ValueError, match="alias"):
        qdq_delta_rows_rng(w, w, (1, 2), s, n, bits=8)
