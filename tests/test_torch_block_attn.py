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
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.block_attn import block_attention as j_block_attention
from repro.models import layers as JL

from repro_torch.kernels.block_attn import block_attention
from repro_torch.kernels.block_attn import block_attn as bk
from repro_torch.kernels.block_attn.ref import attention_pairs, block_attention_plain

TOL = dict(atol=1e-5, rtol=1e-5)


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
    """Only a CPU tensor takes the plain version; any device other than the
    CPU or a card is refused, not computed."""
    q, k, v = (torch.from_numpy(a).to("meta") for a in _qkv(1, 8, 8, 2, 2, 8))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        block_attention(q, k, v)
