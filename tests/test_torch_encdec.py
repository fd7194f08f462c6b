"""The port's encoder-decoder (``seamless-m4t-large-v2``: a non-causal
encoder over the audio stub's frames and a cross-attention layer after every
decoder block) against the JAX package, on the CPU.

Weights are the JAX ``init_attn`` / ``T.init_params(..., jnp.float32)``
pytrees, carried across with ``lm_params_from_numpy``; inputs, tokens and
the stub's frame embeddings are made with numpy from a seed. On the CPU the
port's attention takes ``block_attention``'s plain version; the kernel
itself is held on the card by ``chip_smoke.py``.

Contracts, with their tolerances (absolute and relative):
- ``attn_train(causal=False)`` (the encoder's self-attention) against the
  reference's, whose ``_sdpa`` runs over a zero mask (not against the JAX
  kernel, which pads ragged non-causal lengths without masking them), at a
  block multiple and at ragged frame counts; and ``attn_train(kv_override=)``
  (cross-attention: no RoPE, no bias, Lq != Lk) against the reference's:
  1e-5;
- ``_run_encoder`` against the reference's: 1e-5; Seamless SMOKE
  ``forward_train`` logits 1e-4 and ``loss_fn`` 1e-5, three
  ``block_attention`` calls a block (encoder non-causal, decoder causal,
  cross non-causal);
- the reference's ``test_encdec_decode_consistency``, ported: decode over
  ``cache["enc_out"] = _run_encoder(...)`` against the reference's decode
  step by step (1e-4) and against the port's forward (2e-3);
- the registry, ``param_count``, the tree's keys and shapes: equal, at SMOKE
  size and at full size (``FakeTensorMode`` against ``jax.eval_shape``):
  2,034,784,256 parameters.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as j_configs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.config import ArchConfig as JArch

from repro_torch import configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.block_attn import block_attn as bk
from repro_torch.kernels.block_attn import ops
from repro_torch.models import ArchConfig, MLAConfig, MoEConfig, SSMConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from _torch_threads import torch_threads  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
DECODE_TOL = dict(atol=2e-3, rtol=2e-3)
ARCH_ID = "seamless-m4t-large-v2"
_SUB = {"ssm": SSMConfig, "moe": MoEConfig, "mla": MLAConfig}
# tests/test_decode_consistency.py's test_encdec_decode_consistency configuration
J_TEST_CFG = JArch(name="ed", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                   vocab=64, enc_dec=True, n_enc_layers=2, frontend="audio",
                   frontend_tokens=12)


def _port_cfg(jcfg, **over):
    """The port's ArchConfig with the same fields as the reference's."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for name, cls in _SUB.items():
        if kw[name] is not None:
            kw[name] = cls(**dataclasses.asdict(kw[name]))
    kw.update(over)
    return ArchConfig(**kw)


def _attn_pair(jcfg, seed=1):
    jp = jax.tree_util.tree_map(np.array, JL.init_attn(jax.random.PRNGKey(seed), jcfg,
                                                       jnp.float32))
    return jax.tree_util.tree_map(jnp.asarray, jp), lm_params_from_numpy(jp, device="cpu")


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# (config, frames): Seamless SMOKE at its 32 frames (a block multiple of the
# JAX kernel's tiles), and ragged counts; GQA with window and bias too.
ENC_CASES = {
    "smoke-32": (j_configs.get_smoke(ARCH_ID), 32),
    "smoke-29": (j_configs.get_smoke(ARCH_ID), 29),
    "smoke-1000": (j_configs.get_smoke(ARCH_ID), 1000),
    "gqa-window-bias-23": (JArch(name="g", n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
                                 d_ff=64, vocab=64, qkv_bias=True, sliding_window=4), 23),
}


@pytest.mark.parametrize("case", list(ENC_CASES))
def test_noncausal_attention_matches_jax_sdpa(case):
    """The encoder's ``attn_train(causal=False)``: every query sees every
    key, whatever the frame count, and a configured window is not applied
    (the reference's zero mask)."""
    jcfg, frames = ENC_CASES[case]
    cfg = _port_cfg(jcfg)
    jp, tp = _attn_pair(jcfg)
    if jcfg.qkv_bias:
        for name in ("bq", "bk", "bv"):
            b = _normal(tp[name].shape, 7) * 0.2
            jp[name], tp[name] = jnp.asarray(b), torch.from_numpy(b)
    x = _normal((2, frames, cfg.d_model), 2)
    jc, js = JL.rope_freqs(jnp.arange(frames), cfg.head_dim_, cfg.rope_theta)
    tc, ts = L.rope_freqs(torch.arange(frames), cfg.head_dim_, cfg.rope_theta)
    calls = []
    real = ops.block_attention
    want = JL.attn_train(jp, jnp.asarray(x), jcfg, jc, js, causal=False)
    try:
        ops.block_attention = lambda *a, **k: calls.append(k) or real(*a, **k)
        got = L.attn_train(tp, torch.from_numpy(x), cfg, tc, ts, causal=False)
    finally:
        ops.block_attention = real
    assert calls == [{"causal": False, "window": 0}]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    # The causal call keeps the window and differs.
    causal = L.attn_train(tp, torch.from_numpy(x), cfg, tc, ts)
    np.testing.assert_allclose(causal.numpy(), np.asarray(JL.attn_train(
        jp, jnp.asarray(x), jcfg, jc, js)), **LAYER_TOL)
    assert not np.allclose(causal.numpy(), got.numpy(), **LAYER_TOL)


def test_plain_noncausal_block_attention_matches_jax_sdpa():
    """The plain version itself against the reference's ``_sdpa`` with a
    zero mask at a ragged length, MHA and GQA."""
    from repro_torch.kernels.block_attn.ref import block_attention_plain

    for lq, lk, h, kv in ((29, 29, 4, 4), (17, 45, 4, 2), (1, 33, 4, 4)):
        q, k, v = (_normal((2, n, heads, 16), s) for n, heads, s in
                   ((lq, h, 1), (lk, kv, 2), (lk, kv, 3)))
        want = JL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.zeros((1, 1, lq, lk), jnp.float32), h // kv)
        got = block_attention_plain(*map(torch.from_numpy, (q, k, v)), causal=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("lq,lk", [(10, 32), (32, 12), (1, 29)])
def test_cross_attention_matches_jax(lq, lk):
    """``attn_train(kv_override=enc_out)``: q from the decoder, k/v from the
    encoder's output, no RoPE (cos/sin are not read), no QKV bias, no mask;
    one ``block_attention(causal=False, window=0)`` call."""
    jcfg = dataclasses.replace(j_configs.get_smoke(ARCH_ID), qkv_bias=True,
                               sliding_window=3)
    cfg = _port_cfg(jcfg)
    jp, tp = _attn_pair(jcfg, seed=3)
    for name in ("bq", "bk", "bv"):         # not read by the cross path
        tp[name] = torch.full_like(tp[name], 5.0)
    x, enc = _normal((2, lq, cfg.d_model), 4), _normal((2, lk, cfg.d_model), 5)
    want = JL.attn_train(jp, jnp.asarray(x), jcfg, None, None, kv_override=jnp.asarray(enc))
    calls = []
    real = ops.block_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw))
        return real(q, k, v, **kw)

    ops.block_attention = spy
    try:
        got = L.attn_train(tp, torch.from_numpy(x), cfg, None, None,
                           kv_override=torch.from_numpy(enc))
    finally:
        ops.block_attention = real
    hd = cfg.head_dim_
    assert calls == [((2, lq, cfg.n_heads, hd), (2, lk, cfg.n_kv_heads, hd),
                      {"causal": False, "window": 0})]
    assert got.shape == (2, lq, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


_PARAMS = {}


def _params(jcfg):
    """(port config, JAX params, port params)."""
    if jcfg not in _PARAMS:
        tree = jax.tree_util.tree_map(
            np.array, JT.init_params(jcfg, jax.random.PRNGKey(5), jnp.float32))
        _PARAMS[jcfg] = (_port_cfg(jcfg), jax.tree_util.tree_map(jnp.asarray, tree),
                         lm_params_from_numpy(tree, device="cpu"))
    return _PARAMS[jcfg]


CFGS = {"seamless-smoke": j_configs.get_smoke(ARCH_ID), "test-config": J_TEST_CFG}


@pytest.mark.parametrize("name", list(CFGS))
def test_run_encoder_matches_jax(name):
    jcfg = CFGS[name]
    cfg, jp, tp = _params(jcfg)
    for frames in (cfg.frontend_tokens, cfg.frontend_tokens - 3):
        emb = _normal((2, frames, cfg.d_model), frames)
        want = JT._run_encoder(jcfg, jp, jnp.asarray(emb), remat=False)
        got = T._run_encoder(cfg, tp, torch.from_numpy(emb))
        assert got.shape == (2, frames, cfg.d_model)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_forward_and_loss_match_jax(monkeypatch):
    """Seamless SMOKE: logits over the text positions 0..S-1 (the frames are
    the encoder's, not prepended) and the loss; per forward 2 encoder calls
    (non-causal, Lq = Lk = 32), then per block one causal call (Lq = Lk = S)
    and one cross call (Lq = S, Lk = 32)."""
    jcfg = CFGS["seamless-smoke"]
    cfg, jp, tp = _params(jcfg)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    emb = _normal((2, cfg.frontend_tokens, cfg.d_model), 4)
    j_logits, j_aux = JT.forward_train(jcfg, jp, jnp.asarray(tokens), jnp.asarray(emb),
                                       remat=False)
    j_loss = JT.loss_fn(jcfg, jp, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
                                   "embeds": jnp.asarray(emb)}, remat=False)
    calls = []
    real = ops.block_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw["causal"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "block_attention", spy)
    bk.reset_launch_counts()
    logits, aux = T.forward_train(cfg, tp, torch.from_numpy(tokens), torch.from_numpy(emb))
    monkeypatch.undo()
    loss = T.loss_fn(cfg, tp, {"tokens": torch.from_numpy(tokens),
                               "labels": torch.from_numpy(labels),
                               "embeds": torch.from_numpy(emb)})
    assert bk.LAUNCHES["block_attn"] == 0
    f = cfg.frontend_tokens
    assert calls == [(f, f, False)] * cfg.n_enc_layers + [(40, 40, True), (40, f, False)] * \
        cfg.n_blocks
    assert logits.shape == (2, 40, cfg.vocab) and float(aux) == float(j_aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
    np.testing.assert_allclose(float(loss), float(j_loss), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="frontend_embeds"):
        T.forward_train(cfg, tp, torch.from_numpy(tokens))


@pytest.mark.parametrize("name", list(CFGS))
def test_encdec_decode_consistency(name):
    """The reference's test, ported: the cache holds the encoder's output;
    decode over it against the reference's decode step by step and against
    the port's own forward. The cross layers run in every decode step (one
    Lq = 1 call a block)."""
    jcfg = CFGS[name]
    cfg, jp, tp = _params(jcfg)
    seq, f = 10, cfg.frontend_tokens
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, seq)).astype(np.int32)
    emb = _normal((2, f, cfg.d_model), 6)
    jcache = JT.init_cache(jcfg, 2, seq, jnp.float32, enc_len=f)
    jcache["enc_out"] = JT._run_encoder(jcfg, jp, jnp.asarray(emb), remat=False)
    cache = T.init_cache(cfg, 2, seq, device="cpu", enc_len=f)
    assert tuple(cache["enc_out"].shape) == jcache["enc_out"].shape == (2, f, cfg.d_model)
    assert not cache["enc_out"].any()
    cache["enc_out"] = T._run_encoder(cfg, tp, torch.from_numpy(emb))
    jstep = jax.jit(lambda c, t: JT.decode_step(jcfg, jp, c, t))
    calls = []
    real = ops.block_attention
    ops.block_attention = lambda q, *a, **k: calls.append(q.shape[1]) or real(q, *a, **k)
    want, got = [], []
    try:
        for t in range(seq):
            jlg, jcache = jstep(jcache, jnp.asarray(tokens[:, t:t + 1]))
            lg, cache = T.decode_step(cfg, tp, cache, torch.from_numpy(tokens[:, t:t + 1]))
            want.append(np.asarray(jlg)[:, 0])
            got.append(lg[:, 0].numpy())
    finally:
        ops.block_attention = real
    assert calls == [1] * (seq * cfg.n_blocks)
    np.testing.assert_allclose(np.stack(got, 1), np.stack(want, 1), **TOL)
    logits, _ = T.forward_train(cfg, tp, torch.from_numpy(tokens), torch.from_numpy(emb))
    np.testing.assert_allclose(np.stack(got, 1), logits.numpy(), **DECODE_TOL)
    assert int(cache["pos"]) == seq


def test_lone_audio_frontend_prepends_like_jax():
    """``frontend="audio"`` without ``enc_dec`` has no encoder: its frames go
    before the tokens, as the reference's ``forward_train`` does."""
    jcfg = JArch(name="a", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                 vocab=64, frontend="audio", frontend_tokens=6)
    cfg, jp, tp = _params(jcfg)
    assert "encoder" not in tp
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    emb = _normal((2, 6, cfg.d_model), 8)
    want, _ = JT.forward_train(jcfg, jp, jnp.asarray(tokens), jnp.asarray(emb), remat=False)
    got, _ = T.forward_train(cfg, tp, torch.from_numpy(tokens), torch.from_numpy(emb))
    assert got.shape == (2, 9, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_registry_and_param_count_match_jax():
    for get, j_get in ((configs.get_arch, j_configs.get_arch),
                       (configs.get_smoke, j_configs.get_smoke)):
        mine, ref = get(ARCH_ID), j_get(ARCH_ID)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine == _port_cfg(ref)
        assert mine.param_count() == ref.param_count()


def _shapes(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, prefix + (k,)))
        return out
    return {prefix: tuple(tree.shape)}


@pytest.mark.parametrize("size", ["smoke", "arch"])
def test_ported_model_has_jax_shapes(size):
    """init_params draws the reference's tree (``encoder`` stacked
    n_enc_layers deep, ``cross`` n_blocks deep, ``enc_norm``): at SMOKE size
    for real, and the carried JAX tree too; at full size under
    FakeTensorMode against ``jax.eval_shape``: 2,034,784,256 parameters."""
    get, j_get = ((configs.get_smoke, j_configs.get_smoke) if size == "smoke"
                  else (configs.get_arch, j_configs.get_arch))
    cfg, jcfg = get(ARCH_ID), j_get(ARCH_ID)
    want = {tuple(k.key for k in path): tuple(leaf.shape) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jax.eval_shape(
                lambda k: JT.init_params(jcfg, k, jnp.float32), jax.random.PRNGKey(0)))[0]}
    if size == "smoke":
        mine = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        assert _shapes(_params(jcfg)[2]) == want
    else:
        with FakeTensorMode():
            mine = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert _shapes(mine) == want
    assert want[("encoder", "mixer", "wq")] == (cfg.n_enc_layers, cfg.d_model, cfg.d_model)
    assert want[("cross", "norm")] == (cfg.n_blocks, cfg.d_model)
    total = sum(int(np.prod(s)) for s in want.values())
    # The analytic count leaves out the final norm and the encoder's norm.
    assert total == cfg.param_count() + 2 * cfg.d_model
    if size == "arch":
        assert total == 2_034_784_256
