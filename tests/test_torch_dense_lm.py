"""The port's dense GQA decoder family against the JAX package, on the CPU.

Weights are the JAX ``T.init_params(cfg, key, jnp.float32)`` pytree, with
the QKV biases (zero at init) filled from numpy so that they count, carried
across with ``lm_params_from_numpy``; tokens are made with numpy from a
seed. Configurations: the ``dense-gqa-bias`` and ``mqa`` cases of
tests/test_decode_consistency.py and the SMOKE configurations of
``yi-6b``, ``qwen2.5-32b``, ``qwen2-72b`` and ``granite-34b``.

Contracts, with their tolerances (absolute and relative):
- ``forward_train`` logits and ``loss_fn`` against the reference: 1e-4.
  Both are float32; attention differs by the order of its sums and by the
  scale (the port multiplies by 1/sqrt(hd), the reference divides), a few
  ulps;
- ``decode_step`` over 16 tokens against the reference's: 1e-4;
- the port's own decode against its forward, in lockstep and in slot mode,
  and the sliding-window ring buffer past the window: 2e-3, the tolerance
  of tests/test_decode_consistency.py;
- ``active``: an inactive row's cache is left bit for bit;
- ``attn_train`` hands every full-sequence attention to
  ``block_attention``, whatever the configuration says;
- the registry, ``param_count`` and the parameter shapes: equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import transformer as JT
from repro.models.config import ArchConfig as JArch

from repro_torch import configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.block_attn import block_attn as bk
from repro_torch.models import ArchConfig
from repro_torch.models import transformer as T

TOL = dict(atol=1e-4, rtol=1e-4)
DECODE_TOL = dict(atol=2e-3, rtol=2e-3)
SEQ = 16
DENSE_IDS = ["yi-6b", "qwen2.5-32b", "qwen2-72b", "granite-34b"]

J_CASES = {
    "dense-gqa-bias": JArch(name="d", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                            d_ff=128, vocab=64, qkv_bias=True),
    "mqa": JArch(name="q", n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
                 vocab=64),
    **{f"{a}-smoke": j_configs.get_smoke(a) for a in DENSE_IDS},
}


def _port_cfg(jcfg, **over):
    """The port's ArchConfig with the same fields as the reference's."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw.update(over)
    return ArchConfig(**kw)


_PARAMS = {}


def _params(case):
    """(JAX params, port params) from one JAX init, biases made nonzero."""
    if case not in _PARAMS:
        jp = JT.init_params(J_CASES[case], jax.random.PRNGKey(3), jnp.float32)
        tree = jax.tree_util.tree_map(np.array, jp)
        rng = np.random.default_rng(5)
        mixer = tree["blocks"]["slot0"]["mixer"]
        for name in ("bq", "bk", "bv"):
            if name in mixer:
                mixer[name] = (0.2 * rng.standard_normal(mixer[name].shape)).astype(np.float32)
        _PARAMS[case] = (jax.tree_util.tree_map(jnp.asarray, tree),
                         lm_params_from_numpy(tree, device="cpu"))
    return _PARAMS[case]


def _tokens(cfg, batch=2, seq=SEQ, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (batch, seq)).astype(np.int32)


@pytest.mark.parametrize("case", list(J_CASES))
def test_forward_and_loss_match_jax(case):
    jcfg = J_CASES[case]
    cfg = _port_cfg(jcfg)
    jp, tp = _params(case)
    tokens = _tokens(cfg, seq=40)
    labels = np.roll(tokens, -1, axis=1)
    j_logits, _ = JT.forward_train(jcfg, jp, jnp.asarray(tokens), remat=False)
    j_loss = JT.loss_fn(jcfg, jp, {"tokens": jnp.asarray(tokens),
                                   "labels": jnp.asarray(labels)}, remat=False)
    bk.reset_launch_counts()
    logits, aux = T.forward_train(cfg, tp, torch.from_numpy(tokens))
    loss = T.loss_fn(cfg, tp, {"tokens": torch.from_numpy(tokens),
                               "labels": torch.from_numpy(labels)})
    assert bk.LAUNCHES["block_attn"] == 0         # CPU tensors take the plain version
    assert logits.shape == (2, 40, cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
    np.testing.assert_allclose(float(loss), float(j_loss), **TOL)


def _decode(step, cache, tokens):
    outs = []
    for t in range(tokens.shape[1]):
        lg, cache = step(cache, tokens[:, t:t + 1])
        outs.append(np.asarray(lg)[:, 0])
    return np.stack(outs, axis=1), cache


@pytest.mark.parametrize("case", ["dense-gqa-bias", "mqa", "qwen2.5-32b-smoke"])
def test_decode_matches_jax(case):
    jcfg = J_CASES[case]
    cfg = _port_cfg(jcfg)
    jp, tp = _params(case)
    tokens = _tokens(cfg, seed=1)
    jstep = jax.jit(lambda c, t: JT.decode_step(jcfg, jp, c, t))
    want, jcache = _decode(jstep, JT.init_cache(jcfg, 2, SEQ, jnp.float32), jnp.asarray(tokens))
    got, cache = _decode(lambda c, t: T.decode_step(cfg, tp, c, t),
                         T.init_cache(cfg, 2, SEQ, device="cpu"), torch.from_numpy(tokens))
    np.testing.assert_allclose(got, want, **TOL)
    assert int(cache["pos"]) == int(jcache["pos"]) == SEQ
    for name in ("k", "v"):
        np.testing.assert_allclose(cache["slots"]["slot0"][name].numpy(),
                                   np.asarray(jcache["slots"]["slot0"][name]), **TOL)


@pytest.mark.parametrize("case", list(J_CASES))
def test_decode_matches_forward(case):
    """Lockstep decode is the same model as the kernel route's forward."""
    cfg = _port_cfg(J_CASES[case])
    _, tp = _params(case)
    tokens = torch.from_numpy(_tokens(cfg, seed=2))
    logits, _ = T.forward_train(cfg, tp, tokens)
    got, cache = _decode(lambda c, t: T.decode_step(cfg, tp, c, t),
                         T.init_cache(cfg, 2, SEQ, device="cpu"), tokens)
    np.testing.assert_allclose(got, logits.numpy(), **DECODE_TOL)
    assert cache["slots"]["slot0"]["k"].shape == (cfg.n_blocks, 2, SEQ, cfg.n_kv_heads,
                                                  cfg.head_dim_)


@pytest.mark.parametrize("case", ["dense-gqa-bias", "granite-34b-smoke"])
def test_slot_mode_matches_forward(case):
    """Slot mode: each row at its own position, ``active`` holding a row
    back. Row 1 waits 5 steps (inactive, at position 0), then decodes its
    sequence; each row's logits equal the forward over its own tokens, and
    cache["pos"] is never touched."""
    cfg = _port_cfg(J_CASES[case])
    _, tp = _params(case)
    tokens = torch.from_numpy(_tokens(cfg, seed=4))
    want, _ = T.forward_train(cfg, tp, tokens)
    delay = 5
    cache = T.init_cache(cfg, 2, SEQ, device="cpu")
    got = [[], []]
    for t in range(SEQ + delay):
        pos = torch.tensor([min(t, SEQ - 1), max(t - delay, 0)], dtype=torch.int32)
        active = torch.tensor([t < SEQ, t >= delay])
        tok = torch.stack([tokens[0, pos[0]], tokens[1, pos[1]]])[:, None]
        lg, cache = T.decode_step(cfg, tp, cache, tok, positions=pos, active=active)
        for r in range(2):
            if active[r]:
                got[r].append(lg[r, 0].numpy())
        assert int(cache["pos"]) == 0
    for r in range(2):
        np.testing.assert_allclose(np.stack(got[r]), want[r].numpy(), **DECODE_TOL)


def test_sliding_window_ring_buffer():
    """Decode past the window: the ring buffer keeps only the last W tokens
    and matches sliding-window attention at every position (the case of
    tests/test_decode_consistency.py::test_sliding_window_ring_buffer), and
    the port's windowed forward matches the reference's."""
    jcfg = dataclasses.replace(J_CASES["dense-gqa-bias"], sliding_window=8)
    cfg = _port_cfg(jcfg)
    jp, tp = _params("dense-gqa-bias")
    tokens = _tokens(cfg, batch=1, seq=20, seed=4)
    j_logits, _ = JT.forward_train(jcfg, jp, jnp.asarray(tokens), remat=False)
    logits, _ = T.forward_train(cfg, tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
    cache = T.init_cache(cfg, 1, 20, device="cpu")
    assert cache["slots"]["slot0"]["k"].shape[2] == 8     # ring buffer = window
    got, _ = _decode(lambda c, t: T.decode_step(cfg, tp, c, t), cache,
                     torch.from_numpy(tokens))
    np.testing.assert_allclose(got, logits.numpy(), **DECODE_TOL)
    np.testing.assert_allclose(got[:, -1], np.asarray(j_logits)[:, -1], **DECODE_TOL)


def test_active_leaves_frozen_rows_untouched():
    cfg = _port_cfg(J_CASES["mqa"])
    _, tp = _params("mqa")
    tokens = torch.from_numpy(_tokens(cfg, batch=3, seed=6))
    _, cache = _decode(lambda c, t: T.decode_step(cfg, tp, c, t),
                       T.init_cache(cfg, 3, SEQ, device="cpu"), tokens[:, :4])
    active = torch.tensor([True, False, True])
    _, new = T.decode_step(cfg, tp, cache, tokens[:, 4:5], active=active)
    for name in ("k", "v"):
        old, upd = cache["slots"]["slot0"][name], new["slots"]["slot0"][name]
        assert torch.equal(old[:, 1], upd[:, 1])
        assert not torch.equal(old[:, 0], upd[:, 0]) and not torch.equal(old[:, 2], upd[:, 2])
        assert torch.equal(old[:, 0, :4], upd[:, 0, :4])   # only slot 4 was written
    assert int(new["pos"]) == 5


@pytest.mark.parametrize("over", [{}, {"sliding_window": 8}, {"attn_batch_parallel": True},
                                  {"qkv_bias": False}])
def test_attn_train_always_calls_block_attention(monkeypatch, over):
    """No configuration field routes full-sequence attention elsewhere:
    every layer hands it to ``block_attention``, so on the card it is
    always the kernel."""
    from repro_torch.kernels.block_attn import ops

    cfg = _port_cfg(J_CASES["dense-gqa-bias"], **over)
    tp = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    calls = []
    real = ops.block_attention
    monkeypatch.setattr(ops, "block_attention",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    T.forward_train(cfg, tp, torch.from_numpy(_tokens(cfg)))
    window = over.get("sliding_window", 0)
    assert calls == [{"causal": True, "window": window}] * cfg.n_layers


def test_unported_attention_options_raise():
    """The two attention options the port once refused, now against the
    reference's: ``attn_logits_bf16`` (``_sdpa(logits_bf16=True)``, the
    scores kept in the activations' dtype, on bf16 and on float32 q/k/v over
    a ring mask with masked slots) and cross-attention (``kv_override``: q
    from x, k/v from the override, no RoPE, no QKV bias). bf16: 2e-2
    absolute and relative, a few bf16 ulps, since each framework rounds its
    bf16 softmax steps at other places; float32: 1e-5."""
    from repro.models import layers as JL
    from repro_torch.models import layers as L

    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 9, 2, 16)).astype(np.float32) for _ in range(2))
    pos = np.array([4, 11], np.int32)
    mask_t = L._ring_mask(torch.from_numpy(pos), 9)
    mask_j = JL._ring_mask(jnp.asarray(pos), 9)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    for dt, jdt, tol in ((torch.bfloat16, jnp.bfloat16, dict(atol=2e-2, rtol=2e-2)),
                         (torch.float32, jnp.float32, dict(atol=1e-5, rtol=1e-5))):
        got = L._sdpa(*(torch.from_numpy(a).to(dt) for a in (q, k, v)), mask_t, 2,
                      logits_bf16=True)
        want = JL._sdpa(*(jnp.asarray(a, jdt) for a in (q, k, v)), mask_j, 2,
                        logits_bf16=True)
        assert got.dtype == dt and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)

    jp, tp = _params("dense-gqa-bias")
    jcfg = J_CASES["dense-gqa-bias"]
    base = _port_cfg(jcfg)
    mixer = {k: v[0] for k, v in tp["blocks"]["slot0"]["mixer"].items()}
    j_mixer = {k: v[0] for k, v in jp["blocks"]["slot0"]["mixer"].items()}
    x = rng.standard_normal((2, 4, base.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 7, base.d_model)).astype(np.float32)
    got = L.attn_train(mixer, torch.from_numpy(x), base, None, None,
                       kv_override=torch.from_numpy(enc))
    want = JL.attn_train(j_mixer, jnp.asarray(x), jcfg, None, None,
                         kv_override=jnp.asarray(enc))
    assert got.shape == (2, 4, base.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_rope_matches_jax():
    """RoPE at Yi-6B's theta of 5e6: float32 inverse frequencies, as the
    reference computes them, and the rotate-half layout."""
    from repro.models import layers as JL
    from repro_torch.models import layers as L

    pos = np.arange(0, 4096, 37, dtype=np.int32)
    x = np.random.default_rng(8).standard_normal((1, pos.size, 2, 128)).astype(np.float32)
    jc, js = JL.rope_freqs(jnp.asarray(pos), 128, 5e6)
    tc, ts = L.rope_freqs(torch.from_numpy(pos), 128, 5e6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(L.apply_rope(torch.from_numpy(x), tc, ts).numpy(),
                               np.asarray(JL.apply_rope(jnp.asarray(x), jc, js)),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch_id", DENSE_IDS)
def test_registry_and_param_count_match_jax(arch_id):
    for get, j_get in ((configs.get_arch, j_configs.get_arch),
                       (configs.get_smoke, j_configs.get_smoke)):
        mine, ref = get(arch_id), j_get(arch_id)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine == _port_cfg(ref)
        assert mine.param_count() == ref.param_count()
    # The analytic count leaves out the final norm: Yi-6B holds 6,061,035,520.
    yi = configs.get_arch("yi-6b")
    assert yi.param_count() + yi.d_model == 6_061_035_520


@pytest.mark.parametrize("arch_id", DENSE_IDS)
def test_ported_model_has_jax_shapes(arch_id):
    cfg = configs.get_smoke(arch_id)
    mine = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = JT.init_params(j_configs.get_smoke(arch_id), jax.random.PRNGKey(0), jnp.float32)
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    for path, leaf in flat:
        node = mine
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32
    count = lambda t: sum(map(count, t.values())) if isinstance(t, dict) else 1  # noqa: E731
    assert count(mine) == len(flat)
    size = lambda t: sum(map(size, t.values())) if isinstance(t, dict) else t.numel()  # noqa: E731
    # The analytic count leaves out the final norm and the QKV biases.
    bias = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim_ if cfg.qkv_bias else 0
    assert size(mine) == cfg.param_count() + cfg.d_model + cfg.n_blocks * bias
