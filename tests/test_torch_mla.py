"""The port's MLA (DeepSeek's compressed-KV attention) and the model it opens,
``deepseek-v2-lite-16b``, against the JAX package, on the CPU.

Weights are the JAX ``init_mla`` / ``T.init_params(..., jnp.float32)``
pytrees, carried across with ``lm_params_from_numpy``; inputs and tokens are
made with numpy from a seed.

Contracts, with their tolerances (absolute and relative):
- ``_mla_qkv``, ``_mla_attend`` and ``mla_train`` against the reference's,
  at the reference's test configuration (``tests/test_decode_consistency.py``
  ``"mla"``) and at DeepSeek SMOKE, with and without a sliding window: 1e-5;
- DeepSeek SMOKE: ``forward_train`` logits 1e-4 and aux 1e-6, ``loss_fn``
  1e-5, the same ``gate_idx`` and drops in every MoE layer as the
  reference's; ``decode_step`` against the reference's, step by step, 1e-4,
  also after a sliding window's ring wraps; the port's decode against its
  forward 2e-3 at ``capacity_factor = n_experts / top_k`` (no drops);
- the registry, ``param_count``, the tree's keys and shapes: equal, at SMOKE
  size and at full size (the port's tree built under ``FakeTensorMode``,
  the reference's under ``jax.eval_shape``): 16,210,324,992 parameters.
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
from repro.models.config import ArchConfig as JArch, MLAConfig as JMLA

from repro_torch import configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.block_attn import block_attn as bk
from repro_torch.models import ArchConfig, MLAConfig, MoEConfig, SSMConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from _torch_threads import torch_threads  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
AUX_TOL = dict(atol=1e-6, rtol=1e-6)
DECODE_TOL = dict(atol=2e-3, rtol=2e-3)
SEQ = 16
ARCH_ID = "deepseek-v2-lite-16b"
_SUB = {"ssm": SSMConfig, "moe": MoEConfig, "mla": MLAConfig}

LAYER_CASES = {
    # tests/test_decode_consistency.py's "mla" configuration
    "test-config": JArch(name="m", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         d_ff=128, vocab=64, attn_type="mla",
                         mla=JMLA(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                                  v_head_dim=16)),
    "deepseek-smoke": j_configs.get_smoke(ARCH_ID),
    "deepseek-smoke-window": dataclasses.replace(j_configs.get_smoke(ARCH_ID),
                                                 sliding_window=5),
}


def _port_cfg(jcfg, **over):
    """The port's ArchConfig with the same fields as the reference's."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for name, cls in _SUB.items():
        if kw[name] is not None:
            kw[name] = cls(**dataclasses.asdict(kw[name]))
    kw.update(over)
    return ArchConfig(**kw)


def _mla_pair(jcfg, seed=1):
    """(JAX params, port params) of one MLA layer; kv_norm made non-trivial."""
    jp = jax.tree_util.tree_map(np.array, JL.init_mla(jax.random.PRNGKey(seed), jcfg,
                                                      jnp.float32))
    jp["kv_norm"] = (1 + 0.3 * np.random.default_rng(seed).standard_normal(
        jp["kv_norm"].shape)).astype(np.float32)
    return jax.tree_util.tree_map(jnp.asarray, jp), lm_params_from_numpy(jp, device="cpu")


def _rope(cfg, n):
    jc, js = JL.rope_freqs(jnp.arange(n), cfg.mla.qk_rope_dim, cfg.rope_theta)
    tc, ts = L.rope_freqs(torch.arange(n), cfg.mla.qk_rope_dim, cfg.rope_theta)
    return (jc, js), (tc, ts)


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_mla_layer_matches_jax(case):
    """_mla_qkv's four outputs, _mla_attend over the causal mask, and
    mla_train: the absorbed form with the 1/sqrt(nope + rope) scale, one RoPE
    key shared by the heads, the RMS-normed latent."""
    jcfg = LAYER_CASES[case]
    cfg = _port_cfg(jcfg)
    jp, tp = _mla_pair(jcfg)
    x = np.random.default_rng(2).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    (jc, js), (tc, ts) = _rope(cfg, 24)
    j_parts = JL._mla_qkv(jp, jnp.asarray(x), jcfg, jc, js)
    t_parts = L._mla_qkv(tp, torch.from_numpy(x), cfg, tc, ts)
    m = cfg.mla
    shapes = [(2, 24, cfg.n_heads, m.qk_nope_dim), (2, 24, cfg.n_heads, m.qk_rope_dim),
              (2, 24, m.kv_lora_rank), (2, 24, m.qk_rope_dim)]
    for got, want, shape in zip(t_parts, j_parts, shapes):
        assert tuple(got.shape) == shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    j_mask = JL._causal_mask(24, cfg.sliding_window)[:, 0][:, None]
    t_mask = L._causal_mask(24, cfg.sliding_window, "cpu")
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    j_att = JL._mla_attend(jp, *j_parts, j_mask, jcfg)
    t_att = L._mla_attend(tp, *t_parts, t_mask, cfg)
    np.testing.assert_allclose(t_att.numpy(), np.asarray(j_att), **LAYER_TOL)
    got = L.mla_train(tp, torch.from_numpy(x), cfg, tc, ts)
    want = JL.mla_train(jp, jnp.asarray(x), jcfg, jc, js)
    assert got.shape == (2, 24, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_mla_decode_matches_jax_and_keeps_inactive_rows():
    """mla_decode over a ring of 6 slots for 14 steps (the ring wraps),
    against the reference's, with per-row positions; an inactive row's
    cache stays as it was."""
    jcfg = LAYER_CASES["deepseek-smoke-window"]
    jcfg = dataclasses.replace(jcfg, sliding_window=6)
    cfg = _port_cfg(jcfg)
    jp, tp = _mla_pair(jcfg, seed=4)
    xs = np.random.default_rng(3).standard_normal((14, 2, 1, cfg.d_model)).astype(np.float32)
    jcache = JL.init_cache_mla(jcfg, 2, 32, jnp.float32)
    tcache = L.init_cache_mla(cfg, 2, 32, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == {
        k: v.shape for k, v in jcache.items()} == {"c_kv": (2, 6, 64), "k_rope": (2, 6, 16)}
    for t in range(14):
        pos = np.array([t, t + 3], dtype=np.int32)
        jy, jcache = JL.mla_decode(jp, jnp.asarray(xs[t]), jcache, jnp.asarray(pos), jcfg)
        ty, tcache = L.mla_decode(tp, torch.from_numpy(xs[t]), tcache, torch.from_numpy(pos),
                                  cfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
        for name in ("c_kv", "k_rope"):
            np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                       **LAYER_TOL)
    active = torch.tensor([True, False])
    _, frozen = L.mla_decode(tp, torch.from_numpy(xs[0]), tcache, 14, cfg, active=active)
    for name in ("c_kv", "k_rope"):
        assert torch.equal(frozen[name][1], tcache[name][1])
        assert not torch.equal(frozen[name][0], tcache[name][0])


_PARAMS = {}


def _params(jcfg=None):
    """(JAX config, port config, JAX params, port params) of DeepSeek SMOKE
    or of ``jcfg``; the kv norms made non-trivial so that they count."""
    jcfg = jcfg or j_configs.get_smoke(ARCH_ID)
    if jcfg not in _PARAMS:
        tree = jax.tree_util.tree_map(
            np.array, JT.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32))
        kv_norm = tree["blocks"]["slot0"]["mixer"]["kv_norm"]
        tree["blocks"]["slot0"]["mixer"]["kv_norm"] = (1 + 0.3 * np.random.default_rng(
            6).standard_normal(kv_norm.shape)).astype(np.float32)
        _PARAMS[jcfg] = (jcfg, _port_cfg(jcfg), jax.tree_util.tree_map(jnp.asarray, tree),
                        lm_params_from_numpy(tree, device="cpu"))
    return _PARAMS[jcfg]


def _tokens(cfg, batch=2, seq=SEQ, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (batch, seq)).astype(np.int32)


def _routing(monkeypatch):
    """Spies on both routers: (the reference's top-k indices, the port's
    moe_route outputs), one entry a MoE layer."""
    j_seen, t_seen = [], []
    real_top_k, real_route = jax.lax.top_k, L.moe_route

    def j_spy(operand, k):
        out = real_top_k(operand, k)
        j_seen.append(np.asarray(out[1]))
        return out

    def t_spy(p, x, cfg):
        out = real_route(p, x, cfg)
        t_seen.append(out)
        return out

    monkeypatch.setattr(jax.lax, "top_k", j_spy)
    monkeypatch.setattr(L, "moe_route", t_spy)
    return j_seen, t_seen


def _reference_keep(gate_idx, n_experts, cap):
    """The reference's capacity rule: token-major, choice rank inside."""
    b, l, k = gate_idx.shape
    keep = np.zeros((b, l * k), dtype=bool)
    for r, row in enumerate(gate_idx.reshape(b, l * k)):
        seen = np.zeros(n_experts, dtype=int)
        for j, ex in enumerate(row):
            keep[r, j] = seen[ex] < cap
            seen[ex] += 1
    return keep.reshape(b, l, k)


def test_forward_and_loss_match_jax(monkeypatch):
    """DeepSeek SMOKE: logits, aux and loss; every MoE layer routes every
    token to the reference's experts and drops the reference's choices
    (64 tokens at capacity factor 1: some drop); no block_attn call (MLA
    attends in plain torch)."""
    jcfg, cfg, jp, tp = _params()
    tokens = _tokens(cfg, seq=64)
    labels = np.roll(tokens, -1, axis=1)
    j_seen, t_seen = _routing(monkeypatch)
    with jax.disable_jit():                 # the scan runs eagerly: the spy sees values
        j_logits, j_aux = JT.forward_train(jcfg, jp, jnp.asarray(tokens), remat=False)
        j_loss = JT.loss_fn(jcfg, jp, {"tokens": jnp.asarray(tokens),
                                       "labels": jnp.asarray(labels)}, remat=False)
    bk.reset_launch_counts()
    logits, aux = T.forward_train(cfg, tp, torch.from_numpy(tokens))
    loss = T.loss_fn(cfg, tp, {"tokens": torch.from_numpy(tokens),
                               "labels": torch.from_numpy(labels)})
    monkeypatch.undo()
    assert bk.LAUNCHES["block_attn"] == 0
    assert logits.shape == (2, 64, cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
    np.testing.assert_allclose(float(aux), float(j_aux), **AUX_TOL)
    np.testing.assert_allclose(float(loss), float(j_loss), **dict(atol=1e-5, rtol=1e-5))
    n_moe = cfg.n_blocks
    assert len(j_seen) == 2 * n_moe and len(t_seen) == 2 * n_moe   # forward, then loss
    dropped = 0
    for j_idx, (_, gate_idx, _, keep, cap, _) in zip(j_seen, t_seen):
        np.testing.assert_array_equal(gate_idx.numpy(), j_idx)
        want_keep = _reference_keep(j_idx, cfg.moe.n_experts, cap)
        np.testing.assert_array_equal(keep.numpy(), want_keep)
        dropped += int((~want_keep).sum())
    assert dropped > 0


def _decode(step, cache, tokens):
    outs = []
    for t in range(tokens.shape[1]):
        lg, cache = step(cache, tokens[:, t:t + 1])
        outs.append(np.asarray(lg)[:, 0])
    return np.stack(outs, axis=1), cache


@pytest.mark.parametrize("window", [0, 6])
def test_decode_matches_jax(window):
    """decode_step against the reference's, step by step over 16 tokens;
    with a window of 6 the compressed ring wraps twice."""
    jcfg = j_configs.get_smoke(ARCH_ID)
    if window:
        jcfg = dataclasses.replace(jcfg, sliding_window=window)
    jcfg, cfg, jp, tp = _params(jcfg)
    tokens = _tokens(cfg, seed=1)
    jstep = jax.jit(lambda c, t: JT.decode_step(jcfg, jp, c, t))
    want, jcache = _decode(jstep, JT.init_cache(jcfg, 2, SEQ, jnp.float32), jnp.asarray(tokens))
    cache0 = T.init_cache(cfg, 2, SEQ, device="cpu")
    size = window or SEQ
    assert tuple(cache0["slots"]["slot0"]["c_kv"].shape) == (cfg.n_blocks, 2, size, 64)
    assert tuple(cache0["slots"]["slot0"]["k_rope"].shape) == (cfg.n_blocks, 2, size, 16)
    got, cache = _decode(lambda c, t: T.decode_step(cfg, tp, c, t), cache0,
                         torch.from_numpy(tokens))
    np.testing.assert_allclose(got, want, **TOL)
    assert int(cache["pos"]) == int(jcache["pos"]) == SEQ
    for name in ("c_kv", "k_rope"):
        np.testing.assert_allclose(cache["slots"]["slot0"][name].numpy(),
                                   np.asarray(jcache["slots"]["slot0"][name]), **TOL)


@pytest.mark.parametrize("window", [0, 6])
def test_decode_matches_forward_without_drops(window):
    """Decode dispatches each token alone (cap 8, no drops); at
    ``capacity_factor = n_experts / top_k`` the forward drops nothing
    either, so the two are the same model; with a window of 6 the train
    mask and the ring agree on which keys each query sees."""
    _, cfg, _, tp = _params()
    mo = cfg.moe
    cfg = dataclasses.replace(cfg, sliding_window=window, moe=dataclasses.replace(
        mo, capacity_factor=mo.n_experts / mo.top_k))
    tokens = torch.from_numpy(_tokens(cfg, seed=2))
    logits, _ = T.forward_train(cfg, tp, tokens)
    got, _ = _decode(lambda c, t: T.decode_step(cfg, tp, c, t),
                     T.init_cache(cfg, 2, SEQ, device="cpu"), tokens)
    np.testing.assert_allclose(got, logits.numpy(), **DECODE_TOL)


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


def _jax_shapes(tree):
    return {tuple(k.key for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("size", ["smoke", "arch"])
def test_ported_model_has_jax_shapes(size):
    """init_params draws the reference's tree: at SMOKE size for real (and
    the carried JAX tree has the same keys and shapes), at full size under
    FakeTensorMode against ``jax.eval_shape``: 16,210,324,992 parameters,
    the largest leaf the experts' (27, 64, 1408, 2048)."""
    get, j_get = ((configs.get_smoke, j_configs.get_smoke) if size == "smoke"
                  else (configs.get_arch, j_configs.get_arch))
    cfg, jcfg = get(ARCH_ID), j_get(ARCH_ID)
    want = _jax_shapes(jax.eval_shape(lambda k: JT.init_params(jcfg, k, jnp.float32),
                                      jax.random.PRNGKey(0)))
    if size == "smoke":
        mine = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        assert _shapes(_params()[3]) == want
    else:
        with FakeTensorMode():
            mine = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert _shapes(mine) == want
    assert list(mine["blocks"]["slot0"]["mixer"]) == ["wq", "w_dkv", "w_uk", "w_uv", "wo",
                                                      "kv_norm"]
    assert list(mine["blocks"]["slot0"]["ffn"]) == ["router", "w_gate", "w_up", "w_down",
                                                    "shared"]
    total = sum(int(np.prod(s)) for s in want.values())
    # The analytic count leaves out the final norm and each layer's kv_norm.
    assert total == cfg.param_count() + cfg.d_model + cfg.n_blocks * cfg.mla.kv_lora_rank
    if size == "arch":
        assert total == 16_210_324_992
        assert max(want.values(), key=np.prod) == (27, 64, 1408, 2048)
