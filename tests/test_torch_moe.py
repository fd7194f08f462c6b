"""The port's MoE layer and the three models it opens (``grok-1-314b``,
``jamba-1.5-large-398b``, and ``internvl2-1b`` with its vision stub) against
the JAX package, on the CPU.

Weights are the JAX ``init_moe`` / ``T.init_params(..., jnp.float32)``
pytrees, carried across with ``lm_params_from_numpy``; inputs, tokens and
the stub's patch embeddings are made with numpy from a seed.

Contracts, with their tolerances (absolute and relative):
- ``moe_apply`` against ``repro.models.layers.moe_apply``: output 1e-5, aux
  loss 1e-6; the same ``gate_idx`` as the reference's ``jax.lax.top_k``, and
  the same dropped (token, choice) pairs as the reference's capacity rule
  (token-major cumsum, choice rank inside), over top-1, top-2, a capacity
  factor of 0.25 (choices drop), ``group_size`` regrouping and a shared
  expert;
- the SMOKE models: ``forward_train`` logits 1e-4 and aux 1e-6, ``loss_fn``
  1e-5, ``decode_step`` against the reference's 1e-4; the port's decode
  against its forward 2e-3 at ``capacity_factor = n_experts / top_k``,
  where no choice drops (a one-token decode step never drops: cap >= 8);
- the registry, ``param_count``, and the tree's keys and shapes: equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.config import ArchConfig as JArch, MoEConfig as JMoE

from repro_torch import configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.block_attn import block_attn as bk
from repro_torch.kernels.ssd_scan import ssd_scan as sk
from repro_torch.models import ArchConfig, MLAConfig, MoEConfig, SSMConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from _torch_threads import torch_threads  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
MOE_TOL = dict(atol=1e-5, rtol=1e-5)
AUX_TOL = dict(atol=1e-6, rtol=1e-6)
DECODE_TOL = dict(atol=2e-3, rtol=2e-3)
SEQ = 16
MOE_IDS = ["grok-1-314b", "jamba-1.5-large-398b", "internvl2-1b"]
_SUB = {"ssm": SSMConfig, "moe": MoEConfig, "mla": MLAConfig}


def _port_cfg(jcfg, **over):
    """The port's ArchConfig with the same fields as the reference's."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for name, cls in _SUB.items():
        if kw[name] is not None:
            kw[name] = cls(**dataclasses.asdict(kw[name]))
    kw.update(over)
    return ArchConfig(**kw)


def _layer_cfg(**moe):
    return JArch(name="m", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_ff=48,
                 vocab=64, ffn_pattern=("moe",), moe=JMoE(**moe))


MOE_CASES = {
    "top1": (_layer_cfg(n_experts=4, top_k=1), 24),
    "top2": (_layer_cfg(n_experts=4, top_k=2, d_expert=40), 24),
    "drop": (_layer_cfg(n_experts=4, top_k=2, capacity_factor=0.25), 64),
    "group": (_layer_cfg(n_experts=4, top_k=2, group_size=16), 64),
    "shared": (_layer_cfg(n_experts=8, top_k=2, n_shared=1), 24),
}


def _reference_keep(gate_idx, n_experts, cap):
    """The reference's capacity rule written out: walk each group's choices
    token-major, choice rank inside, and keep a choice while its expert has
    fewer than ``cap`` earlier ones."""
    b, l, k = gate_idx.shape
    keep = np.zeros((b, l * k), dtype=bool)
    for r, row in enumerate(gate_idx.reshape(b, l * k)):
        seen = np.zeros(n_experts, dtype=int)
        for j, ex in enumerate(row):
            keep[r, j] = seen[ex] < cap
            seen[ex] += 1
    return keep.reshape(b, l, k)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_jax(case, monkeypatch):
    jcfg, seq = MOE_CASES[case]
    cfg = _port_cfg(jcfg)
    jp = jax.tree_util.tree_map(np.asarray, JL.init_moe(jax.random.PRNGKey(1), jcfg,
                                                        jnp.float32))
    tp = lm_params_from_numpy(jp, device="cpu")
    x = np.random.default_rng(2).standard_normal((2, seq, cfg.d_model)).astype(np.float32)

    seen = []
    real_top_k = jax.lax.top_k

    def spy(operand, k):
        out = real_top_k(operand, k)
        seen.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(jax.lax, "top_k", spy)
    j_out, j_aux = JL.moe_apply(jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x), jcfg)
    monkeypatch.undo()
    out, aux = L.moe_apply(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(j_aux), **AUX_TOL)

    (j_idx,) = seen
    gs = cfg.moe.group_size
    xg = torch.from_numpy(x)
    if gs and seq > gs and seq % gs == 0:
        xg = xg.reshape(-1, gs, cfg.d_model)
    gate_vals, gate_idx, slot, keep, cap, _ = L.moe_route(tp, xg, cfg)
    assert gate_idx.shape == j_idx.shape == (*xg.shape[:2], cfg.moe.top_k)
    np.testing.assert_array_equal(gate_idx.numpy(), j_idx)
    l = xg.shape[1]
    assert cap == max(8, int(l * cfg.moe.top_k * cfg.moe.capacity_factor / cfg.moe.n_experts))
    want_keep = _reference_keep(j_idx, cfg.moe.n_experts, cap)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert bool((gate_vals[~keep] == 0).all()) and bool((gate_vals[keep] > 0).all())
    if case in ("drop", "group"):
        assert not want_keep.all()                  # the case does drop choices
    if case == "group":
        assert xg.shape[0] == 2 * seq // gs


def test_moe_top_k_ties_go_to_the_lower_index():
    """Equal router probabilities: the lower expert index first, as
    ``jax.lax.top_k`` orders them."""
    cfg = _port_cfg(_layer_cfg(n_experts=4, top_k=2))
    p = {"router": torch.zeros(cfg.d_model, 4)}
    _, gate_idx, slot, keep, _, _ = L.moe_route(p, torch.ones(1, 3, cfg.d_model), cfg)
    assert gate_idx.tolist() == [[[0, 1]] * 3]
    assert slot.tolist() == [[[0, 0], [1, 1], [2, 2]]] and bool(keep.all())


_PARAMS = {}


def _params(arch_id):
    """(JAX config, port config, JAX params, port params) of a SMOKE model."""
    if arch_id not in _PARAMS:
        jcfg = j_configs.get_smoke(arch_id)
        jp = JT.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32)
        tree = jax.tree_util.tree_map(np.array, jp)
        if jcfg.qkv_bias:                     # zero at init: made nonzero so they count
            rng = np.random.default_rng(5)
            for slot in tree["blocks"].values():
                for name in ("bq", "bk", "bv"):
                    if name in slot["mixer"]:
                        slot["mixer"][name] = (0.2 * rng.standard_normal(
                            slot["mixer"][name].shape)).astype(np.float32)
        _PARAMS[arch_id] = (jcfg, configs.get_smoke(arch_id),
                            jax.tree_util.tree_map(jnp.asarray, tree),
                            lm_params_from_numpy(tree, device="cpu"))
    return _PARAMS[arch_id]


def _tokens(cfg, batch=2, seq=SEQ, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (batch, seq)).astype(np.int32)


def _embeds(cfg, batch=2, seed=4):
    """The stub's patch embeddings, N(0, 1), or None without a frontend."""
    if cfg.frontend == "none":
        return None
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch_id", MOE_IDS)
def test_forward_and_loss_match_jax(arch_id):
    jcfg, cfg, jp, tp = _params(arch_id)
    tokens = _tokens(cfg, seq=64)          # a multiple of Jamba's SSD chunk (32)
    labels = np.roll(tokens, -1, axis=1)
    embeds = _embeds(cfg)
    j_emb = None if embeds is None else jnp.asarray(embeds)
    t_emb = None if embeds is None else torch.from_numpy(embeds)
    j_logits, j_aux = JT.forward_train(jcfg, jp, jnp.asarray(tokens), j_emb, remat=False)
    j_batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    t_batch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    if embeds is not None:
        j_batch["embeds"], t_batch["embeds"] = j_emb, t_emb
    j_loss = JT.loss_fn(jcfg, jp, j_batch, remat=False)
    bk.reset_launch_counts()
    sk.reset_launch_counts()
    logits, aux = T.forward_train(cfg, tp, torch.from_numpy(tokens), t_emb)
    loss = T.loss_fn(cfg, tp, t_batch)
    assert bk.LAUNCHES["block_attn"] == 0 and sk.LAUNCHES["ssd_scan"] == 0
    assert logits.shape == (2, 64, cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
    np.testing.assert_allclose(float(aux), float(j_aux), **AUX_TOL)
    np.testing.assert_allclose(float(loss), float(j_loss), **MOE_TOL)
    if cfg.moe is None:
        assert float(aux) == 0.0
    else:
        assert float(aux) > 0.0


def _decode(step, cache, tokens):
    outs = []
    for t in range(tokens.shape[1]):
        lg, cache = step(cache, tokens[:, t:t + 1])
        outs.append(np.asarray(lg)[:, 0])
    return np.stack(outs, axis=1), cache


@pytest.mark.parametrize("arch_id", MOE_IDS)
def test_decode_matches_jax(arch_id):
    jcfg, cfg, jp, tp = _params(arch_id)
    tokens = _tokens(cfg, seed=1)
    jstep = jax.jit(lambda c, t: JT.decode_step(jcfg, jp, c, t))
    want, jcache = _decode(jstep, JT.init_cache(jcfg, 2, SEQ, jnp.float32), jnp.asarray(tokens))
    got, cache = _decode(lambda c, t: T.decode_step(cfg, tp, c, t),
                         T.init_cache(cfg, 2, SEQ, device="cpu"), torch.from_numpy(tokens))
    np.testing.assert_allclose(got, want, **TOL)
    assert int(cache["pos"]) == int(jcache["pos"]) == SEQ


@pytest.mark.parametrize("arch_id", MOE_IDS)
def test_decode_matches_forward_without_drops(arch_id):
    """Decode dispatches each token alone (cap 8, nothing dropped); the
    forward over the whole sequence drops at capacity factor 1. At
    ``capacity_factor = n_experts / top_k`` the forward's cap is >= its
    length and nothing drops, so the two are the same model."""
    _, cfg, _, tp = _params(arch_id)
    if cfg.moe is not None:
        mo = cfg.moe
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            mo, capacity_factor=mo.n_experts / mo.top_k))
    tokens = torch.from_numpy(_tokens(cfg, seed=2))
    logits, _ = T.forward_train(cfg, tp, tokens)
    got, _ = _decode(lambda c, t: T.decode_step(cfg, tp, c, t),
                     T.init_cache(cfg, 2, SEQ, device="cpu"), tokens)
    np.testing.assert_allclose(got, logits.numpy(), **DECODE_TOL)


@pytest.mark.parametrize("arch_id", MOE_IDS)
def test_registry_and_param_count_match_jax(arch_id):
    for get, j_get in ((configs.get_arch, j_configs.get_arch),
                       (configs.get_smoke, j_configs.get_smoke)):
        mine, ref = get(arch_id), j_get(arch_id)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine == _port_cfg(ref)
        assert mine.param_count() == ref.param_count()


@pytest.mark.parametrize("arch_id", MOE_IDS)
def test_ported_model_has_jax_shapes(arch_id):
    """init_params draws from a torch.Generator with the reference's tree;
    the converted JAX tree has the same keys and shapes, the MoE leaves
    (router (d, E), w_gate/w_up (E, d, de), w_down (E, de, d)) included."""
    cfg = configs.get_smoke(arch_id)
    mine = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, _, _, carried = _params(arch_id)
    ref = JT.init_params(j_configs.get_smoke(arch_id), jax.random.PRNGKey(0), jnp.float32)
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    for tree in (mine, carried):
        for path, leaf in flat:
            node = tree
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32
        count = lambda t: sum(map(count, t.values())) if isinstance(t, dict) else 1  # noqa: E731
        assert count(tree) == len(flat)
    if cfg.moe is not None:
        slot = next(f"slot{i}" for i in range(len(cfg.block_pattern))
                    if cfg.ffn_kind(i) == "moe")
        moe = carried["blocks"][slot]["ffn"]
        e, d, de = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert or cfg.d_ff
        nb = cfg.n_blocks
        # The reference's order of draws; a JAX tree comes across key-sorted.
        assert list(mine["blocks"][slot]["ffn"]) == ["router", "w_gate", "w_up", "w_down"]
        assert set(moe) == set(mine["blocks"][slot]["ffn"])
        assert tuple(moe["router"].shape) == (nb, d, e)
        assert tuple(moe["w_gate"].shape) == tuple(moe["w_up"].shape) == (nb, e, d, de)
        assert tuple(moe["w_down"].shape) == (nb, e, de, d)
    size = lambda t: sum(map(size, t.values())) if isinstance(t, dict) else t.numel()  # noqa: E731
    # The analytic count leaves out the final norm, the QKV biases, and a
    # Mamba2 mixer's conv bias and gated norm.
    left_out = {"attn": (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim_ * cfg.qkv_bias}
    if cfg.ssm is not None:
        d_in = cfg.ssm.expand * cfg.d_model
        left_out["mamba"] = 2 * d_in + 2 * cfg.ssm.n_groups * cfg.ssm.state_dim
    per_block = sum(left_out[kind] for kind in cfg.block_pattern)
    assert size(mine) == cfg.param_count() + cfg.d_model + cfg.n_blocks * per_block
