"""The port's Mamba2 slice against the JAX package, on the CPU.

Weights are the JAX ``T.init_params(cfg, key, jnp.float32)`` pytree carried
across with ``lm_params_from_numpy``; tokens are made with numpy from a
seed. Two configurations: the ``"ssm"`` shape of
tests/test_decode_consistency.py and ``configs.mamba2_130m.SMOKE``.

Contracts, with their tolerances (absolute and relative):
- ``forward_train`` logits and ``loss_fn`` against the reference with its
  ``use_pallas_ssd`` True (its Pallas kernel in interpret mode) and False
  (its plain chunked scan): 1e-4. The port reads the flag nowhere: its
  mixer always calls ``ssd_chunked``, which takes the plain version here
  because the tensors lie on the CPU. Both are float32; the SSD scan's
  prefix sums are float64 on the port's side;
- ``decode_step`` over 16 tokens against the reference's: 1e-4;
- the port's own decode against its forward: 2e-3, the tolerance of
  tests/test_decode_consistency.py;
- the registry and ``param_count``: equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as j_configs
from repro.configs import mamba2_130m as j_mamba
from repro.models import transformer as JT
from repro.models.config import (ArchConfig as JArch, MLAConfig as JMLA, MoEConfig as JMoE,
                                 SSMConfig as JSSM)

from repro_torch import configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.ssd_scan.ssd_scan import LAUNCHES, reset_launch_counts
from repro_torch.models import ArchConfig, MLAConfig, MoEConfig, SSMConfig
from repro_torch.models import transformer as T
from _torch_threads import torch_threads  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
DECODE_TOL = dict(atol=2e-3, rtol=2e-3)
SEQ = 16

J_CASES = {
    "ssm": JArch(name="s", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                 d_ff=0, vocab=64, block_pattern=("mamba",), ffn_pattern=("none",),
                 ssm=JSSM(state_dim=16, head_dim=16, chunk=8), tie_embeddings=True),
    "mamba2-smoke": j_mamba.SMOKE,
}
_SUB = {"ssm": SSMConfig, "moe": MoEConfig, "mla": MLAConfig}


def _port_cfg(jcfg, **over):
    """The port's ArchConfig with the same fields as the reference's."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for name, cls in _SUB.items():
        if kw[name] is not None:
            kw[name] = cls(**dataclasses.asdict(kw[name]))
    kw.update(over)
    return ArchConfig(**kw)


_PARAMS = {}


def _params(case):
    if case not in _PARAMS:
        jp = JT.init_params(J_CASES[case], jax.random.PRNGKey(3), jnp.float32)
        _PARAMS[case] = jp, lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                                 device="cpu")
    return _PARAMS[case]


def _tokens(cfg, batch=2, seq=SEQ, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (batch, seq)).astype(np.int32)


@pytest.mark.parametrize("pallas", [True, False], ids=["kernel-route", "plain-route"])
@pytest.mark.parametrize("case", list(J_CASES))
def test_forward_and_loss_match_jax(case, pallas):
    jcfg = dataclasses.replace(J_CASES[case], use_pallas_ssd=pallas)
    cfg = _port_cfg(jcfg)
    jp, tp = _params(case)
    # The reference's plain route needs L % chunk == 0; its kernel route
    # pads, so it takes a ragged length.
    seq = 40 if pallas else 64
    tokens = _tokens(cfg, seq=seq)
    labels = np.roll(tokens, -1, axis=1)
    j_logits, _ = JT.forward_train(jcfg, jp, jnp.asarray(tokens), remat=False)
    j_loss = JT.loss_fn(jcfg, jp, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
                        remat=False)
    reset_launch_counts()
    logits, aux = T.forward_train(cfg, tp, torch.from_numpy(tokens))
    loss = T.loss_fn(cfg, tp, {"tokens": torch.from_numpy(tokens),
                               "labels": torch.from_numpy(labels)})
    assert LAUNCHES["ssd_scan"] == 0            # CPU tensors take the plain version
    assert logits.shape == (2, seq, cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
    np.testing.assert_allclose(float(loss), float(j_loss), **TOL)


@pytest.mark.parametrize("pallas", [True, False])
def test_mixer_always_calls_ssd_chunked(monkeypatch, pallas):
    """use_pallas_ssd picks no route in the port: the mixer hands the SSD to
    ``ssd_chunked`` either way, so on the card it is always the kernel."""
    from repro_torch.kernels.ssd_scan import ops

    cfg = _port_cfg(J_CASES["ssm"], use_pallas_ssd=pallas)
    _, tp = _params("ssm")
    calls = []
    real = ops.ssd_chunked
    monkeypatch.setattr(ops, "ssd_chunked", lambda *a, **k: calls.append(1) or real(*a, **k))
    T.forward_train(cfg, tp, torch.from_numpy(_tokens(cfg)))
    assert len(calls) == cfg.n_layers


def _decode(step, cache, tokens):
    outs = []
    for t in range(tokens.shape[1]):
        lg, cache = step(cache, tokens[:, t:t + 1])
        outs.append(np.asarray(lg)[:, 0])
    return np.stack(outs, axis=1), cache


@pytest.mark.parametrize("case", list(J_CASES))
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
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(cache["slots"]["slot0"][name].numpy(),
                                   np.asarray(jcache["slots"]["slot0"][name]), **TOL)


@pytest.mark.parametrize("case", list(J_CASES))
def test_decode_matches_forward(case):
    """The port's recurrent decode is the same model as its chunked forward;
    an inactive row keeps its cache."""
    cfg = _port_cfg(J_CASES[case])
    _, tp = _params(case)
    tokens = torch.from_numpy(_tokens(cfg, seed=2))
    logits, _ = T.forward_train(cfg, tp, tokens)
    got, cache = _decode(lambda c, t: T.decode_step(cfg, tp, c, t),
                         T.init_cache(cfg, 2, SEQ, device="cpu"), tokens)
    np.testing.assert_allclose(got, logits.numpy(), **DECODE_TOL)

    active = torch.tensor([True, False])
    _, frozen = T.decode_step(cfg, tp, cache, tokens[:, :1], active=active)
    for name in ("conv", "ssm"):
        old, new = cache["slots"]["slot0"][name], frozen["slots"]["slot0"][name]
        assert torch.equal(old[:, 1], new[:, 1]) and not torch.equal(old[:, 0], new[:, 0])


def test_registry_matches_jax():
    """Every one of the ten ids loads, ARCH and SMOKE, field for field the
    reference's configuration."""
    assert configs.ARCH_IDS == j_configs.ARCH_IDS
    for arch_id in configs.ARCH_IDS:
        for get, j_get in ((configs.get_arch, j_configs.get_arch),
                           (configs.get_smoke, j_configs.get_smoke)):
            mine, ref = get(arch_id), j_get(arch_id)
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
            assert mine == _port_cfg(ref)
    with pytest.raises(KeyError):
        configs.get_arch("no-such-model")


@pytest.mark.parametrize("arch_id", j_configs.ARCH_IDS)
def test_param_count_matches_jax(arch_id):
    for ref in (j_configs.get_arch(arch_id), j_configs.get_smoke(arch_id)):
        assert _port_cfg(ref).param_count() == ref.param_count()


def test_ported_model_has_jax_shapes():
    """init_params draws from a torch.Generator with the reference's shapes,
    for the Mamba2 SMOKE model and for the families ported last: MLA, the
    encoder-decoder with the audio frontend, and a lone audio frontend,
    whose frames go before the tokens as the reference's forward does."""
    def check(mine, ref):
        flat = jax.tree_util.tree_flatten_with_path(ref)[0]
        for path, leaf in flat:
            node = mine
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32
        count = lambda t: sum(map(count, t.values())) if isinstance(t, dict) else 1  # noqa: E731
        assert count(mine) == len(flat)

    cfg = configs.get_smoke("mamba2-130m")
    check(T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"),
          JT.init_params(j_mamba.SMOKE, jax.random.PRNGKey(0), jnp.float32))
    base = JArch(name="d", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                 vocab=64, ffn_pattern=("moe",), moe=JMoE(n_experts=4, top_k=2))
    lately = [
        dataclasses.replace(base, attn_type="mla", mla=JMLA(kv_lora_rank=32, qk_nope_dim=16,
                                                            qk_rope_dim=8, v_head_dim=16)),
        dataclasses.replace(base, enc_dec=True, n_enc_layers=2, frontend="audio"),
        dataclasses.replace(base, frontend="audio", frontend_tokens=5),
    ]
    for jcfg in lately:
        ref = JT.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
        check(T.init_params(_port_cfg(jcfg), torch.Generator().manual_seed(0), device="cpu"),
              ref)
    jcfg = lately[-1]
    ref = jax.tree_util.tree_map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(1),
                                                            jnp.float32))
    tokens = np.random.default_rng(0).integers(0, 64, (2, 7)).astype(np.int32)
    emb = np.random.default_rng(1).standard_normal((2, 5, 64)).astype(np.float32)
    want, _ = JT.forward_train(jcfg, jax.tree_util.tree_map(jnp.asarray, ref),
                               jnp.asarray(tokens), jnp.asarray(emb), remat=False)
    got, _ = T.forward_train(_port_cfg(jcfg), lm_params_from_numpy(ref, device="cpu"),
                             torch.from_numpy(tokens), torch.from_numpy(emb))
    assert got.shape == (2, 7, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
