"""The port's bf16 language-model path against the JAX package's, on the CPU.

The reference's default dtype is bf16 (``T.init_params(..., jnp.bfloat16)``,
``launch/serve.py --full``). Weights are the JAX bf16 ``init_params``
pytrees, carried across bit for bit with ``lm_params_from_numpy``; inputs,
tokens, frame embeddings and request workloads are made with numpy from a
seed. Pallas kernels run in interpret mode. SMOKE widths.

Contracts, with their tolerances:
- ``init_params(dtype=bf16)``: every leaf's shape and dtype equal the
  reference's, for all ten registry ids; ``abstract_params`` equals the
  reference's at full size, on the meta device;
- ``lm_params_from_numpy`` of a JAX bf16 pytree: bit for bit (the uint16
  views equal);
- the plain bf16 ``block_attention`` against the JAX ``block_attention(...,
  interpret=True)`` in bf16: within 1 bf16 ulp an element (both round one
  float32 value once; ulps are taken no finer than at 2^-8 of the largest
  |v|, below which the order of the float32 sums decides);
- the plain bf16 ``ssd_chunked`` against the JAX ``ssd_chunked(...,
  interpret=True)`` in bf16: 1e-2 absolute and relative (the JAX kernel's
  float32 prefix sums against the port's float64 ones, then one bf16
  rounding; the reference's own ``test_kernel_bf16_close`` allows 0.15
  and 0.1 against the float32 recurrence);
- SMOKE ``forward_train`` logits, ``decode_step`` logits (8 steps) and
  ``prefill_chunk`` logits (rows of mixed ``n_valid``) against the
  reference's bf16 path: 0.05 absolute and relative (the reference's own
  ``test_kernel_bf16`` tolerance): each framework rounds its bf16 products
  and elementwise steps at other places. ``loss_fn``: 1e-3 relative;
- MoE routing (``grok``, ``jamba`` at ``capacity_factor = e / k``): the
  router runs in float32 on bf16 activations that differ between the two
  frameworks by bf16 roundings, so a near-tie of the k-th and (k+1)-th
  expert can flip. Each row's first flip must be a bf16 near-tie (the
  port's router probabilities of the two within ``ROUTE_TIE`` = 2^-5 of the
  k-th: 8 bf16 ulps), and each row is held up to its first flip;
- ``_sdpa(logits_bf16=True)`` (``cfg.attn_logits_bf16``) in decode;
- the bf16 ``ServeEngine`` against the JAX ``ServeEngine`` in bf16 (on a
  one-device mesh of automatic axes) at temperature 0: equal token streams,
  a difference allowed only where the port's sequential run's top-2 gap is
  a bf16 near-tie (below 2 bf16 ulps of the top logit, 2 * 2^-8 * |top|),
  and equal counters. The encoder-decoder runs its encoder at admission in
  float32 on both sides;
- a bf16 forward's matrix products are bf16 but the MoE router's, and the
  encoder run on float32 embeddings (the engine's admission) is float32
  throughout: no silent upcast.
"""
import argparse
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as j_configs
from repro.kernels.block_attn import block_attention as j_block_attention
from repro.kernels.ssd_scan import ssd_chunked as j_ssd_chunked
from repro.models import transformer as JT
from repro.serve import EngineConfig as JEngineConfig, ServeEngine as JServeEngine
from repro.serve import scheduler as j_sched

from repro_torch import configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.block_attn import ops as attn_ops
from repro_torch.kernels.block_attn.ref import block_attention_plain
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_plain
from repro_torch.launch import serve as launch
from repro_torch.models import ArchConfig, MLAConfig, MoEConfig, SSMConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve import EngineConfig, ServeEngine

BF = torch.bfloat16
LOGIT_TOL = dict(atol=0.05, rtol=0.05)
LOSS_RTOL = 1e-3
SSD_TOL = dict(atol=1e-2, rtol=1e-2)
ROUTE_TIE = 2.0 ** -5          # a bf16 routing near-tie, relative to the k-th probability
SERVE_TIE = 2 * 2.0 ** -8      # a bf16 top-2 near-tie, relative to the top logit
_SUB = {"ssm": SSMConfig, "moe": MoEConfig, "mla": MLAConfig}
MODELS = ["yi-6b", "mamba2-130m", "grok-1-314b", "jamba-1.5-large-398b",
          "deepseek-v2-lite-16b", "seamless-m4t-large-v2"]


def _no_drops(cfg):
    """capacity_factor = e / k: no choice is dropped, in a group of any size."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def _port_cfg(jcfg):
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for name, cls in _SUB.items():
        if kw[name] is not None:
            kw[name] = cls(**dataclasses.asdict(kw[name]))
    return ArchConfig(**kw)


_PARAMS = {}


def _params(arch_id):
    """(JAX config, port config, JAX bf16 params, port params) of the SMOKE
    configuration, MoE at capacity_factor = e / k."""
    if arch_id not in _PARAMS:
        jcfg = _no_drops(j_configs.get_smoke(arch_id))
        jp = JT.init_params(jcfg, jax.random.PRNGKey(1), jnp.bfloat16)
        tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        _PARAMS[arch_id] = (jcfg, _port_cfg(jcfg), jp, tp)
    return _PARAMS[arch_id]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _bf16_ulps(want: np.ndarray, got: torch.Tensor, scale: float) -> float:
    """The largest |got - want| in bf16 ulps, each taken at the element's
    magnitude but no finer than at 2^-8 * ``scale`` (the operands' largest
    magnitude): an output that cancels below that is set by the float32
    sums' order, not by the one rounding."""
    w = np.asarray(want, np.float32)
    g = got.float().numpy()
    mag = np.maximum(np.maximum(np.abs(w), np.abs(g)), 2.0 ** -8 * scale)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    return float((np.abs(g - w) / ulp).max())


def _j_dtype_name(leaf):
    return np.dtype(leaf.dtype).name


# ------------------------------------------------------------ parameters
@pytest.mark.parametrize("arch_id", configs.ARCH_IDS)
def test_init_params_bf16_leaf_dtypes_match_jax(arch_id):
    cfg = configs.get_smoke(arch_id)
    mine = _flat(T.init_params(cfg, torch.Generator().manual_seed(0), BF, device="cpu"))
    ref = _flat(jax.eval_shape(lambda k: JT.init_params(j_configs.get_smoke(arch_id), k,
                                                        jnp.bfloat16),
                               jax.random.PRNGKey(0)))
    assert sorted(mine) == sorted(ref)
    for name, leaf in ref.items():
        assert tuple(mine[name].shape) == tuple(leaf.shape), name
        assert str(mine[name].dtype).split(".")[-1] == _j_dtype_name(leaf), name


@pytest.mark.parametrize("arch_id", configs.ARCH_IDS)
def test_abstract_params_match_jax_at_full_size(arch_id):
    mine = _flat(T.abstract_params(configs.get_arch(arch_id)))
    ref = _flat(JT.abstract_params(j_configs.get_arch(arch_id)))
    assert sorted(mine) == sorted(ref)
    for name, leaf in ref.items():
        assert mine[name].device.type == "meta", name
        assert tuple(mine[name].shape) == tuple(leaf.shape), name
        assert str(mine[name].dtype).split(".")[-1] == _j_dtype_name(leaf), name


@pytest.mark.parametrize("arch_id", ["mamba2-130m", "grok-1-314b", "seamless-m4t-large-v2"])
def test_lm_params_from_numpy_bf16_is_bit_identical(arch_id):
    tree = jax.tree_util.tree_map(np.asarray, JT.init_params(
        j_configs.get_smoke(arch_id), jax.random.PRNGKey(2), jnp.bfloat16))
    ref, mine = _flat(tree), _flat(lm_params_from_numpy(tree, device="cpu"))
    assert sorted(mine) == sorted(ref)
    for name, leaf in ref.items():
        got = mine[name]
        if leaf.dtype.name == "bfloat16":
            assert got.dtype == BF, name
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), leaf.view(np.int16))
        else:
            assert got.dtype == torch.float32, name
            np.testing.assert_array_equal(got.numpy(), leaf)


# ------------------------------------------------------------------ kernels
ATTN_CASES = [  # (B, L, H, KV, hd, causal): block multiples of 32
    (2, 96, 4, 2, 32, True),
    (1, 64, 2, 2, 32, False),
    (2, 64, 4, 1, 16, True),
    (1, 128, 8, 2, 64, True),
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_block_attention_plain_bf16_within_one_ulp_of_jax(case):
    b, l, h, kv, hd, causal = case
    rng = np.random.default_rng(sum(case))
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, l, h, hd), (b, l, kv, hd), (b, l, kv, hd)))
    want = j_block_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), bq=32, bk=32,
                             causal=causal, interpret=True)
    got = block_attention_plain(*(torch.from_numpy(a).to(BF) for a in (q, k, v)),
                                causal=causal)
    assert got.dtype == BF and tuple(got.shape) == want.shape
    assert _bf16_ulps(want, got, float(np.abs(v).max())) <= 1


SSD_CASES = [  # (B, H, L, P, N, G, chunk)
    (1, 2, 64, 32, 16, 2, 16),
    (2, 4, 50, 16, 8, 2, 16),       # L not a chunk multiple
    (2, 8, 96, 64, 32, 1, 32),      # one group for eight heads
]


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_chunked_plain_bf16_matches_jax(case):
    bsz, h, l, p, n, g, chunk = case
    rng = np.random.default_rng(sum(case))
    x = (0.8 * rng.standard_normal((bsz, h, l, p))).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, h, l)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 8.0, h)).astype(np.float32)
    b = (0.5 * rng.standard_normal((bsz, g, l, n))).astype(np.float32)
    c = (0.5 * rng.standard_normal((bsz, g, l, n))).astype(np.float32)
    want = j_ssd_chunked(jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt), jnp.asarray(a_log),
                         jnp.asarray(b, jnp.bfloat16), jnp.asarray(c, jnp.bfloat16),
                         chunk=chunk, interpret=True)
    got = ssd_ops.ssd_chunked(torch.from_numpy(x).to(BF), torch.from_numpy(dt),
                              torch.from_numpy(a_log), torch.from_numpy(b).to(BF),
                              torch.from_numpy(c).to(BF), chunk=chunk)
    assert got.dtype == BF
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **SSD_TOL)
    plain, state = ssd_chunked_plain(torch.from_numpy(x).to(BF), torch.from_numpy(dt),
                                     torch.from_numpy(a_log), torch.from_numpy(b).to(BF),
                                     torch.from_numpy(c).to(BF), chunk)
    assert torch.equal(plain, got) and state.dtype == torch.float32


# -------------------------------------------------------------------- model
def _routing(monkeypatch):
    """Spies on both routers -> (JAX calls, port calls), each a list of
    (probabilities (B, T, e), gate_idx (B, T, k)) in call order."""
    j_seen, t_seen = [], []
    real_top_k, real_route = jax.lax.top_k, L.moe_route

    def j_spy(operand, k):
        out = real_top_k(operand, k)
        j_seen.append((np.asarray(operand), np.asarray(out[1])))
        return out

    def t_spy(p, x, cfg):
        out = real_route(p, x, cfg)
        t_seen.append((torch.softmax(x.float() @ p["router"], -1).numpy(), out[1].numpy()))
        return out

    monkeypatch.setattr(jax.lax, "top_k", j_spy)
    monkeypatch.setattr(L, "moe_route", t_spy)
    return j_seen, t_seen


def _first_flips(j_seen, t_seen, rows, k):
    """Each row's first position whose top-k set differs between the runs
    (``None``: none), after checking that the earliest such flip of each row
    is a bf16 near-tie in the port's router."""
    first = [None] * rows
    for (_, ji), (tp, ti) in zip(j_seen, t_seen):
        ji, ti = ji.reshape(rows, -1, k), ti.reshape(rows, -1, k)
        tp = tp.reshape(rows, -1, tp.shape[-1])
        differs = (np.sort(ji, -1) != np.sort(ti, -1)).any(-1)
        for r in range(rows):
            hits = np.nonzero(differs[r])[0]
            if hits.size and (first[r] is None or hits[0] < first[r]):
                s = np.sort(tp[r, hits[0]])[::-1]
                assert s[k - 1] - s[k] < ROUTE_TIE * s[k - 1], (r, hits[0], s[k - 1], s[k])
                first[r] = int(hits[0])
    return first


def _hold_rows(got, want, first):
    """Logits (B, T, V) of each row up to its first flip, LOGIT_TOL."""
    held = 0
    for r, stop in enumerate(first):
        stop = got.shape[1] if stop is None else stop
        np.testing.assert_allclose(got[r, :stop].float().numpy(),
                                   np.asarray(want[r, :stop], np.float32), **LOGIT_TOL)
        held += stop
    assert held >= got.shape[1] // 2       # at least a quarter of the positions held
    return held


def _inputs(cfg, b=2, s=24, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    embeds = (rng.standard_normal((b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
              if cfg.enc_dec else None)
    return tokens, embeds


@pytest.mark.parametrize("arch_id", MODELS)
def test_forward_and_loss_bf16_match_jax(arch_id, monkeypatch):
    jcfg, cfg, jp, tp = _params(arch_id)
    tokens, embeds = _inputs(cfg)
    labels = np.roll(tokens, -1, axis=1)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    if embeds is not None:
        jb["embeds"], tb["embeds"] = jnp.asarray(embeds), torch.from_numpy(embeds)
    j_seen, t_seen = _routing(monkeypatch)
    with jax.disable_jit():
        want, _ = JT.forward_train(jcfg, jp, jb["tokens"], jb.get("embeds"), remat=False)
    with torch.no_grad():
        got, _ = T.forward_train(cfg, tp, tb["tokens"], tb.get("embeds"))
    assert got.dtype == BF and tuple(got.shape) == want.shape
    first = (_first_flips(j_seen, t_seen, tokens.shape[0], cfg.moe.top_k)
             if cfg.moe else [None] * tokens.shape[0])
    _hold_rows(got, want, first)
    if all(f is None for f in first):
        with jax.disable_jit():
            j_loss = JT.loss_fn(jcfg, jp, jb, remat=False)
        with torch.no_grad():
            loss = T.loss_fn(cfg, tp, tb)
        assert loss.dtype == torch.float32
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=LOSS_RTOL)


def _caches(jcfg, cfg, jp, tp, b, max_len, embeds):
    jc = JT.init_cache(jcfg, b, max_len, jnp.bfloat16)
    tc = T.init_cache(cfg, b, max_len, BF, device="cpu")
    if cfg.enc_dec:
        jc["enc_out"] = JT._run_encoder(jcfg, jp, jnp.asarray(embeds),
                                        remat=False).astype(jnp.bfloat16)
        with torch.no_grad():
            tc["enc_out"] = T._run_encoder(cfg, tp, torch.from_numpy(embeds),
                                           remat=False).to(BF)
        np.testing.assert_allclose(tc["enc_out"].float().numpy(),
                                   np.asarray(jc["enc_out"], np.float32), **LOGIT_TOL)
    return jc, tc


@pytest.mark.parametrize("arch_id", MODELS)
def test_decode_step_bf16_matches_jax(arch_id, monkeypatch):
    """8 decode steps in lockstep from an empty bf16 cache."""
    jcfg, cfg, jp, tp = _params(arch_id)
    tokens, embeds = _inputs(cfg, seed=1)
    jc, tc = _caches(jcfg, cfg, jp, tp, 2, 16, embeds)
    j_seen, t_seen = _routing(monkeypatch)
    want, got = [], []
    for t in range(8):
        with jax.disable_jit():
            jl, jc = JT.decode_step(jcfg, jp, jc, jnp.asarray(tokens[:, t:t + 1]))
        with torch.no_grad():
            tl, tc = T.decode_step(cfg, tp, tc, torch.from_numpy(tokens[:, t:t + 1]))
        want.append(np.asarray(jl))
        got.append(tl)
    assert all(leaf.dtype == BF for leaf in _flat(tc["slots"]).values())
    first = [None, None]
    if cfg.moe:
        # One router call a MoE layer a step, (B, 1, .): each layer's calls
        # over the steps, with the step as the position.
        n_moe = len(t_seen) // 8

        def by_layer(seen):
            return [tuple(np.concatenate([seen[s * n_moe + i][j] for s in range(8)], 1)
                          for j in range(2)) for i in range(n_moe)]

        first = _first_flips(by_layer(j_seen), by_layer(t_seen), 2, cfg.moe.top_k)
    _hold_rows(torch.cat(got, 1), np.concatenate(want, 1), first)


@pytest.mark.parametrize("arch_id", MODELS)
def test_prefill_chunk_bf16_matches_jax(arch_id, monkeypatch):
    """Two chunks into a bf16 cache, rows of mixed n_valid (0 included)."""
    jcfg, cfg, jp, tp = _params(arch_id)
    tokens, embeds = _inputs(cfg, b=3, s=12, seed=2)
    jc, tc = _caches(jcfg, cfg, jp, tp, 3, 16, embeds)
    j_seen, t_seen = _routing(monkeypatch)
    done = np.zeros(3, np.int32)
    for nv in (np.array([6, 3, 0], np.int32), np.array([5, 6, 4], np.int32)):
        args = (tokens[np.arange(3)[:, None], np.minimum(done[:, None] + np.arange(6), 11)],
                done, nv)
        with jax.disable_jit():
            jl, jc = JT.prefill_chunk(jcfg, jp, jc, *(jnp.asarray(a) for a in args))
        with torch.no_grad():
            tl, tc = T.prefill_chunk(cfg, tp, tc, *(torch.from_numpy(a) for a in args))
        first = [None] * 3
        if cfg.moe:
            first = _first_flips(j_seen, t_seen, 3, cfg.moe.top_k)
            j_seen.clear()
            t_seen.clear()
        for r in range(3):
            stop = nv[r] if first[r] is None else min(nv[r], first[r])
            np.testing.assert_allclose(tl[r, :stop].float().numpy(),
                                       np.asarray(jl[r, :stop], np.float32), **LOGIT_TOL)
        done = done + nv
    assert all(leaf.dtype == BF for leaf in _flat(tc["slots"]).values())


def test_logits_bf16_decode_matches_jax(monkeypatch):
    """cfg.attn_logits_bf16 reaches the decode attention (the scores stay
    bf16), as the reference's; the full-sequence kernel ignores it."""
    jcfg, _, jp, tp = _params("yi-6b")
    jcfg = dataclasses.replace(jcfg, attn_logits_bf16=True)
    cfg = _port_cfg(jcfg)
    tokens, _ = _inputs(cfg, seed=3)
    jc, tc = _caches(jcfg, cfg, jp, tp, 2, 16, None)
    flags = []
    real = L._sdpa
    monkeypatch.setattr(L, "_sdpa", lambda *a: flags.append(a[5]) or real(*a))
    for t in range(6):
        jl, jc = JT.decode_step(jcfg, jp, jc, jnp.asarray(tokens[:, t:t + 1]))
        with torch.no_grad():
            tl, tc = T.decode_step(cfg, tp, tc, torch.from_numpy(tokens[:, t:t + 1]))
        np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32), **LOGIT_TOL)
    assert flags == [True] * (6 * cfg.n_layers)


# --------------------------------------------------------------- dtype flow
class _Products(TorchDispatchMode):
    """Records the operand dtypes of every matrix product."""

    PRODUCTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.PRODUCTS:
            self.seen.append({a.dtype for a in args if isinstance(a, torch.Tensor)})
        return func(*args, **(kwargs or {}))


def test_bf16_products_run_in_bf16(monkeypatch):
    """The jamba SMOKE forward (Mamba2, attention and MoE slots) in bf16:
    every matrix product is bf16 but one router product a MoE slot; the
    two kernels' plain versions, which upcast by design, are replaced by
    stubs here. The encoder on float32 embeddings (the serve engine's
    admission) runs every product in float32."""
    _, cfg, _, tp = _params("jamba-1.5-large-398b")
    monkeypatch.setattr(attn_ops, "block_attention", lambda q, k, v, **kw: torch.zeros_like(q))
    monkeypatch.setattr(ssd_ops, "ssd_chunked", lambda x, *a, **kw: torch.zeros_like(x))
    tokens, _ = _inputs(cfg)
    with torch.no_grad(), _Products() as rec:
        T.forward_train(cfg, tp, torch.from_numpy(tokens))
    kinds = [d for d in rec.seen]
    n_moe = sum(cfg.ffn_kind(i) == "moe" for i in range(len(cfg.block_pattern))) * cfg.n_blocks
    assert kinds.count({torch.float32}) == n_moe
    assert all(d in ({BF}, {torch.float32}) for d in kinds) and len(kinds) > 2 * n_moe

    _, scfg, _, sp = _params("seamless-m4t-large-v2")
    emb = torch.from_numpy(_inputs(scfg)[1][:1])
    with torch.no_grad(), _Products() as rec:
        out = T._run_encoder(scfg, sp, emb, remat=False)
    assert out.dtype == torch.float32 and rec.seen
    assert all(d == {torch.float32} for d in rec.seen)


# ------------------------------------------------------------------ serving
def _workload(cfg, **over):
    args = dict(seed=0, requests=8, prompt_len=8, gen=8, mixed=True, arrival=0.5,
                eos_id=-1, temperature=0.0)
    args.update(over)
    return launch.build_requests(argparse.Namespace(**args), cfg)


def _j_requests(reqs):
    return [j_sched.Request(rid=r.rid, prompt=r.prompt, max_tokens=r.max_tokens,
                            eos_id=r.eos_id, temperature=r.temperature,
                            arrival_step=r.arrival_step, embeds=r.embeds) for r in reqs]


def _counters(metrics):
    return {**{k: v for k, v in metrics.summary().items()
               if not k.endswith("_s") and k not in ("tok_s", "total_tok_s")},
            "requests": {rid: (m.prompt_len, m.n_generated, m.arrival_step, m.admit_step,
                               m.finish_step) for rid, m in metrics.requests.items()}}


def _same_up_to_bf16_tie(cfg, params, req, max_len, got, want):
    """Equal streams, or equal up to a first difference where the port's
    sequential run took its token at a bf16 near-tie: a top-2 gap of at
    most SERVE_TIE times its largest logit."""
    if got == want:
        return True
    gaps, tops = [], []
    real = torch.topk

    def spy(row, k):
        out = real(row, k)
        tops.append(float(out.values[0].abs()))
        return out

    with mock.patch.object(torch, "topk", spy):
        seq = launch.sequential_reference(cfg, params, req, max_len, "cpu", gaps)
    first = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    return seq[:first] == got[:first] and gaps[first] <= SERVE_TIE * tops[first]


@pytest.mark.parametrize("arch_id", ["yi-6b", "mamba2-130m", "seamless-m4t-large-v2",
                                     "deepseek-v2-lite-16b"])
def test_serve_engine_bf16_matches_jax_engine(arch_id):
    """The launcher's requests through the JAX engine and the port's, both
    in bf16 (params and cache), at temperature 0."""
    jcfg, cfg, jp, tp = _params(arch_id)
    kw = dict(max_concurrency=4, max_len=16, chunk=4)
    reqs = _workload(cfg)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jeng = JServeEngine(jcfg, jp, JEngineConfig(dtype=jnp.bfloat16, **kw), mesh=mesh)
    want = jeng.run(_j_requests(reqs))
    eng = ServeEngine(cfg, tp, EngineConfig(dtype=BF, **kw), device="cpu")
    got = eng.run(reqs)
    assert eng.cache["slots"]["slot0"][next(iter(eng.cache["slots"]["slot0"]))].dtype == BF
    assert [st.request.rid for st in got] == [st.request.rid for st in want]
    for g, w in zip(got, want):
        assert g.slot == w.slot
        assert _same_up_to_bf16_tie(cfg, tp, g.request, kw["max_len"], g.generated,
                                    w.generated), (g.request.rid, g.generated, w.generated)
    assert _counters(eng.metrics) == _counters(jeng.metrics)


def test_launch_full_serves_bf16_and_smoke_float32(monkeypatch):
    """``--full`` builds bf16 params and a bf16 engine, the smoke config
    float32, as the reference's launcher (the full configuration swapped for
    the SMOKE one here, to run on the CPU)."""
    import repro_torch.serve as serve

    params, engines = [], []
    real_init, real_cfg = T.init_params, serve.EngineConfig
    monkeypatch.setattr(configs, "get_arch", configs.get_smoke)
    monkeypatch.setattr(T, "init_params", lambda cfg, gen, dtype, device: params.append(
        dtype) or real_init(cfg, gen, dtype, device))
    monkeypatch.setattr(serve, "EngineConfig", lambda **kw: engines.append(
        kw["dtype"]) or real_cfg(**kw))
    for flag in (["--full"], []):
        launch.main(["--arch", "mamba2-130m", "--device", "cpu", "--requests", "2",
                     "--prompt-len", "4", "--gen", "3", "--verify", *flag])
    assert params == engines == [BF, torch.float32]


def test_full_width_bf16_drift_matches_the_references():
    """At ``mamba2-130m``'s full width and depth (24 layers, random bf16
    weights), a bf16 forward strays from the float32 forward at the same
    weights by rounding amplified through the layers: the reference's own
    by ~0.2 of rms(logits). The port's drift is held to the reference's,
    within 1.5 times (each framework rounds its bf16 steps at other
    places), and its loss within 1e-3 relative of its float32 loss."""
    jcfg = j_configs.get_arch("mamba2-130m")
    cfg = configs.get_arch("mamba2-130m")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (1, 128)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)

    def drift(got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        return np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean())

    j16, _ = JT.forward_train(jcfg, jp, jnp.asarray(tokens), remat=False)
    j32, _ = JT.forward_train(jcfg, jp32, jnp.asarray(tokens), remat=False)
    ref = drift(np.asarray(j16, np.float32), j32)

    def as_float(tree):
        return ({k: as_float(v) for k, v in tree.items()} if isinstance(tree, dict)
                else tree.float())

    batch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    with torch.no_grad():
        t16, _ = T.forward_train(cfg, tp, batch["tokens"])
        t32, _ = T.forward_train(cfg, as_float(tp), batch["tokens"])
        loss16, loss32 = T.loss_fn(cfg, tp, batch), T.loss_fn(cfg, as_float(tp), batch)
    mine = drift(t16.float().numpy(), t32.numpy())
    assert 0.01 < ref and mine <= 1.5 * ref, (mine, ref)
    np.testing.assert_allclose(t32.numpy(), np.asarray(j32), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(float(loss16), float(loss32), rtol=1e-3)
