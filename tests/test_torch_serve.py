"""The port's serving path (``models.layers`` ``attn_prefill``/``mla_prefill``/
``mamba_prefill``, ``transformer.prefill_chunk``, ``dist`` ``make_serve_step``/
``make_prefill_step``, ``repro_torch.serve`` and ``launch.serve``) against
the JAX package, on the CPU.

Weights are the JAX ``T.init_params(..., jnp.float32)`` pytrees, carried
across with ``lm_params_from_numpy``; tokens, encoder outputs, frame
embeddings and request workloads are made with numpy from a seed. The JAX
engine runs on a one-device mesh of automatic axes
(``jax.sharding.Mesh``).

Contracts, with their tolerances (absolute and relative):
- ``_prefill_write_slots`` and ``_prefill_mask`` equal the reference's,
  bit for bit;
- ``prefill_chunk`` chunk by chunk against the reference's: logits and
  every cache leaf 1e-4, and each MoE layer's ``gate_idx`` equal; rows of
  mixed ``n_valid``, 0 included, for dense GQA with bias, a sliding window
  of 6 over 17 tokens (the ring wraps), mamba2, jamba, deepseek (MLA) and
  seamless (the cross layers over ``enc_out``);
- ``prefill_chunk`` against the port's own token-at-a-time decode: 2e-3
  (``tests/test_decode_consistency.py``'s tolerance); ``mamba_prefill``
  and the Mamba2 model's cache against decode, bit for bit;
- a row with ``n_valid = 0`` keeps every cache leaf bit for bit;
- ``plan_chunk`` and ``FCFSScheduler`` equal the reference's;
- the engine at temperature 0 against the JAX ``ServeEngine`` on the same
  requests: equal token streams (a difference is allowed only at a
  near-tie, a top-2 logit gap below ``FLIP_GAP`` in the sequential run)
  and every ``EngineMetrics`` counter and request step equal;
- the engine's own behaviour (slot reuse, EOS, errors, sampling) and the
  ``launch.serve --obs --trace`` stream's schema, series and span trees.
"""
import argparse
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as j_configs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.config import ArchConfig as JArch
from repro.obs import PausableWallClock as JClock, Recorder as JRecorder
from repro.serve import EngineConfig as JEngineConfig, ServeEngine as JServeEngine
from repro.serve import prefill as j_prefill, scheduler as j_sched

from repro_torch.convert import lm_params_from_numpy
from repro_torch.dist import make_prefill_step, make_serve_step
from repro_torch.kernels.block_attn import ops as attn_ops
from repro_torch.launch import serve as launch
from repro_torch.models import ArchConfig, MLAConfig, MoEConfig, SSMConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.obs import ObsStream, build_trees, spans_of
from repro_torch.serve import EngineConfig, Phase, Request, RequestState, ServeEngine
from repro_torch.serve import engine as serve_engine, scheduler as t_sched
from repro_torch.serve.prefill import plan_chunk
from repro_torch.serve.scheduler import FCFSScheduler, stop_reason

TOL = dict(atol=1e-4, rtol=1e-4)
DECODE_TOL = dict(atol=2e-3, rtol=2e-3)
FLIP_GAP = 1e-5                # chip_smoke.py's near-tie gap
_SUB = {"ssm": SSMConfig, "moe": MoEConfig, "mla": MLAConfig}
DENSE = JArch(name="d", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
              vocab=64, qkv_bias=True)
CASES = {
    "dense-gqa-bias": DENSE,
    "window": dataclasses.replace(DENSE, sliding_window=6),
    "mamba2": j_configs.get_smoke("mamba2-130m"),
    "jamba": j_configs.get_smoke("jamba-1.5-large-398b"),
    "deepseek": j_configs.get_smoke("deepseek-v2-lite-16b"),
    "seamless": j_configs.get_smoke("seamless-m4t-large-v2"),
}
MOE = ("jamba", "deepseek")


def _port_cfg(jcfg):
    """The port's ArchConfig with the same fields as the reference's."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for name, cls in _SUB.items():
        if kw[name] is not None:
            kw[name] = cls(**dataclasses.asdict(kw[name]))
    return ArchConfig(**kw)


_PARAMS = {}


def _params(name):
    """(JAX config, port config, JAX params, port params); biases drawn
    non-zero so that the QKV bias path is exercised."""
    if name not in _PARAMS:
        jcfg = CASES[name]
        tree = jax.tree_util.tree_map(
            np.array, JT.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32))
        if jcfg.qkv_bias:
            rng = np.random.default_rng(4)
            for bias in ("bq", "bk", "bv"):
                leaf = tree["blocks"]["slot0"]["mixer"][bias]
                tree["blocks"]["slot0"]["mixer"][bias] = (
                    0.2 * rng.standard_normal(leaf.shape)).astype(np.float32)
        _PARAMS[name] = (jcfg, _port_cfg(jcfg), jax.tree_util.tree_map(jnp.asarray, tree),
                         lm_params_from_numpy(tree, device="cpu"))
    return _PARAMS[name]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


# ------------------------------------------------------------------ masks
@pytest.mark.parametrize("window", [0, 3, 6])
def test_prefill_mask_and_write_slots_match_jax(window):
    """Both helpers at fresh, filling and wrapped positions with mixed
    n_valid: equal to the reference's, bit for bit."""
    pos = np.array([0, 3, 9, 14, 6], np.int32)
    n_valid = np.array([4, 0, 2, 5, 1], np.int32)
    for c, size in ((4, 8), (5, 6), (5, 5)):
        nv = np.minimum(n_valid, c)
        want = JL._prefill_mask(jnp.asarray(pos), jnp.asarray(nv), c, size, window)
        got = L._prefill_mask(torch.from_numpy(pos), torch.from_numpy(nv), c, size, window)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        tok_pos = pos[:, None] + np.arange(c)[None]
        np.testing.assert_array_equal(
            L._prefill_write_slots(torch.from_numpy(tok_pos), torch.from_numpy(nv),
                                   size).numpy(),
            np.asarray(JL._prefill_write_slots(jnp.asarray(tok_pos), jnp.asarray(nv), size)))


# --------------------------------------------------------- prefill_chunk
def _plan(lens, chunk):
    """The chunk schedule of rows with prompt lengths ``lens``: a list of
    (pos (B,), n_valid (B,)) a call, every row to the end of its prompt."""
    lens = np.asarray(lens)
    done = np.zeros_like(lens)
    out = []
    while (done < lens).any():
        nv = np.minimum(chunk, lens - done).astype(np.int32)
        out.append((done.astype(np.int32), nv))
        done = done + nv
    return out


def _enc_out(cfg, b, seed=6):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)


def _routing(monkeypatch):
    """Spies on both routers: (the reference's top-k indices, the port's
    gate_idx), one entry a MoE layer call."""
    j_seen, t_seen = [], []
    real_top_k, real_route = jax.lax.top_k, L.moe_route

    def j_spy(operand, k):
        out = real_top_k(operand, k)
        j_seen.append(np.asarray(out[1]))
        return out

    def t_spy(p, x, cfg):
        out = real_route(p, x, cfg)
        t_seen.append(out[1].numpy())
        return out

    monkeypatch.setattr(jax.lax, "top_k", j_spy)
    monkeypatch.setattr(L, "moe_route", t_spy)
    return j_seen, t_seen


PREFILL = {name: ((5, 11, 0), 4, 16) for name in CASES}
PREFILL["window"] = ((17, 9, 0), 5, 17)           # ring of 6: the chunks wrap it


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_chunk_matches_jax(name, monkeypatch):
    """Chunk by chunk from an empty cache (row 2 has n_valid 0 throughout,
    row 0 once its prompt is done): logits and every cache leaf within
    1e-4 of the reference's; MoE layers route each token as the reference
    does (dispatch groups of one token)."""
    jcfg, cfg, jp, tp = _params(name)
    lens, chunk, max_len = PREFILL[name]
    b = len(lens)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (b, max(lens))).astype(np.int32)
    jcache = JT.init_cache(jcfg, b, max_len, jnp.float32)
    cache = T.init_cache(cfg, b, max_len, device="cpu")
    if cfg.enc_dec:
        enc = _enc_out(cfg, b)
        jcache["enc_out"], cache["enc_out"] = jnp.asarray(enc), torch.from_numpy(enc)
    step = make_prefill_step(cfg)
    j_seen, t_seen = _routing(monkeypatch) if name in MOE else ([], [])
    for pos, nv in _plan(lens, chunk):
        buf = np.zeros((b, chunk), np.int32)
        for r in range(b):
            buf[r, :nv[r]] = tokens[r, pos[r]:pos[r] + nv[r]]
        with jax.disable_jit(name in MOE):  # eager scan: the spy sees values
            jlg, jcache = JT.prefill_chunk(jcfg, jp, jcache, jnp.asarray(buf),
                                           jnp.asarray(pos), jnp.asarray(nv))
        lg, cache = step(tp, cache, torch.from_numpy(buf), torch.from_numpy(pos),
                         torch.from_numpy(nv))
        assert lg.shape == (b, chunk, cfg.vocab) and torch.isfinite(lg).all()
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
        want, got = _leaves(jcache["slots"]), _leaves(cache["slots"])
        assert want.keys() == got.keys()
        for key in want:
            np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    if name in MOE:
        assert len(t_seen) == len(j_seen) == cfg.n_blocks * len(_plan(lens, chunk))
        for j_idx, t_idx in zip(j_seen, t_seen):
            assert t_idx.shape == (b * chunk, 1, cfg.moe.top_k)
            np.testing.assert_array_equal(t_idx.reshape(j_idx.shape), j_idx)


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_chunk_matches_token_decode(name):
    """The port's chunked prefill against its own token-at-a-time slot
    decode of the same rows (``make_serve_step``, inactive rows
    frozen), 2e-3 on the logits of the real tokens; for Mamba2 the cache
    bit for bit."""
    _, cfg, _, tp = _params(name)
    lens, chunk, max_len = PREFILL[name]
    b = len(lens)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (b, max(lens))).astype(np.int32)
    pcache = T.init_cache(cfg, b, max_len, device="cpu")
    dcache = T.init_cache(cfg, b, max_len, device="cpu")
    if cfg.enc_dec:
        pcache["enc_out"] = dcache["enc_out"] = torch.from_numpy(_enc_out(cfg, b))
    serve = make_serve_step(cfg)
    for pos, nv in _plan(lens, chunk):
        buf = np.zeros((b, chunk), np.int32)
        for r in range(b):
            buf[r, :nv[r]] = tokens[r, pos[r]:pos[r] + nv[r]]
        lg, pcache = T.prefill_chunk(cfg, tp, pcache, torch.from_numpy(buf),
                                     torch.from_numpy(pos), torch.from_numpy(nv))
        for j in range(chunk):
            active = torch.from_numpy(j < nv)
            dlg, dcache = serve(tp, dcache, torch.from_numpy(buf[:, j:j + 1]),
                                torch.from_numpy(pos + j), active)
            for r in np.flatnonzero(j < nv):
                np.testing.assert_allclose(lg[r, j].numpy(), dlg[r, 0].numpy(), **DECODE_TOL)
    for key, want in _leaves(dcache["slots"]).items():
        got = _leaves(pcache["slots"])[key]
        if cfg.block_pattern == ("mamba",):
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            np.testing.assert_allclose(got, want, err_msg=key, **DECODE_TOL)


def test_mamba_prefill_is_the_decode_step_bit_for_bit():
    """``mamba_prefill`` over a chunk against ``mamba_decode`` token at a
    time on the same batch: outputs and state equal, torch.equal."""
    _, cfg, _, tp = _params("mamba2")
    p = tp["blocks"]["slot0"]["mixer"]
    p = {k: v[0] for k, v in p.items()}
    b, c = 3, 5
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (b, c, cfg.d_model)).astype(np.float32))
    cache0 = {k: v[0] for k, v in T.init_cache(cfg, b, 8, device="cpu")["slots"]["slot0"].items()}
    cache0 = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(5))
              for k, v in cache0.items()}
    n_valid = torch.tensor([5, 2, 0])
    y, cache = L.mamba_prefill(p, x, cache0, n_valid, cfg)
    dc = cache0
    for t in range(c):
        xt = x[:, t:t + 1].clone()                 # as decode's own (B, 1, d) input
        yt, dc = L.mamba_decode(p, xt, dc, cfg, active=t < n_valid)
        assert torch.equal(y[:, t], yt[:, 0])
    for k in cache:
        assert torch.equal(cache[k], dc[k])
        assert torch.equal(cache[k][2], cache0[k][2])
        assert not torch.equal(cache[k][0], cache0[k][0])


@pytest.mark.parametrize("name", ["jamba", "deepseek", "window"])
def test_prefill_inactive_rows_untouched(name):
    """A row with n_valid = 0 keeps every cache leaf bit for bit; a row with
    tokens changes (the reference's test, and MLA and the window)."""
    _, cfg, _, tp = _params(name)
    b, chunk, max_len = 3, 4, 16
    rng = np.random.default_rng(11)
    cache = T.init_cache(cfg, b, max_len, device="cpu")
    warm = torch.from_numpy(rng.integers(0, cfg.vocab, (b, chunk)))
    _, cache = T.prefill_chunk(cfg, tp, cache, warm, torch.zeros(b, dtype=torch.int32),
                               torch.full((b,), chunk, dtype=torch.int32))
    buf = torch.from_numpy(rng.integers(0, cfg.vocab, (b, chunk)))
    _, cache2 = T.prefill_chunk(cfg, tp, cache, buf, torch.full((b,), chunk, dtype=torch.int32),
                                torch.tensor([chunk, 0, 2], dtype=torch.int32))
    before, after = _leaves(cache["slots"]), _leaves(cache2["slots"])
    for key in before:
        np.testing.assert_array_equal(after[key][:, 1], before[key][:, 1], err_msg=key)
    assert any(not np.array_equal(after[k][:, 0], before[k][:, 0]) for k in before)
    assert any(not np.array_equal(after[k][:, 2], before[k][:, 2]) for k in before)


@pytest.mark.parametrize("name", ["window", "deepseek"])
def test_prefill_chunk_longer_than_the_ring_raises(name):
    _, cfg, _, tp = _params(name)
    cache = T.init_cache(cfg, 1, 6, device="cpu")
    with pytest.raises(ValueError, match="prefill chunk 7 exceeds ring buffer 6"):
        T.prefill_chunk(cfg, tp, cache, torch.zeros(1, 7, dtype=torch.long),
                        torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.int32))


def test_prefill_cross_layers_go_through_block_attention(monkeypatch):
    """Seamless: each chunk calls ``block_attention`` once a cross layer,
    non-causal at Lq = chunk over the encoder's frames; self-attention stays
    in plain torch."""
    _, cfg, _, tp = _params("seamless")
    calls = []
    real = attn_ops.block_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attn_ops, "block_attention", spy)
    cache = T.init_cache(cfg, 2, 16, device="cpu")
    cache["enc_out"] = torch.from_numpy(_enc_out(cfg, 2))
    T.prefill_chunk(cfg, tp, cache, torch.zeros(2, 6, dtype=torch.int64),
                    torch.zeros(2, dtype=torch.int32), torch.tensor([6, 3], dtype=torch.int32))
    f = cfg.frontend_tokens
    assert calls == [(6, f, {"causal": False, "window": 0})] * cfg.n_blocks


# ------------------------------------------------- scheduler and planner
def _states(mod, reqs, progress):
    out = []
    for slot, (r, done, phase) in enumerate(zip(reqs, progress, ("prefill", "decode",
                                                                   "prefill", "prefill"))):
        req = mod.Request(rid=r.rid, prompt=r.prompt, max_tokens=r.max_tokens,
                          arrival_step=r.arrival_step)
        st = mod.RequestState(request=req, slot=slot, prompt_done=done,
                              phase=getattr(mod.Phase, phase.upper()))
        out.append(st)
    return out


def test_plan_chunk_and_scheduler_match_jax():
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, 50, size=(int(n),)), max_tokens=3,
                    arrival_step=int(a))
            for i, (n, a) in enumerate(zip((9, 4, 7, 12, 3, 5), (0, 0, 2, 2, 3, 7)))]
    progress = (0, 4, 6, 12)
    for batch, chunk in ((4, 4), (6, 5), (4, 16)):
        got = plan_chunk(_states(t_sched, reqs[:4], progress), batch, chunk)
        want = j_prefill.plan_chunk(_states(j_sched, reqs[:4], progress), batch, chunk)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    mine, ref = FCFSScheduler(), j_sched.FCFSScheduler()
    for r in reqs:
        mine.submit(r)
        ref.submit(j_sched.Request(rid=r.rid, prompt=r.prompt, max_tokens=r.max_tokens,
                                   arrival_step=r.arrival_step))
    free = [0, 1, 2]
    for step in range(9):
        a = mine.admit(free, step, float(step))
        b = ref.admit(free, step, float(step))
        assert [(s.request.rid, s.slot) for s in a] == [(s.request.rid, s.slot) for s in b]
        assert mine.eligible_wall == ref.eligible_wall and len(mine) == len(ref)
        assert mine.next_arrival() == ref.next_arrival()
        free = [s.slot for s in a][:1] + ([3] if step == 4 else [])
    for gen in ([1, 2], [1, 2, 7], [5, 5, 5]):
        req = Request(rid=0, prompt=[1], max_tokens=3, eos_id=7)
        assert stop_reason(req, gen) == j_sched.stop_reason(
            j_sched.Request(rid=0, prompt=[1], max_tokens=3, eos_id=7), gen)


# --------------------------------------------------------------- engine
def _workload(cfg, **over):
    args = dict(seed=0, requests=10, prompt_len=8, gen=8, mixed=True, arrival=0.5,
                eos_id=-1, temperature=0.0)
    args.update(over)
    return launch.build_requests(argparse.Namespace(**args), cfg)


def _j_requests(reqs):
    return [j_sched.Request(rid=r.rid, prompt=r.prompt, max_tokens=r.max_tokens,
                            eos_id=r.eos_id, temperature=r.temperature,
                            arrival_step=r.arrival_step, embeds=r.embeds) for r in reqs]


def _counters(metrics):
    return {**{k: v for k, v in metrics.summary().items()
               if not k.endswith("_s") and k != "tok_s" and k != "total_tok_s"},
            "requests": {rid: (m.prompt_len, m.n_generated, m.arrival_step, m.admit_step,
                               m.finish_step) for rid, m in metrics.requests.items()}}


def _same_up_to_near_tie(cfg, params, req, max_len, got, want):
    """Equal streams, or equal up to a first difference where the
    sequential run's top-2 logit gap is below FLIP_GAP."""
    if got == want:
        return True
    gaps = []
    seq = launch.sequential_reference(cfg, params, req, max_len, "cpu", gaps)
    first = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    return seq[:first] == got[:first] and gaps[first] < FLIP_GAP


ENGINE = {name: dict(max_concurrency=4, max_len=16, chunk=4) for name in CASES}
ENGINE["window"] = dict(max_concurrency=3, max_len=24, chunk=5)


@pytest.mark.parametrize("name", list(CASES))
def test_engine_matches_jax_engine(name):
    """The same requests (build_requests from one seed, Poisson arrivals,
    mixed lengths) through the JAX engine and the port's at temperature 0:
    equal token streams and equal counters and request steps."""
    jcfg, cfg, jp, tp = _params(name)
    kw = ENGINE[name]
    over = dict(prompt_len=16, gen=6) if name == "window" else {}
    reqs = _workload(cfg, **over)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jeng = JServeEngine(jcfg, jp, JEngineConfig(**kw), mesh=mesh)
    want = jeng.run(_j_requests(reqs))
    eng = ServeEngine(cfg, tp, EngineConfig(**kw), device="cpu")
    got = eng.run(reqs)
    assert [st.request.rid for st in got] == [st.request.rid for st in want]
    for g, w in zip(got, want):
        assert g.stop == w.stop and g.slot == w.slot
        assert _same_up_to_near_tie(cfg, tp, g.request, kw["max_len"], g.generated,
                                    w.generated), (g.request.rid, g.generated, w.generated)
    assert _counters(eng.metrics) == _counters(jeng.metrics)
    assert eng.metrics.prefill_chunks > 0 and eng.metrics.decode_steps > 0
    assert eng.metrics.piggyback_tokens > 0


def test_engine_matches_sequential_decode_with_slot_reuse():
    """Mamba2 on one and two slots: every request reuses a slot a finished
    one held, prefills by gang chunks and by piggybacking, and its tokens
    are the sequential decode's from a zero state (recurrent rows are
    zeroed at admission)."""
    _, cfg, _, tp = _params("mamba2")
    reqs = _workload(cfg, requests=6, arrival=0.7)
    for slots, rows in ((1, 0), (2, 9)):
        eng = ServeEngine(cfg, tp, EngineConfig(max_concurrency=slots, max_len=16, chunk=4,
                                                min_prefill_rows=rows), device="cpu")
        out = eng.run(reqs)
        assert len({st.slot for st in out}) == slots
        for st in out:
            assert st.generated == launch.sequential_reference(cfg, tp, st.request, 16, "cpu")
        if rows:
            assert eng.metrics.piggyback_tokens > 0


def test_zero_fresh_state_zeroes_only_recurrent_rows():
    _, cfg, _, _ = _params("jamba")
    cache = T.init_cache(cfg, 3, 8, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for slot in cache["slots"].values():
        for k in slot:
            slot[k] = torch.randn(slot[k].shape, generator=gen)
    out = serve_engine._zero_fresh_state(cache, torch.tensor([False, True, False]))
    for name, slot in out["slots"].items():
        for k, leaf in slot.items():
            old = cache["slots"][name][k]
            assert torch.equal(leaf[:, [0, 2]], old[:, [0, 2]])
            assert torch.equal(leaf[:, 1], torch.zeros_like(leaf[:, 1])) == (k in ("conv",
                                                                                 "ssm"))


def test_eos_retires_and_frees_the_slot():
    """A request whose stream reaches its eos_id stops there ("eos") and
    its slot takes the next request in the same engine run."""
    _, cfg, _, tp = _params("dense-gqa-bias")
    reqs = _workload(cfg, requests=3, arrival=0.0)
    kw = dict(max_concurrency=1, max_len=16, chunk=4)
    free_run = ServeEngine(cfg, tp, EngineConfig(**kw), device="cpu").run(reqs)
    eos = free_run[0].generated[1]
    reqs[0] = dataclasses.replace(reqs[0], eos_id=eos)
    eng = ServeEngine(cfg, tp, EngineConfig(**kw), device="cpu")
    out = eng.run(reqs)
    first = free_run[0].generated.index(eos)
    assert out[0].stop == "eos" and out[0].generated == free_run[0].generated[:first + 1]
    assert out[0].phase is Phase.FINISHED and out[1].stop == "max_tokens"
    m = eng.metrics.requests
    assert m[1].admit_step == m[0].finish_step and out[1].slot == out[0].slot == 0
    assert [st.generated for st in out[1:]] == [st.generated for st in free_run[1:]]


def test_submit_and_config_errors():
    _, cfg, _, tp = _params("dense-gqa-bias")
    eng = ServeEngine(cfg, tp, EngineConfig(max_concurrency=2, max_len=8), device="cpu")
    eng.submit(Request(rid=0, prompt=[1, 2], max_tokens=2))
    with pytest.raises(ValueError, match="duplicate request id 0"):
        eng.submit(Request(rid=0, prompt=[1, 2], max_tokens=2))
    with pytest.raises(ValueError, match="exceeds max_len 8"):
        eng.submit(Request(rid=1, prompt=[1] * 6, max_tokens=3))
    with pytest.raises(ValueError, match="empty prompt"):
        Request(rid=2, prompt=[])
    with pytest.raises(ValueError, match="max_tokens must be >= 1"):
        Request(rid=2, prompt=[1], max_tokens=0)
    _, scfg, _, stp = _params("seamless")
    enc = ServeEngine(scfg, stp, EngineConfig(max_concurrency=1, max_len=8), device="cpu")
    with pytest.raises(ValueError, match="enc-dec arch needs embeds"):
        enc.submit(Request(rid=3, prompt=[1], max_tokens=1,
                           embeds=np.zeros((2, 2), np.float32)))
    assert EngineConfig(dtype=torch.bfloat16).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        EngineConfig(dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A11"):
        launch.main(["--arch", "mamba2-130m", "--device", "cpu", "--mesh-model", "2"])
    with pytest.raises(SystemExit, match="--trace requires --obs"):
        launch.main(["--arch", "mamba2-130m", "--device", "cpu", "--trace"])
    stuck = ServeEngine(cfg, tp, EngineConfig(max_concurrency=1, max_len=8), device="cpu")
    stuck.submit(Request(rid=0, prompt=[1], max_tokens=1))
    stuck._work_budget = -40                      # the guard: 2 * budget + 64 steps
    stuck._slots[0] = RequestState(request=Request(rid=9, prompt=[1]), slot=0,
                                   phase=Phase.DECODE)
    stuck._emit_token = lambda *a, **k: None      # a slot that never retires
    with pytest.raises(RuntimeError, match="engine stalled"):
        stuck.run()


def test_sampling_is_seeded_and_keeps_greedy_rows():
    """Half the requests at temperature 0.8: two runs with one seed give the
    same streams, another seed other sampled streams; the greedy requests'
    streams are the all-greedy run's."""
    _, cfg, _, tp = _params("jamba")
    reqs = _workload(cfg, requests=8)
    mixed = [dataclasses.replace(r, temperature=0.8 if r.rid % 2 else 0.0) for r in reqs]
    kw = dict(max_concurrency=4, max_len=16, chunk=4)
    greedy = ServeEngine(cfg, tp, EngineConfig(**kw), device="cpu").run(reqs)
    runs = [ServeEngine(cfg, tp, EngineConfig(seed=s, **kw), device="cpu").run(mixed)
            for s in (1, 1, 2)]
    assert [st.generated for st in runs[0]] == [st.generated for st in runs[1]]
    assert [st.generated for st in runs[0]] != [st.generated for st in runs[2]]
    for run in runs:
        for st, g in zip(run, greedy):
            if st.request.temperature == 0:
                assert st.generated == g.generated


def test_reset_keeps_the_cache_and_serves_again():
    _, cfg, _, tp = _params("deepseek")
    reqs = _workload(cfg, requests=5)
    eng = ServeEngine(cfg, tp, EngineConfig(max_concurrency=2, max_len=16, chunk=4),
                      device="cpu")
    first = [st.generated for st in eng.run(reqs)]
    cache = eng.cache["slots"]["slot0"]["c_kv"]
    eng.reset()
    assert eng.metrics.engine_steps == 0 and not eng.pending()
    assert eng.cache["slots"]["slot0"]["c_kv"] is cache
    assert [st.generated for st in eng.run(_workload(cfg, requests=5))] == first


# ------------------------------------------------------------------ obs
def test_launch_obs_trace_matches_jax_stream(tmp_path, capsys):
    """``launch.serve --obs --trace --verify`` on the CPU: the stream loads in
    both packages' ``ObsStream``; its schema, series names and every
    request's span tree (ids, parents, kinds, attributes) are those of the
    JAX engine's traced run on the same workload."""
    path = os.path.join(tmp_path, "serve.jsonl")
    argv = ["--arch", "mamba2-130m", "--device", "cpu", "--requests", "6",
            "--max-concurrency", "2", "--prompt-len", "8", "--gen", "6", "--mixed",
            "--arrival", "0.5", "--chunk", "4"]
    launch.main(argv + ["--verify", "--obs", path, "--trace"])
    out = capsys.readouterr().out
    assert "verify: all 6 requests identical" in out and "obs: wrote" in out
    stream = ObsStream.load(path)
    from repro.obs import ObsStream as JObsStream

    assert JObsStream.load(path).header["schema"] == stream.header["schema"]
    jcfg = j_configs.get_smoke("mamba2-130m")
    args = argparse.Namespace(seed=0, requests=6, prompt_len=8, gen=6, mixed=True,
                              arrival=0.5, eos_id=-1, temperature=0.0)
    jrec = JRecorder(clock=JClock(), trace=True)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    JServeEngine(jcfg, JT.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32),
                 JEngineConfig(max_concurrency=2, max_len=14, chunk=4), mesh=mesh,
                 obs=jrec).run(_j_requests(launch.build_requests(args, _port_cfg(jcfg))))
    want = jrec.to_stream()
    for key in ("schema", "version", "clock"):
        assert stream.header[key] == want.header[key]
    assert stream.header["workload"] == "serve" and stream.header["arch"] == jcfg.name

    def series(s):
        return {(ev["kind"], ev.get("name")) for ev in s.events if ev["kind"] != "tspan"}

    def shape(s):
        return {t: [(sp.span, sp.parent, sp.kind, sp.attrs) for sp in tree.spans.values()]
                for t, tree in build_trees(spans_of(s)).items()}

    assert series(stream) == series(want)
    for part in ("counters", "gauges", "spans", "hists"):
        assert set(stream.summary[part]) == set(want.summary[part]), part
    assert stream.summary["counters"] == want.summary["counters"]
    assert shape(stream) == shape(want) and len(shape(stream)) == 6
