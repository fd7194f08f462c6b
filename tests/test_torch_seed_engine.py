"""The port's seed engine (``DFedRWConfig(engine="reference")``) and its
pytree codec against the JAX package's, and against the port's own flat
engine, on the CPU. The setup is tests/test_flat_engine.py's: 10 devices,
complete graph, the 2FNN-64, M = 4, K = 3, B = 32, 3 rounds.

Contracts:
- port seed vs JAX seed, from the reference's initial params and plans
  (the planners are line-for-line numpy copies on one seed):
  - bits 32: device leaves within rtol 1e-5 / atol 1e-6, loss and
    gamma_hat within rtol 1e-5 (the port's flat-engine contract: fp32 sums
    in another order); Eq. 18 bits exactly equal;
  - bits 8, given the JAX seed engine's own uniforms (drawn in the test
    from the key its ``run_round`` receives): device leaves within
    ``SEED_BITS8_REL * scale + 1e-4``. The uniforms are then identical but
    the norms are summed in another order, so a near-tie rounding decision
    can move an element by one grid cell; over 5 config seeds the largest
    difference measured was ``SEED_BITS8_MEASURED`` of the leaves' scale;
  - chain mode and stragglers (truncate, partial) at both widths.
- port seed vs port flat: bits 32 bit-identical device parameters (as the
  reference holds its own pair), bits 8 within ``0.05 * scale + 1e-4`` (the
  engines draw different uniforms); Eq. 18 bits exactly equal.
- the codec: ``quantize_pytree`` given the reference's uniforms, indices
  within one grid cell of the reference's and equal wherever (s, norm) are
  the reference's bits; s and norm within 4 ulps (tests/test_torch_quantize.py);
  ``pytree_wire_bits`` and ``QuantConfig.interval`` equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import DFedRW as JDFedRW, DFedRWConfig as JConfig
from repro.core import QuantConfig as JQuant, StragglerModel as JStraggler
from repro.core import make_topology as j_make_topology
from repro.core.heterogeneity import partition_similarity as j_partition
from repro.core.quantization import dequantize_pytree as j_dequantize_pytree
from repro.core.quantization import pytree_wire_bits as j_pytree_wire_bits
from repro.core.quantization import quantize as j_quantize
from repro.core.quantization import quantize_pytree as j_quantize_pytree
from repro.data import FederatedDataset as JData
from repro.data import synthetic_image_classification as j_synth
from repro.models import make_fnn as j_make_fnn

from repro_torch.convert import params_from_numpy
from repro_torch.core import DFedRW, DFedRWConfig, QuantConfig, StragglerModel, make_topology
from repro_torch.core.flatten import tree_leaves, unflatten_tree
from repro_torch.core.heterogeneity import partition_similarity
from repro_torch.core.quantization import (
    dequantize,
    dequantize_pytree,
    pytree_wire_bits,
    quantize_pytree,
    quantize_rows,
)
from repro_torch.data import FederatedDataset, synthetic_image_classification
from repro_torch.models import make_fnn
from _torch_threads import torch_threads  # noqa: F401

N, M, K, B = 10, 4, 3, 32
# Port seed vs JAX seed at bits 8: the bound on max |diff| / max |leaf|,
# and the largest ratio measured over config seeds 0..4 in every case below
# (3 rounds each; partial stragglers, seed 3, round 3).
SEED_BITS8_REL = 0.009
SEED_BITS8_MEASURED = 0.00817
CASES = {
    "plain": {},
    "chain": {"chain_mode": True},
    "truncate": {"straggler": dict(h_percent=50, mode="truncate"), "k_walk": 4},
    "partial": {"straggler": dict(h_percent=50, mode="partial"), "k_walk": 4},
}


@pytest.fixture(scope="module")
def data():
    x, y = j_synth(n_samples=2000, seed=0, noise=1.0)
    jdata = JData.from_partition(x, y, j_partition(y, N, 50, np.random.default_rng(0)))
    xt, yt = synthetic_image_classification(n_samples=2000, seed=0, noise=1.0)
    tdata = FederatedDataset.from_partition(
        xt, yt, partition_similarity(yt, N, 50, np.random.default_rng(0)))
    return jdata, tdata


def _configs(case, bits, seed=0):
    kw = dict(m_chains=M, k_walk=K, batch_size=B, seed=seed)
    kw.update({k: v for k, v in CASES[case].items() if k != "straggler"})
    strag = CASES[case].get("straggler")
    jcfg = JConfig(quant=JQuant(bits=bits), engine="reference", **kw,
                   **({"straggler": JStraggler(**strag)} if strag else {}))
    tcfg = DFedRWConfig(quant=QuantConfig(bits=bits), engine="reference", **kw,
                        **({"straggler": StragglerModel(**strag)} if strag else {}))
    return jcfg, tcfg


def _init(tr, jparams):
    return tr.state_from_params(params_from_numpy(
        [(np.asarray(w), np.asarray(b)) for w, b in jparams], device="cpu"))


def _jax_uniforms(key, leaf_shapes, m, k, rows):
    """The uniforms the JAX seed engine draws from the key its round
    function receives (dfedrw.py:448/459 for the K hops, :500/:505 for the
    aggregation), nested as the port's ``uniforms`` argument."""
    qkey, hop = key, []
    for _ in range(k):
        qkey, sub = jax.random.split(qkey)
        keys = jax.random.split(sub, len(leaf_shapes))
        hop.append([torch.from_numpy(np.array(
            jax.random.uniform(kk, (m, *shape), dtype=jnp.float32)))
            for kk, shape in zip(keys, leaf_shapes)])
    qkey, sub = jax.random.split(qkey)
    keys = jax.random.split(sub, len(leaf_shapes))
    agg = []
    for kk, shape in zip(keys, leaf_shapes):
        row_keys = jax.random.split(kk, rows)
        draw = jax.vmap(lambda r, shape=shape: jax.random.uniform(r, shape, dtype=jnp.float32))
        agg.append(torch.from_numpy(np.array(draw(row_keys))))
    return {"hop": hop, "agg": agg}


def _jax_leaves(state):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(state.device_params)]


def _run_vs_jax(data, case, bits, seed=0, rounds=3):
    """Rounds of the JAX and the port seed engines from the same init and
    plans; yields (JAX leaves, port leaves, JAX metrics, port metrics)."""
    jdata, tdata = data
    jcfg, tcfg = _configs(case, bits, seed)
    jmodel = j_make_fnn((64,))
    jr = JDFedRW(jmodel, jdata, j_make_topology("complete", N), jcfg)
    tr = DFedRW(make_fnn((64,)), tdata, make_topology("complete", N), tcfg, device="cpu")
    key = jax.random.PRNGKey(0)
    js = jr.init_state(key)
    ts = _init(tr, jmodel.init(key))
    shapes = tr.flat_spec.shapes
    out = []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        jplan, jbidx = jr.plan_walks(js)
        jagg = jr.plan_aggregation(jplan)
        tplan, tbidx = tr.plan_walks(ts)
        tagg = tr.plan_aggregation(tplan)
        np.testing.assert_array_equal(jplan.devices, tplan.devices)
        np.testing.assert_array_equal(jbidx, tbidx)
        for a, b in zip(jagg, tagg):
            np.testing.assert_array_equal(a, b)
        js, jm = jr.execute_round(js, jplan, jbidx, jagg, sub)
        uniforms = (_jax_uniforms(sub, shapes, tcfg.m_chains, tcfg.k_walk, tagg[1].size)
                    if bits < 32 else None)
        ts, tm = tr.execute_round(ts, tplan, tbidx, tagg, None, uniforms=uniforms)
        assert jm.comm_bits_round == tm.comm_bits_round
        assert jm.comm_bits_busiest_round == tm.comm_bits_busiest_round
        np.testing.assert_array_equal(js.updated, ts.updated)
        if tcfg.chain_mode:
            np.testing.assert_array_equal(js.chain_starts, ts.chain_starts)
        out.append((_jax_leaves(js), [t.numpy() for t in tree_leaves(ts.device_params)],
                    jm, tm))
    return out


def _rel_diff(jl, tl):
    scale = max(float(np.abs(a).max()) for a in jl)
    return max(float(np.abs(a - b).max()) for a, b in zip(jl, tl)) / scale, scale


@pytest.mark.parametrize("case", sorted(CASES))
def test_seed_matches_jax_seed_bits32(data, case):
    for jl, tl, jm, tm in _run_vs_jax(data, case, 32):
        for a, b in zip(jl, tl):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tm.train_loss, jm.train_loss, rtol=1e-5)
        np.testing.assert_allclose(tm.gamma_hat, jm.gamma_hat, rtol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_seed_matches_jax_seed_bits8(data, case):
    for jl, tl, jm, tm in _run_vs_jax(data, case, 8):
        rel, scale = _rel_diff(jl, tl)
        assert rel * scale < SEED_BITS8_REL * scale + 1e-4, (rel, scale)
        np.testing.assert_allclose(tm.train_loss, jm.train_loss, atol=5e-3)
        np.testing.assert_allclose(tm.gamma_hat, jm.gamma_hat, atol=5e-3)


def test_seed_engine_seams_match_jax(data):
    """``execute_round``'s seams on the seed engine, as on the JAX one: a
    bits-32 config run at ``bits=8`` for one round, Eq. 18 charged for
    ``account_plan`` (every chain's last hop dropped), and an attached
    recorder; the same bits, the same obs lines, the width in
    ``programs_run``, and leaves within the bits-8 bound."""
    from repro import obs as jobs
    from repro_torch import obs as tobs

    jdata, tdata = data
    jcfg, tcfg = _configs("plain", 32)
    jmodel = j_make_fnn((64,))
    jr = JDFedRW(jmodel, jdata, j_make_topology("complete", N), jcfg)
    tr = DFedRW(make_fnn((64,)), tdata, make_topology("complete", N), tcfg, device="cpu")
    jrec = jobs.Recorder(clock=jobs.VirtualClock(lambda: 0.0))
    trec = tobs.Recorder(clock=tobs.VirtualClock(lambda: 0.0))
    jr.attach_obs(jrec)
    tr.attach_obs(trec)
    key = jax.random.PRNGKey(0)
    js, ts = jr.init_state(key), _init(tr, jmodel.init(key))
    for bits in (8, None):
        key, sub = jax.random.split(key)
        jplan, jbidx = jr.plan_walks(js)
        jagg = jr.plan_aggregation(jplan)
        tplan, tbidx = tr.plan_walks(ts)
        tagg = tr.plan_aggregation(tplan)
        mask = jplan.mask.copy()
        mask[:, -1] = False
        jacct = dataclasses.replace(jplan, mask=mask, k_m=mask.sum(1).astype(np.int32))
        tacct = dataclasses.replace(tplan, mask=mask, k_m=mask.sum(1).astype(np.int32))
        js, jm = jr.execute_round(js, jplan, jbidx, jagg, sub, account_plan=jacct, bits=bits)
        uniforms = (_jax_uniforms(sub, tr.flat_spec.shapes, M, K, tagg[1].size)
                    if bits == 8 else None)
        ts, tm = tr.execute_round(ts, tplan, tbidx, tagg, None, account_plan=tacct,
                                  bits=bits, uniforms=uniforms)
        assert jm.comm_bits_round == tm.comm_bits_round
        assert jm.comm_bits_busiest_round == tm.comm_bits_busiest_round
        rel, scale = _rel_diff(_jax_leaves(js), [t.numpy() for t in tree_leaves(ts.device_params)])
        assert rel * scale < SEED_BITS8_REL * scale + 1e-4, (bits, rel, scale)
    assert tr.programs_run == jr.programs_run == (8, 32)
    assert trec.to_stream().to_lines() == jrec.to_stream().to_lines()


def _run_vs_flat(data, case, bits, rounds=3):
    """Rounds of the port's seed and flat engines from one init, on their
    own (equal) plans; yields (seed leaves, flat leaves, seed m, flat m)."""
    _, tdata = data
    _, scfg = _configs(case, bits)
    fcfg = dataclasses.replace(scfg, engine="flat")
    topo = make_topology("complete", N)
    sr = DFedRW(make_fnn((64,)), tdata, topo, scfg, device="cpu")
    fr = DFedRW(make_fnn((64,)), tdata, topo, fcfg, device="cpu")
    params = make_fnn((64,)).init(torch.Generator().manual_seed(0), "cpu")
    ss, fs = sr.state_from_params(params), fr.state_from_params(params)
    gs, gf = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    out = []
    for _ in range(rounds):
        ss, ms = sr.run_round(ss, gs)
        fs, mf = fr.run_round(fs, gf)
        assert ms.comm_bits_round == mf.comm_bits_round
        assert ms.comm_bits_busiest_round == mf.comm_bits_busiest_round
        np.testing.assert_array_equal(ss.updated, fs.updated)
        out.append((tree_leaves(sr.params_pytree(ss)), tree_leaves(fr.params_pytree(fs)),
                    ms, mf))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_seed_matches_flat_bits32_bit_exact(data, case):
    for sl, fl, ms, mf in _run_vs_flat(data, case, 32):
        for a, b in zip(sl, fl):
            assert torch.equal(a, b)
        np.testing.assert_allclose(ms.train_loss, mf.train_loss, rtol=1e-5)
        np.testing.assert_allclose(ms.gamma_hat, mf.gamma_hat, rtol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_seed_matches_flat_bits8(data, case):
    for sl, fl, ms, mf in _run_vs_flat(data, case, 8):
        scale = max(float(a.abs().max()) for a in sl)
        diff = max(float((a - b).abs().max()) for a, b in zip(sl, fl))
        assert diff < 0.05 * scale + 1e-4, (diff, scale)
        np.testing.assert_allclose(ms.train_loss, mf.train_loss, atol=5e-3)


def test_seed_engine_tree_state_and_evaluate(data):
    """The seed engine keeps the model's tree stacked (n, ...), the flat one
    the (n, d_pad) matrix; ``params_pytree`` and ``evaluate`` agree."""
    _, tdata = data
    topo = make_topology("complete", N)
    params = make_fnn((64,)).init(torch.Generator().manual_seed(0), "cpu")
    runners = {e: DFedRW(make_fnn((64,)), tdata, topo,
                         DFedRWConfig(m_chains=M, k_walk=K, batch_size=B, engine=e),
                         device="cpu") for e in ("reference", "flat")}
    states = {e: r.state_from_params(params) for e, r in runners.items()}
    assert isinstance(states["reference"].device_params, list)
    assert states["flat"].device_params.shape == (N, runners["flat"].flat_spec.d_pad)
    for leaf, p in zip(tree_leaves(states["reference"].device_params), tree_leaves(params)):
        assert leaf.shape == (N, *p.shape)
    for e, r in runners.items():
        states[e], _ = r.run_round(states[e], torch.Generator().manual_seed(0))
    xt, yt = synthetic_image_classification(n_samples=256, seed=1, noise=1.0)
    ev = {e: r.evaluate(states[e], xt, yt) for e, r in runners.items()}
    np.testing.assert_allclose(ev["reference"]["loss"], ev["flat"]["loss"], rtol=1e-5)
    assert ev["reference"]["accuracy"] == ev["flat"]["accuracy"]


def test_seed_engine_draws_its_own_uniforms(data):
    """Without uniforms a quantized round draws them from the generator:
    the same seed gives the same round, another seed another; a flat
    engine's qseeds and a seed engine's uniforms are refused crosswise."""
    _, tdata = data
    topo = make_topology("complete", N)
    params = make_fnn((64,)).init(torch.Generator().manual_seed(0), "cpu")
    cfg = DFedRWConfig(m_chains=M, k_walk=K, batch_size=B, engine="reference",
                       quant=QuantConfig(bits=8))

    def one(seed):
        r = DFedRW(make_fnn((64,)), tdata, topo, cfg, device="cpu")
        s, m = r.run_round(r.state_from_params(params), torch.Generator().manual_seed(seed))
        return tree_leaves(s.device_params), m

    a, ma = one(1)
    b, _ = one(1)
    c, _ = one(2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    assert np.isfinite(ma.train_loss)
    r = DFedRW(make_fnn((64,)), tdata, topo, cfg, device="cpu")
    s = r.state_from_params(params)
    plan, bidx = r.plan_walks(s)
    agg = r.plan_aggregation(plan)
    with pytest.raises(ValueError, match="uniforms"):
        r.execute_round(s, plan, bidx, agg, None, qseeds=np.zeros((K + 1, 2)))
    with pytest.raises(ValueError, match="generator or uniforms"):
        r.execute_round(s, plan, bidx, agg, None)
    flat = DFedRW(make_fnn((64,)), tdata, topo, dataclasses.replace(cfg, engine="flat"),
                  device="cpu")
    with pytest.raises(ValueError, match="qseeds"):
        flat.execute_round(flat.state_from_params(params), plan, bidx, agg, None,
                           uniforms={"hop": [], "agg": []})
    with pytest.raises(ValueError, match="unknown engine"):
        DFedRW(make_fnn((64,)), tdata, topo, dataclasses.replace(cfg, engine="fused"),
               device="cpu")


# ------------------------------------------------------------------ codec


def _ulps(a, b):
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


def _tree(seed):
    """A dict tree (sorted-key order differs from insertion order) with a
    zero leaf, as numpy arrays."""
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(33, 17)) * 0.05).astype(np.float32),
            "b": np.zeros(17, np.float32),
            "a": [(rng.normal(size=(5, 7))).astype(np.float32),
                  (rng.normal(size=(130,)) * 3).astype(np.float32)]}


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("s", [None, 0.05])
def test_quantize_pytree_matches_reference(bits, s):
    tree = _tree(bits)
    key = jax.random.PRNGKey(bits)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    jq = j_quantize_pytree(jtree, JQuant(bits=bits, s=s), key)
    jleaves = jax.tree_util.tree_leaves(jtree)
    keys = jax.random.split(key, len(jleaves))
    u = [torch.from_numpy(np.array(jax.random.uniform(kk, leaf.shape, dtype=jnp.float32)))
         for kk, leaf in zip(keys, jleaves)]
    ttree = {k: ([torch.from_numpy(a) for a in v] if isinstance(v, list)
                 else torch.from_numpy(v)) for k, v in tree.items()}
    tq = quantize_pytree(ttree, QuantConfig(bits=bits, s=s), uniforms=u)
    jqs = jax.tree_util.tree_leaves(jq, is_leaf=lambda x: hasattr(x, "indices"))
    tqs = tree_leaves(tq)
    assert len(jqs) == len(tqs) == 4
    for jl, tl in zip(jqs, tqs):
        assert _ulps(tl.norm.item(), jl.norm).max() <= 4
        assert _ulps(tl.s.item(), jl.s).max() <= 4
        idx, jidx = tl.indices.numpy(), np.asarray(jl.indices)
        if tl.norm.item() == float(jl.norm) and tl.s.item() == float(jl.s):
            np.testing.assert_array_equal(idx, jidx)
        else:
            assert np.abs(idx - jidx).max() <= 1
    jdeq = jax.tree_util.tree_leaves(j_dequantize_pytree(jq))
    tdeq = dequantize_pytree(tq)
    assert isinstance(tdeq, dict) and isinstance(tdeq["a"], list)
    for jd, td, tl in zip(jdeq, tree_leaves(tdeq), tqs):
        assert td.shape == jd.shape and td.dtype == torch.float32
        cell = float(tl.s) * float(tl.norm)
        assert float(np.abs(td.numpy() - np.asarray(jd)).max()) <= cell * (1 + 1e-5)


def test_quantize_pytree_draws_from_generator():
    tree = {k: torch.from_numpy(v) for k, v in _tree(0).items() if k != "a"}
    cfg = QuantConfig(bits=8)
    a = quantize_pytree(tree, cfg, generator=torch.Generator().manual_seed(3))
    b = quantize_pytree(tree, cfg, generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(x.indices, y.indices) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    with pytest.raises(ValueError, match="uniforms or a generator"):
        quantize_pytree(tree, cfg)


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_rows_matches_vmapped_reference(bits):
    """Each row its own wire tensor, as the reference's vmapped quantize;
    a zero row keeps norm 0 and s 1."""
    rng = np.random.default_rng(bits)
    w = (rng.normal(size=(6, 9, 5)) * 0.1).astype(np.float32)
    w[2] = 0.0
    keys = jax.random.split(jax.random.PRNGKey(bits), w.shape[0])
    cfg = JQuant(bits=bits)
    jq = jax.vmap(lambda d, kk: j_quantize(d, cfg, kk))(jnp.asarray(w), keys)
    u = np.array(jax.vmap(lambda kk: jax.random.uniform(kk, w.shape[1:], dtype=jnp.float32))(
        keys))
    tq = quantize_rows(torch.from_numpy(w), QuantConfig(bits=bits), torch.from_numpy(u))
    assert tq.s.shape == tq.norm.shape == (6, 1, 1)
    assert _ulps(tq.norm.numpy().reshape(-1), np.asarray(jq.norm)).max() <= 4
    assert _ulps(tq.s.numpy().reshape(-1), np.asarray(jq.s)).max() <= 4
    assert float(tq.norm[2]) == 0.0 and float(tq.s[2]) == 1.0
    assert np.abs(tq.indices.numpy() - np.asarray(jq.indices)).max() <= 1
    deq = dequantize(tq)
    assert deq.shape == w.shape


@pytest.mark.parametrize("bits", [2, 8, 32])
def test_pytree_wire_bits_and_interval(bits):
    tree = _tree(0)
    ttree = {k: ([torch.from_numpy(a) for a in v] if isinstance(v, list)
                 else torch.from_numpy(v)) for k, v in tree.items()}
    assert pytree_wire_bits(ttree, bits) == j_pytree_wire_bits(
        jax.tree_util.tree_map(jnp.asarray, tree), bits)
    for s in (None, 0.05):
        assert QuantConfig(bits=bits, s=s).interval == JQuant(bits=bits, s=s).interval


def test_flat_and_tree_leaves_agree(data):
    """``params_pytree`` of the flat engine unflattens in the seed engine's
    leaf order (the order the uniforms follow)."""
    _, tdata = data
    r = DFedRW(make_fnn((64,)), tdata, make_topology("complete", N),
               DFedRWConfig(m_chains=M, k_walk=K, batch_size=B), device="cpu")
    s = r.state_from_params(make_fnn((64,)).init(torch.Generator().manual_seed(0), "cpu"))
    shapes = [tuple(leaf.shape[1:]) for leaf in tree_leaves(
        unflatten_tree(s.device_params, r.flat_spec))]
    assert shapes == [tuple(x) for x in r.flat_spec.shapes]
