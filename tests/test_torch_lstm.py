"""The LSTM chain-mode slice of the port (§VI-F) against the JAX package on
the CPU: ``make_lstm_lm``, its flat layout, ``synthetic_token_stream`` and
``DFedRW(chain_mode=True)`` on the same inputs.

Contracts:
- model: ``predict``, ``loss_fn`` and every leaf's gradient within rtol
  1e-5 / atol 1e-6 at vocab 200, embed 32, hidden 64 (fp32 products and
  transcendental functions in another library);
- flat spec: leaf order, shapes, d and d_pad equal the JAX
  ``make_flat_spec``'s (dicts in sorted-key order), at that width and at
  the published one (vocab 50,000: d = 20,169,552);
- ``synthetic_token_stream``: array-equal;
- chain-mode engine, 3 rounds: chain starts, walk plans, batches,
  aggregation plans and Eq. 18 bits exactly equal; at bits=32 the device
  matrix within rtol 1e-5 / atol 1e-6 and the loss within rtol 1e-5; at
  bits=8 with the JAX engine's seed words within 0.05 * scale + 1e-4, the
  bound of tests/test_flat_engine.py.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.core import DFedRW as JDFedRW, DFedRWConfig as JConfig
from repro.core import QuantConfig as JQuant, make_topology as j_make_topology
from repro.core.flatten import flatten_tree as j_flatten, make_flat_spec as j_make_spec
from repro.core.heterogeneity import Partition as JPartition
from repro.core.heterogeneity import partition_similarity as j_partition
from repro.data import FederatedDataset as JData, synthetic_image_classification as j_synth
from repro.data.synthetic import synthetic_token_stream as j_tokens
from repro.models import make_fnn as j_make_fnn, make_lstm_lm as j_make_lstm

import torch

from repro_torch.configs.lstm_reddit import LSTM
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import DFedRW, DFedRWConfig, QuantConfig, make_topology
from repro_torch.core.flatten import flatten_tree, make_flat_spec, tree_leaves, unflatten_tree
from repro_torch.core.heterogeneity import Partition, partition_similarity
from repro_torch.data import FederatedDataset
from repro_torch.data import synthetic_token_stream
from repro_torch.models import make_fnn, make_lstm_lm
from _torch_threads import torch_threads  # noqa: F401

SMALL = dict(vocab=200, embed=32, hidden=64, layers=2)


def _small_params():
    jm, tm = j_make_lstm(**SMALL), make_lstm_lm(**SMALL)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, tm, jp, tp


def _tokens(seed=0, b=8, t=12):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, SMALL["vocab"], (b, t)).astype(np.int32),
            rng.integers(0, SMALL["vocab"], (b, t)).astype(np.int32))


def test_params_cross_with_their_nesting():
    _, _, jp, tp = _small_params()
    assert sorted(tp) == ["cells", "embed", "out_b", "out_w"]
    assert isinstance(tp["cells"], list) and all(isinstance(c, tuple) for c in tp["cells"])
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("targets", ["sequence", "last"])
def test_predict_loss_and_grads_match_jax(targets):
    jm, tm, jp, tp = _small_params()
    toks, nxt = _tokens()
    if targets == "last":
        nxt = nxt[:, -1]
    jb, tb = (jnp.asarray(toks), jnp.asarray(nxt)), (torch.as_tensor(toks), torch.as_tensor(nxt))
    np.testing.assert_allclose(tm.predict(tp, tb[0]).numpy(), np.asarray(jm.predict(jp, jb[0])),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tm.loss_fn(tp, tb)), float(jm.loss_fn(jp, jb)), rtol=1e-5)
    jg = jax.grad(jm.loss_fn)(jp, jb)
    leaves = tree_leaves(tp)
    tg = torch.func.grad(lambda ls: tm.loss_fn(
        {"cells": [tuple(ls[3 * i:3 * i + 3]) for i in range(2)], "embed": ls[6],
         "out_b": ls[7], "out_w": ls[8]}, tb))(leaves)
    for a, b in zip(jax.tree_util.tree_leaves(jg), tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("width", ["small", "published"])
def test_flat_spec_matches_jax(width):
    kw = SMALL if width == "small" else dict(vocab=50_000, embed=128, hidden=256, layers=2)
    jspec = j_make_spec(jax.eval_shape(j_make_lstm(**kw).init, jax.random.PRNGKey(0)))
    model = LSTM(vocab=kw["vocab"]) if width == "published" else make_lstm_lm(**kw)
    spec = make_flat_spec(model.init(torch.Generator().manual_seed(0), "meta"))
    for field in ("shapes", "sizes", "padded_sizes", "offsets", "d", "d_pad"):
        assert getattr(spec, field) == getattr(jspec, field), field
    if width == "published":
        assert (spec.d, spec.d_pad, spec.rows) == (20_169_552, 20_169_600, 157_575)
        # cells[0] (wx, wh, b), cells[1], embed, out_b, out_w
        assert spec.shapes[6] == (50_000, 128) and spec.shapes[8] == (256, 50_000)


def test_flat_codec_round_trips_the_lstm_layout():
    _, _, jp, tp = _small_params()
    spec = make_flat_spec(tp)
    vec = flatten_tree(tp, spec)
    np.testing.assert_array_equal(vec.numpy(), np.asarray(j_flatten(jp, j_make_spec(jp))))
    back = unflatten_tree(vec, spec)
    assert isinstance(back["cells"], list) and isinstance(back["cells"][1], tuple)
    for a, b in zip(tree_leaves(tp), tree_leaves(back)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [
    {},
    dict(n_clients=64, seq_len=12, seqs_per_client=48, vocab=500, client_vocab=60, seed=0),
    dict(n_clients=7, seq_len=5, seqs_per_client=3, vocab=50_000, client_vocab=60, seed=3),
])
def test_synthetic_token_stream_matches_jax(kw):
    for a, b in zip(j_tokens(**kw), synthetic_token_stream(**kw)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ chain mode


def _jax_qseeds(key, k):
    """The JAX flat engine's uint32 seed words for its K hop calls and its
    one aggregation call (tests/test_torch_dfedrw.py)."""
    words = []
    for _ in range(k + 1):
        key, sub = jax.random.split(key)
        words.append(np.asarray(jax.random.key_data(sub)).reshape(-1)[:2])
    return np.stack(words)


def _chain_pair(case, bits):
    if case == "fnn":
        n = 10
        x, y = j_synth(n_samples=2000, seed=0, noise=1.0)
        jdata = JData.from_partition(x, y, j_partition(y, n, 50, np.random.default_rng(0)))
        tdata = FederatedDataset.from_partition(
            x, y, partition_similarity(y, n, 50, np.random.default_rng(0)))
        jmodel, tmodel = j_make_fnn((64,)), make_fnn((64,))
        kw = dict(m_chains=3, k_walk=3, batch_size=32)
    else:
        n = 8
        toks, nxt, client = j_tokens(n_clients=n, seq_len=6, seqs_per_client=16,
                                     vocab=SMALL["vocab"], client_vocab=20, seed=0)
        idxs = [np.nonzero(client == c)[0] for c in range(n)]
        jdata = JData.from_partition(toks, nxt[:, -1], JPartition(idxs, n))
        tdata = FederatedDataset.from_partition(toks, nxt[:, -1], Partition(idxs, n))
        jmodel, tmodel = j_make_lstm(**SMALL), make_lstm_lm(**SMALL)
        kw = dict(m_chains=4, k_walk=3, batch_size=8, lr_r=0.5)
    jr = JDFedRW(jmodel, jdata, j_make_topology("complete", n),
                 JConfig(chain_mode=True, quant=JQuant(bits=bits), **kw))
    tr = DFedRW(tmodel, tdata, make_topology("complete", n),
                DFedRWConfig(chain_mode=True, quant=QuantConfig(bits=bits), **kw), device="cpu")
    js = jr.init_state(jax.random.PRNGKey(0))
    params = jmodel.init(jax.random.PRNGKey(0))
    ts = tr.state_from_params(lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    return jr, js, tr, ts


@pytest.mark.parametrize("case", ["fnn", "lstm"])
@pytest.mark.parametrize("bits", [32, 8])
def test_chain_mode_rounds_match_jax(case, bits):
    jr, js, tr, ts = _chain_pair(case, bits)
    np.testing.assert_array_equal(js.chain_starts, ts.chain_starts)
    key = jax.random.PRNGKey(0)
    for _ in range(3):
        key, sub = jax.random.split(key)
        jplan, jbidx = jr.plan_walks(js)
        jagg = jr.plan_aggregation(jplan)
        tplan, tbidx = tr.plan_walks(ts)
        tagg = tr.plan_aggregation(tplan)
        np.testing.assert_array_equal(jplan.devices[:, 0], js.chain_starts)
        np.testing.assert_array_equal(jplan.devices, tplan.devices)
        np.testing.assert_array_equal(jplan.mask, tplan.mask)
        np.testing.assert_array_equal(jbidx, tbidx)
        assert jagg[1].shape == (tr.cfg.m_chains, tr.cfg.m_chains)
        for a, b in zip(jagg, tagg):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        js, jm = jr.execute_round(js, jplan, jbidx, jagg, sub)
        qseeds = _jax_qseeds(sub, tr.cfg.k_walk) if bits < 32 else None
        ts, tm = tr.execute_round(ts, tplan, tbidx, tagg, None, qseeds=qseeds)
        np.testing.assert_array_equal(js.chain_starts, ts.chain_starts)
        np.testing.assert_array_equal(ts.chain_starts, tplan.last_device)
        assert jm.comm_bits_round == tm.comm_bits_round
        assert jm.comm_bits_busiest_round == tm.comm_bits_busiest_round
        np.testing.assert_array_equal(js.updated, ts.updated)
        jmat, tmat = np.asarray(js.device_params), ts.device_params.numpy()
        if bits == 32:
            np.testing.assert_allclose(tmat, jmat, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(tm.train_loss, jm.train_loss, rtol=1e-5)
        else:
            scale = float(np.abs(jmat).max())
            assert float(np.abs(jmat - tmat).max()) < 0.05 * scale + 1e-4
            np.testing.assert_allclose(tm.train_loss, jm.train_loss, atol=5e-3)
