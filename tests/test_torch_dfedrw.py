"""The port's flat round engine (repro_torch.core.dfedrw) against the JAX
package's (repro.core.DFedRW, engine="flat") on the CPU: the same data,
topology, config seed and initial params, several rounds.

Contracts:
- plans (walks, batches, aggregation) and Eq. 18 comm bits: exactly equal
  (the planners are line-for-line numpy copies on one seed);
- bits=32: device matrix within rtol 1e-5 / atol 1e-6, loss and gamma_hat
  within rtol 1e-5 (fp32 sums in another order);
- bits=8, with the JAX engine's own quantizer seed words passed in: params
  within 0.05 * scale + 1e-4, the bound of tests/test_flat_engine.py. The
  uniforms are then identical, but the per-leaf norms are summed in another
  order, so a few stochastic-rounding decisions move by one grid cell.
"""
import numpy as np
import pytest

import jax

from repro.core import DFedRW as JDFedRW, DFedRWConfig as JConfig
from repro.core import QuantConfig as JQuant, StragglerModel as JStraggler
from repro.core import make_topology as j_make_topology
from repro.core.heterogeneity import partition_similarity as j_partition
from repro.data import FederatedDataset as JData
from repro.data import synthetic_image_classification as j_synth
from repro.models import make_fnn as j_make_fnn

from repro_torch.convert import params_from_numpy
from repro_torch.core import DFedRW, DFedRWConfig, QuantConfig, StragglerModel, make_topology
from repro_torch.core.heterogeneity import partition_similarity
from repro_torch.data import FederatedDataset, synthetic_image_classification
from repro_torch.models import make_fnn
from _torch_threads import torch_threads  # noqa: F401

CASES = {
    # tests/test_flat_engine.py's setup: 10 devices, 2,000 samples, 2FNN-64
    "fnn64": dict(n=10, samples=2000, noise=1.0, hidden=(64,)),
    # the paper's 3FNN at its published widths on tiny data
    "3fnn": dict(n=6, samples=300, noise=2.0, hidden=(200, 200)),
}


def _pair(case, **cfg_kw):
    c = CASES[case]
    x, y = j_synth(n_samples=c["samples"], seed=0, noise=c["noise"])
    jdata = JData.from_partition(x, y, j_partition(y, c["n"], 50, np.random.default_rng(0)))
    xt, yt = synthetic_image_classification(n_samples=c["samples"], seed=0, noise=c["noise"])
    tdata = FederatedDataset.from_partition(
        xt, yt, partition_similarity(yt, c["n"], 50, np.random.default_rng(0)))
    bits = cfg_kw.pop("bits", 32)
    strag = cfg_kw.pop("straggler", None)
    jcfg = JConfig(quant=JQuant(bits=bits), engine="flat", **cfg_kw,
                   **({"straggler": JStraggler(**strag)} if strag else {}))
    tcfg = DFedRWConfig(quant=QuantConfig(bits=bits), **cfg_kw,
                        **({"straggler": StragglerModel(**strag)} if strag else {}))
    jmodel = j_make_fnn(c["hidden"])
    jr = JDFedRW(jmodel, jdata, j_make_topology("complete", c["n"]), jcfg)
    tr = DFedRW(make_fnn(c["hidden"]), tdata, make_topology("complete", c["n"]), tcfg,
                device="cpu")
    params = jmodel.init(jax.random.PRNGKey(0))
    js = jr.init_state(jax.random.PRNGKey(0))
    ts = tr.state_from_params(params_from_numpy(
        [(np.asarray(w), np.asarray(b)) for w, b in params], device="cpu"))
    return jr, js, tr, ts


def _jax_qseeds(key, k):
    """The uint32 seed words the JAX flat engine derives for its K hop calls
    and its one aggregation call (dfedrw.py:311/:362, ops.py:111)."""
    words = []
    for _ in range(k + 1):
        key, sub = jax.random.split(key)
        words.append(np.asarray(jax.random.key_data(sub)).reshape(-1)[:2])
    return np.stack(words)


def _run(jr, js, tr, ts, rounds, bits, check):
    key = jax.random.PRNGKey(0)
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        jplan, jbidx = jr.plan_walks(js)
        jagg = jr.plan_aggregation(jplan)
        tplan, tbidx = tr.plan_walks(ts)
        tagg = tr.plan_aggregation(tplan)
        np.testing.assert_array_equal(jplan.devices, tplan.devices)
        np.testing.assert_array_equal(jplan.mask, tplan.mask)
        np.testing.assert_array_equal(jbidx, tbidx)
        for a, b in zip(jagg, tagg):
            np.testing.assert_array_equal(a, b)
        js, jm = jr.execute_round(js, jplan, jbidx, jagg, sub)
        qseeds = _jax_qseeds(sub, tr.cfg.k_walk) if bits < 32 else None
        ts, tm = tr.execute_round(ts, tplan, tbidx, tagg, None, qseeds=qseeds)
        assert jm.comm_bits_round == tm.comm_bits_round
        assert jm.comm_bits_busiest_round == tm.comm_bits_busiest_round
        np.testing.assert_array_equal(js.updated, ts.updated)
        check(np.asarray(js.device_params), ts.device_params.numpy(), jm, tm)
    return js, ts


def _check_fp32(jmat, tmat, jm, tm):
    np.testing.assert_allclose(tmat, jmat, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tm.train_loss, jm.train_loss, rtol=1e-5)
    np.testing.assert_allclose(tm.gamma_hat, jm.gamma_hat, rtol=1e-5)


def _check_quant(jmat, tmat, jm, tm):
    scale = float(np.abs(jmat).max())
    assert float(np.abs(jmat - tmat).max()) < 0.05 * scale + 1e-4
    np.testing.assert_allclose(tm.train_loss, jm.train_loss, atol=5e-3)
    np.testing.assert_allclose(tm.gamma_hat, jm.gamma_hat, atol=5e-3)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("bits", [32, 8])
def test_rounds_match_jax(case, bits):
    jr, js, tr, ts = _pair(case, m_chains=4, k_walk=3, batch_size=32, bits=bits)
    js, ts = _run(jr, js, tr, ts, 3, bits, _check_fp32 if bits == 32 else _check_quant)
    # evaluation of the averaged participating model agrees as well
    xt, yt = synthetic_image_classification(n_samples=256, seed=1, noise=2.0)
    je, te = jr.evaluate(js, xt, yt), tr.evaluate(ts, xt, yt)
    tol = 1e-5 if bits == 32 else 5e-2
    np.testing.assert_allclose(te["loss"], je["loss"], rtol=tol)


@pytest.mark.parametrize("mode", ["truncate", "partial"])
def test_rounds_match_jax_under_stragglers(mode):
    """Variable-length chains (truncate) and partial sub-batches mask and
    tile identically."""
    jr, js, tr, ts = _pair("fnn64", m_chains=4, k_walk=4, batch_size=32,
                           straggler=dict(h_percent=50, mode=mode))
    _run(jr, js, tr, ts, 2, 32, _check_fp32)


def test_run_round_draws_own_seeds_and_is_deterministic():
    """Without qseeds the engine draws its seed words from the generator:
    the same generator seed gives the same round, another seed another."""
    import torch

    def one(seed):
        _, _, tr, ts = _pair("fnn64", m_chains=4, k_walk=3, batch_size=32, bits=8)
        ts, m = tr.run_round(ts, torch.Generator().manual_seed(seed))
        return ts.device_params, m

    a, ma = one(1)
    b, _ = one(1)
    c, _ = one(2)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert np.isfinite(ma.train_loss)


def test_launcher_cpu_round(capsys):
    from repro_torch.launch.train import main

    main(["protocol", "--algo", "dfedrw", "--device", "cpu", "--rounds", "1",
          "--devices", "8", "--chains", "2", "--epochs", "2", "--bits", "8"])
    out = capsys.readouterr().out
    assert "round    1" in out and "final:" in out
    main(["protocol", "--algo", "fedavg", "--device", "cpu", "--rounds", "1",
          "--devices", "8", "--chains", "2", "--epochs", "2"])
    out = capsys.readouterr().out
    assert "round    1" in out and "final:" in out
    main(["pod", "--arch", "mamba2-130m", "--smoke", "--device", "cpu", "--fed", "--steps", "1",
          "--batch", "1", "--seq", "32"])
    out = capsys.readouterr().out
    assert "fed pod mode: 1 pods" in out and "done (inter-pod param spread=0.00000)" in out
