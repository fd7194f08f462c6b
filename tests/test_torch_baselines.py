"""The port's baselines (repro_torch.core.baselines: FedAvg, DFedAvg,
DFedAvgM, DSGD) against the JAX package's (repro.core.baselines) on the
CPU: the same data, topology, config seed and initial params, several
rounds; the Table IV latency model; the launcher's ``--algo`` choices.

Contracts:
- selections, batches, ``updated`` masks and Eq. 18 bits: exactly equal
  (the host side is a line-for-line numpy copy on one seed), and so is the
  protocol rng's state after every round; a skipped round (every selected
  device a straggler) has a NaN loss and zero bits in both;
- bits=32: device matrix within rtol 1e-5 / atol 1e-6, loss within rtol
  1e-5 (fp32 sums in another order);
- bits=8, with the JAX round key's seed words ``key_data(key)[:2]`` passed
  as ``qseed``: matrix within 0.05 * scale + 1e-4, the bound of
  tests/test_flat_engine.py (the uniforms are identical, the per-leaf
  norms summed in another order).
"""
import numpy as np
import pytest

import jax

from repro.core import BaselineConfig as JConfig, DFedAvg as JDFedAvg, DSGD as JDSGD
from repro.core import FedAvg as JFedAvg, QuantConfig as JQuant
from repro.core import StragglerModel as JStraggler, make_topology as j_make_topology
from repro.core.heterogeneity import partition_similarity as j_partition
from repro.core.metrics import latency_dfedrw as j_lat_rw, latency_fedavg as j_lat_avg
from repro.data import FederatedDataset as JData, synthetic_image_classification as j_synth
from repro.models import make_fnn as j_make_fnn

from repro_torch.convert import params_from_numpy
from repro_torch.core import (
    DSGD, BaselineConfig, DFedAvg, FedAvg, QuantConfig, StragglerModel,
    latency_dfedrw, latency_fedavg, make_topology,
)
from repro_torch.core.heterogeneity import partition_similarity
from repro_torch.data import FederatedDataset, synthetic_image_classification
from repro_torch.models import make_fnn
from _torch_threads import torch_threads  # noqa: F401

N = 10
# algo -> (JAX class, port class, config fields)
ALGOS = {
    "fedavg": (JFedAvg, FedAvg, dict(n_selected=4, local_epochs=3)),
    "dfedavg": (JDFedAvg, DFedAvg, dict(n_selected=N, local_epochs=3, n_agg=3)),
    "dfedavgm": (JDFedAvg, DFedAvg, dict(n_selected=N, local_epochs=3, n_agg=3,
                                         momentum=0.9)),
    "dsgd": (JDSGD, DSGD, dict(n_selected=6, local_epochs=3, n_agg=3)),
}


def _pair(algo, bits=32, h=0.0, **over):
    jcls, tcls, fields = ALGOS[algo]
    fields = {**fields, **over}
    x, y = j_synth(n_samples=2000, seed=0, noise=1.0)
    jdata = JData.from_partition(x, y, j_partition(y, N, 50, np.random.default_rng(0)))
    xt, yt = synthetic_image_classification(n_samples=2000, seed=0, noise=1.0)
    tdata = FederatedDataset.from_partition(
        xt, yt, partition_similarity(yt, N, 50, np.random.default_rng(0)))
    jcfg = JConfig(batch_size=32, quant=JQuant(bits=bits),
                   straggler=JStraggler(h_percent=h), **fields)
    tcfg = BaselineConfig(batch_size=32, quant=QuantConfig(bits=bits),
                          straggler=StragglerModel(h_percent=h), **fields)
    jmodel = j_make_fnn((64,))
    jr = jcls(jmodel, jdata, j_make_topology("complete", N), jcfg)
    tr = tcls(make_fnn((64,)), tdata, make_topology("complete", N), tcfg, device="cpu")
    params = jmodel.init(jax.random.PRNGKey(0))
    js = jr.init_state(jax.random.PRNGKey(0))
    ts = tr.state_from_params(params_from_numpy(
        [(np.asarray(w), np.asarray(b)) for w, b in params], device="cpu"))
    return jr, js, tr, ts


def _record(runner, name, log):
    """Log every return value of ``runner.name`` (an instance override, which
    the JAX DSGD's copied runner keeps)."""
    real = getattr(runner, name)

    def call(*args, **kw):
        out = real(*args, **kw)
        log.append(np.array(out))
        return out

    setattr(runner, name, call)


def _run(jr, js, tr, ts, rounds, bits):
    logs = {side: {"_select": [], "_batches": []} for side in ("jax", "torch")}
    for side, runner in (("jax", jr), ("torch", tr)):
        for name in logs[side]:
            _record(runner, name, logs[side][name])
    key = jax.random.PRNGKey(0)
    skipped = 0
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        before = ts.device_params.clone()
        js, jm = jr.run_round(js, sub)
        qseed = np.asarray(jax.random.key_data(sub)).reshape(-1)[:2]
        ts, tm = tr.run_round(ts, None, qseed=qseed if bits < 32 else None)
        assert jr.rng.bit_generator.state == tr.rng.bit_generator.state
        for name in ("_select", "_batches"):
            assert len(logs["jax"][name]) == len(logs["torch"][name])
            for a, b in zip(logs["jax"][name], logs["torch"][name]):
                np.testing.assert_array_equal(a, b)
        assert jm.comm_bits_round == tm.comm_bits_round
        assert jm.comm_bits_busiest_round == tm.comm_bits_busiest_round
        assert (js.round, js.global_step) == (ts.round, ts.global_step)
        assert js.comm_bits_total == ts.comm_bits_total
        np.testing.assert_array_equal(js.updated, ts.updated)
        jmat, tmat = np.asarray(js.device_params), ts.device_params.numpy()
        if np.isnan(jm.train_loss):
            skipped += 1
            assert np.isnan(tm.train_loss) and tm.comm_bits_round == 0.0
            np.testing.assert_array_equal(tmat, before.numpy())
        else:
            np.testing.assert_allclose(tm.train_loss, jm.train_loss,
                                       rtol=1e-5 if bits == 32 else 5e-3)
        if bits == 32:
            np.testing.assert_allclose(tmat, jmat, rtol=1e-5, atol=1e-6)
        else:
            scale = float(np.abs(jmat).max())
            assert float(np.abs(jmat - tmat).max()) < 0.05 * scale + 1e-4
    return js, ts, skipped


@pytest.mark.parametrize("algo", sorted(ALGOS))
@pytest.mark.parametrize("bits", [32, 8])
def test_rounds_match_jax(algo, bits):
    jr, js, tr, ts = _pair(algo, bits)
    js, ts, skipped = _run(jr, js, tr, ts, 3, bits)
    assert skipped == 0
    xt, yt = synthetic_image_classification(n_samples=256, seed=1, noise=2.0)
    je, te = jr.evaluate(js, xt, yt), tr.evaluate(ts, xt, yt)
    np.testing.assert_allclose(te["loss"], je["loss"], rtol=1e-5 if bits == 32 else 5e-2)


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_stragglers_are_dropped_and_rounds_skipped_as_in_jax(algo):
    """h = 90: nine of ten devices are slow and dropped from every selection;
    a round whose selection is all stragglers is skipped (NaN loss, zero
    bits, no update). Two selections of two devices keep the fast one in
    some rounds and lose it in others."""
    jr, js, tr, ts = _pair(algo, 8, h=90.0, n_selected=2)
    _, _, skipped = _run(jr, js, tr, ts, 6, 8)
    assert 0 < skipped < 6


def test_latency_model_matches_jax():
    for k in (1, 2, 5, 8, 20):
        for t_p in (0.0, 0.3, 1.0, 2.5):
            for t_c in (0.0, 0.1, 1.0, 7.0):
                assert latency_fedavg(k, t_p, t_c) == j_lat_avg(k, t_p, t_c)
                assert latency_dfedrw(k, t_p, t_c) == j_lat_rw(k, t_p, t_c)
    assert latency_dfedrw(5, 1.0, 1.0) == 11.0 and latency_fedavg(5, 1.0, 1.0) == 7.0


def test_run_round_draws_own_seed_and_is_deterministic():
    """Without qseed a quantized DFedAvg round draws its seed words from the
    generator: the same generator seed gives the same round."""
    import torch

    def one(seed):
        _, _, tr, ts = _pair("dfedavg", 8)
        ts, m = tr.run_round(ts, torch.Generator().manual_seed(seed))
        return ts.device_params, m

    a, ma = one(1)
    b, _ = one(1)
    c, _ = one(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert np.isfinite(ma.train_loss)


@pytest.mark.parametrize("algo", ["fedavg", "dfedavg", "dsgd"])
def test_launcher_runs_baselines_on_cpu(algo, capsys):
    from repro_torch.launch.train import main

    main(["protocol", "--algo", algo, "--device", "cpu", "--rounds", "1",
          "--devices", "6", "--chains", "2", "--epochs", "2", "--bits", "8"])
    out = capsys.readouterr().out
    assert "round    1" in out and "final:" in out


@pytest.mark.parametrize("name", ["FNN2", "FNN3"])
def test_fnn_configs_match_jax(name):
    """configs/fnn_mnist.py: the paper's 2FNN and 3FNN, layer for layer."""
    import importlib

    import torch

    from repro.core.flatten import make_flat_spec as j_make_spec
    from repro_torch.core import make_flat_spec

    jmodel = getattr(importlib.import_module("repro.configs.fnn_mnist"), name)()
    tmodel = getattr(importlib.import_module("repro_torch.configs.fnn_mnist"), name)()
    jspec = j_make_spec(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))
    spec = make_flat_spec(tmodel.init(torch.Generator().manual_seed(0), "cpu"))
    assert (spec.shapes, spec.d, spec.d_pad) == (jspec.shapes, jspec.d, jspec.d_pad)
    assert tmodel.name == jmodel.name
    assert spec.d == {"FNN2": 79_510, "FNN3": 199_210}[name]
