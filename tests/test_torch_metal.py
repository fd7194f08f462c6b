"""The port's metal replay (``repro_torch.sim.metal``) on the CPU.

Contracts:
- against the JAX package's ``repro.sim.MetalReplay`` (one position, from
  the reference's initial params and its metal seed words: hops from
  ``split`` of ``fold_in(sub, 0)`` a step, aggregation from
  ``fold_in(sub, 4096)``) on ``uniform_sync`` at bits 32 and 8 and on
  ``churn_dropout`` under ``FaultInjector``: the device matrix within rtol
  1e-5 / atol 1e-6 at bits 32 and 0.05 * scale + 1e-4 at bits 8, losses
  and gamma_hat as tests/_torch_sim_pair.py holds them, Eq. 18 bits and
  the fault counters exactly equal;
- against the port's own simulator: bit for bit at one position (bits 32
  and 8); at two positions bit for bit at bits 32 and within 4x the
  simulator's spread under other seed words at bits 8; a position of one
  chain within CHAIN_SLICE_TOL at bits 32 (on a CPU with several threads
  a lone matrix product takes MKL's threaded path, which splits the inner
  dimension: ROADMAP.md C, "Chain slices");
- ``FaultInjector``: the derived masks equal the reference's under
  ``partial`` and ``drop``; a tampered window raises; ``stall_scale``
  sleeps;
- a mismatched trace header raises ``TraceIntegrityError``, an engine that
  is not the flat DFedRW raises; ``LocalExchange`` is the identity;
- the metal stream and the simulator stream of one trace pass
  ``tools/obs_diff.py``.
"""
import dataclasses
import functools
import os
import sys

import jax
import numpy as np
import pytest
import torch

import repro.sim as jsim
from _torch_sim_pair import assert_params_close, jax_qseeds
from repro.core.dfedrw import DFedRW as JDFedRW

import repro_torch.sim as tsim
from repro_torch.convert import params_from_numpy
from repro_torch.core import DFedRW
from repro_torch.core.baselines import BaselineConfig, DFedAvg
from repro_torch.obs import Recorder, VirtualClock
from repro_torch.sim import (
    CHAIN_SLICE_TOL,
    FaultInjector,
    LocalExchange,
    MetalConformanceError,
    MetalReplay,
    TraceIntegrityError,
    build_scenario,
    conformance_diff,
)
from _torch_threads import torch_threads  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
KEY_SEED = 7
WINDOWS = 2

JAX_CASES = {"fp32": ("uniform_sync", 0, {}), "bits8": ("uniform_sync", 0, {"bits": 8}),
             "churn": ("churn_dropout", 2, {})}


def metal_words(root, windows, k):
    """The seed words the JAX metal replay derives a window at one position:
    K hops from ``split`` of ``fold_in(sub, 0)``, then ``fold_in(sub, 4096)``."""
    out, key = [], root
    for _ in range(windows):
        key, sub = jax.random.split(key)
        hops = jax_qseeds(jax.random.fold_in(sub, 0), k)[:k]
        agg = np.asarray(jax.random.key_data(jax.random.fold_in(sub, 4096))).reshape(-1)[:2]
        out.append(np.vstack([hops, agg[None]]))
    return out


@functools.lru_cache(maxsize=None)
def _jax_pair(case):
    scenario, seed, ov = JAX_CASES[case]
    windows = WINDOWS
    jsetup = jsim.build_scenario(scenario, n=12, seed=seed, rounds=windows, **ov)
    tsetup = build_scenario(scenario, n=12, seed=seed, rounds=windows, **ov)
    # the port's simulator records the trace (both packages read it)
    ttrace = tsetup.runner(device="cpu").run(
        windows, torch.Generator().manual_seed(KEY_SEED), record=True).trace
    jtrace = jsim.SimTrace.from_lines(ttrace.to_lines())
    root = jax.random.PRNGKey(KEY_SEED)
    faults = scenario == "churn_dropout"
    jfi = jsim.FaultInjector(policy=jsetup.sim.policy) if faults else None
    jres = jsim.MetalReplay(JDFedRW(jsetup.model, jsetup.data, jsetup.topo, jsetup.cfg)).run(
        jtrace, root, jsetup.x_test, jsetup.y_test, fault=jfi)
    tparams = params_from_numpy([(np.asarray(w), np.asarray(b))
                                 for w, b in jsetup.model.init(root)], device="cpu")
    tfi = FaultInjector(policy=tsetup.sim.policy) if faults else None
    metal = MetalReplay(DFedRW(tsetup.model, tsetup.data, tsetup.topo, tsetup.cfg, device="cpu"))
    tres = metal.run(ttrace, torch.Generator().manual_seed(0), tsetup.x_test,
                     tsetup.y_test, fault=tfi,
                     qseeds=metal_words(root, windows, jsetup.cfg.k_walk), params=tparams)
    return dict(case=case, jtrace=jtrace, ttrace=ttrace, jres=jres, tres=tres, jfi=jfi,
                tfi=tfi)


@pytest.fixture(scope="module", params=sorted(JAX_CASES))
def jax_pair(request):
    return _jax_pair(request.param)


def test_port_metal_matches_jax_metal(jax_pair):
    jres, tres = jax_pair["jres"], jax_pair["tres"]
    assert_params_close(jres, tres, quantized=jax_pair["case"] == "bits8")
    assert tres.history.comm_bits == jres.history.comm_bits
    assert tres.history.comm_bits_busiest == jres.history.comm_bits_busiest
    assert tres.history.rounds == jres.history.rounds
    assert tres.state.comm_bits_total == jres.state.comm_bits_total
    assert tres.state.global_step == jres.state.global_step
    assert tres.windows == jres.windows and tres.n_shards == jres.n_shards == 1
    assert tres.virtual_time_s == jres.virtual_time_s
    if jax_pair["jfi"] is not None:
        jfi, tfi = jax_pair["jfi"], jax_pair["tfi"]
        assert (tfi.stalls_injected, tfi.steps_stalled, tfi.aggregators_dropped) == \
            (jfi.stalls_injected, jfi.steps_stalled, jfi.aggregators_dropped)
        assert tfi.aggregators_dropped > 0 and tfi.steps_stalled > 0
        assert tres.fault is tfi


@pytest.mark.parametrize("policy", ["partial", "drop"])
def test_derive_exec_mask_matches_the_reference(policy):
    pair = _jax_pair("churn")
    jsched, tsched = pair["jtrace"].schedule(), pair["ttrace"].schedule()
    jfi = jsim.FaultInjector(policy=policy, verify=False)
    tfi = FaultInjector(policy=policy, verify=False)
    stalled = 0
    for jw, tw in zip(jsched, tsched):
        want = np.asarray(jfi.derive_exec_mask(jw))
        got = tfi.derive_exec_mask(tw)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tfi.inject(tw), want)
        stalled += int(tw.stalled.sum())
    assert stalled > 0


# ------------------------------------------------------ against the port's sim
def _setup(scenario="uniform_sync", m_chains=None, **ov):
    setup = build_scenario(scenario, n=12, seed=0, rounds=WINDOWS, **ov)
    if m_chains is not None:
        setup = dataclasses.replace(setup, cfg=dataclasses.replace(setup.cfg, m_chains=m_chains))
    return setup


def _sim(setup, obs=None):
    runner = setup.runner(device="cpu")
    if obs is not None:
        runner.attach_obs(obs)
    return runner.run(WINDOWS, torch.Generator().manual_seed(KEY_SEED), setup.x_test,
                      setup.y_test, record=True)


@functools.lru_cache(maxsize=None)
def _recorded(bits, m_chains=None):
    """``uniform_sync`` at ``bits`` (M = 5, or ``m_chains``) run by the port's
    simulator, recorded; shared by the tests that only read it."""
    setup = _setup(m_chains=m_chains, bits=bits)
    return setup, _sim(setup)


def _metal(setup, trace, devices=None, obs=None, fault=None, **kw):
    metal = MetalReplay(DFedRW(setup.model, setup.data, setup.topo, setup.cfg, device="cpu"),
                        devices=devices)
    if obs is not None:
        metal.attach_obs(obs)
    res = metal.run(trace, torch.Generator().manual_seed(KEY_SEED), setup.x_test,
                    setup.y_test, fault=fault, **kw)
    return metal, res


@pytest.mark.parametrize("bits,m_chains", [(32, None), (8, 6)])
def test_one_position_is_the_sim_bit_for_bit(bits, m_chains):
    setup, sim = _recorded(bits, m_chains)
    metal, res = _metal(setup, sim.trace)
    assert metal.positions_used == 1
    assert torch.equal(res.state.device_params, sim.state.device_params)
    assert dataclasses.asdict(res.history) == dataclasses.asdict(sim.history)
    assert res.state.comm_bits_busiest == sim.state.comm_bits_busiest
    np.testing.assert_array_equal(res.state.updated, sim.state.updated)


@pytest.mark.parametrize("bits", [32, 8])
def test_two_positions_against_the_sim(bits):
    setup, sim = _recorded(bits, 6)
    metal, res = _metal(setup, sim.trace, devices=["cpu", "cpu"])
    assert metal.positions_used == 2
    diff = conformance_diff(sim, res)
    if bits == 32:
        assert diff == 0.0
        assert res.history.train_loss == sim.history.train_loss
        return
    params = setup.model.init(torch.Generator().manual_seed(KEY_SEED), "cpu")
    alt = setup.runner(device="cpu").replay(sim.trace, torch.Generator().manual_seed(99),
                                            params=params)
    spread = conformance_diff(sim, alt)
    assert 0.0 < diff <= 4.0 * spread, (diff, spread)


def test_one_chain_positions_within_the_chain_slice_bound():
    setup, sim = _recorded(32)
    metal, res = _metal(setup, sim.trace, devices=["cpu"] * 5)
    assert metal.positions_used == 5
    np.testing.assert_allclose(res.state.device_params.numpy(),
                               sim.state.device_params.numpy(), **CHAIN_SLICE_TOL)
    np.testing.assert_allclose(res.history.train_loss, sim.history.train_loss,
                               rtol=CHAIN_SLICE_TOL["rtol"])


def test_position_seeds_differ_by_position():
    words = np.array([[1, 2], [3, 4]])
    a, b = tsim.position_seeds(words, 0), tsim.position_seeds(words, 1)
    assert a != b and len(a) == 2
    assert all(0 <= v < 1 << 32 for pair in a + b for v in pair)
    assert a == tsim.position_seeds(words, 0)


def test_quantized_window_needs_seed_words():
    setup, sim = _recorded(8, 6)
    metal = MetalReplay(DFedRW(setup.model, setup.data, setup.topo, setup.cfg, device="cpu"))
    state = metal.engine.init_state(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="seed words"):
        metal.run_window(state, sim.trace.schedule()[0])


# ---------------------------------------------------------------- faults
@pytest.fixture(scope="module")
def churn():
    setup = build_scenario("churn_dropout", n=12, seed=2, rounds=3)
    return setup, _sim(setup)


def test_fault_injection_reproduces_partial_aggregation(churn):
    setup, sim = churn
    fi = FaultInjector(policy=setup.sim.policy)
    _, res = _metal(setup, sim.trace, fault=fi)
    assert torch.equal(res.state.device_params, sim.state.device_params)
    assert fi.stalls_injected > 0 and fi.steps_stalled > 0 and fi.aggregators_dropped > 0


def test_fault_injector_detects_divergence(churn):
    setup, sim = churn
    w = sim.trace.schedule()[0]
    tampered = np.asarray(w.exec_mask).copy()
    tampered[0, 0] = ~tampered[0, 0]
    with pytest.raises(MetalConformanceError, match="exec mask"):
        FaultInjector(policy=setup.sim.policy).inject(dataclasses.replace(w, exec_mask=tampered))


def test_fault_injector_stall_scale_sleeps(churn, monkeypatch):
    setup, sim = churn
    w = next(w for w in sim.trace.schedule() if (w.k_planned > w.k_done).any())
    slept = []
    monkeypatch.setattr("repro_torch.sim.metal.time.sleep", slept.append)
    FaultInjector(policy=setup.sim.policy, stall_scale=0.25).inject(w)
    assert slept == [0.25 * int(np.maximum(w.k_planned - w.k_done, 0).sum())]


# ---------------------------------------------------------------- refusals
def test_metal_rejects_a_mismatched_header():
    setup, sim = _recorded(32)
    other = _setup(m_chains=6)
    with pytest.raises(TraceIntegrityError, match="m_chains"):
        _metal(other, sim.trace)


def test_metal_refuses_an_engine_that_is_not_the_flat_dfedrw():
    setup = _setup()
    engine = DFedRW(setup.model, setup.data, setup.topo, setup.cfg, device="cpu")
    engine.cfg = dataclasses.replace(setup.cfg, engine="reference")
    with pytest.raises(ValueError, match="flat"):
        MetalReplay(engine)
    baseline = DFedAvg(setup.model, setup.data, setup.topo, BaselineConfig(), device="cpu")
    with pytest.raises(ValueError, match="flat"):
        MetalReplay(baseline)


def test_local_exchange_identity():
    ex = LocalExchange()
    assert ex.n_shards == 1 and ex.shard_id == 0
    assert ex.allgather(("a", 1)) == [("a", 1)]


# -------------------------------------------------------------- telemetry
def test_obs_diff_sim_vs_metal_is_clean(tmp_path):
    setup = _setup()
    rec_sim, rec_metal = Recorder(clock=VirtualClock()), Recorder(clock=VirtualClock())
    sim = _sim(setup, obs=rec_sim)
    _, res = _metal(setup, sim.trace, obs=rec_metal)
    assert conformance_diff(sim, res) == 0.0
    paths = [str(tmp_path / "sim_obs.jsonl"), str(tmp_path / "metal_obs.jsonl")]
    rec_sim.save(paths[0], workload="sim")
    rec_metal.save(paths[1], workload="metal")
    tools = os.path.join(ROOT, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import obs_diff
    assert obs_diff.main(paths) == 0
