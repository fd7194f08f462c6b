"""The port's heap simulator (repro_torch.sim.AsyncDFedRW) against the JAX
package's (repro.sim) on the CPU: one scenario, the same data, seeds and
initial params (through repro_torch.convert), at most 3 windows.

Contract (tests/_torch_sim_pair.py): every SimRoundRecord field except the
host wall times, the recorded window plans, batch indices, aggregation
plans, Eq. 18 bits and every numpy rng state (protocol, link jitter, churn)
after every window are exactly equal; the device matrix is within
rtol 1e-5 / atol 1e-6 at bits 32 and, with the JAX run's quantizer seed
words, within 0.05 * scale + 1e-4 at bits < 32. ``uniform_sync`` reproduces
the port's own synchronous DFedRW bit for bit.
"""
import numpy as np
import pytest
import torch

from _torch_sim_pair import assert_params_close, assert_same_timeline, run_pair

from repro_torch.core import DFedRW
from repro_torch.sim import build_scenario
from _torch_threads import torch_threads  # noqa: F401

CASES = {
    # (scenario, windows, overrides)
    "straggler_partial": ("straggler_tail", 3, {"policy": "partial"}),
    "straggler_drop": ("straggler_tail", 3, {"policy": "drop"}),
    "overlap_async": ("overlap_async", 3, {}),
    "congested_bits8": ("congested_uplink", 3, {"bits": 8}),
    "congested_adaptive": ("congested_uplink", 3, {"bits": "adaptive"}),
    # seed 2: churn kills chains AND takes aggregators down at a trigger
    "churn_dropout": ("churn_dropout", 3, {"seed": 2}),
    "partition_heal": ("partition_heal", 3, {"heal_after_rounds": 1}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_heap_matches_jax(case):
    scenario, windows, ov = CASES[case]
    out = run_pair(scenario, windows, **ov)
    jres, tres = out["jres"], out["tres"]
    assert_same_timeline(jres, tres, out["jsnaps"], out["tsnaps"])
    bits = [rec.bits for rec in tres.records]
    assert_params_close(jres, tres, quantized=min(bits) < 32)
    # the engine ran exactly the widths the windows report
    assert out["tr"].engine.programs_run == tuple(sorted(set(bits)))


def test_case_features_are_exercised():
    """The cases above reach what they are named for: truncation, drops,
    resumed chains, churn kills, several adaptive widths, the healed ring."""
    def run(case):
        scenario, windows, ov = CASES[case]
        setup = build_scenario(scenario, n=12, **ov)
        return setup.runner(device="cpu").run(windows, torch.Generator().manual_seed(0),
                                              record=True)
    assert sum(r.truncated_chains for r in run("straggler_partial").records) > 0
    assert sum(r.dropped_chains for r in run("straggler_drop").records) > 0
    assert sum(r.resumed_chains for r in run("overlap_async").records) > 0
    churn = run("churn_dropout")
    assert sum(int(r.killed.sum()) for r in churn.records) > 0
    assert any((w.agg_devices >= 12).any() for w in churn.trace.windows)
    assert len({r.bits for r in run("congested_adaptive").records}) > 1
    setup = build_scenario("partition_heal", n=12, seed=0, heal_after_rounds=1)
    runner = setup.runner(device="cpu")
    res = runner.run(3, torch.Generator().manual_seed(0))
    assert runner.topo_at(res.records[-1].t_start).name == "ring"


@pytest.mark.parametrize("bits", [32, 8])
def test_uniform_sync_reproduces_the_port_engine(bits):
    """Uniform rates, free links, no deadline: the simulator's trajectory is
    the port's synchronous DFedRW's, bit for bit (same generator seed)."""
    setup = build_scenario("uniform_sync", n=8, seed=0, bits=bits)
    sim = setup.runner(device="cpu")
    sync = DFedRW(setup.model, setup.data, setup.topo, setup.cfg, device="cpu")
    gs, ga = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    ss, sa = sync.init_state(gs), sim.init_state(ga)
    for _ in range(2):
        ss, ms = sync.run_round(ss, gs)
        sa, ma, rec = sim.run_round(sa, ga)
        assert torch.equal(ss.device_params, sa.device_params)
        assert ms == ma
        assert bool((rec.k_done == rec.k_planned).all())
    assert sync.rng.bit_generator.state == sim.engine.rng.bit_generator.state


@pytest.mark.parametrize("bits", [32, 8])
def test_churned_out_aggregators_are_dropped(bits):
    """``_drop_down_aggregators`` redirects a down aggregator to the id
    n + M + a; the round drops that row (as the JAX scatter's mode='drop'
    does): the result is the round without that aggregator."""
    setup = build_scenario("churn_dropout", n=12, seed=0, bits=bits)
    eng = setup.runner(device="cpu").engine
    state = eng.init_state(torch.Generator().manual_seed(0))
    plan, bidx = eng.plan_walks(state)
    agg_devices, agg_rows, agg_w = eng.plan_aggregation(plan)
    n, m = eng.topo.n, eng.cfg.m_chains
    churned = agg_devices.copy()
    churned[0] = n + m + agg_devices[0]
    qseeds = np.arange(2 * (eng.cfg.k_walk + 1)).reshape(-1, 2)
    out, _ = eng.execute_round(state, plan, bidx, (churned, agg_rows, agg_w), None,
                               qseeds=qseeds)
    without, _ = eng.execute_round(state, plan, bidx,
                                   (agg_devices[1:], agg_rows[1:], agg_w[1:]), None,
                                   qseeds=qseeds)
    assert torch.equal(out.device_params, without.device_params)
    np.testing.assert_array_equal(out.updated, without.updated)
