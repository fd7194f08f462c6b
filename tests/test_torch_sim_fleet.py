"""The port's fleet-scale pieces against the JAX package's on the CPU: the
implicit ``SparseTopology`` with its samplers and planner, the vectorized
fleet timeline (repro_torch.sim.FleetDFedRW) against the reference's fleet,
and the port's fleet against the port's heap engine.

Contracts:
- CSR arrays, ``sample_next`` draws, sparse walks and the sparse
  aggregation plan (CSR gather + lexsort) equal the reference's, rng state
  included; ``lambda_p_power`` and ``mixing_time`` equal it too;
- the port's fleet equals the reference's fleet bit for bit on the
  timeline, plans, Eq. 18 bits, rng states and uplink stats, with params
  within the flat engine's contract (tests/_torch_sim_pair.py);
- the port's fleet equals the port's heap, params included, at the
  configurations where the reference's passing fleet tests
  (tests/test_sim_fleet.py ``PARITY_CONFIGS``) hold its fleet to its heap.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from _torch_sim_pair import assert_params_close, assert_same_timeline, run_pair

from repro.core import graph as jgraph
from repro.core import walk as jwalk
from repro.core.dfedrw import DFedRW as JDFedRW, DFedRWConfig as JConfig
from repro.data.synthetic import FederatedDataset as JData
from repro.models.fnn import make_fnn as j_make_fnn

from repro_torch.core import graph as tgraph
from repro_torch.core import walk as twalk
from repro_torch.core.dfedrw import DFedRW, DFedRWConfig
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.models.fnn import make_fnn
from repro_torch.sim import (
    AsyncDFedRW,
    FleetDFedRW,
    LinkModelConfig,
    build_scenario,
)
from repro_torch.sim.hierarchy import HierarchicalLinkModel
from _torch_threads import torch_threads  # noqa: F401

SPARSE = [("ring", 50, {}), ("expander3", 200, {"seed": 4}),
          ("expander5", 97, {}), ("metro", 1000, {"devices_per_cell": 100,
                                                  "cells_per_metro": 4, "seed": 1})]


@pytest.mark.parametrize("name,n,kw", SPARSE)
def test_sparse_topology_and_sampler_match_jax(name, n, kw):
    jt = jgraph.make_sparse_topology(name, n, **kw)
    tt = tgraph.make_sparse_topology(name, n, **kw)
    np.testing.assert_array_equal(jt.indptr, tt.indptr)
    np.testing.assert_array_equal(jt.indices, tt.indices)
    assert jt.lazy == tt.lazy and jt.degree(3) == tt.degree(3)
    np.testing.assert_array_equal(jt.neighbors(5, include_self=True),
                                  tt.neighbors(5, include_self=True))
    x = np.random.default_rng(0).standard_normal(n)
    np.testing.assert_array_equal(jt.mh_matvec(x), tt.mh_matvec(x))
    assert jt.lambda_p_estimate(iters=40) == tt.lambda_p_estimate(iters=40)
    jr, tr = np.random.default_rng(7), np.random.default_rng(7)
    cur = np.arange(0, n, 3)
    for _ in range(4):
        a, b = jt.sample_next(cur, jr), tt.sample_next(cur, tr)
        np.testing.assert_array_equal(a, b)
        cur = a
    strag = dict(h_percent=30, mode="truncate")
    jp = jwalk.sample_walks(jt, 9, 6, jr, straggler=jwalk.StragglerModel(**strag))
    tp = twalk.sample_walks(tt, 9, 6, tr, straggler=twalk.StragglerModel(**strag))
    np.testing.assert_array_equal(jp.devices, tp.devices)
    np.testing.assert_array_equal(jp.mask, tp.mask)
    np.testing.assert_array_equal(jp.last_device, tp.last_device)
    assert jr.bit_generator.state == tr.bit_generator.state


def test_spectral_helpers_match_jax():
    for name in ("ring", "expander3", "complete"):
        jP = jgraph.make_topology(name, 16).transition
        tP = tgraph.make_topology(name, 16).transition
        np.testing.assert_array_equal(jP, tP)
        assert jgraph.lambda_p_power(jP) == tgraph.lambda_p_power(tP)
        for method in ("dense", "power"):
            assert (jgraph.mixing_time(jP, method=method)
                    == tgraph.mixing_time(tP, method=method))
    with pytest.raises(ValueError, match="method"):
        tgraph.mixing_time(tP, method="exact")
    with pytest.raises(ValueError, match="n="):
        tgraph.lambda_p_power(lambda v: v)
    plan = twalk.WalkPlan(devices=np.array([[0, 1, 2]]), mask=np.ones((1, 3), bool),
                          k_m=np.array([3], np.int32))
    cut = plan.truncated(np.array([1]))
    assert cut.k_m.tolist() == [1] and cut.last_device.tolist() == [0]


def _pooled(n, jax_side):
    """Pooled-shard data as the fleet scenarios build it (16 shards of 4)."""
    from repro_torch.data.synthetic import synthetic_image_classification
    x, y = synthetic_image_classification(n_samples=64, image_shape=(8, 8), seed=0,
                                          noise=1.0)
    idx = np.arange(64, dtype=np.int64).reshape(16, 4)[np.arange(n) % 16]
    cls = JData if jax_side else FederatedDataset
    return cls(x=x, y=y, client_idx=idx, client_mask=np.ones_like(idx, dtype=bool),
               n_clients=n)


def test_sparse_plan_aggregation_matches_jax():
    """The CSR gather + lexsort planner draws and returns what the
    reference's does, and its rows are valid neighbor selections."""
    n = 64
    kw = dict(devices_per_cell=8, cells_per_metro=2, seed=0)
    jt, tt = jgraph.make_sparse_topology("metro", n, **kw), tgraph.make_sparse_topology(
        "metro", n, **kw)
    cfg = dict(m_chains=6, k_walk=5, batch_size=4, n_agg=4, agg_fraction=0.25, seed=0)
    je = JDFedRW(j_make_fnn((4,), in_dim=64), _pooled(n, True), jt, JConfig(**cfg))
    te = DFedRW(make_fnn((4,), in_dim=64), _pooled(n, False), tt, DFedRWConfig(**cfg),
                device="cpu")
    js = je.init_state(jax.random.PRNGKey(0))
    ts = te.init_state(torch.Generator().manual_seed(0))
    for _ in range(3):
        (jp, jb), (tp, tb) = je.plan_walks(js, m=4), te.plan_walks(ts, m=4)
        np.testing.assert_array_equal(jp.devices, tp.devices)
        np.testing.assert_array_equal(jb, tb)
        ja, ta = je.plan_aggregation(jp), te.plan_aggregation(tp)
        for a, b in zip(ja, ta):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert je.rng.bit_generator.state == te.rng.bit_generator.state
    participants = set(np.unique(tp.devices[tp.mask]).tolist())
    agg_devices, agg_rows, agg_w = ta
    for r, a in enumerate(agg_devices):
        nbrs = set(tt.neighbors(int(a)).tolist()) | {int(a)}
        sel = agg_w[r] > 0.0
        assert abs(agg_w[r][sel].sum() - 1.0) < 1e-6
        for dev, w in zip(agg_rows[r], agg_w[r]):
            if w > 0.0:
                assert int(dev) in nbrs and (int(dev) in participants or dev == a)
            else:
                assert int(dev) == int(a)


@pytest.mark.parametrize("scenario,n", [("fleet_metro", 200), ("million_walks", 500)])
def test_fleet_matches_jax_fleet(scenario, n):
    out = run_pair(scenario, 2, n=n, seed=3)
    jr, tr = out["jr"], out["tr"]
    assert jr.timeline_engine == tr.timeline_engine == "fleet"
    assert_same_timeline(out["jres"], out["tres"], out["jsnaps"], out["tsnaps"])
    assert_params_close(out["jres"], out["tres"], quantized=True)
    if jr._queue_on:
        for name in ("_q_busy", "_q_sent", "_q_busy_s", "_q_queued", "_q_first",
                     "_q_last"):
            np.testing.assert_array_equal(getattr(jr, name), getattr(tr, name))
    if isinstance(tr.link, HierarchicalLinkModel):
        for tier, st in jr.link.tier_stats.items():
            assert dataclasses.asdict(st) == dataclasses.asdict(tr.link.tier_stats[tier])


# The reference's fleet-vs-heap parity configurations (tests/test_sim_fleet.py).
PARITY_CONFIGS = {
    "uniform_barrier": ("uniform_sync", {}),
    "straggler_partial": ("straggler_tail", {"policy": "partial"}),
    "straggler_drop": ("straggler_tail", {"policy": "drop"}),
    "churn": ("churn_dropout", {}),
    "congested_overlap": ("congested_uplink", {}),
    "congested_quant8": ("congested_uplink", {"bits": 8}),
    "hier_noqueue": ("fleet_metro", {"queue": False}),
    "hier_queue_churn_overlap": ("fleet_metro", {"policy": "overlap"}),
}
_RECORD_FIELDS = ("t_start", "t_compute_end", "t_end", "k_planned", "k_done",
                  "k_exec", "killed", "events", "agg_latency_s", "resumed", "bits")


@pytest.mark.parametrize("name", sorted(PARITY_CONFIGS))
def test_fleet_matches_heap(name):
    scenario, overrides = PARITY_CONFIGS[name]
    runs = []
    for engine in ("heap", "fleet"):
        setup = build_scenario(scenario, n=20, seed=3, **overrides)
        runner = setup.runner(engine=engine, device="cpu")
        runs.append((runner, runner.run(2, torch.Generator().manual_seed(1),
                                        setup.x_test, setup.y_test, eval_every=2)))
    (heap, a), (fleet, b) = runs
    assert isinstance(heap, AsyncDFedRW) and isinstance(fleet, FleetDFedRW)
    assert a.virtual_time_s == b.virtual_time_s
    assert a.events_total == b.events_total
    assert torch.equal(a.state.device_params, b.state.device_params)
    for ra, rb in zip(a.records, b.records):
        for f in _RECORD_FIELDS:
            assert np.array_equal(np.asarray(getattr(ra, f)), np.asarray(getattr(rb, f))), f
    assert heap.engine.rng.bit_generator.state == fleet.engine.rng.bit_generator.state
    if heap.link.uplinks is not None:
        for dev, sh in heap.link.uplinks.stats.items():
            assert dataclasses.asdict(sh) == dataclasses.asdict(fleet.uplink_stats(dev))
    if isinstance(heap.link, HierarchicalLinkModel):
        for tier, sh in heap.link.tier_stats.items():
            assert sh.sent == fleet.link.tier_stats[tier].sent, tier


def test_fleet_engine_dispatch_and_refusals():
    setup = build_scenario("uniform_sync", n=8, seed=0)
    assert isinstance(setup.runner(device="cpu"), AsyncDFedRW)
    assert isinstance(setup.runner(engine="fleet", device="cpu"), FleetDFedRW)
    bad = dataclasses.replace(setup.sim, engine="fleet")
    with pytest.raises(TypeError):
        AsyncDFedRW(setup.model, setup.data, setup.topo, setup.cfg, bad, device="cpu")
    jitter = dataclasses.replace(setup.sim, engine="fleet",
                                 links=LinkModelConfig(latency_s=0.01, jitter_sigma=0.5))
    with pytest.raises(ValueError, match="jitter"):
        FleetDFedRW(setup.model, setup.data, setup.topo, setup.cfg, jitter, device="cpu")
