"""Declarative scenario registry for the virtual-time DFedRW simulator.

The port of ``repro.sim.scenarios``: the same ten scenarios, names,
defaults and overrides, so a scenario built here and one built by the JAX
package hold the same data, topology, configs and wall-clock models.
``SimSetup.runner(engine=..., device=...)`` builds the heap or the fleet
engine on the card unless ``device="cpu"`` is given.

A scenario bundles everything one simulated experiment needs — model, data
partition, topology (possibly time-varying), device/link wall-clock models,
protocol config, deadline policy — behind a name, so launchers, benchmarks
and tests run the *same* configurations:

    setup = build_scenario("straggler_tail", n=20, seed=0, policy="drop")
    result = setup.runner().run(setup.rounds, torch.Generator().manual_seed(0),
                                setup.x_test, setup.y_test)

Every builder takes ``(n, seed)`` plus scenario-specific keyword overrides
and returns a :class:`SimSetup`. Registered scenarios cover the regimes the
DFL surveys call out as the gap between simulated and deployed systems:
heavy-tailed stragglers under a deadline, statistical x system heterogeneity
crosses, partition-then-heal topologies, device churn mid-walk, chains
overlapping aggregation triggers, and shared-uplink congestion.

>>> sorted(list_scenarios()) # doctest: +NORMALIZE_WHITESPACE
['adaptive_uplink', 'churn_dropout', 'congested_uplink',
 'dirichlet_deadline', 'fleet_metro', 'million_walks', 'overlap_async',
 'partition_heal', 'straggler_tail', 'uniform_sync']
>>> get_scenario("overlap_async").build.__name__
'_overlap_async'
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

from repro_torch.core.dfedrw import DFedRWConfig
from repro_torch.core.graph import (
    SparseTopology,
    Topology,
    lambda_p,
    make_sparse_topology,
    make_topology,
    metropolis_hastings_matrix,
    _with_self_loops,
)
from repro_torch.core.heterogeneity import partition_dirichlet, partition_similarity
from repro_torch.core.quantization import QuantConfig
from repro_torch.data.synthetic import FederatedDataset, synthetic_image_classification
from repro_torch.models.fnn import make_fnn
from repro_torch.sim.adapt import AdaptiveBits
from repro_torch.sim.devices import DeviceModelConfig
from repro_torch.sim.fleet import FleetDFedRW
from repro_torch.sim.hierarchy import HierLinkConfig
from repro_torch.sim.links import LinkModelConfig
from repro_torch.sim.runner import AsyncDFedRW, SimConfig

__all__ = [
    "SimSetup",
    "SimScenario",
    "SCENARIOS",
    "register_scenario",
    "get_scenario",
    "list_scenarios",
    "build_scenario",
    "partitioned_topology",
]


@dataclasses.dataclass
class SimSetup:
    """One ready-to-run simulated experiment."""

    name: str
    model: Any
    data: FederatedDataset
    topo: Topology | SparseTopology
    cfg: DFedRWConfig
    sim: SimConfig
    x_test: np.ndarray
    y_test: np.ndarray
    rounds: int = 40
    topology_schedule: list | None = None

    def runner(self, engine: str | None = None,
               device: str = "cuda") -> AsyncDFedRW:
        """Instantiate the runner for ``sim.engine`` (or an explicit
        override): ``"heap"`` is the per-event oracle loop, ``"fleet"`` the
        vectorized batched-timeline backend for large n. The engine runs on
        ``device``: the card unless the caller asks for the CPU."""
        sim = self.sim
        if engine is not None and engine != sim.engine:
            sim = dataclasses.replace(sim, engine=engine)
        cls = FleetDFedRW if sim.engine == "fleet" else AsyncDFedRW
        return cls(self.model, self.data, self.topo, self.cfg,
                   sim, topology_schedule=self.topology_schedule, device=device)


@dataclasses.dataclass(frozen=True)
class SimScenario:
    name: str
    description: str
    build: Callable[..., SimSetup]


SCENARIOS: dict[str, SimScenario] = {}


def register_scenario(name: str, description: str):
    def deco(fn: Callable[..., SimSetup]):
        if name in SCENARIOS:
            # a typo'd re-registration used to shadow the existing entry
            # silently; every name collision is a bug in the caller
            raise ValueError(
                f"scenario {name!r} is already registered "
                f"(by {SCENARIOS[name].build.__name__}); pick a new name or "
                "remove the old registration explicitly")
        SCENARIOS[name] = SimScenario(name=name, description=description, build=fn)
        return fn
    return deco


def get_scenario(name: str) -> SimScenario:
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; have {sorted(SCENARIOS)}")
    return SCENARIOS[name]


def list_scenarios() -> dict[str, str]:
    return {s.name: s.description for s in SCENARIOS.values()}


def build_scenario(name: str, n: int = 20, seed: int = 0, **overrides) -> SimSetup:
    return get_scenario(name).build(n=n, seed=seed, **overrides)


# ------------------------------------------------------------------ helpers


def _resolve_bits(bits, **controller_kw):
    """Scenario ``bits`` knob: an int is the static width; the string
    ``"adaptive"`` installs an :class:`repro_torch.sim.adapt.AdaptiveBits`
    controller (``controller_kw`` forwards its knobs) and returns the
    controller's top width as the engine's base — the static width the
    trace header pins and window 0 starts from."""
    if isinstance(bits, str):
        if bits != "adaptive":
            raise ValueError(
                f"bits={bits!r}: expected an integer width or 'adaptive'")
        policy = AdaptiveBits(**controller_kw)
        return policy.widths[-1], policy
    return int(bits), None


def _image_setup(n: int, seed: int, scheme: str = "similarity",
                 alpha: float = 0.1, u: int = 50):
    """The paper's §VI-A synthetic image task, partitioned for n devices."""
    x, y = synthetic_image_classification(n_samples=4000, seed=0, noise=2.0)
    xt, yt = synthetic_image_classification(n_samples=1000, seed=1, noise=2.0)
    rng = np.random.default_rng(seed + 7)
    if scheme == "dirichlet":
        part = partition_dirichlet(y, n, alpha, rng)
    else:
        part = partition_similarity(y, n, u, rng)
    return FederatedDataset.from_partition(x, y, part), xt, yt


def partitioned_topology(n: int, n_parts: int = 2) -> Topology:
    """``n_parts`` disconnected ring components (a network partition): the
    MH walk cannot leave its component and lambda_P = 1 — the regime the
    connected-ER resampling in core.graph refuses to hand out silently, here
    constructed on purpose."""
    adj = np.zeros((n, n), dtype=bool)
    bounds = np.linspace(0, n, n_parts + 1).astype(int)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        size = hi - lo
        idx = lo + np.arange(size)
        adj[idx, lo + (idx - lo + 1) % size] = True
    adj = _with_self_loops(adj)
    P = metropolis_hastings_matrix(adj)
    return Topology(name=f"partitioned{n_parts}", adjacency=adj, transition=P,
                    lambda_p=lambda_p(P), n=n)


# ---------------------------------------------------------------- scenarios


@register_scenario(
    "uniform_sync",
    "uniform rates, free links, no deadline: reproduces the synchronous "
    "flat engine bit-exactly (the parity anchor)")
def _uniform_sync(n: int = 20, seed: int = 0, bits: int = 32,
                  rounds: int = 40, **kw) -> SimSetup:
    data, xt, yt = _image_setup(n, seed)
    cfg = DFedRWConfig(m_chains=5, k_walk=5, quant=QuantConfig(bits=bits),
                       seed=seed)
    sim = SimConfig(devices=DeviceModelConfig(rate_dist="uniform", seed=seed),
                    links=LinkModelConfig(), deadline_s=None, **kw)
    return SimSetup(name="uniform_sync", model=make_fnn((100,)), data=data,
                    topo=make_topology("complete", n), cfg=cfg, sim=sim,
                    x_test=xt, y_test=yt, rounds=rounds)


@register_scenario(
    "straggler_tail",
    "lognormal heavy-tailed device rates under a wall-clock aggregation "
    "deadline; policy='partial' aggregates truncated walks (the paper), "
    "policy='drop' discards them (the baseline)")
def _straggler_tail(n: int = 20, seed: int = 0, policy: str = "partial",
                    rate_sigma: float = 1.25, deadline_factor: float = 1.0,
                    bits: int = 32, rounds: int = 40, **kw) -> SimSetup:
    data, xt, yt = _image_setup(n, seed)
    cfg = DFedRWConfig(m_chains=5, k_walk=5, quant=QuantConfig(bits=bits),
                       seed=seed)
    dev = DeviceModelConfig(rate_dist="lognormal", rate_sigma=rate_sigma,
                            base_step_time=1.0, seed=seed)
    # deadline_factor=1.0 gives a median-rate chain exactly enough wall
    # clock for its K steps: chains routed through the slow tail truncate.
    sim = SimConfig(devices=dev,
                    links=LinkModelConfig(latency_s=0.05, bandwidth_bps=1e9),
                    deadline_s=deadline_factor * cfg.k_walk * dev.base_step_time,
                    policy=policy, **kw)
    return SimSetup(name="straggler_tail", model=make_fnn((100,)), data=data,
                    topo=make_topology("complete", n), cfg=cfg, sim=sim,
                    x_test=xt, y_test=yt, rounds=rounds)


@register_scenario(
    "dirichlet_deadline",
    "statistical x system heterogeneity cross: Dirichlet(alpha) non-IID "
    "partition under the heavy-tailed deadline of straggler_tail")
def _dirichlet_deadline(n: int = 20, seed: int = 0, policy: str = "partial",
                        alpha: float = 0.1, rate_sigma: float = 1.25,
                        deadline_factor: float = 1.0, bits: int = 32,
                        rounds: int = 40, **kw) -> SimSetup:
    data, xt, yt = _image_setup(n, seed, scheme="dirichlet", alpha=alpha)
    cfg = DFedRWConfig(m_chains=5, k_walk=5, quant=QuantConfig(bits=bits),
                       seed=seed)
    dev = DeviceModelConfig(rate_dist="lognormal", rate_sigma=rate_sigma,
                            base_step_time=1.0, seed=seed)
    sim = SimConfig(devices=dev,
                    links=LinkModelConfig(latency_s=0.05, bandwidth_bps=1e9),
                    deadline_s=deadline_factor * cfg.k_walk * dev.base_step_time,
                    policy=policy, **kw)
    return SimSetup(name="dirichlet_deadline", model=make_fnn((100,)),
                    data=data, topo=make_topology("complete", n), cfg=cfg,
                    sim=sim, x_test=xt, y_test=yt, rounds=rounds)


@register_scenario(
    "partition_heal",
    "time-varying topology: the network starts split into two disconnected "
    "components (walks cannot mix, lambda_P = 1), then heals into one ring "
    "mid-run")
def _partition_heal(n: int = 20, seed: int = 0, heal_after_rounds: int = 10,
                    rounds: int = 30, bits: int = 32, **kw) -> SimSetup:
    data, xt, yt = _image_setup(n, seed)
    cfg = DFedRWConfig(m_chains=5, k_walk=5, quant=QuantConfig(bits=bits),
                       seed=seed)
    dev = DeviceModelConfig(rate_dist="uniform", base_step_time=1.0, seed=seed)
    links = LinkModelConfig(latency_s=0.05, bandwidth_bps=1e9)
    # Uniform rates + barrier rounds take ~K*(step + hop latency) virtual
    # seconds each; schedule the heal at that estimate x heal_after_rounds.
    t_heal = heal_after_rounds * cfg.k_walk * (dev.base_step_time + 2 * links.latency_s)
    schedule = [(0.0, partitioned_topology(n, 2)),
                (t_heal, make_topology("ring", n))]
    sim = SimConfig(devices=dev, links=links, deadline_s=None, **kw)
    return SimSetup(name="partition_heal", model=make_fnn((100,)), data=data,
                    topo=partitioned_topology(n, 2), cfg=cfg, sim=sim,
                    x_test=xt, y_test=yt, rounds=rounds,
                    topology_schedule=schedule)


@register_scenario(
    "overlap_async",
    "fully-asynchronous rounds: the deadline is shorter than a median "
    "chain's walk, so most chains span multiple aggregation triggers; "
    "policy='overlap' resumes them across windows (persistent event "
    "queue + anchor-column re-gather), 'partial' truncates, 'drop' discards")
def _overlap_async(n: int = 20, seed: int = 0, policy: str = "overlap",
                   rate_sigma: float = 1.25, deadline_factor: float = 0.5,
                   bits: int = 32, rounds: int = 40, **kw) -> SimSetup:
    data, xt, yt = _image_setup(n, seed)
    cfg = DFedRWConfig(m_chains=5, k_walk=5, quant=QuantConfig(bits=bits),
                       seed=seed)
    dev = DeviceModelConfig(rate_dist="lognormal", rate_sigma=rate_sigma,
                            base_step_time=1.0, seed=seed)
    # deadline_factor=0.5 gives a median-rate chain wall clock for only half
    # its K steps: nearly every chain is cut mid-walk, so the policies
    # separate — overlap finishes every walk (across ~1/deadline_factor
    # windows), partial keeps only prefixes, drop keeps nothing mid-flight.
    sim = SimConfig(devices=dev,
                    links=LinkModelConfig(latency_s=0.05, bandwidth_bps=1e9),
                    deadline_s=deadline_factor * cfg.k_walk * dev.base_step_time,
                    policy=policy, **kw)
    return SimSetup(name="overlap_async", model=make_fnn((100,)), data=data,
                    topo=make_topology("complete", n), cfg=cfg, sim=sim,
                    x_test=xt, y_test=yt, rounds=rounds)


@register_scenario(
    "congested_uplink",
    "shared-uplink contention: per-device FIFO transmit queues "
    "(LinkModelConfig(queue=True)) serialize concurrent hop hand-offs and "
    "aggregation broadcasts on a bandwidth-limited wire, so busy senders "
    "stall the chains behind them; quantization (bits=8) relieves the "
    "queueing, not just the Eq. 18 bill")
def _congested_uplink(n: int = 20, seed: int = 0, policy: str = "overlap",
                      bandwidth_bps: float = 2e6, latency_s: float = 0.02,
                      queue: bool = True, deadline_factor: float = 1.6,
                      bits: int | str = 32, rounds: int = 40,
                      m_chains: int = 8, **kw) -> SimSetup:
    data, xt, yt = _image_setup(n, seed)
    # More chains than aggregators on a complete graph: hop fan-out and the
    # per-trigger aggregation burst (every participant unicasts to each
    # aggregator listing it) collide on the senders' uplinks. An fp32 model
    # is ~2.5 Mbit on the wire, so at 2 Mbps a transfer costs ~1.3 s against
    # a 1 s step — queueing is the dominant term, and 8-bit payloads cut it
    # ~4x. bits="adaptive" installs the repro_torch.sim.adapt controller instead
    # of a static width (see the adaptive_uplink scenario for its knobs).
    bits, bits_policy = _resolve_bits(bits)
    cfg = DFedRWConfig(m_chains=m_chains, k_walk=5,
                       quant=QuantConfig(bits=bits), seed=seed)
    dev = DeviceModelConfig(rate_dist="uniform", base_step_time=1.0,
                            seed=seed)
    sim = SimConfig(devices=dev,
                    links=LinkModelConfig(latency_s=latency_s,
                                          bandwidth_bps=bandwidth_bps,
                                          queue=queue),
                    deadline_s=deadline_factor * cfg.k_walk * dev.base_step_time,
                    policy=policy, bits_policy=bits_policy, **kw)
    return SimSetup(name="congested_uplink", model=make_fnn((100,)),
                    data=data, topo=make_topology("complete", n), cfg=cfg,
                    sim=sim, x_test=xt, y_test=yt, rounds=rounds)


@register_scenario(
    "adaptive_uplink",
    "adaptive per-round quantization on the congested uplink: an "
    "AdaptiveBits controller (repro_torch.sim.adapt) walks bits up/down each "
    "window from observed FIFO-uplink queue pressure and the Eq. 18 "
    "budget — the scenario matrix for where adaptive beats static widths "
    "(knobs: widths, step_down, step_up, budget_mbits)")
def _adaptive_uplink(n: int = 20, seed: int = 0, policy: str = "overlap",
                     bandwidth_bps: float = 2e6, latency_s: float = 0.02,
                     queue: bool = True, deadline_factor: float = 1.6,
                     widths: tuple = (4, 6, 8), step_down: float = 0.15,
                     step_up: float = 0.05, budget_mbits: float | None = None,
                     rounds: int = 40, m_chains: int = 8, **kw) -> SimSetup:
    data, xt, yt = _image_setup(n, seed)
    ctl = AdaptiveBits(
        widths=tuple(widths), step_down=step_down, step_up=step_up,
        budget_bits_per_window=(None if budget_mbits is None
                                else budget_mbits * 1e6))
    # Same wall-clock world as congested_uplink so the adaptive-vs-static
    # cross compares nothing but the width policy at identical seeds.
    cfg = DFedRWConfig(m_chains=m_chains, k_walk=5,
                       quant=QuantConfig(bits=ctl.widths[-1]), seed=seed)
    dev = DeviceModelConfig(rate_dist="uniform", base_step_time=1.0,
                            seed=seed)
    sim = SimConfig(devices=dev,
                    links=LinkModelConfig(latency_s=latency_s,
                                          bandwidth_bps=bandwidth_bps,
                                          queue=queue),
                    deadline_s=deadline_factor * cfg.k_walk * dev.base_step_time,
                    policy=policy, bits_policy=ctl, **kw)
    return SimSetup(name="adaptive_uplink", model=make_fnn((100,)),
                    data=data, topo=make_topology("complete", n), cfg=cfg,
                    sim=sim, x_test=xt, y_test=yt, rounds=rounds)


@register_scenario(
    "churn_dropout",
    "device availability churn: devices go offline for whole intervals, "
    "killing walks mid-step (partial-update accounting keeps the completed "
    "prefix) and knocking out aggregators")
def _churn_dropout(n: int = 20, seed: int = 0, policy: str = "partial",
                   mean_up_s: float = 12.0, mean_down_s: float = 4.0,
                   deadline_factor: float = 1.6, bits: int = 32,
                   rounds: int = 40, **kw) -> SimSetup:
    data, xt, yt = _image_setup(n, seed)
    cfg = DFedRWConfig(m_chains=5, k_walk=5, quant=QuantConfig(bits=bits),
                       seed=seed)
    dev = DeviceModelConfig(rate_dist="uniform", base_step_time=1.0,
                            mean_up_s=mean_up_s, mean_down_s=mean_down_s,
                            seed=seed)
    sim = SimConfig(devices=dev,
                    links=LinkModelConfig(latency_s=0.05, bandwidth_bps=1e9),
                    deadline_s=deadline_factor * cfg.k_walk * dev.base_step_time,
                    policy=policy, **kw)
    return SimSetup(name="churn_dropout", model=make_fnn((100,)), data=data,
                    topo=make_topology("complete", n), cfg=cfg, sim=sim,
                    x_test=xt, y_test=yt, rounds=rounds)


# ---------------------------------------------------------- fleet scenarios


def _fleet_data(n: int, n_shards: int = 128, per_shard: int = 8):
    """Pooled-shard partition for fleet-scale n: the sample pool is O(shards),
    not O(n) — client c trains on shard ``c % n_shards`` — so a 10^5-device
    dataset costs the same memory as a 10^2-device one. 8x8 images keep the
    flat model dimension (and the (n, d_pad) device-parameter matrix) small
    enough to replicate across the whole fleet."""
    x, y = synthetic_image_classification(
        n_samples=n_shards * per_shard, image_shape=(8, 8), seed=0, noise=1.0)
    xt, yt = synthetic_image_classification(
        n_samples=256, image_shape=(8, 8), seed=1, noise=1.0)
    shard = np.arange(n_shards * per_shard, dtype=np.int64).reshape(
        n_shards, per_shard)
    client_idx = shard[np.arange(n, dtype=np.int64) % n_shards]
    data = FederatedDataset(x=x, y=y, client_idx=client_idx,
                            client_mask=np.ones_like(client_idx, dtype=bool),
                            n_clients=n)
    return data, xt, yt


@register_scenario(
    "fleet_metro",
    "fleet-scale cellular deployment on the vectorized engine: implicit "
    "metro SparseTopology (no materialized P), hierarchical "
    "device->cell->metro->backbone links with queued device uplinks, "
    "two-class device rates, slow churn — m_chains scales with n (n/10), "
    "aggregator count capped at 64 absolute")
def _fleet_metro(n: int = 20, seed: int = 0, bits: int = 8,
                 m_chains: int | None = None, k_walk: int = 8,
                 policy: str = "partial", queue: bool = True,
                 deadline_factor: float = 4.0, devices_per_cell: int = 100,
                 cells_per_metro: int = 32, rounds: int = 3,
                 **kw) -> SimSetup:
    data, xt, yt = _fleet_data(n)
    m = max(2, n // 10) if m_chains is None else m_chains
    # agg_fraction: 25% of a small fleet, but an absolute cap of 64
    # aggregators at scale — a 10^5-device round should not fan in to 25 000
    # collection points.
    cfg = DFedRWConfig(m_chains=m, k_walk=k_walk, batch_size=8,
                       agg_fraction=min(0.25, 64.0 / n), n_agg=4,
                       quant=QuantConfig(bits=bits), seed=seed)
    dev = DeviceModelConfig(rate_dist="two_class", slow_fraction=0.1,
                            slowdown=4.0, base_step_time=0.5,
                            mean_up_s=600.0, mean_down_s=60.0, seed=seed)
    links = HierLinkConfig(devices_per_cell=devices_per_cell,
                           cells_per_metro=cells_per_metro,
                           queue=queue, seed=seed)
    sim = SimConfig(engine="fleet", devices=dev, links=links,
                    deadline_s=deadline_factor * cfg.k_walk * dev.base_step_time,
                    policy=policy, **kw)
    topo = make_sparse_topology("metro", n, devices_per_cell=devices_per_cell,
                                cells_per_metro=cells_per_metro, seed=seed)
    return SimSetup(name="fleet_metro", model=make_fnn((8,), in_dim=64),
                    data=data, topo=topo, cfg=cfg, sim=sim,
                    x_test=xt, y_test=yt, rounds=rounds)


@register_scenario(
    "million_walks",
    "pure timeline stress for the fleet engine: implicit expander "
    "SparseTopology, uncontended uniform links, lognormal rates, no churn "
    "— the cheapest configuration that still exercises hop/SGD/transfer "
    "timelines, sized for n up to 10^6 with m_chains = n/10")
def _million_walks(n: int = 20, seed: int = 0, m_chains: int | None = None,
                   k_walk: int = 8, rate_sigma: float = 0.5,
                   deadline_factor: float = 3.0, bits: int = 8,
                   rounds: int = 2, **kw) -> SimSetup:
    data, xt, yt = _fleet_data(n)
    m = max(2, n // 10) if m_chains is None else m_chains
    cfg = DFedRWConfig(m_chains=m, k_walk=k_walk, batch_size=8,
                       agg_fraction=min(0.25, 64.0 / n), n_agg=4,
                       quant=QuantConfig(bits=bits), seed=seed)
    dev = DeviceModelConfig(rate_dist="lognormal", rate_sigma=rate_sigma,
                            base_step_time=0.5, seed=seed)
    sim = SimConfig(engine="fleet", devices=dev,
                    links=LinkModelConfig(latency_s=0.01, bandwidth_bps=20e6),
                    deadline_s=deadline_factor * cfg.k_walk * dev.base_step_time,
                    policy="partial", **kw)
    topo = make_sparse_topology("expander3", n, seed=seed)
    return SimSetup(name="million_walks", model=make_fnn((8,), in_dim=64),
                    data=data, topo=topo, cfg=cfg, sim=sim,
                    x_test=xt, y_test=yt, rounds=rounds)
