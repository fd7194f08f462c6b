"""Random-walk trajectory machinery (paper §III-D, Alg. 1 lines 3-9).

Samples M parallel Metropolis-Hastings random-walk chains over the device
graph and models system heterogeneity as variable chain lengths K_m
(the paper's straggler-tolerant partial walks, §VI-A "system heterogeneity").

The port's copy of ``repro.core.walk``: plain numpy that consumes the
protocol rng in the reference's order, for dense and implicit topologies
alike, so one seed gives identical plans in both packages.
"""
from __future__ import annotations

import dataclasses
import numpy as np

from repro_torch.core.graph import SparseTopology, Topology

__all__ = [
    "WalkPlan",
    "ChainResume",
    "sample_walks",
    "StragglerModel",
    "gamma_inexactness",
]


@dataclasses.dataclass(frozen=True)
class ChainResume:
    """Cut-state of walk chains at an aggregation trigger.

    The fully-asynchronous simulator (repro_torch.sim, ``policy="overlap"``) lets a
    chain span multiple aggregation triggers: when a trigger fires, the chain
    contributes the prefix of steps it completed *this window* (Eq. 11/14
    partial updates) and then keeps walking instead of being discarded. The
    runner's internal slot planner holds the full resumable state (remaining
    trajectory + batch indices + pending events); this record is the public
    summary it attaches to the executed window's :class:`WalkPlan` — the
    round records, recorded traces and tests read chain liveness, lifetime
    progress and anchors from here.

    live:   (M,) bool  — chain still in flight after the trigger (it neither
                          finished its K_m steps nor was churn-killed).
    k_done: (M,) int32 — steps completed over the chain's whole life so far.
    anchor: (M,) int32 — device whose row holds each chain's current model:
                          the device of its last completed step, i.e. the row
                          the w^{t,last} scatter wrote (a trigger therefore
                          "refreshes" a resumed chain with whatever that row
                          holds after aggregation — see repro_torch.sim.runner).
    """

    live: np.ndarray
    k_done: np.ndarray
    anchor: np.ndarray

    @property
    def n_live(self) -> int:
        return int(self.live.sum())


@dataclasses.dataclass(frozen=True)
class WalkPlan:
    """One communication round's worth of random-walk trajectories.

    devices: (M, K_max) int32 — device visited at step k of chain m.
    mask:    (M, K_max) bool  — True where the chain performs step k. The
        synchronous planner emits *prefix* masks (chain m performs its first
        K_m <= K_max steps); the asynchronous simulator's *window views* may
        mask out column 0 — a resumed chain's leading column is its anchor
        device, a pure re-gather of the model it left there, not a step.
    k_m:     (M,) int32       — number of executed steps (= mask.sum(1)).
    last_device: (M,) int32   — device holding w^{t,last} of each chain.
    timestamps: (M, K_max) f64 | None — virtual-time completion instant of
        each hop's local step, filled in by the discrete-event simulator
        (repro_torch.sim); NaN where the step never executed. The synchronous
        engine leaves it None.
    resume: ChainResume | None — live state of chains spanning past this
        plan's trigger (repro_torch.sim ``policy="overlap"``); None everywhere
        else.
    """

    devices: np.ndarray
    mask: np.ndarray
    k_m: np.ndarray
    timestamps: np.ndarray | None = None
    resume: ChainResume | None = None

    @property
    def last_device(self) -> np.ndarray:
        """Device of each chain's last *executed* step (mask-general: window
        views may lead with a masked anchor column). Chains with no executed
        step fall back to their column-0 device."""
        m = self.devices.shape[0]
        any_active = self.mask.any(axis=1)
        last = self.k_max - 1 - np.argmax(self.mask[:, ::-1], axis=1)
        idx = np.where(any_active, last, 0)
        return self.devices[np.arange(m), idx]

    @property
    def m(self) -> int:
        return self.devices.shape[0]

    @property
    def k_max(self) -> int:
        return self.devices.shape[1]

    def truncated(
        self, k_new: np.ndarray, timestamps: np.ndarray | None = None
    ) -> "WalkPlan":
        """Deadline/churn truncation hook: the same trajectories, cut to
        ``min(k_m, k_new)`` completed steps per chain (k_new may be 0 — a
        chain that never finished a step contributes nothing). The truncated
        plan feeds Eq. 18 comm accounting and the Eq. 11/14 partial-update
        aggregation exactly like a straggler-shortened walk."""
        k_m = np.minimum(self.k_m, np.asarray(k_new, dtype=np.int32))
        k_m = np.maximum(k_m, 0).astype(np.int32)
        mask = np.arange(self.k_max)[None, :] < k_m[:, None]
        return WalkPlan(
            devices=self.devices,
            mask=mask,
            k_m=k_m,
            timestamps=self.timestamps if timestamps is None else timestamps,
        )


@dataclasses.dataclass(frozen=True)
class StragglerModel:
    """System heterogeneity h% (paper §III-C, §VI-A): a FIXED h% of devices
    are persistently slow (hardware/battery/network capability), with epoch
    cost `slowdown`x a fast device's. A global clock budgets each round at
    K fast-epochs; a random-walk chain stops when its cumulative cost along
    the visited devices exceeds the budget -- the paper's variable K_m
    partial walks. Baselines instead *drop* any selected slow device (it
    cannot finish E local epochs inside the clock), which is exactly the
    sampling bias the paper criticizes.

    gamma-inexactness view (Def. 2 / Lemma 1): a slow device has larger
    gamma_i, so chains through slow devices realize fewer effective updates.
    """

    h_percent: float = 0.0
    slowdown: float = 5.0
    seed: int = 1234
    mode: str = "partial"  # "partial": slow devices do 1/slowdown of the batch
                           #            within the clock (paper: "integrating
                           #            partial contributions from stragglers")
                           # "truncate": budget-based variable K_m chains

    def slow_mask(self, n: int) -> np.ndarray:
        """Deterministic fixed slow-device set."""
        n_slow = int(round(n * self.h_percent / 100.0))
        mask = np.zeros(n, dtype=bool)
        if n_slow > 0:
            rng = np.random.default_rng(self.seed)
            mask[rng.choice(n, size=n_slow, replace=False)] = True
        return mask

    def chain_lengths(self, devices: np.ndarray, k: int, n: int) -> np.ndarray:
        """K_m per chain: steps completable within a budget of k fast-epochs,
        where steps on slow devices cost `slowdown`."""
        m = devices.shape[0]
        if self.h_percent <= 0 or self.mode == "partial":
            return np.full(m, k, dtype=np.int32)
        slow = self.slow_mask(n)
        cost = np.where(slow[devices], self.slowdown, 1.0)  # (M, K)
        cum = np.cumsum(cost, axis=1)
        k_m = (cum <= float(k)).sum(axis=1).astype(np.int32)
        return np.maximum(k_m, 1)  # every chain contributes at least one step


def sample_walks(
    topo: Topology | SparseTopology,
    m: int,
    k: int,
    rng: np.random.Generator,
    straggler: StragglerModel | None = None,
    start_devices: np.ndarray | None = None,
) -> WalkPlan:
    """Sample M MH random-walk chains of (variable) length <= K.

    Start devices are uniform over V (Alg. 1 line 3) unless given (the
    large-scale LM experiment chains rounds: i_m^{t,0} = i_m^{t-1,last}).

    Accepts either representation: a dense :class:`Topology` steps by
    inverse-CDF over cached transition rows (RNG-stream-identical to the
    original per-call ``np.cumsum`` path), an implicit
    :class:`SparseTopology` steps via its generative proposal/acceptance
    kernel (same chain law, different — but deterministic — stream)."""
    if start_devices is None:
        start = rng.integers(0, topo.n, size=m)
    else:
        start = np.asarray(start_devices, dtype=np.int64) % topo.n
    devices = np.zeros((m, k), dtype=np.int32)
    n = topo.n
    cur = start.astype(np.int64)
    if getattr(topo, "transition", None) is None:
        # Implicit SparseTopology: generative MH kernel, no CDF rows to
        # gather — one vectorized proposal/acceptance step for all M chains.
        for step in range(k):
            devices[:, step] = cur
            cur = topo.sample_next(cur, rng)
    else:
        cdf = topo.transition_cdf
        # All M chains advance together: one uniform draw per step, one
        # inverse-CDF lookup on the M gathered kernel rows (vectorized
        # searchsorted: count of cdf entries <= u, which includes the
        # self-loop mass).
        for step in range(k):
            devices[:, step] = cur
            u = rng.random(m)
            cur = np.minimum((cdf[cur] <= u[:, None]).sum(axis=1), n - 1)
    k_m = (
        straggler.chain_lengths(devices, k, topo.n)
        if straggler is not None
        else np.full(m, k, dtype=np.int32)
    )
    mask = np.arange(k)[None, :] < k_m[:, None]
    return WalkPlan(devices=devices, mask=mask, k_m=k_m)


def gamma_inexactness(grad_norm_end: float, grad_norm_start: float) -> float:
    """Empirical gamma-hat of Lemma 1: ||∇F(w^k)|| / ||∇F(w^{k-K})||, the
    realized inexactness of one random-walk trajectory."""
    if grad_norm_start <= 0.0:
        return 1.0
    return float(grad_norm_end / grad_norm_start)
