"""Random-walk trajectory machinery (paper §III-D, Alg. 1 lines 3-9).

The port's copy of ``repro.core.walk`` for dense topologies: M parallel
Metropolis-Hastings chains over the device graph, with system heterogeneity
modelled as variable chain lengths K_m. Plain numpy that consumes the
protocol rng in the reference's order, so one seed gives identical plans.
The simulator's resumable-chain state (``ChainResume``) and plan
truncation wait for the simulator slice (ROADMAP.md, queue A).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import Topology

__all__ = ["WalkPlan", "sample_walks", "StragglerModel"]


@dataclasses.dataclass(frozen=True)
class WalkPlan:
    """One communication round's worth of random-walk trajectories.

    devices: (M, K_max) int32 — device visited at step k of chain m.
    mask:    (M, K_max) bool  — True where the chain performs step k.
    k_m:     (M,) int32       — number of executed steps (= mask.sum(1)).
    last_device: (M,) int32   — device holding w^{t,last} of each chain.
    """

    devices: np.ndarray
    mask: np.ndarray
    k_m: np.ndarray

    @property
    def last_device(self) -> np.ndarray:
        """Device of each chain's last *executed* step; chains with no
        executed step fall back to their column-0 device."""
        m = self.devices.shape[0]
        any_active = self.mask.any(axis=1)
        last = self.k_max - 1 - np.argmax(self.mask[:, ::-1], axis=1)
        idx = np.where(any_active, last, 0)
        return self.devices[np.arange(m), idx]

    @property
    def k_max(self) -> int:
        return self.devices.shape[1]


@dataclasses.dataclass(frozen=True)
class StragglerModel:
    """System heterogeneity h% (paper §III-C, §VI-A): a FIXED h% of devices
    are persistently slow, with epoch cost `slowdown`x a fast device's.
    ``mode="partial"``: slow devices process 1/slowdown of the batch within
    the clock; ``mode="truncate"``: budget-based variable K_m chains."""

    h_percent: float = 0.0
    slowdown: float = 5.0
    seed: int = 1234
    mode: str = "partial"

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
    topo: Topology,
    m: int,
    k: int,
    rng: np.random.Generator,
    straggler: StragglerModel | None = None,
    start_devices: np.ndarray | None = None,
) -> WalkPlan:
    """Sample M MH random-walk chains of (variable) length <= K.

    Start devices are uniform over V (Alg. 1 line 3) unless given: chain
    mode (§VI-F) starts each chain where it ended, i_m^{t,0} =
    i_m^{t-1,last}, and then draws no start. Chains step by inverse-CDF over
    the cached transition rows: one uniform draw per step for all M
    chains."""
    if start_devices is None:
        start = rng.integers(0, topo.n, size=m)
    else:
        start = np.asarray(start_devices, dtype=np.int64) % topo.n
    devices = np.zeros((m, k), dtype=np.int32)
    n = topo.n
    cur = start.astype(np.int64)
    cdf = topo.transition_cdf
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

