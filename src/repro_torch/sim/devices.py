"""Per-device wall-clock compute-rate and availability/churn models.

System heterogeneity in the synchronous engine is *pre-drawn* chain lengths
(core.walk.StragglerModel); here it is a wall-clock phenomenon: device ``d``
takes ``base_step_time / rate[d]`` seconds of virtual time per local SGD
step, and a renewal availability process takes it offline for whole
intervals. Deadlines, overlap, and dropout then *emerge* from the event
timeline instead of being sampled.

Rate distributions (all with median ~1 so ``base_step_time`` stays the
median step cost):

* ``uniform``    — every device at rate 1.0 (the parity configuration).
* ``lognormal``  — ``exp(N(0, sigma))``; heavy left tail of slow devices,
                   the classic device-capability spread of DFL surveys.
* ``pareto``     — step-time multiplier ``1 + Pareto(alpha)``; the extreme
                   straggler tail regime.
* ``two_class``  — the paper's §VI-A h%: a fixed fraction of devices is
                   ``slowdown``x slower.

Churn is an alternating up/down renewal process per device (exponential
sojourns, mean ``mean_up_s`` / ``mean_down_s``), generated lazily along the
virtual timeline and deterministic per (seed, device). Devices start up.

Fleet scale
-----------
All churn state is allocated lazily per *touched* device (a 10^6-device
fleet whose round only visits 10^4 devices pays for 10^4 traces), traces
grow in batched chunks (``_CHURN_CHUNK`` intervals per RNG call, via one
``standard_exponential`` draw — bit-identical to the one-interval-at-a-time
stream, just a longer prefix of it), and the ``*_many`` query methods
answer whole device vectors from a padded boundary matrix with zero Python
per-device work after the traces exist. The scalar methods remain the
reference semantics; the vectorized ones are exact replicas of them.
"""
from __future__ import annotations

import bisect
import dataclasses
import math

import numpy as np

__all__ = ["DeviceModelConfig", "DeviceFleet"]

_RATE_DISTS = ("uniform", "lognormal", "pareto", "two_class")

# Churn intervals generated per RNG call when a trace needs growing.
_CHURN_CHUNK = 16


@dataclasses.dataclass(frozen=True)
class DeviceModelConfig:
    base_step_time: float = 1.0      # seconds per local SGD step at rate 1.0
    rate_dist: str = "uniform"
    rate_sigma: float = 1.0          # lognormal sigma
    pareto_alpha: float = 1.5        # pareto tail index (smaller = heavier)
    slow_fraction: float = 0.0       # two_class: fraction of slow devices
    slowdown: float = 5.0            # two_class: slow-device step-time factor
    mean_up_s: float = math.inf      # churn: mean up sojourn (inf = no churn)
    mean_down_s: float = 0.0         # churn: mean down sojourn
    rate_clip: float = 0.0           # clip rates into [1/c, c] (0 = off); the
                                     # fleet engine's bucket width is set by
                                     # the fastest device, so unbounded
                                     # lognormal tails want a clip
    seed: int = 0

    @property
    def has_churn(self) -> bool:
        return math.isfinite(self.mean_up_s) and self.mean_down_s > 0.0


class DeviceFleet:
    """n devices with fixed compute rates and lazily-generated churn traces.

    >>> fleet = DeviceFleet(2, DeviceModelConfig())   # uniform, no churn
    >>> fleet.step_time(0)                            # base_step_time / rate
    1.0
    >>> fleet.is_up(0, 1e9), fleet.avail_at(0, 5.0)   # always available
    (True, 5.0)
    >>> slow = DeviceFleet(4, DeviceModelConfig(rate_dist="two_class",
    ...                                         slow_fraction=1.0,
    ...                                         slowdown=4.0))
    >>> slow.step_time(0)                             # 4x slower everywhere
    4.0
    """

    def __init__(self, n: int, cfg: DeviceModelConfig):
        if cfg.rate_dist not in _RATE_DISTS:
            raise ValueError(f"unknown rate_dist {cfg.rate_dist!r}; have {_RATE_DISTS}")
        self.n = n
        self.cfg = cfg
        rng = np.random.default_rng([cfg.seed, 0])
        if cfg.rate_dist == "uniform":
            rates = np.ones(n)
        elif cfg.rate_dist == "lognormal":
            rates = np.exp(rng.normal(0.0, cfg.rate_sigma, size=n))
        elif cfg.rate_dist == "pareto":
            rates = 1.0 / (1.0 + rng.pareto(cfg.pareto_alpha, size=n))
        else:  # two_class
            rates = np.ones(n)
            n_slow = int(round(n * cfg.slow_fraction))
            if n_slow > 0:
                slow = rng.choice(n, size=n_slow, replace=False)
                rates[slow] = 1.0 / cfg.slowdown
        if cfg.rate_clip > 0.0:
            c = float(cfg.rate_clip)
            rates = np.clip(rates, 1.0 / c, c)
        self.rates = rates
        # Churn traces: per touched device, sorted alternating boundary times
        # [down0, up0, down1, up1, ...] (device is down on [down_i, up_i)),
        # extended on demand to cover queried times. Lazy dicts — untouched
        # devices cost nothing at fleet scale.
        self._bounds: dict[int, list[float]] = {}
        self._frontier = np.zeros(n)
        self._churn_rngs: dict[int, np.random.Generator] = {}
        # Padded boundary matrix backing the *_many queries, rebuilt lazily
        # whenever any trace grows.
        self._pad_dirty = True
        self._pad_keys = np.empty(0, dtype=np.int64)
        self._pad = np.empty((0, 1))

    # ------------------------------------------------------------- compute
    def step_time(self, device: int) -> float:
        """Virtual seconds device ``device`` needs for one local SGD step."""
        return self.cfg.base_step_time / float(self.rates[device])

    def step_times(self, devices: np.ndarray) -> np.ndarray:
        """Vectorized ``step_time`` (identical float semantics: f64 scalar
        division and numpy f64 array division agree bitwise)."""
        return self.cfg.base_step_time / self.rates[devices]

    @property
    def min_step_time(self) -> float:
        """The fastest device's step time — the fleet engine's compute
        contribution to its bucket width."""
        return self.cfg.base_step_time / float(self.rates.max())

    # --------------------------------------------------------------- churn
    def _bounds_of(self, device: int) -> list[float]:
        b = self._bounds.get(device)
        if b is None:
            b = self._bounds[device] = []
        return b

    def _rng_of(self, device: int) -> np.random.Generator:
        rng = self._churn_rngs.get(device)
        if rng is None:
            rng = self._churn_rngs[device] = np.random.default_rng(
                [self.cfg.seed, 1, device])
        return rng

    def _extend(self, device: int, t: float) -> None:
        """Grow the churn trace until it covers time ``t`` plus one interval.

        Draws ``_CHURN_CHUNK`` up/down interval pairs per RNG call:
        ``rng.exponential(scale)`` consumes the exact same underlying stream
        as ``scale * rng.standard_exponential()``, and the running sum is
        accumulated with a prepended-frontier cumsum, so the boundary values
        are bit-identical to the historical one-pair-at-a-time loop — the
        trace is simply materialized further ahead."""
        cfg = self.cfg
        if not cfg.has_churn:
            self._frontier[device] = math.inf
            return
        rng = self._rng_of(device)
        bounds = self._bounds_of(device)
        grew = False
        while self._frontier[device] <= t:
            gaps = rng.standard_exponential(2 * _CHURN_CHUNK)
            gaps[0::2] *= cfg.mean_up_s
            gaps[1::2] *= cfg.mean_down_s
            new = np.cumsum(np.concatenate(([self._frontier[device]], gaps)))[1:]
            bounds.extend(new.tolist())
            self._frontier[device] = bounds[-1]
            grew = True
        if grew:
            self._pad_dirty = True

    def is_up(self, device: int, t: float) -> bool:
        self._extend(device, t)
        # odd count of boundaries <= t means inside a [down, up) interval
        return bisect.bisect_right(self._bounds_of(device), t) % 2 == 0

    def avail_at(self, device: int, t: float) -> float:
        """Earliest instant >= t at which the device is up (t itself if up)."""
        self._extend(device, t)
        bounds = self._bounds_of(device)
        i = bisect.bisect_right(bounds, t)
        return t if i % 2 == 0 else bounds[i]

    def down_during(self, device: int, t0: float, t1: float) -> float | None:
        """First down transition inside [t0, t1), or None. Callers use this
        to kill a local step in flight when its device churns out mid-step
        (the paper's partial-update accounting keeps the chain's completed
        prefix). bisect_right keeps the boundary convention of
        ``is_up``/``avail_at``: at an up-boundary instant the device IS up
        (a chain resuming exactly when its device returns must survive)."""
        self._extend(device, t1)
        bounds = self._bounds_of(device)
        i = bisect.bisect_right(bounds, t0)
        if i % 2 == 1:  # already down at t0
            return t0
        if i < len(bounds) and bounds[i] < t1:
            return bounds[i]
        return None

    # ----------------------------------------------------- vectorized churn
    def extend_many(self, devices: np.ndarray, t: np.ndarray | float) -> None:
        """Ensure every trace in ``devices`` covers its query time."""
        if not self.cfg.has_churn:
            return
        devices = np.asarray(devices, dtype=np.int64)
        t = np.broadcast_to(np.asarray(t, dtype=np.float64), devices.shape)
        need = self._frontier[devices] <= t
        if not need.any():
            return
        devs, inv = np.unique(devices[need], return_inverse=True)
        tmax = np.zeros(devs.shape[0])
        np.maximum.at(tmax, inv, t[need])
        for d, td in zip(devs.tolist(), tmax.tolist()):
            self._extend(d, td)

    def _pad_view(self) -> tuple[np.ndarray, np.ndarray]:
        """(sorted touched-device ids, (U, L+1) boundary matrix padded with
        +inf). Rebuilt only after a trace has grown."""
        if self._pad_dirty:
            keys = np.array(sorted(self._bounds), dtype=np.int64)
            width = max((len(self._bounds[d]) for d in keys.tolist()),
                        default=0)
            pad = np.full((keys.shape[0], width + 1), np.inf)
            for r, d in enumerate(keys.tolist()):
                b = self._bounds[d]
                pad[r, :len(b)] = b
            self._pad_keys, self._pad = keys, pad
            self._pad_dirty = False
        return self._pad_keys, self._pad

    def _boundary_counts(self, devices: np.ndarray, t: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray]:
        """(rows, counts): per query, the trace row and the number of
        boundaries <= t — the vectorized twin of ``bisect.bisect_right``."""
        keys, pad = self._pad_view()
        rows = np.searchsorted(keys, devices)
        counts = (pad[rows] <= t[:, None]).sum(axis=1)
        return rows, counts

    def is_up_many(self, devices: np.ndarray,
                   t: np.ndarray | float) -> np.ndarray:
        """Vectorized ``is_up`` over parallel (device, time) vectors."""
        devices = np.asarray(devices, dtype=np.int64)
        if not self.cfg.has_churn:
            return np.ones(devices.shape[0], dtype=bool)
        t = np.broadcast_to(
            np.asarray(t, dtype=np.float64), devices.shape).copy()
        self.extend_many(devices, t)
        _, counts = self._boundary_counts(devices, t)
        return counts % 2 == 0

    def avail_at_many(self, devices: np.ndarray,
                      t: np.ndarray) -> np.ndarray:
        """Vectorized ``avail_at`` over parallel (device, time) vectors."""
        devices = np.asarray(devices, dtype=np.int64)
        t = np.asarray(t, dtype=np.float64)
        if not self.cfg.has_churn:
            return t.copy()
        self.extend_many(devices, t)
        rows, counts = self._boundary_counts(devices, t)
        _, pad = self._pad_view()
        up = pad[rows, counts]
        return np.where(counts % 2 == 1, up, t)

    def down_in_many(self, devices: np.ndarray, t0: np.ndarray,
                     t1: np.ndarray) -> np.ndarray:
        """Vectorized ``down_during(...) is not None`` over parallel
        (device, t0, t1) vectors: True where the device is down at t0 or
        transitions down before t1."""
        devices = np.asarray(devices, dtype=np.int64)
        t0 = np.asarray(t0, dtype=np.float64)
        t1 = np.asarray(t1, dtype=np.float64)
        if not self.cfg.has_churn:
            return np.zeros(devices.shape[0], dtype=bool)
        self.extend_many(devices, t1)
        rows, counts = self._boundary_counts(devices, t0)
        _, pad = self._pad_view()
        return (counts % 2 == 1) | (pad[rows, counts] < t1)
