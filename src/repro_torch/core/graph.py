"""Communication graphs for decentralized FL (paper §III-A, §III-D).

The port's copy of the dense half of ``repro.core.graph``: the undirected
device graph G = (V, E) with self-loops, the Metropolis-Hastings transition
matrix (Eq. 7) and its spectral quantity lambda_P (Definition 4). Plain
numpy, line for line the reference's arithmetic, so the same topology name
and size give identical arrays. The implicit fleet-scale ``SparseTopology``
belongs to the simulator slice and is not ported yet (ROADMAP.md, queue A).

Topologies mirror §VI-C: complete, ring, and c-regular expander graphs.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

__all__ = [
    "Topology",
    "complete_graph",
    "ring_graph",
    "expander_graph",
    "star_graph",
    "erdos_renyi_graph",
    "is_connected",
    "metropolis_hastings_matrix",
    "lambda_p",
    "make_topology",
    "DENSE_EIG_LIMIT",
]

# Above this many devices a dense eigendecomposition / n x n matrix is an
# O(n^2)-memory, O(n^3)-time trap: lambda_p raises instead of allocating.
DENSE_EIG_LIMIT = 2048


@dataclasses.dataclass(frozen=True)
class Topology:
    """A device communication graph plus its random-walk transition matrix."""

    name: str
    adjacency: np.ndarray          # (n, n) bool, symmetric, self-loops on diag
    transition: np.ndarray         # (n, n) MH transition matrix P (Eq. 7)
    lambda_p: float                # Definition 4
    n: int

    @functools.cached_property
    def csr(self) -> tuple[np.ndarray, np.ndarray]:
        """CSR neighbor lists (indptr, indices), self-loops EXCLUDED."""
        adj = self.adjacency.copy()
        np.fill_diagonal(adj, False)
        rows, cols = np.nonzero(adj)
        indptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows, minlength=self.n), out=indptr[1:])
        return indptr, cols

    @functools.cached_property
    def csr_with_self(self) -> tuple[np.ndarray, np.ndarray]:
        """CSR over adjacency rows *including* the diagonal self-loop."""
        rows, cols = np.nonzero(self.adjacency)
        indptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows, minlength=self.n), out=indptr[1:])
        return indptr, cols

    @functools.cached_property
    def transition_cdf(self) -> np.ndarray:
        """Row-wise CDF of P, cached for the inverse-CDF walk sampler."""
        return np.cumsum(self.transition, axis=1)

    def neighbors(self, i: int, include_self: bool = False) -> np.ndarray:
        indptr, indices = self.csr_with_self if include_self else self.csr
        return indices[indptr[i]:indptr[i + 1]].copy()


def _with_self_loops(adj: np.ndarray) -> np.ndarray:
    adj = adj.astype(bool)
    adj |= adj.T
    np.fill_diagonal(adj, True)
    return adj


def complete_graph(n: int) -> np.ndarray:
    return _with_self_loops(np.ones((n, n), dtype=bool))


def ring_graph(n: int) -> np.ndarray:
    adj = np.zeros((n, n), dtype=bool)
    idx = np.arange(n)
    adj[idx, (idx + 1) % n] = True
    adj[idx, (idx - 1) % n] = True
    return _with_self_loops(adj)


def expander_graph(n: int, c: int, seed: int = 0) -> np.ndarray:
    """c-regular expander built from c/2 random circulant shifts (c even) or
    union of random perfect matchings (c odd). Deterministic given
    (n, c, seed)."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((n, n), dtype=bool)
    idx = np.arange(n)
    # Start from a ring to guarantee connectivity, then add random shifts.
    adj[idx, (idx + 1) % n] = True
    shifts_needed = max(0, (c - 2 + 1) // 2)
    used = {1, n - 1}
    for _ in range(shifts_needed):
        choices = [s for s in range(2, n - 1) if s not in used]
        if not choices:
            break
        s = int(rng.choice(choices))
        used.add(s)
        used.add(n - s)
        adj[idx, (idx + s) % n] = True
    return _with_self_loops(adj)


def star_graph(n: int) -> np.ndarray:
    """Centralized topology (FedAvg's implicit graph) — for baselines."""
    adj = np.zeros((n, n), dtype=bool)
    adj[0, :] = True
    adj[:, 0] = True
    return _with_self_loops(adj)


def is_connected(adjacency: np.ndarray) -> bool:
    """True iff the graph has one component (self-loops/direction ignored)."""
    adj = adjacency.astype(bool)
    adj |= adj.T
    reach = np.zeros(adj.shape[0], dtype=bool)
    reach[0] = True
    while True:
        new = reach | (adj @ reach)
        if (new == reach).all():
            return bool(reach.all())
        reach = new


def erdos_renyi_graph(n: int, p: float, seed: int = 0, max_tries: int = 200) -> np.ndarray:
    """G(n, p) draw, resampled until connected. Deterministic given
    (n, p, seed); raises when no connected draw appears within
    ``max_tries``."""
    for t in range(max_tries):
        rng = np.random.default_rng([seed, t])
        adj = _with_self_loops(np.triu(rng.random((n, n)) < p, 1))
        if is_connected(adj):
            return adj
    raise ValueError(
        f"no connected G(n={n}, p={p}) draw in {max_tries} tries; "
        f"p is likely below the ln(n)/n ~ {np.log(max(n, 2)) / max(n, 1):.3f} "
        "connectivity threshold"
    )


def metropolis_hastings_matrix(adjacency: np.ndarray, lazy: float = 0.1) -> np.ndarray:
    """Eq. 7: MH transition matrix with acceptance a(i,j)=min{1, deg(i)/deg(j)},
    i.e. P(i,j) = min{1/deg(i), 1/deg(j)} for j != i (symmetric, doubly
    stochastic). ``lazy`` mixes in an identity component
    P <- (1-lazy) P + lazy I, which keeps the chain aperiodic (Assumption 3)."""
    adj = adjacency.astype(bool)
    n = adj.shape[0]
    deg = adj.sum(axis=1) - 1  # exclude self-loop
    P = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        nbrs = np.nonzero(adj[i])[0]
        nbrs = nbrs[nbrs != i]
        for j in nbrs:
            P[i, j] = min(1.0 / max(deg[i], 1), 1.0 / max(deg[j], 1))
        P[i, i] = 1.0 - P[i].sum()
    if lazy > 0.0:
        P = (1.0 - lazy) * P + lazy * np.eye(n)
    if np.any(P < -1e-12) or not np.allclose(P.sum(axis=1), 1.0):
        raise ValueError("MH matrix must be non-negative with rows summing to 1")
    return P


def lambda_p(P: np.ndarray, *, dense_limit: int = DENSE_EIG_LIMIT) -> float:
    """Definition 4: lambda_P = (max{|lambda_2|, |lambda_n|} + 1) / 2."""
    n = P.shape[0]
    if n > dense_limit:
        raise ValueError(
            f"lambda_p: dense eigendecomposition of a {n}x{n} transition "
            f"matrix exceeds dense_limit={dense_limit}"
        )
    eigs = np.linalg.eigvals(P)
    eigs = np.sort(np.abs(eigs))[::-1]
    second = eigs[1] if len(eigs) > 1 else 0.0
    return float((second + 1.0) / 2.0)


_BUILDERS = {
    "complete": lambda n, **kw: complete_graph(n),
    "ring": lambda n, **kw: ring_graph(n),
    "expander3": lambda n, **kw: expander_graph(n, 3, seed=kw.get("seed", 0)),
    "expander5": lambda n, **kw: expander_graph(n, 5, seed=kw.get("seed", 0)),
    "star": lambda n, **kw: star_graph(n),
    "erdos_renyi": lambda n, **kw: erdos_renyi_graph(
        n, kw.get("p", 0.3), seed=kw.get("seed", 0)
    ),
}


def make_topology(name: str, n: int, **kwargs) -> Topology:
    if name not in _BUILDERS:
        raise ValueError(f"unknown topology {name!r}; have {sorted(_BUILDERS)}")
    adj = _BUILDERS[name](n, **kwargs)
    P = metropolis_hastings_matrix(adj)
    return Topology(name=name, adjacency=adj, transition=P, lambda_p=lambda_p(P), n=n)
