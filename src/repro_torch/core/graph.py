"""Communication graphs for decentralized FL (paper §III-A, §III-D).

The port's copy of ``repro.core.graph``: the undirected device graph
G = (V, E) with self-loops, the Metropolis-Hastings transition matrix
(Eq. 7), its spectral quantity lambda_P (Definition 4) and the mixing-time
bound (Lemma 2). Plain numpy, line for line the reference's arithmetic, so
the same topology name and size give identical arrays.

Two representations, one protocol: :class:`Topology` is dense (adjacency +
materialized P, exact spectra, inverse-CDF walk sampling, honest up to a
few thousand devices); :class:`SparseTopology` is the fleet-scale one (CSR
neighbor lists only, the Eq. 7 kernel realized generatively: propose a
uniform neighbor, accept with probability min{1, deg(i)/deg(j)}, mix in the
lazy self-loop). ``lambda_p``/``mixing_time`` refuse dense
eigendecompositions above ``DENSE_EIG_LIMIT``; :func:`lambda_p_power` is the
matrix-free fallback.

Topologies mirror §VI-C: complete, ring, and c-regular expander graphs.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

__all__ = [
    "Topology",
    "SparseTopology",
    "complete_graph",
    "ring_graph",
    "expander_graph",
    "star_graph",
    "erdos_renyi_graph",
    "is_connected",
    "metropolis_hastings_matrix",
    "lambda_p",
    "lambda_p_power",
    "mixing_time",
    "make_topology",
    "make_sparse_topology",
    "DENSE_EIG_LIMIT",
]

# Above this many devices a dense eigendecomposition / n x n matrix is an
# O(n^2)-memory, O(n^3)-time trap: lambda_p/mixing_time raise and name the
# power-iteration fallback instead of silently allocating.
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

    def degree(self, i: int) -> int:
        # Degree excludes the self-loop, matching deg(i) in Eq. 7.
        return int(self.adjacency[i].sum()) - 1

    @property
    def degrees(self) -> np.ndarray:
        return self.adjacency.sum(axis=1) - 1


@dataclasses.dataclass(frozen=True)
class SparseTopology:
    """Implicit fleet-scale device graph: CSR neighbor lists, generative
    Eq. 7 MH sampling, no materialized transition matrix.

    ``indptr``/``indices`` exclude self-loops (every device implicitly has
    one, as in §III-A); ``lazy`` is the identity mixture of
    :func:`metropolis_hastings_matrix`. The realized chain kernel is

        P(i, j) = (1 - lazy) * min{1/deg(i), 1/deg(j)}   for j ~ i, j != i

    with the remaining mass on the self-loop — sampled in O(1) per step per
    chain by uniform-neighbor proposal + min{1, deg(i)/deg(j)} acceptance,
    identical in distribution to the dense matrix (tests/test_graph.py
    checks the analytic row against :func:`metropolis_hastings_matrix`).

    >>> topo = make_sparse_topology("ring", 6)
    >>> topo.degrees.tolist()
    [2, 2, 2, 2, 2, 2]
    >>> sorted(topo.neighbors(0).tolist())
    [1, 5]
    """

    name: str
    n: int
    indptr: np.ndarray             # (n+1,) int64 CSR row pointers (no self)
    indices: np.ndarray            # (nnz,) int64 neighbor ids
    lazy: float = 0.1

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def degree(self, i: int) -> int:
        return int(self.indptr[i + 1] - self.indptr[i])

    def neighbors(self, i: int, include_self: bool = False) -> np.ndarray:
        nbrs = self.indices[self.indptr[i]:self.indptr[i + 1]]
        if include_self:
            return np.sort(np.append(nbrs, i))
        return nbrs.copy()

    def sample_next(self, cur: np.ndarray,
                    rng: np.random.Generator) -> np.ndarray:
        """One vectorized MH step for all chains at ``cur`` (three uniform
        draws per chain per step: lazy gate, neighbor proposal, acceptance).
        Isolated devices (degree 0) self-loop with probability 1."""
        cur = np.asarray(cur, dtype=np.int64)
        m = cur.shape[0]
        u_lazy = rng.random(m)
        u_prop = rng.random(m)
        u_acc = rng.random(m)
        deg = self.degrees
        d_cur = deg[cur]
        safe_deg = np.maximum(d_cur, 1)
        offs = np.minimum((u_prop * safe_deg).astype(np.int64), safe_deg - 1)
        prop = self.indices[self.indptr[cur] + offs]
        accept = u_acc * deg[prop] < d_cur          # u < deg(i)/deg(j)
        move = (u_lazy >= self.lazy) & (d_cur > 0) & accept
        return np.where(move, prop, cur)

    def mh_matvec(self, x: np.ndarray) -> np.ndarray:
        """y = P x for the implicit MH kernel (CSR edge weights + diagonal),
        the matrix-free operator behind :meth:`lambda_p_estimate`."""
        w, diag = self._edge_weights
        y = diag * x
        rows = np.repeat(np.arange(self.n), self.degrees)
        np.add.at(y, rows, w * x[self.indices])
        return y

    @functools.cached_property
    def _edge_weights(self) -> tuple[np.ndarray, np.ndarray]:
        deg = np.maximum(self.degrees, 1)
        rows = np.repeat(np.arange(self.n), self.degrees)
        w = (1.0 - self.lazy) * np.minimum(1.0 / deg[rows],
                                           1.0 / deg[self.indices])
        diag = 1.0 - np.bincount(rows, weights=w, minlength=self.n)
        return w, diag

    def lambda_p_estimate(self, iters: int = 300, seed: int = 0) -> float:
        """Definition 4 via matrix-free power iteration (no n x n matrix)."""
        return lambda_p_power(self.mh_matvec, n=self.n, iters=iters,
                              seed=seed)


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


def lambda_p_power(P, *, n: int | None = None, iters: int = 300,
                   seed: int = 0, tol: float = 1e-10) -> float:
    """Definition 4 via power iteration on the deflated operator, matrix-free.

    ``P`` is either a dense doubly-stochastic matrix or a callable
    ``x -> P @ x`` (pass ``n`` for the callable form). The uniform Perron
    vector is deflated analytically — B x = P x - mean(x) — and the
    iteration runs on B^2, whose dominant eigenvalue is
    max{|lambda_2|, |lambda_n|}^2 >= 0 regardless of the sign of lambda_n
    (a plain B-iteration oscillates when lambda_n < 0 dominates)."""
    if callable(P):
        if n is None:
            raise ValueError("lambda_p_power: pass n= with a callable operator")
        matvec = P
    else:
        n = P.shape[0]
        matvec = lambda x: P @ x
    if n < 2:
        return 0.5
    rng = np.random.default_rng([seed, 97])
    x = rng.standard_normal(n)
    x -= x.mean()
    x /= np.linalg.norm(x)
    second_sq = 0.0
    for _ in range(iters):
        y = matvec(x)
        y -= y.mean()
        y = matvec(y)
        y -= y.mean()
        norm = np.linalg.norm(y)
        if norm < 1e-300:
            second_sq = 0.0
            break
        y /= norm
        prev, second_sq = second_sq, float(norm)
        x = y
        if abs(second_sq - prev) <= tol * max(second_sq, 1.0):
            break
    second = float(np.sqrt(max(second_sq, 0.0)))
    return (min(second, 1.0) + 1.0) / 2.0


def mixing_time(P: np.ndarray, zeta: float = 1.0, eps: float = 1e-2,
                *, method: str = "dense",
                dense_limit: int = DENSE_EIG_LIMIT) -> int:
    """Smallest tau with zeta * lambda_P^tau <= eps (Lemma 2 bound).

    ``method="dense"`` uses the exact eigendecomposition and inherits the
    ``dense_limit`` guard of :func:`lambda_p`; ``method="power"`` uses the
    matrix-free estimate of :func:`lambda_p_power` at any size."""
    if method == "dense":
        lp = lambda_p(P, dense_limit=dense_limit)
    elif method == "power":
        lp = lambda_p_power(P)
    else:
        raise ValueError(f"mixing_time: unknown method {method!r} "
                         "(expected 'dense' or 'power')")
    if lp <= 0.0:
        return 1
    tau = int(np.ceil(np.log(eps / zeta) / np.log(lp)))
    return max(tau, 1)


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


# --------------------------------------------------------------------------
# Generative (implicit) topologies: build CSR neighbor lists directly from
# edge arrays, never touching an n x n matrix. All builders are O(n + |E|).
# --------------------------------------------------------------------------

def _csr_from_edges(n: int, src: np.ndarray, dst: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Symmetrize, dedupe, drop self-edges, and pack (src, dst) into CSR
    with each row's neighbor list sorted ascending."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    all_src = np.concatenate([src, dst])
    all_dst = np.concatenate([dst, src])
    key = all_src * n + all_dst
    uniq = np.unique(key)
    rows = uniq // n
    cols = uniq % n
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return indptr, cols


def _sparse_ring_edges(n: int) -> tuple[np.ndarray, np.ndarray]:
    i = np.arange(n, dtype=np.int64)
    return i, (i + 1) % n


def _sparse_expander_edges(n: int, c: int, seed: int
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Ring backbone + (c - 2) random circulant shifts: connected, near-regular,
    the same construction as the dense ``expander_graph`` recipe."""
    i = np.arange(n, dtype=np.int64)
    src = [i]
    dst = [(i + 1) % n]
    rng = np.random.default_rng([seed, 11])
    shifts: set[int] = set()
    while len(shifts) < max(c - 2, 0) and len(shifts) < max(n - 3, 0):
        s = int(rng.integers(2, n - 1))
        if s in shifts or (n - s) in shifts:
            continue
        shifts.add(s)
        src.append(i)
        dst.append((i + s) % n)
    return np.concatenate(src), np.concatenate(dst)


def _sparse_metro_edges(n: int, devices_per_cell: int, cells_per_metro: int,
                        seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Hierarchical fleet graph: per-cell ring + one random chord per device,
    cell gateways (device 0 of each cell) ringed within a metro, metro
    gateways ringed across the fleet. Max degree ~6, connected, and aligned
    with the hierarchical link model's device->cell->metro->backbone tiers."""
    dpc = max(int(devices_per_cell), 2)
    i = np.arange(n, dtype=np.int64)
    cell = i // dpc
    n_cells = int(cell[-1]) + 1 if n else 0
    src_l, dst_l = [], []
    # Intra-cell ring.
    start = cell * dpc
    size = np.minimum(start + dpc, n) - start
    nxt = start + (i - start + 1) % np.maximum(size, 1)
    keep = size > 1
    src_l.append(i[keep]); dst_l.append(nxt[keep])
    # Intra-cell random chords (skip size-<=2 cells where a chord is a dup).
    rng = np.random.default_rng([seed, 13])
    offs = rng.integers(2, np.maximum(size, 3))
    chord = start + (i - start + offs) % np.maximum(size, 1)
    keep = size > 2
    src_l.append(i[keep]); dst_l.append(chord[keep])
    # Cell-gateway ring within each metro.
    cells = np.arange(n_cells, dtype=np.int64)
    metro = cells // max(cells_per_metro, 1)
    n_metros = int(metro[-1]) + 1 if n_cells else 0
    m_start = metro * cells_per_metro
    m_size = np.minimum(m_start + cells_per_metro, n_cells) - m_start
    nxt_cell = m_start + (cells - m_start + 1) % np.maximum(m_size, 1)
    keep = m_size > 1
    src_l.append(cells[keep] * dpc); dst_l.append(nxt_cell[keep] * dpc)
    # Metro-gateway ring across the fleet.
    if n_metros > 1:
        metros = np.arange(n_metros, dtype=np.int64)
        src_l.append(metros * cells_per_metro * dpc)
        dst_l.append(((metros + 1) % n_metros) * cells_per_metro * dpc)
    return np.concatenate(src_l), np.concatenate(dst_l)


_SPARSE_BUILDERS = {
    "ring": lambda n, **kw: _sparse_ring_edges(n),
    "expander3": lambda n, **kw: _sparse_expander_edges(
        n, 3, kw.get("seed", 0)),
    "expander5": lambda n, **kw: _sparse_expander_edges(
        n, 5, kw.get("seed", 0)),
    "metro": lambda n, **kw: _sparse_metro_edges(
        n, kw.get("devices_per_cell", 100), kw.get("cells_per_metro", 32),
        kw.get("seed", 0)),
}


def make_sparse_topology(name: str, n: int, lazy: float = 0.1,
                         **kwargs) -> SparseTopology:
    """Build an implicit CSR topology without materializing any n x n array.

    Same MH chain law as ``make_topology`` (Eq. 7 with the default lazy=0.1
    identity mixture) but realized generatively; see :class:`SparseTopology`."""
    if n < 2:
        raise ValueError("make_sparse_topology: need n >= 2")
    if name not in _SPARSE_BUILDERS:
        raise ValueError(
            f"unknown sparse topology {name!r}; have {sorted(_SPARSE_BUILDERS)}")
    src, dst = _SPARSE_BUILDERS[name](n, **kwargs)
    indptr, indices = _csr_from_edges(n, src, dst)
    return SparseTopology(name=name, n=n, indptr=indptr, indices=indices,
                          lazy=lazy)
