"""Statistical & system heterogeneity models (paper §III-C, §VI-A).

- Deterministic u%-similarity partitioning: u% of each client's data comes
  from a shuffled IID pool, (100-u)% from label-sorted shards (2 shards of
  40 per client for 20 clients, as in the paper).
- Probabilistic Dirichlet partitioning Dir(alpha_d) over class proportions.
- Non-IID-nonbalance: label-imbalanced equal-size partitions.

The port's copy of ``repro.core.heterogeneity``: plain numpy, the same rng
draw order, so one seed gives identical partitions in both packages.
"""
from __future__ import annotations

import dataclasses
import numpy as np

__all__ = [
    "Partition",
    "partition_similarity",
    "partition_dirichlet",
    "partition_nonbalance",
    "delta_squared",
]


@dataclasses.dataclass(frozen=True)
class Partition:
    """client_indices[i] = indices into the global dataset owned by client i."""

    client_indices: list
    n_clients: int

    def sizes(self) -> np.ndarray:
        return np.array([len(ix) for ix in self.client_indices])

    def as_dense(self, pad_to: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Stack to (n_clients, max_size) index matrix + validity mask, padding
        by repeating each client's own indices (so padded rows resample data
        rather than injecting zeros)."""
        sizes = self.sizes()
        m = int(pad_to or sizes.max())
        idx = np.zeros((self.n_clients, m), dtype=np.int64)
        mask = np.zeros((self.n_clients, m), dtype=bool)
        for i, ix in enumerate(self.client_indices):
            ix = np.asarray(ix, dtype=np.int64)
            if len(ix) == 0:
                continue
            reps = int(np.ceil(m / len(ix)))
            idx[i] = np.tile(ix, reps)[:m]
            mask[i, : min(len(ix), m)] = True
        return idx, mask


def partition_similarity(
    labels: np.ndarray,
    n_clients: int,
    u_percent: float,
    rng: np.random.Generator,
    shards_per_client: int = 2,
) -> Partition:
    """Deterministic partitioning, paper §VI-A (1).

    u% of each client's budget is drawn from an IID pool; the rest comes from
    label-sorted shards (n_clients * shards_per_client shards total).
    u=100 is the IID setting; u=0 fully Non-IID."""
    n = len(labels)
    per_client = n // n_clients
    n_iid = int(round(per_client * u_percent / 100.0))
    n_shard_part = per_client - n_iid

    perm = rng.permutation(n)
    iid_pool = perm[: n_clients * n_iid]
    noniid_pool = perm[n_clients * n_iid :]

    # Label-sorted shards over the non-IID pool.
    noniid_sorted = noniid_pool[np.argsort(labels[noniid_pool], kind="stable")]
    n_shards = n_clients * shards_per_client
    shards = np.array_split(noniid_sorted, n_shards)
    shard_order = rng.permutation(n_shards)

    client_indices = []
    for i in range(n_clients):
        own = [iid_pool[i * n_iid : (i + 1) * n_iid]]
        for sidx in range(shards_per_client):
            shard = shards[shard_order[i * shards_per_client + sidx]]
            own.append(shard[: max(n_shard_part // shards_per_client, 1)])
        client_indices.append(np.concatenate(own))
    return Partition(client_indices=client_indices, n_clients=n_clients)


def partition_dirichlet(
    labels: np.ndarray,
    n_clients: int,
    alpha_d: float,
    rng: np.random.Generator,
    min_size: int = 8,
) -> Partition:
    """Probabilistic partitioning: p_c ~ Dir(alpha_d) over clients per class."""
    classes = np.unique(labels)
    for _ in range(100):
        buckets: list[list] = [[] for _ in range(n_clients)]
        for c in classes:
            idx_c = np.nonzero(labels == c)[0]
            rng.shuffle(idx_c)
            p = rng.dirichlet(np.full(n_clients, alpha_d))
            cuts = (np.cumsum(p) * len(idx_c)).astype(int)[:-1]
            for i, chunk in enumerate(np.split(idx_c, cuts)):
                buckets[i].extend(chunk.tolist())
        if min(len(b) for b in buckets) >= min_size:
            break
    return Partition(
        client_indices=[np.array(sorted(b)) for b in buckets], n_clients=n_clients
    )


def partition_nonbalance(
    labels: np.ndarray,
    n_clients: int,
    rng: np.random.Generator,
    max_per_label: int = 1500,
) -> Partition:
    """u=0 & nonbalance (paper Fig. 3): equal total samples per client, but
    label-imbalanced — fill each client's budget label by label, capped at
    max_per_label samples of any one label."""
    n = len(labels)
    per_client = n // n_clients
    by_label = {c: list(rng.permutation(np.nonzero(labels == c)[0])) for c in np.unique(labels)}
    label_order = list(by_label.keys())
    client_indices = []
    li = 0
    for _ in range(n_clients):
        got: list[int] = []
        while len(got) < per_client:
            lab = label_order[li % len(label_order)]
            take = min(max_per_label, per_client - len(got), len(by_label[lab]))
            if take > 0:
                got.extend(by_label[lab][:take])
                by_label[lab] = by_label[lab][take:]
            li += 1
            if all(len(v) == 0 for v in by_label.values()):
                break
        client_indices.append(np.array(got[:per_client], dtype=np.int64))
    return Partition(client_indices=client_indices, n_clients=n_clients)


def delta_squared(local_grad_sq_norms: np.ndarray, global_grad_sq_norm: float) -> float:
    """Definition 1 estimator: E_i ||∇F_i(w)||^2 / ||∇f(w)||^2 (>= 1 iff
    heterogeneous; ~1 for IID)."""
    if global_grad_sq_norm <= 0:
        return 1.0
    return float(np.mean(local_grad_sq_norms) / global_grad_sq_norm)
