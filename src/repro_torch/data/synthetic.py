"""Deterministic synthetic image data standing in for MNIST (the port's copy
of ``repro.data.synthetic``; plain numpy, so one seed gives identical
arrays in both packages).

- `synthetic_image_classification`: class-conditional images with a fixed
  per-class template + Gaussian noise, 28x28 grayscale, 10 classes -- same
  shape/cardinality as MNIST.
- `synthetic_token_stream`: per-client next-word sequences with a skewed
  vocabulary, the stand-in for the paper's Reddit data (§VI-F).
- `FederatedDataset`: the global arrays plus the dense per-client index
  matrix the round engine samples batches from.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["synthetic_image_classification", "synthetic_token_stream", "FederatedDataset"]


@dataclasses.dataclass(frozen=True)
class FederatedDataset:
    """Global arrays + per-client dense index matrix (n_clients, m) + mask."""

    x: np.ndarray            # (N, ...) features
    y: np.ndarray            # (N,) labels
    client_idx: np.ndarray   # (n_clients, m) int64
    client_mask: np.ndarray  # (n_clients, m) bool
    n_clients: int

    @property
    def client_sizes(self) -> np.ndarray:
        return self.client_mask.sum(axis=1)

    def client_batch(
        self, client: int, batch_size: int, rng: np.random.Generator
    ) -> tuple[np.ndarray, np.ndarray]:
        """``batch_size`` samples of ``client``'s index row, drawn with
        replacement from ``rng`` as the reference draws them."""
        row = self.client_idx[client]
        take = rng.integers(0, row.shape[0], size=batch_size)
        sel = row[take]
        return self.x[sel], self.y[sel]

    @classmethod
    def from_partition(cls, x, y, part) -> "FederatedDataset":
        """part: repro_torch.core.heterogeneity.Partition (duck-typed to avoid
        a data->core import cycle)."""
        idx, mask = part.as_dense()
        return cls(x=x, y=y, client_idx=idx, client_mask=mask, n_clients=part.n_clients)


def synthetic_image_classification(
    n_samples: int = 12000,
    n_classes: int = 10,
    image_shape: tuple[int, int] = (28, 28),
    noise: float = 0.35,
    seed: int = 0,
    template_seed: int = 42,
) -> tuple[np.ndarray, np.ndarray]:
    """Class-conditional Gaussian images: x = template[y] + noise*N(0,1).

    Templates are smooth random fields (low-freq) so nearby pixels correlate
    like real digits; flattened dim = 784 matching the paper's FNN input.
    `template_seed` fixes the class templates so differently-seeded draws
    (e.g. train vs IID test split) share the same class structure."""
    trng = np.random.default_rng(template_seed)
    rng = np.random.default_rng(seed)
    h, w = image_shape
    # Low-frequency class templates: upsampled 7x7 random grids.
    small = trng.normal(0.0, 1.0, size=(n_classes, h // 4, w // 4))
    templates = np.kron(small, np.ones((4, 4)))[:, :h, :w]
    templates = templates / np.abs(templates).max(axis=(1, 2), keepdims=True)
    y = rng.integers(0, n_classes, size=n_samples)
    x = templates[y] + noise * rng.normal(0.0, 1.0, size=(n_samples, h, w))
    return x.astype(np.float32), y.astype(np.int64)


def synthetic_token_stream(
    n_clients: int = 64,
    seq_len: int = 20,
    seqs_per_client: int = 64,
    vocab: int = 1000,
    client_vocab: int = 120,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-client LM data with vocabulary skew (natural Non-IID, like Reddit
    users). Token t+1 = (a_c * t + b_c) mod client_vocab mapped into the
    client's preferred vocab slice, + occasional global tokens — a learnable
    structured sequence per client.

    Returns (tokens, next_tokens, client_of_seq):
      tokens      (n_clients*seqs_per_client, seq_len) int32
      next        (n_clients*seqs_per_client, seq_len) int32
      client_of   (n_clients*seqs_per_client,) int32
    """
    rng = np.random.default_rng(seed)
    xs, ys, cs = [], [], []
    for c in range(n_clients):
        base = int(rng.integers(0, max(vocab - client_vocab, 1)))
        a = int(rng.integers(1, 7))
        b = int(rng.integers(0, client_vocab))
        t0 = rng.integers(0, client_vocab, size=seqs_per_client)
        seq = np.zeros((seqs_per_client, seq_len + 1), dtype=np.int64)
        seq[:, 0] = t0
        for t in range(seq_len):
            seq[:, t + 1] = (a * seq[:, t] + b) % client_vocab
        toks = (seq + base) % vocab
        xs.append(toks[:, :-1])
        ys.append(toks[:, 1:])
        cs.append(np.full(seqs_per_client, c))
    return (
        np.concatenate(xs).astype(np.int32),
        np.concatenate(ys).astype(np.int32),
        np.concatenate(cs).astype(np.int32),
    )
