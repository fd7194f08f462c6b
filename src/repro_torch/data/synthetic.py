"""Deterministic synthetic image data standing in for MNIST (the port's copy
of ``repro.data.synthetic``; plain numpy, so one seed gives identical
arrays in both packages).

- `synthetic_image_classification`: class-conditional images with a fixed
  per-class template + Gaussian noise, 28x28 grayscale, 10 classes -- same
  shape/cardinality as MNIST.
- `FederatedDataset`: the global arrays plus the dense per-client index
  matrix the round engine samples batches from.

The Reddit stand-in (``synthetic_token_stream``) comes with the LSTM slice
(ROADMAP.md, queue A).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["synthetic_image_classification", "FederatedDataset"]


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
