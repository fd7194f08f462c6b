"""Flat parameter-buffer codec for the vectorized DFedRW round engine.

The port of ``repro.core.flatten``. The engine keeps all n device models as
ONE ``(n, d_pad)`` float32 matrix, so every protocol operation of a round is
a single 2-D tensor op.

Layout: leaves are concatenated in tree order along the last axis, each
leaf padded up to a multiple of ``LANES`` (= 128) so every leaf occupies a
whole number of 128-element rows. A payload of B models then reshapes to
``(B * rows_per_model, 128)`` with each row belonging to exactly one
(model, leaf) segment, which is what lets the fused qdq kernels apply
per-leaf adaptive grids through per-row scale operands
(repro_torch.kernels.quantize). Padding entries start at zero and stay
exactly zero through the whole protocol.

A tree is a nested dict/list/tuple of tensors (the FNN's ``[(W, b), ...]``,
the LSTM's ``{"cells": [(wx, wh, b), ...], "embed": ..., ...}``); dicts are
walked in sorted-key order, as ``jax.tree_util`` walks them, so a leaf has
the same segment of the flat vector in both packages. ``FlatSpec`` records
the nesting and the leaf shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = [
    "LANES",
    "FlatSpec",
    "make_flat_spec",
    "tree_leaves",
    "tree_from_leaves",
    "tree_map",
    "flatten_tree",
    "unflatten_tree",
    "elect_writers",
    "masked_scatter_last_wins",
]

LANES = 128


def tree_leaves(tree: Any) -> list:
    """Leaves of a nested dict/list/tuple, depth first; a dict's children
    in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def _structure(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _structure(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_structure(sub) for sub in tree)
    return None


def _rebuild(structure: Any, leaves) -> Any:
    if isinstance(structure, dict):
        return {k: _rebuild(sub, leaves) for k, sub in structure.items()}
    if isinstance(structure, (list, tuple)):
        return type(structure)(_rebuild(sub, leaves) for sub in structure)
    return next(leaves)


def tree_from_leaves(spec: "FlatSpec", leaves) -> Any:
    """The tree of ``spec``'s nesting whose leaves, in sorted-key order,
    are ``leaves``."""
    return _rebuild(spec.structure, iter(leaves))


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (with the leaves at the same places
    of each tree of ``rest``), in :func:`tree_leaves` order; the same
    nesting back."""
    leaves = [fn(*xs) for xs in zip(tree_leaves(tree), *(tree_leaves(r) for r in rest))]
    return _rebuild(_structure(tree), iter(leaves))


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Static codec between a model tree and its padded flat layout.

    shapes/sizes describe the *single-model* leaves (no batch axes);
    ``offsets[l] : offsets[l] + sizes[l]`` is leaf l's live slice of the flat
    vector, inside its 128-aligned segment of ``padded_sizes[l]`` elements.
    """

    structure: Any          # the tree's nesting, leaves replaced by None
    shapes: tuple
    sizes: tuple            # true element counts per leaf
    padded_sizes: tuple     # aligned up to a multiple of LANES
    offsets: tuple          # start of each leaf segment in the flat vector
    d: int                  # true total parameter count (wire accounting)
    d_pad: int              # flat vector length (multiple of LANES)

    @property
    def n_leaves(self) -> int:
        return len(self.shapes)

    @property
    def rows(self) -> int:
        """128-lane rows per flattened model."""
        return self.d_pad // LANES

    def row_leaf_ids(self) -> np.ndarray:
        """(rows,) int32: which leaf each 128-lane row belongs to."""
        ids = np.zeros(self.rows, dtype=np.int32)
        for leaf, (off, psize) in enumerate(zip(self.offsets, self.padded_sizes)):
            ids[off // LANES:(off + psize) // LANES] = leaf
        return ids


def make_flat_spec(template: Any) -> FlatSpec:
    """Build the codec from a single-model tree whose leaves have ``.shape``."""
    shapes = tuple(tuple(leaf.shape) for leaf in tree_leaves(template))
    sizes = tuple(int(np.prod(s)) if s else 1 for s in shapes)
    padded = tuple(-(-sz // LANES) * LANES for sz in sizes)
    offsets = tuple(int(o) for o in np.concatenate([[0], np.cumsum(padded)[:-1]]))
    return FlatSpec(
        structure=_structure(template),
        shapes=shapes,
        sizes=sizes,
        padded_sizes=padded,
        offsets=offsets,
        d=int(sum(sizes)),
        d_pad=int(sum(padded)),
    )


def flatten_tree(tree: Any, spec: FlatSpec) -> torch.Tensor:
    """Pack a tree with leaves of shape ``batch_shape + spec.shapes[l]``
    into a ``batch_shape + (d_pad,)`` tensor (zero padding between leaves)."""
    leaves = tree_leaves(tree)
    bshape = tuple(leaves[0].shape[: leaves[0].dim() - len(spec.shapes[0])])
    segs = []
    for leaf, size, psize in zip(leaves, spec.sizes, spec.padded_sizes):
        flat = leaf.reshape(bshape + (size,))
        segs.append(torch.nn.functional.pad(flat, (0, psize - size)))
    return torch.cat(segs, dim=-1)


def unflatten_tree(flat: torch.Tensor, spec: FlatSpec) -> Any:
    """Inverse of :func:`flatten_tree`; drops the padding entries. The leaves
    are views of ``flat``.

    One split into the leaf segments: its gradient is one concatenation of
    the leaves' gradients, where a slice per leaf would give each leaf's
    gradient as a zero-filled tensor of the whole flat width to be summed
    (nine of them at the LSTM's 20 M parameters a chain)."""
    bshape = tuple(flat.shape[:-1])
    segs = torch.split(flat, list(spec.padded_sizes), dim=-1)
    leaves = [
        (seg if size == psize else seg[..., :size]).reshape(bshape + shape)
        for seg, shape, size, psize in zip(segs, spec.shapes, spec.sizes,
                                           spec.padded_sizes)
    ]
    return _rebuild(spec.structure, iter(leaves))


def elect_writers(
    idx: torch.Tensor, mask: torch.Tensor, n: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Elect, per target row, the LAST active writer in sequence order.

    Returns ``(winner, wins)``: ``winner[j]`` is the index of the writer that
    owns row j (-1 if untouched) and ``wins[c]`` marks writers that own their
    row. One scatter-amax over writer priorities (inactive writers carry
    priority -1 and can never win); winners are unique per row by
    construction. ``idx`` must lie in ``[0, n)``: torch has no dropping
    scatter mode, and the engine's writers are always real devices.
    """
    m = idx.shape[0]
    order = torch.arange(m, dtype=torch.int64, device=idx.device)
    idx = idx.to(torch.int64)
    prio = torch.where(mask, order, torch.full_like(order, -1))
    winner = torch.full((n,), -1, dtype=torch.int64, device=idx.device)
    winner = winner.scatter_reduce(0, idx, prio, reduce="amax")
    wins = (winner[idx] == order) & mask
    return winner, wins


def masked_scatter_last_wins(
    buf: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor, values: torch.Tensor
) -> torch.Tensor:
    """Vectorized equivalent of the sequential masked row scatter

        for c in range(M):
            if mask[c]:
                buf[idx[c]] = values[c]

    i.e. among active writers that hit the same row, the highest index wins
    (`elect_writers`); one row copy then writes only the winners (losers
    and inactive writers are filtered out, never clamped). Out of place."""
    _, wins = elect_writers(idx, mask, buf.shape[0])
    sel = torch.nonzero(wins).reshape(-1)
    return buf.index_copy(0, idx.to(torch.int64)[sel], values[sel])
