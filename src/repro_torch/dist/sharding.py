"""The path- and shape-driven sharding rules, the port of
``repro.dist.sharding``, with no import of ``jax``.

Every parameter, batch and cache leaf of the model zoo maps onto a spec over
the meshes ``("data", "model")`` (one pod) and ``("pod", "data", "model")``
(several). The rule tables (``_COL``, ``_ROW``, ``_SSM_DATA_ONLY``,
``_STACKED_ROOTS``, ``_CACHE_PREFS``) and the greedy ``_assign`` are the
reference's, rule for rule:

* stacked leading dims (the ``blocks``, ``encoder`` and ``cross`` layer
  stacks, and the federated pod stack) are never sharded;
* column-parallel (model on the output dim, data on the input dim):
  ``wq wk wv w_dkv w_uk w_uv w_gate w_up head router``; row-parallel
  (model on the input dim, data on the output dim): ``wo w_down``;
* the Mamba mixer (``in_proj out_proj conv_w`` and its cache) stays off the
  model axis;
* MoE expert stacks are expert-parallel when the model axis divides the
  expert count, else tensor-parallel inside each expert;
* ``embed`` (vocab, d) puts the model axis on the vocab, or on d when the
  vocab does not divide; 1-D leaves are replicated;
* batches take data on the batch dim (the sequence dim for a batch of 1);
  caches data on the slot dim and model on the KV heads.

A spec is a plain tuple with one entry a dimension, an axis name or
``None``: the counterpart of ``PartitionSpec``. A mesh here is anything
with axis sizes: the port's :class:`MeshShape`, a launcher's host mesh
(``launch.mesh.make_host_mesh``) or a plain ``{axis: size}`` dict, so the
rules run on the reference's production sizes with no devices at all.

In place of the reference's ``named`` (a spec tree to ``NamedSharding``s
for ``jax.device_put``): :func:`shard_tree` cuts each leaf to one rank's
block and :func:`gather_tree` puts the ranks' blocks back together.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

__all__ = [
    "MeshShape",
    "spec_for_leaf",
    "param_specs",
    "opt_specs",
    "batch_specs",
    "cache_specs",
    "cache_spec_for_leaf",
    "serve_arg_specs",
    "slot_rows",
    "model_specs",
    "shard_tree",
    "gather_tree",
    "mesh_coords",
    "block_slices",
    "zip_specs",
]

# Leaf names (last path component) keyed to their parallelism role.
_COL = frozenset(
    {"wq", "wk", "wv", "w_dkv", "w_uk", "w_uv", "w_gate", "w_up",
     "head", "router"}
)
_ROW = frozenset({"wo", "w_down"})
# The SSM mixer's leaves stay off the model axis (data/FSDP only): its fused
# channel dim is split and concatenated (z|x|B|C|dt, then x|B|C around the
# conv) at offsets that no model-axis block boundary meets, so the whole
# mixer is model-replicated and attention/FFN blocks carry the tensor
# parallelism (the reference's reason: its partitioner miscompiled such
# splits).
_SSM_DATA_ONLY = frozenset({"in_proj", "out_proj", "conv_w"})

# Param-tree roots whose leaves carry a leading stacked-layer dim.
_STACKED_ROOTS = frozenset({"blocks", "encoder", "cross"})

# Decode-cache rules: absolute dim positions (with the n_blocks stack dim at
# 0, never sharded) per leaf name, shapes as ``models.layers`` builds them.
# Head dims that RoPE splits in half and MLA's latent rank are never
# model-sharded: the model axis of a cache lives on its KV-heads dim only.
_CACHE_PREFS = {
    # (n_blocks, B, S, kv_heads, head_dim)
    "k": [("data", (1, 2)), ("model", (3,))],
    "v": [("data", (1, 2)), ("model", (3,))],
    # (n_blocks, B, S, rank)
    "c_kv": [("data", (1, 2))],
    "k_rope": [("data", (1, 2))],
    # (n_blocks, B, d_conv-1, conv_channels): the fused x|B|C channels,
    # never model-sharded
    "conv": [("data", (1,))],
    # (n_blocks, B, n_heads, head_dim, state): model-replicated with the rest
    # of the SSM mixer
    "ssm": [("data", (1,))],
}


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, with no devices: ``MeshShape(("data",
    "model"), (16, 16))``. ``shape`` is the ``{axis: size}`` dict of a JAX
    mesh's ``shape``."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def _sizes(mesh) -> dict:
    """Axis name -> size for a MeshShape, a host mesh or a plain dict."""
    return dict(mesh) if isinstance(mesh, dict) else dict(mesh.shape)


def _assign(shape, prefs, sizes) -> tuple:
    """Greedy placement: each (axis, candidate dims) pair lands on the first
    free dim the axis size divides; axes absent from the mesh are skipped."""
    spec: list = [None] * len(shape)
    for ax, cands in prefs:
        size = sizes.get(ax)
        if not size:
            continue
        for d in cands:
            if spec[d] is None and shape[d] % size == 0:
                spec[d] = ax
                break
    return tuple(spec)


def spec_for_leaf(path: str, shape: tuple, mesh, n_stack: int = 0) -> tuple:
    """The spec of one param leaf.

    path: "/"-joined tree path (e.g. "blocks/slot0/mixer/wq").
    n_stack: number of leading stacked dims (never sharded)."""
    sizes = _sizes(mesh)
    name = path.rsplit("/", 1)[-1]
    nd = len(shape)
    free = nd - n_stack
    if free <= 1:
        # Norm scales, biases, A_log/D/dt_bias, scalars: replicated.
        return (None,) * nd
    in_pos, out_pos = nd - 2, nd - 1
    if name == "embed":
        # (vocab, d): model prefers the vocab dim; odd vocabs fall back to d.
        prefs = [("model", [in_pos, out_pos]), ("data", [out_pos])]
    elif name in _SSM_DATA_ONLY:
        # Mamba mixer: model-replicated (see _SSM_DATA_ONLY); FSDP keeps the
        # matmul weights data-sharded on their non-fused dim.
        if name == "conv_w":
            return (None,) * nd
        prefs = [("data", [in_pos if name == "in_proj" else out_pos])]
    elif name in _COL or name in _ROW:
        model_first = out_pos if name in _COL else in_pos
        model_second = in_pos if name in _COL else out_pos
        data_dim = in_pos if name in _COL else out_pos
        model_pref = [model_first, model_second]
        if free == 3:
            # MoE expert stack (E, d_in, d_out): expert-parallel when the
            # model-axis size divides the expert count, else tensor-parallel
            # inside each expert.
            model_pref = [n_stack] + model_pref
        prefs = [("model", model_pref), ("data", [data_dim])]
    else:
        # Unknown >= 2-D leaf: replicate rather than guess.
        return (None,) * nd
    return _assign(shape, prefs, sizes)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict/list/tuple, the same nesting
    back; ``path`` is the tuple of keys and indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _param_spec(path, leaf, mesh) -> tuple:
    parts = [str(k) for k in path]
    n_stack = 1 if parts and parts[0] in _STACKED_ROOTS else 0
    return spec_for_leaf("/".join(parts), tuple(leaf.shape), mesh, n_stack)


def param_specs(params: Any, mesh, fed_axis: str | None = None) -> Any:
    """A spec tree mirroring ``params`` leaf for leaf.

    fed_axis: prepend this mesh axis to every spec; the specs then address
    the per-pod stacked tree ``(n_pods, *leaf.shape)`` of the federated
    steps (callers pass the unstacked tree here)."""

    def one(path, leaf):
        spec = _param_spec(path, leaf, mesh)
        return (fed_axis, *spec) if fed_axis is not None else spec

    return _map_with_path(one, params)


def opt_specs(params: Any, mesh, fed_axis: str | None = None) -> Any:
    """Specs for optimizer-state mirrors of ``params`` (momentum velocities,
    moments, float32 master copies).

    Optimizer state joins no product, so it may shard where the params
    cannot: where the param rules replicate a leaf (1-D leaves,
    indivisible dims, the SSM conv weights), the state leaf takes the
    ``data`` axis on the first dim it divides (stacked leading dims
    included). A leaf whose param spec uses a mesh axis keeps that spec, so
    the elementwise update needs no collective."""
    sizes = _sizes(mesh)

    def one(path, leaf):
        spec = _param_spec(path, leaf, mesh)
        if all(ax is None for ax in spec):
            dsize = sizes.get("data")
            if dsize:
                upgraded: list = [None] * len(leaf.shape)
                for d, dim in enumerate(leaf.shape):
                    if dim % dsize == 0:
                        upgraded[d] = "data"
                        break
                spec = tuple(upgraded)
        return (fed_axis, *spec) if fed_axis is not None else spec

    return _map_with_path(one, params)


def batch_specs(batch: Any, mesh, fed_axis: str | None = None) -> Any:
    """Batch leaves shard dim 0 over data; a batch of 1 (long context) falls
    back to the sequence dim. With ``fed_axis`` the leading federated group
    dim is sharded over that axis first."""
    sizes = _sizes(mesh)

    def one(_, leaf):
        shape = tuple(leaf.shape)
        lead: list = []
        if fed_axis is not None:
            ok = sizes.get(fed_axis) and shape and shape[0] % sizes[fed_axis] == 0
            lead = [fed_axis if ok else None]
            shape = shape[1:]
        spec: list = [None] * len(shape)
        dsize = sizes.get("data")
        if dsize and shape:
            if shape[0] % dsize == 0:
                spec[0] = "data"
            elif len(shape) > 1 and shape[1] % dsize == 0:
                spec[1] = "data"
        return (*lead, *spec)

    return _map_with_path(one, batch)


def cache_spec_for_leaf(name: str, shape: tuple, mesh) -> tuple:
    """The spec of one decode-cache leaf by its name (see
    :func:`cache_specs`)."""
    sizes = _sizes(mesh)
    shape = tuple(shape)
    if name == "enc_out":  # (B, enc_len, d)
        return _assign(shape, [("data", (0,)), ("model", (2,))], sizes)
    prefs = _CACHE_PREFS.get(name)
    if prefs is None or not shape:  # the "pos" scalar and unknown leaves
        return (None,) * len(shape)
    batch = shape[1] if len(shape) > 1 else 0
    prefs = [(ax, [d for d in dims if d < len(shape)
                   and not (ax == "data" and d == 2 and batch != 1)])
             for ax, dims in prefs]
    return _assign(shape, prefs, sizes)


def cache_specs(cache: Any, mesh) -> Any:
    """Specs for a decode cache tree (``transformer.init_cache``).

    The batch (slot) dim rides ``data``; the sequence dim is the fallback
    only for a batch of 1 (the long-context shapes): the serve engine
    writes new k/v at per-slot positions along S, and an indivisible batch
    of several slots replicates instead."""
    return _map_with_path(
        lambda path, leaf: cache_spec_for_leaf(str(path[-1]) if path else "",
                                               tuple(leaf.shape), mesh), cache)


def serve_arg_specs(args: Any, mesh) -> Any:
    """Specs for the serve engine's per-step host arrays (token (B,1),
    positions/n_valid/active/temps (B,)): the slot dim rides ``data``, as
    the cache's batch dim does, and replicates when it does not divide."""
    sizes = _sizes(mesh)

    def one(_, leaf):
        shape = tuple(leaf.shape)
        spec: list = [None] * len(shape)
        dsize = sizes.get("data")
        if dsize and shape and shape[0] % dsize == 0:
            spec[0] = "data"
        return tuple(spec)

    return _map_with_path(one, args)


def slot_rows(batch: int, mesh, rank: int) -> tuple[int, int]:
    """Rank ``rank``'s [lo, hi) of the serve engine's ``batch`` slots: its
    data rank's contiguous block of ``batch // data``, the block that
    :func:`serve_arg_specs` gives the per-step arrays' slot dim and
    :func:`cache_specs` the cache's. Where ``data`` does not divide
    ``batch`` every rank holds every slot, [0, batch). That includes
    ``batch`` = 1, where ``cache_specs`` would fall back to the sequence
    dim: that fallback is for the reference's dry-run shapes, and the serve
    engine keeps such a cache whole on every rank. The one place that
    splits the slots: the engine sizes its cache by it and cuts every
    step's arguments by it."""
    data = _sizes(mesh).get("data") or 1
    if batch % data:
        return 0, batch
    d = mesh_coords(mesh, rank).get("data", 0)
    return d * batch // data, (d + 1) * batch // data


def model_specs(specs: Any) -> Any:
    """``specs`` with every ``"data"`` entry dropped: a leaf's placement on
    the model axis alone, whole along the data axis (the serving steps'
    weights, see ``steps.make_serve_step``). A spec tree's tuples are its
    leaves."""
    if isinstance(specs, dict):
        return {k: model_specs(v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [model_specs(v) for v in specs]
    return tuple(None if ax == "data" else ax for ax in specs)


# ------------------------------------------------------------- placement
def mesh_coords(mesh, rank: int) -> dict:
    """Axis name -> this rank's index on it: ranks are laid out over the
    mesh's axes in row-major order, the last axis fastest (a JAX mesh's
    device order)."""
    sizes = _sizes(mesh)
    coords = {}
    for ax in reversed(list(sizes)):
        coords[ax] = rank % sizes[ax]
        rank //= sizes[ax]
    return coords


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _block(entry, sizes: dict, coords: dict) -> tuple[int, int]:
    """(number of blocks, this rank's block index) of a dim with spec
    ``entry``: one axis, or several, the first major."""
    n, idx = 1, 0
    for ax in _axes(entry):
        n, idx = n * sizes[ax], idx * sizes[ax] + coords[ax]
    return n, idx


def zip_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree`` with its mirroring spec tree (the
    tree's nodes decide: a leaf is never a dict, list or tuple), leaf by
    leaf in the tree's order; the same nesting back."""
    if isinstance(tree, dict):
        return {k: zip_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(zip_specs(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def block_slices(shape, spec, mesh, rank: int) -> tuple:
    """Rank ``rank``'s block of a leaf of ``shape`` placed by ``spec``: one
    slice a dim, along every dim its spec names an axis the rank's
    contiguous block of ``dim // size``."""
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} does not fit a leaf of shape {tuple(shape)}")
    sizes, coords = _sizes(mesh), mesh_coords(mesh, rank)
    index = []
    for dim, entry in zip(shape, spec):
        n, i = _block(entry, sizes, coords)
        if dim % n:
            raise ValueError(f"dim {dim} does not divide into {n} blocks (spec {spec})")
        index.append(slice(i * (dim // n), (i + 1) * (dim // n)))
    return tuple(index)


def shard_tree(tree: Any, specs: Any, mesh, rank: int | None = None) -> Any:
    """Each leaf of ``tree`` (tensors or numpy arrays) cut to rank
    ``rank``'s block (``mesh.rank`` when ``rank`` is None): along every dim
    its spec names an axis, the rank's contiguous block of ``dim // size``.
    A cut leaf comes back as a copy of its block, so the whole leaf can be
    freed; a leaf that no axis cuts comes back as it is."""
    if rank is None:
        rank = mesh.rank

    def one(leaf, spec):
        index = block_slices(leaf.shape, spec, mesh, rank)
        if all(cut == slice(0, dim) for cut, dim in zip(index, leaf.shape)):
            return leaf
        block = leaf[index]
        return block.clone() if hasattr(block, "clone") else block.copy()

    return zip_specs(one, tree, specs)


def gather_tree(blocks: list, specs: Any, mesh) -> Any:
    """The inverse of :func:`shard_tree`: ``blocks`` holds every rank's tree
    in rank order; each leaf is put back together from the ranks' blocks
    (ranks that hold the same block, along an axis the spec leaves out, are
    read once)."""
    sizes = _sizes(mesh)
    n_ranks = math.prod(sizes.values())
    if len(blocks) != n_ranks:
        raise ValueError(f"{len(blocks)} trees for a mesh of {n_ranks} ranks")
    coords = [mesh_coords(mesh, r) for r in range(n_ranks)]

    def cat(parts, dim):
        if hasattr(parts[0], "dim"):
            import torch
            return torch.cat(parts, dim)
        import numpy as np
        return np.concatenate(parts, dim)

    def assemble(spec, picks, dim):
        """The leaf from the ranks in ``picks`` (all on the same block of
        the dims before ``dim``)."""
        if dim == len(spec):
            return picks[0][1]
        n, _ = _block(spec[dim], sizes, coords[0])
        if n == 1:
            return assemble(spec, picks, dim + 1)
        parts = []
        for b in range(n):
            sub = [(r, leaf) for r, leaf in picks
                   if _block(spec[dim], sizes, coords[r])[1] == b]
            parts.append(assemble(spec, sub, dim + 1))
        return cat(parts, dim)

    def walk(trees, spec_tree):
        first = trees[0]
        if isinstance(first, dict):
            return {k: walk([t[k] for t in trees], spec_tree[k]) for k in first}
        if isinstance(first, (list, tuple)):
            return type(first)(walk([t[i] for t in trees], s)
                               for i, s in enumerate(spec_tree))
        return assemble(spec_tree, list(enumerate(trees)), 0)

    return walk(list(blocks), specs)
