"""Gossip over the pods of the DFedRW pod deployment: the port of
``repro.dist.gossip``.

Each pod holds one model replica (a "pod" in the §VI-F large-scale
picture). One gossip round is the decentralized weighted averaging of paper
Eq. 11 over a virtual topology of *offsets*: receiver i mixes the models of
senders (i + o) mod n for each topology offset o, with weights that sum to
one (doubly stochastic: the mean over the pods is preserved).
:func:`walk_permute_batch` is the random-walk hand-off: shard j travels to
j + offset.

Two placements compute the same function:

- **stacked** (``group=None``): every leaf of the tree carries a leading
  pod dimension n on one device, the reference's global view of its fed
  tree. "Receiver i takes sender (i + off) mod n" is ``torch.roll(x, -off,
  0)``.
- **group**: a ``torch.distributed`` process group of n ranks (or a
  :class:`~repro_torch.dist.parallel.MeshAxis` over one, whose counters
  then count the exchanges), one pod a rank, each holding its own pod's
  tree without the leading dimension. The permute is
  :meth:`MeshAxis.exchange`: send to (rank - off) mod n, receive from
  (rank + off) mod n. On the reference's ``(pod, data, 1)`` mesh a rank
  holds its blocks of its pod's tree (``sharding.param_specs``) and the
  group is the pod mesh's gossip group, the ranks with its data index in
  pod order (``launch.mesh.make_pod_mesh``): each rank mixes its blocks
  with the same blocks of the other pods, as the reference's ``shard_map``
  does.

Both keep the reference's order of arithmetic, ``acc = w0 * x`` and then
``acc + w * payload`` for each offset in :func:`mixing_weights` order, so
they agree bit for bit given the same uniforms.

With ``quant_bits < 32`` every transmitted payload is the Eq. 12 wire of the
reference's ``quantize``: one wire tensor per (leaf, offset, pod), the
sender's whole leaf, or its block on a mesh with a data axis (one wire
tensor per (block, leaf, offset): a data-split leaf carries one header a
data shard), with the adaptive grid ``s = max|w| / (||w|| levels)``.
Each pod's leaves are laid out as 128-lane rows (``core.flatten``), the
side information ``(s, ||w||)`` of each (pod, leaf) comes from
``payload_side_info(per_message=True)``, the sender quantizes with
``quantize_rows`` (int8 codes) and the receiver dequantizes with
``dequantize_rows``: one launch of each a gossip offset covers every leaf
of every pod. The int8 codes and one ``(s, norm)`` pair a wire tensor are
what moves between pods: in the group placement the codes of the leaves'
live elements (their 128-lane padding stays home) and one ``(s, norm)``
pair a leaf, ``64 + 8 d`` bits a wire tensor at bits 8, or the live
float32 elements at bits 32, ``32 d``: what :func:`gossip_wire_bits`
counts. Below 8 bits the wire still carries one int8 a code.

The stochastic-rounding uniforms of wire tensor (leaf li, offset oi, sender
pod) come from ``uniforms(li, oi, pod)`` (a tensor of the shape of the
rank's block of the leaf, its whole shape at data = 1; the reference salts
its key in that order, ``fold_in`` by li, oi, then the pod, and not by the
data index: a pod's data ranks draw the same uniforms for their equal
blocks), or from a ``torch.Generator`` on the device, which a pod's data
ranks seed alike (by pod). A leaf that ``param_specs`` replicates over the
data axis is then quantized whole on each data rank with the same uniforms
and stays bit-equal across them. Leaves are numbered in the reference's
sorted-key order (``core.flatten.tree_leaves``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.core.flatten import (
    LANES, FlatSpec, flatten_tree, make_flat_spec, tree_from_leaves, tree_leaves,
    unflatten_tree,
)
from repro_torch.core.quantization import wire_bits
from repro_torch.dist.parallel import MeshAxis
from repro_torch.kernels.quantize import quantize as qk
from repro_torch.kernels.quantize.ops import payload_side_info

__all__ = [
    "GossipConfig",
    "make_ring_weights",
    "make_expander_weights",
    "mixing_weights",
    "gossip_mix",
    "mix_into",
    "walk_permute_batch",
    "gossip_wire_bits",
]

Uniforms = Callable[[int, int, int], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class GossipConfig:
    """Gossip topology + wire format over the pods.

    topology: "ring" (offsets ±1), "expander" (powers of two — a circulant
    expander with log2(n) distinct offsets), or "all" (complete graph).
    quant_bits < 32 quantizes every transmitted payload (Eq. 12/13).
    every: gossip period of the federated train step (make_fed_train_step
    mixes after every `every`-th local step). The reference's ``axis``
    (its mesh axis) and ``seed`` (the key of its unquantized path) have
    nothing to name here.
    """

    topology: str = "ring"
    quant_bits: int = 32
    every: int = 1

    def offsets(self, n: int) -> list[int]:
        """Distinct non-zero shard offsets 0 < o < n of the virtual graph."""
        if n <= 1:
            return []
        if self.topology == "ring":
            return [1] if n == 2 else [1, n - 1]
        if self.topology == "all":
            return list(range(1, n))
        if self.topology == "expander":
            offs, o = [], 1
            while o < n:
                offs.append(o)
                o *= 2
            return offs
        raise ValueError(f"unknown gossip topology {self.topology!r}")


def mixing_weights(n: int, cfg: GossipConfig) -> list[tuple[int, float]]:
    """Uniform (offset, weight) pairs over {self} ∪ offsets; weights sum to 1.

    Uniform weights over a circulant offset neighborhood make the mixing
    matrix doubly stochastic, so the mean over the pods is preserved. Ring
    and "all" offset sets are closed under negation (a symmetric W); the
    powers-of-two expander set is directed — still doubly stochastic, not
    symmetric."""
    offs = cfg.offsets(n)
    w = 1.0 / (len(offs) + 1)
    return [(0, w)] + [(o, w) for o in offs]


def make_ring_weights(n: int) -> list[tuple[int, float]]:
    return mixing_weights(n, GossipConfig(topology="ring"))


def make_expander_weights(n: int, cfg: GossipConfig) -> list[tuple[int, float]]:
    return mixing_weights(n, dataclasses.replace(cfg, topology="expander"))


def gossip_wire_bits(spec: FlatSpec, n: int, cfg: GossipConfig, data: int = 1) -> int:
    """Bits that cross between the ``n`` pods in one gossip round: each of
    the ``n * data`` ranks (one a pod at data = 1) sends each leaf of its
    layout ``spec`` (its blocks on a data axis: a data-split leaf one
    header a block, a replicated leaf once a data rank) to each offset,
    ``64 + b d`` bits a wire tensor (32 d at bits 32, paper §IV-B)."""
    per_rank = sum(wire_bits(d, cfg.quant_bits) for d in spec.sizes)
    return n * data * len(cfg.offsets(n)) * per_rank


# ------------------------------------------------------------------ the wire


def _leaf_rows(spec: FlatSpec) -> tuple[list[int], list[int]]:
    """(first 128-lane row of each leaf, rows of each leaf) of one model."""
    return ([off // LANES for off in spec.offsets],
            [psize // LANES for psize in spec.padded_sizes])


def _side_info(flat: torch.Tensor, spec: FlatSpec, bits: int):
    """Per-row ``(s, ||w||)`` of a (B, d_pad) payload, one wire tensor a
    (message, leaf), and the same as (B, leaves) headers."""
    s_rows, n_rows = payload_side_info(flat, spec, per_message=True, bits=bits)
    first = torch.as_tensor(_leaf_rows(spec)[0], device=flat.device)
    b = flat.shape[0]
    return (s_rows, n_rows), (s_rows.view(b, spec.rows)[:, first],
                              n_rows.view(b, spec.rows)[:, first])


def _encode(flat, u, rows_side, bits):
    """B5: the int8 codes of a (B, d_pad) payload, (B, d_pad) int8."""
    s_rows, n_rows = rows_side
    codes = qk.quantize_rows(flat.reshape(-1, LANES), u.reshape(-1, LANES), s_rows, n_rows,
                             bits=bits)
    return codes.view(flat.shape)


def _decode(codes, s, norm, spec):
    """B6: a (B, d_pad) float32 payload from its codes and its (B, leaves)
    headers."""
    counts = torch.as_tensor(_leaf_rows(spec)[1], device=codes.device)
    s_rows = s.repeat_interleave(counts, dim=1, output_size=spec.rows).reshape(-1)
    n_rows = norm.repeat_interleave(counts, dim=1, output_size=spec.rows).reshape(-1)
    out = qk.dequantize_rows(codes.reshape(-1, LANES), s_rows, n_rows)
    return out.view(codes.shape)


def _wire_round_trip(x: torch.Tensor, bits: int, u: torch.Tensor) -> torch.Tensor:
    """The quantized wire of one tensor: deq(Q(x)) with the Eq. 12 adaptive
    grid and the uniforms ``u`` (x's shape), through B5 and B6."""
    spec = make_flat_spec(x)
    flat = flatten_tree(x.to(torch.float32), spec)[None]
    rows_side, (s, norm) = _side_info(flat, spec, bits)
    codes = _encode(flat, flatten_tree(u.to(torch.float32), spec)[None], rows_side, bits)
    return unflatten_tree(_decode(codes, s, norm, spec)[0], spec).to(x.dtype)


# ---------------------------------------------------------------- placements


def _axis(group) -> MeshAxis:
    """``group`` as the pod axis: a :class:`MeshAxis` as it is, a process
    group as a new one over its ranks."""
    if isinstance(group, MeshAxis):
        return group
    return MeshAxis(group, dist.get_rank(group), dist.get_world_size(group), "pod")


def _live(spec: FlatSpec) -> list[tuple[int, int]]:
    """[start, end) of each leaf's live elements in the padded layout."""
    return [(off, off + size) for off, size in zip(spec.offsets, spec.sizes)]


def _pack(x: torch.Tensor, spec: FlatSpec) -> torch.Tensor:
    """The live elements of a (1, d_pad) payload, (1, d): what crosses."""
    return torch.cat([x[:, lo:hi] for lo, hi in _live(spec)], 1)


def _unpack(x: torch.Tensor, spec: FlatSpec) -> torch.Tensor:
    """A (1, d) payload back in the padded layout, zeros in the padding."""
    out = x.new_zeros((x.shape[0], spec.d_pad))
    start = 0
    for lo, hi in _live(spec):
        out[:, lo:hi] = x[:, start:start + hi - lo]
        start += hi - lo
    return out


def _uniforms(spec, pods, oi, uniforms, generator, device) -> torch.Tensor:
    """(len(pods), d_pad) float32 uniforms of offset ``oi`` for the sending
    ``pods``, laid out as their payload."""
    if generator is not None:
        return torch.rand((len(pods), spec.d_pad), generator=generator, device=device)
    leaves = [torch.stack([uniforms(li, oi, p).to(device=device, dtype=torch.float32)
                           .reshape(shape) for p in pods])
              for li, shape in enumerate(spec.shapes)]
    return flatten_tree(leaves, spec)


def _mix_flat(flat: torch.Tensor, spec: FlatSpec, cfg: GossipConfig, group,
              uniforms: Uniforms | None, generator: torch.Generator | None) -> torch.Tensor:
    """One gossip round on the (B, d_pad) payload of this process's pods
    (all n stacked, or this rank's one): the mixed payload, a new tensor."""
    if group is None:
        n = flat.shape[0]
        pods = list(range(n))
    else:
        axis = _axis(group)
        n, pods = axis.size, [axis.rank]
    bits = cfg.quant_bits
    quantized = bits < 32
    if quantized and uniforms is None and generator is None:
        raise ValueError("gossip_mix with quant_bits < 32 requires uniforms or a generator")
    if quantized:           # one header a (pod, leaf), the same for every offset
        rows_side, (s, norm) = _side_info(flat, spec, bits)
    pairs = mixing_weights(n, cfg)
    acc = torch.mul(flat, pairs[0][1])
    for oi, (off, w) in enumerate(pairs[1:]):
        message = (flat,)
        if quantized:
            u = _uniforms(spec, pods, oi, uniforms, generator, flat.device)
            message = (_encode(flat, u, rows_side, bits), s, norm)
            del u
        if group is None:       # receiver i takes the message of sender (i + off) mod n
            message = [t.roll(-off, 0) for t in message]
        else:                   # the live elements cross, and the headers
            message = axis.exchange([_pack(message[0], spec), *message[1:]],
                                    (pods[0] - off) % n, (pods[0] + off) % n)
            message = [_unpack(message[0], spec), *message[1:]]
        payload = _decode(*message, spec) if quantized else message[0]
        del message             # each offset's temporaries go before the next's
        acc.add_(payload.mul_(w))
        del payload
    return acc


def _mixed(tree: Any, cfg: GossipConfig, group, uniforms, generator):
    """(one pod's layout, the mixed payload as a tree of views of it, the
    tree's leaves)."""
    stacked = group is None
    leaves = tree_leaves(tree)
    for leaf in leaves:
        if leaf.dtype != torch.float32:
            raise TypeError(f"gossip_mix carries float32 leaves, got {leaf.dtype}")
    nesting = make_flat_spec(tree)
    spec = make_flat_spec(tree_from_leaves(
        nesting, [leaf[0] if stacked else leaf for leaf in leaves]))
    flat = flatten_tree(tree, spec)
    acc = _mix_flat(flat if stacked else flat[None], spec, cfg, group, uniforms, generator)
    return spec, unflatten_tree(acc if stacked else acc[0], spec), leaves


@torch.no_grad()
def gossip_mix(tree: Any, cfg: GossipConfig, *, group=None,
               uniforms: Uniforms | None = None,
               generator: torch.Generator | None = None) -> Any:
    """One decentralized averaging round (Eq. 11) over the pods: receiver i
    gets sum_{(o, w)} w * model_{(i+o) mod n}; a new tree of contiguous
    float32 leaves.

    ``group=None``: the stacked placement, every leaf ``(n, ...)`` on one
    device. Otherwise ``group`` is a ``torch.distributed`` process group of
    n ranks (or a ``MeshAxis`` over one) and ``tree`` is this rank's pod, or
    its blocks of the pod's tree on a pod mesh with a data axis. With
    ``cfg.quant_bits < 32`` every transmitted payload goes through the Eq.
    12 wire (B5 quantizes, B6 dequantizes), its uniforms from
    ``uniforms(li, oi, pod)`` or ``generator``: one of the two is then
    required."""
    spec, mixed, _ = _mixed(tree, cfg, group, uniforms, generator)
    return tree_from_leaves(spec, [leaf.contiguous() for leaf in tree_leaves(mixed)])


@torch.no_grad()
def mix_into(tree: Any, cfg: GossipConfig, *, group=None,
             uniforms: Uniforms | None = None,
             generator: torch.Generator | None = None) -> Any:
    """:func:`gossip_mix` written over ``tree``'s own leaves, so that the
    federated step's parameters stay where they are; returns ``tree``."""
    _, mixed, leaves = _mixed(tree, cfg, group, uniforms, generator)
    for leaf, new in zip(leaves, tree_leaves(mixed)):
        leaf.copy_(new)
    return tree


@torch.no_grad()
def walk_permute_batch(tree: Any, n_or_group, offset: int = 1) -> Any:
    """Move every pod's tensors one walk hop: receiver i takes the shard of
    (i - offset) mod n (shard j travels to j + offset). ``n_or_group`` is
    the pod count of a stacked tree (leaves ``(n, ...)``), or a process
    group (or ``MeshAxis``) whose ranks hold one pod each: on a pod mesh
    with a data axis, its gossip group, whose ranks hold their blocks of
    their pods, each moved to pod + offset at the same data index; a new
    tree."""
    leaves = tree_leaves(tree)
    if isinstance(n_or_group, int):
        for leaf in leaves:
            if leaf.shape[0] != n_or_group:
                raise ValueError(f"a stacked leaf of shape {tuple(leaf.shape)} has no "
                                 f"leading pod dimension {n_or_group}")
        moved = [leaf.roll(offset, 0) for leaf in leaves]
    else:
        axis = _axis(n_or_group)
        n, me = axis.size, axis.rank
        moved = axis.exchange(leaves, (me + offset) % n, (me - offset) % n)
    return tree_from_leaves(make_flat_spec(tree), moved)
