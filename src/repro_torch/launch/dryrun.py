"""Multi-pod dry run: every (architecture x input shape) of the registry on
the production meshes, as a shape-only roofline for the H100 (the port of
``repro.launch.dryrun``).

The reference lowers and compiles each program on 512 virtual host devices
and reads XLA's cost and memory analyses. The port has no compiler to ask.
Its counterpart of an abstract lowering is running the port's own step
functions on **meta tensors**: shapes and dtypes, no memory, nothing
computed, no card. One rank's program runs on its blocks (rank 0 of the
mesh: every rank's blocks have the same shapes), over shape-only mesh axes
(``dist.parallel.ShapeAxis``) that return outputs of the right shapes and
count what the real collectives would move. Nothing here touches a GPU,
just as the reference never touches a TPU; this is not a CPU fallback,
since it computes nothing. A kernel entry point given meta tensors takes
its plain version, shape-only: that is the count the reference takes of its
own model, whose attention materializes the full L x L scores and whose SSD
is the ``jnp`` one.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--fed]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch grok-1-314b --shape train_4k --json out.json

The programs: ``train`` is ``dist.steps.make_train_step(cfg, mesh)`` (remat,
as ``launch.train`` takes it), ``prefill`` the reference's ``prefill_fn``
(the forward, the last position's logits), ``decode`` one lockstep step of
``make_serve_step(cfg, mesh, slots=False)``. With ``--fed`` on the
multi-pod mesh a train shape runs the gossip program alone,
``make_gossip_step`` over the pod axis (ring, ``REPRO_FED_BITS`` wide), as
the reference does; the gossip carries float32 leaves (``dist.gossip``),
where the reference's fed tree is bf16.

What a rank's roofline counts, and how it differs from the reference's:

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the program,
  which counts the products (matrix products, einsums); XLA's count has
  the element-wise ops too. Every layer runs eagerly, so the count is the
  whole depth's: there is no scan correction (``scaled_cfg`` stays, for the
  check that the count grows by one block's exactly).
- bytes: the bytes of every op's tensor inputs and outputs (views move
  nothing and are left out): the eager program's traffic with no fusion,
  an upper bound on its HBM bytes.
- memory: argument and output bytes, exact from the meta tensors; the peak
  is the arguments plus the high-water mark of the live storage the
  program creates (a storage is live from its creation until it is freed),
  leaving out cuBLAS and kernel workspaces; ``temp`` is that high-water
  mark alone.
- collectives: each shape-only axis's bytes by kind (``"model/gather"``,
  ``"data/gather"``, ``"gossip/exchange"``, ...), in place of the
  reference's ``collective_bytes(hlo_text)``: there is no HLO to parse. The
  port's sum over an axis is a gather followed by a float32 sum in rank
  order (``dist.parallel``), so it counts ``size`` times what an
  all-reduce's output counts in the reference's HLO.
- the roofline's terms divide by the H100's published peaks
  (``launch.mesh.HW``): FLOPs by ``PEAK_FLOPS_BF16`` (the production inputs
  are bf16), bytes by ``HBM_BW``, collective bytes by ``NVLINK_SEND_BW``,
  what a card sends a second over NVLink. A 16-wide model axis spans two
  8-card nodes, whose link between them is slower: there the collective
  term is a lower bound.

A decode rank holds its rows of the cache's slots and whole weights along
the data axis (``make_serve_step``'s placement); a batch of one (the
long-context shape) is whole on every data rank, where the reference splits
its sequence over the data axis.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core.flatten import tree_leaves, tree_map
from repro_torch.dist.gossip import GossipConfig
from repro_torch.dist.parallel import ShapeAxis
from repro_torch.dist.sharding import batch_specs, param_specs, shard_tree, slot_rows
from repro_torch.dist.steps import (make_gossip_step, make_serve_step, make_train_step,
                                    whole_params)
from repro_torch.launch.mesh import HW
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig

__all__ = ["SHAPES", "LONG_CTX_WINDOW", "ShapeMesh", "ShapePodMesh", "resolve_cfg",
           "optimize_cfg", "scaled_cfg", "input_specs", "build_program", "measure", "costs",
           "roofline", "model_flops_estimate", "dryrun_one", "main"]

# ------------------------------------------------------------------- shapes
SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

# Full-attention archs get an explicit sliding-window variant at long_500k;
# SSM/hybrid run natively.
LONG_CTX_WINDOW = 8192

META = torch.device("meta")


def resolve_cfg(arch_id: str, shape_name: str) -> ArchConfig:
    cfg = get_arch(arch_id)
    if shape_name == "long_500k" and cfg.has_attention and not cfg.sub_quadratic:
        cfg = cfg.with_sliding_window(LONG_CTX_WINDOW)
    return cfg


def optimize_cfg(cfg: ArchConfig, global_batch: int = 0) -> ArchConfig:
    """The reference's beyond-paper variant: grouped MoE dispatch
    (``REPRO_OPT_MOE_GS``, default 1024), batch-parallel attention where the
    head count does not divide the 16-way model axis, and bf16 scores with
    ``REPRO_OPT_BF16_SCORES``. The same fields as the reference's; the port
    reads ``moe.group_size`` and ``attn_logits_bf16``, not
    ``attn_batch_parallel``."""
    kw = {}
    if cfg.moe is not None:
        gs = int(os.environ.get("REPRO_OPT_MOE_GS", "1024"))
        kw["moe"] = dataclasses.replace(cfg.moe, group_size=gs)
    if cfg.has_attention and cfg.n_heads % 16 != 0:
        kw["attn_batch_parallel"] = True
    if cfg.has_attention and os.environ.get("REPRO_OPT_BF16_SCORES"):
        kw["attn_logits_bf16"] = True
    return dataclasses.replace(cfg, **kw) if kw else cfg


def scaled_cfg(cfg: ArchConfig, k: int) -> ArchConfig:
    """Same architecture with k blocks (and proportional encoder depth): a
    count at k = 2 and 3 extrapolates to the whole depth exactly."""
    pat = len(cfg.block_pattern)
    kwargs = dict(n_layers=pat * k)
    if cfg.enc_dec:
        enc_per_block = cfg.n_enc_layers // cfg.n_blocks
        kwargs["n_enc_layers"] = max(enc_per_block * k, 1)
    return dataclasses.replace(cfg, **kwargs)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape_name: str, fed_groups: int = 0) -> dict:
    """Meta-tensor stand-ins for every step input, the whole global batch
    (the reference's ``ShapeDtypeStruct``s): bf16 embeds, int32 tokens, and
    for decode the cache of ``T.init_cache`` on meta."""
    sh = SHAPES[shape_name]
    b, s = sh["global_batch"], sh["seq_len"]
    i32, f = torch.int32, torch.bfloat16
    if sh["kind"] in ("train", "prefill"):
        n_front = cfg.frontend_tokens if cfg.frontend != "none" else 0
        if cfg.enc_dec:
            batch = {"tokens": _meta((b, s), i32), "labels": _meta((b, s), i32),
                     "embeds": _meta((b, n_front, cfg.d_model), f)}
        elif n_front > 0:
            s_text = max(s - n_front, 1)
            batch = {"tokens": _meta((b, s_text), i32), "labels": _meta((b, s_text), i32),
                     "embeds": _meta((b, n_front, cfg.d_model), f)}
        else:
            batch = {"tokens": _meta((b, s), i32), "labels": _meta((b, s), i32)}
        if fed_groups > 1:
            if b % fed_groups:
                raise ValueError(f"global batch {b} does not split into {fed_groups} groups")
            batch = {k: _meta((fed_groups, v.shape[0] // fed_groups, *v.shape[1:]), v.dtype)
                     for k, v in batch.items()}
        return batch
    cache = T.init_cache(cfg, b, s, f, device=META,
                         enc_len=cfg.frontend_tokens if cfg.enc_dec else 0)
    return {"token": _meta((b, 1), i32), "cache": cache}


# -------------------------------------------------------------------- meshes
@dataclasses.dataclass
class ShapeMesh:
    """Rank ``rank`` of a ``(data, model)`` mesh (with a leading ``pod``
    axis of ``pods`` when > 0, which the train, prefill and decode programs
    replicate over, as the reference's do) with no devices: ``axis`` and
    ``data_axis`` are :class:`ShapeAxis` objects, what ``make_train_step``
    and ``make_serve_step`` read of a ``launch.mesh.HostMesh``."""

    data: int
    model: int
    pods: int = 0
    rank: int = 0
    device: torch.device = META

    def __post_init__(self):
        self.axis = ShapeAxis(self.rank % self.model, self.model, "model")
        self.data_axis = ShapeAxis(self.rank // self.model % self.data, self.data, "data")

    @property
    def shape(self) -> dict:
        pod = {"pod": self.pods} if self.pods else {}
        return {**pod, "data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return max(self.pods, 1) * self.data * self.model

    def axes(self) -> list[ShapeAxis]:
        return [self.axis, self.data_axis]


@dataclasses.dataclass
class ShapePodMesh:
    """Rank ``rank`` of the ``(pod, data, model)`` mesh of the DFedRW pod
    deployment with no devices: what ``make_gossip_step`` reads of a
    ``launch.mesh.PodMesh`` placed on ranks, its ``gossip_axis`` and
    ``pod_axis`` shape-only."""

    pods: int
    data: int
    model: int
    rank: int = 0
    device: torch.device = META
    group: Any = "shape-only"

    def __post_init__(self):
        pod = self.rank // (self.data * self.model)
        self.gossip_axis = ShapeAxis(pod, self.pods, "gossip")
        self.pod_axis = ShapeAxis(pod, self.pods, "pod")

    @property
    def shape(self) -> dict:
        return {"pod": self.pods, "data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.pods * self.data * self.model

    def axes(self) -> list[ShapeAxis]:
        return [self.gossip_axis, self.pod_axis]


def production_mesh(multi_pod: bool, fed: bool):
    """The reference's production mesh, (16, 16) or (2, 16, 16), shape-only."""
    if fed:
        return ShapePodMesh(2, 16, 16)
    return ShapeMesh(16, 16, pods=2 if multi_pod else 0)


# ------------------------------------------------------------------ programs
def _materialize(tree, device: torch.device):
    """A tree of meta tensors as zeros on ``device`` (meta: as it is)."""
    if device.type == "meta":
        return tree
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device), tree)


def _fresh(tree):
    """Each leaf of ``tree`` as a new meta tensor of its shape and dtype."""
    return tree_map(lambda t: _meta(t.shape, t.dtype), tree)


def build_program(cfg: ArchConfig, shape_name: str, mesh, *, fed: bool = False,
                  device: torch.device | str = META, gossip_bits: int | None = None):
    """(fn, args): one rank's program of ``shape_name`` on ``mesh`` and its
    arguments, this rank's blocks of each input (zeros on ``device``, or
    meta tensors). ``mesh`` is a :class:`ShapeMesh`/:class:`ShapePodMesh`,
    or a real ``HostMesh``/``PodMesh`` with ``device`` its rank's device
    (the same program with real collectives). ``fed`` runs the gossip
    program (a train shape on a pod mesh) at ``gossip_bits`` (default
    ``REPRO_FED_BITS``, else 32)."""
    device = torch.device(device)
    sh = SHAPES[shape_name]
    if fed:
        if sh["kind"] != "train":
            raise ValueError("fed mode gossips the train program's parameters")
        if "pod" not in mesh.shape:
            raise ValueError("fed mode gossips over the pod axis: use --multi-pod")
        bits = int(os.environ.get("REPRO_FED_BITS", "32")) if gossip_bits is None else gossip_bits
        gossip = GossipConfig(topology="ring", quant_bits=bits)
        gstep, _, _ = make_gossip_step(cfg, mesh, gossip)
        base = T.abstract_params(cfg, torch.float32)
        blocks = _fresh(shard_tree(base, param_specs(base, mesh), mesh, mesh.rank))
        shapes = [tuple(leaf.shape) for leaf in tree_leaves(blocks)]   # the gossip's leaf order

        def uniforms(li, oi, pod):
            return torch.zeros(shapes[li], device=device)

        def gossip_fn(params):
            return gstep(params, uniforms=uniforms if bits < 32 else None)

        return gossip_fn, (_materialize(blocks, device),)
    abstract = T.abstract_params(cfg)
    if sh["kind"] == "decode":
        serve_fn, p_specs = make_serve_step(cfg, mesh, slots=False)
        lo, hi = slot_rows(sh["global_batch"], mesh, mesh.rank)
        params = _fresh(shard_tree(abstract, p_specs, mesh, mesh.rank))
        cache = T.init_cache(cfg, hi - lo, sh["seq_len"], torch.bfloat16, device=META,
                             enc_len=cfg.frontend_tokens if cfg.enc_dec else 0,
                             axis=mesh.axis)
        token = _meta((hi - lo, 1), torch.int32)

        @torch.no_grad()
        def decode_fn(params, cache, token):
            return serve_fn(params, cache, token)

        return decode_fn, tuple(_materialize(t, device) for t in (params, cache, token))
    batch = input_specs(cfg, shape_name)
    b_specs = batch_specs(batch, mesh)
    local = _fresh(shard_tree(batch, b_specs, mesh, mesh.rank))
    if sh["kind"] == "prefill":
        p_specs = param_specs(abstract, mesh)

        @torch.no_grad()
        def prefill_fn(params, batch):
            whole = whole_params(params, p_specs, mesh)
            logits, _ = T.forward_train(cfg, whole, batch["tokens"], batch.get("embeds"),
                                        remat=False, axis=mesh.axis)
            return logits[:, -1, :]

        params = _fresh(shard_tree(abstract, p_specs, mesh, mesh.rank))
        return prefill_fn, (_materialize(params, device), _materialize(local, device))
    step_fn, p_specs = make_train_step(cfg, mesh)
    params = _fresh(shard_tree(abstract, p_specs, mesh, mesh.rank))

    def train_fn(params, vel, batch):
        return step_fn(params, vel, batch, 0, batch_spec=b_specs)

    return train_fn, tuple(_materialize(t, device) for t in (params, _fresh(params), local))


# ------------------------------------------------------------------ counting
def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage_bytes(tensors) -> int:
    """The bytes of the distinct storages of ``tensors``."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


class _Traffic(TorchDispatchMode):
    """Adds up the bytes of every op's tensor inputs and outputs (view ops
    move nothing and are skipped), and the high-water mark of the storage
    the ops create: a storage is live from the op that creates it until its
    last tensor is freed. Storages that existed before (the arguments) are
    not counted."""

    def __init__(self, known):
        super().__init__()
        self.bytes = 0
        self.known = {t.untyped_storage()._cdata for t in known}
        self.live: dict[int, list[int]] = {}
        self.current = 0
        self.peak = 0

    def _release(self, key: int) -> None:
        entry = self.live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.current -= entry[0]
            del self.live[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out)
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in _tensors((args, kwargs)) + outs)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.known:
                continue
            if key not in self.live:
                self.live[key] = [st.nbytes(), 0]
                self.current += st.nbytes()
                self.peak = max(self.peak, self.current)
            self.live[key][1] += 1
            weakref.finalize(t, self._release, key)
        return out


def measure(fn, args, axes) -> dict:
    """Run ``fn(*args)`` once on meta tensors under the FLOP counter and the
    traffic mode; each of ``axes`` counts its collectives from zero. Returns
    {"flops", "bytes", "coll", "calls", "memory"}."""
    for axis in axes:
        axis.stats.update(calls=0, bytes=0, seconds=0.0)
        axis.ops = {"gather": [0, 0], "exchange": [0, 0]}
    inputs = _tensors(args)
    traffic = _Traffic(inputs)
    counter = FlopCounterMode(display=False)
    with counter, traffic:
        out = fn(*args)
    outputs = _tensors(out)
    argument = _storage_bytes(inputs)
    coll, calls = {}, {}
    for axis in axes:
        for kind, (n, nbytes) in axis.ops.items():
            if n:
                coll[f"{axis.name}/{kind}"] = float(nbytes)
                calls[f"{axis.name}/{kind}"] = n
    coll["total"] = float(sum(coll.values()))
    return {
        "flops": float(counter.get_total_flops()),
        "bytes": float(traffic.bytes),
        "coll": coll,
        "calls": calls,
        "memory": {"argument": argument, "output": _storage_bytes(outputs),
                   "temp": traffic.peak, "peak": argument + traffic.peak},
    }


def costs(cfg: ArchConfig, shape_name: str, mesh, fed: bool = False) -> dict:
    """:func:`measure` of one rank's program of ``shape_name`` on the
    shape-only ``mesh`` (the whole depth: no scan correction)."""
    fn, args = build_program(cfg, shape_name, mesh, fed=fed)
    return measure(fn, args, mesh.axes())


def roofline(cost: dict, coll: dict, n_chips: int, model_flops: float) -> dict:
    """The three roofline terms (seconds) and diagnostics of one rank's
    ``cost`` ({"flops", "bytes"}) and collective bytes ``coll`` (by axis and
    kind, with their ``"total"``), on the H100's published peaks
    (``HW.PEAK_FLOPS_BF16``, ``HW.HBM_BW``, ``HW.NVLINK_SEND_BW``). The
    ``hlo_*`` keys keep the reference's names; here they hold the meta
    run's counts."""
    flops = float(cost["flops"])
    bytes_acc = float(cost["bytes"])
    compute_s = flops / HW.PEAK_FLOPS_BF16
    memory_s = bytes_acc / HW.HBM_BW
    coll_s = coll["total"] / HW.NVLINK_SEND_BW
    dominant = max([("compute", compute_s), ("memory", memory_s), ("collective", coll_s)],
                   key=lambda kv: kv[1])[0]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "dominant": dominant,
        "hlo_flops_per_chip": flops,
        "hlo_bytes_per_chip": bytes_acc,
        "collective_bytes_per_chip": coll["total"],
        "model_flops": model_flops,
        "useful_flops_ratio": model_flops / max(flops * n_chips, 1.0),
        "collectives": {k: v for k, v in coll.items() if k != "total"},
    }


def model_flops_estimate(cfg: ArchConfig, shape_name: str) -> float:
    """6*N_active*D for train (fwd+bwd), 2*N_active*D for inference."""
    sh = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if sh["kind"] == "train":
        tokens = sh["global_batch"] * sh["seq_len"]
        return 6.0 * n_active * tokens
    if sh["kind"] == "prefill":
        tokens = sh["global_batch"] * sh["seq_len"]
        return 2.0 * n_active * tokens
    tokens = sh["global_batch"]  # one token per sequence
    return 2.0 * n_active * tokens


def dryrun_one(arch_id: str, shape_name: str, *, multi_pod: bool = False,
               fed: bool = False, opt: bool = False, verbose: bool = True) -> dict:
    """One (arch, shape) on the production mesh: the reference's result
    keys, plus ``collective_calls`` (each axis's calls by kind)."""
    cfg = resolve_cfg(arch_id, shape_name)
    if opt:
        cfg = optimize_cfg(cfg, global_batch=SHAPES[shape_name]["global_batch"])
    gossip = fed and SHAPES[shape_name]["kind"] == "train"
    if fed and not multi_pod:
        raise ValueError("fed mode gossips over the pod axis: use --multi-pod")
    mesh = production_mesh(multi_pod, gossip)
    t0 = time.time()
    cc = costs(cfg, shape_name, mesh, fed=gossip)
    rl = roofline(cc, cc["coll"], mesh.size, model_flops_estimate(cfg, shape_name))
    result = {
        "arch": arch_id,
        "shape": shape_name,
        "mesh": ("2x16x16" if multi_pod else "16x16"),
        "fed": fed,
        "opt": opt,
        "sliding_window": cfg.sliding_window,
        "params_b": cfg.param_count() / 1e9,
        "active_params_b": cfg.active_param_count() / 1e9,
        "bytes_per_device": cc["memory"],
        "roofline": rl,
        "collective_calls": cc["calls"],
        "lower_compile_s": time.time() - t0,
    }
    if verbose:
        mem = result["bytes_per_device"]
        print(f"== {arch_id} x {shape_name} mesh={result['mesh']} fed={fed} "
              f"(window={cfg.sliding_window or 'full'})")
        print(f"   memory: arg={mem['argument'] / 1e9:.3f}GB "
              f"temp={mem['temp'] / 1e9:.3f}GB peak={mem['peak'] / 1e9:.3f}GB")
        print(f"   cost (meta run, whole depth): flops/chip={rl['hlo_flops_per_chip']:.3e} "
              f"bytes/chip={rl['hlo_bytes_per_chip']:.3e}")
        print(f"   collectives/chip: { {k: f'{v:.3e}' for k, v in rl['collectives'].items()} } "
              f"calls: {result['collective_calls']} (a sum over an axis counts as a gather "
              f"of every rank's part)")
        print(f"   roofline (H100 SXM5 peaks): compute={rl['compute_s'] * 1e3:.2f}ms "
              f"memory={rl['memory_s'] * 1e3:.2f}ms collective={rl['collective_s'] * 1e3:.2f}ms "
              f"-> dominant={rl['dominant']} useful_ratio={rl['useful_flops_ratio']:.3f}")
        print(f"   meta run: {result['lower_compile_s']:.1f}s", flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--fed", action="store_true", help="DFedRW gossip train step")
    ap.add_argument("--opt", action="store_true", help="beyond-paper optimized variant")
    ap.add_argument("--json", type=str, default="")
    args = ap.parse_args(argv)
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("give --arch and --shape, or --all")

    results = []
    combos = ([(a, s) for a in ARCH_IDS for s in SHAPES] if args.all
              else [(args.arch, args.shape)])
    ok = True
    for arch, shape in combos:
        try:
            results.append(dryrun_one(arch, shape, multi_pod=args.multi_pod,
                                      fed=args.fed, opt=args.opt))
        except Exception as e:  # noqa: BLE001 -- report every combo
            ok = False
            print(f"!! FAIL {arch} x {shape}: {type(e).__name__}: {e}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
