"""Training launcher (the port of ``repro.launch.train``).

``protocol`` runs the paper's federated protocol (``--algo dfedrw``:
DFedRW/QDFedRW) or one of its baselines (``--algo fedavg|dfedavg|dsgd``) on
synthetic federated data, on the card unless ``--device cpu`` is given;
``--checkpoint-dir`` saves the accuracy history at step ``--rounds``.
``--obs PATH`` records a ``repro_torch.obs`` telemetry stream of a
``dfedrw`` run (per-round engine spans and Eq. 18 bits on the wall clock);
``--trace`` marks it trace-capable, as the reference does.

``pod`` trains one LM of the registry (``--arch``, ``--smoke`` for its
SMOKE configuration) for ``--steps`` steps of ``dist.make_train_step``
(gradient, ``decreasing_lr(step + 1, r=--lr_r)``, momentum SGD at 0.9,
remat) on batches of ``--batch`` x ``--seq`` tokens drawn from
``np.random.default_rng(0)`` as the reference's ``pod_main`` draws them (and
stub frontend embeddings N(0, 1) for a model with a frontend), from weights
drawn on the device by a seeded generator. It prints a ``step i loss=...``
line a step, then ``done``. Under ``torchrun`` (``WORLD_SIZE`` > 1) it
trains data-parallel, as the reference trains on a data axis over every
device: a ``(data=world, model=1)`` mesh, ``dist.make_train_step(cfg,
mesh)``, every rank keeping its blocks of the weights (``param_specs``),
the velocity (``opt_specs``) and each global batch (``batch_specs``). Rank
0 prints the same lines with the global batch's loss; every rank prints its
backend, mesh and device, a ``timing`` JSON line and the digest of its
gathered parameters, equal on every rank.

``pod --fed`` runs the DFedRW pod deployment (``dist.make_fed_train_step``,
float32, no remat): one model initialised and copied to G pods with zero
velocities, a local step a pod on its own batch (drawn with a leading pod
dimension from the same stream), and gossip averaging over ``--topology``
every ``--gossip-every`` steps, quantized through the int8 wire kernels at
``--bits < 32``. Without ``torchrun`` the ``--pods`` pods stack on the one
device. Under ``torchrun`` the ranks form the reference's ``(pods, W //
pods, 1)`` mesh (``--pods`` 0: one pod a rank; a ``--pods`` that does not
divide the ranks raises ValueError): each pod trains data-parallel over
its data ranks, and the pods gossip between the ranks that hold the same
data index, each rank's blocks a wire tensor each; every rank draws every
pod's batch to keep its rows, and prints a ``timing`` line and the digest
of its pod's parameters.

Under ``torchrun`` the ranks join one process group
(``launch.mesh.join_torchrun``): NCCL when every rank has a card of its
own, gloo when ranks share a card (NCCL refuses two ranks on one device)
and on the CPU.
It prints a line a step and the final inter-pod spread of the first leaf
(in the reference's sorted-key order).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train protocol --algo dfedrw --rounds 100
  PYTHONPATH=src python -m repro_torch.launch.train protocol --bits 8 --device cpu --rounds 2
  PYTHONPATH=src python -m repro_torch.launch.train protocol --bits 8 --device cpu --rounds 2 \
      --obs /tmp/obs.jsonl --trace
  PYTHONPATH=src python -m repro_torch.launch.train protocol --algo dfedavg --bits 8 \
      --device cpu --rounds 2 --checkpoint-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train pod --arch mamba2-130m --smoke \
      --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train pod --arch mamba2-130m --batch 8 \
      --seq 2048 --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train pod --arch mamba2-130m --smoke --fed \
      --pods 4 --bits 8 --gossip-every 2 --steps 3 --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train pod \
      --arch mamba2-130m --smoke --fed --bits 8 --steps 3 --device cpu
  PYTHONPATH=src OMP_NUM_THREADS=1 torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      pod --arch mamba2-130m --smoke --fed --pods 2 --bits 8 --steps 3 --device cpu
  PYTHONPATH=src OMP_NUM_THREADS=1 torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      pod --arch mamba2-130m --smoke --steps 2 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def protocol_main(args) -> None:
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.core import (
        DSGD, BaselineConfig, DFedAvg, DFedRW, DFedRWConfig, FedAvg, QuantConfig,
        StragglerModel, make_topology, train_loop,
    )
    from repro_torch.core.heterogeneity import partition_similarity
    from repro_torch.data import FederatedDataset, synthetic_image_classification
    from repro_torch.models import make_fnn

    x, y = synthetic_image_classification(n_samples=8000, seed=0, noise=2.0)
    xt, yt = synthetic_image_classification(n_samples=1000, seed=1, noise=2.0)
    part = partition_similarity(y, args.devices, args.u, np.random.default_rng(7))
    data = FederatedDataset.from_partition(x, y, part)
    topo = make_topology(args.topology, args.devices)
    model = make_fnn((200, 200))
    strag = StragglerModel(h_percent=args.h)
    quant = QuantConfig(bits=args.bits)
    if args.algo == "dfedrw":
        runner = DFedRW(model, data, topo, DFedRWConfig(
            m_chains=args.chains, k_walk=args.epochs, straggler=strag, quant=quant),
            device=args.device)
    else:
        cls = {"fedavg": FedAvg, "dfedavg": DFedAvg, "dsgd": DSGD}[args.algo]
        runner = cls(model, data, topo, BaselineConfig(
            n_selected=args.devices if args.algo != "fedavg" else args.chains,
            local_epochs=args.epochs, straggler=strag, quant=quant),
            device=args.device)

    rec = None
    if args.trace and not args.obs:
        raise SystemExit("--trace requires --obs (it augments the obs "
                         "stream with tspan events)")
    if args.obs:
        if not hasattr(runner, "attach_obs"):
            raise SystemExit(f"--obs: --algo {args.algo} exposes no telemetry "
                             f"hooks (supported: dfedrw)")
        from repro_torch.obs import Recorder
        # wall clock: per-round engine spans + Eq. 18 bits. --trace marks the
        # stream trace-capable; the protocol engine itself emits no tspans
        # (causal span trees come from the simulator's timelines).
        rec = Recorder(trace=args.trace)
        runner.attach_obs(rec)

    def cb(r, metrics, evald):
        print(f"round {r+1:4d}  loss={metrics.train_loss:.4f} "
              f"acc={evald['accuracy']:.4f} busiest_mb={metrics.comm_bits_busiest_round/8e6:.2f}")

    hist = train_loop(runner, args.rounds, xt, yt,
                      eval_every=max(args.rounds // 20, 1), callback=cb)
    print(f"final: {hist.final()}")
    if rec is not None:
        from repro_torch.obs import provenance
        rec.save(args.obs, provenance=provenance(config=vars(args), device=args.device),
                 workload="train", algo=args.algo)
        print(f"obs: wrote {args.obs} "
              f"(report: python tools/obs_report.py {args.obs})")
    if args.checkpoint_dir:
        save_checkpoint(args.checkpoint_dir, args.rounds,
                        {"history_acc": np.array(hist.test_accuracy)})
        print(f"checkpointed to {args.checkpoint_dir}")


def pod_main(args) -> None:
    import os

    import torch

    from repro_torch.configs import get_arch, get_smoke
    from repro_torch.device import resolve_device
    from repro_torch.dist.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import momentum_init

    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    dev = resolve_device(args.device)
    backend = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:       # under torchrun
        from repro_torch.launch.mesh import join_torchrun

        dev, backend = join_torchrun(dev)
    rng = np.random.default_rng(0)
    b, s = args.batch, args.seq

    def make_batch(lead=()):
        toks = rng.integers(0, cfg.vocab, size=(*lead, b, s + 1))
        batch = {"tokens": torch.as_tensor(toks[..., :-1], device=dev),
                 "labels": torch.as_tensor(toks[..., 1:], device=dev)}
        if cfg.frontend != "none":
            batch["embeds"] = torch.as_tensor(rng.normal(
                size=(*lead, b, cfg.frontend_tokens, cfg.d_model)), dtype=torch.float32,
                device=dev)
        return batch

    if args.fed:
        import torch.distributed as dist

        fed_pod_main(args, cfg, dev, dist.group.WORLD if backend else None, make_batch,
                     backend)
    elif backend:
        data_pod_main(args, cfg, dev, backend, make_batch)
    else:
        step_fn = make_train_step(cfg, lr_r=args.lr_r)
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        vel = momentum_init(params).velocity
        for step in range(args.steps):
            t0 = time.time()
            params, vel, loss = step_fn(params, vel, make_batch(), step)
            print(f"step {step:3d} loss={float(loss):.4f} ({time.time()-t0:.2f}s)")
        print("done")


def data_pod_main(args, cfg, dev, backend, make_batch) -> None:
    """pod under torchrun: data-parallel training on a ``(data=world,
    model=1)`` mesh (``dist.make_train_step(cfg, mesh)``), as the reference
    trains on ``make_host_mesh(data=len(jax.devices()))``. Every rank draws
    the same weights and the same global batches and keeps its blocks
    (parameters by ``param_specs``, velocity by ``opt_specs``, batch by
    ``batch_specs``). Rank 0 prints the reference's lines; every rank its
    backend, mesh and device, a ``timing`` JSON line (ms a step, the data
    collectives' calls, ms and bytes a step, peak memory, the kernels'
    launches, each step's loss at full precision) and the digest of its
    gathered parameters, which must be equal on every rank."""
    import json

    import torch
    import torch.distributed as dist

    from repro_torch.convert import shard_lm_params, shard_opt_state
    from repro_torch.dist.sharding import batch_specs, shard_tree
    from repro_torch.dist.steps import make_train_step, whole_params
    from repro_torch.kernels.block_attn import block_attn as ba
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import momentum_init

    mesh = make_host_mesh(data=dist.get_world_size(), device=dev, group=dist.group.WORLD)
    data, cuda = mesh.data_axis, dev.type == "cuda"
    _say_all(mesh.rank, f"backend={backend} mesh={mesh.shape} device={dev}")
    step_fn, p_specs = make_train_step(cfg, mesh, lr_r=args.lr_r)
    whole = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    vel = shard_opt_state(momentum_init(whole).velocity, mesh, dev)
    params = shard_lm_params(whole, p_specs, mesh, dev)
    del whole
    ba.reset_launch_counts()
    sk.reset_launch_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    timing = {"rank": mesh.rank, "backend": backend, "device": str(dev), "ms": [],
              "collectives": [], "losses": []}
    for step in range(args.steps):
        batch = make_batch()
        b_spec = batch_specs(batch, mesh)
        batch = shard_tree(batch, b_spec, mesh)
        if cuda:
            torch.cuda.synchronize(dev)
        before = dict(data.stats)
        t0 = time.perf_counter()
        params, vel, loss = step_fn(params, vel, batch, step, batch_spec=b_spec)
        loss = float(loss)
        if cuda:
            torch.cuda.synchronize(dev)
        timing["ms"].append((time.perf_counter() - t0) * 1e3)
        timing["collectives"].append(_since(data, before))
        timing["losses"].append(loss)
        if mesh.rank == 0:
            print(f"step {step:3d} loss={loss:.4f} ({timing['ms'][-1] / 1e3:.2f}s)", flush=True)
    timing["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda else None
    timing["launches"] = {**ba.LAUNCHES, **ba.BWD_LAUNCHES, **sk.LAUNCHES, **sk.BWD_LAUNCHES}
    _say_all(mesh.rank, f"timing {json.dumps(timing)}")
    digest = _agreed_digest(whole_params(params, p_specs, mesh), data, mesh.rank)
    _say_all(mesh.rank, f"digest={digest} (equal on all {mesh.size} ranks)")
    if mesh.rank == 0:
        print("done", flush=True)
    dist.barrier()
    dist.destroy_process_group()


def fed_pod_main(args, cfg, dev, group, make_batch, backend=None) -> None:
    """pod --fed: the DFedRW pod deployment, G pods stacked on one device or
    the ranks of ``group`` (under torchrun) as the reference's ``(pods, W //
    pods, 1)`` mesh (``launch.mesh.make_pod_mesh``; one pod a rank at
    ``--pods`` 0 or W). Every rank draws every pod's tokens and keeps its
    pod's rows, cut by ``batch_specs`` over the pod's data ranks; draws the
    weights and keeps its blocks (``param_specs``; the velocity by
    ``opt_specs``); and seeds the gossip's uniforms by its pod, so that a
    pod's data ranks quantize alike. Rank 0 prints the reference's lines
    (the mode, a loss a step, the inter-pod spread of leaf 0 gathered whole
    over both groups); every rank in a group prints its backend, mesh and
    place, a ``timing`` JSON line (ms a step, the data axis's and the
    gossip's calls, ms and bytes a step, peak memory, the launches of B5,
    B6, B9, B9b and B10, each step's loss at full precision) and the digest
    of its pod's gathered parameters, which must be equal on the pod's data
    ranks."""
    import torch

    from repro_torch.convert import stack_pods
    from repro_torch.core.flatten import tree_leaves
    from repro_torch.dist.gossip import GossipConfig
    from repro_torch.dist.steps import make_fed_train_step
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import momentum_init

    mesh = make_pod_mesh(args.pods, device=dev, group=group)
    g = mesh.pods
    gossip = GossipConfig(topology=args.topology, every=args.gossip_every,
                          quant_bits=args.bits)
    step_fn, _, _ = make_fed_train_step(cfg, mesh, gossip, lr_r=args.lr_r, remat=False)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    wire = torch.Generator(device=dev).manual_seed(1 + mesh.pod)     # the gossip's uniforms
    place = ("stacked on " + str(dev) if group is None
             else "one a rank" if mesh.data == 1 else f"{mesh.data} ranks a pod")
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    say(f"fed pod mode: {g} pods x data={mesh.data} ({place}) "
        f"topology={gossip.topology} every={gossip.every} bits={gossip.quant_bits}")
    if group is not None:
        _fed_ranks(args, cfg, mesh, step_fn, params, wire, make_batch, backend)
        return
    params = stack_pods(params, g, dev)
    vel = momentum_init(params).velocity
    for step in range(args.steps):
        t0 = time.time()
        params, vel, loss = step_fn(params, vel, make_batch(lead=(g,)), step, generator=wire)
        say(f"step {step:3d} loss={float(loss):.4f} ({time.time()-t0:.2f}s)")
    leaf = tree_leaves(params)[0]
    spread = float(torch.std(leaf.float(), dim=0, correction=0).max())
    say(f"done (inter-pod param spread={spread:.5f})")


def _fed_ranks(args, cfg, mesh, step_fn, whole, wire, make_batch, backend) -> None:
    """:func:`fed_pod_main` on the ranks of a process group, from the
    weights ``whole``."""
    import json

    import torch
    import torch.distributed as dist

    from repro_torch.convert import shard_lm_params, shard_opt_state
    from repro_torch.core.flatten import tree_leaves
    from repro_torch.dist.sharding import batch_specs, param_specs, shard_tree
    from repro_torch.dist.steps import whole_params
    from repro_torch.kernels.block_attn import block_attn as ba
    from repro_torch.kernels.quantize import quantize as qk
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.models import transformer as T
    from repro_torch.optim import momentum_init

    host, dev = mesh.host, mesh.device
    cuda = dev.type == "cuda"
    _say_all(mesh.rank, f"backend={backend} mesh={mesh.shape} pod={mesh.pod} "
             f"data={host.data_axis.rank} device={dev}")
    specs = param_specs(T.abstract_params(cfg), host)
    vel = shard_opt_state(momentum_init(whole).velocity, host, dev)
    params = shard_lm_params(whole, specs, host, dev)
    del whole
    for module in (ba, qk, sk):
        module.reset_launch_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    axes = {"data": host.data_axis, "gossip": mesh.gossip_axis}
    timing = {"rank": mesh.rank, "pod": mesh.pod, "backend": backend, "device": str(dev),
              "ms": [], **{name: [] for name in axes}, "losses": []}
    for step in range(args.steps):
        batch = {k: v[mesh.pod] for k, v in make_batch(lead=(mesh.pods,)).items()}
        b_spec = batch_specs(batch, host)
        batch = shard_tree(batch, b_spec, host)
        if cuda:
            torch.cuda.synchronize(dev)
        before = {name: dict(axis.stats) for name, axis in axes.items()}
        t0 = time.perf_counter()
        params, vel, loss = step_fn(params, vel, batch, step, generator=wire, batch_spec=b_spec)
        loss = float(loss)
        if cuda:
            torch.cuda.synchronize(dev)
        timing["ms"].append((time.perf_counter() - t0) * 1e3)
        for name, axis in axes.items():
            timing[name].append(_since(axis, before[name]))
        timing["losses"].append(loss)
        if mesh.rank == 0:
            print(f"step {step:3d} loss={loss:.4f} ({timing['ms'][-1] / 1e3:.2f}s)", flush=True)
    timing["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda else None
    timing["launches"] = {**ba.LAUNCHES, **ba.BWD_LAUNCHES, **sk.LAUNCHES, **sk.BWD_LAUNCHES,
                          "quantize_rows": qk.LAUNCHES["quantize_rows"],
                          "dequantize_rows": qk.LAUNCHES["dequantize_rows"]}
    _say_all(mesh.rank, f"timing {json.dumps(timing)}")
    whole = whole_params(params, specs, host)
    digest = _agreed_digest(whole, host.data_axis, mesh.rank)
    _say_all(mesh.rank, f"digest={digest} (equal on pod {mesh.pod}'s {mesh.data} ranks)")
    pods = mesh.pod_axis.all_gather(tree_leaves(whole)[0][None], 0)
    spread = float(torch.std(pods.float(), dim=0, correction=0).max())
    dist.barrier(mesh.group)
    if mesh.rank == 0:
        print(f"done (inter-pod param spread={spread:.5f})", flush=True)
    dist.barrier(mesh.group)
    dist.destroy_process_group()


def _say_all(rank: int, line: str) -> None:
    """Print ``line`` as rank ``rank``'s, in one write: the ranks share
    stdout."""
    import sys

    sys.stdout.write(f"rank {rank}: {line}\n")
    sys.stdout.flush()


def _since(axis, before: dict) -> dict:
    """The calls, ms and bytes of ``axis``'s collectives since its stats
    were ``before``."""
    return {"calls": axis.stats["calls"] - before["calls"],
            "ms": (axis.stats["seconds"] - before["seconds"]) * 1e3,
            "bytes": axis.stats["bytes"] - before["bytes"]}


def _agreed_digest(tree, axis, rank: int) -> str:
    """The first 16 hex digits of the sha256 of ``tree``'s leaves' bytes;
    raises unless every rank of ``axis`` holds the same."""
    import hashlib

    import torch
    from torch.utils._pytree import tree_leaves

    digest = hashlib.sha256()
    for leaf in tree_leaves(tree):
        digest.update(leaf.cpu().contiguous().view(torch.uint8).numpy().tobytes())
    digest = digest.hexdigest()[:16]
    if not axis.all_equal([int(digest[i:i + 8], 16) for i in (0, 8)]):
        raise RuntimeError(f"the {axis.name} axis's ranks hold different parameters (rank "
                           f"{rank} digest {digest})")
    return digest


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="mode", required=True)
    p = sub.add_parser("protocol")
    p.add_argument("--algo", default="dfedrw",
                   choices=["dfedrw", "fedavg", "dfedavg", "dsgd"])
    p.add_argument("--rounds", type=int, default=100)
    p.add_argument("--devices", type=int, default=20)
    p.add_argument("--u", type=int, default=50)
    p.add_argument("--h", type=float, default=0.0)
    p.add_argument("--bits", type=int, default=32)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--chains", type=int, default=5)
    p.add_argument("--topology", default="complete")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--obs", default="",
                   help="record a repro_torch.obs telemetry stream (JSONL) here")
    p.add_argument("--trace", action="store_true",
                   help="with --obs: mark the stream trace-capable (schema v2); the "
                        "protocol engine emits no causal spans: use the simulator "
                        "(launch.sim --trace) for causal span trees")
    q = sub.add_parser("pod", help="train one LM of the registry on one device, "
                                   "data-parallel under torchrun, or G replicas of it "
                                   "with --fed")
    q.add_argument("--arch", required=True)
    q.add_argument("--smoke", action="store_true")
    q.add_argument("--steps", type=int, default=10)
    q.add_argument("--batch", type=int, default=4)
    q.add_argument("--seq", type=int, default=64)
    q.add_argument("--lr_r", type=float, default=100.0)
    q.add_argument("--fed", action="store_true",
                   help="DFedRW: per-pod replicas + gossip averaging")
    q.add_argument("--pods", type=int, default=0,
                   help="pods (0 = one a rank under torchrun, else 1); without torchrun "
                        "they stack on the one device; under torchrun a divisor of the "
                        "ranks, each pod data-parallel over the ranks it is given")
    q.add_argument("--gossip-every", type=int, default=1)
    q.add_argument("--bits", type=int, default=32,
                   help="gossip payload quantization bits (<32 = QDFedRW)")
    q.add_argument("--topology", default="ring",
                   choices=["ring", "expander", "all"])
    q.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    (protocol_main if args.mode == "protocol" else pod_main)(args)


if __name__ == "__main__":
    main()
