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
line a step, then ``done``.

``pod --fed`` runs the DFedRW pod deployment (``dist.make_fed_train_step``,
float32, no remat): one model initialised and copied to G pods with zero
velocities, a local step a pod on its own batch (drawn with a leading pod
dimension from the same stream), and gossip averaging over ``--topology``
every ``--gossip-every`` steps, quantized through the int8 wire kernels at
``--bits < 32``. Without ``torchrun`` the ``--pods`` pods stack on the one
device; under ``torchrun`` (``WORLD_SIZE`` > 1) each rank is one pod (nccl
on the card, gloo on the CPU) and draws every pod's batch to keep its own.
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
    import torch

    from repro_torch.configs import get_arch, get_smoke
    from repro_torch.device import resolve_device
    from repro_torch.dist.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import momentum_init

    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    group = _process_group(args) if args.fed else None
    dev = resolve_device(args.device)
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
        fed_pod_main(args, cfg, dev, group, make_batch)
        return
    step_fn = make_train_step(cfg, lr_r=args.lr_r)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    vel = momentum_init(params).velocity
    for step in range(args.steps):
        t0 = time.time()
        params, vel, loss = step_fn(params, vel, make_batch(), step)
        print(f"step {step:3d} loss={float(loss):.4f} ({time.time()-t0:.2f}s)")
    print("done")


def _process_group(args):
    """The default process group when the launcher runs under ``torchrun``
    (``WORLD_SIZE`` > 1; nccl on the card, gloo on the CPU), else None. On
    the card each rank takes the card of its ``LOCAL_RANK``."""
    import os

    import torch
    import torch.distributed as dist

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        dist.init_process_group("nccl" if cuda else "gloo")
    return dist.group.WORLD


def fed_pod_main(args, cfg, dev, group, make_batch) -> None:
    """pod --fed: the DFedRW pod deployment, G pods stacked on one device or
    one pod a rank of ``group``."""
    import torch
    import torch.distributed as dist

    from repro_torch.convert import stack_pods
    from repro_torch.core.flatten import tree_leaves
    from repro_torch.dist.gossip import GossipConfig
    from repro_torch.dist.steps import make_fed_train_step
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import momentum_init

    mesh = make_pod_mesh(args.pods, device=dev, group=group)
    g = mesh.pods
    rank = 0 if group is None else dist.get_rank(group)
    gossip = GossipConfig(topology=args.topology, every=args.gossip_every,
                          quant_bits=args.bits)
    step_fn, _ = make_fed_train_step(cfg, mesh, gossip, lr_r=args.lr_r, remat=False)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    if group is None:
        params = stack_pods(params, g, dev)
    vel = momentum_init(params).velocity
    wire = torch.Generator(device=dev).manual_seed(1 + rank)     # the gossip's uniforms
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"fed pod mode: {g} pods x data=1 "
        f"({'stacked on ' + str(dev) if group is None else 'one a rank'}) "
        f"topology={gossip.topology} every={gossip.every} bits={gossip.quant_bits}")
    for step in range(args.steps):
        batch = make_batch(lead=(g,))
        if group is not None:              # every rank draws all pods' tokens, keeps its own
            batch = {k: v[rank] for k, v in batch.items()}
        t0 = time.time()
        params, vel, loss = step_fn(params, vel, batch, step, generator=wire)
        say(f"step {step:3d} loss={float(loss):.4f} ({time.time()-t0:.2f}s)")
    leaf = tree_leaves(params)[0]
    if group is not None:
        pods = [torch.empty_like(leaf) for _ in range(g)]
        dist.all_gather(pods, leaf, group=group)
        leaf = torch.stack(pods)
    spread = float(torch.std(leaf.float(), dim=0, correction=0).max())
    say(f"done (inter-pod param spread={spread:.5f})")


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
    q = sub.add_parser("pod", help="train one LM of the registry on one device, or G "
                                   "replicas of it with --fed")
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
                        "they stack on the one device")
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
