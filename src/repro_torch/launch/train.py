"""Training launcher (the port of ``repro.launch.train``).

``protocol --algo dfedrw`` runs the paper's federated protocol
(DFedRW/QDFedRW) on synthetic federated data, on the card unless
``--device cpu`` is given. The baselines (``--algo fedavg|dfedavg|dsgd``)
and the ``pod`` mode are not ported yet (ROADMAP.md, queue A).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train protocol --algo dfedrw --rounds 100
  PYTHONPATH=src python -m repro_torch.launch.train protocol --bits 8 --device cpu --rounds 2
"""
from __future__ import annotations

import argparse

import numpy as np


def protocol_main(args) -> None:
    from repro_torch.core import (
        DFedRW, DFedRWConfig, QuantConfig, StragglerModel, make_topology, train_loop,
    )
    from repro_torch.core.heterogeneity import partition_similarity
    from repro_torch.data import FederatedDataset, synthetic_image_classification
    from repro_torch.models import make_fnn

    if args.algo != "dfedrw":
        raise NotImplementedError(
            f"--algo {args.algo}: the baselines are not ported yet "
            "(ROADMAP.md queue A, item 5: baselines)")
    x, y = synthetic_image_classification(n_samples=8000, seed=0, noise=2.0)
    xt, yt = synthetic_image_classification(n_samples=1000, seed=1, noise=2.0)
    part = partition_similarity(y, args.devices, args.u, np.random.default_rng(7))
    data = FederatedDataset.from_partition(x, y, part)
    topo = make_topology(args.topology, args.devices)
    model = make_fnn((200, 200))
    runner = DFedRW(model, data, topo, DFedRWConfig(
        m_chains=args.chains, k_walk=args.epochs,
        straggler=StragglerModel(h_percent=args.h), quant=QuantConfig(bits=args.bits)),
        device=args.device)

    def cb(r, metrics, evald):
        print(f"round {r+1:4d}  loss={metrics.train_loss:.4f} "
              f"acc={evald['accuracy']:.4f} busiest_mb={metrics.comm_bits_busiest_round/8e6:.2f}")

    hist = train_loop(runner, args.rounds, xt, yt,
                      eval_every=max(args.rounds // 20, 1), callback=cb)
    print(f"final: {hist.final()}")


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
    sub.add_parser("pod", help="not ported yet")
    args = ap.parse_args(argv)
    if args.mode == "pod":
        raise NotImplementedError(
            "pod mode is not ported yet (ROADMAP.md queue A, item 11: distribution)")
    protocol_main(args)


if __name__ == "__main__":
    main()
