"""Virtual-time simulator launcher (the port of ``repro.launch.sim``).

Runs a registered scenario of the discrete-event asynchronous DFedRW
simulator (repro_torch.sim) on the card unless ``--device cpu`` is given,
and reports per-eval progress plus the end-of-run
timeline summary (virtual seconds, truncated/resumed/dropped chains,
events/sec). ``--record`` saves the run as a versioned JSONL event trace
(the reference's schema, so either package replays it); ``--replay``
re-executes a recorded trace through the flat engine — no device/link/churn
simulation — and reproduces the recorded run bit-exactly. ``--obs`` writes
a telemetry stream that the JAX package's ``tools/obs_report.py`` and
``tools/obs_diff.py`` read.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.sim --list
  PYTHONPATH=src python -m repro_torch.launch.sim --scenario straggler_tail --rounds 30
  PYTHONPATH=src python -m repro_torch.launch.sim --scenario congested_uplink --bits adaptive
  PYTHONPATH=src python -m repro_torch.launch.sim --scenario straggler_tail \\
      --device cpu --rounds 2 --record trace.jsonl
  PYTHONPATH=src python -m repro_torch.launch.sim --replay trace.jsonl --device cpu
  PYTHONPATH=src python -m repro_torch.launch.sim --scenario fleet_metro \\
      --engine fleet --n 100000 --rounds 2
"""
from __future__ import annotations

import argparse


def _progress_cb(r, metrics, evald, record):
    print(f"round {record.round:4d}  t={record.t_end:9.1f}s  "
          f"loss={metrics.train_loss:.4f} acc={evald['accuracy']:.4f}  "
          f"trunc={record.truncated_chains} resumed={record.resumed_chains} "
          f"drop={record.dropped_chains} killed={int(record.killed.sum())}")


def _summary(result) -> None:
    final = result.final()
    print(f"final: acc={final['accuracy']:.4f} best={final['best_accuracy']:.4f} "
          f"virtual_time={final['virtual_time_s']:.1f}s "
          f"events={final['events_total']} "
          f"({final['events_per_sec']:.0f} ev/s host)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenario", default="straggler_tail")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and exit")
    ap.add_argument("--rounds", type=int, default=0,
                    help="0 = the scenario's default")
    ap.add_argument("--devices", "--n", dest="devices", type=int, default=20,
                    help="fleet size (--n is an alias)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", default="", choices=["", "heap", "fleet"],
                    help="timeline engine override: 'heap' is the per-event "
                         "oracle, 'fleet' the vectorized batched-timeline "
                         "backend for large --n ('' = scenario default)")
    ap.add_argument("--policy", default="",
                    choices=["", "partial", "drop", "overlap"],
                    help="deadline policy override (scenarios default to "
                         "'partial', the paper's partial-update aggregation; "
                         "'overlap' resumes cut chains across windows)")
    ap.add_argument("--bits", default="",
                    help="payload quantization override: an integer width "
                         "(<32 = QDFedRW) or 'adaptive' for the online "
                         "uplink-pressure controller (repro_torch.sim.adapt; "
                         "supported by the *_uplink scenarios); "
                         "'' = scenario default")
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--record", default="",
                    help="save the run as a JSONL event trace at this path")
    ap.add_argument("--replay", default="",
                    help="replay a recorded JSONL trace (scenario/seed come "
                         "from its header) instead of simulating")
    ap.add_argument("--obs", default="",
                    help="record a repro.obs-schema telemetry stream (JSONL) here — "
                         "virtual-clock spans/counters, deterministic per "
                         "seed (report: python tools/obs_report.py <path>)")
    ap.add_argument("--trace", nargs="?", const="auto", default="",
                    choices=["auto", "full", "coarse"],
                    help="with --obs: also record causal span trees (schema "
                         "v2 tspan events) — per hop/sgd/transfer/queue_wait/"
                         "churn_wait/aggregate span with trace & parent ids. "
                         "'auto' coarsens to per-chain-per-window envelopes "
                         "past TRACE_COARSE_LIMIT chain-steps; export: "
                         "python tools/obs_trace_export.py <obs.jsonl>")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the round engine: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.sim import build_scenario, list_scenarios

    if args.list:
        for name, desc in sorted(list_scenarios().items()):
            print(f"{name:20s} {desc}")
        return

    import torch

    from repro_torch.device import resolve_device

    device = resolve_device(args.device)

    if args.trace and not args.obs:
        raise SystemExit("--trace requires --obs (it augments the obs "
                         "stream with tspan events)")
    if args.trace and args.replay:
        raise SystemExit("--trace is not available under --replay: the flat "
                         "replay engine skips the device/link timeline that "
                         "spans are built from — re-simulate instead")

    def _attach_obs(runner):
        if not args.obs:
            return None
        from repro_torch.obs import Recorder, VirtualClock
        rec = Recorder(clock=VirtualClock(), trace=bool(args.trace))
        if args.trace:
            runner.attach_obs(rec, trace=(True if args.trace == "auto"
                                          else args.trace))
        else:
            runner.attach_obs(rec)
        return rec

    def _save_obs(rec, setup) -> None:
        if rec is None:
            return
        from repro_torch.obs import provenance
        rec.save(args.obs, provenance=provenance(config=vars(args), device=device),
                 workload="sim", scenario=setup.name)
        print(f"obs: wrote {args.obs} "
              f"(report: python tools/obs_report.py {args.obs})")

    if args.replay:
        if args.record:
            raise SystemExit(
                "--record and --replay are mutually exclusive: a replay "
                "re-executes an existing trace, it does not produce one")
        from repro_torch.sim import SimTrace

        trace = SimTrace.load(args.replay)
        h = trace.header
        if not {"scenario", "build_seed", "key_seed"} <= set(h):
            raise SystemExit(
                "trace header lacks launcher provenance (scenario/build_seed/"
                "key_seed): it was recorded in-process via run(record=True); "
                "replay it with AsyncDFedRW.replay, or record through "
                "`python -m repro_torch.launch.sim --record`")
        overrides = dict(h.get("build_overrides", {}))
        setup = build_scenario(h["scenario"], n=h["n"], seed=h["build_seed"],
                               **overrides)
        runner = setup.runner(device=device)
        rec = _attach_obs(runner)
        print(f"replay={args.replay} scenario={h['scenario']} n={h['n']} "
              f"windows={len(trace.windows)} policy={h['policy']} "
              f"bits={h['bits']} (trace schema v{h['version']})")
        result = runner.replay(trace, torch.Generator().manual_seed(h["key_seed"]),
                               setup.x_test, setup.y_test,
                               eval_every=max(h.get("eval_every", 1), 1),
                               callback=_progress_cb)
        _summary(result)
        _save_obs(rec, setup)
        return

    overrides = {}
    if args.policy:
        overrides["policy"] = args.policy
    if args.bits:
        overrides["bits"] = ("adaptive" if args.bits == "adaptive"
                             else int(args.bits))
    if args.rounds:
        overrides["rounds"] = args.rounds
    setup = build_scenario(args.scenario, n=args.devices, seed=args.seed,
                           **overrides)
    runner = setup.runner(engine=args.engine or None, device=device)
    bits_desc = str(setup.cfg.quant.bits)
    if setup.sim.bits_policy is not None:
        widths = "/".join(
            str(b) for b in getattr(setup.sim.bits_policy, "widths", ()))
        bits_desc = f"adaptive({widths})"
    print(f"scenario={setup.name} n={args.devices} rounds={setup.rounds} "
          f"engine={runner.timeline_engine} policy={setup.sim.policy} "
          f"deadline_s={setup.sim.deadline_s} bits={bits_desc}")

    rec = _attach_obs(runner)
    result = runner.run(setup.rounds, torch.Generator().manual_seed(args.seed),
                        setup.x_test, setup.y_test,
                        eval_every=max(args.eval_every, 1),
                        callback=_progress_cb, record=bool(args.record))
    _summary(result)
    _save_obs(rec, setup)
    if args.record:
        # launcher provenance so --replay can rebuild the same scenario
        result.trace.header.update(
            scenario=setup.name, build_seed=args.seed, key_seed=args.seed,
            eval_every=max(args.eval_every, 1), build_overrides=overrides)
        result.trace.save(args.record)
        print(f"recorded {len(result.trace.windows)} windows -> {args.record} "
              f"(replay: python -m repro_torch.launch.sim --replay {args.record})")


if __name__ == "__main__":
    main()
