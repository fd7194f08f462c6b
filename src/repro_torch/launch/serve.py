"""Serving launcher (the port of ``repro.launch.serve``): the
continuous-batching engine (``repro_torch.serve``) on one device, or on a
``(data, model)`` mesh of the ranks that ``torchrun`` starts. It makes a
synthetic request workload, runs it through ``ServeEngine`` and reports each request's
TTFT/TPOT and the engine's throughput, on the card unless ``--device cpu``
is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m --smoke \\
      --device cpu --requests 12 --max-concurrency 4 --prompt-len 8 --gen 8 \\
      --mixed --verify

  # staggered Poisson arrivals, mixed lengths, full width on the card:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --full \\
      --requests 16 --max-concurrency 8 --prompt-len 512 --gen 64 --chunk 128 \\
      --arrival 0.5 --mixed

``--full`` serves in bf16 (weights, cache and activations) and the smoke
configuration in float32, as the reference's launcher chooses.

Under ``torchrun`` with world size W > 1 the ranks serve on a ``(data=W /
N, model=N)`` mesh for ``--mesh-model N`` (default 1), as the reference
gives the data axis every device that the model axis leaves: N must divide
W. The model axis is tensor-parallel; the data axis splits the engine's
slots (``--max-concurrency``) over its ranks, or replicates them where it
does not divide them. Every rank draws the same weights and keeps its
block (``dist.sharding``), whole along the data axis. ``--mesh-model N`` >
1 without ``torchrun`` is refused. The ranks' collectives run over NCCL
when every rank has a card of its own, else over gloo (ranks that share
one card, and ``--device cpu``); each rank prints its backend, the mesh and
its device, and at the end a ``timing`` JSON line (ms a decode step and a
prefill chunk, each axis's collectives' calls, ms and bytes a step, peak
device memory, ``block_attn`` launches) and its token-stream digest; rank
0 prints the rest, and runs ``--verify`` against the unsharded sequential
decode:

  PYTHONPATH=src OMP_NUM_THREADS=1 torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
      --arch yi-6b --smoke --device cpu --mesh-model 2 --requests 6 --verify
  PYTHONPATH=src OMP_NUM_THREADS=1 torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --arch yi-6b --smoke --device cpu --mesh-model 2 --requests 6 --verify   # (2, 2)
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def build_requests(args, cfg):
    """Synthetic workload, the reference's draws from ``--seed``: fixed
    lengths by default; --mixed draws prompt lengths U[plen/2, plen] and
    budgets U[gen/4, gen]; --arrival r spreads arrivals as Poisson(rate=r
    requests per engine step). enc-dec archs get random frontend
    embeddings per request."""
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(args.seed)
    step = 0
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(max(args.prompt_len // 2, 1), args.prompt_len + 1)) \
            if args.mixed else args.prompt_len
        gen = int(rng.integers(max(args.gen // 4, 1), args.gen + 1)) \
            if args.mixed else args.gen
        if args.arrival > 0 and i > 0:
            step += int(rng.poisson(1.0 / args.arrival))
        embeds = None
        if cfg.enc_dec:
            embeds = rng.normal(
                size=(cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
        reqs.append(Request(
            rid=i, prompt=rng.integers(0, cfg.vocab, size=(plen,)),
            max_tokens=gen, eos_id=args.eos_id, temperature=args.temperature,
            arrival_step=step, embeds=embeds))
    return reqs


def sequential_reference(cfg, params, req, max_len: int, device="cuda", gaps=None):
    """The pre-engine serving semantics: one request, token-at-a-time
    prefill through ``T.decode_step``, then greedy (temperature-0) decode.
    At temperature 0 the engine's tokens for the request are these. The
    cache is in the parameters' dtype, as the engine's (the reference's
    builds a float32 one), and an encoder-decoder's encoder runs on the
    float32 embeddings with its output rounded to that dtype, as the
    engine's admission does. With a list ``gaps``, the gap between the two
    largest logits that each token was taken from is appended to it (a
    near-tie is a small gap)."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as T

    dev = resolve_device(device)
    with torch.no_grad():
        dtype = params["embed"].dtype
        cache = T.init_cache(cfg, 1, max_len, dtype, device=dev,
                             enc_len=cfg.frontend_tokens if cfg.enc_dec else 0)
        if cfg.enc_dec:
            emb = torch.as_tensor(req.embeds, dtype=torch.float32, device=dev)[None]
            cache["enc_out"] = T._run_encoder(cfg, params, emb, remat=False).to(dtype)
        prompt = torch.as_tensor(req.prompt, device=dev)
        logits = None
        for t in range(len(req.prompt)):
            logits, cache = T.decode_step(cfg, params, cache, prompt[None, t:t + 1])
        out = []
        for _ in range(req.max_tokens):
            row = logits[0, -1].float()
            tok = int(torch.argmax(row))
            if gaps is not None:
                top = torch.topk(row, 2).values
                gaps.append(float(top[0] - top[1]))
            out.append(tok)
            if req.eos_id >= 0 and tok == req.eos_id:
                break
            logits, cache = T.decode_step(
                cfg, params, cache, torch.tensor([[tok]], dtype=torch.int32, device=dev))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="does nothing: kept for the reference's command line; "
                         "the reduced smoke config is the default and --full "
                         "alone chooses the full-size one")
    ap.add_argument("--full", action="store_true",
                    help="use the full-size architecture config, in bf16 (the smoke "
                         "config runs float32)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-concurrency", type=int, default=8,
                    help="engine cache slots (max in-flight requests)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32, help="max new tokens per request")
    ap.add_argument("--chunk", type=int, default=16, help="prefill chunk size")
    ap.add_argument("--max-len", type=int, default=0,
                    help="per-slot cache capacity (0 = prompt+gen)")
    ap.add_argument("--arrival", type=float, default=0.0,
                    help="mean arrivals per engine step (0 = all at step 0)")
    ap.add_argument("--mixed", action="store_true",
                    help="draw mixed prompt/gen lengths instead of fixed")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--eos-id", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="model-axis size: under torchrun with world size W the ranks "
                         "serve on a (W / N, N) mesh; N > 1 needs torchrun")
    ap.add_argument("--verify", action="store_true",
                    help="replay each request through the sequential decode "
                         "path and require identical outputs (temp 0)")
    ap.add_argument("--json", default="", help="write the metrics summary here")
    ap.add_argument("--tokens", default="",
                    help="write each request's generated tokens here, each with its top-2 "
                         "logit gap and top logit (JSON: request id -> {tokens, margins})")
    ap.add_argument("--obs", default="",
                    help="record a repro_torch.obs telemetry stream (JSONL) here "
                         "(report: python tools/obs_report.py <path>)")
    ap.add_argument("--trace", action="store_true",
                    help="with --obs: record per-request causal span trees "
                         "(admit/prefill_chunk/decode tspan events)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.mesh_model < 1:
        raise SystemExit(f"--mesh-model {args.mesh_model}: the model axis takes 1 rank or more")
    if args.mesh_model > 1 and world == 1:
        raise SystemExit(
            f"--mesh-model {args.mesh_model} runs on {args.mesh_model} ranks or a multiple: "
            f"start it with torchrun --nproc-per-node {args.mesh_model} (this process has no "
            f"process group)")
    if world % args.mesh_model:
        raise SystemExit(
            f"--mesh-model {args.mesh_model} over {world} ranks: the (data, model) mesh is "
            f"({world} // {args.mesh_model}, {args.mesh_model}), and {args.mesh_model} does "
            f"not divide {world}")
    if args.trace and not args.obs:
        raise SystemExit("--trace requires --obs (it augments the obs "
                         "stream with tspan events)")

    import torch

    from repro_torch.configs import get_arch, get_smoke
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as T
    from repro_torch.serve import EngineConfig, ServeEngine

    mesh = None
    dev = resolve_device(args.device)
    if world > 1:
        dev, mesh = _join_mesh(args, dev, world)
    lead = mesh is None or mesh.rank == 0
    cfg = get_arch(args.arch) if args.full else get_smoke(args.arch)
    dtype = torch.bfloat16 if args.full else torch.float32
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dtype, device=dev)
    max_len = args.max_len or (args.prompt_len + args.gen)
    obs = None
    if args.obs and lead:
        from repro_torch.obs import PausableWallClock, Recorder
        obs = Recorder(clock=PausableWallClock(), trace=args.trace)

    reqs = build_requests(args, cfg)
    eng = ServeEngine(cfg, params, EngineConfig(
        max_concurrency=args.max_concurrency, max_len=max_len,
        chunk=args.chunk, dtype=dtype, seed=args.seed), device=dev, obs=obs, mesh=mesh,
        margins=bool(args.tokens))
    if mesh is not None:
        if not (args.verify and lead):
            del params                   # this rank keeps its block (eng.params) alone
        timing = _RankTiming(eng, dev)
    results = eng.run(reqs)
    if mesh is not None:
        timing.report(args, eng)
        if not lead:
            _leave_mesh()
            return

    summary = eng.metrics.summary()
    where = f"device={dev}" if mesh is None else f"mesh={mesh.shape} ranks={mesh.size}"
    print(f"arch={cfg.name} {where} slots={args.max_concurrency} "
          f"chunk={eng.chunk} requests={len(reqs)}")
    for st in results:
        m = eng.metrics.requests[st.request.rid]
        print(f"  req {st.request.rid:3d}: prompt={m.prompt_len:3d} "
              f"gen={m.n_generated:3d} stop={st.stop:<10s} "
              f"ttft={m.ttft_s*1e3:7.1f}ms tpot={m.tpot_s*1e3:6.1f}ms "
              f"tokens={st.generated[:8]}{'...' if len(st.generated) > 8 else ''}")
    print(f"throughput: {summary['tok_s']:.1f} gen tok/s "
          f"({summary['total_tok_s']:.1f} incl. prefill) | "
          f"mean TTFT {summary['mean_ttft_s']*1e3:.1f}ms | "
          f"mean TPOT {summary['mean_tpot_s']*1e3:.1f}ms | "
          f"{summary['prefill_chunks']} prefill chunks + "
          f"{summary['decode_steps']} decode steps")

    if args.verify:
        if args.temperature > 0:
            raise SystemExit("--verify requires --temperature 0")
        full = eng.params if mesh is None else params
        bad = [st.request.rid for st in results
               if st.generated != sequential_reference(cfg, full, st.request, max_len, dev)]
        if bad:
            raise SystemExit(f"VERIFY FAILED: engine != sequential decode for rids {bad}")
        print(f"verify: all {len(results)} requests identical to the "
              f"sequential decode path")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=2)
        print(f"wrote {args.json}")
    if args.tokens:
        with open(args.tokens, "w") as f:
            json.dump({st.request.rid: {"tokens": st.generated,
                                        "margins": eng.margins[st.request.rid]}
                       for st in results}, f)

    if args.obs:
        from repro_torch.obs import provenance
        obs.save(args.obs, provenance=provenance(config=vars(args), device=dev),
                 workload="serve", arch=cfg.name)
        print(f"obs: wrote {args.obs} "
              f"(report: python tools/obs_report.py {args.obs})")
    if mesh is not None:
        _leave_mesh()


def _join_mesh(args, dev, world: int):
    """This rank's device and mesh: the ranks that ``torchrun`` started join
    one process group (``launch.mesh.join_torchrun``: NCCL when every rank
    of the host has a card of its own, gloo when they share cards and on
    the CPU) as a (world / N, N) mesh. A rank that finds no card raises
    (``resolve_device``)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import join_torchrun, make_host_mesh

    dev, backend = join_torchrun(dev)
    mesh = make_host_mesh(world // args.mesh_model, args.mesh_model, device=dev,
                          group=dist.group.WORLD)
    sys.stdout.write(f"rank {mesh.rank}: backend={backend} mesh={mesh.shape} device={dev}\n")
    sys.stdout.flush()
    return dev, mesh


def _leave_mesh() -> None:
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


class _RankTiming:
    """Each engine step's device work on this rank timed (the device
    synchronised before and after): its step call, the sampling of its
    rows and the gather of the step's tokens over the data axis; with each
    axis's collectives' calls, ms and bytes (``MeshAxis.stats``);
    ``block_attn``'s launches counted from 0."""

    def __init__(self, eng, dev):
        import torch

        from repro_torch.kernels.block_attn import block_attn

        self.dev, self.mesh, self.torch, self.ba = dev, eng.mesh, torch, block_attn
        self.axes = {"model": eng.mesh.axis, "data": eng.mesh.data_axis}
        self.calls = {"decode": [], "prefill": []}
        eng._decode = self._timed(eng._decode, "decode")
        eng._prefill = self._timed(eng._prefill, "prefill")
        block_attn.reset_launch_counts()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

    def _sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize(self.dev)

    def _timed(self, fn, kind):
        def run(*args, **kwargs):
            self._sync()
            before = {name: dict(axis.stats) for name, axis in self.axes.items()}
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self._sync()
            call = {"ms": (time.perf_counter() - t0) * 1e3}
            for name, axis in self.axes.items():
                call[name] = {"calls": axis.stats["calls"] - before[name]["calls"],
                              "ms": (axis.stats["seconds"] - before[name]["seconds"]) * 1e3,
                              "bytes": axis.stats["bytes"] - before[name]["bytes"]}
            self.calls[kind].append(call)
            return out

        return run

    def report(self, args, eng) -> None:
        rank = self.mesh.rank
        out = {"rank": rank, "backend": self.axes["model"].backend or self.axes["data"].backend,
               "device": str(self.dev),
               "peak_bytes": (self.torch.cuda.max_memory_allocated(self.dev)
                              if self.dev.type == "cuda" else None),
               "block_attn_launches": self.ba.LAUNCHES["block_attn"],
               "block_attn_bf16_launches": self.ba.BF16_LAUNCHES["block_attn"]}
        med = statistics.median
        for kind, calls in self.calls.items():
            if calls:
                out[kind] = {"steps": len(calls), "ms": med(c["ms"] for c in calls),
                             "axes": {name: {key: med(c[name][key] for c in calls)
                                             for key in ("calls", "ms", "bytes")}
                                      for name in self.axes}}
        # one write a line: the ranks share one standard output
        for line in (f"rank {rank}: timing {json.dumps(out)}",
                     f"rank {rank}: digest={eng.digest} (equal on all "
                     f"{self.mesh.size} ranks)"):
            sys.stdout.write(line + "\n")
            sys.stdout.flush()


if __name__ == "__main__":
    main()
