"""Serving launcher (the port of ``repro.launch.serve``): the
continuous-batching engine (``repro_torch.serve``) on one device. It makes
a synthetic request workload, runs it through ``ServeEngine`` and reports
each request's TTFT/TPOT and the engine's throughput, on the card unless
``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m --smoke \\
      --device cpu --requests 12 --max-concurrency 4 --prompt-len 8 --gen 8 \\
      --mixed --verify

  # staggered Poisson arrivals, mixed lengths, full width on the card:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --full \\
      --requests 16 --max-concurrency 8 --prompt-len 512 --gen 64 --chunk 128 \\
      --arrival 0.5 --mixed

``--full`` runs float32 (the reference runs bf16 there; bf16 is ROADMAP.md
A10), and ``--mesh-model`` > 1 (tensor-parallel serving) is not ported yet
(ROADMAP.md A11).
"""
from __future__ import annotations

import argparse
import json


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
    At temperature 0 the engine's tokens for the request are these. With a
    list ``gaps``, the gap between the two largest logits that each token
    was taken from is appended to it (a near-tie is a small gap)."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as T

    dev = resolve_device(device)
    with torch.no_grad():
        cache = T.init_cache(cfg, 1, max_len, device=dev,
                             enc_len=cfg.frontend_tokens if cfg.enc_dec else 0)
        if cfg.enc_dec:
            emb = torch.as_tensor(req.embeds, dtype=torch.float32, device=dev)[None]
            cache["enc_out"] = T._run_encoder(cfg, params, emb, remat=False)
        prompt = torch.as_tensor(req.prompt, device=dev)
        logits = None
        for t in range(len(req.prompt)):
            logits, cache = T.decode_step(cfg, params, cache, prompt[None, t:t + 1])
        out = []
        for _ in range(req.max_tokens):
            row = logits[0, -1]
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
                    help="use the full-size architecture config, in float32 (the "
                         "reference runs bf16 here; bf16 is ROADMAP.md A10)")
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
                    help="model-axis size: only 1 (sharded serving is ROADMAP.md A11)")
    ap.add_argument("--verify", action="store_true",
                    help="replay each request through the sequential decode "
                         "path and require identical outputs (temp 0)")
    ap.add_argument("--json", default="", help="write the metrics summary here")
    ap.add_argument("--obs", default="",
                    help="record a repro_torch.obs telemetry stream (JSONL) here "
                         "(report: python tools/obs_report.py <path>)")
    ap.add_argument("--trace", action="store_true",
                    help="with --obs: record per-request causal span trees "
                         "(admit/prefill_chunk/decode tspan events)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.mesh_model > 1:
        raise NotImplementedError(
            f"--mesh-model {args.mesh_model}: sharded serving is not ported yet "
            f"(ROADMAP.md A11: distribution)")
    if args.trace and not args.obs:
        raise SystemExit("--trace requires --obs (it augments the obs "
                         "stream with tspan events)")

    import torch

    from repro_torch.configs import get_arch, get_smoke
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as T
    from repro_torch.serve import EngineConfig, ServeEngine

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch) if args.full else get_smoke(args.arch)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    max_len = args.max_len or (args.prompt_len + args.gen)
    obs = None
    if args.obs:
        from repro_torch.obs import PausableWallClock, Recorder
        obs = Recorder(clock=PausableWallClock(), trace=args.trace)

    reqs = build_requests(args, cfg)
    eng = ServeEngine(cfg, params, EngineConfig(
        max_concurrency=args.max_concurrency, max_len=max_len,
        chunk=args.chunk, seed=args.seed), device=dev, obs=obs)
    results = eng.run(reqs)

    summary = eng.metrics.summary()
    print(f"arch={cfg.name} device={dev} slots={args.max_concurrency} "
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
        bad = [st.request.rid for st in results
               if st.generated != sequential_reference(cfg, eng.params, st.request,
                                                       max_len, dev)]
        if bad:
            raise SystemExit(f"VERIFY FAILED: engine != sequential decode for rids {bad}")
        print(f"verify: all {len(results)} requests identical to the "
              f"sequential decode path")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=2)
        print(f"wrote {args.json}")

    if args.obs:
        from repro_torch.obs import provenance
        obs.save(args.obs, provenance=provenance(config=vars(args), device=dev),
                 workload="serve", arch=cfg.name)
        print(f"obs: wrote {args.obs} "
              f"(report: python tools/obs_report.py {args.obs})")


if __name__ == "__main__":
    main()
