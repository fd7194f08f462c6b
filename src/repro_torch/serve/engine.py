"""Continuous-batching serve engine over the slot-based ring-buffer cache,
the port of ``repro.serve.engine``.

One `ServeEngine` owns a decode cache with ``max_concurrency`` slots (the
batch dim of `T.init_cache`) and runs a step loop in which every engine
step is one call of one of two step functions:

* **gang prefill step** — when prefilling slots outnumber decoding ones
  (admission waves, cold start), one `make_prefill_step` call advances
  *every* prefilling slot by up to ``chunk`` tokens, writing k/v (or
  recurrent state) at each slot's own offset; slots that finish their
  prompt get their first token sampled from the same call's logits.
* **decode step** — otherwise one `make_serve_step` call
  decodes every in-flight slot at its own position, and the few
  prefilling slots (trickled admissions) *piggyback* on it, streaming
  their next prompt token at their own position. Retired and free rows
  ride along under an ``active`` mask that drops their cache writes.
  (``min_prefill_rows`` overrides the auto gang threshold.)

Requests are admitted FCFS as slots free up and retired per token on
EOS/max-token stops; the cache never reshapes, and slot reuse is a pure
data change. An encoder-decoder runs its encoder once per admitted
request and writes the output into the slot's row of ``cache["enc_out"]``.

PyTorch runs eagerly, so nothing is traced or compiled and the engine has
no ``trace_counts``: its ``prefill_chunks`` and ``decode_steps`` counters
count the step calls run. Each engine step moves its sampled tokens to
the host once (one device-to-host copy, as the reference's
``np.asarray(tok)``). There is no mesh: the parameters and the cache live
on ``device`` (sharded serving, ``--mesh-model``, is ROADMAP.md A11). The
cache is in ``EngineConfig.dtype`` (float32 or bf16, the parameters'
dtype); the last logits are cast to float32 before sampling, and an
encoder-decoder's encoder runs on float32 frame embeddings, its output
rounded to the cache's dtype as it is written, as the reference's engine
does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist.steps import make_prefill_step, make_serve_step
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from repro_torch.serve.metrics import EngineMetrics, RequestMetrics
from repro_torch.serve.prefill import plan_chunk
from repro_torch.serve.scheduler import FCFSScheduler, Phase, Request, RequestState, stop_reason

__all__ = ["EngineConfig", "ServeEngine"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The reference's fields but ``donate_cache``, which has no meaning
    for eager PyTorch (a step's new cache replaces the old one, and the old
    one is freed when nothing holds it)."""

    max_concurrency: int = 8       # cache slots = max in-flight requests
    max_len: int = 128             # per-slot cache capacity (prompt + gen)
    chunk: int = 16                # prefill tokens per slot per step
    min_prefill_rows: int = 0      # gang-prefill threshold: run the chunked
                                   # step only when this many slots are
                                   # prefilling; fewer rows piggyback on
                                   # decode steps. 0 = auto: gang when
                                   # prefilling rows >= decoding rows
    dtype: torch.dtype = torch.float32
    seed: int = 0

    def __post_init__(self):
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"EngineConfig.dtype {self.dtype}: the cache is float32 or "
                             f"bfloat16")


def _sample_tokens(logits: torch.Tensor, gen: torch.Generator,
                   temps: torch.Tensor) -> torch.Tensor:
    """Per-row greedy/temperature sampling. logits (B, V) float32; temps
    (B,), temp <= 0 meaning greedy (``argmax``, ties to the lowest index,
    as the sequential reference takes it). A sampled row draws Gumbel noise
    from ``gen`` (the reference's ``jax.random.categorical`` method; its
    bits are the generator's, not JAX's)."""
    greedy = torch.argmax(logits, dim=-1)
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    scaled = logits / temps.clamp_min(1e-6)[:, None]
    sampled = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    return torch.where(temps > 0, sampled, greedy)


def _zero_fresh_state(cache: dict, fresh: torch.Tensor) -> dict:
    """Zero the recurrent-state rows (``conv``/``ssm``) of freshly admitted
    slots, out of place. Attention slots need no reset (their ring mask
    hides everything past the slot's position), but Mamba state is
    position-free and would carry the previous occupant's state into the
    new request."""

    def one(name, leaf):
        if isinstance(leaf, dict):
            return {k: one(k, v) for k, v in leaf.items()}
        if name in ("conv", "ssm"):
            m = fresh.reshape((1, fresh.shape[0]) + (1,) * (leaf.dim() - 2))
            return torch.where(m, torch.zeros((), dtype=leaf.dtype, device=leaf.device), leaf)
        return leaf

    return {k: one(k, v) for k, v in cache.items()}


class ServeEngine:
    """Continuous-batching engine; see the module docstring.

    Typical use::

        eng = ServeEngine(cfg, params, EngineConfig(max_concurrency=8))
        for r in requests:
            eng.submit(r)           # Request(rid, prompt, max_tokens, ...)
        results = eng.run()         # list[RequestState] sorted by rid

    ``device`` (default ``"cuda"``) holds the parameters (moved there if
    they are elsewhere) and the cache; ``obs`` is an optional shared
    ``repro_torch.obs.Recorder``: engine counters and latency histograms
    land there as ``serve/*`` series with a duration per step, and with
    ``trace=True`` each request's ``admit -> prefill_chunk* -> decode*``
    span chain. Host-side only, between steps: token streams are the same
    with obs on or off."""

    def __init__(self, cfg: ArchConfig, params, engine: EngineConfig | None = None,
                 device: str | torch.device = "cuda", obs=None):
        self.cfg = cfg
        self.engine = engine or EngineConfig()
        self.obs = obs
        self.device = resolve_device(device)
        b, s = self.engine.max_concurrency, self.engine.max_len
        ring = min(s, cfg.sliding_window) if cfg.sliding_window > 0 else s
        self.ring_size = ring
        self.chunk = min(self.engine.chunk, ring)
        self.min_prefill_rows = self.engine.min_prefill_rows  # 0 = auto
        self.params = _to(params, self.device)
        self.cache = T.init_cache(cfg, b, s, self.engine.dtype, device=self.device,
                                  enc_len=cfg.frontend_tokens if cfg.enc_dec else 0)
        self._serve_fn = make_serve_step(cfg)
        self._prefill_fn = make_prefill_step(cfg)
        self._recurrent = "mamba" in cfg.block_pattern
        self.reset()

    def reset(self) -> None:
        """Clear all request state (queue, slots, metrics, sampling
        generator) while keeping the allocated cache: stale cache contents
        are invisible behind the ring masks, and recurrent state is zeroed
        on admission."""
        b = self.engine.max_concurrency
        self.scheduler = FCFSScheduler()
        self.metrics = EngineMetrics(recorder=self.obs)
        self._slots: list[RequestState | None] = [None] * b
        self.positions = np.zeros((b,), np.int32)
        self._last_tok = np.zeros((b,), np.int32)
        self._temps = np.zeros((b,), np.float32)
        self._gen = torch.Generator(device=self.device).manual_seed(self.engine.seed)
        self._step_count = 0
        self._work_budget = 0
        # per-request causal span chains (repro_torch.obs.trace): last span
        # id and a per-request sequence counter for unique step-span ids
        self._tracing = (self.obs is not None
                         and getattr(self.obs, "trace_enabled", False))
        self._trace_prev: dict[int, str] = {}
        self._trace_seq: dict[int, int] = {}

    # ------------------------------------------------------------- lifecycle
    def _dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    def _admit_enc(self, st: RequestState) -> None:
        """enc-dec: run the encoder for the admitted request and write its
        output into the slot's row of the shared ``enc_out`` cache. The
        encoder runs on the request's float32 embeddings, as the
        reference's (a bf16 model's weights are promoted), and its output is
        rounded to the cache's dtype as it is written."""
        if not self.cfg.enc_dec:
            return
        emb = self._dev(np.asarray(st.request.embeds, np.float32)[None])  # (1, F, d)
        with torch.no_grad():
            one = T._run_encoder(self.cfg, self.params, emb, remat=False)
            self.cache["enc_out"][st.slot] = one[0].to(self.cache["enc_out"].dtype)

    def submit(self, req: Request) -> None:
        if req.rid in self.metrics.requests:
            raise ValueError(f"duplicate request id {req.rid}")
        total = len(req.prompt) + req.max_tokens
        if self.cfg.has_attention and self.cfg.sliding_window == 0 \
                and total > self.engine.max_len:
            raise ValueError(
                f"request {req.rid}: prompt+max_tokens {total} exceeds "
                f"max_len {self.engine.max_len} (full-attention cache)")
        if self.cfg.enc_dec:
            want = (self.cfg.frontend_tokens, self.cfg.d_model)
            got = None if req.embeds is None else tuple(np.shape(req.embeds))
            if got != want:
                raise ValueError(
                    f"request {req.rid}: enc-dec arch needs embeds of shape "
                    f"{want}, got {got}")
        self.scheduler.submit(req)
        self.metrics.requests[req.rid] = RequestMetrics(
            rid=req.rid, prompt_len=len(req.prompt), arrival_step=req.arrival_step)
        # worst case: the whole prompt streams via piggyback decode steps
        self._work_budget += req.arrival_step + req.max_tokens + len(req.prompt) + 2

    def in_flight(self) -> int:
        return sum(st is not None for st in self._slots)

    def pending(self) -> bool:
        return self.in_flight() > 0 or len(self.scheduler) > 0

    def _emit_token(self, st: RequestState, tok: int,
                    finished: list[RequestState], first: bool = False) -> None:
        st.generated.append(tok)
        self._last_tok[st.slot] = tok
        now = self.metrics.now()
        rm = self.metrics.requests[st.request.rid]
        if first:
            rm.first_token_wall = now
            rm.eligible_wall = self.scheduler.eligible_wall.get(st.request.rid, now)
        rm.n_generated = len(st.generated)
        self.metrics.generated_tokens += 1
        reason = stop_reason(st.request, st.generated)
        if reason:
            st.stop = reason
            st.phase = Phase.FINISHED
            rm.finish_wall = now
            rm.finish_step = self._step_count
            self._slots[st.slot] = None  # slot is immediately reusable
            self._temps[st.slot] = 0.0   # don't hold the sampled path open
            if self.obs is not None:
                self.metrics.observe_request(rm)
            finished.append(st)

    # ------------------------------------------------------------ programs
    def _fresh(self, cache: dict, fresh: np.ndarray) -> dict:
        """Zero the recurrent state of the rows in ``fresh`` (host bool)."""
        if self._recurrent and fresh.any():
            return _zero_fresh_state(cache, self._dev(fresh))
        return cache

    def _pick(self, last: torch.Tensor, sampled: bool) -> np.ndarray:
        """Tokens from the last logits (B, V), moved to the host: the
        step's one device-to-host copy."""
        if sampled:
            tok = _sample_tokens(last, self._gen, self._dev(self._temps.copy()))
        else:
            tok = _greedy_tokens(last)
        return tok.to(torch.int32).cpu().numpy()

    @torch.no_grad()
    def _prefill(self, tokens: np.ndarray, n_valid: np.ndarray, sampled: bool) -> np.ndarray:
        cache = self._fresh(self.cache, (self.positions == 0) & (n_valid > 0))
        logits, self.cache = self._prefill_fn(
            self.params, cache, self._dev(tokens), self._dev(self.positions.copy()),
            self._dev(n_valid))
        idx = np.clip(n_valid - 1, 0, tokens.shape[1] - 1)
        last = logits[torch.arange(logits.shape[0], device=self.device), self._dev(idx)]
        return self._pick(last.float(), sampled)

    @torch.no_grad()
    def _decode(self, token: np.ndarray, active: np.ndarray, sampled: bool) -> np.ndarray:
        # an active row at position 0 is a piggybacked first prompt token on
        # a freshly admitted slot: its recurrent state is zeroed here, as it
        # never passes through the prefill step
        cache = self._fresh(self.cache, active & (self.positions == 0))
        logits, self.cache = self._serve_fn(
            self.params, cache, self._dev(token[:, None]), self._dev(self.positions.copy()),
            self._dev(active))
        return self._pick(logits[:, 0].float(), sampled)

    # ------------------------------------------------------------------ step
    def step(self) -> list[RequestState]:
        """One engine iteration: admit, then run ONE step call — a gang
        prefill chunk when an admission wave justifies it, else a decode
        step that lone prefilling slots piggyback on (one prompt token at
        their own position). Returns the requests that finished during this
        step."""
        now_step = self._step_count
        self._step_count += 1
        self.metrics.engine_steps += 1
        t_step0 = self.metrics.now() if self.obs is not None else 0.0
        finished: list[RequestState] = []

        # admit() also stamps arrival eligibility on waiting requests, so it
        # runs even when no slot is free — queueing delay counts in TTFT
        free = [i for i, st in enumerate(self._slots) if st is None]
        for st in self.scheduler.admit(free, now_step, self.metrics.now()):
            self._slots[st.slot] = st
            self.positions[st.slot] = 0
            self._temps[st.slot] = st.request.temperature
            self.metrics.requests[st.request.rid].admit_step = now_step
            self._admit_enc(st)
            if self._tracing:
                rid = st.request.rid
                now = self.metrics.now()
                sid = f"r{rid}.admit"
                self.obs.trace_span(
                    "admit", trace=f"r{rid}", span=sid,
                    t0=self.scheduler.eligible_wall.get(rid, now), t1=now,
                    rid=rid, slot=st.slot)
                self._trace_prev[rid] = sid
                self._trace_seq[rid] = 0

        prefilling = [st for st in self._slots if st is not None
                      and st.phase is Phase.PREFILL]
        decoding = [st for st in self._slots if st is not None
                    and st.phase is Phase.DECODE]

        sampled = bool(np.any(self._temps > 0))
        gang_at = self.min_prefill_rows or max(1, len(decoding))
        if prefilling and (len(prefilling) >= gang_at or not decoding):
            tokens, n_valid = plan_chunk(prefilling, len(self._slots), self.chunk)
            tok = self._prefill(tokens, n_valid, sampled)
            for st in prefilling:
                m = int(n_valid[st.slot])
                st.prompt_done += m
                self.positions[st.slot] += m
                self.metrics.prompt_tokens += m
                if st.prompt_remaining == 0:
                    st.phase = Phase.DECODE
                    self._emit_token(st, int(tok[st.slot]), finished, first=True)
            self.metrics.prefill_chunks += 1
            self.metrics.touch()
            if self._tracing:
                t1 = self.metrics.now()
                for st in prefilling:
                    self._trace_step_span("prefill_chunk", st, t_step0, t1,
                                          tokens=int(n_valid[st.slot]))
            self._note_step("prefill", t_step0)
            return finished

        if decoding or prefilling:
            active = np.zeros((len(self._slots),), bool)
            token = self._last_tok.copy()
            for st in decoding:
                active[st.slot] = True
            for st in prefilling:  # piggyback: next prompt token, 1/step
                active[st.slot] = True
                token[st.slot] = st.request.prompt[st.prompt_done]
            tok = self._decode(token, active, sampled)
            for st in prefilling:
                st.prompt_done += 1
                self.positions[st.slot] += 1
                self.metrics.prompt_tokens += 1
                self.metrics.piggyback_tokens += 1
                if st.prompt_remaining == 0:
                    # this step consumed the last prompt token, so its
                    # logits already yield the first generated token
                    st.phase = Phase.DECODE
                    self._emit_token(st, int(tok[st.slot]), finished, first=True)
            for st in decoding:
                self.positions[st.slot] += 1
                self._emit_token(st, int(tok[st.slot]), finished)
            self.metrics.decode_steps += 1
            self.metrics.touch()
            if self._tracing:
                t1 = self.metrics.now()
                for st in prefilling:   # piggybacked prompt token
                    self._trace_step_span("prefill_chunk", st, t_step0, t1,
                                          tokens=1, piggyback=1)
                for st in decoding:
                    self._trace_step_span("decode", st, t_step0, t1)
            self._note_step("decode", t_step0)
        else:
            self.metrics.idle_steps += 1  # waiting on a future arrival_step
            self._note_step("idle", t_step0)
        return finished

    def _trace_step_span(self, kind: str, st: RequestState, t0: float,
                         t1: float, **attrs) -> None:
        """One node of a request's causal chain: admit -> prefill_chunk* ->
        decode* — each step span parented on the request's previous span."""
        rid = st.request.rid
        seq = self._trace_seq.get(rid, 0)
        self._trace_seq[rid] = seq + 1
        sid = f"r{rid}.{'p' if kind == 'prefill_chunk' else 'd'}{seq}"
        self.obs.trace_span(kind, trace=f"r{rid}", span=sid,
                            parent=self._trace_prev.get(rid),
                            t0=t0, t1=t1, rid=rid, slot=st.slot, **attrs)
        self._trace_prev[rid] = sid

    def _note_step(self, kind: str, t0: float) -> None:
        """Flush one step's telemetry at the step boundary."""
        if self.obs is None:
            return
        self.obs.duration("serve/step", self.metrics.now() - t0, kind=kind)
        self.obs.flush()

    # ------------------------------------------------------------------- run
    def run(self, requests=None) -> list[RequestState]:
        """Submit `requests` (optional) and step until everything finishes.
        Returns finished RequestStates sorted by request id."""
        for r in requests or ():
            self.submit(r)
        self.metrics.start()
        done: list[RequestState] = []
        guard = 2 * self._work_budget + 64
        while self.pending():
            done.extend(self.step())
            guard -= 1
            if guard <= 0:
                raise RuntimeError(
                    f"engine stalled: {self.in_flight()} in flight, "
                    f"{len(self.scheduler)} waiting after {self._step_count} steps")
        return sorted(done, key=lambda st: st.request.rid)


def _greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Greedy (temperature-0) tokens of (B, V) logits: ``argmax``, ties to
    the lowest index. The greedy steps draw nothing from the generator."""
    return torch.argmax(logits, dim=-1)


def _to(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
