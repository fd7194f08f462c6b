"""Decoder and encoder-decoder LM over ``ArchConfig``, the port of
``repro.models.transformer``, for every family of the registry: Mamba2
(``block_pattern=("mamba",)``, ``ffn_pattern=("none",)``), dense GQA
(``"attn"`` slots with RoPE, optional QKV bias and sliding window, and a
dense SwiGLU FFN: ``yi-6b``, ``qwen2.5-32b``, ``qwen2-72b``,
``granite-34b``), MoE FFN slots (``grok-1-314b``, and
``jamba-1.5-large-398b``, whose blocks mix Mamba2 and attention slots), MLA
attention slots (``attn_type="mla"``: ``deepseek-v2-lite-16b``, with MoE
and shared experts), the encoder-decoder (``enc_dec``:
``seamless-m4t-large-v2``, a non-causal encoder over the audio stub's
frames and a cross-attention layer after every decoder block) and the
vision stub (``internvl2-1b``: the caller's patch embeddings go before the
tokens, ``frontend_embeds``; an audio frontend without ``enc_dec`` does the
same, as the reference's).

Parameters are the reference's nested dict, blocks stacked along a leading
``n_blocks`` dimension (the encoder's along ``n_enc_layers``, the cross
layers' along ``n_blocks``), so a JAX ``init_params`` pytree carries across
with ``repro_torch.convert.lm_params_from_numpy``. The stacked layers are
walked by a Python loop (PyTorch runs eagerly: the reference's ``unroll``
steers XLA and has no counterpart here). ``remat=True``, the reference's
default, recomputes each block (with its cross layer) and each encoder
layer in the backward pass (``torch.utils.checkpoint``, non-reentrant):
it changes the memory a gradient takes, not the numbers, and does nothing
when no gradient is taken. Embeddings are tied when ``cfg.tie_embeddings``
(head = embed.T).

Public API: init_params / abstract_params / forward_train / loss_fn /
init_cache / decode_step / prefill_chunk (the serve engine's chunked
prefill), and ``_run_encoder`` under the reference's name. Each takes an
optional model ``axis`` (``dist.parallel.MeshAxis``): the parameters and
the cache are then this rank's blocks, and the embedding lookup and the
logits are whole on every rank (``_embed``, ``_logits``). ``forward_train``
and ``loss_fn`` also take a ``data_axis``, over which the MoE aux loss is
the global batch's (``layers.moe_route``). The parameters'
dtype, float32 (the default here) or bf16 (the reference's default), sets
the activations' (``models.layers`` keeps the reference's float32 islands):
the embedding rows are in it, as the reference's ``embed[tokens]`` cast to
the embedding's dtype; frontend embeddings are cast to it before the
blocks or the encoder; the logits come out in it and ``loss_fn`` takes its
log-softmax in float32. ``_run_encoder`` computes in its input's dtype: the
serve engine hands it float32 frame embeddings, as the reference's engine
does, and a bf16 model's weights are then upcast layer by layer, as JAX
promotes them. float32 products run with TF32 off, bf16 ones with float32
sums (``repro_torch.device``).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig

__all__ = ["init_params", "abstract_params", "forward_train", "loss_fn", "init_cache",
           "decode_step", "prefill_chunk"]


def _check_supported(cfg: ArchConfig) -> None:
    for i, kind in enumerate(cfg.block_pattern):
        if kind not in ("attn", "mamba"):
            raise ValueError(f"{cfg.name}: slot {i} is {kind!r}; slots are 'attn' or 'mamba'")
    if cfg.attn_type not in ("gqa", "mla"):
        raise ValueError(f"{cfg.name}: attn_type {cfg.attn_type!r} is not 'gqa' or 'mla'")
    if cfg.frontend not in ("none", "vision", "audio"):
        raise ValueError(f"{cfg.name}: frontend {cfg.frontend!r} is not 'none', "
                         f"'vision' or 'audio'")


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _unstack(tree, n: int) -> list:
    """A tree stacked n deep -> n trees of views (``torch.unbind`` a leaf).
    Its gradient is one stack of the layers' gradients, where indexing each
    layer out would give each layer a zero-filled gradient of the whole
    stack to add up."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _init_slot(gen: torch.Generator, cfg: ArchConfig, slot: int, dev, dtype) -> dict:
    ones = lambda: torch.ones(cfg.d_model, dtype=dtype, device=dev)  # noqa: E731
    p = {"norm1": ones()}
    if cfg.block_pattern[slot] == "mamba":
        p["mixer"] = L.init_mamba(gen, cfg, dev, dtype)
    elif cfg.attn_type == "mla":
        p["mixer"] = L.init_mla(gen, cfg, dev, dtype)
    else:
        p["mixer"] = L.init_attn(gen, cfg, dev, dtype)
    fk = cfg.ffn_kind(slot)
    if fk != "none":
        p["norm2"] = ones()
    if fk == "moe":
        p["ffn"] = L.init_moe(gen, cfg, dev, dtype)
    elif fk == "dense":
        p["ffn"] = L.init_ffn(gen, cfg.d_model, cfg.d_ff, dev, dtype)
    return p


def _init_enc_layer(gen: torch.Generator, cfg: ArchConfig, dev, dtype) -> dict:
    """An encoder layer: GQA self-attention (non-causal at run time) and a
    dense SwiGLU FFN, each behind its RMS norm."""
    ones = lambda: torch.ones(cfg.d_model, dtype=dtype, device=dev)  # noqa: E731
    return {"norm1": ones(), "norm2": ones(), "mixer": L.init_attn(gen, cfg, dev, dtype),
            "ffn": L.init_ffn(gen, cfg.d_model, cfg.d_ff, dev, dtype)}


def _init_cross_layer(gen: torch.Generator, cfg: ArchConfig, dev, dtype) -> dict:
    """A decoder block's cross-attention over the encoder's output."""
    return {"norm": torch.ones(cfg.d_model, dtype=dtype, device=dev),
            "mixer": L.init_attn(gen, cfg, dev, dtype)}


def _into(stacked, tree, i: int) -> None:
    """Copy one layer's parameters into row ``i`` of the stacked ones."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _into(stacked[k], v, i)
    else:
        stacked[i].copy_(tree)


def _expand(tree, n: int):
    """One layer's tree -> an uninitialised tree stacked n deep."""
    if isinstance(tree, dict):
        return {k: _expand(v, n) for k, v in tree.items()}
    return tree.new_empty((n, *tree.shape))


def _init_stacked(make, n: int):
    """``make()`` called n times, one after another, each result written
    into tensors stacked along a leading dim of n, in each leaf's own dtype:
    at most one layer exists twice (and only one leaf's float32 draw, in
    ``layers._dense``), so a bf16 stack never has a float32 copy."""
    first = make()
    stacked = _expand(first, n)
    _into(stacked, first, 0)
    del first
    for i in range(1, n):
        _into(stacked, make(), i)
    return stacked


def _normal(gen: torch.Generator, shape, dev, dtype) -> torch.Tensor:
    """0.02 * normal, drawn in float32 on the generator's device (scaled in
    place: one float32 temporary), then cast: the embedding and the head.
    On the meta device, an empty tensor and no draw."""
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    return torch.randn(shape, generator=gen, device=gen.device).mul_(0.02).to(dev, dtype)


def init_params(cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32,
                device: str | torch.device = "cuda") -> dict:
    """Random init with the reference's tree, shapes, scales and dtypes,
    drawn from ``gen`` on the generator's own device (its draws are not
    JAX's bits): a ``torch.Generator("cuda")`` fills a full-width model on
    the card, a CPU generator draws on the host. ``dtype`` is float32 or
    bf16; every leaf is in it but the float32 ones the reference keeps
    (``A_log``, ``D``, ``dt_bias``, a MoE ``router``), each drawn in float32
    and cast. The blocks are drawn first, one after another, in the same
    order whatever the device or dtype, then the embedding and the head,
    then the encoder layers and the cross layers of an encoder-decoder; each
    stack is written layer by layer into its tensors. On ``device="meta"``
    every leaf is empty and nothing is drawn (``gen`` may be None)."""
    _check_supported(cfg)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype {dtype}: the LM path runs float32 or bfloat16")
    dev = torch.device(device)
    if dev.type != "meta":
        dev = resolve_device(dev)
    blocks = _init_stacked(lambda: {f"slot{i}": _init_slot(gen, cfg, i, dev, dtype)
                                    for i in range(len(cfg.block_pattern))}, cfg.n_blocks)
    params = {
        "embed": _normal(gen, (cfg.vocab, cfg.d_model), dev, dtype),
        "final_norm": torch.ones(cfg.d_model, dtype=dtype, device=dev),
        "blocks": blocks,
    }
    if not cfg.tie_embeddings:
        params["head"] = _normal(gen, (cfg.d_model, cfg.vocab), dev, dtype)
    if cfg.enc_dec:
        params["encoder"] = _init_stacked(lambda: _init_enc_layer(gen, cfg, dev, dtype),
                                          cfg.n_enc_layers)
        params["cross"] = _init_stacked(lambda: _init_cross_layer(gen, cfg, dev, dtype),
                                        cfg.n_blocks)
        params["enc_norm"] = torch.ones(cfg.d_model, dtype=dtype, device=dev)
    return params


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def abstract_params(cfg: ArchConfig, dtype=torch.bfloat16) -> dict:
    """The tree ``init_params(cfg, gen, dtype)`` builds, as tensors on the
    meta device: its shapes and dtypes with no memory and no draw (the
    reference's ``jax.eval_shape`` of its ``init_params``)."""
    return init_params(cfg, None, dtype, device="meta")


def _head(cfg: ArchConfig, params: dict) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def _active(axis) -> bool:
    return axis is not None and axis.size > 1


def _embed(cfg: ArchConfig, params: dict, tokens: torch.Tensor, axis=None) -> torch.Tensor:
    """The embedding rows of ``tokens``. On a model ``axis``, an embedding
    split on the vocab is a masked lookup of this rank's rows summed over
    the axis (one non-zero term: exact), one split on d a lookup of this
    rank's columns, gathered."""
    emb = params["embed"]
    if not _active(axis):
        return emb[tokens]
    dim = axis.model_dim("embed", (cfg.vocab, cfg.d_model))
    if dim == 0:
        lo, hi = axis.span(cfg.vocab)
        local = tokens - lo
        mine = (local >= 0) & (local < hi - lo)
        rows = emb[local.clamp(0, hi - lo - 1)]
        zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
        return axis.sum(torch.where(mine[..., None], rows, zero))
    rows = emb[tokens]
    return axis.all_gather(rows, -1) if dim == 1 else rows


def _logits(cfg: ArchConfig, params: dict, x: torch.Tensor, axis=None) -> torch.Tensor:
    """x @ head. On a model ``axis`` the logits are whole on every rank: a
    head split on the vocab gives this rank's columns (x entering the
    rank's share), gathered; a head split elsewhere (an odd vocab falls to
    d) is gathered before use."""
    if not _active(axis):
        return x @ _head(cfg, params)
    v, d = cfg.vocab, cfg.d_model
    if cfg.tie_embeddings:
        if axis.model_dim("embed", (v, d)) == 0:
            return axis.all_gather(axis.enter(x) @ params["embed"].T, -1)
        return x @ axis.whole(params["embed"], "embed", (v, d)).T
    if axis.splits("head", (d, v), 1):
        return axis.all_gather(axis.enter(x) @ params["head"], -1)
    return x @ axis.whole(params["head"], "head", (d, v))


def _ffn(p: dict, x: torch.Tensor, cfg: ArchConfig, slot: int, per_token: bool = False,
         axis=None, data_axis=None):
    """The slot's FFN on the residual x -> (x + ffn(norm2(x)), aux).
    ``per_token`` dispatches a MoE FFN in groups of one token (the chunked
    prefill's, so its capacity is decode's: a group over the chunk could
    drop a choice that decode keeps)."""
    fk = cfg.ffn_kind(slot)
    if fk == "none":
        return x, None
    h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    if fk == "moe":
        b, l, d = h.shape
        if per_token:
            h = h.reshape(b * l, 1, d)
        h, aux = L.moe_apply(p["ffn"], h, cfg, axis=axis, data_axis=data_axis)
        return x + h.reshape(b, l, d), aux
    return x + L.ffn_apply(p["ffn"], h, axis=axis, ff=cfg.d_ff), None


def _apply_slot(p: dict, x: torch.Tensor, cfg: ArchConfig, slot: int, cos, sin, axis=None,
                data_axis=None):
    """One slot of a block -> (x, aux loss of its MoE FFN, or None)."""
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if cfg.block_pattern[slot] == "mamba":
        x = x + L.mamba_train(p["mixer"], h, cfg)
    elif cfg.attn_type == "mla":
        x = x + L.mla_train(p["mixer"], h, cfg, cos, sin, axis=axis)
    else:
        x = x + L.attn_train(p["mixer"], h, cfg, cos, sin, axis=axis)
    return _ffn(p, x, cfg, slot, axis=axis, data_axis=data_axis)


def _cross(cp: dict, x: torch.Tensor, cfg: ArchConfig, enc_out: torch.Tensor,
           axis=None) -> torch.Tensor:
    """A decoder block's cross layer: x + attention over ``enc_out`` (whole)."""
    hn = L.rms_norm(x, cp["norm"], cfg.norm_eps)
    return x + L.attn_train(cp["mixer"], hn, cfg, None, None, kv_override=enc_out, axis=axis)


def _remat(fn, remat: bool, *args):
    """fn(*args), recomputed in the backward pass when ``remat`` and a
    gradient is being taken; a plain call otherwise."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _enc_layer(cfg: ArchConfig, lp: dict, h: torch.Tensor, cos, sin, axis=None) -> torch.Tensor:
    hn = L.rms_norm(h, lp["norm1"], cfg.norm_eps)
    h = h + L.attn_train(lp["mixer"], hn, cfg, cos, sin, causal=False, axis=axis)
    return h + L.ffn_apply(lp["ffn"], L.rms_norm(h, lp["norm2"], cfg.norm_eps), axis=axis,
                         ff=cfg.d_ff)


def _run_encoder(cfg: ArchConfig, params: dict, embeds: torch.Tensor,
                 remat: bool = True, axis=None) -> torch.Tensor:
    """The encoder over frame embeddings (B, F, d): per layer, non-causal
    self-attention with RoPE over positions 0..F-1 and a SwiGLU FFN, each
    behind its norm and added to the residual; then ``enc_norm``. With
    ``remat`` each layer is recomputed in the backward pass. On a model
    ``axis`` the output is whole on every rank."""
    cos, sin = L.rope_freqs(torch.arange(embeds.shape[1], device=embeds.device),
                            cfg.head_dim_, cfg.rope_theta)
    h = embeds
    for lp in _unstack(params["encoder"], cfg.n_enc_layers):
        if h.dtype == torch.float32:
            # JAX promotes a bf16 model's weights against float32 frames (the
            # serve engine's, at admission): upcast each layer's as it is used.
            lp = _tree_map(torch.Tensor.float, lp)
        h = _remat(lambda lp, h: _enc_layer(cfg, lp, h, cos, sin, axis), remat, lp, h)
    return L.rms_norm(h, params["enc_norm"], cfg.norm_eps)


def _block(cfg: ArchConfig, bp: dict, cp: dict | None, x: torch.Tensor, cos, sin,
           enc_out: torch.Tensor | None, axis=None, data_axis=None):
    """One block's slots, then its cross layer -> (x, aux of its MoE slots)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(len(cfg.block_pattern)):
        x, a = _apply_slot(bp[f"slot{i}"], x, cfg, i, cos, sin, axis, data_axis)
        if a is not None:
            aux = aux + a
    if cp is not None:
        x = _cross(cp, x, cfg, enc_out, axis)
    return x, aux


def forward_train(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                  frontend_embeds: torch.Tensor | None = None, remat: bool = True, axis=None,
                  data_axis=None):
    """tokens (B, S) int -> (logits (B, S, V), aux loss: the sum of the MoE
    slots' over every block, 0 without them).

    ``frontend_embeds`` (B, F, d) are the stub frontend's: with ``enc_dec``
    they are the encoder's input, the text keeps positions 0..S-1 and every
    block ends with a cross layer over the encoder's output; otherwise (the
    vision stub, or audio without an encoder) they go before the tokens,
    RoPE runs over all F + S positions and the first F are cut after the
    final norm. RoPE is built at ``cfg.mla.qk_rope_dim`` for MLA, at the
    head dim otherwise. ``remat`` recomputes each block (with its cross
    layer) and each encoder layer in the backward pass.

    On a model ``axis`` (``dist.parallel.MeshAxis``) ``params`` is this
    rank's block (``sharding.param_specs``); the residual stream, the aux
    loss and the logits are whole, the same on every rank. On a
    ``data_axis`` the tokens are this rank's rows of the global batch and
    the aux loss is the global batch's, the same on every rank. The
    encoder's output enters the rank's share once for every cross layer
    (``axis.enter``: one sum of its gradient, not one a layer)."""
    _check_supported(cfg)
    x = _embed(cfg, params, tokens, axis)
    n_front, enc_out = 0, None
    if cfg.enc_dec:
        if frontend_embeds is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder needs frontend_embeds")
        enc_out = _run_encoder(cfg, params, frontend_embeds.to(x.dtype), remat, axis)
        if L.kv_local(cfg, axis):
            enc_out = axis.enter(enc_out)
    elif frontend_embeds is not None:
        n_front = frontend_embeds.shape[1]
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    rope_dim = cfg.mla.qk_rope_dim if cfg.attn_type == "mla" else cfg.head_dim_
    cos, sin = L.rope_freqs(positions, rope_dim, cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    crosses = (_unstack(params["cross"], cfg.n_blocks) if enc_out is not None
               else [None] * cfg.n_blocks)
    for bp, cp in zip(_unstack(params["blocks"], cfg.n_blocks), crosses):
        x, a = _remat(lambda bp, cp, x, enc_out: _block(cfg, bp, cp, x, cos, sin, enc_out,
                                                        axis, data_axis),
                      remat, bp, cp, x, enc_out)
        aux = aux + a
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if n_front:
        x = x[:, n_front:]
    return _logits(cfg, params, x, axis), aux


def loss_fn(cfg: ArchConfig, params: dict, batch: dict, remat: bool = True,
            axis=None, data_axis=None, span: tuple[int, int] | None = None) -> torch.Tensor:
    """batch: {"tokens": (B,S), "labels": (B,S), optional "embeds": (B,F,d)}
    -> mean next-token NLL + aux. ``data_axis``: as :func:`forward_train`'s.
    ``span`` (lo, hi): the NLL over positions [lo, hi) alone, whose labels
    ``batch["labels"]`` (B, hi - lo) then holds (a data-parallel rank's
    share of a batch split on the sequence)."""
    logits, aux = forward_train(cfg, params, batch["tokens"], batch.get("embeds"), remat,
                                axis, data_axis)
    if span is not None:
        logits = logits[:, span[0]:span[1]]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, batch["labels"][..., None].long())[..., 0]
    return nll.mean() + aux


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.float32,
               device: str | torch.device = "cuda", enc_len: int = 0, axis=None) -> dict:
    """Stacked (n_blocks-leading) cache: attention slots hold a ring buffer
    of min(max_len, window) k/v slots (MLA: its compressed c_kv and k_rope),
    Mamba2 slots their recurrent state (which ``max_len`` does not size).
    An encoder-decoder also holds ``enc_out`` (B, enc_len or
    frontend_tokens, d), zeros until the caller puts the encoder's output
    there. On a model ``axis`` each leaf is this rank's block, at the local
    shape ``sharding.cache_specs`` gives (the KV heads of k/v, d of
    ``enc_out``). ``batch`` is the rows this cache holds: on a data axis the
    caller passes its rank's (``sharding.slot_rows``). ``device="meta"``
    gives the cache's shapes and dtypes with no memory (the dry run's)."""
    _check_supported(cfg)
    dev = torch.device("meta") if torch.device(device).type == "meta" else resolve_device(device)
    if _active(axis):
        whole = _init_cache(cfg, batch, max_len, dtype, torch.device("meta"), enc_len)

        def local(name, leaf):
            if isinstance(leaf, dict):
                return {k: local(k, v) for k, v in leaf.items()}
            shape = list(leaf.shape)
            dim = axis.cache_dim(name, shape)
            if dim is not None:
                shape[dim] //= axis.size
            return torch.zeros(shape, dtype=leaf.dtype, device=dev)

        return {k: local(k, v) for k, v in whole.items()}
    return _init_cache(cfg, batch, max_len, dtype, dev, enc_len)


def _init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, dev, enc_len: int) -> dict:
    def one(i):
        if cfg.block_pattern[i] == "mamba":
            return L.init_cache_mamba(cfg, batch, dtype, dev)
        if cfg.attn_type == "mla":
            return L.init_cache_mla(cfg, batch, max_len, dtype, dev)
        return L.init_cache_attn(cfg, batch, max_len, dtype, dev)

    cache = {
        "slots": {f"slot{i}": _stack([one(i) for _ in range(cfg.n_blocks)])
                  for i in range(len(cfg.block_pattern))},
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }
    if cfg.enc_dec:
        cache["enc_out"] = torch.zeros(batch, enc_len or cfg.frontend_tokens, cfg.d_model,
                                       dtype=dtype, device=dev)
    return cache


def _cached_pass(cfg: ArchConfig, params: dict, cache: dict, x: torch.Tensor, mix,
                 per_token: bool, axis=None, rows: torch.Tensor | None = None):
    """The blocks over the cache: each slot's mixer is ``mix(kind, mixer
    params, normed x, the slot's cache)`` -> (out, new slot cache), then its
    FFN, then an encoder-decoder's cross layer over ``cache["enc_out"]`` (its
    K/V projected anew each call, as the reference does; on a model ``axis``
    a split ``enc_out`` is gathered once a call) -> (logits, new cache);
    cache["pos"] is carried over as it is. ``rows`` (B,) takes one position
    a row before the head: logits (B, 1, V)."""
    new_slots = {f"slot{i}": [] for i in range(len(cfg.block_pattern))}
    slots = {k: _unstack(v, cfg.n_blocks) for k, v in cache["slots"].items()}
    crosses = _unstack(params["cross"], cfg.n_blocks) if cfg.enc_dec else None
    enc_out = cache.get("enc_out")
    if cfg.enc_dec and _active(axis) and axis.cache_dim("enc_out", (
            enc_out.shape[0], enc_out.shape[1], cfg.d_model)) == 2:
        enc_out = axis.all_gather(enc_out, 2)
    for blk, bp in enumerate(_unstack(params["blocks"], cfg.n_blocks)):
        for i, kind in enumerate(cfg.block_pattern):
            p = bp[f"slot{i}"]
            hn = L.rms_norm(x, p["norm1"], cfg.norm_eps)
            out, nc = mix(kind, p["mixer"], hn, slots[f"slot{i}"][blk])
            x = x + out
            new_slots[f"slot{i}"].append(nc)
            x, _ = _ffn(p, x, cfg, i, per_token, axis)
        if cfg.enc_dec:
            x = _cross(crosses[blk], x, cfg, enc_out, axis)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if rows is not None:
        x = x[torch.arange(x.shape[0], device=x.device), rows][:, None]
    new_cache = dict(cache)
    new_cache["slots"] = {k: _stack(v) for k, v in new_slots.items()}
    return _logits(cfg, params, x, axis), new_cache


def decode_step(cfg: ArchConfig, params: dict, cache: dict, token: torch.Tensor,
                positions: torch.Tensor | None = None,
                active: torch.Tensor | None = None, axis=None):
    """token (B, 1) int -> (logits (B, 1, V), new cache).

    Lockstep mode (``positions=None``): every row is at cache["pos"], which
    advances by one. Slot mode: ``positions`` (B,) gives each row its own
    absolute position and cache["pos"] is left untouched. ``active`` (B,)
    bool freezes the cache of inactive rows. An encoder-decoder's cross
    layers attend ``cache["enc_out"]``, its K/V projected anew every step,
    as the reference does. On a model ``axis``, ``params`` and ``cache`` are
    this rank's blocks and the logits are whole."""
    _check_supported(cfg)
    pos = cache["pos"] if positions is None else positions

    def mix(kind, p, hn, c):
        if kind == "mamba":
            return L.mamba_decode(p, hn, c, cfg, active=active)
        if cfg.attn_type == "mla":
            return L.mla_decode(p, hn, c, pos, cfg, active=active, axis=axis)
        return L.attn_decode(p, hn, c, pos, cfg, active=active, axis=axis)

    logits, new_cache = _cached_pass(cfg, params, cache, _embed(cfg, params, token, axis), mix,
                                     False, axis)
    if positions is None:
        new_cache["pos"] = cache["pos"] + 1
    return logits, new_cache


def prefill_chunk(cfg: ArchConfig, params: dict, cache: dict, tokens: torch.Tensor,
                  positions: torch.Tensor, n_valid: torch.Tensor, axis=None,
                  last: bool = False):
    """Chunked batched prefill into the decode cache, the reference's.

    tokens (B, C) int, the next chunk of each row's prompt, right-padded;
    ``positions`` (B,) the absolute position of each row's first chunk
    token; ``n_valid`` (B,) the real tokens of each row (0: the row, a
    decoding or free slot, is untouched). Returns (logits (B, C, V), new
    cache); logits at j >= n_valid[r] are finite and meaningless, and
    cache["pos"] is not read (the caller keeps each row's position).
    Attention slots go through ``attn_prefill``/``mla_prefill``, Mamba2
    slots through ``mamba_prefill`` (bit for bit the decode step), a MoE
    FFN dispatches one token at a time (decode's capacity), and an
    encoder-decoder's cross layers attend ``cache["enc_out"]`` through
    ``block_attention`` (Lq = C). On a model ``axis``, as
    :func:`decode_step`. ``last`` returns only each row's logits at its last
    real token (position n_valid - 1, 0 for an empty row): (B, 1, V), the
    head run on those rows alone (a tensor-parallel engine then gathers B
    rows of logits, not B x C)."""
    _check_supported(cfg)

    def mix(kind, p, hn, c):
        if kind == "mamba":
            return L.mamba_prefill(p, hn, c, n_valid, cfg)
        if cfg.attn_type == "mla":
            return L.mla_prefill(p, hn, c, positions, n_valid, cfg, axis=axis)
        return L.attn_prefill(p, hn, c, positions, n_valid, cfg, axis=axis)

    rows = (n_valid - 1).clamp(0, tokens.shape[1] - 1).long() if last else None
    return _cached_pass(cfg, params, cache, _embed(cfg, params, tokens, axis), mix, True, axis,
                        rows)
