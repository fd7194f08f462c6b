"""Layer primitives of the language-model zoo, the port of
``repro.models.layers``: RMSNorm, RoPE, GQA attention (QKV bias, MQA,
sliding-window ring cache; non-causal for an encoder, and cross-attention
over an encoder's output), MLA (DeepSeek's compressed-KV attention in the
reference's absorbed form), the SwiGLU FFN, the top-k mixture of SwiGLU
experts with capacity (``moe_apply``), and the Mamba2 SSD mixer (chunked
full-sequence scan and O(1) recurrent decode).

Plain functions over explicit parameter dicts, in the reference's layouts,
so weights carry across unchanged. Two things here were Pallas kernels in
the JAX package, and each always goes to its kernel module, whose tensors'
device picks the route (the kernel on the card, its plain version on the
CPU): the SSD scan (``mamba_train`` -> ``kernels.ssd_scan.ssd_chunked``;
``cfg.use_pallas_ssd`` is read by nothing here) and full-sequence
attention (``attn_train`` -> ``kernels.block_attn.block_attention``, where
the reference's ``attn_train`` materializes the softmax; the causal,
non-causal and cross-attention calls alike). Decode's one-token attention
over the ring cache, the chunked prefill's (``attn_prefill``: a mask over
the ring snapshot and the chunk) and MLA's latent attention are plain
torch, as the reference computes them outside any kernel; ``mamba_prefill``
is the recurrent decode step over the chunk, as the reference's.

Precision: the parameters' dtype, float32 or bf16, with the reference's
dtype flow op for op: activations in the parameters' dtype, norm and
softmax statistics, RoPE, the SSD's ``dt`` and decay, and the MoE router
in float32 (``A_log``, ``D``, ``dt_bias`` and ``router`` are float32
leaves in either mode). A product takes operands of one dtype: where JAX
promotes a float32 activation against bf16 weights (the encoder run on
the serve engine's float32 frame embeddings), the caller upcasts the
weights (``transformer._run_encoder``). ``cfg.attn_logits_bf16`` keeps the
materialized (decode and chunked-prefill) attention scores in the
activations' dtype, as the reference's ``_sdpa``; ``block_attention``
ignores it, as the reference's Pallas kernel would. The causal depthwise
convolution is the reference's sum of shifted products, not ``F.conv1d``
(which cuDNN runs in TF32 by default on the card), and softplus is
``jax.nn.softplus``'s ``max(x, 0) + log1p(exp(-|x|))`` (``F.softplus``
switches to ``x`` above a threshold of 20).

Random init draws on the generator's own device (``_dense``): a CUDA
generator fills a full-width model on the card, a CPU generator draws on
the host and moves the result. Each leaf is drawn in float32, scaled and
cast to the asked dtype (round to nearest even, as XLA's ``astype``).

Tensor parallelism: the attention, MLA, FFN and MoE functions take an
optional ``axis`` (``dist.parallel.MeshAxis``), None by default, which
changes nothing. On an axis their parameters are this rank's blocks by
``dist.sharding``'s specs and the residual stream is whole on every rank:
attention computes this rank's query and K/V heads (:func:`_heads`; MQA's
K/V gathered whole), the FFN its columns, MoE its experts or each expert's
columns with the routing global, and each row-parallel product is summed
over the axis in float32 (:func:`_partial`); MLA and the Mamba mixer run
whole, as the reference's split guard and ``_SSM_DATA_ONLY`` keep them.
Attention still calls ``block_attention``, on the local heads.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.block_attn import ops as attn_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.config import ArchConfig

__all__ = [
    "rms_norm",
    "rope_freqs",
    "apply_rope",
    "init_attn",
    "attn_train",
    "attn_decode",
    "attn_prefill",
    "init_cache_attn",
    "init_mla",
    "mla_train",
    "init_cache_mla",
    "mla_decode",
    "mla_prefill",
    "init_ffn",
    "ffn_apply",
    "init_moe",
    "moe_route",
    "moe_apply",
    "init_mamba",
    "mamba_train",
    "init_cache_mamba",
    "mamba_decode",
    "mamba_prefill",
]

_NEG = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) as max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _dense(gen: torch.Generator, shape, device, dtype=torch.float32,
           scale=None) -> torch.Tensor:
    """normal * scale (1/sqrt(fan_in) by default), drawn in float32 from
    ``gen`` on the generator's own device, then cast to ``dtype`` on
    ``device`` (the reference's ``_dense``); on the meta device, an empty
    tensor and no draw."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    # Scaled in place: one full-size temporary less (a Grok expert leaf is 6.4 GB).
    return torch.randn(shape, generator=gen, device=gen.device).mul_(scale).to(device, dtype)


# --------------------------------------------------------------------- RoPE
def rope_freqs(positions: torch.Tensor, dim: int, theta: float):
    """positions (...,) -> cos/sin (..., dim/2) in float32; the inverse
    frequencies ``theta ** (arange(0, dim, 2) / dim)`` in float32, as the
    reference computes them."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    inv = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., L, n, dim); cos/sin (..., L, dim/2) broadcast over the heads;
    rotate-half layout (the two halves of the head dimension)."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ------------------------------------------------------------ GQA attention
def init_attn(gen: torch.Generator, cfg: ArchConfig, device, dtype=torch.float32) -> dict:
    """The reference's shapes, scales and dtypes; the draws are ``gen``'s,
    not JAX's. QKV biases start at zero, as the reference's."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    p = {
        "wq": _dense(gen, (d, h * hd), device, dtype),
        "wk": _dense(gen, (d, kv * hd), device, dtype),
        "wv": _dense(gen, (d, kv * hd), device, dtype),
        "wo": _dense(gen, (h * hd, d), device, dtype),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", kv * hd), ("bv", kv * hd)):
            p[name] = torch.zeros(width, dtype=dtype, device=device)
    return p


class _Heads(NamedTuple):
    """How a rank of the model axis computes an attention layer."""

    p: dict          # wq wk wv wo (and the QKV biases) as this rank uses them
    h: int           # query heads computed here
    kv: int          # K/V heads computed (and cached) here
    take: object     # None, a slice or an index tensor: the K/V heads of those
                     # that the local queries attend
    n_rep: int       # query heads a K/V head of ``take``
    reduce: bool     # the output projection is a partial sum over the axis


def _heads(p: dict, cfg: ArchConfig, axis=None) -> _Heads:
    """The attention layer's plan on ``axis`` (``dist.parallel.MeshAxis``;
    None: one device, every head). Where the specs split ``wq`` and ``wo`` at
    head boundaries, this rank computes its H/m query heads and its partial
    output projection; its K/V heads too where ``wk``/``wv`` split at head
    boundaries (KV % m == 0), else it computes every K/V head from the
    gathered weights (MQA) and its queries attend the heads they map to.
    Where the query heads do not split, every leaf is gathered and the layer
    is computed whole, the same on every rank."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    if axis is None or axis.size == 1:
        return _Heads(p, h, kv, None, h // kv, False)
    biases = {b: p[b] for b in ("bq", "bk", "bv") if b in p}
    shapes = {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd), "wo": (h * hd, d)}
    if not (axis.splits("wq", shapes["wq"], 1, hd) and axis.splits("wo", shapes["wo"], 0, hd)):
        w = {name: axis.whole(p[name], name, shape) for name, shape in shapes.items()}
        return _Heads({**w, **biases}, h, kv, None, h // kv, False)
    lo, hi = axis.span(h)
    w = {"wq": p["wq"], "wo": p["wo"], **biases}
    if "bq" in p:
        w["bq"] = p["bq"][lo * hd:hi * hd]
    if axis.splits("wk", shapes["wk"], 1, hd):
        klo, khi = axis.span(kv)
        w["wk"], w["wv"] = p["wk"], p["wv"]
        if "bk" in p:
            w["bk"], w["bv"] = p["bk"][klo * hd:khi * hd], p["bv"][klo * hd:khi * hd]
        return _Heads(w, hi - lo, khi - klo, None, h // kv, True)
    w["wk"] = axis.whole(p["wk"], "wk", shapes["wk"])
    w["wv"] = axis.whole(p["wv"], "wv", shapes["wv"])
    groups = [q // (h // kv) for q in range(lo, hi)]           # each local query's K/V head
    n_kv = groups[-1] - groups[0] + 1
    rep = (hi - lo) // n_kv
    if rep * n_kv == hi - lo and all(g - groups[0] == i // rep for i, g in enumerate(groups)):
        return _Heads(w, hi - lo, kv, slice(groups[0], groups[-1] + 1), rep, True)
    return _Heads(w, hi - lo, kv, torch.tensor(groups), 1, True)


def _take(hs: _Heads, k: torch.Tensor, v: torch.Tensor):
    """The K/V heads (dim 2) the local queries attend."""
    if hs.take is None:
        return k, v
    if isinstance(hs.take, slice):
        return k[:, :, hs.take], v[:, :, hs.take]
    idx = hs.take.to(k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _partial(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A row-parallel block's product x @ w in float32, left unrounded: the
    ranks' partials are summed in float32 and rounded once to the model's
    dtype, as the whole product rounds once (a bf16 partial rounded on each
    rank would round twice)."""
    return x.float() @ w.float()


def _out(hs: _Heads, out: torch.Tensor, axis) -> torch.Tensor:
    """The output projection of the attention ``out`` (B, L, h, hd), summed
    over the axis when it is partial."""
    b, l = out.shape[:2]
    if hs.reduce:
        return axis.sum(_partial(out.reshape(b, l, -1), hs.p["wo"])).to(out.dtype)
    return out.reshape(b, l, -1) @ hs.p["wo"]


def _qkv(hs: _Heads, x: torch.Tensor, cfg: ArchConfig):
    b, l, _ = x.shape
    hd = cfg.head_dim_
    p = hs.p
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q.reshape(b, l, hs.h, hd), k.reshape(b, l, hs.kv, hd), v.reshape(b, l, hs.kv, hd)


def _sdpa(q, k, v, mask, n_rep: int, logits_bf16: bool = False):
    """The reference's materialized attention, for decode's one-token query
    and the chunked prefill: q (B,Lq,H,hd), k/v (B,Lk,KV,hd); mask (B|1, 1,
    Lq, Lk) additive f32.

    ``logits_bf16`` (``cfg.attn_logits_bf16``) keeps the (Lq x Lk) scores
    in the scores' own dtype (bf16 for a bf16 model), the mask cast to it,
    and takes ``jax.nn.softmax``'s steps in that dtype: the row max, exp of
    the difference, and the division by the row sum (summed in float32 and
    rounded, as ``jnp.sum`` of bf16). Otherwise the scores go to float32
    first."""
    b, lq, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, lq, kv, n_rep, hd)
    if logits_bf16:
        logits = torch.einsum("bqgrh,bkgh->bgrqk", qg, k)
        logits = logits / math.sqrt(hd) + mask[:, :, None].to(logits.dtype)
        e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        w = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype)
    else:
        logits = torch.einsum("bqgrh,bkgh->bgrqk", qg, k).to(torch.float32)
        logits = logits / math.sqrt(hd) + mask[:, :, None]
        w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bgrqk,bkgh->bqgrh", w, v)
    return out.reshape(b, lq, h, hd)


def attn_train(p: dict, x: torch.Tensor, cfg: ArchConfig, cos, sin, causal: bool = True,
               kv_override: torch.Tensor | None = None, axis=None) -> torch.Tensor:
    """Full-sequence attention through ``block_attention``, with q/k/v
    (B, L, heads, hd) as they are (K/V by group, no repeat).

    Self-attention (``kv_override=None``) runs RoPE on q and k; ``causal``
    masks j > i and, with ``cfg.sliding_window > 0``, i - j >= window;
    ``causal=False`` (an encoder) masks nothing. Cross-attention takes its
    keys and values from ``kv_override`` (B, Lk, d), an encoder's output:
    no RoPE, no QKV bias and no mask, as the reference's. On a model
    ``axis`` the kernel runs on this rank's heads (:func:`_heads`)."""
    b, l, _ = x.shape
    hd = cfg.head_dim_
    hs = _heads(p, cfg, axis)
    if kv_override is None:
        q, k, v = _qkv(hs, x, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        window = cfg.sliding_window if causal else 0
    else:
        lk = kv_override.shape[1]
        q = (x @ hs.p["wq"]).reshape(b, l, hs.h, hd)
        k = (kv_override @ hs.p["wk"]).reshape(b, lk, hs.kv, hd)
        v = (kv_override @ hs.p["wv"]).reshape(b, lk, hs.kv, hd)
        causal, window = False, 0
    k, v = _take(hs, k, v)
    out = attn_ops.block_attention(q, k, v, causal=causal, window=window)
    return _out(hs, out, axis)


def init_cache_attn(cfg: ArchConfig, batch: int, max_len: int, dtype, device) -> dict:
    """Ring buffer of min(max_len, window) slots (max_len without a window);
    the whole K/V heads (``transformer.init_cache`` cuts a rank's block)."""
    size = min(max_len, cfg.sliding_window) if cfg.sliding_window > 0 else max_len
    kv, hd = cfg.n_kv_heads, cfg.head_dim_
    return {
        "k": torch.zeros(batch, size, kv, hd, dtype=dtype, device=device),
        "v": torch.zeros(batch, size, kv, hd, dtype=dtype, device=device),
    }


def _slot_positions(pos, batch: int, device) -> torch.Tensor:
    """Scalar or (B,) positions -> (B,) int32 per-row positions."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    if pos.dim() == 0:
        pos = pos.expand(batch)
    return pos


def _ring_mask(pos: torch.Tensor, size: int) -> torch.Tensor:
    """(B,1,1,S) additive mask of the written ring slots for per-row ``pos``:
    all slots once wrapped, slot index <= pos while filling."""
    idx = torch.arange(size, device=pos.device)
    written = torch.where(pos >= size, torch.full_like(pos, size), pos + 1)
    valid = idx[None, :] < written[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=pos.device)
    return torch.where(valid, zero, zero - 1e30)[:, None, None, :]


def attn_decode(p: dict, x: torch.Tensor, cache: dict, pos, cfg: ArchConfig,
                active: torch.Tensor | None = None, axis=None) -> tuple[torch.Tensor, dict]:
    """One-token decode. x (B,1,d); ``pos`` a scalar (every row in lockstep)
    or (B,) per-row absolute positions. The new k/v go to ring slot
    pos % size; ``active`` (B,) bool drops the write of inactive rows (the
    reference sends it to slot ``size`` with ``mode="drop"``; torch would
    raise on that index, so those rows write back what their slot held).
    On a model ``axis`` the cache holds this rank's K/V heads (or all of
    them, see :func:`_heads`). Returns new cache tensors; the given cache is
    not modified."""
    b = x.shape[0]
    hd = cfg.head_dim_
    size = cache["k"].shape[1]
    pos = _slot_positions(pos, b, x.device)
    hs = _heads(p, cfg, axis)
    q, k, v = _qkv(hs, x, cfg)
    cos, sin = rope_freqs(pos[:, None], hd, cfg.rope_theta)     # (B, 1, hd/2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    rows = torch.arange(b, device=x.device)
    slot = torch.remainder(pos, size).long()
    k_new, v_new = k[:, 0], v[:, 0]
    if active is not None:
        keep = active[:, None, None]
        k_new = torch.where(keep, k_new, cache["k"][rows, slot])
        v_new = torch.where(keep, v_new, cache["v"][rows, slot])
    ck = cache["k"].index_put((rows, slot), k_new)
    cv = cache["v"].index_put((rows, slot), v_new)
    kk, vv = _take(hs, ck, cv)
    out = _sdpa(q, kk, vv, _ring_mask(pos, size), hs.n_rep, cfg.attn_logits_bf16)
    return _out(hs, out, axis), {"k": ck, "v": cv}


def _prefill_write_slots(tok_pos: torch.Tensor, n_valid: torch.Tensor, size: int) -> torch.Tensor:
    """(B,C) ring slots for a chunk write, the reference's: a real token
    (j < n_valid) goes to tok_pos % size, a padding token to ``size``,
    past the end."""
    c = tok_pos.shape[1]
    valid = torch.arange(c, device=tok_pos.device)[None, :] < n_valid[:, None]
    return torch.where(valid, torch.remainder(tok_pos, size), torch.full_like(tok_pos, size))


def _prefill_mask(pos: torch.Tensor, n_valid: torch.Tensor, c: int, size: int,
                  window: int) -> torch.Tensor:
    """(B,1,C,S+C) additive float32 mask over [pre-chunk cache snapshot |
    chunk keys], the reference's bit for bit (0 or ``_NEG``).

    Chunk token j of row r sits at absolute position pos[r] + j. Snapshot
    slot s holds absolute position a_s = P - ((P - s) mod S), P = pos - 1
    (a_s < 0: never written); it is visible when written and, with a
    window, when tok_pos - a_s < window. Chunk keys are causal over the
    real tokens, and every query keeps its own key, so a padding query's
    softmax stays finite."""
    dev = pos.device
    b = pos.shape[0]
    j = torch.arange(c, device=dev)
    tok_pos = pos[:, None] + j[None, :]                              # (B,C)
    valid_tok = j[None, :] < n_valid[:, None]                        # (B,C)
    idx = torch.arange(size, device=dev)
    last = pos[:, None] - 1
    a_s = last - torch.remainder(last - idx[None, :], size)          # (B,S)
    cache_ok = (a_s >= 0)[:, None, :].expand(b, c, size)             # (B,C,S)
    if window > 0:
        cache_ok = cache_ok & ((tok_pos[:, :, None] - a_s[:, None, :]) < window)
    self_k = j[None, None, :] == j[None, :, None]                    # (1,C,C)
    chunk_ok = (j[None, None, :] <= j[None, :, None]) & (valid_tok[:, None, :] | self_k)
    if window > 0:
        chunk_ok = chunk_ok & ((j[None, :, None] - j[None, None, :]) < window)
    ok = torch.cat([cache_ok, chunk_ok.expand(b, c, c)], dim=-1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return torch.where(ok, zero, zero + _NEG)[:, None]


def _check_chunk(c: int, size: int) -> None:
    if c > size:
        raise ValueError(f"prefill chunk {c} exceeds ring buffer {size}")


def _prefill_write(cache: torch.Tensor, new: torch.Tensor, tok_pos: torch.Tensor,
                   n_valid: torch.Tensor) -> torch.Tensor:
    """Write a chunk's (B,C,...) rows into the (B,S,...) ring ``cache`` out
    of place, as the reference's scatter with ``mode="drop"``. A padding
    token is not written: it writes back what its slot held. Its slot
    cannot collide with a real token's, since the C slots tok_pos % S of a
    row are distinct for C <= S, so no index repeats and the write order
    is fixed."""
    b, c = tok_pos.shape
    size = cache.shape[1]
    rows = torch.arange(b, device=cache.device)[:, None].expand(b, c)
    written = _prefill_write_slots(tok_pos, n_valid, size) < size
    slot = torch.remainder(tok_pos, size).long()
    keep = written.reshape(b, c, *([1] * (new.dim() - 2)))
    return cache.index_put((rows, slot), torch.where(keep, new, cache[rows, slot]))


def attn_prefill(p: dict, x: torch.Tensor, cache: dict, pos: torch.Tensor,
                 n_valid: torch.Tensor, cfg: ArchConfig, axis=None) -> tuple[torch.Tensor, dict]:
    """Chunked batched prefill into the decode ring cache, the reference's.
    x (B,C,d), a chunk of C tokens a row; ``pos`` (B,) the absolute
    position of each row's first chunk token; ``n_valid`` (B,) the real
    tokens of each row (0: the row's cache is untouched). Queries attend
    the pre-chunk snapshot (the given cache, which is not modified) and the
    chunk's own keys, through :func:`_prefill_mask`; the attention is the
    plain materialized ``_sdpa``, as the reference's (``block_attention``
    takes no mask over a wrapped ring). Needs C <= the ring size. On a model
    ``axis``, this rank's heads (:func:`attn_decode`)."""
    c = x.shape[1]
    hd = cfg.head_dim_
    size = cache["k"].shape[1]
    _check_chunk(c, size)
    hs = _heads(p, cfg, axis)
    q, k, v = _qkv(hs, x, cfg)
    tok_pos = pos[:, None] + torch.arange(c, device=x.device)[None, :]
    cos, sin = rope_freqs(tok_pos, hd, cfg.rope_theta)              # (B,C,hd/2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    ck = _prefill_write(cache["k"], k, tok_pos, n_valid)
    cv = _prefill_write(cache["v"], v, tok_pos, n_valid)
    mask = _prefill_mask(pos, n_valid, c, size, cfg.sliding_window)
    kk, vv = _take(hs, torch.cat([cache["k"], k], dim=1),           # snapshot + chunk
                   torch.cat([cache["v"], v], dim=1))
    out = _sdpa(q, kk, vv, mask, hs.n_rep, cfg.attn_logits_bf16)
    return _out(hs, out, axis), {"k": ck, "v": cv}


# ------------------------------------------------------------ MLA attention
def init_mla(gen: torch.Generator, cfg: ArchConfig, device, dtype=torch.float32) -> dict:
    """The reference's leaves, shapes, scales and dtypes; the draws are
    ``gen``'s."""
    d, h, m = cfg.d_model, cfg.n_heads, cfg.mla
    return {
        "wq": _dense(gen, (d, h * (m.qk_nope_dim + m.qk_rope_dim)), device, dtype),
        "w_dkv": _dense(gen, (d, m.kv_lora_rank + m.qk_rope_dim), device, dtype),
        "w_uk": _dense(gen, (m.kv_lora_rank, h * m.qk_nope_dim), device, dtype),
        "w_uv": _dense(gen, (m.kv_lora_rank, h * m.v_head_dim), device, dtype),
        "wo": _dense(gen, (h * m.v_head_dim, d), device, dtype),
        "kv_norm": torch.ones(m.kv_lora_rank, dtype=dtype, device=device),
    }


def _mla_whole(p: dict, cfg: ArchConfig, axis) -> dict:
    """MLA's leaves whole on a model ``axis``: its two fused splits (q's
    nope|rope, w_dkv's latent|rope) are computed replicated, as the
    reference's ``_split_guard`` keeps them, so the layer runs whole on every
    rank."""
    if axis is None or axis.size == 1:
        return p
    d, h, m = cfg.d_model, cfg.n_heads, cfg.mla
    shapes = {"wq": (d, h * (m.qk_nope_dim + m.qk_rope_dim)),
              "w_dkv": (d, m.kv_lora_rank + m.qk_rope_dim),
              "w_uk": (m.kv_lora_rank, h * m.qk_nope_dim),
              "w_uv": (m.kv_lora_rank, h * m.v_head_dim),
              "wo": (h * m.v_head_dim, d)}
    return {**p, **{name: axis.whole(p[name], name, shape) for name, shape in shapes.items()}}


def _mla_qkv(p, x, cfg, cos, sin):
    """x (b, l, d) -> q_nope (b, l, h, nope), q_rope (b, l, h, rope) after
    RoPE, c_kv (b, l, rank) after its RMS norm, and k_rope (b, l, rope):
    one RoPE key shared by every head."""
    b, l, _ = x.shape
    h, m = cfg.n_heads, cfg.mla
    q = (x @ p["wq"]).reshape(b, l, h, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    q_rope = apply_rope(q_rope, cos, sin)
    c_kv, k_rope = torch.split(x @ p["w_dkv"], [m.kv_lora_rank, m.qk_rope_dim], dim=-1)
    c_kv = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _mla_attend(p, q_nope, q_rope, c_kv, k_rope, mask, cfg):
    """Latent-space attention, the reference's absorbed form: w_uk goes
    into the query (q_lat = q_nope . w_uk), the scores are q_lat . c_kv +
    q_rope . k_rope over the compressed cache, scaled by 1/sqrt(nope +
    rope), and the context stays in latent space until w_uv and wo. The
    softmax is float32 over the materialized (B, H, Lq, Lk) scores, with
    the additive ``mask`` (B|1, 1, Lq|1, Lk); the scaling and the mask are
    applied in place (the same float32 operations, one score-sized
    temporary fewer)."""
    b, lq, h, _ = q_nope.shape
    m = cfg.mla
    w_uk = p["w_uk"].reshape(m.kv_lora_rank, h, m.qk_nope_dim)
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, w_uk)
    scores = torch.einsum("bqhr,bkr->bhqk", q_lat, c_kv)
    scores.add_(torch.einsum("bqhn,bkn->bhqk", q_rope, k_rope))
    logits = scores.float().mul_(1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)).add_(mask)
    w = torch.softmax(logits, dim=-1).to(c_kv.dtype)
    del scores, logits
    ctx = torch.einsum("bhqk,bkr->bqhr", w, c_kv)
    w_uv = p["w_uv"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    out = torch.einsum("bqhr,rhv->bqhv", ctx, w_uv)
    return out.reshape(b, lq, h * m.v_head_dim) @ p["wo"]


def _causal_mask(l: int, window: int, device) -> torch.Tensor:
    """(1, 1, L, L) additive float32 mask: 0 where j <= i (and i - j <
    window when window > 0), -1e30 elsewhere, as the reference's."""
    i = torch.arange(l, device=device)[:, None]
    j = torch.arange(l, device=device)[None, :]
    ok = j <= i
    if window > 0:
        ok &= (i - j) < window
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, zero - 1e30)[None, None]


def mla_train(p: dict, x: torch.Tensor, cfg: ArchConfig, cos, sin, axis=None) -> torch.Tensor:
    """Full-sequence causal MLA (sliding window when the config has one);
    ``cos``/``sin`` at ``cfg.mla.qk_rope_dim``; whole on a model ``axis``
    (:func:`_mla_whole`)."""
    p = _mla_whole(p, cfg, axis)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, cos, sin)
    mask = _causal_mask(x.shape[1], cfg.sliding_window, x.device)
    return _mla_attend(p, q_nope, q_rope, c_kv, k_rope, mask, cfg)


def init_cache_mla(cfg: ArchConfig, batch: int, max_len: int, dtype, device) -> dict:
    """Ring buffer of the compressed cache: c_kv (B, S, rank) and the
    shared RoPE key k_rope (B, S, rope), S = min(max_len, window)."""
    size = min(max_len, cfg.sliding_window) if cfg.sliding_window > 0 else max_len
    m = cfg.mla
    return {
        "c_kv": torch.zeros(batch, size, m.kv_lora_rank, dtype=dtype, device=device),
        "k_rope": torch.zeros(batch, size, m.qk_rope_dim, dtype=dtype, device=device),
    }


def mla_decode(p: dict, x: torch.Tensor, cache: dict, pos, cfg: ArchConfig,
               active: torch.Tensor | None = None, axis=None) -> tuple[torch.Tensor, dict]:
    """One-token MLA decode; ``pos`` and ``active`` as in :func:`attn_decode`
    (inactive rows write back what their slot held); whole on a model
    ``axis``. Returns new cache tensors; the given cache is not modified."""
    p = _mla_whole(p, cfg, axis)
    b = x.shape[0]
    size = cache["c_kv"].shape[1]
    pos = _slot_positions(pos, b, x.device)
    cos, sin = rope_freqs(pos[:, None], cfg.mla.qk_rope_dim, cfg.rope_theta)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, cos, sin)
    rows = torch.arange(b, device=x.device)
    slot = torch.remainder(pos, size).long()
    c_new, r_new = c_kv[:, 0], k_rope[:, 0]
    if active is not None:
        keep = active[:, None]
        c_new = torch.where(keep, c_new, cache["c_kv"][rows, slot])
        r_new = torch.where(keep, r_new, cache["k_rope"][rows, slot])
    cc = cache["c_kv"].index_put((rows, slot), c_new)
    cr = cache["k_rope"].index_put((rows, slot), r_new)
    y = _mla_attend(p, q_nope, q_rope, cc, cr, _ring_mask(pos, size), cfg)
    return y, {"c_kv": cc, "k_rope": cr}


def mla_prefill(p: dict, x: torch.Tensor, cache: dict, pos: torch.Tensor,
                n_valid: torch.Tensor, cfg: ArchConfig, axis=None) -> tuple[torch.Tensor, dict]:
    """Chunked MLA prefill into the compressed ring cache, with
    :func:`attn_prefill`'s chunk, snapshot and padding semantics; whole on a
    model ``axis``."""
    p = _mla_whole(p, cfg, axis)
    b, c, _ = x.shape
    size = cache["c_kv"].shape[1]
    _check_chunk(c, size)
    tok_pos = pos[:, None] + torch.arange(c, device=x.device)[None, :]
    cos, sin = rope_freqs(tok_pos, cfg.mla.qk_rope_dim, cfg.rope_theta)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, cos, sin)
    cc = _prefill_write(cache["c_kv"], c_kv, tok_pos, n_valid)
    cr = _prefill_write(cache["k_rope"], k_rope, tok_pos, n_valid)
    mask = _prefill_mask(pos, n_valid, c, size, cfg.sliding_window)
    ckv_all = torch.cat([cache["c_kv"], c_kv], dim=1)
    kr_all = torch.cat([cache["k_rope"], k_rope], dim=1)
    y = _mla_attend(p, q_nope, q_rope, ckv_all, kr_all, mask, cfg)
    return y, {"c_kv": cc, "k_rope": cr}


# -------------------------------------------------------------- SwiGLU FFN
def init_ffn(gen: torch.Generator, d: int, ff: int, device, dtype=torch.float32) -> dict:
    return {
        "w_gate": _dense(gen, (d, ff), device, dtype),
        "w_up": _dense(gen, (d, ff), device, dtype),
        "w_down": _dense(gen, (ff, d), device, dtype),
    }


def ffn_apply(p: dict, x: torch.Tensor, axis=None, ff: int = 0) -> torch.Tensor:
    """SwiGLU. On a model ``axis`` (``dist.parallel.MeshAxis``) ``p`` holds
    this rank's block and ``ff`` is the FFN's whole width: where the specs
    split it on ``ff``, column-parallel ``w_gate``/``w_up`` and a
    row-parallel ``w_down`` (:func:`_partial`) summed over the axis; else
    the whole leaves, gathered."""
    if axis is None or axis.size == 1:
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    d = x.shape[-1]
    shapes = {"w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)}
    if axis.splits("w_gate", shapes["w_gate"], 1) and axis.splits("w_down", shapes["w_down"], 0):
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
        return axis.sum(_partial(h, p["w_down"])).to(x.dtype)
    w = {name: axis.whole(p[name], name, shape) for name, shape in shapes.items()}
    return (F.silu(x @ w["w_gate"]) * (x @ w["w_up"])) @ w["w_down"]


# --------------------------------------------------------------------- MoE
def init_moe(gen: torch.Generator, cfg: ArchConfig, device, dtype=torch.float32) -> dict:
    """The reference's leaves in its order (router, w_gate, w_up, w_down,
    then the shared experts' FFN), shapes, scales and dtypes (the router
    float32 in either mode); the draws are ``gen``'s, not JAX's. The expert
    weights are scaled by 1/sqrt of their leading (expert) dimension, as
    the reference's ``_dense`` does."""
    mo = cfg.moe
    d = cfg.d_model
    de = mo.d_expert or cfg.d_ff
    p = {
        "router": _dense(gen, (d, mo.n_experts), device),
        "w_gate": _dense(gen, (mo.n_experts, d, de), device, dtype),
        "w_up": _dense(gen, (mo.n_experts, d, de), device, dtype),
        "w_down": _dense(gen, (mo.n_experts, de, d), device, dtype),
    }
    if mo.n_shared > 0:
        p["shared"] = init_ffn(gen, d, mo.n_shared * de, device, dtype)
    return p


def moe_route(p: dict, x: torch.Tensor, cfg: ArchConfig, axis=None, data_axis=None):
    """The router of ``moe_apply`` over dispatch groups x (b, l, d), as the
    reference computes it: float32 logits, softmax, the top-k (ties to the
    lower expert index, as ``jax.lax.top_k``: a stable descending sort, since
    ``torch.topk`` orders ties arbitrarily on the card), renormalised with
    a 1e-9 clip, and the Switch aux loss
    ``e * sum(mean(probs) * mean(onehot(top1))) * router_aux_weight``.

    Each choice's slot in its expert is the number of earlier choices of
    that expert in its group, counted token-major with the choice rank
    inside (the reference's cumsum over ``(b, l * k, e)``); a slot at or past
    ``cap = max(8, int(l * top_k * capacity_factor / e))`` is dropped and
    keeps a zero gate.

    On a model ``axis`` the routing stays global: a router split on the
    experts has its logits gathered before the top-k (one split on d is
    gathered whole), so every rank routes every token as one device would.

    Returns (gate_vals (b, l, k) with dropped choices zeroed, gate_idx
    (b, l, k), slot (b, l, k), keep (b, l, k) bool, cap, aux)."""
    mo = cfg.moe
    b, l, d = x.shape
    e, k = mo.n_experts, mo.top_k
    cap = max(8, int(l * k * mo.capacity_factor / e))
    if axis is not None and axis.size > 1 and axis.splits("router", (d, e), 1):
        logits = axis.all_gather(x.float() @ p["router"], -1)
    else:
        router = p["router"] if axis is None else axis.whole(p["router"], "router", (d, e))
        logits = x.float() @ router
    probs = torch.softmax(logits, dim=-1)                            # (b, l, e)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = gate_vals[..., :k], gate_idx[..., :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(gate_idx[..., 0], e).float().mean(dim=(0, 1))
    if data_axis is not None and data_axis.size > 1:
        me, ce = data_axis.mean(torch.cat([me, ce])).split(e)
    aux = e * torch.sum(me * ce) * mo.router_aux_weight

    sel = F.one_hot(gate_idx, e)                                     # (b, l, k, e)
    flat = sel.reshape(b, l * k, e)
    slot = ((flat.cumsum(1) - flat).reshape(b, l, k, e) * sel).sum(-1)
    keep = slot < cap
    return gate_vals * keep, gate_idx, slot, keep, cap, aux


def _expert_plan(p: dict, cfg: ArchConfig, d: int, axis):
    """(expert weights as this rank uses them, its experts [lo, hi), mode):
    "experts" (expert-parallel) where the specs split the expert stacks on
    the experts, "columns" (tensor-parallel inside each expert) where they
    split d_expert, else None: the whole stacks, gathered."""
    e = cfg.moe.n_experts
    w = {name: p[name] for name in ("w_gate", "w_up", "w_down")}
    if axis is None or axis.size == 1:
        return w, (0, e), None
    de = cfg.moe.d_expert or cfg.d_ff
    shapes = {"w_gate": (e, d, de), "w_up": (e, d, de), "w_down": (e, de, d)}
    if axis.splits("w_gate", shapes["w_gate"], 0) and axis.splits("w_down", shapes["w_down"], 0):
        return w, axis.span(e), "experts"
    if axis.splits("w_gate", shapes["w_gate"], 2) and axis.splits("w_down", shapes["w_down"], 1):
        return w, (0, e), "columns"
    return ({name: axis.whole(w[name], name, shape) for name, shape in shapes.items()},
            (0, e), None)


def moe_apply(p: dict, x: torch.Tensor, cfg: ArchConfig, axis=None,
              data_axis=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k dispatch with capacity, the reference's ``moe_apply``. x (B, L, d)
    -> (out, aux loss). The routing is :func:`moe_route`'s.

    Dispatch is by index where the reference multiplies one-hot tensors:
    each kept choice copies its token into slot ``slot`` of its expert's
    buffer, (b, e, min(cap, l), d), and the output gathers it back, scaled
    by the gate. The copies are exact, as the one-hot products are (one
    non-zero term each), and the slots from ``l`` on, which no choice can
    reach (a token picks an expert once), are not computed. The expert
    SwiGLU is batched products over the experts (the reference computes it
    outside any kernel too). Shared experts go through ``ffn_apply``.

    The dispatch groups are the batch rows, or rows of ``group_size`` tokens
    when that divides L and is shorter.

    On a model ``axis`` the routing and the capacity are global (every rank
    routes every token); a rank runs its own experts (expert-parallel, when
    the axis divides the expert count) or its columns of every expert, and
    the outputs are summed over the axis (:func:`_expert_plan`; the
    columns' ``w_down`` products in float32, :func:`_partial`). On a
    ``data_axis`` the aux loss is the global batch's (:func:`moe_route`)."""
    b0, l0, d0 = x.shape
    gs = cfg.moe.group_size
    if gs and l0 > gs and l0 % gs == 0:
        x = x.reshape(b0 * (l0 // gs), gs, d0)
    b, l, d = x.shape
    e = cfg.moe.n_experts
    route = (p, x, cfg) if axis is None or axis.size == 1 else (p, x, cfg, axis)
    data = {} if data_axis is None or data_axis.size == 1 else {"data_axis": data_axis}
    gate_vals, gate_idx, slot, keep, cap, aux = moe_route(*route, **data)
    w, (lo, hi), mode = _expert_plan(p, cfg, d, axis)
    width = min(cap, l)
    # Row of each kept choice in the flattened (b, e, width) buffer; dropped
    # choices write to one spare row past the end, which nothing reads.
    spare = b * e * width
    rows = (torch.arange(b, device=x.device)[:, None, None] * e + gate_idx) * width + slot
    rows = torch.where(keep, rows, spare)
    k = rows.shape[-1]
    xe = x.new_zeros(spare + 1, d)
    xe.index_copy_(0, rows.reshape(-1), x.unsqueeze(2).expand(b, l, k, d).reshape(-1, d))
    xe = xe[:spare].view(b, e, width, d)
    if (lo, hi) != (0, e):
        xe = xe[:, lo:hi]
    h = F.silu(torch.einsum("becd,edf->becf", xe, w["w_gate"]))
    h = h * torch.einsum("becd,edf->becf", xe, w["w_up"])
    if mode == "columns":
        ye = torch.einsum("becf,efd->becd", h.float(), w["w_down"].float())
    else:
        ye = torch.einsum("becf,efd->becd", h, w["w_down"])
    if (lo, hi) != (0, e):            # other ranks' experts: zero rows here
        full = ye.new_zeros(b, e, width, d)
        full[:, lo:hi] = ye
        ye = full
    ye = ye.reshape(spare, d)
    picked = ye[torch.where(keep, rows, 0)]                          # (b, l, k, d)
    out = (picked * gate_vals.to(ye.dtype)[..., None]).sum(2)
    if mode is not None:
        out = axis.sum(out).to(x.dtype)
    if "shared" in p:
        de = cfg.moe.d_expert or cfg.d_ff
        out = out + ffn_apply(p["shared"], x, axis=axis, ff=cfg.moe.n_shared * de)
    return out.reshape(b0, l0, d0), aux


# ------------------------------------------------------------------ Mamba2
def init_mamba(gen: torch.Generator, cfg: ArchConfig, device, dtype=torch.float32) -> dict:
    """The reference's shapes, scales and dtypes (``A_log``, ``D`` and
    ``dt_bias`` float32 in either mode); the draws are ``gen``'s, not JAX's."""
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    n_h = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.state_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": _dense(gen, (d, 2 * d_in + 2 * s.n_groups * s.state_dim + n_h), device,
                          dtype),
        "conv_w": _dense(gen, (s.d_conv, conv_dim), device, dtype, scale=0.5),
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_h)).to(device),
        "D": torch.ones(n_h, **f32),
        "dt_bias": torch.zeros(n_h, **f32),
        "norm": torch.ones(d_in, dtype=dtype, device=device),
        "out_proj": _dense(gen, (d_in, d), device, dtype),
    }


def _mamba_split(p, x, cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_h = d_in // s.head_dim
    gn = s.n_groups * s.state_dim
    z, xc, bc, cc, dt = torch.split(x @ p["in_proj"], [d_in, d_in, gn, gn, n_h], dim=-1)
    return z, xc, bc, cc, dt, n_h, d_in


def mamba_train(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    s = cfg.ssm
    b, l, _ = x.shape
    z, xc, bc, cc, dt, n_h, d_in = _mamba_split(p, x, cfg)
    # Causal depthwise conv over (x, B, C): a sum of shifted products.
    xbc = torch.cat([xc, bc, cc], dim=-1)
    pad = F.pad(xbc, (0, 0, s.d_conv - 1, 0))
    conv = sum(pad[:, i:i + l, :] * p["conv_w"][i] for i in range(s.d_conv)) + p["conv_b"]
    conv = F.silu(conv)
    gn = s.n_groups * s.state_dim
    xc, bc, cc = torch.split(conv, [d_in, gn, gn], dim=-1)
    xh = xc.reshape(b, l, n_h, s.head_dim)
    bb = bc.reshape(b, l, s.n_groups, s.state_dim)
    cv = cc.reshape(b, l, s.n_groups, s.state_dim)
    dt_ = _softplus(dt.float() + p["dt_bias"])
    chunk = min(s.chunk, l)
    # Transposed views: the kernel reads them by strides, no copy.
    y = ssd_ops.ssd_chunked(xh.transpose(1, 2), dt_.transpose(1, 2), p["A_log"],
                            bb.transpose(1, 2), cv.transpose(1, 2),
                            chunk=chunk).transpose(1, 2)
    y = y + xh * p["D"].to(xh.dtype)[:, None]
    y = y.reshape(b, l, d_in)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"]


def init_cache_mamba(cfg: ArchConfig, batch: int, dtype, device) -> dict:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_h = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.state_dim
    return {
        "conv": torch.zeros(batch, s.d_conv - 1, conv_dim, dtype=dtype, device=device),
        "ssm": torch.zeros(batch, n_h, s.head_dim, s.state_dim, dtype=dtype, device=device),
    }


def mamba_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ArchConfig,
                 active: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """O(1) recurrent step. x (B,1,d). ``active`` (B,) bool gates the
    conv/ssm state advance per row (inactive rows keep their cache)."""
    s = cfg.ssm
    b = x.shape[0]
    z, xc, bc, cc, dt, n_h, d_in = _mamba_split(p, x, cfg)
    xbc = torch.cat([xc, bc, cc], dim=-1)                       # (b,1,conv_dim)
    window = torch.cat([cache["conv"], xbc], dim=1)             # (b,d_conv,conv_dim)
    conv = torch.einsum("btc,tc->bc", window, p["conv_w"]) + p["conv_b"]
    conv = F.silu(conv)[:, None, :]
    new_conv_cache = window[:, 1:, :]
    gn = s.n_groups * s.state_dim
    xc, bc, cc = torch.split(conv, [d_in, gn, gn], dim=-1)
    xh = xc.reshape(b, n_h, s.head_dim)
    rep = n_h // s.n_groups
    bbh = bc.reshape(b, s.n_groups, s.state_dim).repeat_interleave(rep, dim=1)  # (b,h,n)
    cvh = cc.reshape(b, s.n_groups, s.state_dim).repeat_interleave(rep, dim=1)
    dt_ = _softplus(dt.float() + p["dt_bias"])[:, 0]             # (b,h)
    a = -torch.exp(p["A_log"].float())
    alpha = torch.exp(dt_ * a)                                  # (b,h)
    st = cache["ssm"]
    st = st * alpha[..., None, None].to(st.dtype) + torch.einsum(
        "bhp,bhn->bhpn", xh * dt_.to(xh.dtype)[..., None], bbh)
    y = torch.einsum("bhpn,bhn->bhp", st, cvh) + xh * p["D"].to(xh.dtype)[:, None]
    y = y.reshape(b, 1, d_in)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    if active is not None:
        new_conv_cache = torch.where(active[:, None, None], new_conv_cache, cache["conv"])
        st = torch.where(active[:, None, None, None], st, cache["ssm"])
    return y @ p["out_proj"], {"conv": new_conv_cache, "ssm": st}


def mamba_prefill(p: dict, x: torch.Tensor, cache: dict, n_valid: torch.Tensor,
                  cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """Chunked prefill for the recurrent mixer, the reference's: the O(1)
    step :func:`mamba_decode` over the chunk's tokens in order, each row's
    state advancing only for its first n_valid tokens (``active=t <
    n_valid``), so it is bit for bit the decode step run token at a time.
    x (B,C,d) -> (y (B,C,d), new cache). Each token goes in as its own
    contiguous (B,1,d) tensor, as decode gives it: a strided view of the
    chunk takes another BLAS path, a few ulps apart."""
    ys = []
    for t in range(x.shape[1]):
        xt = x[:, t:t + 1].contiguous()
        y, cache = mamba_decode(p, xt, cache, cfg, active=t < n_valid)
        ys.append(y[:, 0])
    return torch.stack(ys, dim=1), cache
