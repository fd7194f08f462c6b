"""Decoder LM over ``ArchConfig``, the port of ``repro.models.transformer``,
for the Mamba2 family (``block_pattern=("mamba",)``, ``ffn_pattern=("none",)``),
the dense GQA family (``"attn"`` slots with RoPE, optional QKV bias and
sliding window, and a dense SwiGLU FFN: ``yi-6b``, ``qwen2.5-32b``,
``qwen2-72b``, ``granite-34b``), MoE FFN slots (``grok-1-314b``, and
``jamba-1.5-large-398b``, whose blocks mix Mamba2 and attention slots) and
the vision stub (``internvl2-1b``: the caller's patch embeddings go before
the tokens, ``frontend_embeds``).

Parameters are the reference's nested dict, blocks stacked along a leading
``n_blocks`` dimension, so a JAX ``init_params`` pytree carries across with
``repro_torch.convert.lm_params_from_numpy``. The stacked blocks are walked
by a Python loop (PyTorch runs eagerly: the reference's ``remat`` and
``unroll`` steer XLA and have no counterpart here). Embeddings are tied when
``cfg.tie_embeddings`` (head = embed.T). MLA, the encoder-decoder and the
audio frontend raise ``NotImplementedError`` (``ROADMAP.md`` A10).

Public API: init_params / forward_train / loss_fn / init_cache /
decode_step. Float32 throughout, with TF32 off (``repro_torch.device``).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig

__all__ = ["init_params", "forward_train", "loss_fn", "init_cache", "decode_step"]


def _check_supported(cfg: ArchConfig) -> None:
    for i, kind in enumerate(cfg.block_pattern):
        if kind == "attn" and cfg.attn_type != "gqa":
            raise NotImplementedError(
                f"{cfg.name}: {cfg.attn_type} attention is not ported (ROADMAP.md A10)")
        if kind not in ("attn", "mamba"):
            raise NotImplementedError(f"{cfg.name}: slot {i} is {kind!r}; only GQA "
                                      f"attention and Mamba2 slots are ported")
    if cfg.enc_dec or cfg.frontend not in ("none", "vision"):
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models and the audio frontend are "
            f"ROADMAP.md A10")


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _init_slot(gen: torch.Generator, cfg: ArchConfig, slot: int, dev) -> dict:
    ones = lambda: torch.ones(cfg.d_model, dtype=torch.float32, device=dev)  # noqa: E731
    p = {"norm1": ones()}
    if cfg.block_pattern[slot] == "attn":
        p["mixer"] = L.init_attn(gen, cfg, dev)
    else:
        p["mixer"] = L.init_mamba(gen, cfg, dev)
    fk = cfg.ffn_kind(slot)
    if fk != "none":
        p["norm2"] = ones()
    if fk == "moe":
        p["ffn"] = L.init_moe(gen, cfg, dev)
    elif fk == "dense":
        p["ffn"] = L.init_ffn(gen, cfg.d_model, cfg.d_ff, dev)
    return p


def _into(stacked, tree, i: int) -> None:
    """Copy one block's parameters into row ``i`` of the stacked ones."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _into(stacked[k], v, i)
    else:
        stacked[i].copy_(tree)


def init_params(cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32,
                device: str | torch.device = "cuda") -> dict:
    """Random init with the reference's shapes and scales, drawn from
    ``gen`` on the generator's own device (its draws are not JAX's bits): a
    ``torch.Generator("cuda")`` fills a full-width model on the card, a CPU
    generator draws on the host. Blocks are drawn one after another, in the
    same order whatever the device, and written into tensors stacked along
    a leading n_blocks dim, so at most one block exists twice."""
    _check_supported(cfg)
    if dtype != torch.float32:
        raise NotImplementedError("the port's LM path is float32 only")
    dev = resolve_device(device)

    def block():
        return {f"slot{i}": _init_slot(gen, cfg, i, dev)
                for i in range(len(cfg.block_pattern))}

    first = block()
    stacked = _expand(first, cfg.n_blocks)
    _into(stacked, first, 0)
    del first
    for blk in range(1, cfg.n_blocks):
        _into(stacked, block(), blk)
    params = {
        "embed": (0.02 * torch.randn(cfg.vocab, cfg.d_model, generator=gen,
                                     device=gen.device)).to(dev),
        "final_norm": torch.ones(cfg.d_model, dtype=dtype, device=dev),
        "blocks": stacked,
    }
    if not cfg.tie_embeddings:
        params["head"] = (0.02 * torch.randn(cfg.d_model, cfg.vocab, generator=gen,
                                             device=gen.device)).to(dev)
    return params


def _expand(tree, n: int):
    """One block's tree -> an uninitialised tree stacked n deep."""
    if isinstance(tree, dict):
        return {k: _expand(v, n) for k, v in tree.items()}
    return tree.new_empty((n, *tree.shape))


def _head(cfg: ArchConfig, params: dict) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def _ffn(p: dict, x: torch.Tensor, cfg: ArchConfig, slot: int):
    """The slot's FFN on the residual x -> (x + ffn(norm2(x)), aux)."""
    fk = cfg.ffn_kind(slot)
    if fk == "none":
        return x, None
    h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    if fk == "moe":
        h, aux = L.moe_apply(p["ffn"], h, cfg)
        return x + h, aux
    return x + L.ffn_apply(p["ffn"], h), None


def _apply_slot(p: dict, x: torch.Tensor, cfg: ArchConfig, slot: int, cos, sin):
    """One slot of a block -> (x, aux loss of its MoE FFN, or None)."""
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if cfg.block_pattern[slot] == "attn":
        x = x + L.attn_train(p["mixer"], h, cfg, cos, sin)
    else:
        x = x + L.mamba_train(p["mixer"], h, cfg)
    return _ffn(p, x, cfg, slot)


def forward_train(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                  frontend_embeds: torch.Tensor | None = None):
    """tokens (B, S) int -> (logits (B, S, V), aux loss: the sum of the MoE
    slots' over every block, 0 without them). ``frontend_embeds`` (B, F, d),
    the vision stub's patch embeddings, go before the tokens; RoPE runs over
    all F + S positions, and the first F are cut after the final norm."""
    _check_supported(cfg)
    x = params["embed"][tokens]
    n_front = 0
    if frontend_embeds is not None:
        n_front = frontend_embeds.shape[1]
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    cos, sin = L.rope_freqs(positions, cfg.head_dim_, cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in range(cfg.n_blocks):
        bp = _index(params["blocks"], blk)
        for i in range(len(cfg.block_pattern)):
            x, a = _apply_slot(bp[f"slot{i}"], x, cfg, i, cos, sin)
            if a is not None:
                aux = aux + a
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if n_front:
        x = x[:, n_front:]
    return x @ _head(cfg, params), aux


def loss_fn(cfg: ArchConfig, params: dict, batch: dict) -> torch.Tensor:
    """batch: {"tokens": (B,S), "labels": (B,S), optional "embeds": (B,F,d)}
    -> mean next-token NLL + aux."""
    logits, aux = forward_train(cfg, params, batch["tokens"], batch.get("embeds"))
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, batch["labels"][..., None].long())[..., 0]
    return nll.mean() + aux


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.float32,
               device: str | torch.device = "cuda") -> dict:
    """Stacked (n_blocks-leading) cache: attention slots hold a ring buffer
    of min(max_len, window) k/v slots, Mamba2 slots their recurrent state
    (which ``max_len`` does not size)."""
    _check_supported(cfg)
    dev = resolve_device(device)

    def one(i):
        if cfg.block_pattern[i] == "attn":
            return L.init_cache_attn(cfg, batch, max_len, dtype, dev)
        return L.init_cache_mamba(cfg, batch, dtype, dev)

    return {
        "slots": {f"slot{i}": _stack([one(i) for _ in range(cfg.n_blocks)])
                  for i in range(len(cfg.block_pattern))},
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def decode_step(cfg: ArchConfig, params: dict, cache: dict, token: torch.Tensor,
                positions: torch.Tensor | None = None,
                active: torch.Tensor | None = None):
    """token (B, 1) int -> (logits (B, 1, V), new cache).

    Lockstep mode (``positions=None``): every row is at cache["pos"], which
    advances by one. Slot mode: ``positions`` (B,) gives each row its own
    absolute position and cache["pos"] is left untouched. ``active`` (B,)
    bool freezes the cache of inactive rows."""
    _check_supported(cfg)
    x = params["embed"][token]
    pos = cache["pos"] if positions is None else positions
    new_slots = {f"slot{i}": [] for i in range(len(cfg.block_pattern))}
    for blk in range(cfg.n_blocks):
        bp = _index(params["blocks"], blk)
        for i, kind in enumerate(cfg.block_pattern):
            p = bp[f"slot{i}"]
            hn = L.rms_norm(x, p["norm1"], cfg.norm_eps)
            c = _index(cache["slots"][f"slot{i}"], blk)
            if kind == "attn":
                out, nc = L.attn_decode(p["mixer"], hn, c, pos, cfg, active=active)
            else:
                out, nc = L.mamba_decode(p["mixer"], hn, c, cfg, active=active)
            x = x + out
            new_slots[f"slot{i}"].append(nc)
            x, _ = _ffn(p, x, cfg, i)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    new_cache = dict(cache)
    new_cache["slots"] = {k: _stack(v) for k, v in new_slots.items()}
    if positions is None:
        new_cache["pos"] = cache["pos"] + 1
    return x @ _head(cfg, params), new_cache
