"""Decoder LM over ``ArchConfig``, the port of ``repro.models.transformer``,
for the Mamba2 family (``block_pattern=("mamba",)``, ``ffn_pattern=("none",)``).

Parameters are the reference's nested dict, blocks stacked along a leading
``n_blocks`` dimension, so a JAX ``init_params`` pytree carries across with
``repro_torch.convert.lm_params_from_numpy``. The stacked blocks are walked
by a Python loop (PyTorch runs eagerly: the reference's ``remat`` and
``unroll`` steer XLA and have no counterpart here). Embeddings are tied when
``cfg.tie_embeddings`` (head = embed.T). Attention, MLA, MoE, dense FFN,
encoder-decoder and frontends raise ``NotImplementedError`` (``ROADMAP.md``
A10).

Public API: init_params / forward_train / loss_fn / init_cache /
decode_step. Float32 throughout: TF32 is switched off for matmuls and
cuDNN once, when this module is imported, as ``repro_torch.core.dfedrw``
does for the round engine.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig

# fp32 matrix products, as the JAX package computes them (no TF32).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["init_params", "forward_train", "loss_fn", "init_cache", "decode_step"]


def _check_supported(cfg: ArchConfig) -> None:
    kinds = set(cfg.block_pattern)
    ffns = {cfg.ffn_kind(i) for i in range(len(cfg.block_pattern))}
    if kinds != {"mamba"} or ffns != {"none"} or cfg.enc_dec or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: only the Mamba2 family (mamba blocks, no FFN, no "
            f"encoder or frontend) is ported; attention, MLA, MoE, dense FFN, "
            f"enc-dec and frontends are ROADMAP.md A10")


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def init_params(cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32,
                device: str | torch.device = "cuda") -> dict:
    """Random init with the reference's shapes and scales, drawn from the
    CPU generator ``gen`` (its draws are not JAX's bits). Blocks are stacked
    along a leading n_blocks dim."""
    _check_supported(cfg)
    if dtype != torch.float32:
        raise NotImplementedError("the port's LM path is float32 only")
    dev = resolve_device(device)
    ones = lambda: torch.ones(cfg.d_model, dtype=dtype, device=dev)  # noqa: E731
    blocks = [{f"slot{i}": {"norm1": ones(), "mixer": L.init_mamba(gen, cfg, dev)}
               for i in range(len(cfg.block_pattern))} for _ in range(cfg.n_blocks)]
    params = {
        "embed": (0.02 * torch.randn(cfg.vocab, cfg.d_model, generator=gen)).to(dev),
        "final_norm": ones(),
        "blocks": _stack(blocks),
    }
    if not cfg.tie_embeddings:
        params["head"] = (0.02 * torch.randn(cfg.d_model, cfg.vocab, generator=gen)).to(dev)
    return params


def _head(cfg: ArchConfig, params: dict) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def forward_train(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                  frontend_embeds: torch.Tensor | None = None):
    """tokens (B, S) int -> (logits (B, S, V), aux loss 0)."""
    _check_supported(cfg)
    if frontend_embeds is not None:
        raise NotImplementedError("frontends are ROADMAP.md A10")
    x = params["embed"][tokens]
    for blk in range(cfg.n_blocks):
        bp = _index(params["blocks"], blk)
        for i in range(len(cfg.block_pattern)):
            p = bp[f"slot{i}"]
            x = x + L.mamba_train(p["mixer"], L.rms_norm(x, p["norm1"], cfg.norm_eps), cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ _head(cfg, params), torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(cfg: ArchConfig, params: dict, batch: dict) -> torch.Tensor:
    """batch: {"tokens": (B,S), "labels": (B,S)} -> mean next-token NLL + aux."""
    logits, aux = forward_train(cfg, params, batch["tokens"], batch.get("embeds"))
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, batch["labels"][..., None].long())[..., 0]
    return nll.mean() + aux


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.float32,
               device: str | torch.device = "cuda") -> dict:
    """Stacked (n_blocks-leading) recurrent cache. A Mamba2 cache does not
    grow with the context, so ``max_len`` is read by nothing (it sizes the
    attention caches of the reference)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    one = lambda: L.init_cache_mamba(cfg, batch, dtype, dev)  # noqa: E731
    return {
        "slots": {f"slot{i}": _stack([one() for _ in range(cfg.n_blocks)])
                  for i in range(len(cfg.block_pattern))},
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def decode_step(cfg: ArchConfig, params: dict, cache: dict, token: torch.Tensor,
                active: torch.Tensor | None = None):
    """token (B, 1) int -> (logits (B, 1, V), new cache), every row at
    cache["pos"], which advances by one (the reference's lockstep mode).
    ``active`` (B,) bool freezes the cache of inactive rows."""
    _check_supported(cfg)
    x = params["embed"][token]
    new_slots = {f"slot{i}": [] for i in range(len(cfg.block_pattern))}
    for blk in range(cfg.n_blocks):
        bp = _index(params["blocks"], blk)
        for i in range(len(cfg.block_pattern)):
            p = bp[f"slot{i}"]
            out, nc = L.mamba_decode(p["mixer"], L.rms_norm(x, p["norm1"], cfg.norm_eps),
                                     _index(cache["slots"][f"slot{i}"], blk), cfg,
                                     active=active)
            x = x + out
            new_slots[f"slot{i}"].append(nc)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    new_cache = dict(cache)
    new_cache["slots"] = {k: _stack(v) for k, v in new_slots.items()}
    new_cache["pos"] = cache["pos"] + 1
    return x @ _head(cfg, params), new_cache
