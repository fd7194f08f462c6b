"""What a planted bf16-path fault reads against the sound bf16 drift.

``chip_smoke.py`` holds each bf16 forward against the float32 forward at the
same weights, and Qwen2.5-32B's bf16 decode against its bf16 forward, by
rms(d) / rms(want) of the logits. This script reads that figure on the CPU
for Yi-6B, Qwen2.5-32B and SeamlessM4T-large-v2 cut to a few layers and
narrow widths (their head ratios, QKV bias and encoder kept), once sound and
once with each fault planted on bf16 inputs only, by replacing one function
of the port for the call:

- ``norm in bf16``: RMSNorm's statistics in bf16, not float32;
- ``P rounded to bf16``: full-sequence attention rounds the softmax
  probabilities to bf16 before P V;
- ``QKV bias dropped`` (the QKV biases drawn nonzero here);
- ``frontend cast to fp8``: the frame embeddings through float8 e4m3;
- decode: the new K/V cache through float8 e4m3, and the QKV bias dropped.

    PYTHONPATH=src python tools/bf16_fault_study.py

Prints one line a model and check: each reading, and each over the sound one.
"""
import dataclasses
import math

import torch

from repro_torch.configs import get_arch
from repro_torch.kernels.block_attn import ops as attn_ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

BF = torch.bfloat16
BATCH, SEQ, FRAMES, DECODE = 2, 256, 128, 48


def _tree(fn, t):
    return {k: _tree(fn, v) for k, v in t.items()} if isinstance(t, dict) else fn(t)


def _rel(got, want):
    d = (got.double() - want.double()).square().mean().sqrt()
    return float(d / want.double().square().mean().sqrt())


def _models():
    yi = dataclasses.replace(get_arch("yi-6b"), n_layers=6, d_model=512, n_heads=8,
                             n_kv_heads=1, d_ff=1376, vocab=8000)
    qwen = dataclasses.replace(get_arch("qwen2.5-32b"), n_layers=6, d_model=640, n_heads=5,
                               n_kv_heads=1, d_ff=3456, vocab=8000)
    seamless = dataclasses.replace(get_arch("seamless-m4t-large-v2"), n_layers=4,
                                   n_enc_layers=4, d_model=256, n_heads=4, n_kv_heads=4,
                                   d_ff=2048, vocab=8000)
    return yi, qwen, seamless


def _make(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    p = T.init_params(cfg, g, BF, device="cpu")
    mixer = p["blocks"]["slot0"]["mixer"]
    for name in ("bq", "bk", "bv"):
        if name in mixer:
            mixer[name] = (torch.randn(mixer[name].shape, generator=g) * 0.5).to(BF)
    tokens = torch.randint(0, cfg.vocab, (BATCH, SEQ), generator=g)
    embeds = torch.randn(BATCH, FRAMES, cfg.d_model, generator=g) if cfg.enc_dec else None
    return p, tokens, embeds


def _forward(cfg, p, tokens, embeds):
    with torch.inference_mode():
        return T.forward_train(cfg, p, tokens, embeds)[0]


def _forward_drift(cfg, p, tokens, embeds):
    p32 = _tree(lambda t: t.float(), p)
    return _rel(_forward(cfg, p, tokens, embeds), _forward(cfg, p32, tokens, embeds))


def _decode_drift(cfg, p, tokens):
    tokens = tokens[:, :DECODE]
    with torch.inference_mode():
        cache = T.init_cache(cfg, tokens.shape[0], DECODE, BF, device="cpu")
        out = []
        for t in range(DECODE):
            lg, cache = T.decode_step(cfg, p, cache, tokens[:, t:t + 1])
            out.append(lg[:, 0])
    return _rel(torch.stack(out, 1), _forward(cfg, p, tokens, None))


_rms_norm, _qkv, _attention = L.rms_norm, L._qkv, attn_ops.block_attention
_attn_decode, _forward_train = L.attn_decode, T.forward_train


def _norm_in_bf16(x, scale, eps=1e-5):
    if x.dtype != BF:
        return _rms_norm(x, scale, eps)
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale


def _bias_dropped(p, x, cfg):
    if x.dtype != BF:
        return _qkv(p, x, cfg)
    return _qkv({k: v for k, v in p.items() if k not in ("bq", "bk", "bv")}, x, cfg)


def _p_in_bf16(q, k, v, causal=True, window=0):
    if q.dtype != BF:
        return _attention(q, k, v, causal=causal, window=window)
    hd, rep = q.shape[-1], q.shape[2] // k.shape[2]
    kk, vv = (t.float().repeat_interleave(rep, 2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) / math.sqrt(hd)
    if causal:
        s = s.masked_fill(~torch.ones(q.shape[1], k.shape[1], dtype=torch.bool).tril(), -1e30)
    prob = torch.softmax(s, -1).to(BF).float()
    return torch.einsum("bhqk,bkhd->bqhd", prob, vv).to(q.dtype)


def _frontend_fp8(cfg, params, tokens, frontend_embeds=None, remat=True):
    if frontend_embeds is not None and params["embed"].dtype == BF:
        frontend_embeds = frontend_embeds.to(torch.float8_e4m3fn).float()
    return _forward_train(cfg, params, tokens, frontend_embeds, remat)


def _cache_fp8(p, x, cache, pos, cfg, active=None):
    out, new = _attn_decode(p, x, cache, pos, cfg, active)
    return out, {k: v.to(torch.float8_e4m3fn).to(v.dtype) for k, v in new.items()}


def _decode_bias_dropped(p, *args, **kw):
    return _attn_decode({k: v for k, v in p.items() if k not in ("bq", "bk", "bv")},
                        *args, **kw)


def _planted(module, name, fn, run):
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        return run()
    finally:
        setattr(module, name, old)


def _show(label, row):
    sound = row["sound"]
    print(label + ": " + "; ".join(f"{k} {v:.5f}" + ("" if k == "sound" else f" ({v / sound:.2f}x)")
                                   for k, v in row.items()), flush=True)


def main():
    yi, qwen, seamless = _models()
    for cfg in (yi, qwen, seamless):
        p, tokens, embeds = _make(cfg)
        drift = lambda: _forward_drift(cfg, p, tokens, embeds)  # noqa: E731
        row = {"sound": drift(),
               "norm in bf16": _planted(L, "rms_norm", _norm_in_bf16, drift),
               "P rounded to bf16": _planted(attn_ops, "block_attention", _p_in_bf16, drift)}
        if cfg.qkv_bias:
            row["QKV bias dropped"] = _planted(L, "_qkv", _bias_dropped, drift)
        if cfg.enc_dec:
            row["frontend cast to fp8"] = _planted(T, "forward_train", _frontend_fp8, drift)
        _show(f"{cfg.name} (cut) bf16 forward vs float32 forward", row)
        if cfg.qkv_bias:
            drift = lambda: _decode_drift(cfg, p, tokens)  # noqa: E731
            _show(f"{cfg.name} (cut) bf16 decode vs bf16 forward",
                  {"sound": drift(),
                   "cache through fp8": _planted(L, "attn_decode", _cache_fp8, drift),
                   "QKV bias dropped": _planted(L, "attn_decode", _decode_bias_dropped, drift)})


if __name__ == "__main__":
    main()
