"""The cases and inputs of the model-axis tests (``tests/test_torch_tp.py``),
shared by the test module and its rank processes, which import no JAX: each
case is a registry id with overrides of its SMOKE config, and every input
is made with numpy from a seed."""
import dataclasses

import numpy as np

B, S, DEC_STEPS, MAX_LEN, CHUNK = 2, 12, 4, 16, 4
PRE_LENS = (7, 4, 0)
# case -> (registry id, overrides of its SMOKE config)
CASES = {
    "mamba2": ("mamba2-130m", {}),
    "yi": ("yi-6b", {}),
    "qwen2.5-bias": ("qwen2.5-32b", {}),
    "granite-mqa": ("granite-34b", {}),
    "odd-vocab": ("yi-6b", {"vocab": 511}),
    "internvl-vision": ("internvl2-1b", {}),
    "grok-moe": ("grok-1-314b", {}),
    "moe-3-experts": ("grok-1-314b", {"moe": {"n_experts": 3}}),
    "jamba": ("jamba-1.5-large-398b", {}),
    "deepseek-mla": ("deepseek-v2-lite-16b", {}),
    "seamless": ("seamless-m4t-large-v2", {}),
}
MOE = ("grok-moe", "moe-3-experts", "jamba", "deepseek-mla")


def smoke(get_smoke, arch, over):
    """``get_smoke(arch)`` (either package's) with ``over`` replaced; a dict
    value replaces fields of a sub-config."""
    cfg = get_smoke(arch)
    for key, value in over.items():
        if isinstance(value, dict):
            value = dataclasses.replace(getattr(cfg, key), **value)
        cfg = dataclasses.replace(cfg, **{key: value})
    return cfg


def inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "dec": rng.integers(0, cfg.vocab, (B, DEC_STEPS)).astype(np.int32),
           "pre": rng.integers(0, cfg.vocab, (len(PRE_LENS), max(PRE_LENS))).astype(np.int32),
           "post": rng.integers(0, cfg.vocab, (len(PRE_LENS), 1)).astype(np.int32)}
    if cfg.frontend != "none":
        out["embeds"] = rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model)).astype(
            np.float32)
    return out


def chunks(lens, chunk):
    """(pos, n_valid) of each prefill call, every row to its length."""
    lens = np.asarray(lens)
    done = np.zeros_like(lens)
    while (done < lens).any():
        nv = np.minimum(chunk, lens - done).astype(np.int32)
        yield done.astype(np.int32), nv
        done = done + nv


def chunk_tokens(pre, pos, nv, chunk):
    buf = np.zeros((pre.shape[0], chunk), np.int32)
    for r in range(pre.shape[0]):
        buf[r, :nv[r]] = pre[r, pos[r]:pos[r] + nv[r]]
    return buf


def pre_embeds(embeds):
    """The prefill rows' frame embeddings: the batch's rows and its first
    again (three rows)."""
    return np.concatenate([embeds, embeds[:1]])
