"""The cases and inputs of the data-axis tests (``tests/test_torch_dp.py``),
shared by the test module and its rank processes, which import no JAX: each
case is a registry id with overrides of its SMOKE config and the global
batch's (rows, positions), and every input is made with numpy from a
seed."""
import dataclasses

import numpy as np

STEPS = 3
LR_R = 20.0
# case -> (registry id, overrides of its SMOKE config, (B, S) of the global batch)
CASES = {
    "mamba2": ("mamba2-130m", {}, (4, 12)),
    "yi": ("yi-6b", {}, (4, 12)),
    "odd-vocab": ("yi-6b", {"vocab": 511}, (4, 12)),
    "internvl-vision": ("internvl2-1b", {}, (4, 12)),
    "grok-moe": ("grok-1-314b", {}, (4, 12)),
    "jamba": ("jamba-1.5-large-398b", {}, (4, 12)),
    "deepseek-mla": ("deepseek-v2-lite-16b", {}, (4, 12)),
    "seamless": ("seamless-m4t-large-v2", {}, (4, 12)),
    # a batch of 1: batch_specs cuts the sequence, each rank runs the whole row
    "batch-of-1": ("jamba-1.5-large-398b", {}, (1, 12)),
    # neither 3 rows nor 13 positions divide over 2 ranks: replicated
    "replicated": ("grok-1-314b", {}, (3, 13)),
}
# The MoE cases whose batch is cut by rows: their aux loss needs the data axis.
MOE_ROWS = ("grok-moe", "jamba", "deepseek-mla")


def smoke(get_smoke, arch, over):
    """``get_smoke(arch)`` (either package's) with ``over`` replaced; a dict
    value replaces fields of a sub-config."""
    cfg = get_smoke(arch)
    for key, value in over.items():
        if isinstance(value, dict):
            value = dataclasses.replace(getattr(cfg, key), **value)
        cfg = dataclasses.replace(cfg, **{key: value})
    return cfg


def batches(cfg, shape):
    """The global batch of each step: next-token pairs of one draw of
    ``S + 1`` tokens a row, and stub frame or patch embeddings N(0, 1)."""
    b, s = shape
    out = []
    for step in range(STEPS):
        rng = np.random.default_rng(100 + step)
        toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
        if cfg.frontend != "none":
            batch["embeds"] = rng.standard_normal(
                (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
        out.append(batch)
    return out


def flatten(tree, prefix=""):
    """{"a/b/c": leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *parts, last = key.split("/")
        for part in parts:
            node = node.setdefault(part, {})
        node[last] = value
    return tree
