"""Architecture registry, the port of ``repro.configs``: the same ten ids.
Each ported module exposes ARCH (the assigned configuration) and SMOKE (a
reduced variant of the same family).

Ported: the Mamba2 family (``mamba2-130m``), the dense GQA family
(``yi-6b``, ``qwen2.5-32b``, ``qwen2-72b``, ``granite-34b``), the vision
stub (``internvl2-1b``) and the MoE models (``grok-1-314b``, and
``jamba-1.5-large-398b``, which mixes Mamba2 and attention slots). MLA
(``deepseek-v2-lite-16b``) and the encoder-decoder
(``seamless-m4t-large-v2``) raise ``NotImplementedError`` (``ROADMAP.md``
A10).

Usage: ``from repro_torch.configs import get_arch, get_smoke, ARCH_IDS``.
"""
from __future__ import annotations

import importlib

__all__ = ["ARCH_IDS", "get_arch", "get_smoke"]

ARCH_IDS = [
    "jamba-1.5-large-398b",
    "deepseek-v2-lite-16b",
    "mamba2-130m",
    "qwen2-72b",
    "yi-6b",
    "internvl2-1b",
    "granite-34b",
    "qwen2.5-32b",
    "grok-1-314b",
    "seamless-m4t-large-v2",
]

_PORTED = {"mamba2-130m", "yi-6b", "qwen2.5-32b", "qwen2-72b", "granite-34b",
           "internvl2-1b", "grok-1-314b", "jamba-1.5-large-398b"}


def _load(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    if arch_id not in _PORTED:
        raise NotImplementedError(
            f"{arch_id}: its model family is not ported yet (ROADMAP.md A10)")
    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))


def get_arch(arch_id: str):
    return _load(arch_id).ARCH


def get_smoke(arch_id: str):
    return _load(arch_id).SMOKE
