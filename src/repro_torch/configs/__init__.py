"""Architecture registry, the port of ``repro.configs``: the same ten ids,
all loaded. Each module exposes ARCH (the assigned configuration) and SMOKE
(a reduced variant of the same family), field for field the reference's:
Mamba2 (``mamba2-130m``), dense GQA (``yi-6b``, ``qwen2.5-32b``,
``qwen2-72b``, ``granite-34b``), the vision stub (``internvl2-1b``), MoE
(``grok-1-314b``, and ``jamba-1.5-large-398b``, which mixes Mamba2 and
attention slots), MLA with MoE and shared experts
(``deepseek-v2-lite-16b``) and the encoder-decoder with the audio stub
(``seamless-m4t-large-v2``).

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


def _load(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))


def get_arch(arch_id: str):
    return _load(arch_id).ARCH


def get_smoke(arch_id: str):
    return _load(arch_id).SMOKE
