"""Flat-npz checkpointing with tree structure preserved by key paths, the
port of ``repro.checkpoint.store`` in the reference's file format.

Layout: <dir>/step_<N>.npz holding one array per leaf, keyed by its path
joined with ``||`` (dict keys by name, sequence indices as numbers:
``cells||0||1``, ``embed``; a bare leaf is ``__root__``), plus a
``__meta__`` JSON blob (step, metrics). A file written by either package
loads in the other. Trees are dicts/lists/tuples of tensors or numpy
arrays; dicts are walked in sorted-key order, as ``jax.tree_util`` walks
them.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step"]

_SEP = "||"


def _items(tree: Any, path: tuple = ()):
    """(key, leaf) pairs in tree order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _items(sub, path + (str(i),))
    else:
        yield _SEP.join(path) or "__root__", tree


def _restore(tree: Any, arrays: dict, path: tuple = ()):
    """``tree`` with every leaf replaced by its array from ``arrays``, cast
    to the leaf's dtype and (for tensors) put on the leaf's device."""
    if isinstance(tree, dict):
        return {k: _restore(tree[k], arrays, path + (str(k),)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_restore(sub, arrays, path + (str(i),))
                          for i, sub in enumerate(tree))
    key = _SEP.join(path) or "__root__"
    if key not in arrays:
        raise KeyError(f"checkpoint has no array {key!r}")
    arr = arrays[key]
    if arr.shape != tuple(tree.shape):
        raise ValueError(f"{key}: checkpoint shape {arr.shape} != template "
                         f"shape {tuple(tree.shape)}")
    if torch.is_tensor(tree):
        return torch.from_numpy(arr).to(device=tree.device, dtype=tree.dtype)
    return arr.astype(tree.dtype)


def _numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(directory: str, step: int, tree: Any,
                    metrics: dict | None = None) -> str:
    """Write ``tree`` to ``<directory>/step_<step>.npz`` through a ``.tmp``
    file renamed into place; returns the path."""
    os.makedirs(directory, exist_ok=True)
    arrays = {key: _numpy(leaf) for key, leaf in _items(tree)}
    meta = {"step": int(step), "metrics": metrics or {}}
    path = os.path.join(directory, f"step_{step:08d}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
                 **arrays)
    os.replace(tmp, path)
    return path


def load_checkpoint(directory: str, template: Any,
                    step: int | None = None) -> tuple[Any, dict]:
    """Restore into ``template``'s structure (the latest step unless
    ``step`` is given): shapes checked against the template, whose dtypes
    and devices the restored leaves take. Returns (tree, meta)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}.npz")
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
    return _restore(template, arrays), meta


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(m.group(1))
        for f in os.listdir(directory)
        if (m := re.match(r"step_(\d+)\.npz$", f))
    ]
    return max(steps) if steps else None
