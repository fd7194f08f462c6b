"""Run provenance: the "where did this number come from" header.

The port's copy of ``repro.obs.provenance``. Every obs stream the port
writes embeds the same provenance dict, so a reader can tell a CPU number
from a card one, and a stale stream from the revision that produced it.
``torch``, ``cuda``, ``backend`` (``cuda`` or ``cpu``) and ``device_kind``
(``torch.cuda.get_device_name``) take the place of the JAX package's
``jax``/``backend``/``device_kind``; every other key is the reference's.
"""
from __future__ import annotations

import datetime
import hashlib
import json
import platform as _platform
import subprocess
from typing import Any

__all__ = ["provenance", "config_hash", "PROVENANCE_KEYS"]

# Keys every provenance dict carries.
PROVENANCE_KEYS = ("torch", "cuda", "numpy", "platform", "backend",
                   "device_kind", "git_rev", "timestamp_utc")


def _git_rev() -> str:
    try:
        root = str(__file__).rsplit("/src/", 1)[0]
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, timeout=10, cwd=root)
        rev = out.stdout.strip()
        dirty = subprocess.run(["git", "status", "--porcelain"],
                               capture_output=True, text=True, timeout=10,
                               cwd=root).stdout.strip()
        return (rev + ("+dirty" if dirty else "")) if rev else "unknown"
    except Exception:
        return "unknown"


def config_hash(config: Any) -> str:
    """Short stable hash of an arbitrary JSON-able config object."""
    blob = json.dumps(config, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def provenance(config: Any = None, device: Any = None) -> dict:
    """Build the provenance dict; ``config`` (if given) is hashed in as
    ``config_hash``. ``device`` is the torch device the run used (``None``
    reads the card if there is one)."""
    import numpy as np
    import torch
    out: dict[str, Any] = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "none",
        "numpy": np.__version__,
        "platform": _platform.platform(),
        "git_rev": _git_rev(),
        "timestamp_utc": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
    }
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    out["backend"] = dev.type
    out["device_kind"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                          else "cpu")
    if config is not None:
        out["config_hash"] = config_hash(config)
    return out
