"""The SSD chunked scan's entry point, the port of
``src/repro/kernels/ssd_scan/ops.py:15`` ``ssd_chunked``."""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.ref import ssd_chunked_plain
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan

__all__ = ["ssd_chunked"]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, *, chunk: int = 256) -> torch.Tensor:
    """Mamba2 SSD: x (B,H,L,P), dt (B,H,L) post-softplus, a_log (H,), b/c
    (B,G,L,N) with H % G == 0 (each group shared by H/G heads). Returns
    y (B,H,L,P).

    A CUDA tensor launches the hand-written kernel, which reads B/C by group
    and masks a ragged last chunk itself, or raises. A CPU tensor takes the
    plain version, which pads L to a chunk multiple with dt = 0 (a no-op
    step), and so does a meta tensor (shapes only, nothing computed: the
    dry run's count, ``launch/dryrun.py``); any other device is refused."""
    if x.device.type == "cuda":
        return ssd_scan(x, dt, a_log, b, c, chunk=chunk)
    if x.device.type not in ("cpu", "meta"):
        raise ValueError(f"ssd_chunked takes CPU, CUDA or meta tensors, got {x.device}")
    return ssd_chunked_plain(x, dt, a_log, b, c, chunk)[0]
