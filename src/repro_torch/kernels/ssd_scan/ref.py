"""Plain PyTorch versions of the SSD chunked scan, beside the kernel.

- :func:`ssd_sequential_ref`: the literal SSM recurrence
  ``S_t = exp(dt_t a) S_{t-1} + B_t (dt_t x_t)^T``, ``y_t = C_t S_t``:
  slow but indisputable (``src/repro/kernels/ssd_scan/ref.py``).
- :func:`ssd_chunked_plain`: the chunked formulation (arXiv:2405.21060,
  Alg. 1) of ``repro.models.layers.ssd_chunked_ref``, written in the
  kernel's ``(B, H, L, P)`` layout with B/C per group, as
  ``ssd_chunked_jnp`` adapts it. It is the CPU path of
  :func:`repro_torch.kernels.ssd_scan.ssd_chunked` and the oracle the
  kernel is held to on the card. No path hands it a CUDA tensor in place
  of the kernel.

``ssd_chunked_plain`` keeps the within-chunk prefix sum of the log-decay in
float64, as the kernel does: |cum| reaches thousands when dt*|A| is large,
and exp(cum_i - cum_j) of nearby positions then loses ulp(|cum|) to the
cancellation in float32. The products stay float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ssd_sequential_ref", "ssd_chunked_plain"]


def ssd_sequential_ref(x, dt, a_log, b, c):
    """x (B,H,L,P), dt (B,H,L), a_log (H,), b/c (B,H,L,N) -> y (B,H,L,P)."""
    bsz, h, l, p = x.shape
    n = b.shape[-1]
    a = -torch.exp(a_log.float())
    state = torch.zeros(bsz, h, n, p, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(l):
        dtt = dt[:, :, t].float()
        alpha = torch.exp(dtt * a)
        xdt = x[:, :, t].float() * dtt[..., None]
        state = state * alpha[..., None, None] + b[:, :, t, :, None].float() * xdt[:, :, None, :]
        ys.append(torch.einsum("bhnp,bhn->bhp", state, c[:, :, t].float()))
    return torch.stack(ys, dim=2).to(x.dtype)


def _segsum_exp(cum):
    """exp(segment sums) from the prefix sums ``cum`` (..., C) of a
    log-decay: L[i,j] = exp(cum_i - cum_j) for j <= i, else 0, as float32
    (..., C, C). Masked before the exp: the upper triangle's exp
    overflows."""
    c = cum.shape[-1]
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones(c, c, dtype=torch.bool, device=cum.device).tril()
    return torch.exp(diff.masked_fill(~mask, float("-inf"))).float()


def ssd_chunked_plain(x, dt, a_log, b, c, chunk: int):
    """Chunked SSD. x (B,H,L,P), dt (B,H,L) post-softplus, a_log (H,)
    (A = -exp(a_log)), b/c (B,G,L,N) with H % G == 0. L is padded to a
    multiple of ``chunk`` with dt = 0 (a no-op step). Returns y (B,H,L,P)
    and the final state (B,H,P,N)."""
    bsz, h, l, p = x.shape
    g, n = b.shape[1], b.shape[3]
    if h % g:
        raise ValueError(f"heads {h} not divisible by groups {g}")
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        dt = F.pad(dt, (0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    nc = (l + pad) // chunk
    a = -torch.exp(a_log.float())
    dtc = (dt.float() * a[:, None]).reshape(bsz, h, nc, chunk)      # log-decay
    xc = (x * dt.to(x.dtype)[..., None]).reshape(bsz, h, nc, chunk, p)
    bh = b.repeat_interleave(h // g, dim=1).reshape(bsz, h, nc, chunk, n)
    ch = c.repeat_interleave(h // g, dim=1).reshape(bsz, h, nc, chunk, n)

    cum = torch.cumsum(dtc.double(), dim=-1)

    # Within a chunk: y = ((C B^T) * L) (x dt).
    scores = torch.einsum("bhzin,bhzjn->bhzij", ch, bh).float()
    y_diag = torch.einsum("bhzij,bhzjp->bhzip", scores * _segsum_exp(cum), xc)

    # Chunk-final states S_z = sum_j exp(cum_end - cum_j) B_j (x dt)_j^T,
    # carried across chunks: S <- exp(cum_end) S + S_z.
    decay_to_end = torch.exp(cum[..., -1:] - cum).float()
    sz = torch.einsum("bhzjn,bhzj,bhzjp->bhzpn", bh, decay_to_end, xc)
    chunk_decay = torch.exp(cum[..., -1]).float()
    state = torch.zeros(bsz, h, p, n, dtype=x.dtype, device=x.device)
    entering = []
    for z in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, :, z, None, None] + sz[:, :, z]
    s_prev = torch.stack(entering, dim=2)                          # (b,h,nc,p,n)

    # Across chunks: y_i += exp(cum_i) C_i S_entering.
    y_off = torch.einsum("bhzin,bhzi,bhzpn->bhzip", ch, torch.exp(cum).float(), s_prev)
    y = (y_diag + y_off).reshape(bsz, h, nc * chunk, p)[:, :, :l]
    return y, state
