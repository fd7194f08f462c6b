"""Layer primitives of the language-model zoo, the port of
``repro.models.layers``, with what the Mamba2 family needs: RMSNorm and the
Mamba2 SSD mixer (chunked full-sequence scan and O(1) recurrent decode).

Plain functions over explicit parameter dicts, in the reference's layouts,
so weights carry across unchanged. Nothing here was a Pallas kernel in the
JAX package except the SSD scan, which ``mamba_train`` always sends to
``repro_torch.kernels.ssd_scan.ssd_chunked``: the tensors' device picks the
route (the kernel on the card, its plain version on the CPU), and
``cfg.use_pallas_ssd`` is read by nothing here.

Precision: float32 throughout. The causal depthwise convolution is the
reference's sum of shifted products, not ``F.conv1d`` (which cuDNN runs in
TF32 by default on the card), and softplus is ``jax.nn.softplus``'s
``max(x, 0) + log1p(exp(-|x|))`` (``F.softplus`` switches to ``x`` above a
threshold of 20).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.config import ArchConfig

__all__ = [
    "rms_norm",
    "init_mamba",
    "mamba_train",
    "init_cache_mamba",
    "mamba_decode",
]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) as max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _dense(gen: torch.Generator, shape, device, scale=None) -> torch.Tensor:
    """normal * scale (1/sqrt(fan_in) by default), drawn on the CPU from
    ``gen`` and moved to ``device``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return (scale * torch.randn(shape, generator=gen)).to(device)


# ------------------------------------------------------------------ Mamba2
def init_mamba(gen: torch.Generator, cfg: ArchConfig, device) -> dict:
    """The reference's shapes and scales; the draws are ``gen``'s, not JAX's."""
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    n_h = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.state_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": _dense(gen, (d, 2 * d_in + 2 * s.n_groups * s.state_dim + n_h), device),
        "conv_w": _dense(gen, (s.d_conv, conv_dim), device, scale=0.5),
        "conv_b": torch.zeros(conv_dim, **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_h)).to(device),
        "D": torch.ones(n_h, **f32),
        "dt_bias": torch.zeros(n_h, **f32),
        "norm": torch.ones(d_in, **f32),
        "out_proj": _dense(gen, (d_in, d), device),
    }


def _mamba_split(p, x, cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_h = d_in // s.head_dim
    gn = s.n_groups * s.state_dim
    z, xc, bc, cc, dt = torch.split(x @ p["in_proj"], [d_in, d_in, gn, gn, n_h], dim=-1)
    return z, xc, bc, cc, dt, n_h, d_in


def mamba_train(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    s = cfg.ssm
    b, l, _ = x.shape
    z, xc, bc, cc, dt, n_h, d_in = _mamba_split(p, x, cfg)
    # Causal depthwise conv over (x, B, C): a sum of shifted products.
    xbc = torch.cat([xc, bc, cc], dim=-1)
    pad = F.pad(xbc, (0, 0, s.d_conv - 1, 0))
    conv = sum(pad[:, i:i + l, :] * p["conv_w"][i] for i in range(s.d_conv)) + p["conv_b"]
    conv = F.silu(conv)
    gn = s.n_groups * s.state_dim
    xc, bc, cc = torch.split(conv, [d_in, gn, gn], dim=-1)
    xh = xc.reshape(b, l, n_h, s.head_dim)
    bb = bc.reshape(b, l, s.n_groups, s.state_dim)
    cv = cc.reshape(b, l, s.n_groups, s.state_dim)
    dt_ = _softplus(dt.float() + p["dt_bias"])
    chunk = min(s.chunk, l)
    # Transposed views: the kernel reads them by strides, no copy.
    y = ssd_ops.ssd_chunked(xh.transpose(1, 2), dt_.transpose(1, 2), p["A_log"],
                            bb.transpose(1, 2), cv.transpose(1, 2),
                            chunk=chunk).transpose(1, 2)
    y = y + xh * p["D"].to(xh.dtype)[:, None]
    y = y.reshape(b, l, d_in)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"]


def init_cache_mamba(cfg: ArchConfig, batch: int, dtype, device) -> dict:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_h = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.state_dim
    return {
        "conv": torch.zeros(batch, s.d_conv - 1, conv_dim, dtype=dtype, device=device),
        "ssm": torch.zeros(batch, n_h, s.head_dim, s.state_dim, dtype=dtype, device=device),
    }


def mamba_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ArchConfig,
                 active: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """O(1) recurrent step. x (B,1,d). ``active`` (B,) bool gates the
    conv/ssm state advance per row (inactive rows keep their cache)."""
    s = cfg.ssm
    b = x.shape[0]
    z, xc, bc, cc, dt, n_h, d_in = _mamba_split(p, x, cfg)
    xbc = torch.cat([xc, bc, cc], dim=-1)                       # (b,1,conv_dim)
    window = torch.cat([cache["conv"], xbc], dim=1)             # (b,d_conv,conv_dim)
    conv = torch.einsum("btc,tc->bc", window, p["conv_w"]) + p["conv_b"]
    conv = F.silu(conv)[:, None, :]
    new_conv_cache = window[:, 1:, :]
    gn = s.n_groups * s.state_dim
    xc, bc, cc = torch.split(conv, [d_in, gn, gn], dim=-1)
    xh = xc.reshape(b, n_h, s.head_dim)
    rep = n_h // s.n_groups
    bbh = bc.reshape(b, s.n_groups, s.state_dim).repeat_interleave(rep, dim=1)  # (b,h,n)
    cvh = cc.reshape(b, s.n_groups, s.state_dim).repeat_interleave(rep, dim=1)
    dt_ = _softplus(dt.float() + p["dt_bias"])[:, 0]             # (b,h)
    a = -torch.exp(p["A_log"].float())
    alpha = torch.exp(dt_ * a)                                  # (b,h)
    st = cache["ssm"]
    st = st * alpha[..., None, None].to(st.dtype) + torch.einsum(
        "bhp,bhn->bhpn", xh * dt_.to(xh.dtype)[..., None], bbh)
    y = torch.einsum("bhpn,bhn->bhp", st, cvh) + xh * p["D"].to(xh.dtype)[:, None]
    y = y.reshape(b, 1, d_in)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    if active is not None:
        new_conv_cache = torch.where(active[:, None, None], new_conv_cache, cache["conv"])
        st = torch.where(active[:, None, None, None], st, cache["ssm"])
    return y @ p["out_proj"], {"conv": new_conv_cache, "ssm": st}
