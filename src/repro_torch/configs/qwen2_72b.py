"""Qwen2-72B: dense GQA decoder with QKV bias.

[arXiv:2407.10671] 80L, d_model=8192, 64H (GQA kv=8), d_ff=29568,
vocab=152064, QKV bias, rope theta 1e6.

Field for field the configuration of ``src/repro/configs/qwen2_72b.py``.
"""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="qwen2-72b",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
    citation="arXiv:2407.10671",
)

SMOKE = ArchConfig(
    name="qwen2-smoke",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=512,
    vocab=512,
    qkv_bias=True,
    citation="arXiv:2407.10671 (reduced)",
)
