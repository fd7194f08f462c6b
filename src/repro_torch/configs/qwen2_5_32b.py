"""Qwen2.5-32B: dense GQA decoder with QKV bias.

[hf:Qwen/Qwen2.5-0.5B family card, 32B size] 64L, d_model=5120, 40H
(GQA kv=8), d_ff=27648, vocab=152064.

Field for field the configuration of ``src/repro/configs/qwen2_5_32b.py``.
"""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="qwen2.5-32b",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
    citation="hf:Qwen/Qwen2.5-0.5B",
)

SMOKE = ArchConfig(
    name="qwen2.5-smoke",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=512,
    vocab=512,
    qkv_bias=True,
    citation="hf:Qwen/Qwen2.5-0.5B (reduced)",
)
