"""Grok-1: 314B MoE decoder, 8 experts top-2.

[hf:xai-org/grok-1] 64L, d_model=6144, 48H (GQA kv=8), expert d_ff=32768,
vocab=131072, MoE 8 experts top-2 on every layer.

Field for field the configuration of ``src/repro/configs/grok_1_314b.py``.
"""
from repro_torch.models.config import ArchConfig, MoEConfig

ARCH = ArchConfig(
    name="grok-1-314b",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    ffn_pattern=("moe",),
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32768),
    rope_theta=1e4,
    citation="hf:xai-org/grok-1",
)

SMOKE = ArchConfig(
    name="grok-smoke",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=512,
    vocab=512,
    ffn_pattern=("moe",),
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=512),
    citation="hf:xai-org/grok-1 (reduced)",
)
