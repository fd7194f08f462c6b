"""Jamba-1.5-Large: hybrid Mamba+Attention 1:7 interleave, MoE.

[arXiv:2403.19887 / Jamba-1.5 model card] 72L, d_model=8192, 64H (GQA kv=8),
d_ff=24576, vocab=65536, MoE 16 experts top-2 on every other layer; one
attention layer per 8-layer block (the 1:7 attn:mamba interleave).

Field for field the configuration of ``src/repro/configs/jamba_1_5_large_398b.py``.
"""
from repro_torch.models.config import ArchConfig, MoEConfig, SSMConfig

ARCH = ArchConfig(
    name="jamba-1.5-large-398b",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    # Real Jamba block: [m, m, m, m, a, m, m, m]; MoE every other layer.
    block_pattern=("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba"),
    ffn_pattern=("dense", "moe", "dense", "moe", "dense", "moe", "dense", "moe"),
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24576),
    ssm=SSMConfig(state_dim=128, head_dim=64, n_groups=8, chunk=256, expand=2),
    rope_theta=1e6,
    citation="arXiv:2403.19887",
)

SMOKE = ArchConfig(
    name="jamba-smoke",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=512,
    vocab=512,
    block_pattern=("mamba", "attn"),
    ffn_pattern=("dense", "moe"),
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=512),
    ssm=SSMConfig(state_dim=32, head_dim=32, n_groups=2, chunk=32, expand=2),
    citation="arXiv:2403.19887 (reduced)",
)
