"""DeepSeek-V2-Lite: MLA attention + fine-grained MoE.

[arXiv:2405.04434] 27L, d_model=2048, 16H, MLA kv_lora_rank=512 (qk_nope=128,
qk_rope=64, v=128), vocab=102400; MoE 64 routed experts top-6 + 2 shared,
expert d_ff=1408.

Field for field the configuration of ``src/repro/configs/deepseek_v2_lite_16b.py``.
"""
from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig

ARCH = ArchConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    attn_type="mla",
    mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    ffn_pattern=("moe",),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408),
    rope_theta=1e4,
    citation="arXiv:2405.04434",
)

SMOKE = ArchConfig(
    name="deepseek-v2-lite-smoke",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=512,
    attn_type="mla",
    mla=MLAConfig(kv_lora_rank=64, qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32),
    ffn_pattern=("moe",),
    moe=MoEConfig(n_experts=4, top_k=2, n_shared=1, d_expert=128),
    citation="arXiv:2405.04434 (reduced)",
)
