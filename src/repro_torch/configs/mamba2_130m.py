"""Mamba2-130M: pure SSM (state-space duality / SSD), attention-free.

[arXiv:2405.21060] 24L, d_model=768, vocab=50280 (padded 50288 in the
release; the model-card value is kept), ssm_state=128, head_dim=64,
expand=2, no FFN sublayer (the mixer is the whole layer). Field for field
the configuration of ``src/repro/configs/mamba2_130m.py``.
"""
from repro_torch.models.config import ArchConfig, SSMConfig

ARCH = ArchConfig(
    name="mamba2-130m",
    n_layers=24,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=0,
    vocab=50280,
    block_pattern=("mamba",),
    ffn_pattern=("none",),
    ssm=SSMConfig(state_dim=128, head_dim=64, n_groups=1, chunk=256, expand=2),
    tie_embeddings=True,
    citation="arXiv:2405.21060",
)

SMOKE = ArchConfig(
    name="mamba2-smoke",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=512,
    block_pattern=("mamba",),
    ffn_pattern=("none",),
    ssm=SSMConfig(state_dim=32, head_dim=32, n_groups=1, chunk=32, expand=2),
    tie_embeddings=True,
    citation="arXiv:2405.21060 (reduced)",
)
