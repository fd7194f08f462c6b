"""Granite-34B-Code: deep MQA (kv=1) dense decoder for code.

[arXiv:2405.04324] 88L, d_model=6144, 48H (MQA kv=1), d_ff=24576, vocab=49152.

Field for field the configuration of ``src/repro/configs/granite_34b.py``.
"""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="granite-34b",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    rope_theta=1e5,
    citation="arXiv:2405.04324",
)

SMOKE = ArchConfig(
    name="granite-smoke",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=1,
    d_ff=512,
    vocab=512,
    citation="arXiv:2405.04324 (reduced)",
)
