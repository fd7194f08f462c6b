"""Yi-6B: llama-architecture dense GQA decoder.

[arXiv:2403.04652] 32L, d_model=4096, 32H (GQA kv=4), d_ff=11008, vocab=64000.

Field for field the configuration of ``src/repro/configs/yi_6b.py``.
"""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="yi-6b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    rope_theta=5e6,
    citation="arXiv:2403.04652",
)

SMOKE = ArchConfig(
    name="yi-smoke",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=512,
    vocab=512,
    citation="arXiv:2403.04652 (reduced)",
)
