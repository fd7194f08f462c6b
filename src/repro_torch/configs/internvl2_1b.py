"""InternVL2-1B: InternViT vision encoder (STUB) + Qwen2-0.5B-style LM.

[arXiv:2404.16821] LM backbone: 24L, d_model=896, 14H (GQA kv=2), d_ff=4864,
vocab=151655. The ViT frontend is a stub: the caller supplies 256
precomputed patch embeddings of shape (B, 256, d_model)
(``forward_train(frontend_embeds=)``, ``batch["embeds"]``), prepended to the
text tokens.

Field for field the configuration of ``src/repro/configs/internvl2_1b.py``.
"""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="internvl2-1b",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    qkv_bias=True,
    frontend="vision",
    frontend_tokens=256,
    rope_theta=1e6,
    citation="arXiv:2404.16821",
)

SMOKE = ArchConfig(
    name="internvl2-smoke",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=512,
    vocab=512,
    qkv_bias=True,
    frontend="vision",
    frontend_tokens=16,
    citation="arXiv:2404.16821 (reduced)",
)
