"""SeamlessM4T-Large-v2: encoder-decoder multimodal translation backbone.

[arXiv:2308.11596] Text decoder backbone: 24L decoder + 24L encoder,
d_model=1024, 16H (kv=16, i.e. MHA), d_ff=8192, vocab=256206. The speech
frontend (mel + conformer feature extractor) is a stub, as in the
reference: the caller supplies frame embeddings (B, frames, d_model), which
the encoder consumes.

Field for field the configuration of ``src/repro/configs/seamless_m4t_large_v2.py``.
"""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="seamless-m4t-large-v2",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    enc_dec=True,
    n_enc_layers=24,
    frontend="audio",
    frontend_tokens=1024,   # encoder frames fed by the stub frontend
    rope_theta=1e4,
    citation="arXiv:2308.11596",
)

SMOKE = ArchConfig(
    name="seamless-smoke",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=512,
    vocab=512,
    enc_dec=True,
    n_enc_layers=2,
    frontend="audio",
    frontend_tokens=32,
    citation="arXiv:2308.11596 (reduced)",
)
