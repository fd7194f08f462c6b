from repro_torch.kernels.block_attn import ref
from repro_torch.kernels.block_attn.ops import block_attention

__all__ = ["block_attention", "ref"]
