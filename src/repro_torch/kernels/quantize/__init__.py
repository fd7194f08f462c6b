from repro_torch.kernels.quantize.ops import (
    payload_quantize_dequantize,
    payload_side_info,
    segment_quantize_dequantize,
    stochastic_dequantize,
    stochastic_quantize,
)
from repro_torch.kernels.quantize import ref

__all__ = [
    "stochastic_quantize",
    "stochastic_dequantize",
    "segment_quantize_dequantize",
    "payload_quantize_dequantize",
    "payload_side_info",
    "ref",
]
