from repro_torch.kernels.quantize.ops import payload_quantize_dequantize, payload_side_info

__all__ = ["payload_quantize_dequantize", "payload_side_info"]
