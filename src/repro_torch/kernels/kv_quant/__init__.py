from repro_torch.kernels.kv_quant.ops import kv_dequantize, kv_quantize
from repro_torch.kernels.kv_quant.ref import kv_dequantize_ref, kv_quantize_ref

__all__ = ["kv_quantize", "kv_dequantize", "kv_quantize_ref",
           "kv_dequantize_ref"]
