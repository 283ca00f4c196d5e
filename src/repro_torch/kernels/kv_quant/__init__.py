from repro_torch.kernels.kv_quant.ops import (kv_dequantize, kv_quantize,
                                             paged_attention_q8)
from repro_torch.kernels.kv_quant.ref import (kv_dequantize_ref,
                                              kv_quantize_ref,
                                              paged_attention_q8_ref)

__all__ = ["kv_quantize", "kv_dequantize", "paged_attention_q8",
           "kv_quantize_ref", "kv_dequantize_ref", "paged_attention_q8_ref"]
