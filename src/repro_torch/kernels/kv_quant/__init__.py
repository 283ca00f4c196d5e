from repro_torch.kernels.kv_quant.ops import (kv_dequantize, kv_quantize,
                                             kv_quantize_store,
                                             paged_attention_q8)
from repro_torch.kernels.kv_quant.ref import (kv_dequantize_ref,
                                              kv_quantize_ref,
                                              kv_quantize_store_ref,
                                              paged_attention_q8_ref)

__all__ = ["kv_quantize", "kv_quantize_store", "kv_dequantize",
           "paged_attention_q8", "kv_quantize_ref", "kv_quantize_store_ref",
           "kv_dequantize_ref", "paged_attention_q8_ref"]
