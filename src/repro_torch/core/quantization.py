"""KV-cache sizing for the memory manager (paper Eq. 8 context).

The engine path quantizes KV on the device through the ``kv_quant``
kernels (``serving/kv_cache.py``); the host-side quantizers of the JAX
package are not on that path and are not ported.
"""
from __future__ import annotations


def kv_bytes_per_token(num_layers: int, num_kv_heads: int, head_dim: int,
                       quantized: bool = False) -> int:
    """Bytes of KV per token: 2 (K,V) x layers x heads x dim x dtype bytes."""
    per = 2 * num_layers * num_kv_heads * head_dim
    return per * (1 if quantized else 2)   # int8 vs bf16
