"""Plain PyTorch versions of INT8 KV quantization (paper Eq. 8) and of the
quantized-KV paged decode attention."""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def kv_quantize_ref(x):
    """Channel-wise (last-dim kept) asymmetric INT8 quant of a KV tensor.
    x: (..., d) -> (q int8 (...,d), scale (...,1), zero (...,1)).
    ``torch.round`` rounds half to even, as ``jnp.round``."""
    xf = x.float()
    mx = xf.amax(dim=-1, keepdim=True)
    mn = xf.amin(dim=-1, keepdim=True)
    lam = torch.clamp((mx - mn) / 255.0, min=1e-8)
    z = torch.round(-mn / lam)
    q = torch.clamp(torch.round(xf / lam + z), 0, 255) - 128
    return q.to(torch.int8), lam, z


def kv_dequantize_ref(q, lam, z, dtype=torch.float32):
    return (lam * (q.float() + 128.0 - z)).to(dtype)


def paged_attention_q8_ref(q, kq, k_lam, k_z, vq, v_lam, v_z, block_tables,
                           lengths):
    """Quantized-pool oracle: dequantize the pages, then exact paged
    attention."""
    k = kv_dequantize_ref(kq, k_lam, k_z)
    v = kv_dequantize_ref(vq, v_lam, v_z)
    return paged_attention_ref(q, k, v, block_tables, lengths)
