"""Plain PyTorch version of INT8 KV quantization (paper Eq. 8)."""
from __future__ import annotations

import torch


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
