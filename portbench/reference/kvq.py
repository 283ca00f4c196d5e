"""The INT8 round trip of a swapped request's K/V, worked out again by the
reference: a frozen copy of the arithmetic the port's swap applies (its
``kernels/kv_quant/ref.py``: per (token, head) row over the head dim,
asymmetric, 255 steps, round half to even), in float32."""
from __future__ import annotations

import torch


def roundtrip(x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., d) float32 quantized to INT8 row by row and back."""
    mx = x.amax(dim=-1, keepdim=True)
    mn = x.amin(dim=-1, keepdim=True)
    lam = torch.clamp((mx - mn) / x.new_full((), 255.0), min=1e-8)
    z = torch.round(-mn / lam)
    q = torch.clamp(torch.round(x / lam + z), 0, 255) - 128
    return lam * (q + 128.0 - z)
