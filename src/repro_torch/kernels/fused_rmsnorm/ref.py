"""Plain PyTorch version of RMSNorm over rows."""
from __future__ import annotations

import torch


def rmsnorm_ref(x, scale, eps: float = 1e-5):
    """x: (..., d), scale: (d,) -> x * rsqrt(mean(x^2) + eps) * scale,
    computed in float32 and returned in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
