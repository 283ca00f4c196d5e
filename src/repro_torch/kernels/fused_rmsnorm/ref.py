"""Plain PyTorch versions of RMSNorm over rows, whole or split over ranks."""
from __future__ import annotations

import torch


def rmsnorm_ref(x, scale, eps: float = 1e-5):
    """x: (..., d), scale: (d,) -> x * rsqrt(mean(x^2) + eps) * scale,
    computed in float32 and returned in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_sumsq_ref(x):
    """x: (T, d) -> (T,) float32: each row's sum of squares, in float32
    (a rank's part of a split row's statistic)."""
    xf = x.float()
    return (xf * xf).sum(-1)


def rmsnorm_apply_ref(x, sumsq, scale, d_full: int, eps: float = 1e-5):
    """x: (T, d) a rank's columns of rows of ``d_full`` columns, sumsq (T,)
    float32 the whole rows' sums of squares, scale (d,) ->
    x * rsqrt(sumsq / d_full + eps) * scale in float32, returned in x's
    dtype."""
    r = torch.rsqrt(sumsq.float() / d_full + eps)
    return (x.float() * r[..., None] * scale.float()).to(x.dtype)
