"""Fused RMSNorm: the CUDA kernel's wrapper.

``fused_rmsnorm`` launches ``csrc/fused_rmsnorm.cu`` for CUDA tensors and
takes the plain version (:mod:`.ref`) for CPU tensors; there is no fallback
from one to the other.  ``fused_rmsnorm.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_rmsnorm.ref import rmsnorm_ref

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _fn():
    f = _build.load("fused_rmsnorm").fused_rmsnorm_launch
    f.argtypes = [_P] * 3 + [_L, _I, _F, _I, _I, _P]
    f.restype = _I
    return f


def fused_rmsnorm(x, scale, eps: float = 1e-5):
    """x: (T, d) float32 or bfloat16, contiguous; scale: (d,) float32 or
    bfloat16 -> (T, d) in x's dtype, accumulated in float32."""
    if not x.is_cuda:
        return rmsnorm_ref(x, scale, eps)
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"fused_rmsnorm takes a contiguous (T, d) tensor, "
                         f"got {tuple(x.shape)} (contiguous="
                         f"{x.is_contiguous()})")
    T, d = x.shape
    if (scale.device != x.device or tuple(scale.shape) != (d,)
            or not scale.is_contiguous()):
        raise ValueError(f"fused_rmsnorm: scale must be a contiguous ({d},) "
                         f"tensor on {x.device}")
    out = torch.empty_like(x)
    err = _fn()(x.data_ptr(), scale.data_ptr(), out.data_ptr(), T, d,
                float(eps), _build.dtype_code(x.dtype),
                _build.dtype_code(scale.dtype),
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_rmsnorm")
    fused_rmsnorm.launches += 1
    return out


fused_rmsnorm.launches = 0
