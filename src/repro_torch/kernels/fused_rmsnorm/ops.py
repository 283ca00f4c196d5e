"""Fused RMSNorm: the CUDA kernel's wrapper and the autograd Function.

``fused_rmsnorm`` launches ``csrc/fused_rmsnorm.cu`` for CUDA tensors and
takes the plain version (:mod:`.ref`) for CPU tensors; there is no fallback
from one to the other.  ``fused_rmsnorm.launches`` counts kernel launches.
The raw wrapper records no backward and raises when grad mode is on and an
input requires grad; :class:`FusedRMSNorm` is its differentiable form (the
kernel forward, a plain recomputed backward, as the JAX package, which has
no backward kernel, differentiates the jnp norm).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_rmsnorm.ref import rmsnorm_ref

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


_FN = []


def _fn():
    """The C entry point, typed once (the decode steps call this wrapper
    some 80 times a step, so its host time counts)."""
    if not _FN:
        f = _build.load("fused_rmsnorm").fused_rmsnorm_launch
        f.argtypes = [_P] * 3 + [_L, _I, _F, _I, _I, _P]
        f.restype = _I
        _FN.append(f)
    return _FN[0]


def fused_rmsnorm(x, scale, eps: float = 1e-5):
    """x: (T, d) float32 or bfloat16, contiguous; scale: (d,) float32 or
    bfloat16 -> (T, d) in x's dtype, accumulated in float32."""
    _build.refuse_grad("fused_rmsnorm", x, scale)
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
    fn = _fn()
    with _build.COUNT_LOCK:
        err = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), T, d,
                 float(eps), _build.dtype_code(x.dtype),
                 _build.dtype_code(scale.dtype),
                 torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "fused_rmsnorm")
        fused_rmsnorm.launches += 1
    return out


fused_rmsnorm.launches = 0


class FusedRMSNorm(torch.autograd.Function):
    """Differentiable ``fused_rmsnorm``: ``FusedRMSNorm.apply(x, scale,
    eps)``.  The forward launches the kernel (the plain version on the CPU)
    and saves x and scale; the backward recomputes ``rmsnorm_ref`` under
    grad mode and returns its gradients."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale)
        return fused_rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, grad_out):
        x, scale = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in (x, scale)]
            out = rmsnorm_ref(*ins, ctx.eps)
            dx, dscale = torch.autograd.grad(out, ins, grad_out)
        return dx, dscale, None
