"""Fused RMSNorm: the CUDA kernel's wrappers and the autograd Functions.

``fused_rmsnorm`` launches ``csrc/fused_rmsnorm.cu`` for CUDA tensors and
takes the plain version (:mod:`.ref`) for CPU tensors; there is no fallback
from one to the other.  ``fused_rmsnorm.launches`` counts kernel launches.
The raw wrapper records no backward and raises when grad mode is on and an
input requires grad; :class:`FusedRMSNorm` is its differentiable form (the
kernel forward, a plain recomputed backward, as the JAX package, which has
no backward kernel, differentiates the jnp norm).

A row whose columns lie on several ranks (the gated norm over ``d_inner``
under tensor parallelism) takes two more entries of the same kernel:
``rmsnorm_sumsq`` (each row's float32 sum of squares of the rank's
columns) and, after the caller sums that over the ranks,
``rmsnorm_apply`` (the scale-and-store from the summed statistic).  Each
has its plain twin in :mod:`.ref`, counts its own launches and launches
for CUDA tensors only; :class:`RMSNormSumsq` and :class:`RMSNormApply`
are their differentiable forms.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_rmsnorm.ref import (rmsnorm_apply_ref,
                                                   rmsnorm_ref,
                                                   rmsnorm_sumsq_ref)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


_ARGS = {"fused_rmsnorm_launch": [_P] * 3 + [_L, _I, _F, _I, _I, _P],
         "rmsnorm_sumsq_launch": [_P, _P, _L, _I, _I, _P],
         "rmsnorm_apply_launch": [_P] * 4 + [_L, _I, _I, _F, _I, _I, _P]}
_FN = {}


def _fn(entry: str = "fused_rmsnorm_launch"):
    """A C entry point, typed once (the decode steps call these wrappers
    some 80 times a step, so their host time counts)."""
    if entry not in _FN:
        f = getattr(_build.load("fused_rmsnorm"), entry)
        f.argtypes = _ARGS[entry]
        f.restype = _I
        _FN[entry] = f
    return _FN[entry]


def _check_rows(what: str, x, scale=None):
    """Raise unless ``x`` is a contiguous (T, d) tensor (and ``scale`` a
    contiguous (d,) tensor on its device)."""
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous (T, d) tensor, "
                         f"got {tuple(x.shape)} (contiguous="
                         f"{x.is_contiguous()})")
    if scale is not None and (scale.device != x.device
                              or tuple(scale.shape) != (x.shape[1],)
                              or not scale.is_contiguous()):
        raise ValueError(f"{what}: scale must be a contiguous "
                         f"({x.shape[1]},) tensor on {x.device}")


def fused_rmsnorm(x, scale, eps: float = 1e-5):
    """x: (T, d) float32 or bfloat16, contiguous; scale: (d,) float32 or
    bfloat16 -> (T, d) in x's dtype, accumulated in float32."""
    _build.refuse_grad("fused_rmsnorm", x, scale)
    if not x.is_cuda:
        return rmsnorm_ref(x, scale, eps)
    _check_rows("fused_rmsnorm", x, scale=scale)
    T, d = x.shape
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


def rmsnorm_sumsq(x):
    """x: (T, d) float32 or bfloat16, contiguous -> (T,) float32, each
    row's sum of squares accumulated in float32."""
    _build.refuse_grad("rmsnorm_sumsq", x)
    if not x.is_cuda:
        return rmsnorm_sumsq_ref(x)
    _check_rows("rmsnorm_sumsq", x)
    T, d = x.shape
    out = torch.empty((T,), dtype=torch.float32, device=x.device)
    fn = _fn("rmsnorm_sumsq_launch")
    with _build.COUNT_LOCK:
        err = fn(x.data_ptr(), out.data_ptr(), T, d,
                 _build.dtype_code(x.dtype),
                 torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "rmsnorm_sumsq")
        rmsnorm_sumsq.launches += 1
    return out


rmsnorm_sumsq.launches = 0


def rmsnorm_apply(x, sumsq, scale, d_full: int, eps: float = 1e-5):
    """x: (T, d) a rank's columns of rows of ``d_full`` columns, contiguous;
    sumsq: (T,) float32, the whole rows' sums of squares; scale: (d,) ->
    (T, d) in x's dtype: x * rsqrt(sumsq / d_full + eps) * scale."""
    _build.refuse_grad("rmsnorm_apply", x, sumsq, scale)
    if not x.is_cuda:
        return rmsnorm_apply_ref(x, sumsq, scale, d_full, eps)
    _check_rows("rmsnorm_apply", x, scale=scale)
    T, d = x.shape
    if (sumsq.device != x.device or sumsq.dtype != torch.float32
            or tuple(sumsq.shape) != (T,) or not sumsq.is_contiguous()
            or d_full < d):
        raise ValueError(f"rmsnorm_apply: sumsq must be a contiguous ({T},) "
                         f"float32 tensor on {x.device} and d_full {d_full} "
                         f"at least d {d}")
    out = torch.empty_like(x)
    fn = _fn("rmsnorm_apply_launch")
    with _build.COUNT_LOCK:
        err = fn(x.data_ptr(), sumsq.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), T, d, int(d_full), float(eps),
                 _build.dtype_code(x.dtype), _build.dtype_code(scale.dtype),
                 torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "rmsnorm_apply")
        rmsnorm_apply.launches += 1
    return out


rmsnorm_apply.launches = 0


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


class RMSNormSumsq(torch.autograd.Function):
    """Differentiable ``rmsnorm_sumsq``: the kernel forward; backward
    ``2 x g``."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return rmsnorm_sumsq(x)

    @staticmethod
    def backward(ctx, grad_out):
        x, = ctx.saved_tensors
        return (2.0 * x.float() * grad_out[:, None]).to(x.dtype)


class RMSNormApply(torch.autograd.Function):
    """Differentiable ``rmsnorm_apply``: ``RMSNormApply.apply(x, sumsq,
    scale, d_full, eps)``.  The forward launches the kernel (the plain
    twin on the CPU); the backward recomputes ``rmsnorm_apply_ref`` under
    grad mode, as :class:`FusedRMSNorm` does, so that the statistic's
    gradient reaches ``sumsq`` (and, through the cross-rank sum, every
    rank's columns)."""

    @staticmethod
    def forward(ctx, x, sumsq, scale, d_full, eps):
        ctx.d_full, ctx.eps = d_full, eps
        ctx.save_for_backward(x, sumsq, scale)
        return rmsnorm_apply(x, sumsq, scale, d_full, eps)

    @staticmethod
    def backward(ctx, grad_out):
        x, sumsq, scale = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in (x, sumsq, scale)]
            out = rmsnorm_apply_ref(*ins, ctx.d_full, ctx.eps)
            dx, ds, dscale = torch.autograd.grad(out, ins, grad_out)
        return dx, ds, dscale, None, None
