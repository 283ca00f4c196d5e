"""Flash attention: the CUDA kernels' wrappers and the autograd Function.

``flash_prefill_prefix`` (chunked prefill over prefix KV) and
``flash_prefill`` (full sequence, causal or bidirectional) launch the two
entry points of ``csrc/flash_prefill_prefix.cu`` for CUDA tensors and take
the plain versions (:mod:`.ref`) for CPU tensors; there is no fallback
from one to the other.  The kernels read strided views (only the last
axis must be contiguous), so callers may pass transposed tensors without
a copy.  Each wrapper's ``launches`` attribute counts its kernel launches.

The raw wrappers record no backward and raise when grad mode is on and an
input requires grad.  :class:`FlashPrefill` is the differentiable form of
``flash_prefill``: its forward launches the kernel, its backward recomputes
the plain version and differentiates it.  The JAX package has no backward
kernel either (``jax.grad`` differentiates the jnp attention), so a
hand-written backward is later work.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill.ref import (flash_prefill_prefix_ref,
                                                   flash_prefill_ref)

_P, _I = ctypes.c_void_p, ctypes.c_int
_Strides = ctypes.c_longlong * 3

# the head dims the kernels are built for (csrc/flash_prefill_prefix.cu)
HEAD_DIMS = (64, 128)


def _fn():
    f = _build.load("flash_prefill_prefix").flash_prefill_prefix_launch
    f.argtypes = [_P] * 9 + [_I] * 7 + [_P]
    f.restype = _I
    return f


def _full_fn():
    f = _build.load("flash_prefill_prefix").flash_prefill_launch
    f.argtypes = [_P] * 8 + [_I] * 7 + [_P]
    f.restype = _I
    return f


def _strides(t):
    return _Strides(t.stride(0), t.stride(1), t.stride(2))


def _check_qkv(what, q, k, v):
    """The checks both kernels share: devices, dtypes, head dim, GQA
    grouping, a contiguous last axis."""
    B, H, _, d = q.shape
    KVH = k.shape[1]
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{what}: {name} on {t.device}, q on {q.device}")
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != d
            or H % KVH):
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{what} kernel takes d in {HEAD_DIMS}, got {d}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k and v must share a dtype")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{what}: {name}'s last axis must be contiguous")


def flash_prefill_prefix(q, k, v, start):
    """q: (B, H, C, d) chunk queries; k/v: (B, KVH, Smax, d) per-request
    stripes with positions ``[0, start[b] + C)`` materialized; start: (B,)
    int32 absolute position of each chunk's first query -> (B, H, C, d)."""
    _build.refuse_grad("flash_prefill_prefix", q, k, v)
    if not q.is_cuda:
        return flash_prefill_prefix_ref(q, k, v, start)
    _check_qkv("flash_prefill_prefix", q, k, v)
    B, H, C, d = q.shape
    KVH, Smax = k.shape[1], k.shape[2]
    if start.device != q.device or tuple(start.shape) != (B,):
        raise ValueError(f"flash_prefill_prefix: start {tuple(start.shape)} "
                         f"on {start.device}, want ({B},) on {q.device}")
    if start.dtype != torch.int32 or not start.is_contiguous():
        raise TypeError("flash_prefill_prefix: start must be contiguous int32")
    out = torch.empty((B, H, C, d), dtype=q.dtype, device=q.device)
    qs, ks, vs, os_ = _strides(q), _strides(k), _strides(v), _strides(out)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), start.data_ptr(),
                out.data_ptr(), ctypes.addressof(qs), ctypes.addressof(ks),
                ctypes.addressof(vs), ctypes.addressof(os_), B, H, KVH, C,
                Smax, d, _build.dtype_code(q.dtype),
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_prefill_prefix")
    flash_prefill_prefix.launches += 1
    return out


flash_prefill_prefix.launches = 0


def flash_prefill(q, k, v, *, causal: bool = True):
    """q: (B, H, S, d); k/v: (B, KVH, S, d), any S, d in ``HEAD_DIMS`` on
    the card, float32 or bfloat16 -> (B, H, S, d) in q's dtype, accumulated
    in float32.  ``causal`` lets query i see keys ``j <= i``; otherwise
    every key is visible."""
    _build.refuse_grad("flash_prefill", q, k, v)
    if not q.is_cuda:
        return flash_prefill_ref(q, k, v, causal=causal)
    _check_qkv("flash_prefill", q, k, v)
    B, H, S, d = q.shape
    KVH = k.shape[1]
    if k.shape[2] != S:
        raise ValueError(f"flash_prefill: q has {S} positions, k/v "
                         f"{k.shape[2]}")
    out = torch.empty((B, H, S, d), dtype=q.dtype, device=q.device)
    qs, ks, vs, os_ = _strides(q), _strides(k), _strides(v), _strides(out)
    err = _full_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     ctypes.addressof(qs), ctypes.addressof(ks),
                     ctypes.addressof(vs), ctypes.addressof(os_), B, H, KVH,
                     S, d, int(bool(causal)), _build.dtype_code(q.dtype),
                     torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0


class FlashPrefill(torch.autograd.Function):
    """Differentiable ``flash_prefill``: ``FlashPrefill.apply(q, k, v,
    causal)``.  The forward launches the kernel (the plain version on the
    CPU) and saves q, k, v; the backward recomputes ``flash_prefill_ref``
    under grad mode and returns its gradients.  The recompute materializes
    the (S, S) scores of every head, as the plain version does."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return flash_prefill(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad(), torch.profiler.record_function(
                "flash_prefill.backward_plain"):
            ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = flash_prefill_ref(*ins, causal=ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, ins, grad_out)
        return dq, dk, dv, None
