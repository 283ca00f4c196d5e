"""Chunked-prefill flash attention over prefix KV: the CUDA kernel's
wrapper.

``flash_prefill_prefix`` launches ``csrc/flash_prefill_prefix.cu`` for
CUDA tensors and takes the plain version (:mod:`.ref`) for CPU tensors;
there is no fallback from one to the other.  The kernel reads strided
views (only the last axis must be contiguous), so callers may pass
transposed tensors without a copy.  ``flash_prefill_prefix.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill.ref import flash_prefill_prefix_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_Strides = ctypes.c_longlong * 3


def _fn():
    f = _build.load("flash_prefill_prefix").flash_prefill_prefix_launch
    f.argtypes = [_P] * 9 + [_I] * 7 + [_P]
    f.restype = _I
    return f


def flash_prefill_prefix(q, k, v, start):
    """q: (B, H, C, d) chunk queries; k/v: (B, KVH, Smax, d) per-request
    stripes with positions ``[0, start[b] + C)`` materialized; start: (B,)
    int32 absolute position of each chunk's first query -> (B, H, C, d)."""
    if not q.is_cuda:
        return flash_prefill_prefix_ref(q, k, v, start)
    B, H, C, d = q.shape
    KVH, Smax = k.shape[1], k.shape[2]
    for name, t in (("k", k), ("v", v), ("start", start)):
        if t.device != q.device:
            raise ValueError(f"flash_prefill_prefix: {name} on {t.device}, "
                             f"q on {q.device}")
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != d
            or H % KVH or tuple(start.shape) != (B,)):
        raise ValueError(
            f"flash_prefill_prefix: shapes q {tuple(q.shape)}, k/v "
            f"{tuple(k.shape)}/{tuple(v.shape)}, start {tuple(start.shape)}")
    if d not in (64, 128):
        raise ValueError(f"flash_prefill_prefix kernel takes d 64 or 128, "
                         f"got {d}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_prefill_prefix: q, k and v must share a dtype")
    if start.dtype != torch.int32 or not start.is_contiguous():
        raise TypeError("flash_prefill_prefix: start must be contiguous int32")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_prefill_prefix: {name}'s last axis must "
                             "be contiguous")
    out = torch.empty((B, H, C, d), dtype=q.dtype, device=q.device)

    def strides(t):
        return _Strides(t.stride(0), t.stride(1), t.stride(2))

    qs, ks, vs, os_ = strides(q), strides(k), strides(v), strides(out)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), start.data_ptr(),
                out.data_ptr(), ctypes.addressof(qs), ctypes.addressof(ks),
                ctypes.addressof(vs), ctypes.addressof(os_), B, H, KVH, C,
                Smax, d, _build.dtype_code(q.dtype),
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_prefill_prefix")
    flash_prefill_prefix.launches += 1
    return out


flash_prefill_prefix.launches = 0
