"""Paged decode attention: the CUDA kernel's wrapper.

``paged_attention`` launches ``csrc/paged_attention.cu`` for CUDA tensors
and takes the plain version (:mod:`.ref`) for CPU tensors; there is no
fallback from one to the other.  ``paged_attention.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

_P, _I = ctypes.c_void_p, ctypes.c_int


def _fn():
    f = _build.load("paged_attention").paged_attention_launch
    f.argtypes = [_P] * 6 + [_I] * 9 + [_P]
    f.restype = _I
    return f


def paged_attention(q, k_cache, v_cache, block_tables, lengths):
    """q: (B, H, d); caches: (num_pages, page, KVH, d); block_tables:
    (B, max_pages) int32; lengths: (B,) int32 valid tokens per row
    (including the token just written) -> (B, H, d) in q's dtype."""
    if not q.is_cuda:
        return paged_attention_ref(q, k_cache, v_cache, block_tables, lengths)
    B, H, d = q.shape
    num_pages, page, KVH, dk = k_cache.shape
    max_pages = block_tables.shape[1]
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"paged_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("paged_attention: q must be contiguous")
    if (v_cache.shape != k_cache.shape or dk != d or H % KVH
            or block_tables.shape[0] != B or tuple(lengths.shape) != (B,)):
        raise ValueError(
            f"paged_attention: shapes q {tuple(q.shape)}, k/v "
            f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}, tables "
            f"{tuple(block_tables.shape)}, lengths {tuple(lengths.shape)}")
    if H // KVH > 8 or d > 256 or page > 64:
        raise ValueError(f"paged_attention kernel takes G <= 8, d <= 256, "
                         f"page <= 64 (got G={H // KVH}, d={d}, page={page})")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attention: block_tables and lengths must be "
                        "int32")
    if v_cache.dtype != k_cache.dtype:
        raise TypeError("paged_attention: k and v caches differ in dtype")
    out = torch.empty_like(q)
    err = _fn()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                B, H, KVH, d, page, num_pages, max_pages,
                _build.dtype_code(q.dtype), _build.dtype_code(k_cache.dtype),
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
