"""INT8 KV quantize / dequantize and decode attention over INT8 pages: the
CUDA kernels' wrappers.

``kv_quantize`` / ``kv_dequantize`` launch ``csrc/kv_quant.cu`` and
``paged_attention_q8`` launches the int8 entry of
``csrc/paged_attention.cu`` (the split-KV body of ``paged_attention``, its
plan and its scratch) for CUDA tensors; each takes its plain version
(:mod:`.ref`) for CPU tensors; there is no fallback from one to the other.
Each wrapper's ``launches`` attribute counts its kernel launches;
:func:`body_launches` counts ``kv_dequantize``'s two bodies (the kernel
chooses from d and the addresses: csrc/kv_quant.cu).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ops import check_shape, split
from repro_torch.kernels.kv_quant.ref import (kv_dequantize_ref,
                                              kv_quantize_ref,
                                              paged_attention_q8_ref)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib():
    lib = _build.load("kv_quant")
    lib.kv_quantize_launch.argtypes = [_P] * 4 + [_L, _I, _P]
    lib.kv_quantize_launch.restype = _I
    lib.kv_dequantize_launch.argtypes = [_P] * 4 + [_L, _I, _I, _P]
    lib.kv_dequantize_launch.restype = _I
    lib.kv_quant_body_launches.argtypes = [_P]
    lib.kv_quant_body_launches.restype = _I
    return lib


DEQUANTIZE_BODIES = ("vec16", "scalar")
# launches of each body by replayed CUDA graphs (kernels/counters.py)
REPLAYED = dict.fromkeys(DEQUANTIZE_BODIES, 0)


def body_launches():
    """Launches of ``kv_dequantize``'s bodies since the library was
    loaded: ``{"vec16": n, "scalar": n}`` (16 codes a thread with 16-byte
    loads and stores, for d a multiple of 16 up to 1024 and 16-byte
    aligned codes and output; one element a thread otherwise).
    A replayed CUDA graph's launches are in it too (``REPLAYED``, which
    ``kernels/counters.py`` advances)."""
    got = (ctypes.c_longlong * len(DEQUANTIZE_BODIES))()
    with _build.COUNT_LOCK:
        _lib().kv_quant_body_launches(ctypes.addressof(got))
        return {k: n + REPLAYED[k] for k, n in zip(DEQUANTIZE_BODIES, got)}


def kv_quantize(x):
    """x: (T, d) float32 -> (q int8 (T, d), lam (T, 1), z (T, 1)) float32;
    rows are (token, head) vectors (flatten any leading dims first)."""
    _build.refuse_grad("kv_quantize", x)
    if not x.is_cuda:
        return kv_quantize_ref(x)
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"kv_quantize takes a contiguous float32 (T, d) "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    T, d = x.shape
    q = torch.empty((T, d), dtype=torch.int8, device=x.device)
    lam = torch.empty((T, 1), dtype=torch.float32, device=x.device)
    z = torch.empty((T, 1), dtype=torch.float32, device=x.device)
    fn = _lib().kv_quantize_launch
    with _build.COUNT_LOCK:
        err = fn(
            x.data_ptr(), q.data_ptr(), lam.data_ptr(), z.data_ptr(), T, d,
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "kv_quantize")
        kv_quantize.launches += 1
    return q, lam, z


def kv_dequantize(q, lam, z, dtype=torch.float32):
    """Inverse of :func:`kv_quantize`: ``lam * (q + 128 - z)`` as dtype
    (float32 or bfloat16)."""
    _build.refuse_grad("kv_dequantize", lam, z)
    if not q.is_cuda:
        return kv_dequantize_ref(q, lam, z, dtype)
    if q.dim() != 2 or q.dtype != torch.int8 or not q.is_contiguous():
        raise ValueError(f"kv_dequantize takes contiguous int8 (T, d) codes, "
                         f"got {q.dtype} {tuple(q.shape)}")
    T, d = q.shape
    for name, t in (("lam", lam), ("z", z)):
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != (T, 1) or not t.is_contiguous()):
            raise ValueError(f"kv_dequantize: {name} must be contiguous "
                             f"float32 (T, 1) on {q.device}")
    code = _build.dtype_code(dtype)
    x = torch.empty((T, d), dtype=dtype, device=q.device)
    fn = _lib().kv_dequantize_launch
    with _build.COUNT_LOCK:
        err = fn(
            q.data_ptr(), lam.data_ptr(), z.data_ptr(), x.data_ptr(), T, d,
            code, torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(err, "kv_dequantize")
        kv_dequantize.launches += 1
    return x


def _q8_fn():
    f = _build.load("paged_attention").paged_attention_q8_launch
    f.argtypes = [_P] * 11 + [_I] * 9 + [_P]
    f.restype = _I
    return f


def paged_attention_q8(q, kq, k_lam, k_z, vq, v_lam, v_z, block_tables,
                       lengths):
    """Decode attention over an INT8 page pool, dequantized in the kernel.

    q: (B, H, d) float32 or bfloat16; kq/vq: (num_pages, page, KVH, d)
    int8; k_lam/k_z/v_lam/v_z: (num_pages, page, KVH, 1) float32, one
    (scale, zero) pair per (token, head) row; block_tables: (B, max_pages)
    int32; lengths: (B,) int32 >= 1, valid tokens per row -> (B, H, d) in
    q's dtype.  Table entries past a row's length are never read."""
    _build.refuse_grad("paged_attention_q8", q, k_lam, k_z, v_lam, v_z)
    if not q.is_cuda:
        return paged_attention_q8_ref(q, kq, k_lam, k_z, vq, v_lam, v_z,
                                      block_tables, lengths)
    B, H, d = q.shape
    num_pages, page, KVH, dk = kq.shape
    max_pages = block_tables.shape[1]
    named = (("q", q), ("kq", kq), ("k_lam", k_lam), ("k_z", k_z),
             ("vq", vq), ("v_lam", v_lam), ("v_z", v_z),
             ("block_tables", block_tables), ("lengths", lengths))
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"paged_attention_q8: {name} on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention_q8: {name} must be "
                             "contiguous")
    rows = (num_pages, page, KVH, 1)
    if (vq.shape != kq.shape or dk != d or H % KVH
            or any(tuple(t.shape) != rows for t in (k_lam, k_z, v_lam, v_z))
            or block_tables.shape[0] != B or tuple(lengths.shape) != (B,)):
        raise ValueError(
            f"paged_attention_q8: shapes q {tuple(q.shape)}, codes "
            f"{tuple(kq.shape)}/{tuple(vq.shape)}, scales "
            f"{[tuple(t.shape) for t in (k_lam, k_z, v_lam, v_z)]}, tables "
            f"{tuple(block_tables.shape)}, lengths {tuple(lengths.shape)}")
    check_shape("paged_attention_q8", H // KVH, d, page, 16)
    if kq.dtype != torch.int8 or vq.dtype != torch.int8:
        raise TypeError("paged_attention_q8: codes must be int8")
    if any(t.dtype != torch.float32 for t in (k_lam, k_z, v_lam, v_z)):
        raise TypeError("paged_attention_q8: scales and zeros must be "
                        "float32")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attention_q8: block_tables and lengths must "
                        "be int32")
    if any(t.data_ptr() % 16 for t in (kq, vq)):
        raise ValueError("paged_attention_q8: the codes must start on a "
                         "16-byte boundary")
    out = torch.empty_like(q)
    scratch, nsplit = split(q, B, KVH, d, page, max_pages)
    fn = _q8_fn()
    with _build.COUNT_LOCK:
        err = fn(q.data_ptr(), kq.data_ptr(), k_lam.data_ptr(),
                 k_z.data_ptr(), vq.data_ptr(), v_lam.data_ptr(),
                 v_z.data_ptr(), block_tables.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), nsplit,
                 B, H, KVH, d, page,
                 num_pages, max_pages, _build.dtype_code(q.dtype),
                 torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(err, "paged_attention_q8")
        paged_attention_q8.launches += 1
    return out


kv_quantize.launches = 0
kv_dequantize.launches = 0
paged_attention_q8.launches = 0
