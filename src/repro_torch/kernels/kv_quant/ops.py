"""INT8 KV quantize / dequantize: the CUDA kernels' wrappers.

``kv_quantize`` / ``kv_dequantize`` launch ``csrc/kv_quant.cu`` for CUDA
tensors and take the plain versions (:mod:`.ref`) for CPU tensors; there
is no fallback from one to the other.  Each wrapper's ``launches``
attribute counts its kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kv_quant.ref import kv_dequantize_ref, kv_quantize_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib():
    lib = _build.load("kv_quant")
    lib.kv_quantize_launch.argtypes = [_P] * 4 + [_L, _I, _P]
    lib.kv_quantize_launch.restype = _I
    lib.kv_dequantize_launch.argtypes = [_P] * 4 + [_L, _I, _I, _P]
    lib.kv_dequantize_launch.restype = _I
    return lib


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
    err = _lib().kv_quantize_launch(
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
    err = _lib().kv_dequantize_launch(
        q.data_ptr(), lam.data_ptr(), z.data_ptr(), x.data_ptr(), T, d,
        code, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "kv_dequantize")
    kv_dequantize.launches += 1
    return x


kv_quantize.launches = 0
kv_dequantize.launches = 0
