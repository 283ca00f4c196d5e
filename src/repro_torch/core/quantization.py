"""KV-cache quantization (paper Eq. 8): channel-wise b-bit integer
quantization, and KV sizing for the memory manager.

The paper stores preempted jobs' KV caches as INT8 and dequantizes back to
the compute dtype on resume.  The standard asymmetric affine scheme:

    x_q = round(x / lam + z),      x_hat = lam * (x_q - z)
    lam = (max - min) / (2^b - 1), z   = round(-min / lam)

(the paper's printed zero-point formula ``z = round(-2^b/(max-min))`` is
dimensionally a typo for the standard form above).  Statistics are taken
per channel (the last axis by default), which keeps attention quality
acceptable for K tensors.

:func:`quantize` / :func:`dequantize` are the torch rewrite of the JAX
package's, :func:`quantize_np` / :func:`dequantize_np` its numpy twins
(copied), :func:`roundtrip_rel_error` the round trip's relative error.
The serving engine quantizes swapped KV per (token, head) row on the
device through the ``kv_quant`` kernels instead
(``serving/kv_cache.quantize_kv_device``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class QuantizedTensor:
    q: torch.Tensor       # int8/int4-in-int8 codes
    scale: torch.Tensor   # lam, broadcastable to x
    zero: torch.Tensor    # z, same shape as scale
    bits: int

    @property
    def nbytes(self) -> int:
        return ((self.q.numel() * self.bits) // 8 + self.scale.numel() * 4
                + self.zero.numel() * 4)


def quantize(x: torch.Tensor, bits: int = 8, axis: int = -1
             ) -> QuantizedTensor:
    """Channel-wise asymmetric quantization along ``axis`` (kept per
    channel)."""
    xf = x.float()
    reduce_axes = tuple(i for i in range(x.ndim) if i != (axis % x.ndim))
    mx = xf.amax(dim=reduce_axes, keepdim=True)
    mn = xf.amin(dim=reduce_axes, keepdim=True)
    qmax = 2.0 ** bits - 1.0
    lam = torch.clamp((mx - mn) / qmax, min=1e-8)
    z = torch.round(-mn / lam)
    q = torch.clamp(torch.round(xf / lam + z), 0, qmax)
    # int8 holds [0, 255] as unsigned by offsetting into the signed range
    q = (q - 128).to(torch.int8) if bits == 8 else q.to(
        torch.int8 if bits <= 8 else torch.int32)
    return QuantizedTensor(q=q, scale=lam, zero=z, bits=bits)


def dequantize(qt: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    q = qt.q.float()
    if qt.bits == 8:
        q = q + 128.0
    return (qt.scale * (q - qt.zero)).to(dtype)


def quantize_np(x: np.ndarray, bits: int = 8, axis: int = -1):
    """Numpy twin used for host-side (DRAM tier) storage."""
    xf = x.astype(np.float32)
    reduce_axes = tuple(i for i in range(x.ndim) if i != (axis % x.ndim))
    mx = xf.max(axis=reduce_axes, keepdims=True)
    mn = xf.min(axis=reduce_axes, keepdims=True)
    qmax = 2.0 ** bits - 1.0
    lam = np.maximum((mx - mn) / qmax, 1e-8)
    z = np.round(-mn / lam)
    q = np.clip(np.round(xf / lam + z), 0, qmax)
    q8 = (q - 128).astype(np.int8) if bits == 8 else q.astype(np.int32)
    return q8, lam, z


def dequantize_np(q8: np.ndarray, lam: np.ndarray, z: np.ndarray,
                  bits: int = 8, dtype=np.float32) -> np.ndarray:
    q = q8.astype(np.float32)
    if bits == 8:
        q = q + 128.0
    return (lam * (q - z)).astype(dtype)


def roundtrip_rel_error(x: torch.Tensor, bits: int = 8,
                        axis: int = -1) -> float:
    qt = quantize(x, bits=bits, axis=axis)
    xh = dequantize(qt, dtype=torch.float32)
    num = (xh - x.float()).abs().max()
    den = torch.clamp(x.float().abs().max(), min=1e-9)
    return float(num / den)


def kv_bytes_per_token(num_layers: int, num_kv_heads: int, head_dim: int,
                       quantized: bool = False) -> int:
    """Bytes of KV per token: 2 (K,V) x layers x heads x dim x dtype bytes."""
    per = 2 * num_layers * num_kv_heads * head_dim
    return per * (1 if quantized else 2)   # int8 vs bf16
