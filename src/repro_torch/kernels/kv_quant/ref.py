"""Plain PyTorch versions of INT8 KV quantization (paper Eq. 8) and of the
quantized-KV paged decode attention."""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def kv_quantize_ref(x):
    """Channel-wise (last-dim kept) asymmetric INT8 quant of a KV tensor.
    x: (..., d) -> (q int8 (...,d), scale (...,1), zero (...,1)).
    ``torch.round`` rounds half to even, as ``jnp.round``.  255 is a 0-d
    tensor on x's device: PyTorch's CUDA kernels divide by a Python scalar
    as a multiply by its reciprocal, which is not the IEEE quotient the
    kernel (and the TPU) computes."""
    xf = x.float()
    mx = xf.amax(dim=-1, keepdim=True)
    mn = xf.amin(dim=-1, keepdim=True)
    lam = torch.clamp((mx - mn) / mx.new_full((), 255.0), min=1e-8)
    z = torch.round(-mn / lam)
    q = torch.clamp(torch.round(xf / lam + z), 0, 255) - 128
    return q.to(torch.int8), lam, z


def store_view(x):
    """``x`` (rank 1 to 5, last axis d) as the (L, N, O, H, d) view the
    store entry reads, without a copy: a rank-4 (L, O, H, d) tensor (a
    dense lane's stripe span, one tier page) is one block a layer,
    ``x.unsqueeze(1)``; (O, H, d), (T, d) and (d,) are one block."""
    if x.dim() == 5:
        return x
    if x.dim() == 4:
        return x.unsqueeze(1)
    if x.dim() == 3:
        return x[None, None]
    if x.dim() == 2:
        return x[None, None, :, None]
    if x.dim() == 1:
        return x.reshape(1, 1, 1, 1, -1)
    raise ValueError(f"a KV store of rank 1 to 5, got {tuple(x.shape)}")


def kv_quantize_store_ref(xs, pages=None, length=None):
    """The store entry in plain PyTorch: for each of ``xs`` (K and V),
    gather axis 1 of its :func:`store_view` through ``pages`` (a long
    tensor; all of it when None), zero the rows whose position ``i * O +
    o`` is at or past ``length`` (none when None), cast to float32 and
    :func:`kv_quantize_ref` the rows in (l, i, o, h) order.  Returns a
    ``(q, lam, z)`` triple a source."""
    out = []
    for x in xs:
        v = store_view(x)
        if pages is not None:
            v = v[:, pages]
        if length is not None:
            P, O = v.shape[1], v.shape[2]
            pos = torch.arange(P * O, device=v.device).reshape(1, P, O, 1, 1)
            v = torch.where(pos < length, v, torch.zeros_like(v))
        out.append(kv_quantize_ref(v.reshape(-1, v.shape[-1]).float()))
    return out


def kv_dequantize_ref(q, lam, z, dtype=torch.float32):
    return (lam * (q.float() + 128.0 - z)).to(dtype)


def paged_attention_q8_ref(q, kq, k_lam, k_z, vq, v_lam, v_z, block_tables,
                           lengths):
    """Quantized-pool oracle: dequantize the pages, then exact paged
    attention."""
    k = kv_dequantize_ref(kq, k_lam, k_z)
    v = kv_dequantize_ref(vq, v_lam, v_z)
    return paged_attention_ref(q, k, v, block_tables, lengths)
