"""Composable model layers, attention-family subset: norms (RMSNorm through
the fused kernel), RoPE, GQA attention (full / chunked through the flash
kernel / decode), dense FFN.

Everything is a plain function over an explicit parameter dict, mirroring
``repro.models.layers`` so each function can be checked against its jnp
twin on the same inputs.  Initialisers draw from an explicit
``torch.Generator`` on the target device (no global RNG state).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_prefill import FlashPrefill
from repro_torch.kernels.fused_rmsnorm import (FusedRMSNorm, fused_rmsnorm,
                                               rmsnorm_ref)
from repro_torch.models.config import ArchConfig

# --------------------------------------------------------------------- init


def _dense_init(gen: torch.Generator, shape, scale=None,
                dtype=torch.float32, device=None):
    """Normal init scaled by 1/sqrt(fan_in) (embeddings pass 0.02), drawn
    in float32 on ``device`` then cast, as ``layers._dense_init``."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / (fan_in ** 0.5)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def init_norm(cfg: ArchConfig, dim: int, dtype, device=None):
    p = {"scale": torch.ones((dim,), dtype=dtype, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=dtype, device=device)
    return p


def apply_norm(cfg: ArchConfig, p, x, eps: float = 1e-5, *,
               use_kernel: bool = True):
    """RMSNorm or LayerNorm over the last axis, in float32, returned in x's
    dtype.  RMSNorm goes through the fused kernel (the CUDA kernel for a
    CUDA tensor, its plain version for a CPU tensor) over x viewed as
    (rows, d): through its autograd Function when grad mode is on and an
    input requires grad, else through the raw wrapper, which costs less
    host time per call (the decode steps); ``use_kernel=False`` takes the
    plain version on any device.  LayerNorm stays plain."""
    if cfg.norm_type != "layernorm":
        rows = x.reshape(-1, x.shape[-1]).contiguous()
        scale = p["scale"]
        if not use_kernel:
            y = rmsnorm_ref(rows, scale, eps)
        elif torch.is_grad_enabled() and (rows.requires_grad
                                          or scale.requires_grad):
            y = FusedRMSNorm.apply(rows, scale, eps)
        else:
            y = fused_rmsnorm(rows, scale, eps)
        return y.reshape(x.shape)
    xf = x.float()
    xf = xf - xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


# --------------------------------------------------------------------- RoPE

def rope_freqs(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x, positions, theta: float):
    """x: (..., S, hd) with matching positions (..., S) or (S,).  Split-
    halves rotation (not interleaved)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    angles = positions[..., None].float() * freqs            # (..., S, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention

def init_attention(cfg: ArchConfig, gen, dtype, device=None):
    D, H, KVH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    p = {
        "wq": _dense_init(gen, (D, H * hd), dtype=dtype, device=device),
        "wk": _dense_init(gen, (D, KVH * hd), dtype=dtype, device=device),
        "wv": _dense_init(gen, (D, KVH * hd), dtype=dtype, device=device),
        "wo": _dense_init(gen, (H * hd, D), dtype=dtype, device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((KVH * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((KVH * hd,), dtype=dtype, device=device)
    return p


def _project_qkv(cfg: ArchConfig, p, x, positions, rope: bool = True):
    B, S, _ = x.shape
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KVH, hd)
    v = v.reshape(B, S, KVH, hd)
    if rope:
        pos = positions[:, None, :]
        q = apply_rope(q.transpose(1, 2), pos, cfg.rope_theta).transpose(1, 2)
        k = apply_rope(k.transpose(1, 2), pos, cfg.rope_theta).transpose(1, 2)
    return q, k, v


def full_attention(cfg: ArchConfig, q, k, v, *, causal: bool,
                   q_positions=None, kv_positions=None):
    """Reference (materialized-scores) attention.  q:(B,S,H,hd)
    k/v:(B,T,KVH,hd)."""
    B, S, H, hd = q.shape
    T, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qg = q.reshape(B, S, KVH, G, hd)
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    if causal:
        dev = q.device
        qpos = (q_positions if q_positions is not None
                else torch.arange(S, device=dev)[None].expand(B, S))
        kpos = (kv_positions if kv_positions is not None
                else torch.arange(T, device=dev)[None].expand(B, T))
        mask = kpos[:, None, None, None, :] <= qpos[:, None, None, :, None]
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


def chunked_attention(cfg: ArchConfig, q, k, v, *, causal: bool,
                      q_chunk: int = 1024, kv_chunk: int = 1024,
                      use_kernel: bool = True):
    """Full-sequence attention without the S x T score matrix.
    q:(B,S,H,hd) k/v:(B,T,KVH,hd) -> (B,S,H,hd) in q's dtype.

    For CUDA tensors (and ``use_kernel``) it runs the flash kernel through
    :class:`FlashPrefill` over (B, H, S, hd) views (strided, no copy),
    which needs T == S.  Otherwise it is the plain online-softmax version
    of ``layers.chunked_attention``: query chunks, each walking the kv
    chunks with a running (max, sum, acc), queries padded to a chunk
    multiple and padded keys masked by the original T.  The chunk sizes
    only shape the plain version; the kernel tiles by itself."""
    if use_kernel and q.is_cuda:
        out = FlashPrefill.apply(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal)
        return out.transpose(1, 2)
    B, S, H, hd = q.shape
    T, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    q_chunk, kv_chunk = min(q_chunk, S), min(kv_chunk, T)
    S_orig, T_orig = S, T
    if S % q_chunk:                      # pad queries to a chunk multiple
        q = F.pad(q, (0, 0, 0, 0, 0, -S % q_chunk))
        S = q.shape[1]
    if T % kv_chunk:                     # pad keys/values; masked out below
        k = F.pad(k, (0, 0, 0, 0, 0, -T % kv_chunk))
        v = F.pad(v, (0, 0, 0, 0, 0, -T % kv_chunk))
        T = k.shape[1]
    nq, nk = S // q_chunk, T // kv_chunk
    scale = 1.0 / (hd ** 0.5)
    dev = q.device
    qg = q.reshape(B, nq, q_chunk, KVH, G, hd).permute(1, 0, 3, 4, 2, 5)
    kc = k.reshape(B, nk, kv_chunk, KVH, hd).permute(1, 0, 3, 2, 4)
    vc = v.reshape(B, nk, kv_chunk, KVH, hd).permute(1, 0, 3, 2, 4)
    outs = []
    for qi in range(nq):                 # (B, KVH, G, Cq, hd) per chunk
        qb = qg[qi].float()
        m = torch.full((B, KVH, G, q_chunk), float("-inf"), device=dev)
        lsum = torch.zeros((B, KVH, G, q_chunk), device=dev)
        acc = torch.zeros((B, KVH, G, q_chunk, hd), device=dev)
        qpos = qi * q_chunk + torch.arange(q_chunk, device=dev)
        for kj in range(nk):
            s = torch.einsum("bkgqd,bkcd->bkgqc", qb, kc[kj].float()) * scale
            kpos = kj * kv_chunk + torch.arange(kv_chunk, device=dev)
            ok = (kpos < T_orig)[None, :]                 # mask kv padding
            if causal:
                ok = ok & (kpos[None, :] <= qpos[:, None])
            s = torch.where(ok, s, torch.full_like(s, -1e30))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            lsum = lsum * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqc,bkcd->bkgqd", p, vc[kj].float())
            m = m_new
        outs.append(acc / torch.clamp(lsum, min=1e-30)[..., None])
    # (nq, B, KVH, G, Cq, hd) -> (B, S, H, hd)
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, S, H, hd)
    return out[:, :S_orig].to(q.dtype)


def decode_attention(cfg: ArchConfig, q, k_cache, v_cache, lengths):
    """Single-token decode.  q:(B,H,hd), caches:(B,Smax,KVH,hd), lengths:(B,)
    = number of valid cached tokens (including the token just written)."""
    B, H, hd = q.shape
    Smax, KVH = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    qg = q.reshape(B, KVH, G, hd)
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) * scale
    valid = (torch.arange(Smax, device=q.device)[None, :]
             < lengths.long()[:, None])                         # (B, Smax)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", w, v_cache.float())
    return o.reshape(B, H, hd).to(q.dtype)


# --------------------------------------------------------------------- FFN

def init_ffn(cfg: ArchConfig, gen, dtype, device=None):
    D, Fd = cfg.d_model, cfg.d_ff
    p = {"wi": _dense_init(gen, (D, Fd), dtype=dtype, device=device),
         "wo": _dense_init(gen, (Fd, D), dtype=dtype, device=device)}
    if cfg.act == "swiglu":
        p["wg"] = _dense_init(gen, (D, Fd), dtype=dtype, device=device)
    return p


def _act(cfg: ArchConfig, h, g=None):
    if cfg.act == "swiglu":
        return F.silu(g) * h
    if cfg.act == "gelu":
        return F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    return F.relu(h)


def apply_ffn(cfg: ArchConfig, p, x):
    h = x @ p["wi"]
    g = x @ p["wg"] if cfg.act == "swiglu" else None
    return _act(cfg, h, g) @ p["wo"]
