"""Plain PyTorch versions of the flash-attention kernels: chunked-prefill
attention over prefix KV, full-sequence attention (causal or
bidirectional), and the split-KV partials and their merge."""
from __future__ import annotations

import torch


def flash_prefill_prefix_ref(q, k, v, start):
    """q: (B, H, C, d); k/v: (B, KVH, Smax, d); start: (B,) int32.
    Chunk queries at absolute positions ``start[b] + i`` attend stripe
    keys ``j <= start[b] + i``; returns (B, H, C, d)."""
    B, H, C, d = q.shape
    KVH, Smax = k.shape[1], k.shape[2]
    G = H // KVH
    qg = q.reshape(B, KVH, G, C, d).float()
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, k.float()) / (d ** 0.5)
    qpos = start.long()[:, None] + torch.arange(C, device=q.device)[None]
    mask = (torch.arange(Smax, device=q.device)[None, None]
            <= qpos[:, :, None])                            # (B, C, Smax)
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,bktd->bkgqd", w, v.float())
    return o.reshape(B, H, C, d).to(q.dtype)


def flash_prefill_prefix_partial_ref(q, k, v, start, lo: int, hi: int):
    """The state of ``flash_prefill_prefix_ref`` over keys ``[lo, hi)``
    only, as one split of the CUDA kernel holds it before the merge, in
    float32: per row the largest visible score ``m`` (-inf when the range
    shows the row nothing), ``l = sum exp(s - m)`` and ``acc = sum exp(s -
    m) v`` (with 0 for ``m`` when it is -inf).  Scores are ``q . k /
    sqrt(d)`` in natural-log units (the kernel keeps them in log2 units).
    Returns (m (B, H, C), l (B, H, C), acc (B, H, C, d))."""
    B, H, C, d = q.shape
    KVH = k.shape[1]
    G = H // KVH
    if not 0 <= lo < hi <= k.shape[2]:
        raise ValueError(f"key range [{lo}, {hi}) of {k.shape[2]}")
    qg = q.reshape(B, KVH, G, C, d).float()
    s = torch.einsum("bkgqd,bktd->bkgqt", qg,
                     k[:, :, lo:hi].float()) / (d ** 0.5)
    qpos = start.long()[:, None] + torch.arange(C, device=q.device)[None]
    kpos = torch.arange(lo, hi, device=q.device)
    mask = kpos[None, None] <= qpos[:, :, None]             # (B, C, hi-lo)
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    m = s.amax(-1)
    p = torch.exp(s - torch.where(m == float("-inf"), 0.0, m)[..., None])
    acc = torch.einsum("bkgqt,bktd->bkgqd", p, v[:, :, lo:hi].float())
    return (m.reshape(B, H, C), p.sum(-1).reshape(B, H, C),
            acc.reshape(B, H, C, d))


def merge_partials(parts, dtype=torch.float32):
    """Combines partials of disjoint key ranges (each ``(m, l, acc)`` as
    :func:`flash_prefill_prefix_partial_ref` gives) in list order, as the
    kernel's merge pass does: ``M = max m``, ``w = exp(m - M)`` (0 for a
    range that showed the row nothing), ``out = sum w acc / max(sum w l,
    1e-30)``, returned in ``dtype``."""
    ms = torch.stack([m for m, _, _ in parts])
    top = ms.amax(0)
    num = den = 0.0
    for m, l, acc in parts:
        w = torch.where(m == float("-inf"), 0.0, torch.exp(m - top))
        num = num + w[..., None] * acc
        den = den + w * l
    return (num / den.clamp_min(1e-30)[..., None]).to(dtype)


def flash_prefill_ref(q, k, v, *, causal: bool = True):
    """q: (B, H, S, d); k/v: (B, KVH, S, d) -> (B, H, S, d) in q's dtype,
    computed in float32; ``causal`` lets query i see keys ``j <= i``."""
    B, H, S, d = q.shape
    KVH = k.shape[1]
    G = H // KVH
    qg = q.reshape(B, KVH, G, S, d).float()
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, k.float()) / (d ** 0.5)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,bktd->bkgqd", w, v.float())
    return o.reshape(B, H, S, d).to(q.dtype)
