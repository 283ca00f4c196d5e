"""Plain PyTorch versions of the flash-attention kernels: chunked-prefill
attention over prefix KV, and full-sequence attention (causal or
bidirectional)."""
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
