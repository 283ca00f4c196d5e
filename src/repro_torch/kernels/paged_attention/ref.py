"""Plain PyTorch version of paged decode attention (block-table KV)."""
from __future__ import annotations

import torch


def gather_pages(cache, block_tables):
    """cache: (num_pages, page, KVH, d); tables: (B, max_pages)
    -> (B, max_pages*page, KVH, d)."""
    gathered = cache[block_tables.long()]      # (B, max_pages, page, KVH, d)
    B, n, p, KVH, d = gathered.shape
    return gathered.reshape(B, n * p, KVH, d)


def paged_attention_ref(q, k_cache, v_cache, block_tables, lengths):
    """q: (B, H, d); caches: (num_pages, page, KVH, d);
    block_tables: (B, max_pages) int32; lengths: (B,) int32 -> (B, H, d)."""
    B, H, d = q.shape
    KVH = k_cache.shape[2]
    G = H // KVH
    k = gather_pages(k_cache, block_tables).float()
    v = gather_pages(v_cache, block_tables).float()
    qg = q.reshape(B, KVH, G, d).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k) / (d ** 0.5)
    S = k.shape[1]
    valid = torch.arange(S, device=q.device)[None] < lengths.long()[:, None]
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", w, v)
    return o.reshape(B, H, d).to(q.dtype)
