"""The paged KV page pool and the paged KV backend of the serving engine.

Two layers live here, as in ``repro.serving.kv_cache``:

  * :class:`PagedKVPool` — the vLLM-style block allocator (physical pages +
    refcounted per-request page tables) ALISE's request-level swapping
    sits on.  The pool tensors live on the device and are written **in
    place** (``index_put_`` / ``index_copy_``) where the JAX package
    rebuilt them functionally.
  * :class:`PagedKVBackend` — the engine-facing device KV residency:
    decode-lane (slot) assignment, resumable chunked prefill into pages,
    request-granular offload/upload blobs, and ``decode()`` — one fused
    step per iteration that samples and decides termination on the device
    (one small ``(tokens, reasons)`` copy to the host).

Offload/upload run the INT8 ``kv_quant`` kernels on the device when
``quantize_offload`` is set (paper Eq. 8): the host link carries the INT8
payload plus float32 per-row scales and zeros.

Not ported yet (a config that asks for one raises ``NotImplementedError``
naming its ``ROADMAP.md`` item): the dense backend, packed prefill, the
shared-prefix cache, the cluster KV tier and speculative decoding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.kv_quant import kv_dequantize, kv_quantize
from repro_torch.utils import dtype_of


# --------------------------------------------------------------- page pool

@dataclass
class PagedKVConfig:
    num_pages: int = 256
    page_size: int = 16
    num_kv_heads: int = 8
    head_dim: int = 64
    num_layers: int = 4
    dtype: str = "float32"


class PagedKVPool:
    """Physical page pool + per-request page tables (one layer set each).

    Pages are refcounted: every table entry holds one reference and a page
    returns to the free list when its count reaches zero.  ``k``/``v`` are
    device tensors (L, num_pages, page, KVH, d) updated in place.
    """

    def __init__(self, cfg: PagedKVConfig, device=None):
        self.cfg = cfg
        shape = (cfg.num_layers, cfg.num_pages, cfg.page_size,
                 cfg.num_kv_heads, cfg.head_dim)
        dt = dtype_of(cfg.dtype)
        self.k = torch.zeros(shape, dtype=dt, device=device)
        self.v = torch.zeros(shape, dtype=dt, device=device)
        self.free_pages: List[int] = list(range(cfg.num_pages))
        self.page_table: Dict[int, List[int]] = {}       # req -> pages
        self.lengths: Dict[int, int] = {}
        self.refs: Dict[int, int] = {}                   # page -> refcount

    # ----------------------------------------------------------- refcounts
    def take_page(self) -> int:
        """Claim one free page (refcount 1)."""
        page = self.free_pages.pop()
        self.refs[page] = 1
        return page

    def decref(self, page: int) -> int:
        """Drop one reference; a page at zero returns to the free list."""
        n = self.refs.get(page, 0) - 1
        if n <= 0:
            self.refs.pop(page, None)
            self.free_pages.append(page)
            return 0
        self.refs[page] = n
        return n

    # ------------------------------------------------------------ allocator
    def pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.cfg.page_size)

    def allocate(self, req_id: int, tokens: int) -> List[int]:
        n = self.pages_needed(tokens)
        if len(self.free_pages) < n:
            raise RuntimeError(
                f"page pool exhausted: need {n}, free {len(self.free_pages)}")
        pages = [self.take_page() for _ in range(n)]
        self.page_table[req_id] = pages
        self.lengths[req_id] = tokens
        return pages

    def extend(self, req_id: int, new_tokens: int = 1) -> Optional[int]:
        """Grow a sequence; returns a newly-allocated page id or None."""
        length = self.lengths[req_id] + new_tokens
        need = self.pages_needed(length)
        new_page = None
        if need > len(self.page_table[req_id]):
            if not self.free_pages:
                raise RuntimeError("page pool exhausted on extend")
            new_page = self.take_page()
            self.page_table[req_id].append(new_page)
        self.lengths[req_id] = length
        return new_page

    def extend_to(self, req_id: int, tokens: int) -> None:
        """Grow a sequence to cover ``tokens`` logical positions (chunked
        prefill may end mid-page; the next chunk continues inside it)."""
        pages = self.page_table[req_id]
        need = self.pages_needed(tokens)
        while len(pages) < need:
            if not self.free_pages:
                raise RuntimeError("page pool exhausted on extend_to")
            pages.append(self.take_page())
        self.lengths[req_id] = max(self.lengths.get(req_id, 0), tokens)

    def reserve_scratch(self) -> int:
        """Permanently remove one physical page from the allocator — the
        sacrificial write target for inactive decode lanes and padded
        chunk rows, and the filler of unused block-table entries."""
        return self.take_page()

    def free(self, req_id: int) -> None:
        for page in self.page_table.pop(req_id, []):
            self.decref(page)
        self.lengths.pop(req_id, None)

    def block_table_array(self, req_ids: List[int], device=None) -> tuple:
        """(tables (B, max_pages) int32, lengths (B,) int32) padded."""
        max_pages = max((len(self.page_table[r]) for r in req_ids), default=1)
        tables = np.zeros((len(req_ids), max_pages), np.int32)
        lens = np.zeros((len(req_ids),), np.int32)
        for i, r in enumerate(req_ids):
            pages = self.page_table[r]
            tables[i, :len(pages)] = pages
            lens[i] = self.lengths[r]
        dev = device if device is not None else self.k.device
        return (torch.from_numpy(tables).to(dev),
                torch.from_numpy(lens).to(dev))


# ------------------------------------------------- device-side quant blobs

def quantize_kv_device(x) -> tuple:
    """INT8-quantize a KV tensor of any rank on its device (one row per
    (token, head) over the last axis) with the ``kv_quantize`` kernel, and
    move the INT8 payload plus float32 scales/zeros to the host.  The input
    is quantized as a float32 copy.  Returns ``(q, lam, z, shape)`` with
    CPU tensors ``q`` (rows, d) int8 and ``lam``/``z`` (rows, 1)."""
    shape = tuple(x.shape)
    flat = x.reshape(-1, shape[-1]).float().contiguous()
    q, lam, z = kv_quantize(flat)
    return q.cpu(), lam.cpu(), z.cpu(), shape


def dequantize_kv_device(blob: tuple, dtype=torch.float32, device=None):
    """Inverse of :func:`quantize_kv_device`: upload the INT8 payload and
    scales, run the ``kv_dequantize`` kernel on ``device``, reshape."""
    q, lam, z, shape = blob
    x = kv_dequantize(q.to(device), lam.to(device), z.to(device), dtype=dtype)
    return x.reshape(shape)


# ---------------------------------------------------------------- backends

@dataclass
class KVBackendConfig:
    """Static knobs the backend needs for its fused decode step."""
    max_slots: int
    max_seq_len: int
    eos_token: int = 1
    max_new_tokens: int = 128
    greedy: bool = True
    temperature: float = 1.0
    top_k: int = 0
    quantize_offload: bool = True
    page_size: int = 16
    attn_impl: str = "gather"      # paged decode attention: gather | kernel
    seed: int = 0
    prefill_buckets: Optional[Tuple[int, ...]] = None
    # fixed, sorted menu of chunk-shape buckets: chunk dispatch shapes are
    # rounded up to the nearest entry (else pow2 buckets, min 8)


class KVBackend:
    """Engine-facing device KV residency + the fused decode step.

    Decode lanes ("slots") give the decode batch its fixed shape; the
    storage is implementation-defined.  ``decode()`` is the hot path: one
    step covering embedding, the layer stack, KV writes, attention,
    sampling and termination — the engine copies a single small
    ``(tokens, reasons)`` pair to the host per iteration.
    """

    def __init__(self, model, cfg: KVBackendConfig):
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self.slot_req: List[Optional[int]] = [None] * cfg.max_slots

    # --------------------------------------------------------------- lanes
    def slot_of(self, rid: int) -> Optional[int]:
        try:
            return self.slot_req.index(rid)
        except ValueError:
            return None

    def has(self, rid: int) -> bool:
        return rid in self.slot_req

    def free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slot_req):
            if r is None:
                return i
        return None

    def _sample_kwargs(self) -> dict:
        c = self.cfg
        return dict(greedy_sampling=c.greedy, temp=c.temperature,
                    top_k=c.top_k, eos_token=c.eos_token,
                    max_new_tokens=c.max_new_tokens,
                    max_seq_len=c.max_seq_len, seed=c.seed)

    def _chunk_bucket(self, n: int) -> int:
        """Dispatch-shape bucket for an ``n``-token chunk: the smallest
        entry of the ``prefill_buckets`` menu covering it, else the pow2
        bucket (min 8)."""
        menu = self.cfg.prefill_buckets
        if menu:
            for b in menu:
                if b >= n:
                    return b
            raise ValueError(
                f"{n}-token chunk exceeds the largest prefill bucket "
                f"{menu[-1]}; the scheduler must clamp chunk spans")
        return max(8, 1 << (n - 1).bit_length())

    def _t(self, a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)


class PagedKVBackend(KVBackend):
    """Paged KV storage: decode lanes share one physical page pool.

    Offload/upload move whole pages (request-granular) and the fused step
    writes the new token's KV directly into its page at ``(write_page,
    write_off)``; inactive lanes write to a reserved scratch page.
    """

    def __init__(self, model, cfg: KVBackendConfig, num_pages: int):
        super().__init__(model, cfg)
        if cfg.max_seq_len % cfg.page_size:
            raise ValueError("max_seq_len must be a page_size multiple")
        if cfg.attn_impl not in ("gather", "kernel"):
            raise ValueError(f"paged_attn_impl={cfg.attn_impl!r}")
        acfg = model.cfg
        self.max_pages_per_seq = cfg.max_seq_len // cfg.page_size
        self.pool = PagedKVPool(PagedKVConfig(
            num_pages=num_pages + 1,                # +1 sacrificial scratch
            page_size=cfg.page_size, num_kv_heads=acfg.num_kv_heads,
            head_dim=acfg.hd, num_layers=acfg.num_layers,
            dtype=model.kv_dtype), device=self.device)
        self.scratch_page = self.pool.reserve_scratch()

    def _kv(self) -> dict:
        return {"k": self.pool.k, "v": self.pool.v}

    # ---------------------------------------------------------- interface
    def prefill_chunk(self, params, rid: int, tokens: List[int],
                      start: int):
        """Run one resumable prefill chunk for ``rid``: write KV for
        absolute positions ``[start, start+len(tokens))`` into its pages
        (claiming a lane on the first chunk) and return the chunk's
        last-position logits (1, V)."""
        slot = self.slot_of(rid)
        if slot is None:                    # first chunk: claim a lane
            slot = self.free_slot()
            if slot is None:
                raise RuntimeError("no free decode lane: the caller must "
                                   "check free_slot()")
            self.slot_req[slot] = rid
            if rid not in self.pool.page_table:
                self.pool.allocate(rid, 0)  # empty table; chunks extend it
        C = len(tokens)
        end = start + C
        pg = self.cfg.page_size
        # grow page coverage to the chunk's end (caller checked
        # chunk_pages_shortfall); a chunk may start/end mid-page
        self.pool.extend_to(rid, end)
        pt = self.pool.page_table[rid]
        Cb = self._chunk_bucket(C)
        toks = np.zeros((1, Cb), np.int64)
        toks[0, :C] = tokens
        wp = np.full((Cb,), self.scratch_page, np.int64)
        wo = np.arange(Cb, dtype=np.int64) % pg     # harmless scratch offsets
        pos = start + np.arange(C)
        wp[:C] = np.asarray(pt, np.int64)[pos // pg]
        wo[:C] = pos % pg
        tables = np.full((1, self.max_pages_per_seq), self.scratch_page,
                         np.int32)
        tables[0, :len(pt)] = pt
        return self.model.paged_prefill_chunk(
            params, self._kv(), self._t(toks, torch.int64), self._t(tables),
            self._t(wp, torch.int64), self._t(wo, torch.int64), start, C)

    def chunk_pages_shortfall(self, rid: int, end: int) -> int:
        have = len(self.pool.page_table.get(rid, []))
        return max(0, self.pool.pages_needed(end) - have
                   - len(self.pool.free_pages))

    def clear(self, rid: int) -> None:
        slot = self.slot_of(rid)
        if slot is not None:
            self.slot_req[slot] = None
        self.pool.free(rid)

    def offload(self, rid: int) -> dict:
        """Detach ``rid``'s KV into a host blob (INT8 through the
        ``kv_quantize`` kernel when ``quantize_offload``) and free its lane
        and pages.  The blob holds exactly the request's pages, with rows
        past its length zeroed (per-row statistics must not see stale
        slots)."""
        pages = self.pool.page_table[rid]
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        length = self.pool.lengths[rid]
        pg = self.cfg.page_size
        pos = torch.arange(len(pages) * pg, device=self.device).reshape(
            len(pages), pg)[None, :, :, None, None]
        stored: dict = {"lengths": length}
        for key in ("k", "v"):
            arr = getattr(self.pool, key)[:, idx]
            arr = torch.where(pos < length, arr, torch.zeros_like(arr))
            if self.cfg.quantize_offload:
                stored[key] = ("q8", quantize_kv_device(arr))
            else:
                stored[key] = ("raw", arr.cpu())
        self.clear(rid)
        return stored

    def upload(self, rid: int, blob: dict) -> None:
        """Restore an offloaded blob into fresh pages and a free lane
        (dequantized to float32 on the device, then cast to the pool's
        dtype)."""
        slot = self.free_slot()
        if slot is None:
            raise RuntimeError("no free decode lane for upload")
        length = blob["lengths"]
        n_need = self.pool.pages_needed(length)
        if n_need > len(self.pool.free_pages):
            raise RuntimeError(
                f"page pool exhausted on upload: need {n_need}, free "
                f"{len(self.pool.free_pages)}")
        fresh = [self.pool.take_page() for _ in range(n_need)]
        self.pool.page_table[rid] = fresh
        self.pool.lengths[rid] = length
        idx = torch.as_tensor(fresh, dtype=torch.long, device=self.device)
        for key in ("k", "v"):
            kind, item = blob[key]
            if kind == "q8":
                src = dequantize_kv_device(item, dtype=torch.float32,
                                           device=self.device)
            else:
                src = item.to(self.device)
            arr = getattr(self.pool, key)
            arr.index_copy_(1, idx, src[:, :n_need].to(arr.dtype))
        self.slot_req[slot] = rid

    def pages_shortfall(self, rids: List[int]) -> int:
        """Physical pages missing to decode one token for each of
        ``rids``."""
        pg = self.cfg.page_size
        need_new = sum(1 for rid in rids if self.pool.lengths[rid] % pg == 0)
        return max(0, need_new - len(self.pool.free_pages))

    def decode(self, params, tokens, active, new_gen, new_ctx, true_len,
               rids):
        """One fused iteration -> (sampled (B,), reason (B,)) numpy."""
        B, pg = self.cfg.max_slots, self.cfg.page_size
        maxp = self.max_pages_per_seq
        tables = np.full((B, maxp), self.scratch_page, np.int32)
        lens = np.zeros((B,), np.int32)
        wp = np.full((B,), self.scratch_page, np.int64)
        wo = np.zeros((B,), np.int64)
        for slot, rid in enumerate(self.slot_req):
            if rid is None or not active[slot]:
                continue
            # the fed token's KV lands at logical position `pos`: grow the
            # page table first (caller guarantees a free page via
            # pages_shortfall), then point the write at its page slot
            self.pool.extend(rid, 1)
            pos = self.pool.lengths[rid] - 1
            pt = self.pool.page_table[rid]
            tables[slot, :len(pt)] = pt
            lens[slot] = pos
            wp[slot] = pt[pos // pg]
            wo[slot] = pos % pg
        tok, reason = self.model.paged_decode_step_sampled(
            params, self._kv(), self._t(tokens, torch.int64),
            self._t(tables), self._t(lens), self._t(wp, torch.int64),
            self._t(wo, torch.int64), self._t(active, torch.bool),
            self._t(new_gen), self._t(new_ctx), self._t(true_len),
            self._t(rids), attn_impl=self.cfg.attn_impl,
            **self._sample_kwargs())
        out = torch.stack([tok, reason]).cpu().numpy()
        return out[0], out[1]
