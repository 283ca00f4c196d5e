"""Priority-based adaptive KV memory management (paper §3.2, Algorithm 2).

Tracks KV residency per request across a two-tier hierarchy (HBM <-> host
DRAM) with token-based accounting, INT8 compression of offloaded KV (paper's
KV Compression) and an optional quantized *cold tier inside HBM* (beyond-paper
TPU adaptation: quantize-in-place is cheaper than crossing the host link; see
DESIGN.md §3).

The manager performs the bookkeeping; *which* request to move is decided by
the scheduler via EWT ordering and executed through :meth:`offload` /
:meth:`upload` / :meth:`drop`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.request import KVLocation, Request


@dataclass
class SwapOp:
    req_id: int
    kind: str          # "upload" | "offload" | "quantize" | "dequantize"
    bytes: float
    issue_time: float
    done_time: float = 0.0


@dataclass
class MemoryConfig:
    hbm_bytes: float = 16e9              # per-replica KV budget (after weights)
    dram_bytes: float = 256e9
    bytes_per_token_fp: int = 2 * 40 * 40 * 128 * 2   # set per model
    swap_bw: float = 32e9                # host link bytes/s (PCIe4 x16-class)
    quantize_offload: bool = True        # paper: offloaded KV stored INT8
    quant_ratio: float = 0.5             # int8 vs fp16
    quantize_cold_hbm: bool = False      # beyond-paper HBM cold tier
    reserve_policy: str = "ondemand"     # ondemand | reserve_max (ORCA-style)
    reserve_max_tokens: int = 2048
    admit_headroom: float = 0.02         # vLLM-style watermark: keep this
                                         # fraction of HBM free at admission
    page_size: Optional[int] = None      # paged backend: HBM allocation is
                                         # page-granular, so token counts
                                         # round up to page multiples — the
                                         # accounting then upper-bounds the
                                         # physical page pool exactly


class TieredKVManager:
    def __init__(self, cfg: MemoryConfig):
        self.cfg = cfg
        self.tokens: Dict[int, int] = {}            # req_id -> resident tokens
        self.reserved: Dict[int, int] = {}          # req_id -> reserved tokens
        self.location: Dict[int, KVLocation] = {}
        self.used_hbm = 0.0
        self.used_dram = 0.0
        self.swap_log: List[SwapOp] = []
        self._swap_free_at = 0.0                    # swap engine busy-until
        # shared-prefix KV cache hooks (registered by the engine when the
        # cache is enabled): cached-but-unreferenced pages are *reclaimable*
        # HBM — they are evicted (priority-aware LRU, leaf-first) before any
        # resident job's pages are offloaded, extending Alg. 2's victim
        # ordering below the request level
        self._cache_reclaim: Optional[Callable[[int], int]] = None
        self._cache_pages: Optional[Callable[[], Tuple[int, int]]] = None
        self.cache_reclaimed_pages = 0              # lifetime eviction count
        self.static_bytes = 0.0                     # fixed device charges
                                                    # (e.g. the dense prefix
                                                    # cache's private store)
        self.tier_imports = 0                       # cluster-tier prefix
        self.tier_import_bytes = 0.0                # imports through this
                                                    # replica's DMA queue

    # ------------------------------------------------------------- helpers
    def _round_tokens(self, tokens: int) -> int:
        """Allocation granularity: whole pages when page_size is set."""
        ps = self.cfg.page_size
        if not ps or tokens <= 0:
            return tokens
        return -(-tokens // ps) * ps

    def pages_of(self, tokens: int) -> int:
        """Page count backing ``tokens`` (0 without a page_size)."""
        ps = self.cfg.page_size
        return -(-tokens // ps) if ps else 0

    def _bytes(self, tokens: int, quantized: bool) -> float:
        per = self.cfg.bytes_per_token_fp
        return (self._round_tokens(tokens) * per
                * (self.cfg.quant_ratio if quantized else 1.0))

    def _reservation(self, req: Request) -> int:
        if self.cfg.reserve_policy == "reserve_max":
            return req.prompt_len + self.cfg.reserve_max_tokens
        return req.context_len + 1

    def hbm_free(self) -> float:
        return self.cfg.hbm_bytes - self.used_hbm - self.static_bytes

    # ------------------------------------------------ prefix-cache tier
    def charge_static(self, nbytes: float) -> None:
        """Reserve a fixed, unreclaimable device allocation against the
        HBM budget (the dense prefix cache's private store lives outside
        per-request accounting but is physically real — without this
        charge the accounting would stop upper-bounding device memory)."""
        self.static_bytes += nbytes

    def register_prefix_cache(self, reclaim: Callable[[int], int],
                              pages: Callable[[], Tuple[int, int]]) -> None:
        """Wire the shared-prefix cache in as the lowest-priority KV
        tier: ``reclaim(n_pages) -> freed`` evicts unreferenced cached
        pages LRU-first; ``pages() -> (held, reclaimable)`` reports its
        footprint."""
        self._cache_reclaim = reclaim
        self._cache_pages = pages

    def reclaim_cache(self, n_pages: int) -> int:
        """Free up to ``n_pages`` physical pages by evicting
        cached-but-unreferenced prefix pages — always tried before any
        resident job is spilled (they hold no live request's state, so
        evicting them costs a possible future hit, never a recompute)."""
        if self._cache_reclaim is None or n_pages <= 0:
            return 0
        freed = self._cache_reclaim(n_pages)
        self.cache_reclaimed_pages += freed
        return freed

    def cached_pages(self) -> Tuple[int, int]:
        """(pages the prefix cache holds, pages reclaimable right now)."""
        return self._cache_pages() if self._cache_pages else (0, 0)

    def hbm_bytes_of(self, req: Request) -> float:
        quant = self.location.get(req.req_id) == KVLocation.HBM_Q8
        return self._bytes(self.reserved.get(req.req_id, 0), quant)

    def location_of(self, req: Request) -> KVLocation:
        return self.location.get(req.req_id, KVLocation.NONE)

    def resident_hbm(self, req: Request) -> bool:
        return self.location_of(req) in (KVLocation.HBM, KVLocation.HBM_Q8)

    # ---------------------------------------------------------- allocation
    def can_admit(self, req: Request) -> bool:
        need = self._bytes(self._reservation(req), False)
        watermark = self.cfg.admit_headroom * self.cfg.hbm_bytes
        return self.hbm_free() >= need + watermark

    def admit(self, req: Request) -> None:
        """Allocate HBM for a fresh prefill (QUEUED -> HBM)."""
        assert self.location_of(req) == KVLocation.NONE
        res = self._reservation(req)
        self.tokens[req.req_id] = req.context_len
        self.reserved[req.req_id] = res
        self.location[req.req_id] = KVLocation.HBM
        self.used_hbm += self._bytes(res, False)
        req.kv_location = KVLocation.HBM

    def grow(self, req: Request) -> bool:
        """Account one decoded token; returns False on HBM exhaustion."""
        rid = req.req_id
        assert self.location_of(req) == KVLocation.HBM, req
        self.tokens[rid] = req.context_len
        if self.tokens[rid] < self.reserved[rid]:
            return True
        # marginal cost of one more reserved token: zero inside a page,
        # a whole page's bytes when crossing a boundary (page-granular)
        need = (self._bytes(self.reserved[rid] + 1, False)
                - self._bytes(self.reserved[rid], False))
        if self.hbm_free() < need:
            return False
        self.reserved[rid] += 1
        self.used_hbm += need
        return True

    # ------------------------------------------------------------ movement
    def _swap_time(self, now: float, nbytes: float) -> float:
        """Swap engine is a single DMA queue overlapped with compute."""
        start = max(now, self._swap_free_at)
        done = start + nbytes / self.cfg.swap_bw
        self._swap_free_at = done
        return done

    def note_tier_import(self, now: float, nbytes: float) -> float:
        """Account a cluster-tier prefix import: upload-DMA-shaped bytes
        that ride the same single swap DMA queue as request swaps (so
        imports and swaps contend for link time, like the hardware they
        model).  Returns the modeled transfer-done time."""
        self.tier_imports += 1
        self.tier_import_bytes += nbytes
        return self._swap_time(now, nbytes)

    def offload(self, req: Request, now: float) -> SwapOp:
        """HBM -> DRAM (quantized per config).  Paper Alg. 2 'preemptive offload'."""
        rid = req.req_id
        assert self.resident_hbm(req)
        was_quant = self.location[rid] == KVLocation.HBM_Q8
        res = self.reserved[rid]
        self.used_hbm -= self._bytes(res, was_quant)
        quant = self.cfg.quantize_offload
        nbytes = self._bytes(self.tokens[rid], quant)
        self.used_dram += nbytes
        self.reserved[rid] = self.tokens[rid]
        self.location[rid] = KVLocation.DRAM
        req.kv_location = KVLocation.DRAM
        req.kv_quantized = quant
        req.swap_out_bytes += nbytes
        op = SwapOp(rid, "offload", nbytes, now, self._swap_time(now, nbytes))
        self.swap_log.append(op)
        return op

    def upload(self, req: Request, now: float) -> SwapOp:
        """DRAM -> HBM ('preemptive upload'); dequantizes back to fp16."""
        rid = req.req_id
        assert self.location_of(req) == KVLocation.DRAM
        nbytes = self._bytes(self.tokens[rid], req.kv_quantized)
        self.used_dram -= nbytes
        res = self.tokens[rid] + 1
        self.reserved[rid] = res
        self.used_hbm += self._bytes(res, False)
        self.location[rid] = KVLocation.HBM
        req.kv_location = KVLocation.HBM
        req.kv_quantized = False
        req.swap_in_bytes += nbytes
        op = SwapOp(rid, "upload", nbytes, now, self._swap_time(now, nbytes))
        self.swap_log.append(op)
        return op

    def quantize_cold(self, req: Request, now: float) -> SwapOp:
        """HBM fp16 -> HBM int8 cold tier (no host traffic; beyond-paper)."""
        rid = req.req_id
        assert self.location_of(req) == KVLocation.HBM
        res = self.reserved[rid]
        self.used_hbm -= self._bytes(res, False)
        self.reserved[rid] = self.tokens[rid]
        self.used_hbm += self._bytes(self.tokens[rid], True)
        self.location[rid] = KVLocation.HBM_Q8
        req.kv_location = KVLocation.HBM_Q8
        req.kv_quantized = True
        op = SwapOp(rid, "quantize", 0.0, now, now)   # on-chip, ~free
        self.swap_log.append(op)
        return op

    def dequantize_cold(self, req: Request, now: float) -> SwapOp:
        rid = req.req_id
        assert self.location_of(req) == KVLocation.HBM_Q8
        self.used_hbm -= self._bytes(self.reserved[rid], True)
        res = self.tokens[rid] + 1
        self.reserved[rid] = res
        self.used_hbm += self._bytes(res, False)
        self.location[rid] = KVLocation.HBM
        req.kv_location = KVLocation.HBM
        req.kv_quantized = False
        op = SwapOp(rid, "dequantize", 0.0, now, now)
        self.swap_log.append(op)
        return op

    def drop(self, req: Request) -> None:
        """Delete KV entirely (Recompute-strategy eviction)."""
        rid = req.req_id
        loc = self.location_of(req)
        if loc in (KVLocation.HBM, KVLocation.HBM_Q8):
            self.used_hbm -= self._bytes(self.reserved[rid], loc == KVLocation.HBM_Q8)
        elif loc == KVLocation.DRAM:
            self.used_dram -= self._bytes(self.tokens[rid], req.kv_quantized)
        self.tokens.pop(rid, None)
        self.reserved.pop(rid, None)
        self.location.pop(rid, None)
        req.kv_location = KVLocation.NONE
        req.kv_quantized = False
        req.prefilled = 0                  # chunked prefill restarts from 0
        req.recompute_tokens += req.context_len

    def free(self, req: Request) -> None:
        """Release everything on finish."""
        rid = req.req_id
        loc = self.location_of(req)
        if loc in (KVLocation.HBM, KVLocation.HBM_Q8):
            self.used_hbm -= self._bytes(self.reserved[rid], loc == KVLocation.HBM_Q8)
        elif loc == KVLocation.DRAM:
            self.used_dram -= self._bytes(self.tokens[rid], req.kv_quantized)
        self.tokens.pop(rid, None)
        self.reserved.pop(rid, None)
        self.location.pop(rid, None)
        req.kv_location = KVLocation.NONE
        req.prefilled = 0

    # -------------------------------------------------------------- gauges
    def gauges(self) -> Dict[str, float]:
        """Point-in-time occupancy/fragmentation snapshot for the
        observability layer.  ``hbm_frag`` is internal reservation
        fragmentation: the fraction of reserved HBM tokens not backing a
        resident token (page-rounding slack + reserve-ahead headroom)."""
        resident = [rid for rid, loc in self.location.items()
                    if loc in (KVLocation.HBM, KVLocation.HBM_Q8)]
        res_tokens = sum(self.reserved.get(r, 0) for r in resident)
        live_tokens = sum(self.tokens.get(r, 0) for r in resident)
        held, reclaimable = self.cached_pages()
        return {
            "hbm_used_bytes": self.used_hbm,
            "hbm_static_bytes": self.static_bytes,
            "hbm_free_bytes": self.hbm_free(),
            "hbm_total_bytes": self.cfg.hbm_bytes,
            "hbm_utilization": ((self.used_hbm + self.static_bytes)
                                / max(self.cfg.hbm_bytes, 1.0)),
            "hbm_frag": (1.0 - live_tokens / res_tokens) if res_tokens else 0.0,
            "dram_used_bytes": self.used_dram,
            "n_resident": float(len(resident)),
            "prefix_cache_pages": float(held),
            "prefix_cache_reclaimable": float(reclaimable),
            "prefix_cache_reclaimed_total": float(self.cache_reclaimed_pages),
            "swap_ops_total": float(len(self.swap_log)),
            "tier_dma_imports_total": float(self.tier_imports),
            "tier_dma_bytes_total": self.tier_import_bytes,
        }

    # -------------------------------------------------------------- checks
    def check_invariants(self) -> None:
        hbm = sum(self._bytes(self.reserved[r], self.location[r] == KVLocation.HBM_Q8)
                  for r in self.location
                  if self.location[r] in (KVLocation.HBM, KVLocation.HBM_Q8))
        dram = sum(self._bytes(self.tokens[r], True) if self._quant_of(r)
                   else self._bytes(self.tokens[r], False)
                   for r in self.location if self.location[r] == KVLocation.DRAM)
        assert abs(hbm - self.used_hbm) < 1.0, (hbm, self.used_hbm)
        assert abs(dram - self.used_dram) < 1.0, (dram, self.used_dram)
        assert self.used_hbm + self.static_bytes <= self.cfg.hbm_bytes + 1.0

    def _quant_of(self, rid: int) -> bool:
        return self.cfg.quantize_offload
