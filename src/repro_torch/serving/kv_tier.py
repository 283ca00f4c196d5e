"""Cluster-wide host-RAM KV tier of the PyTorch port: a shared cold store
of prefix pages, as ``repro.serving.kv_tier`` (whose module imports JAX,
so the port keeps its own).

Every replica owns its device-resident prefix cache, but a session
re-routed to a peer replica would re-prefill a prefix the cluster already
computed.  :class:`HostKVTier` makes the prefix cache a cluster asset:
replicas *publish* their exact prefix pages into one host-RAM pool (one
copy per unique page cluster-wide, radix-indexed by token prefix) and any
replica *imports* a peer's pages at admit time, an upload-shaped transfer
instead of prefill compute (FastServe's proactive multi-tier KV movement,
arxiv 2305.05920).

Discipline, as the reference's:

  * entries are **refcounted handles**: an in-flight import pins its
    pages, so byte-capacity LRU eviction (leaf first, pinned pages
    skipped) never frees a payload a replica is copying;
  * ``probe`` and ``probe_bytes`` touch nothing (pricing and routing
    probes must not skew the LRU); ``acquire`` LRU-touches;
  * only **exact** KV is published (the engine's ``_lossy_kv`` guard runs
    upstream), so with the default fp tier a cross-replica import gives
    the bits of a recompute;
  * ``quantize=True`` stores INT8 payloads, about half the bytes, so the
    tier holds about twice the prefixes.  Like an INT8 swap this is lossy:
    importers are marked lossy and never publish.

The torch-specific parts: a raw payload is ``("raw", k, v)`` with CPU
torch tensors (bfloat16 has no numpy dtype); a quantized one is built by
``serving/kv_cache.quantize_kv_store``, which runs the ``kv_quantize``
kernel's store entry on the page's K and V where they lie (their own
device and dtype, one launch) and copies the INT8 blobs to the host; and
:meth:`TierHandle.materialize` takes the device to land the pages on
(the ``kv_dequantize`` kernel runs there for a quantized payload), where
the reference follows JAX's default-device scope.  A payload covers one
page, K and V apart, one row per (token, head) over the head dimension,
as the reference's.

:class:`SimKVTier` is the analytical twin for the simulator and cluster
replicas (pure Python, copied): shared hit lengths + page-capacity LRU,
imports priced at ``bytes / swap_bw`` of transfer instead of prefill
compute.
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.serving.prefix_cache import RadixPageIndex, SimPrefixIndex


@dataclass
class TierStats:
    publishes: int = 0            # publish calls that stored >= 1 page
    published_pages: int = 0
    imports: int = 0              # acquire calls that pinned >= 1 page
    imported_pages: int = 0
    hit_bytes: int = 0            # payload bytes served to importers
    evicted_pages: int = 0
    evicted_bytes: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dict(self.__dict__)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


class _Entry:
    """One page payload: ``("raw", k, v)`` CPU tensors, or ``("q8",
    k_blob, v_blob)`` ``quantize_kv_device`` blobs."""

    __slots__ = ("payload", "nbytes", "refs")

    def __init__(self, payload, nbytes: int):
        self.payload = payload
        self.nbytes = nbytes
        self.refs = 0               # pinned by in-flight imports


class TierHandle:
    """Pinned view of a matched prefix: ``payloads[i]`` covers token page
    ``i`` from the root.  Call :meth:`release` once the pages are copied
    to the device (in a ``finally`` block: an unreleased handle pins its
    pages against eviction for ever)."""

    def __init__(self, tier: "HostKVTier", ids: List[int],
                 payloads: List[tuple], nbytes: int, lossy: bool):
        self._tier = tier
        self._ids = ids
        self.payloads = payloads
        self.nbytes = nbytes
        self.lossy = lossy
        self.tokens = len(ids) * tier.page_size

    def materialize(self, dtype, device=None, first: int = 0,
                    last: Optional[int] = None) -> List[Tuple]:
        """Decode payloads ``first..last`` (all by default) to ``(k, v)``
        pages of ``dtype`` on ``device`` (None: the CPU): a raw payload is
        copied there, a quantized one dequantized there by the
        ``kv_dequantize`` kernel."""
        from repro_torch.serving.kv_cache import dequantize_kv_device
        dev = torch.device("cpu") if device is None else torch.device(device)
        out = []
        for payload in self.payloads[first:last]:
            if payload[0] == "raw":
                out.append((payload[1].to(device=dev, dtype=dtype),
                            payload[2].to(device=dev, dtype=dtype)))
            else:
                out.append((dequantize_kv_device(payload[1], dtype, dev),
                            dequantize_kv_device(payload[2], dtype, dev)))
        return out

    def release(self) -> None:
        if self._ids:
            self._tier._unpin(self._ids)
            self._ids = []


class HostKVTier:
    """Shared host-RAM cold tier of prefix KV pages (a cluster asset).

    Thread-safe: replicas' threads publish and import concurrently.
    ``capacity_bytes`` bounds payload bytes; an overflow evicts unpinned
    pages leaf first, least recently imported first.
    """

    def __init__(self, capacity_bytes: float, page_size: int,
                 quantize: bool = False):
        self.capacity_bytes = float(capacity_bytes)
        self.page_size = int(page_size)
        self.quantize = bool(quantize)
        self.index = RadixPageIndex(self.page_size)
        self.entries: Dict[int, _Entry] = {}
        self.bytes = 0
        self.stats = TierStats()
        self.lock = threading.Lock()
        self._ids = itertools.count()
        self.bus = None                # observability EventBus (None = off)
        self.replica = "tier"

    # ------------------------------------------------------------- probe
    def probe(self, tokens, cap: Optional[int] = None) -> int:
        """Full-page matched token length (touch-free: pricing and routing
        probes must not skew the LRU)."""
        if not tokens:
            return 0
        limit = len(tokens) if cap is None else min(cap, len(tokens))
        with self.lock:
            n = self.index.probe_len(tokens, limit)
        return (n // self.page_size) * self.page_size

    def probe_bytes(self, tokens, cap: Optional[int] = None
                    ) -> Tuple[int, int]:
        """(hit_tokens, payload_bytes) for the matchable full pages: the
        transfer-cost input of tier-aware TTFT pricing."""
        if not tokens:
            return 0, 0
        limit = len(tokens) if cap is None else min(cap, len(tokens))
        with self.lock:
            full, _ = self.index.match(tokens, limit, touch=False)
            nbytes = sum(self.entries[n.page].nbytes for n in full)
        return len(full) * self.page_size, nbytes

    # ----------------------------------------------------------- acquire
    def acquire(self, tokens, upto: int) -> Optional[TierHandle]:
        """Pin and return the payloads covering ``tokens[:upto]`` (full
        pages, from the root); None when nothing matches.  The match
        LRU-touches entries (this is a served hit)."""
        pg = self.page_size
        n_pages = min(upto, len(tokens)) // pg
        if n_pages <= 0:
            return None
        with self.lock:
            full, _ = self.index.match(tokens, n_pages * pg)
            ids = [n.page for n in full][:n_pages]
            if not ids:
                return None
            payloads, nbytes = [], 0
            for pid in ids:
                e = self.entries[pid]
                e.refs += 1
                payloads.append(e.payload)
                nbytes += e.nbytes
            self.stats.imports += 1
            self.stats.imported_pages += len(ids)
            self.stats.hit_bytes += nbytes
        return TierHandle(self, ids, payloads, nbytes, self.quantize)

    def _unpin(self, ids: List[int]) -> None:
        with self.lock:
            for pid in ids:
                e = self.entries.get(pid)
                if e is not None:
                    e.refs -= 1

    # ----------------------------------------------------------- publish
    def publish(self, tokens, upto: int,
                fetch_page: Callable[[int], tuple]) -> int:
        """Index ``tokens[:upto]`` (clipped to full pages).

        ``fetch_page(i)`` returns the ``(k, v)`` page tensors of token
        page ``i`` (on any device), consulted only for pages the tier
        does not hold yet, so re-publishing a prefix the cluster knows
        copies nothing.  Returns the number of newly stored pages."""
        pg = self.page_size
        upto = (min(upto, len(tokens)) // pg) * pg
        if upto <= 0:
            return 0
        with self.lock:
            created = self.index.insert(tokens, upto,
                                        self._store_page(fetch_page))
            if created:
                self.stats.publishes += 1
                self.stats.published_pages += len(created)
                self._evict_to_capacity()
        return len(created)

    def _store_page(self, fetch_page):
        def page_of(i: int) -> int:
            k, v = fetch_page(i)
            payload, nbytes = self._pack(k, v)
            pid = next(self._ids)
            self.entries[pid] = _Entry(payload, nbytes)
            self.bytes += nbytes
            return pid
        return page_of

    def _pack(self, k, v) -> Tuple[tuple, int]:
        """A page's payload: host copies of ``k`` and ``v`` (each
        synchronized with the device before it is stored), or their INT8
        blobs quantized on their device in one launch and copied to
        ordinary host memory in one copy (a page outlives any swap: it is
        not worth page-locked memory)."""
        if not self.quantize:
            k = k.detach().to("cpu", copy=True)
            v = v.detach().to("cpu", copy=True)
            return ("raw", k, v), _nbytes(k, v)
        from repro_torch.serving.kv_cache import quantize_kv_store
        kb, vb = quantize_kv_store((k.detach(), v.detach()), k.shape,
                                   pinned=False)
        return ("q8", kb, vb), _nbytes(*kb, *vb)

    # ------------------------------------------------------------- evict
    def _evict_to_capacity(self) -> None:
        """Drop unpinned pages (LRU, leaf first) until payload bytes fit.
        The caller holds the lock."""
        while self.bytes > self.capacity_bytes:
            freed = self.index.evict_lru(
                8, can_evict=lambda p: self.entries[p].refs == 0)
            if not freed:
                break                  # everything left is pinned
            for pid in freed:
                e = self.entries.pop(pid)
                self.bytes -= e.nbytes
                self.stats.evicted_pages += 1
                self.stats.evicted_bytes += e.nbytes
                if self.bus is not None:
                    self.bus.emit("tier_evict", replica=self.replica,
                                  bytes=e.nbytes)

    def drop_all(self) -> int:
        """Release every entry (shutdown, tests), pinned pages too: call it
        only once importers are drained."""
        with self.lock:
            pages = self.index.clear()
            self.entries.clear()
            self.bytes = 0
        return len(pages)

    # ------------------------------------------------------------- stats
    def gauges(self) -> Dict[str, float]:
        with self.lock:
            s = self.stats
            return {
                "tier_bytes": float(self.bytes),
                "tier_capacity_bytes": float(self.capacity_bytes),
                "tier_pages": float(len(self.entries)),
                "tier_utilization": self.bytes / max(self.capacity_bytes,
                                                     1.0),
                "tier_hit_bytes_total": float(s.hit_bytes),
                "tier_imports_total": float(s.imports),
                "tier_imported_pages_total": float(s.imported_pages),
                "tier_published_pages_total": float(s.published_pages),
                "tier_evicted_pages_total": float(s.evicted_pages),
            }

    def pinned_pages(self) -> int:
        with self.lock:
            return sum(1 for e in self.entries.values() if e.refs > 0)


# ------------------------------------------------------ simulator twin

class SimKVTier:
    """Analytical cluster-tier twin for ``ServingSimulator`` /
    ``core.cluster`` replicas: one shared token-level index; a tier hit
    replaces the prefix's prefill compute with ``bytes / swap_bw`` of
    import DMA."""

    def __init__(self, page_size: int, capacity_pages: int,
                 swap_bw: float):
        self.page_size = page_size
        self.sim = SimPrefixIndex(page_size, capacity_pages)
        self.swap_bw = float(swap_bw)
        self.imports = 0
        self.imported_tokens = 0

    def probe(self, tokens, cap: Optional[int] = None) -> int:
        n = self.sim.probe(tokens)
        if cap is not None:
            n = min(n, cap)
        return (n // self.page_size) * self.page_size

    def hit(self, tokens, cap: int) -> int:
        """Served hit (LRU-touching), floored to full pages."""
        n = (self.sim.hit(tokens, cap) // self.page_size) * self.page_size
        if n > 0:
            self.imports += 1
            self.imported_tokens += n
        return n

    def insert(self, tokens, upto: int) -> int:
        return self.sim.insert(tokens, upto)

    def import_time(self, n_tokens: int, bytes_per_token: float) -> float:
        return (n_tokens * bytes_per_token) / max(self.swap_bw, 1e-9)
