"""Cross-request shared-prefix KV cache of the PyTorch port: a radix-tree
token-prefix index over refcounted pages, as ``repro.serving.prefix_cache``
(whose module imports JAX, so the port keeps its own).

Real traffic re-prefills the same token prefix over and over: multi-turn
chats resend the whole conversation, fleets of requests share one system
prompt.  The KV of a shared prefix can be shared instead of recomputed:

  * the index is **page-granular**: one radix node per full page of
    tokens.  Matching walks full-page token keys exactly; when the walk
    stops mid-page, the longest partially-matching child is reused
    **copy-on-write**, and the request's chunked prefill overwrites the
    copy from the divergence point (positions past the prefill watermark
    are causally masked, so a hit gives the bits of a recompute);
  * pages referenced by the index hold one refcount and every request
    mapping a shared page holds another, so eviction never frees KV a
    resident request attends over;
  * eviction is **priority-aware LRU**: only cached pages no request
    references are evictable, leaf first, least recently matched first.
    ``TieredKVManager.reclaim_cache`` routes page shortfalls here before
    any resident request is spilled.

:class:`_Node`, :class:`PrefixCacheStats`, :class:`RadixPageIndex` and the
simulator's :class:`SimPrefixIndex` are pure Python, copied from the
reference.  The two storage front-ends are rewritten for torch:

  * :class:`PagedPrefixCache` aliases the engine's ``PagedKVPool`` pages
    by refcount: a hit maps shared pages straight into the request's page
    table, a partial page is copied into a fresh one (``cow_page``);
  * :class:`DensePrefixCache` owns a private page store on the engine's
    device (the dense backend's lanes cannot alias storage): a hit copies
    the cached pages into the request's stripe, a publish copies stripe
    rows into the store, each as one torch index copy.

Both front-ends emit ``prefix_cow``, ``prefix_dedupe`` and
``prefix_evict`` events to an observability bus when the engine attaches
one (``bus`` None: nothing is recorded).  With a cluster KV tier attached
(``tier``: a ``serving/kv_tier.HostKVTier``), each publish that indexes
new pages exports its span to the tier, which fetches only the pages it
lacks: one page of the pool, or of the source stripe, as device views
that the tier copies to the host or quantizes on the device.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch


# ------------------------------------------------------------- radix core

class _Node:
    """One full page of cached prefix: ``key`` is the page's token tuple,
    ``page`` the physical page id holding its KV."""

    __slots__ = ("key", "page", "children", "parent", "last_used")

    def __init__(self, key: Tuple[int, ...], page: int,
                 parent: Optional["_Node"]):
        self.key = key
        self.page = page
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.last_used = 0


@dataclass
class PrefixCacheStats:
    hits: int = 0                 # requests that matched >= 1 full page
    partial_hits: int = 0         # matches extended mid-page via CoW
    misses: int = 0
    hit_tokens: int = 0           # total tokens served from cache
    inserted_pages: int = 0
    evicted_pages: int = 0
    cow_pages: int = 0
    deduped_pages: int = 0        # duplicate physical pages freed when a
                                  # publish found the span already indexed

    def as_dict(self) -> Dict[str, int]:
        return dict(self.__dict__)


class RadixPageIndex:
    """Page-granular radix tree: token prefixes -> physical page ids.

    The tree stores *which* pages cache *which* token spans; ownership
    (refcounts, storage) belongs to the caller.  Children are keyed by
    their full page token tuple, so a full-page walk is one dict lookup
    per page; partial (mid-page) matches scan the divergence node's
    children once.
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root: Dict[Tuple[int, ...], _Node] = {}
        self.nodes: set = set()               # flat view for eviction scans
        self._tick = 0

    @property
    def n_pages(self) -> int:
        return len(self.nodes)

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.last_used = self._tick

    # ------------------------------------------------------------- match
    def match(self, tokens, max_len: Optional[int] = None, *,
              touch: bool = True
              ) -> Tuple[List[_Node], Optional[Tuple[_Node, int]]]:
        """Longest cached prefix of ``tokens[:max_len]``.

        Returns ``(full_nodes, partial)``: the chain of fully-matched
        page nodes, plus ``(node, m)`` when a child of the divergence
        point shares the next ``0 < m < page_size`` tokens (the
        copy-on-write candidate).  Matched nodes are LRU-touched unless
        ``touch=False`` — pricing/routing probes must not pin entries
        that never get a real hit ahead of ones that do.
        """
        pg = self.page_size
        limit = len(tokens) if max_len is None else min(len(tokens), max_len)
        full: List[_Node] = []
        children = self.root
        i = 0
        while i + pg <= limit:
            node = children.get(tuple(tokens[i:i + pg]))
            if node is None:
                break
            if touch:
                self._touch(node)
            full.append(node)
            children = node.children
            i += pg
        partial: Optional[Tuple[_Node, int]] = None
        if i < limit:
            tail = tuple(tokens[i:limit])
            best_m, best_node = 0, None
            # snapshot: probes may race a step-thread mutation (gateway
            # routing); a stale view is fine, a RuntimeError is not
            for key, node in list(children.items()):
                m = 0
                for a, b in zip(key, tail):
                    if a != b:
                        break
                    m += 1
                if m > best_m:
                    best_m, best_node = m, node
            if best_node is not None:
                if touch:
                    self._touch(best_node)
                partial = (best_node, best_m)
        return full, partial

    def probe_len(self, tokens, max_len: Optional[int] = None, *,
                  touch: bool = False) -> int:
        """Cached-prefix length in tokens (full pages + partial match).
        Touch-free by default — this is the pricing/routing estimate."""
        full, partial = self.match(tokens, max_len, touch=touch)
        return len(full) * self.page_size + (partial[1] if partial else 0)

    # ------------------------------------------------------------ insert
    def insert(self, tokens, upto: int, page_of) -> List[_Node]:
        """Index the full pages covering ``tokens[:upto]``.

        ``page_of(i)`` supplies the physical page id caching page ``i``
        (tokens ``[i*pg, (i+1)*pg)``) — consulted only for pages not
        already indexed.  Returns the newly-created nodes (the caller
        takes an index refcount on each).  Existing nodes keep their
        page (first writer wins; a duplicate copy stays private to its
        request).
        """
        pg = self.page_size
        created: List[_Node] = []
        children = self.root
        parent: Optional[_Node] = None
        for i in range(upto // pg):
            key = tuple(tokens[i * pg:(i + 1) * pg])
            node = children.get(key)
            if node is None:
                page = page_of(i)
                if page is None:        # storage full and not evictable
                    break
                node = _Node(key, page, parent)
                children[key] = node
                self.nodes.add(node)
                created.append(node)
            self._touch(node)
            children = node.children
            parent = node
        return created

    # ------------------------------------------------------------- evict
    def evict_lru(self, n_pages: int, can_evict) -> List[int]:
        """Remove up to ``n_pages`` least-recently-used *leaf* nodes whose
        page passes ``can_evict`` (shared pages are pinned); returns the
        freed page ids.  Interior nodes become evictable as their
        subtrees drain — a prefix is never orphaned below a hole.  Each
        scan evicts a whole batch of leaves (oldest first), so freeing
        ``k`` pages costs O(depth * N log N), not one full scan per page
        — this runs on the engine's page-shortfall path, under step_lock."""
        freed: List[int] = []
        while len(freed) < n_pages:
            leaves = [nd for nd in self.nodes
                      if not nd.children and can_evict(nd.page)]
            if not leaves:
                break
            leaves.sort(key=lambda nd: nd.last_used)
            for victim in leaves[:n_pages - len(freed)]:
                siblings = (victim.parent.children
                            if victim.parent is not None else self.root)
                siblings.pop(victim.key, None)
                self.nodes.discard(victim)
                freed.append(victim.page)
        return freed

    def clear(self) -> List[int]:
        pages = [n.page for n in self.nodes]
        self.root = {}
        self.nodes = set()
        return pages


# ------------------------------------------------- paged (zero-copy) cache

class PagedPrefixCache:
    """Shared-prefix cache over the engine's :class:`PagedKVPool`.

    Hits map index-held pages directly into the request's page table
    (refcount +1 per page, no data movement); a partial-page match is
    served copy-on-write.  Publishing hands the index a refcount on the
    request's full pages, which outlive the request until LRU eviction
    reclaims them.
    """

    def __init__(self, pool, page_size: int):
        self.pool = pool
        self.index = RadixPageIndex(page_size)
        self.stats = PrefixCacheStats()
        self.bus = None                # observability EventBus (None = off)
        self.replica = ""
        self.tier = None               # cluster HostKVTier (None = off)

    def probe(self, tokens) -> int:
        """Expected hit length in tokens (pricing only: touch-free, so
        probes cannot pin entries in the LRU), capped at ``len(tokens) -
        1``."""
        if not tokens:
            return 0
        return min(self.index.probe_len(tokens), len(tokens) - 1)

    def acquire(self, rid: int, tokens) -> int:
        """Map the longest cached prefix of ``tokens`` into ``rid``'s page
        table and return the hit length (the request's starting
        ``prefilled`` watermark).  Capped at ``len(tokens) - 1``, so at
        least one token runs through prefill (the first token's logits
        come from it)."""
        pool = self.pool
        cap = len(tokens) - 1
        if cap <= 0 or rid in pool.page_table:
            return 0
        full, partial = self.index.match(tokens, cap)
        if not full and partial is None:
            self.stats.misses += 1
            return 0
        pages: List[int] = []
        for node in full:
            pool.incref(node.page)
            pages.append(node.page)
        hit = len(pages) * self.index.page_size
        if partial is not None:
            node, m = partial
            cow = self._cow(node.page)
            if cow is not None:
                pages.append(cow)
                hit += m
                self.stats.partial_hits += 1
                self.stats.cow_pages += 1
                if self.bus is not None:
                    self.bus.emit("prefix_cow", req_id=rid,
                                  replica=self.replica, tokens=m)
        if hit == 0:
            self.stats.misses += 1
            return 0
        pool.page_table[rid] = pages
        pool.lengths[rid] = hit
        self.stats.hits += 1
        self.stats.hit_tokens += hit
        return hit

    def _cow(self, src: int) -> Optional[int]:
        """Copy a cached page into a fresh one the request will own,
        reclaiming an unreferenced cached page if the pool is empty."""
        pool = self.pool
        if not pool.free_pages and self.reclaim(1) == 0:
            return None
        return pool.cow_page(src)

    def publish(self, rid: int, tokens, upto: int) -> int:
        """Index ``rid``'s pages covering ``tokens[:upto]`` (full pages
        only); returns the number of newly shared pages.

        Dedupe on publish: where the span is already indexed (two requests
        with one prompt prefilled at the same time, so neither could hit
        the other's pages), the request's duplicate private pages are
        dropped now and its table remapped onto the indexed ones (one
        extra refcount each).  Remapped pages lie below the request's
        prefilled watermark, so decode (which writes at ``>= upto``)
        never touches them."""
        pool = self.pool
        table = pool.page_table.get(rid)
        if not table:
            return 0
        pg = self.index.page_size
        upto = min(upto, len(table) * pg, len(tokens))
        created = self.index.insert(tokens, upto, lambda i: table[i])
        for node in created:
            pool.incref(node.page)
        full, _ = self.index.match(tokens, upto, touch=False)
        deduped = 0
        for i, node in enumerate(full):
            if i < len(table) and table[i] != node.page:
                pool.incref(node.page)
                old = table[i]
                table[i] = node.page
                pool.decref(old)
                deduped += 1
        if deduped:
            self.stats.deduped_pages += deduped
            if self.bus is not None:
                self.bus.emit("prefix_dedupe", req_id=rid,
                              replica=self.replica, pages=deduped)
        self.stats.inserted_pages += len(created)
        if self.tier is not None and created:
            # export the span to the cluster tier, which fetches only the
            # pages it does not hold (re-publishing a prefix the cluster
            # knows copies nothing)
            def fetch_page(i):
                return pool.k[:, table[i]], pool.v[:, table[i]]
            self.tier.publish(tokens, upto, fetch_page)
        return len(created)

    def reclaim(self, n_pages: int) -> int:
        """Priority-aware LRU eviction: free up to ``n_pages`` cached
        pages no request references (refcount 1 = held by the index
        alone)."""
        freed = self.index.evict_lru(
            n_pages, can_evict=lambda p: self.pool.refs.get(p, 0) == 1)
        for p in freed:
            self.pool.decref(p)
        self.stats.evicted_pages += len(freed)
        if freed and self.bus is not None:
            self.bus.emit("prefix_evict", replica=self.replica,
                          pages=len(freed))
        return len(freed)

    def drop_all(self) -> int:
        """Release every index reference (shutdown, tests)."""
        pages = self.index.clear()
        for p in pages:
            self.pool.decref(p)
        self.stats.evicted_pages += len(pages)
        return len(pages)

    def held_pages(self) -> Tuple[int, int]:
        """(pages the index holds, pages reclaimable right now)."""
        held = self.index.n_pages
        reclaimable = sum(1 for n in self.index.nodes
                          if self.pool.refs.get(n.page, 0) == 1)
        return held, reclaimable


# ------------------------------------------------ dense (copy-based) cache

class DensePrefixCache:
    """Shared-prefix cache for the dense slotted backend.

    Dense lanes cannot alias pages, so the cache owns a private page store
    ``k``/``v`` (L, capacity, page, KVH, hd) on ``device``; a hit copies
    the cached pages into the request's stripe (:meth:`fetch`) and a
    publish copies stripe rows into the store (:meth:`publish`).  The
    copies are device index copies: the gain is the prefill compute the
    hit skips.  Capacity-bounded: a publish past ``capacity_pages``
    LRU-evicts (every store page is unreferenced by requests by
    construction).  The reference pads each copy to a power-of-two page
    count so that XLA compiles few programs; eager torch has no such
    cost, so the copies here move exactly the pages they name.
    """

    def __init__(self, num_layers: int, num_kv_heads: int, head_dim: int,
                 page_size: int, capacity_pages: int, dtype, device=None):
        self.page_size = page_size
        self.capacity = max(capacity_pages, 1)
        shape = (num_layers, self.capacity, page_size, num_kv_heads,
                 head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self.free_pages: List[int] = list(range(self.capacity))
        self.index = RadixPageIndex(page_size)
        self.stats = PrefixCacheStats()
        self.bus = None                # observability EventBus (None = off)
        self.replica = ""
        self.tier = None               # cluster HostKVTier (None = off)

    def probe(self, tokens) -> int:
        if not tokens:
            return 0
        return min(self.index.probe_len(tokens), len(tokens) - 1)

    def fetch(self, tokens):
        """``(hit_len, k (L, T, KVH, hd), v)`` for the longest cached
        prefix of ``tokens`` (capped at ``len(tokens) - 1``), ``T`` = the
        matched pages' positions; ``(0, None, None)`` on a miss.  A
        partial-page match needs no copy-on-write: the gathered copy is
        already private.  Positions past ``hit_len`` carry the cached
        page's other tokens, which the request's chunked prefill
        overwrites before anything attends there."""
        cap = len(tokens) - 1
        if cap <= 0:
            return 0, None, None
        full, partial = self.index.match(tokens, cap)
        hit = len(full) * self.page_size
        pages = [n.page for n in full]
        if partial is not None:
            node, m = partial
            pages.append(node.page)
            hit += m
            self.stats.partial_hits += 1
        if hit == 0:
            self.stats.misses += 1
            return 0, None, None
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.k.device)
        L, _, pg, KVH, hd = self.k.shape
        k = self.k.index_select(1, idx).reshape(L, len(pages) * pg, KVH, hd)
        v = self.v.index_select(1, idx).reshape(L, len(pages) * pg, KVH, hd)
        self.stats.hits += 1
        self.stats.hit_tokens += hit
        return hit, k, v

    def publish(self, tokens, upto: int, k_src, v_src) -> int:
        """Copy the full pages of ``k_src``/``v_src`` (a lane's stripes,
        (L, Smax, KVH, hd)) covering ``tokens[:upto]`` into the store and
        index them; returns the number of new pages."""
        pg = self.page_size
        upto = min(upto, k_src.shape[1], len(tokens))
        n_full = upto // pg
        # make room before the insert walk: evicting mid-walk could pick
        # a node this insert just created (the chain's parent) and orphan
        # the rest of the chain.  Matching first also LRU-touches the
        # existing prefix so that eviction prefers other branches
        matched, _ = self.index.match(tokens, upto)
        missing = max(n_full - len(matched), 0)
        if missing > len(self.free_pages):
            self._evict(missing - len(self.free_pages))
            matched, _ = self.index.match(tokens, upto)
        alloc: Dict[int, int] = {}
        for i in range(len(matched), n_full):
            if not self.free_pages:
                break
            alloc[i] = self.free_pages.pop()
        if alloc:
            dev = self.k.device
            rows = torch.as_tensor(list(alloc.values()), dtype=torch.long,
                                   device=dev)
            pos = (torch.as_tensor(list(alloc), dtype=torch.long,
                                   device=dev)[:, None] * pg
                   + torch.arange(pg, device=dev)[None]).reshape(-1)
            for store, src in ((self.k, k_src), (self.v, v_src)):
                pages = src.index_select(1, pos).reshape(
                    src.shape[0], len(alloc), pg, *src.shape[2:])
                store.index_copy_(1, rows, pages.to(store.dtype))
        created = self.index.insert(tokens, upto, alloc.get)
        used = {n.page for n in created}
        for page in alloc.values():      # chain clipped early: hand back
            if page not in used:
                self.free_pages.append(page)
        self.stats.inserted_pages += len(created)
        if self.tier is not None and created:
            # export the span to the cluster tier (it fetches only the
            # pages it does not hold)
            def fetch_page(i):
                return (k_src[:, i * pg:(i + 1) * pg],
                        v_src[:, i * pg:(i + 1) * pg])
            self.tier.publish(tokens, upto, fetch_page)
        return len(created)

    def _evict(self, n: int) -> int:
        freed = self.index.evict_lru(n, can_evict=lambda p: True)
        self.free_pages.extend(freed)
        self.stats.evicted_pages += len(freed)
        if freed and self.bus is not None:
            self.bus.emit("prefix_evict", replica=self.replica,
                          pages=len(freed))
        return len(freed)

    def reclaim(self, n_pages: int) -> int:
        """The store's pages are private to the cache: reclaiming them
        frees nothing the engine's lanes can use, so an outside reclaim
        is a no-op (the capacity eviction of :meth:`publish` still
        runs)."""
        return 0

    def drop_all(self) -> int:
        pages = self.index.clear()
        self.free_pages.extend(pages)
        self.stats.evicted_pages += len(pages)
        return len(pages)

    def held_pages(self) -> Tuple[int, int]:
        held = self.index.n_pages
        return held, held


# ------------------------------------------------------ simulator twin

class SimPrefixIndex:
    """Token-only prefix index for the discrete-event simulator: same
    page-granular radix and LRU capacity semantics, synthetic page ids
    (there is no storage to manage — only hit lengths and eviction
    pressure need modeling)."""

    def __init__(self, page_size: int, capacity_pages: int):
        self.index = RadixPageIndex(page_size)
        self.capacity = max(capacity_pages, 1)
        self._ids = itertools.count()
        self.stats = PrefixCacheStats()
        self.bus = None                # observability EventBus (None = off)
        self.replica = ""

    def probe(self, tokens) -> int:
        if not tokens:
            return 0
        return min(self.index.probe_len(tokens), len(tokens) - 1)

    def insert(self, tokens, upto: int) -> int:
        created = self.index.insert(tokens, upto,
                                    lambda i: next(self._ids))
        over = self.index.n_pages - self.capacity
        if over > 0:
            evicted = self.index.evict_lru(over, can_evict=lambda p: True)
            self.stats.evicted_pages += len(evicted)
            if evicted and self.bus is not None:
                self.bus.emit("prefix_evict", replica=self.replica,
                              pages=len(evicted))
        self.stats.inserted_pages += len(created)
        return len(created)

    def hit(self, tokens, cap: int) -> int:
        """A *served* hit (unlike probe, it LRU-touches the match)."""
        if not tokens:
            return 0
        h = min(self.index.probe_len(tokens, touch=True),
                len(tokens) - 1, max(cap, 0))
        if h > 0:
            self.stats.hits += 1
            self.stats.hit_tokens += h
        else:
            self.stats.misses += 1
        return h
