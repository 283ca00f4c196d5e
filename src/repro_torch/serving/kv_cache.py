"""The KV / state backends of the serving engine: the paged KV page pool
with its paged backend, and the dense slotted backend.

Three layers live here, as in ``repro.serving.kv_cache``:

  * :class:`PagedKVPool` — the vLLM-style block allocator (physical pages +
    refcounted per-request page tables) ALISE's request-level swapping
    and the shared-prefix cache sit on: a page may be mapped into several
    page tables and the prefix index at once.  The pool tensors live on
    the device and are written **in place** (``index_put_`` /
    ``index_copy_``) where the JAX package rebuilt them functionally.
  * :class:`PagedKVBackend` — the engine-facing device KV residency:
    decode-lane (slot) assignment, resumable chunked prefill into pages,
    request-granular offload/upload blobs, and ``decode()`` — one fused
    step per iteration that samples and decides termination on the device
    (one small ``(tokens, reasons)`` copy to the host).
  * :class:`DenseKVBackend` — ``model.init_cache(max_slots, max_seq_len)``
    with one slice per lane: for the attention family a full
    ``max_seq_len`` K/V stripe per lane (resumable chunked prefill, a
    whole prompt as one chunk when no chunk size is set; fused or per-slot
    decode), for the ``ssm`` family a request's constant-size conv and SSM
    state, for the hybrid family both (monolithic prefill).  It is
    written in place too.

Both attention backends also run packed prefill (``prefill_pack``: up to
``prefill_pack_width`` requests' chunks of one bucket as the rows of one
call) and the shared-prefix cache (``prefix_*``: the paged backend aliases
pool pages, the dense one copies through a private page store;
``serving/prefix_cache.py``).

The fused decode step, the prefill chunks of the engine's bucket menu and
the packs of that menu run through
:class:`~repro_torch.serving.step_graphs.StepGraphs`: on the card each is
a CUDA graph captured at its key's first use (the engine's warmup makes
that happen before serving) and replayed, with its integer inputs staged
by one host-to-device copy.  A pack always has ``prefill_pack_width``
rows (padding rows compute garbage that is dropped), so that the flash
kernel's split plan and the weight products see one shape per bucket.
Other chunks (a whole prompt when no chunk size is set), swaps, prefix
copies and the per-slot decode run eagerly.

With ``spec_k > 0`` the attention backends also run the fused verify-k
step (``decode_verify``: the fed token and ``spec_k`` drafts scored per
lane in one call, accepted on the device), as the step graph
``("verify",)``.  The dense backend commits accepted positions on the
device by advancing ``lengths``; the paged one writes speculative
positions past a lane's last page to the lane's own scratch page and,
after the sync, promotes that page into the page table when the accepted
span reaches it.

Offload/upload of K/V run the INT8 ``kv_quant`` kernels on the device when
``quantize_offload`` is set (paper Eq. 8): the host link carries the INT8
payload plus float32 per-row scales and zeros.  An offload is one kernel
pass over the K/V store where it lies (a request's pages, a lane's stripe
span) into one staging buffer, one copy of it into pinned host memory and
one stream sync (:func:`quantize_kv_store`).  Conv and SSM state cross
raw, as in the reference: INT8 applies to K/V only.

Both attention backends land a cluster-tier import (``tier_fill``: pages
of ``serving/kv_tier.HostKVTier`` another replica published) in their
prefix cache, eagerly, like swaps: the paged backend writes only the
pages past its local radix match into fresh pool pages and indexes them,
the dense one publishes the payload into its private store.  Both write
the device storage in place, so that the captured step graphs, which
hold its addresses, see the imported pages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.kv_quant import kv_dequantize, kv_quantize_store
from repro_torch.kernels.kv_quant.ops import store_layout, store_views
from repro_torch.serving.prefix_cache import (DensePrefixCache,
                                              PagedPrefixCache)
from repro_torch.serving.step_graphs import StepGraphs, pack, unpack
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

    Pages are refcounted so that the shared-prefix cache can alias one
    physical page into many page tables and its own index: every table
    entry and every index entry holds one reference, and a page returns to
    the free list when its count reaches zero.  ``k``/``v`` are device
    tensors (L, num_pages, page, KVH, d) updated in place.
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

    def incref(self, page: int) -> None:
        self.refs[page] = self.refs.get(page, 0) + 1

    def decref(self, page: int) -> int:
        """Drop one reference; a page at zero returns to the free list."""
        n = self.refs.get(page, 0) - 1
        if n <= 0:
            self.refs.pop(page, None)
            self.free_pages.append(page)
            return 0
        self.refs[page] = n
        return n

    def cow_page(self, src: int) -> int:
        """Copy-on-write: a fresh page (refcount 1) holding a copy of
        ``src``'s K/V in every layer, for the caller to own alone."""
        dst = self.take_page()
        self.k[:, dst].copy_(self.k[:, src])
        self.v[:, dst].copy_(self.v[:, src])
        return dst

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

    def utilization(self) -> float:
        return 1.0 - len(self.free_pages) / self.cfg.num_pages

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

def quantize_kv_store(xs, shape, pages=None, length=None,
                      pinned: bool = True) -> list:
    """INT8 blobs ``(q, lam, z, shape)`` of one or two KV stores (K and V)
    with the ``kv_quantize`` kernel's store entry, which reads them where
    they lie in their own dtype
    (``kernels/kv_quant/ops.kv_quantize_store``: ``pages`` a long tensor
    selecting axis 1, rows at positions past ``length`` quantized as zero
    rows).  ``q`` is (rows, d) int8, ``lam``/``z`` (rows, 1) float32 on
    the CPU, and ``shape`` the shape the rows are read back into.  On the
    card the kernel writes one staging buffer, and one copy moves it to
    the host: a swap's (``pinned``) is a non-blocking copy into pinned
    memory and one stream sync, so that its upload copies from pinned
    memory too; a long-lived blob (the KV tier's page) goes to ordinary
    memory.  The blobs are views of that host buffer.  On the CPU they
    are the plain version's tensors."""
    triples, staging = kv_quantize_store(xs, pages, length)
    if staging is not None:
        if pinned:
            host = torch.empty(staging.shape, dtype=torch.uint8,
                               pin_memory=True)
            host.copy_(staging, non_blocking=True)
            torch.cuda.current_stream(staging.device).synchronize()
        else:
            host = staging.cpu()
        triples = store_views(host, *triples[0][0].shape, len(triples))
    return [(q, lam, z, tuple(shape)) for q, lam, z in triples]


def quantize_kv_device(x) -> tuple:
    """INT8-quantize a KV tensor of rank 1 to 5 on its device (one row per
    (token, head) over the last axis, which must be contiguous) and move it
    to the host: :func:`quantize_kv_store` of ``x`` alone.  Returns
    ``(q, lam, z, shape)``."""
    return quantize_kv_store((x,), x.shape)[0]


def reserve_pinned(nbytes: int) -> int:
    """Pin one host block of each power-of-two size from 4 KiB up to the
    first at or above ``nbytes`` and free them into PyTorch's caching host
    allocator, which rounds pinned requests up to a power of two: the
    first INT8 blob of each size then finds pinned memory waiting, where
    page-locking its own would take longer than the copy it serves.
    Returns the bytes those blocks hold."""
    sizes = [4096]
    while sizes[-1] < nbytes:
        sizes.append(2 * sizes[-1])
    blocks = [torch.empty(n, dtype=torch.uint8, pin_memory=True)
              for n in sizes]
    del blocks
    return sum(sizes)


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
    prefix_cache: bool = False     # cross-request shared-prefix KV cache
    prefix_cache_pages: int = 0    # dense backend: private store capacity
                                   # (0 = one full batch of stripes)
    seed: int = 0
    prefill_buckets: Optional[Tuple[int, ...]] = None
    # fixed, sorted menu of chunk-shape buckets: chunk dispatch shapes are
    # rounded up to the nearest entry (else pow2 buckets, min 8)
    graph_buckets: Tuple[int, ...] = ()
    # chunk and pack buckets that run as step graphs (the engine's warmed
    # menu)
    prefill_pack_width: int = 4    # rows of every packed-prefill call
    cuda_graphs: bool = True       # capture the steps on a CUDA device
    spec_k: int = 0                # speculative verify-k draft width


class KVBackend:
    """Engine-facing device KV residency + the fused decode step.

    Decode lanes ("slots") give the decode batch its fixed shape; the
    storage is implementation-defined.  ``decode()`` is the hot path: one
    step covering embedding, the layer stack, KV writes, attention,
    sampling and termination — the engine copies a single small
    ``(tokens, reasons)`` pair to the host per iteration.  ``graphs``
    runs it and the menu's chunks and packs as step graphs.  ``prefix`` is
    the shared-prefix cache, or None when it is off.
    """

    def __init__(self, model, cfg: KVBackendConfig):
        if model.ssm_state_dtype != "float32":
            # the step writes its float32 state into the lanes in place
            raise ValueError(f"ssm_state_dtype={model.ssm_state_dtype!r}: "
                             "a serving backend holds the state in float32")
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self.slot_req: List[Optional[int]] = [None] * cfg.max_slots
        self.graphs = StepGraphs(self.device, cfg.cuda_graphs)
        self.prefix = None

    # --------------------------------------------------------------- lanes
    def slot_of(self, rid: int) -> Optional[int]:
        try:
            return self.slot_req.index(rid)
        except ValueError:
            return None

    def has(self, rid: int) -> bool:
        return rid in self.slot_req

    def _k_store(self):
        """The K store (the page pool's or the dense cache's), or None
        where the model keeps no K/V."""
        raise NotImplementedError

    def reserve_swap_memory(self) -> int:
        """With ``quantize_offload`` on the card, pin host memory for the
        INT8 swap blobs before the first swap (:func:`reserve_pinned` up
        to the blob of a lane of ``max_seq_len`` tokens).  A CUDA graph
        capture empties PyTorch's pinned host cache, so this runs after
        the last one (the engine's warmup ends with it).  Returns the
        bytes pinned (0 on the CPU, raw or without K/V)."""
        k = self._k_store()
        if (not self.cfg.quantize_offload or k is None
                or k.device.type != "cuda"):
            return 0
        rows = k.shape[0] * self.cfg.max_seq_len * k.shape[-2]
        return reserve_pinned(store_layout(rows, k.shape[-1], 2)[1])

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

    @staticmethod
    def _pow2_bucket(n: int) -> int:
        """The power of two covering ``n`` (min 8)."""
        return max(8, 1 << (max(n, 1) - 1).bit_length())

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
        return self._pow2_bucket(n)

    def _t(self, a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _run_chunk(self, key: tuple, staged: np.ndarray, step, neutral):
        """A chunk or pack step: a step graph when its bucket is on the
        graph menu, else an eager call on the staged input.  Returns the
        logits (rows, V), copied out of the graph's pool."""
        if key[1] in self.cfg.graph_buckets:
            return self.graphs.run(key, staged, step, neutral).clone()
        return step(torch.from_numpy(staged).to(self.device))

    def decode(self, params, tokens, active, new_gen, new_ctx, true_len,
               rids):
        """One fused iteration -> (sampled (B,), reason (B,)) numpy, as the
        step graph ``("decode",)`` over the staged :meth:`_decode_inputs`
        (the backend's ``_decode_step``).  Only active lanes' state
        advances."""
        staged = self._decode_inputs(tokens, active, new_gen, new_ctx,
                                     true_len, rids)
        out = self.graphs.to_host(self.graphs.run(
            ("decode",), staged, lambda buf: self._decode_step(params, buf),
            self._neutral_decode))
        return out[0], out[1]

    def _decode_inputs(self, tokens, active, new_gen, new_ctx, true_len,
                       rids) -> np.ndarray:
        """A decode step's staged sampling fields (the dense step's whole
        input; the paged step's tail)."""
        return pack(tokens, active, new_gen, new_ctx, true_len, rids)

    # ------------------------------------------------- speculative decode
    def supports_spec_decode(self) -> bool:
        """Whether :meth:`decode_verify` is available (``spec_k > 0`` and
        the model family has the verify-k step)."""
        return self.cfg.spec_k > 0 and self.model.supports_spec_decode()

    def decode_verify(self, params, tokens, n_drafts, active, base_gen,
                      base_ctx, true_len, rids):
        """One fused verify-k iteration as the step graph ``("verify",)``.

        ``tokens``: (B, spec_k+1), column 0 each lane's fed token, columns
        1..k its drafts (zero-padded past ``n_drafts[b]``; padding never
        matches); ``base_gen``/``base_ctx``: generated count / context
        length *before* the step.  Returns ``(samples (B, spec_k+1),
        n_emit (B,), reason (B,))`` numpy, one copy to the host: the caller
        accepts ``samples[b, :n_emit[b]]`` and applies ``reason[b]`` to the
        last of them.  Each active lane's K/V state advances by exactly
        ``n_emit[b]`` positions; inactive lanes' state is untouched."""
        K1 = self.cfg.spec_k + 1
        staged = self._verify_inputs(tokens, n_drafts, active, base_gen,
                                     base_ctx, true_len, rids)
        out = self.graphs.to_host(self.graphs.run(
            ("verify",), staged, lambda buf: self._verify_step(params, buf),
            self._neutral_verify))
        n_emit = out[:, K1]
        self._commit_verify(n_emit, active)
        return out[:, :K1], n_emit, out[:, K1 + 1]

    def _verify_inputs(self, tokens, n_drafts, active, base_gen, base_ctx,
                       true_len, rids) -> np.ndarray:
        """A verify step's staged tokens and lane scalars (the dense
        step's whole input; the paged step's tail)."""
        return pack(tokens, n_drafts, active, base_gen, base_ctx, true_len,
                    rids)

    def _verify_views(self, buf):
        """(tokens (B, K1), n_drafts, active (B,) bool, base_gen,
        base_ctx, true_len, rids) views of :meth:`_verify_inputs`'s part
        of a step's input."""
        B, K1 = self.cfg.max_slots, self.cfg.spec_k + 1
        toks, nd, act, *rest = unpack(buf, (B, K1), *[(B,)] * 6)
        return (toks, nd, act != 0, *rest)

    def _neutral_verify(self) -> np.ndarray:
        """A verify input that writes no live state: every lane
        inactive."""
        B, K1 = self.cfg.max_slots, self.cfg.spec_k + 1
        z = np.zeros((B,), np.int32)
        return self._verify_inputs(np.zeros((B, K1), np.int32), z, z, z, z,
                                   z, z)

    @staticmethod
    def _verify_out(s, n_emit, reason):
        """The verify step's one output: (B, K1 + 2) int32 of the samples,
        then ``n_emit`` and ``reason``."""
        return torch.cat([s, n_emit[:, None], reason[:, None]], dim=1)

    def _commit_verify(self, n_emit, active) -> None:
        """Host-side bookkeeping after a verify step's sync (none on the
        dense backend: its step advanced ``lengths`` on the device)."""

    def _decode_views(self, buf):
        """(tokens (B, 1), active (B,) bool, new_gen, new_ctx, true_len,
        rids) views of :meth:`_decode_inputs`'s part of a step's input."""
        B = self.cfg.max_slots
        toks, act, *rest = unpack(buf, (B, 1), *[(B,)] * 5)
        return (toks, act != 0, *rest)

    def _neutral_decode(self):
        """A decode input that writes no live state: every lane
        inactive."""
        B = self.cfg.max_slots
        z = np.zeros((B,), np.int32)
        return self._decode_inputs(np.zeros((B, 1), np.int32), z.astype(bool),
                                   z, z, z, z)

    def chunk_pages_shortfall(self, rid: int, end: int) -> int:
        """Physical pages missing to extend ``rid``'s KV coverage to
        ``end`` tokens (always 0 without a page pool)."""
        return 0

    def pages_shortfall(self, rids: List[int]) -> int:
        """Physical pages missing to decode one token for each of ``rids``
        (always 0 without a page pool)."""
        return 0

    # ------------------------------------------------------ packed prefill
    def supports_pack(self) -> bool:
        """Whether :meth:`prefill_pack` is available (the model packs)."""
        return self.model.supports_prefill_pack()

    def prefill_pack(self, params, items: Sequence[Tuple[int, List[int],
                                                         int]],
                     bucket: int = 0):
        """Run several requests' prefill chunks as one call of
        ``prefill_pack_width`` rows.

        ``items``: up to ``prefill_pack_width`` tuples ``(rid, tokens,
        start)`` of distinct requests, each chunk at most ``bucket``
        tokens (0: the bucket of the longest).  A request's first chunk
        claims a lane.  A pack of a menu bucket runs as the step graph
        ``("pack", bucket)``; the rows past the members are padding.
        Returns each member's last-position logits (len(items), V), in
        item order."""
        N = self.cfg.prefill_pack_width
        if not 0 < len(items) <= N:
            raise ValueError(f"a pack of {len(items)} members, width {N}")
        longest = max(len(t) for _, t, _ in items)
        Cb = bucket or self._chunk_bucket(longest)
        if longest > Cb:
            raise ValueError(f"a {longest}-token member exceeds the pack "
                             f"bucket {Cb}")
        staged = self._pack_inputs(items, Cb)
        logits = self._run_chunk(
            ("pack", Cb), staged,
            lambda buf: self._pack_step(params, buf, Cb),
            lambda: self._pack_inputs([], Cb))
        return logits[:len(items)]

    # ------------------------------------------------ shared-prefix cache
    def prefix_probe(self, tokens) -> int:
        """Expected cached-prefix hit for ``tokens`` (a pricing hint;
        touch-free, so probes cannot skew the LRU)."""
        if self.prefix is None or not tokens:
            return 0
        return self.prefix.probe(list(tokens))

    def prefix_acquire(self, rid: int, tokens) -> int:
        """Materialize the longest cached prefix of ``tokens`` for ``rid``
        (claiming its lane) and return the hit length, the request's
        starting ``prefilled`` watermark (0: a miss, or the cache off)."""
        return 0

    def prefix_publish(self, rid: int, tokens, upto: int) -> int:
        """Share ``rid``'s materialized KV of ``tokens[:upto]`` (full
        pages only) into the index; returns the pages newly shared."""
        return 0

    def prefix_reclaim(self, n_pages: int) -> int:
        """Evict up to ``n_pages`` cached pages no request references
        (LRU): the first victims of a page shortfall, ahead of any
        resident request's pages."""
        if self.prefix is None:
            return 0
        return self.prefix.reclaim(n_pages)

    def prefix_pages(self) -> Tuple[int, int]:
        """(pages the cache holds, pages reclaimable now)."""
        if self.prefix is None:
            return (0, 0)
        return self.prefix.held_pages()

    def prefix_stats(self):
        return None if self.prefix is None else self.prefix.stats


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
        if cfg.spec_k >= cfg.page_size:
            raise ValueError(
                f"spec_k ({cfg.spec_k}) must be < page_size "
                f"({cfg.page_size}) so a lane's speculative span never "
                "needs more than its one scratch page")
        acfg = model.cfg
        spec_on = self.supports_spec_decode()
        self.max_pages_per_seq = cfg.max_seq_len // cfg.page_size
        self.pool = PagedKVPool(PagedKVConfig(
            # +1 sacrificial scratch page, plus one private scratch page
            # per lane with verify-k (speculative K/V lands there until
            # accepted)
            num_pages=num_pages + 1 + (cfg.max_slots if spec_on else 0),
            page_size=cfg.page_size, num_kv_heads=acfg.num_kv_heads,
            head_dim=acfg.hd, num_layers=acfg.num_layers,
            dtype=model.kv_dtype), device=self.device)
        self.scratch_page = self.pool.reserve_scratch()
        # per-lane speculative scratch pages: a commit moves one into the
        # request's page table and takes a fresh one from the pool
        self.lane_scratch: List[int] = (
            [self.pool.reserve_scratch() for _ in range(cfg.max_slots)]
            if spec_on else [])
        if cfg.prefix_cache:
            self.prefix = PagedPrefixCache(self.pool, cfg.page_size)

    def _kv(self) -> dict:
        return {"k": self.pool.k, "v": self.pool.v}

    def _k_store(self):
        return self.pool.k

    def _claim(self, rid: int, slot: Optional[int] = None) -> None:
        """Give ``rid`` a lane (``slot`` when given, else the first free
        one) and an empty page table if it has none; chunks extend it."""
        slot = self.free_slot() if slot is None else slot
        if slot is None or self.slot_req[slot] is not None:
            raise RuntimeError("no free decode lane: the caller must "
                               "check free_slot()")
        self.slot_req[slot] = rid
        if rid not in self.pool.page_table:
            self.pool.allocate(rid, 0)

    # ---------------------------------------------------------- interface
    def prefill_chunk(self, params, rid: int, tokens: List[int],
                      start: int, slot: Optional[int] = None):
        """Run one resumable prefill chunk for ``rid``: write KV for
        absolute positions ``[start, start+len(tokens))`` into its pages
        (claiming a lane on the first chunk: ``slot`` when given, else the
        first free one) and return the chunk's last-position logits (1, V).
        A chunk of a menu bucket runs as the step graph ``("chunk",
        bucket)``: its pages are gathered into the graph's own memory, so
        one graph serves every lane."""
        if self.slot_of(rid) is None:       # first chunk: claim a lane
            self._claim(rid, slot)
        C = len(tokens)
        # grow page coverage to the chunk's end (caller checked
        # chunk_pages_shortfall); a chunk may start/end mid-page
        self.pool.extend_to(rid, start + C)
        pt = self.pool.page_table[rid]
        Cb = self._chunk_bucket(C)
        return self._run_chunk(
            ("chunk", Cb), self._chunk_inputs(pt, tokens, start, Cb),
            lambda buf: self._chunk_step(params, buf, Cb),
            lambda: self._chunk_inputs([], [], 0, Cb))

    def _chunk_inputs(self, pt: List[int], tokens: List[int], start: int,
                      Cb: int) -> np.ndarray:
        """A chunk's staged input: its block table, tokens padded to
        ``Cb``, each row's physical page and offset (padded rows at the
        scratch page), ``start`` and the token count.  No pages and no
        tokens give a chunk that writes only the scratch page."""
        return pack(*self._chunk_fields(pt, tokens, start, Cb))

    def _chunk_fields(self, pt: List[int], tokens: List[int], start: int,
                      Cb: int) -> tuple:
        """:meth:`_chunk_inputs`'s arrays, in its order."""
        C, pg = len(tokens), self.cfg.page_size
        toks = np.zeros((Cb,), np.int32)
        toks[:C] = tokens
        wp = np.full((Cb,), self.scratch_page, np.int32)
        wo = np.arange(Cb, dtype=np.int32) % pg     # harmless scratch offsets
        pos = start + np.arange(C)
        wp[:C] = np.asarray(pt, np.int32)[pos // pg]
        wo[:C] = pos % pg
        tables = np.full((self.max_pages_per_seq,), self.scratch_page,
                         np.int32)
        tables[:len(pt)] = pt
        return tables, toks, wp, wo, start, C

    def _pack_inputs(self, items, Cb: int) -> np.ndarray:
        """A pack's staged input: :meth:`_chunk_fields` of each member
        (claiming lanes and growing page coverage to each chunk's end:
        the caller checked the shortfall), then of padding rows (no pages,
        no tokens: they write only the scratch page), stacked field by
        field."""
        rows = []
        for rid, tokens, start in items:
            if self.slot_of(rid) is None:   # first chunk: claim a lane
                self._claim(rid)
            self.pool.extend_to(rid, start + len(tokens))
            rows.append(self._chunk_fields(self.pool.page_table[rid],
                                           tokens, start, Cb))
        pad = self._chunk_fields([], [], 0, Cb)
        rows += [pad] * (self.cfg.prefill_pack_width - len(items))
        return pack(*(np.stack([np.asarray(r[f]) for r in rows])
                      for f in range(len(pad))))

    def _pack_step(self, params, buf, Cb: int):
        N, maxp = self.cfg.prefill_pack_width, self.max_pages_per_seq
        tables, toks, wp, wo, start, n = unpack(
            buf, (N, maxp), (N, Cb), (N, Cb), (N, Cb), (N,), (N,))
        return self.model.paged_prefill_pack(params, self._kv(), toks,
                                             tables, wp, wo, start, n)

    def _chunk_step(self, params, buf, Cb: int):
        tables, toks, wp, wo, start, n = unpack(
            buf, (1, self.max_pages_per_seq), (1, Cb), (Cb,), (Cb,), (1,),
            (1,))
        return self.model.paged_prefill_chunk(params, self._kv(), toks,
                                              tables, wp, wo, start, n)

    def chunk_pages_shortfall(self, rid: int, end: int) -> int:
        have = len(self.pool.page_table.get(rid, []))
        return max(0, self.pool.pages_needed(end) - have
                   - len(self.pool.free_pages))

    def prefix_acquire(self, rid: int, tokens) -> int:
        """Zero-copy hit: map the cached prefix's pages into ``rid``'s page
        table (a reference each; a partial page copied on write) and claim
        its lane, so chunked prefill resumes at the hit watermark."""
        if (self.prefix is None or self.has(rid)
                or rid in self.pool.page_table):
            return 0
        slot = self.free_slot()
        if slot is None:
            return 0
        hit = self.prefix.acquire(rid, list(tokens))
        if hit:
            self.slot_req[slot] = rid
        return hit

    def prefix_publish(self, rid: int, tokens, upto: int) -> int:
        if self.prefix is None:
            return 0
        return self.prefix.publish(rid, list(tokens), upto)

    def tier_fill(self, tokens, handle) -> int:
        """Land a cluster-tier import (a pinned ``TierHandle``) in the
        local prefix cache.  Only the pages past the local radix match
        transfer; cached pages no request references are reclaimed when
        the pool is short, and the import is clipped to the free pages.
        Each lands in a fresh pool page, written in place, and enters the
        index owning its single refcount (index-held, like a published
        page); the caller's ``prefix_acquire`` then maps them.  Returns
        the token watermark now cached locally."""
        if self.prefix is None or handle is None:
            return 0
        pg = self.cfg.page_size
        toks = list(tokens)[:handle.tokens]
        n = len(toks) // pg
        if n <= 0:
            return 0
        full, _ = self.prefix.index.match(toks, n * pg, touch=False)
        have = len(full)
        if have >= n:
            return have * pg        # the local cache covers the import
        short = (n - have) - len(self.pool.free_pages)
        if short > 0:
            self.prefix_reclaim(short)
        n = min(n, have + len(self.pool.free_pages))
        if n <= have:
            return have * pg        # pool too tight to land the import
        mats = handle.materialize(self.pool.k.dtype, self.device, have, n)
        fresh = [self.pool.take_page() for _ in range(n - have)]
        idx = torch.as_tensor(fresh, dtype=torch.long, device=self.device)
        for j, key in enumerate(("k", "v")):
            getattr(self.pool, key).index_copy_(
                1, idx, torch.stack([m[j] for m in mats], dim=1))
        created = self.prefix.index.insert(toks, n * pg,
                                           lambda i: fresh[i - have])
        used = {node.page for node in created}
        for p in fresh:             # chain clipped early: hand pages back
            if p not in used:
                self.pool.decref(p)
        self.prefix.stats.inserted_pages += len(created)
        return n * pg

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
        stored: dict = {"lengths": length}
        if self.cfg.quantize_offload:
            k = self.pool.k
            shape = (k.shape[0], len(pages), *k.shape[2:])
            stored["k"], stored["v"] = (("q8", b) for b in quantize_kv_store(
                (k, self.pool.v), shape, pages=idx, length=length))
        else:
            pg = self.cfg.page_size
            pos = torch.arange(len(pages) * pg, device=self.device).reshape(
                len(pages), pg)[None, :, :, None, None]
            for key in ("k", "v"):
                arr = getattr(self.pool, key)[:, idx]
                arr = torch.where(pos < length, arr, torch.zeros_like(arr))
                stored[key] = ("raw", arr.cpu())
        self.clear(rid)
        return stored

    def upload(self, rid: int, blob: dict) -> None:
        """Restore an offloaded blob into fresh pages and a free lane
        (dequantized to float32 on the device, then cast to the pool's
        dtype).  An exact blob that names its ``tokens`` rejoins the
        shared-prefix pool: the pages of its prefix still in the index
        are mapped in again (a reference each) instead of forked into
        private copies, and only the rest is copied."""
        slot = self.free_slot()
        if slot is None:
            raise RuntimeError("no free decode lane for upload")
        length = blob["lengths"]
        toks = blob.get("tokens")
        shared: List[int] = []
        if toks is not None and self.prefix is not None:
            full, _ = self.prefix.index.match(
                list(toks), min(length, len(toks)), touch=False)
            shared = [n.page for n in full]
            for p in shared:
                # pin before any reclaim: an index-only page is exactly
                # what prefix_reclaim would evict
                self.pool.incref(p)
        n_need = self.pool.pages_needed(length)
        short = n_need - len(shared) - len(self.pool.free_pages)
        if short > 0:       # cached pages no request references go first
            self.prefix_reclaim(short)
        if n_need - len(shared) > len(self.pool.free_pages):
            for p in shared:
                self.pool.decref(p)
            raise RuntimeError(
                f"page pool exhausted on upload: need "
                f"{n_need - len(shared)}, free {len(self.pool.free_pages)}")
        fresh = [self.pool.take_page() for _ in range(n_need - len(shared))]
        self.pool.page_table[rid] = shared + fresh
        self.pool.lengths[rid] = length
        idx = torch.as_tensor(fresh, dtype=torch.long, device=self.device)
        for key in ("k", "v"):
            kind, item = blob[key]
            if kind == "q8":
                src = dequantize_kv_device(item, dtype=torch.float32,
                                           device=self.device)
            else:
                src = item.to(self.device)
            if fresh:
                arr = getattr(self.pool, key)
                arr.index_copy_(1, idx,
                                src[:, len(shared):n_need].to(arr.dtype))
        self.slot_req[slot] = rid

    def pages_shortfall(self, rids: List[int]) -> int:
        """Physical pages missing to decode one token (with verify-k: one
        step) for each of ``rids``."""
        pg = self.cfg.page_size
        if self.lane_scratch:
            # verify-k: a lane whose longest accepted span (k+1 tokens)
            # could reach its scratch page needs one free page for the
            # scratch page's replacement after the commit
            k1 = self.cfg.spec_k + 1
            need_new = sum(1 for rid in rids if self.pool.lengths[rid] + k1
                           > len(self.pool.page_table[rid]) * pg)
        else:
            need_new = sum(1 for rid in rids
                           if self.pool.lengths[rid] % pg == 0)
        return max(0, need_new - len(self.pool.free_pages))

    def _decode_inputs(self, tokens, active, new_gen, new_ctx, true_len,
                       rids) -> np.ndarray:
        """Grow each active lane's pages by the fed token and stage the
        step's input: block tables, lengths, each lane's write page and
        offset (inactive lanes at the scratch page), then the sampling
        fields."""
        B, pg = self.cfg.max_slots, self.cfg.page_size
        tables = np.full((B, self.max_pages_per_seq), self.scratch_page,
                         np.int32)
        lens = np.zeros((B,), np.int32)
        wp = np.full((B,), self.scratch_page, np.int32)
        wo = np.zeros((B,), np.int32)
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
        return pack(tables, lens, wp, wo, super()._decode_inputs(
            tokens, active, new_gen, new_ctx, true_len, rids))

    def _decode_step(self, params, buf):
        B, maxp = self.cfg.max_slots, self.max_pages_per_seq
        head = B * (maxp + 3)
        tables, lens, wp, wo = unpack(buf[:head], (B, maxp), (B,), (B,),
                                      (B,))
        toks, active, *fields = self._decode_views(buf[head:])
        tok, reason = self.model.paged_decode_step_sampled(
            params, self._kv(), toks, tables, lens, wp, wo, active, *fields,
            attn_impl=self.cfg.attn_impl, **self._sample_kwargs())
        return torch.stack([tok, reason])

    def _verify_inputs(self, tokens, n_drafts, active, base_gen, base_ctx,
                       true_len, rids) -> np.ndarray:
        """Stage a verify step's input: block tables with one extra column
        holding each active lane's scratch page right after its real
        pages (a scratch-resident write at logical position p, p // page
        == len(table), gathers back at exactly p), lengths, each
        position's physical page and offset (inactive lanes at the shared
        scratch page), then the tokens and lane scalars.  No page is
        claimed: the commit promotes a scratch page on accept."""
        B, pg = self.cfg.max_slots, self.cfg.page_size
        K1 = self.cfg.spec_k + 1
        tables = np.full((B, self.max_pages_per_seq + 1), self.scratch_page,
                         np.int32)
        lens = np.zeros((B,), np.int32)
        wp = np.full((B, K1), self.scratch_page, np.int32)
        wo = np.broadcast_to(np.arange(K1, dtype=np.int32) % pg,
                             (B, K1)).copy()
        for slot, rid in enumerate(self.slot_req):
            if rid is None or not active[slot]:
                continue
            pos = self.pool.lengths[rid]
            pt = self.pool.page_table[rid]
            tables[slot, :len(pt)] = pt
            tables[slot, len(pt)] = self.lane_scratch[slot]
            lens[slot] = pos
            for i in range(K1):
                p = pos + i
                wp[slot, i] = (pt[p // pg] if p // pg < len(pt)
                               else self.lane_scratch[slot])
                wo[slot, i] = p % pg
        return pack(tables, lens, wp, wo, super()._verify_inputs(
            tokens, n_drafts, active, base_gen, base_ctx, true_len, rids))

    def _verify_step(self, params, buf):
        B, maxp = self.cfg.max_slots, self.max_pages_per_seq + 1
        K1 = self.cfg.spec_k + 1
        head = B * (maxp + 1 + 2 * K1)
        tables, lens, wp, wo = unpack(buf[:head], (B, maxp), (B,), (B, K1),
                                      (B, K1))
        toks, *lane = self._verify_views(buf[head:])
        return self._verify_out(*self.model.paged_decode_verify_sampled(
            params, self._kv(), toks, tables, lens, wp, wo, *lane,
            **self._sample_kwargs()))

    def _commit_verify(self, n_emit, active) -> None:
        """Advance each active lane's pool length by its ``n_emit``; a lane
        whose accepted span reached its scratch page moves that page into
        its page table (no copy) and takes a fresh scratch page (the
        caller guaranteed one through :meth:`pages_shortfall`).  Rejected
        positions are rolled back by not counting them."""
        pg = self.cfg.page_size
        for slot, rid in enumerate(self.slot_req):
            if rid is None or not active[slot] or n_emit[slot] == 0:
                continue
            pt = self.pool.page_table[rid]
            new_len = self.pool.lengths[rid] + int(n_emit[slot])
            if new_len > len(pt) * pg:
                pt.append(self.lane_scratch[slot])
                self.lane_scratch[slot] = self.pool.take_page()
            self.pool.lengths[rid] = new_len


class DenseKVBackend(KVBackend):
    """Slotted dense decode state: ``model.init_cache(max_slots,
    max_seq_len)`` on the device, one slice per lane along each key's batch
    axis, written **in place** where the reference rebuilt the cache.  For
    the attention family every lane owns a full ``max_seq_len`` K/V stripe
    per layer (an encoder-decoder also a ``cross_kv_len`` cross K/V
    stripe, written once by :meth:`write_prefill`); for ``ssm`` a
    constant-size conv window and SSM state; for the hybrid family a K/V
    stripe per 8-layer group and the state of its 7 Mamba layers.  Every
    key stays at one address, so the decode step graph holds them all.

    The pack graph ``("pack", bucket)`` needs no lane in its key (a
    chunk's graph does): the flash kernel reads a per-layer gather of the
    members' stripes, a scratch at a fixed address in the graph's pool,
    and never the stripes themselves.
    """

    def __init__(self, model, cfg: KVBackendConfig):
        super().__init__(model, cfg)
        self.cache = model.init_cache(cfg.max_slots, cfg.max_seq_len)
        self._axes = self._cache_batch_axes()
        if cfg.prefix_cache and model.supports_chunked_prefill():
            acfg = model.cfg
            capacity = cfg.prefix_cache_pages or (
                cfg.max_slots * cfg.max_seq_len // cfg.page_size)
            self.prefix = DensePrefixCache(
                acfg.num_layers, acfg.num_kv_heads, acfg.hd, cfg.page_size,
                capacity, self.cache["k"].dtype, self.device)

    def _cache_batch_axes(self) -> Dict[str, int]:
        """Batch (lane) axis of each cache key (the hybrid family's conv
        and SSM state sit behind their (group, Mamba layer) axes)."""
        fam = self.model.cfg.family
        axes = {"lengths": 0}
        if fam == "ssm":
            axes.update(conv=1, ssm=1)
        elif fam == "hybrid":
            axes.update(k=1, v=1, conv=2, ssm=2)
        else:
            axes.update(k=1, v=1)
            if self.model.cfg.is_encoder_decoder:
                axes.update(xk=1, xv=1)
        return axes

    def _k_store(self):
        return self.cache.get("k")

    def _lane(self, key: str, slot: int):
        """View of one lane's slice of ``cache[key]``."""
        return self.cache[key].select(self._axes[key], slot)

    def _claim(self, rid: int, slot: Optional[int] = None) -> int:
        slot = self.free_slot() if slot is None else slot
        if slot is None or self.slot_req[slot] is not None:
            raise RuntimeError("no free decode lane: the caller must check "
                               "free_slot()")
        self.slot_req[slot] = rid
        return slot

    # ---------------------------------------------------------- interface
    def write_prefill(self, rid: int, pcache, length: int) -> None:
        """Place batch index 0 of a ``Model.prefill`` cache into a free
        lane (the ``ssm`` family's and an encoder-decoder's monolithic
        prefill; an attention prompt takes :meth:`prefill_chunk`).  K/V
        are written trimmed to ``length`` and zero past it, as the
        reference writes them; an encoder-decoder's cross ``xk``/``xv``
        must hold the config's ``cross_kv_len`` frames (the cache's fixed
        length), else this raises."""
        for key in ("xk", "xv"):
            if key in self.cache:
                got = pcache[key].shape[2]
                if got != self.cache[key].shape[2]:
                    raise ValueError(
                        f"write_prefill: {key} holds {got} encoder frames, "
                        f"the cache cross_kv_len = "
                        f"{self.cache[key].shape[2]}")
        slot = self._claim(rid)
        self.cache["lengths"][slot] = length
        for key in self.cache:
            if key == "lengths":
                continue
            lane = self._lane(key, slot)
            src = pcache[key].select(self._axes[key], 0)
            if key in ("k", "v"):     # seq axis: trim the pad, zero to Smax
                lane.zero_()
                lane[:, :length].copy_(src[:, :length])
            else:
                lane.copy_(src)

    def prefill_chunk(self, params, rid: int, tokens: List[int],
                      start: int, slot: Optional[int] = None):
        """One resumable prefill chunk of ``rid`` over its lane's stripe
        (claiming a lane on the first chunk: ``slot`` when given, else the
        first free one): ``Model.prefill_chunk`` on the chunk padded to its
        bucket.  A chunk of a menu bucket runs as the step graph
        ``("chunk", bucket, lane)``: the flash kernel's tensor maps hold
        the lane's stripe address, so each lane has its own graph.  Returns
        the chunk's last-position logits (1, V)."""
        lane = self.slot_of(rid)
        if lane is None:                    # first chunk: claim a lane
            lane = self._claim(rid, slot)
        C = len(tokens)
        Cb = self._chunk_bucket(C)
        Smax = self.cfg.max_seq_len
        toks = np.zeros((1, Cb), np.int32)
        toks[0, :C] = tokens
        logits = self._run_chunk(
            ("chunk", Cb, lane), pack(toks, [start], [C]),
            lambda buf: self._chunk_step(params, buf, Cb, lane),
            # every row past Smax: the chunk writes nothing
            lambda: pack(np.zeros((1, Cb)), [Smax], [1]))
        self.cache["lengths"][lane] = start + C
        return logits

    def _chunk_step(self, params, buf, Cb: int, lane: int):
        toks, start, n = unpack(buf, (1, Cb), (1,), (1,))
        return self.model.prefill_chunk(
            params, self._lane("k", lane), self._lane("v", lane), toks,
            start, n)

    def _pack_inputs(self, items, Cb: int) -> np.ndarray:
        """A pack's staged input: each row's lane, tokens padded to
        ``Cb``, start and token count (claiming lanes for first chunks and
        setting each member lane's length to its chunk's end).  Padding
        rows read the first row's lane with a token count of 0, which
        masks their write-back (``Model.prefill_pack``); with no members,
        every row starts at ``max_seq_len`` and the pack writes
        nothing."""
        N, Smax = self.cfg.prefill_pack_width, self.cfg.max_seq_len
        lanes = np.zeros((N,), np.int32)
        toks = np.zeros((N, Cb), np.int32)
        starts = np.full((N,), 0 if items else Smax, np.int32)
        lens = np.zeros((N,), np.int32)
        for i, (rid, tokens, start) in enumerate(items):
            lane = self.slot_of(rid)
            if lane is None:                # first chunk: claim a lane
                lane = self._claim(rid)
            toks[i, :len(tokens)] = tokens
            lanes[i], starts[i], lens[i] = lane, start, len(tokens)
            self.cache["lengths"][lane] = start + len(tokens)
        lanes[len(items):] = lanes[0]
        return pack(lanes, toks, starts, lens)

    def _pack_step(self, params, buf, Cb: int):
        N = self.cfg.prefill_pack_width
        lanes, toks, start, n = unpack(buf, (N,), (N, Cb), (N,), (N,))
        return self.model.prefill_pack(params, self.cache["k"],
                                       self.cache["v"], lanes, toks, start,
                                       n)

    def prefix_acquire(self, rid: int, tokens) -> int:
        """Copy-based hit: claim a lane and copy the cached prefix's K/V
        from the private page store into its stripe, so chunked prefill
        resumes at the hit watermark (the prefix's prefill compute is
        skipped)."""
        if self.prefix is None or self.has(rid):
            return 0
        slot = self.free_slot()
        if slot is None:
            return 0
        hit, k, v = self.prefix.fetch(list(tokens))
        if hit == 0:
            return 0
        self._claim(rid, slot)
        span = min(k.shape[1], self.cfg.max_seq_len)
        for key, src in (("k", k), ("v", v)):
            self._lane(key, slot)[:, :span].copy_(src[:, :span])
        self.cache["lengths"][slot] = hit
        return hit

    def prefix_publish(self, rid: int, tokens, upto: int) -> int:
        if self.prefix is None:
            return 0
        slot = self.slot_of(rid)
        if slot is None:
            return 0
        return self.prefix.publish(list(tokens), upto,
                                   self._lane("k", slot),
                                   self._lane("v", slot))

    def tier_fill(self, tokens, handle) -> int:
        """Land a cluster-tier import (a pinned ``TierHandle``) in the
        private prefix store: lanes cannot alias host pages, so the import
        is a normal publish whose source is the tier payload, dequantized
        or copied onto the device, instead of a lane's stripe (a pow2
        span is not needed: eager torch has no compile cost).  The
        caller's ``prefix_acquire`` then copies it like any local hit.
        Returns the cached token watermark."""
        if self.prefix is None or handle is None:
            return 0
        pg = self.prefix.page_size
        toks = list(tokens)[:handle.tokens]
        n = len(toks) // pg
        if n <= 0:
            return 0
        mats = handle.materialize(self.cache["k"].dtype, self.device, 0, n)
        self.prefix.publish(toks, n * pg,
                            torch.cat([m[0] for m in mats], dim=1),
                            torch.cat([m[1] for m in mats], dim=1))
        return n * pg

    def clear(self, rid: int) -> None:
        slot = self.slot_of(rid)
        if slot is None:
            return
        self.cache["lengths"][slot] = 0
        self.slot_req[slot] = None

    def offload(self, rid: int) -> dict:
        """Copy ``rid``'s lane to the host and free the lane.  K/V travel
        as a pow2-bucketed span of the stripe (min 8 positions, at most
        ``max_seq_len``) with the rows past the length zeroed, as the
        reference's blob (no stale positions cross the link); INT8 through
        the ``kv_quantize`` kernel when ``quantize_offload``.  Conv and SSM
        state and an encoder-decoder's cross ``xk``/``xv`` travel raw, as
        in the reference."""
        slot = self.slot_of(rid)
        length = int(self.cache["lengths"][slot])
        span = min(self._pow2_bucket(length), self.cfg.max_seq_len)
        stored: dict = {"lengths": length}
        q8: dict = {}
        if self.cfg.quantize_offload and "k" in self.cache:
            k, v = (self._lane(key, slot)[:, :span] for key in ("k", "v"))
            q8 = dict(zip(("k", "v"), quantize_kv_store((k, v), k.shape,
                                                        length=length)))
        for key in self.cache:
            if key == "lengths":
                continue
            if key in q8:
                stored[key] = ("q8", q8[key])
                continue
            lane = self._lane(key, slot)
            if key in ("k", "v"):
                pos = torch.arange(span, device=self.device)[None, :, None,
                                                             None]
                arr = lane[:, :span]
                arr = torch.where(pos < length, arr, torch.zeros_like(arr))
                stored[key] = ("raw", arr.cpu())
            else:
                stored[key] = ("raw", lane.to("cpu", copy=True))
        self.clear(rid)
        return stored

    def upload(self, rid: int, blob: dict) -> None:
        """Restore an offloaded blob into a free lane (K/V dequantized to
        float32 on the device, then cast to the cache's dtype; the stripe
        past the blob's span zeroed)."""
        slot = self._claim(rid)
        self.cache["lengths"][slot] = blob["lengths"]
        for key in self.cache:
            if key == "lengths":
                continue
            kind, item = blob[key]
            lane = self._lane(key, slot)
            if kind == "q8":
                src = dequantize_kv_device(item, dtype=torch.float32,
                                           device=self.device)
            else:
                src = item.to(self.device)
            if key in ("k", "v"):
                lane.zero_()
                lane[:, :src.shape[1]].copy_(src.to(lane.dtype))
            else:
                lane.copy_(src)

    def _decode_step(self, params, buf):
        tok, reason = self.model.decode_step_sampled(
            params, self.cache, *self._decode_views(buf),
            **self._sample_kwargs())
        return torch.stack([tok, reason])

    def _verify_step(self, params, buf):
        return self._verify_out(*self.model.decode_verify_sampled(
            params, self.cache, *self._verify_views(buf),
            **self._sample_kwargs()))

    def decode_logits(self, params, tokens, active):
        """The per-slot path's decode: one ``Model.decode_step`` over every
        lane (only active lanes write and advance), returning the logits
        (B, V) float32 on the device for the caller to sample each lane."""
        return self.model.decode_step(
            params, self.cache, self._t(tokens, torch.int64),
            self._t(active, torch.bool))
