"""Real-execution serving engine of the PyTorch port: continuous batching +
ALISE scheduling over an actual model (paper §3.3), on a pluggable KV
backend: the paged KV pool (the attention family's default here) or the
dense slotted cache (``kv_backend="dense"``: a full K/V stripe per lane
for the attention family, the reference's default backend, and the only
backend of the ``ssm`` and hybrid families, whose per-lane state is
constant-size or holds one.

The engine drives the same Scheduler / TieredKVManager policy code as the
JAX package (its own copy) and executes each
:class:`~repro_torch.core.scheduler.IterationPlan`:

  * prefill: every :class:`PrefillChunk` of an attention prompt (a whole
    prompt as one chunk when ``prefill_chunk`` is None) runs through the
    backend's resumable prefill: ``Model.paged_prefill_chunk`` into the
    page pool, or ``Model.prefill_chunk`` over the lane's dense stripe.
    With ``prefill_pack`` the scheduler fuses equal-bucket chunks of
    distinct requests into a :class:`PrefillPack`, which runs as one call
    (``Model.paged_prefill_pack`` / ``Model.prefill_pack``).  An SSM
    prompt, which cannot resume, goes unpadded through the monolithic
    ``Model.prefill`` and its state is placed in a free lane;
  * with ``prefix_cache``, a fresh prefill first matches the shared-prefix
    index (``serving/prefix_cache.py``) and resumes at the hit watermark;
    a finished prompt's full pages are published back (never KV that went
    through an INT8 swap, which is lossy);
  * decode: one fused step per iteration (``Model.paged_decode_step_
    sampled`` or ``Model.decode_step_sampled``): embedding, layer stack, KV
    or state writes, attention or the SSM recurrence, sampling and
    termination run on the device; the host copies one ``(tokens,
    reasons)`` pair.  ``fused_decode=False`` (dense backend only) is the
    reference's legacy path: one ``Model.decode_step`` for the logits,
    then host sampling lane by lane;
  * with ``spec_decode`` (attention family, fused decode), each decode
    iteration is one verify-k step instead (``Model.decode_verify_
    sampled`` / ``paged_decode_verify_sampled``): a model-free draft
    source (``serving/draft.py``: the request's own n-grams, and the
    prefix index when the prefix cache is on) proposes ``spec_k`` tokens
    per lane, the step scores the fed token and the drafts through the
    chunk attention and accepts the longest exact-match run on the device,
    so a lane emits 1 to ``spec_k + 1`` tokens per iteration;
  * request-level swapping between the device and a host pool: K/V
    quantized to INT8 on the device by the ``kv_quant`` kernels (Eq. 8) so
    the host link carries the INT8 payload; an SSM request's conv and SSM
    state moved raw;
  * per-iteration wall-time profiling (bounded ring buffers) used to fit
    the Eq. 3-5 latency model.

On a CUDA device the fused decode (or verify) step and the prefill chunks
and packs of the bucket menu run as CUDA graphs (``EngineConfig.
cuda_graphs``, on by default; ``serving/step_graphs.py``), each captured
at its first use.
:meth:`ServingEngine.warmup` makes every first use happen before serving
and loads every kernel library serving can reach, as the reference's
warmup compiles every shape: a warmed engine then captures, builds and
loads nothing at serve time (``utils/compile_counter.CompileCounter``
counts it).  What stays eager is what the reference does not warm either:
the ``ssm`` and hybrid families' monolithic prefill, a prompt prefilled
as one chunk when ``prefill_chunk`` is None, swaps, prefix-cache copies
and the per-slot decode.

:meth:`ServingEngine.attach_bus` wires an observability
:class:`~repro_torch.serving.observability.EventBus` through the
scheduler, the prefix cache and the engine's own execution spans; with
no bus attached nothing is recorded.  :meth:`ServingEngine.attach_tier`
joins the replica to a cluster KV tier (``serving/kv_tier.HostKVTier``):
its prefix publishes export their pages to the tier, and a fresh prefill
first imports the pages a peer published past its local match
(``_tier_import``), at transfer cost instead of prefill compute.  With
``realtime_swap`` the modeled transfer time of swaps and imports is
slept off after each step, outside ``step_lock``.

A front end on another thread (the gateway's concurrent pump) hands
requests over through :meth:`ServingEngine.submit_nowait`, a mailbox the
next step drains, and takes events back through
:meth:`ServingEngine.poll_events`; :meth:`ServingEngine.step_and_poll` is
one pump iteration.  Every step holds ``serving/step_graphs.CAPTURE_GATE``
shared, so a graph capture in one replica's thread never overlaps another
replica's step.

Correctness invariant (tested): with greedy sampling and quantization off,
generated tokens do not depend on how jobs are preempted and swapped, on
the backend (dense | paged), on chunked or monolithic prefill, on packed
or single chunks, on the prefix cache, on the length predictor, on fused
or per-slot decode, on speculative decoding and its drafts, on the
observability bus, on ``paged_attn_impl`` (gather | kernel) or on
``Model.chunk_attn_impl`` (masked | flash).  The tests hold it on the CPU
in float32.  On the card in bfloat16 a product's bits depend on its
shape: a pack's rows, or another chunk split, round differently from
single chunks (a pack's head product differs in the last bits), so greedy
tokens there may differ wherever packing, chunking or a verify step (B x
(spec_k + 1) rows where decode has B) changes a shape.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.memory_manager import MemoryConfig, TieredKVManager
from repro_torch.core.predictor import LengthPredictor, RetrievalPredictor
from repro_torch.core.quantization import kv_bytes_per_token
from repro_torch.core.request import KVLocation, Request, RequestState
from repro_torch.core.scheduler import (DecodeLane, PrefillChunk,
                                        PrefillPack, Scheduler,
                                        SchedulerConfig)
from repro_torch.models.model import Model
from repro_torch.serving.draft import make_draft_source
from repro_torch.serving.kv_cache import (DenseKVBackend, KVBackendConfig,
                                          PagedKVBackend,
                                          dequantize_kv_device,
                                          quantize_kv_device)
from repro_torch.serving.sampler import REASONS, sample_and_reason
from repro_torch.serving.step_graphs import CAPTURE_GATE
from repro_torch.utils.compile_counter import CompileCounter


def default_bucket_menu(prefill_chunk: int) -> Tuple[int, ...]:
    """Pow2 bucket menu covering every chunk shape a ``prefill_chunk``-capped
    scheduler can emit."""
    top = max(8, 1 << (max(int(prefill_chunk), 1) - 1).bit_length())
    menu, b = [], 8
    while b <= top:
        menu.append(b)
        b *= 2
    return tuple(menu)


def default_device_label(device) -> str:
    """Placement label this replica reports (``cuda:0``, ``cpu``)."""
    return str(torch.device(device))


@dataclass
class EngineEvent:
    """Streaming event drained via ``ServingEngine.poll_events()``.

    kinds: ``token`` (one decoded token; ``index`` is its 0-based position
    in ``output_tokens``), ``finish`` (request completed; ``reason`` one of
    eos/length/true_len/ctx), ``cancel`` (client abort).
    """
    kind: str
    req_id: int
    t: float
    token: Optional[int] = None
    index: Optional[int] = None
    reason: str = ""


@dataclass
class EngineConfig:
    max_slots: int = 8
    max_seq_len: int = 256
    max_new_tokens: int = 128
    eos_token: int = 1
    greedy: bool = True
    temperature: float = 1.0
    top_k: int = 0
    quantize_offload: bool = True
    hbm_bytes: Optional[float] = None      # default: fits ~max_slots*max_seq
    swap_bw: float = 32e9
    realtime_swap: bool = False            # wall-clock mode: enforce the
                                           # modeled swap and tier-import
                                           # transfer time (the host copy
                                           # may be faster than the modeled
                                           # link); slept off after the
                                           # step, outside step_lock
    kv_backend: str = "dense"              # dense | paged
    page_size: int = 16                    # paged backend page granularity
    paged_attn_impl: str = "gather"        # gather (bit-exact reference) |
                                           # kernel (CUDA paged attention)
    fused_decode: bool = True              # one on-device decode + sample
                                           # step per iteration (False:
                                           # legacy per-slot host sampling,
                                           # dense backend only)
    prefill_chunk: Optional[int] = None    # max prompt tokens per prefill
                                           # chunk (None = the whole prompt
                                           # as one chunk)
    iter_token_budget: Optional[int] = None  # scheduler token budget per
                                             # iteration (None = unbounded)
    prefill_buckets: Optional[Tuple[int, ...]] = None
    # fixed menu of chunk-shape buckets (sorted ascending); None = pow2
    # (packing without a menu takes the pow2 menu of prefill_chunk)
    prefill_pack: bool = False             # fuse equal-bucket chunks of
                                           # distinct requests into one
                                           # PrefillPack call
    prefill_pack_width: int = 4            # rows of every pack call
    prefix_cache: bool = False             # cross-request shared-prefix KV
                                           # cache (needs chunked prefill)
    prefix_cache_pages: int = 0            # dense backend: private store
                                           # capacity (0 = one batch's worth)
    spec_decode: bool = False              # verify-k speculative decode
                                           # (attention family, fused
                                           # decode; output-identical)
    spec_k: int = 3                        # draft tokens per lane per
                                           # verify step (paged: < page_size)
    warmup_compile: bool = False           # run warmup() at construction
    cuda_graphs: bool = True               # port only: on a CUDA device the
                                           # decode step and the menu's
                                           # chunks run as CUDA graphs
                                           # (False: eagerly, to hold the
                                           # graphs against)
    profile_window: int = 4096             # iter/prefill ring-buffer size
    strategy: str = "alise"
    n_queues: int = 4
    base_quantum: float = 0.25
    quantum_growth: float = 4.0
    age_threshold: float = 2.0
    respect_true_len: bool = True          # stop at trace's true_out_len
    device: Optional[str] = None           # placement label; default: the
                                           # model's device
    seed: int = 0


def _refuse_encoder_decoder(cfg) -> None:
    """Raise for an encoder-decoder config: the engine prefills a request
    from its decoder prompt tokens alone, and such a model's prefill needs
    its encoder's inputs (``enc_embeds``).  The reference's engine cannot
    prefill one either: its ``_run_prefill`` passes only ``tokens``, and
    its ``Model.prefill`` fails with ``KeyError: 'enc_embeds'``.  Such a
    model is served by driving ``Model.prefill`` and the dense backend
    (``write_prefill``, ``decode``, ``offload``/``upload``) directly."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the serving engine cannot prefill an "
            "encoder-decoder model (its requests carry decoder tokens, not "
            "the encoder's enc_embeds; the reference's engine fails the "
            "same way, KeyError: 'enc_embeds'); drive Model.prefill and "
            "DenseKVBackend directly")


def _kv_backend(cfg: EngineConfig, model: Model) -> str:
    """``cfg.kv_backend``, checked against the model and the decode step."""
    backend = cfg.kv_backend
    if backend not in ("paged", "dense"):
        raise ValueError(f"unknown kv_backend: {backend!r}")
    if backend == "paged" and not model.supports_paged():
        raise ValueError(f"family={model.cfg.family} has no paged KV (its "
                         "state is constant-size): use kv_backend='dense'")
    if backend == "paged" and not cfg.fused_decode:
        raise ValueError("the paged backend only implements the fused "
                         "decode step (fused_decode=True)")
    return backend


class ServingEngine:
    def __init__(self, model: Model, params, cfg: EngineConfig,
                 predictor: Optional[LengthPredictor] = None,
                 latency: Optional[LatencyModel] = None):
        _refuse_encoder_decoder(model.cfg)
        self.kv_backend = _kv_backend(cfg, model)
        self.model = model
        self.params = params
        self.cfg = cfg
        acfg = model.cfg
        bpt = kv_bytes_per_token(acfg.num_layers, acfg.num_kv_heads, acfg.hd)
        # the dense backend's prefix cache owns a private page store, a
        # real device allocation outside per-request accounting: charge it
        # against the budget (and grow the default budget by it, so the
        # cache does not shrink the lanes' share)
        dense_store_bytes = 0.0
        if (cfg.prefix_cache and self.kv_backend == "dense"
                and model.supports_chunked_prefill()):
            capacity = cfg.prefix_cache_pages or (
                cfg.max_slots * cfg.max_seq_len // cfg.page_size)
            dense_store_bytes = capacity * cfg.page_size * bpt
        hbm = cfg.hbm_bytes or (cfg.max_slots * cfg.max_seq_len * bpt
                                + dense_store_bytes)
        mem_cfg = MemoryConfig(
            hbm_bytes=hbm, dram_bytes=1e12, bytes_per_token_fp=bpt,
            swap_bw=cfg.swap_bw, quantize_offload=cfg.quantize_offload,
            reserve_policy="reserve_max" if cfg.strategy == "orca" else "ondemand",
            reserve_max_tokens=cfg.max_new_tokens,
            page_size=(cfg.page_size if self.kv_backend == "paged" else None))
        self.mem = TieredKVManager(mem_cfg)
        self.predictor = predictor or RetrievalPredictor(seed=cfg.seed)
        self.latency = latency or LatencyModel(t0=1e-4, alpha=1e-6, beta=1e-2)
        # chunked prefill needs model support (the attention family); other
        # families keep monolithic whole-prompt spans
        self._chunked_ok = model.supports_chunked_prefill()
        # fixed chunk-shape menu: the explicit one wins; packing without
        # one takes the pow2 menu (packs group by bucket)
        buckets: Optional[Tuple[int, ...]] = None
        if self._chunked_ok and cfg.prefill_chunk:
            if cfg.prefill_buckets:
                buckets = tuple(sorted({int(b) for b in cfg.prefill_buckets}))
                if buckets[0] <= 0:
                    raise ValueError("prefill buckets must be positive")
            elif cfg.prefill_pack:
                buckets = default_bucket_menu(cfg.prefill_chunk)
        self._buckets = buckets
        self._pack_ok = bool(cfg.prefill_pack and buckets
                             and cfg.prefill_pack_width >= 2
                             and model.supports_prefill_pack())
        # the chunk buckets the reference's warmup compiles, which run as
        # step graphs here (none when a prompt is one chunk)
        menu = buckets
        if menu is None and self._chunked_ok and cfg.prefill_chunk:
            menu = default_bucket_menu(cfg.prefill_chunk)
        self._graph_menu = tuple(b for b in (menu or ())
                                 if b <= cfg.max_seq_len)
        self.warm_stats: Optional[dict] = None   # set by warmup()
        self.serve_started: Optional[float] = None   # set by serve()
        sched_cfg = SchedulerConfig(
            max_batch=cfg.max_slots, n_queues=cfg.n_queues,
            base_quantum=cfg.base_quantum, quantum_growth=cfg.quantum_growth,
            age_threshold=cfg.age_threshold, strategy=cfg.strategy,
            max_new_tokens=cfg.max_new_tokens,
            prefill_chunk=(cfg.prefill_chunk if self._chunked_ok else None),
            iter_token_budget=cfg.iter_token_budget,
            prefill_buckets=buckets, prefill_pack=self._pack_ok,
            prefill_pack_width=cfg.prefill_pack_width,
            decode_width=(cfg.spec_k + 1
                          if (cfg.spec_decode and cfg.fused_decode
                              and model.supports_spec_decode())
                          else 1))
        self.sched = Scheduler(sched_cfg, self.predictor, self.latency, self.mem)

        bcfg = KVBackendConfig(
            max_slots=cfg.max_slots, max_seq_len=cfg.max_seq_len,
            eos_token=cfg.eos_token, max_new_tokens=cfg.max_new_tokens,
            greedy=cfg.greedy, temperature=cfg.temperature, top_k=cfg.top_k,
            quantize_offload=cfg.quantize_offload, page_size=cfg.page_size,
            attn_impl=cfg.paged_attn_impl,
            prefix_cache=(cfg.prefix_cache and self._chunked_ok),
            prefix_cache_pages=cfg.prefix_cache_pages, seed=cfg.seed,
            prefill_buckets=buckets, graph_buckets=self._graph_menu,
            prefill_pack_width=cfg.prefill_pack_width,
            cuda_graphs=cfg.cuda_graphs,
            spec_k=(cfg.spec_k
                    if cfg.spec_decode and cfg.fused_decode else 0))
        if self.kv_backend == "paged":
            num_pages = max(1, int(hbm // (cfg.page_size * bpt)))
            self.kv = PagedKVBackend(model, bcfg, num_pages)
        else:
            self.kv = DenseKVBackend(model, bcfg)
        self._prefix_ok = self.kv.prefix is not None
        # speculative verify-k decode: the backend gates on the model and
        # spec_k > 0 (an ssm engine ignores spec_decode); correctness does
        # not depend on the drafts, so the source needs no warmup
        self._spec_ok = self.kv.supports_spec_decode()
        self._draft = None
        if self._spec_ok:
            self._draft = make_draft_source(
                self.kv.prefix.index if self._prefix_ok else None)
        if self._prefix_ok:
            # cached pages no request references are the lowest KV tier:
            # every page-shortfall path reclaims them before spilling
            self.mem.register_prefix_cache(self.kv.prefix_reclaim,
                                           self.kv.prefix_pages)
            if dense_store_bytes:
                self.mem.charge_static(dense_store_bytes)
        self.host_pool: Dict[int, dict] = {}       # req_id -> offloaded KV
        # requests whose device KV went through a lossy (INT8) swap: it is
        # never published, since a later hit would hand other requests
        # lossy KV where a recompute is exact.  Cleared on drop (a
        # recompute rebuilds exact KV)
        self._lossy_kv: set = set()
        # bounded profiling rings (entries lead with a perf_counter stamp):
        #   iter_times:    (t_mono, ctx_tokens, batch, dt)
        #   prefill_times: (t_mono, n_tokens, dt, rows): rows is 1 for a
        #                  chunk, the member count for a pack (one entry)
        self.iter_times: Deque[tuple] = deque(maxlen=cfg.profile_window)
        self.prefill_times: Deque[tuple] = deque(maxlen=cfg.profile_window)
        self._generated_of: Dict[int, List[int]] = {}
        # streaming events: recorded only when a front-end opts in
        self.stream_events = False
        self._events: List[EngineEvent] = []       # drained by poll_events()
        # step_lock serializes every state mutation; the event buffer has
        # its own lock so poll_events() never blocks on a step
        self.step_lock = threading.RLock()
        self._events_lock = threading.Lock()
        self._backlog_cache = 0.0                  # refreshed under step_lock
        self._backlog_q90 = 0.0                    # p90 surface (admission)
        self._stall_debt = 0.0                     # modeled transfer seconds
        # submit mailbox: intake that never waits on step_lock behind an
        # in-flight iteration, drained at the start of the next step
        # (symmetric to the event buffer going the other way)
        self._submit_box: List = []                # [(Request, now), ...]
        self._submit_lock = threading.Lock()
        # observability: attach_bus() sets a bus; None keeps every emit
        # site to one attribute load and branch
        self.bus = None
        self.name = ""                             # replica lane name
        # cluster KV tier (serving/kv_tier.py): attach_tier() sets it; None
        # keeps the tier paths to one attribute load and branch
        self.tier = None
        self._step_wall0 = 0.0                     # perf_counter at step()
        self.device = cfg.device or default_device_label(model.device)
        if cfg.warmup_compile:
            self.warmup()

    # -------------------------------------------------------- observability
    def attach_bus(self, bus, name: str = "") -> None:
        """Wire an observability EventBus through this engine, its
        scheduler (queue join, promote, demote, predictions) and its
        prefix cache (CoW, dedupe, evict), under one replica lane
        ``name``."""
        self.bus = bus
        self.name = name
        self.sched.bus = bus
        self.sched.replica = name
        if self._prefix_ok:
            self.kv.prefix.bus = bus
            self.kv.prefix.replica = name
        if self.tier is not None and self.tier.bus is None:
            self.tier.bus = bus        # a shared tier: the first replica

    def attach_tier(self, tier) -> None:
        """Join this replica to a cluster KV tier (``serving/kv_tier.
        HostKVTier``): local prefix publishes export their pages to it, and
        a fresh prefill imports a peer replica's pages instead of
        prefilling them.  A quantized tier's ``kv_quant`` library is loaded
        here (one round trip of one row), not at its first publish."""
        self.tier = tier
        if self._prefix_ok:
            self.kv.prefix.tier = tier
        if self.bus is not None and tier.bus is None:
            tier.bus = self.bus
        if tier.quantize:
            x = torch.zeros((1, self.model.cfg.hd), device=self.model.device)
            dequantize_kv_device(quantize_kv_device(x),
                                 device=self.model.device)

    def _span_t(self, t: float, t0: float) -> float:
        """Trace placement of an in-step span that started at wall clock
        ``t0``: the iteration's timestamp ``t`` plus the wall time elapsed
        since step entry (exact on a wall clock; monotone within the
        iteration on a virtual one)."""
        return t + (t0 - self._step_wall0)

    # -------------------------------------------------------------- prefill
    def _sample_host(self, logits_row, rid: int, new_gen: int, new_ctx: int,
                     true_len: int):
        """One-row sampling + termination for prefill first tokens and the
        per-slot decode path — the same ``sample_and_reason`` chain the
        fused decode step runs, with the same per-(request, token-index)
        draw.  Returns ``(token, reason_str)``."""
        dev = logits_row.device

        def one(v):
            return torch.tensor([v], dtype=torch.int32, device=dev)

        tok, reason = sample_and_reason(
            logits_row[None], one(rid), one(new_gen - 1),
            greedy_sampling=self.cfg.greedy, seed=self.cfg.seed,
            temp=self.cfg.temperature, top_k=self.cfg.top_k,
            eos_token=self.cfg.eos_token,
            max_new_tokens=self.cfg.max_new_tokens,
            max_seq_len=self.cfg.max_seq_len, new_gen=one(new_gen),
            new_ctx=one(new_ctx), true_len=one(true_len))
        out = torch.stack([tok, reason]).cpu()
        return int(out[0, 0]), REASONS[int(out[1, 0])]

    def _run_prefill(self, req: Request, tokens: List[int]):
        """Monolithic prefill for a family without chunked prefill (``ssm``,
        hybrid): one ``Model.prefill`` pass over the unpadded prompt (the
        state depends on every step), its cache placed into a free lane.
        Returns the last-token logits (1, V)."""
        return self._run_prefill_tokens(req.req_id, tokens)

    def _run_prefill_tokens(self, rid: int, tokens: List[int]):
        if self.kv.free_slot() is None:
            raise RuntimeError("no free decode lane: the caller must check "
                               "free_slot()")
        batch = {"tokens": torch.as_tensor([tokens], dtype=torch.int64,
                                           device=self.model.device)}
        logits, pcache = self.model.prefill(self.params, batch)
        self.kv.write_prefill(rid, pcache, len(tokens))
        return logits

    def _true_len_of(self, req: Request) -> int:
        return (req.true_out_len if self.cfg.respect_true_len
                else np.iinfo(np.int32).max)

    def _prefill_target_tokens(self, req: Request) -> List[int]:
        """Tokens a (re-)prefill must materialize.  Cache invariant: the
        most recent sampled token's KV is not yet written (the next decode
        step feeds it), so a recompute covers prompt + generated[:-1]."""
        gen = self._generated_of.get(req.req_id)
        if gen is None:
            gen = list(req.output_tokens)
        return list(req.prompt_tokens) + (gen[:-1] if gen else [])

    def _chunk_prework(self, chunk: PrefillChunk, t: float):
        """Everything a chunk needs before its dispatch: residency and lane
        checks, shared-prefix matching, page reservation, memory
        admission.  Returns ``(status, start, target_toks)`` with status
        ``"blocked"`` (cannot run this iteration), ``"covered"`` (the
        prefix cache holds the whole span: no compute) or ``"ready"``.
        Idempotent, so a pack may prework members it then runs through the
        single-chunk path."""
        r = chunk.req
        rid = r.req_id
        if self.mem.location_of(r) == KVLocation.DRAM:
            # spilled by an earlier item this iteration: the chunk cannot
            # resume until swap-in restores its prefix KV
            return "blocked", 0, None
        if chunk.start > 0 and not self.kv.has(rid):
            return "blocked", 0, None   # prefix KV vanished since planning
        if not self.kv.has(rid) and self.kv.free_slot() is None:
            return "blocked", 0, None   # lanes exhausted; retry next iter
        target_toks = self._prefill_target_tokens(r)
        if (self._prefix_ok and chunk.start == 0 and r.prefilled == 0
                and not self.kv.has(rid)):
            # a fresh prefill (or a recompute) matches the index now (the
            # submit-time hint may be stale either way); a hit maps or
            # copies the cached prefix in and moves the watermark forward.
            # When the cluster tier holds more of the prompt than the local
            # index (a peer computed it), import the difference first, so
            # that the acquire sees the extended index
            if self.tier is not None:
                self._tier_import(rid, target_toks, t)
            hit = self.kv.prefix_acquire(rid, target_toks)
            if hit:
                r.prefilled = hit
                r.cached_prefix_hint = hit
                if self.bus is not None:
                    self.bus.emit("prefix_hit", t=t, req_id=rid,
                                  replica=self.name, tokens=hit)
        start = max(chunk.start, r.prefilled)
        # the chunk's coverage may need fresh pages: spill the largest-
        # context other resident (prefer fully-prefilled victims)
        while (short := self.kv.chunk_pages_shortfall(rid, chunk.end)) > 0:
            if self.mem.reclaim_cache(short) > 0:
                continue
            others = [x for x in self.sched.live.values()
                      if x.req_id != rid and self.kv.has(x.req_id)
                      and self.mem.resident_hbm(x)]
            if not others:
                return "blocked", 0, None
            done = [x for x in others if x.prefill_pending == 0]
            victim = max(done or others, key=lambda x: x.context_len)
            self._spill(victim, t, "page_shortfall")
        if self.mem.location_of(r) == KVLocation.NONE:
            self.mem.admit(r)
        r.state = RequestState.RUNNING
        if r.first_scheduled_time is None:
            r.first_scheduled_time = t
        if start >= chunk.end and not chunk.last:
            # the cached prefix covers the whole chunk: no compute; the
            # scheduler re-plans from the new watermark (a last chunk
            # always runs: hits stop one token short of the target, whose
            # logits must come from a real call)
            return "covered", start, target_toks
        return "ready", start, target_toks

    def _chunk_postwork(self, chunk: PrefillChunk, start: int, n_toks: int,
                        logits_row, target_toks, generated_of, t: float,
                        t0: float, dt: float, pack_size: int = 1) -> None:
        """Everything after a chunk's call: the ``prefill_chunk`` event, on
        the final chunk a publish of its full pages to the prefix index
        (unless its KV is lossy), and the first token of a fresh prefill.
        Shared by the single chunk (``pack_size`` 1) and each member of a
        pack."""
        r = chunk.req
        if self.bus is not None:
            self.bus.emit("prefill_chunk", t=self._span_t(t, t0), dur=dt,
                          req_id=r.req_id, replica=self.name, start=start,
                          end=chunk.end, tokens=n_toks, last=chunk.last,
                          fresh=chunk.fresh, bucket=chunk.bucket,
                          pack_size=pack_size)
        if (chunk.last and self._prefix_ok
                and r.req_id not in self._lossy_kv):
            # the next request that shares this prefix hits it (the
            # partial tail page stays private: decode writes it)
            self._publish(r, target_toks, t)
        if chunk.last and r.generated == 0:   # fresh prefill emits a token
            tok, reason = self._sample_host(
                logits_row, r.req_id, 1, r.context_len + 1,
                self._true_len_of(r))
            self._accept_token(r, tok, generated_of, t, reason=reason)

    def _synced_since(self, t0: float, logits) -> float:
        """Seconds since ``t0`` once the device has finished ``logits``."""
        if logits.is_cuda:
            torch.cuda.synchronize(logits.device)
        return time.perf_counter() - t0

    def _exec_prefill_chunk(self, chunk: PrefillChunk, generated_of,
                            t: float) -> bool:
        """Execute one PrefillChunk: match the prefix cache (first chunk),
        claim a lane and admit memory, run the uncached part of the chunk
        through the backend's resumable prefill (or, for a family without
        one, the whole target through the monolithic prefill) and, when
        the final chunk of a fresh prefill completes, sample the first
        token.  Returns whether the chunk made progress."""
        r = chunk.req
        status, start, target_toks = self._chunk_prework(chunk, t)
        if status != "ready":
            return status == "covered"
        t0 = time.perf_counter()
        if self._chunked_ok:
            logits = self.kv.prefill_chunk(
                self.params, r.req_id, target_toks[start:chunk.end], start)
            r.prefilled = chunk.end
            n_toks = chunk.end - start
        else:
            if chunk.start != 0 or not chunk.last:
                raise RuntimeError("the monolithic prefill cannot resume a "
                                   "partial chunk")
            logits = self._run_prefill(r, target_toks)
            r.prefilled = n_toks = len(target_toks)
        dt = self._synced_since(t0, logits)
        self.prefill_times.append((t0, n_toks, dt, 1))
        self._chunk_postwork(chunk, start, n_toks, logits[0], target_toks,
                             generated_of, t, t0, dt)
        return True

    def _exec_prefill_pack(self, pk: PrefillPack, generated_of,
                           t: float) -> bool:
        """Execute one PrefillPack: every member's prework, then every
        ready member through the backend's packed prefill as one call (rows
        padded to the pack's bucket and width).  A member whose prework
        blocks is skipped; the scheduler re-plans it, as a blocked single
        chunk.  A pack left with one ready member runs it through the
        single-chunk path, which warmup() has also captured."""
        ready: List[tuple] = []
        ran_any = False
        for chunk in pk.chunks:
            status, start, target_toks = self._chunk_prework(chunk, t)
            if status == "covered":
                ran_any = True
            elif status == "ready":
                ready.append((chunk, start, target_toks))
        # prework admits each member alone, but the pack claims lanes and
        # pages for all of them at once: drop the members the shared free
        # supply cannot cover (the scheduler re-plans them)
        free_lanes = sum(1 for x in self.kv.slot_req if x is None)
        pool = getattr(self.kv, "pool", None)
        free_pages = len(pool.free_pages) if pool is not None else 0
        fit = []
        for c, s, toks in ready:
            rid = c.req.req_id
            need_lane = 0 if self.kv.has(rid) else 1
            need_pages = 0
            if pool is not None:
                need_pages = max(0, pool.pages_needed(c.end)
                                 - len(pool.page_table.get(rid, [])))
            if need_lane > free_lanes or need_pages > free_pages:
                continue
            free_lanes -= need_lane
            free_pages -= need_pages
            fit.append((c, s, toks))
        ready = fit
        if not ready:
            return ran_any
        if len(ready) == 1:
            return self._exec_prefill_chunk(ready[0][0], generated_of,
                                            t) or ran_any
        items = [(c.req.req_id, toks[s:c.end], s) for c, s, toks in ready]
        t0 = time.perf_counter()
        logits = self.kv.prefill_pack(self.params, items, bucket=pk.bucket)
        dt = self._synced_since(t0, logits)
        total = sum(c.end - s for c, s, _ in ready)
        self.prefill_times.append((t0, total, dt, len(ready)))
        for i, (chunk, start, target_toks) in enumerate(ready):
            chunk.req.prefilled = chunk.end
            self._chunk_postwork(chunk, start, chunk.end - start, logits[i],
                                 target_toks, generated_of, t, t0, dt,
                                 pack_size=len(ready))
        return True

    # -------------------------------------------------------------- warmup
    def warmup(self) -> Dict[int, float]:
        """Make the first use of every step graph serving can hit, and load
        every kernel library it can reach, on an idle engine: each chunk
        bucket of the menu (on the dense backend in every lane: each lane
        has its own graph), with packing one pack per bucket (one member:
        the padding rows fill the rest of the fixed width), the fused
        decode step at ``max_slots`` lanes (with ``spec_decode`` the verify
        step at ``(max_slots, spec_k + 1)`` in its place, its second run's
        seconds in ``self.latency.verify_cost``; without fused decode the
        per-slot decode, eagerly), and one short prompt and one
        offload/upload round trip of a warm lane (:meth:`_warm_libraries`);
        last, with INT8 swaps on the card, the swap blobs' pinned host
        memory (``KVBackend.reserve_swap_memory``).
        A key's first use runs it twice and captures it; each bucket is
        then run once more and that replay's seconds land in
        ``self.latency.bucket_costs``, so EWT prices a bucketed chunk at its
        padded cost, as the reference records its second, post-compile
        rep.  ``self.warm_stats`` records the keys, captures, compile
        events, graph-pool bytes and replays, the warmup's seconds and the
        ``time.perf_counter()`` stamp of its end.

        Warm runs touch only state they release at once: a warm chunk's KV
        lands in a lane that is cleared (dense: its rows are never attended
        before a prompt rewrites them; paged: its pages are freed), the
        all-inactive decode or verify writes only the paged backend's
        shared scratch page (the dense backend keeps inactive lanes'
        state), so a warmed engine serves the same tokens bit for bit as a
        cold one.  A family without chunked prefill has no bucket."""
        if self.sched.live:
            raise RuntimeError("warmup() requires an idle engine")
        with self.step_lock, CAPTURE_GATE.shared():
            return self._warmup()

    def _warmup(self) -> Dict[int, float]:
        t_start = time.perf_counter()
        counter = CompileCounter()
        costs: Dict[int, float] = {}
        warm_rid = -(1 << 30)       # never collides with real request ids
        lanes = (range(self.cfg.max_slots)
                 if isinstance(self.kv, DenseKVBackend) else (None,))
        for lane in lanes:
            # the fewest tokens that take each bucket: the padded chunk
            # costs the same, and a paged chunk needs the fewest pages
            for n, b in zip((0,) + self._graph_menu, self._graph_menu):
                for _ in range(2):
                    t0 = time.perf_counter()
                    logits = self.kv.prefill_chunk(self.params, warm_rid,
                                                   [1] * (n + 1), 0,
                                                   slot=lane)
                    logits.cpu()
                    costs[b] = time.perf_counter() - t0
                    self.kv.clear(warm_rid)
        if self._pack_ok:
            for b in self._graph_menu:
                self.kv.prefill_pack(self.params, [(warm_rid, [1], 0)],
                                     bucket=b).cpu()
                self.kv.clear(warm_rid)
        self._warm_libraries(warm_rid)
        B = self.cfg.max_slots
        zeros = np.zeros((B,), np.int32)
        tokens, active = np.zeros((B, 1), np.int32), np.zeros((B,), bool)
        tl = np.full((B,), np.iinfo(np.int32).max, np.int32)
        if self._spec_ok:
            # the serve path's only decode step is the verify step (one
            # (B, spec_k + 1) shape; draft counts ride n_drafts): its
            # second run's seconds price speculative iterations in EWT
            vtok = np.zeros((B, self.cfg.spec_k + 1), np.int32)
            for _ in range(2):
                t0 = time.perf_counter()
                self.kv.decode_verify(self.params, vtok, zeros, active,
                                      zeros, zeros, tl, zeros)
                self.latency.verify_cost = time.perf_counter() - t0
        elif self.cfg.fused_decode:
            for _ in range(2):
                self.kv.decode(self.params, tokens, active, zeros, zeros, tl,
                               zeros)
        else:
            self.kv.decode_logits(self.params, tokens, active).cpu()
        if costs:
            merged = dict(self.latency.bucket_costs or {})
            merged.update(costs)
            self.latency.bucket_costs = merged
        # after the last capture: torch.cuda.graph empties the pinned host
        # cache this fills
        self.kv.reserve_swap_memory()
        graphs = self.kv.graphs
        end = time.perf_counter()
        self.warm_stats = dict(
            keys=len(graphs), captures=graphs.captures,
            compiles=counter.count, pool_bytes=graphs.pool_bytes,
            replays=dict(graphs.replays), seconds=end - t_start, end=end)
        counter.detach()
        return costs

    def _warm_libraries(self, warm_rid: int) -> None:
        """Load every kernel library serving can reach: one short prompt
        through the route a prompt takes (a chunk, or the ``ssm`` and
        hybrid families' monolithic prefill) into a free lane, then one offload/upload round
        trip of that lane (INT8 through the ``kv_quant`` kernels when
        ``quantize_offload``), then clear it."""
        if self.cfg.max_seq_len < 8:
            return
        if self._chunked_ok:
            self.kv.prefill_chunk(self.params, warm_rid, [1] * 8, 0)
        else:
            self._run_prefill_tokens(warm_rid, [1] * 8)
        self.kv.upload(warm_rid, self.kv.offload(warm_rid))
        self.kv.clear(warm_rid)
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    # ------------------------------------------------------------ swapping
    def _swap_stall(self, n_tokens: int, t0: float) -> None:
        """With ``realtime_swap``, record the modeled transfer time of an
        offload or upload of ``n_tokens`` tokens, less the wall time the
        host copy (started at ``t0``) already took.  It is accumulated and
        slept off at the end of :meth:`step`, after ``step_lock`` is
        released."""
        if not self.cfg.realtime_swap:
            return
        bpt = self.mem.cfg.bytes_per_token_fp
        if self.cfg.quantize_offload:
            bpt *= self.mem.cfg.quant_ratio   # the INT8 payload (Eq. 8)
        need = n_tokens * bpt / self.cfg.swap_bw - (time.perf_counter() - t0)
        if need > 0:
            self._stall_debt += need

    def _tier_import(self, rid: int, toks: List[int], t: float) -> int:
        """Pull a cluster-tier prefix into the local prefix cache when the
        tier holds more of ``toks`` than the local index.  The pages land
        in the index under the refcount discipline of a local publish, so
        the caller's ``prefix_acquire`` then maps (paged) or copies (dense)
        them like any local hit.  Returns the imported token watermark (0:
        the tier adds nothing over the local cache)."""
        cap = len(toks) - 1
        if cap <= 0 or not self._prefix_ok:
            return 0
        local = self.kv.prefix_probe(toks)
        want = self.tier.probe(toks, cap)
        if want <= local:
            return 0
        handle = self.tier.acquire(toks, want)
        if handle is None:
            return 0
        t0 = time.perf_counter()
        try:
            if handle.lossy:
                # a quantized tier's pages went through INT8: like an INT8
                # swap, nothing derived from them is ever published
                self._lossy_kv.add(rid)
            got = self.kv.tier_fill(toks, handle)
        finally:
            handle.release()
        if got > local:
            self.mem.note_tier_import(t, handle.nbytes)
            if self.cfg.realtime_swap:
                need = (handle.nbytes / self.cfg.swap_bw
                        - (time.perf_counter() - t0))
                if need > 0:
                    self._stall_debt += need
            if self.bus is not None:
                self.bus.emit("tier_import", t=t, req_id=rid,
                              replica=self.name, tokens=got,
                              bytes=handle.nbytes,
                              pages=len(handle.payloads))
        return got

    def _offload(self, req: Request) -> None:
        t0 = time.perf_counter()
        blob = self.kv.offload(req.req_id)
        if self.cfg.quantize_offload:
            self._lossy_kv.add(req.req_id)
        else:
            # an exact blob names the tokens it covers, so that the
            # upload can map still-shared prefix pages in again instead
            # of forking private copies
            blob["tokens"] = self._prefill_target_tokens(req)[
                :blob["lengths"]]
        self.host_pool[req.req_id] = blob
        self._swap_stall(blob["lengths"], t0)

    def _upload(self, req: Request) -> None:
        t0 = time.perf_counter()
        blob = self.host_pool.pop(req.req_id)
        self.kv.upload(req.req_id, blob)
        self._swap_stall(blob["lengths"], t0)

    def _drop_kv(self, req_id: int) -> None:
        """Delete all engine-side KV for a request (lane/pages + host pool)."""
        self.kv.clear(req_id)
        self.host_pool.pop(req_id, None)
        self._lossy_kv.discard(req_id)
        if self._draft is not None:
            self._draft.release(req_id)

    def _spill(self, victim: Request, t: float, reason: str) -> None:
        """Preempt a resident victim to host DRAM — the single offload path
        shared by the planned swap-out, page-shortfall and mid-iteration
        grow sites (KV move + memory accounting + request state +
        events)."""
        t0 = time.perf_counter()
        self._offload(victim)
        op = self.mem.offload(victim, t)
        victim.state = RequestState.PREEMPTED
        victim.preempt_count += 1
        if self.bus is not None:
            self.bus.emit("preempt", t=t, req_id=victim.req_id,
                          replica=self.name, reason=reason)
            self.bus.emit("swap_out", t=self._span_t(t, t0),
                          dur=max(op.done_time - op.issue_time, 0.0),
                          req_id=victim.req_id, replica=self.name,
                          bytes=op.bytes,
                          quantized=self.cfg.quantize_offload)

    def _publish(self, req: Request, tokens, t: float) -> None:
        """Publish ``req``'s materialized full pages of ``tokens`` (up to
        its prefilled watermark) to the prefix index."""
        pages = self.kv.prefix_publish(req.req_id, tokens, req.prefilled)
        if pages and self.bus is not None:
            self.bus.emit("prefix_publish", t=t, req_id=req.req_id,
                          replica=self.name, pages=pages)

    # ------------------------------------------------------------ main loop
    def submit(self, req: Request, now: float = 0.0) -> None:
        """Enqueue a request.  Re-entrant: a released request resumes from
        its existing ``output_tokens`` via the recompute path."""
        with self.step_lock:
            self._generated_of[req.req_id] = list(req.output_tokens)
            if self._prefix_ok and req.prompt_tokens:
                # speculative pricing: the scheduler charges only the
                # uncached suffix (matched for real at prefill time); probed
                # before sched.submit, so the predictor sees the watermark
                req.cached_prefix_hint = self.kv.prefix_probe(
                    self._prefill_target_tokens(req))
            self.sched.submit(req, now)
            self._refresh_backlog()

    def submit_nowait(self, req: Request, now: float = 0.0) -> None:
        """Non-blocking intake for the concurrent pump: park the request in
        the submit mailbox (drained at the start of the next step) instead
        of waiting on ``step_lock`` behind an in-flight iteration.  Depth
        and backlog count parked requests at once; the cached-prefix hint
        is set here, before parking, so the mailbox term of
        :meth:`predicted_backlog` prices only the uncached suffix (the
        probe takes no lock: it reads the index and degrades to 0 on a
        racing mutation)."""
        if self._prefix_ok and req.prompt_tokens:
            req.cached_prefix_hint = self.kv.prefix_probe(
                self._prefill_target_tokens(req))
        with self._submit_lock:
            self._submit_box.append((req, now))

    def _drain_submit_box(self) -> None:
        """Move mailbox arrivals into the scheduler (under step_lock)."""
        with self._submit_lock:
            box, self._submit_box = self._submit_box, []
        for req, t in box:
            self.submit(req, t)

    def poll_events(self) -> List[EngineEvent]:
        """Drain streaming events produced since the last poll (recorded
        only while ``stream_events`` is set)."""
        with self._events_lock:
            evs, self._events = self._events, []
        return evs

    def _emit_event(self, ev: EngineEvent) -> None:
        with self._events_lock:
            self._events.append(ev)

    def release(self, req_id: int) -> Optional[Request]:
        """Detach a live request without finishing it (drain / cancel):
        frees its lane/pages, host-pool KV and memory accounting."""
        with self.step_lock, CAPTURE_GATE.shared():
            req = self.sched.live.get(req_id)
            if req is None:
                return None
            self._drop_kv(req_id)
            self.sched.release(req)
            self._generated_of.pop(req_id, None)
            req.state = RequestState.QUEUED
            self._refresh_backlog()
            return req

    def drain(self) -> List[Request]:
        """Release every live request, and every mailbox arrival not yet
        scheduled, for re-enqueue elsewhere."""
        with self._submit_lock:
            box, self._submit_box = self._submit_box, []
        with self.step_lock:
            out = [self.release(rid) for rid in list(self.sched.live.keys())]
        return out + [req for req, _ in box]

    def cancel(self, req_id: int, t: float = 0.0) -> bool:
        """Client abort: free all engine state and emit a cancel event."""
        # parked in the submit mailbox: cancellable without the step lock
        with self._submit_lock:
            for i, (req, _) in enumerate(self._submit_box):
                if req.req_id == req_id:
                    del self._submit_box[i]
                    req.state = RequestState.CANCELLED
                    req.finish_time = t
                    if self.stream_events:
                        self._emit_event(EngineEvent("cancel", req_id, t))
                    return True
        with self.step_lock:
            req = self.release(req_id)
            if req is None:
                return False
            req.state = RequestState.CANCELLED
            req.finish_time = t
        if self.stream_events:
            self._emit_event(EngineEvent("cancel", req_id, t))
        return True

    # ------------------------------------------------ scheduler-facing reads
    def _refresh_backlog(self) -> None:
        self._backlog_cache, self._backlog_q90 = \
            self.sched.backlog_quantiles()

    def queue_depth(self) -> int:
        return len(self.sched.live) + len(self._submit_box)

    def predicted_backlog(self, quantile: Optional[float] = None) -> float:
        """Predicted remaining seconds of live work (routing, admission):
        the snapshot refreshed under ``step_lock`` at the end of every
        step, submit and release, so a caller on another thread never
        races a step.  ``quantile >= 0.9`` reads the p90 remaining-length
        surface (the conservative backlog), else the p50 one.  Mailbox
        arrivals not yet scheduled add their remaining prefill estimate
        (the chunked-prefill cost model over the prefill target, less what
        is already materialized or hinted cached), so back-to-back
        dispatches do not all see a stale zero."""
        chunk = self.sched.cfg.prefill_chunk
        with self._submit_lock:
            pending = sum(self.latency.prefill_time_remaining(
                              req.prefill_target,
                              max(req.prefilled, req.cached_prefix_hint),
                              chunk)
                          for req, _ in self._submit_box)
        base = (self._backlog_q90 if quantile is not None and quantile >= 0.9
                else self._backlog_cache)
        return base + pending

    def gauges(self) -> Dict[str, float]:
        """Replica-level occupancy snapshot: memory, queue and backlog,
        MLFQ depths, page pool, prefix cache and the predictor's
        gauges."""
        g = self.mem.gauges()
        g["queue_depth"] = float(self.queue_depth())
        g["backlog_s"] = float(self._backlog_cache)
        g["live_requests"] = float(len(self.sched.live))
        for i, d in enumerate(self.sched.queue_depths()):
            g[f"mlfq_q{i}_depth"] = float(d)
        pool = getattr(self.kv, "pool", None)
        if pool is not None:
            g["pool_free_pages"] = float(len(pool.free_pages))
            g["pool_total_pages"] = float(pool.cfg.num_pages)
            g["pool_utilization"] = float(pool.utilization())
        if self._prefix_ok:
            st = self.kv.prefix_stats().as_dict()
            probes = st["hits"] + st["partial_hits"] + st["misses"]
            g["prefix_hit_ratio"] = ((st["hits"] + st["partial_hits"])
                                     / probes if probes else 0.0)
            for k, v in st.items():
                g[f"prefix_{k}"] = float(v)
        if self.tier is not None:
            g.update(self.tier.gauges())
        g.update(self.predictor.gauges())
        index = self.model.device.index
        g["device_index"] = float(index) if index is not None else -1.0
        return g

    def prefix_probe(self, prompt_tokens) -> int:
        """Expected shared-prefix hit for a prompt on this engine (0 when
        the cache is off)."""
        if not self._prefix_ok or not prompt_tokens:
            return 0
        return self.kv.prefix_probe(prompt_tokens)

    def prefill_estimate(self, prompt_len: int,
                         prompt_tokens=None) -> float:
        """Prefill term of an expected-TTFT admission gate: with chunked
        prefill only the first chunk gates (later chunks interleave with
        decode), a monolithic prefill charges the whole prompt; with the
        prefix cache only the uncached suffix is charged.  With a cluster
        tier, a prompt the tier holds further costs its transfer plus the
        first uncached chunk from the imported watermark, when that is
        less."""
        chunk = self.sched.cfg.prefill_chunk
        cap = max(prompt_len - 1, 0)
        hit = min(self.prefix_probe(prompt_tokens), cap)
        if hit <= 0:
            est = self.latency.first_chunk_time(prompt_len, chunk)
        else:
            rem = prompt_len - hit
            est = self.latency.prefill_chunk_time(
                hit, min(rem, chunk) if chunk else rem)
        if self.tier is not None and prompt_tokens:
            t_hit, t_bytes = self.tier.probe_bytes(prompt_tokens, cap)
            if t_hit > hit:
                rem = prompt_len - t_hit
                est = min(est, t_bytes / self.cfg.swap_bw
                          + self.latency.prefill_chunk_time(
                              t_hit, min(rem, chunk) if chunk else rem))
        return est

    def serve(self, requests: List[Request], realtime: bool = False,
              max_wall_s: float = 600.0) -> List[Request]:
        """Batch driver: serve all requests to completion on the wall clock
        (a thin wrapper over submit()/step()/poll_events()).  The clock's
        zero, to which the requests' times are relative, is the
        ``time.perf_counter()`` stamp kept in ``self.serve_started``."""
        t_start = self.serve_started = time.perf_counter()
        pending = sorted(requests, key=lambda r: r.arrival_time)
        i_arr = 0

        def now() -> float:
            return time.perf_counter() - t_start

        while (i_arr < len(pending) or self.sched.live) \
                and now() < max_wall_s:
            t = now()
            while i_arr < len(pending) and (
                    not realtime or pending[i_arr].arrival_time <= t):
                self.submit(pending[i_arr], t)
                i_arr += 1
            ran_any = self.step(now())
            self.poll_events()          # batch mode: nobody streams; discard
            if not ran_any:
                if i_arr >= len(pending) and not self.sched.live:
                    break
                time.sleep(0.0005)
        return requests

    def _reserve_pages(self, runnable: List[Request], t: float
                       ) -> List[Request]:
        """Decoding one token may cross a page boundary; when the pool
        can't supply the fresh pages, spill the largest-context runnable
        requests until the rest fit."""
        runnable = list(runnable)
        while runnable:
            short = self.kv.pages_shortfall([r.req_id for r in runnable])
            if short <= 0:
                break
            if self.mem.reclaim_cache(short) > 0:
                continue
            victim = max(runnable, key=lambda r: r.context_len)
            runnable.remove(victim)
            self._spill(victim, t, "page_shortfall")
        return runnable

    def step(self, t: float) -> bool:
        """One scheduling + execution iteration at time ``t`` (a virtual or
        wall clock the caller owns); returns whether work ran."""
        generated_of = self._generated_of
        with self.step_lock, CAPTURE_GATE.shared():
            self._step_wall0 = time.perf_counter()
            self._drain_submit_box()
            plan = self.sched.plan(t)

            for r in plan.drop:            # recompute-strategy eviction
                dropped_ctx = r.context_len
                self._drop_kv(r.req_id)
                self.mem.drop(r)
                r.state = RequestState.QUEUED
                r.preempt_count += 1
                if self.bus is not None:
                    self.bus.emit("drop", t=t, req_id=r.req_id,
                                  replica=self.name, tokens=dropped_ctx)
            for r in plan.swap_out:
                if not self.kv.has(r.req_id):
                    continue               # already off-lane; nothing to move
                self._spill(r, t, "planned")
            for r in plan.swap_in:
                if self.kv.free_slot() is None:
                    continue               # retry next iteration
                t0 = time.perf_counter()
                self._upload(r)
                op = self.mem.upload(r, t)
                r.state = RequestState.PREEMPTED
                self.sched._swap_ready_at[r.req_id] = 0.0
                if self.bus is not None:
                    self.bus.emit("swap_in", t=self._span_t(t, t0),
                                  dur=max(op.done_time - op.issue_time, 0.0),
                                  req_id=r.req_id, replica=self.name,
                                  bytes=op.bytes)

            ran_any = False
            # prefill chunks execute as encountered; decode lanes collect
            # into one fused batch
            decode_lanes: List[Request] = []
            for item in plan.items:
                if isinstance(item, DecodeLane):
                    decode_lanes.append(item.req)
                elif isinstance(item, PrefillPack):
                    ran_any |= self._exec_prefill_pack(item, generated_of, t)
                else:
                    ran_any |= self._exec_prefill_chunk(item, generated_of, t)

            runnable = [r for r in decode_lanes if self.kv.has(r.req_id)]
            if runnable:
                runnable = self._reserve_pages(runnable, t)
            if runnable:
                t0 = time.perf_counter()
                B = self.cfg.max_slots
                k1 = (self.cfg.spec_k + 1) if self._spec_ok else 1
                tokens = np.zeros((B, k1), np.int32)
                n_drafts = np.zeros((B,), np.int32)
                active = np.zeros((B,), bool)
                base_gen = np.zeros((B,), np.int32)
                base_ctx = np.zeros((B,), np.int32)
                true_len = np.full((B,), np.iinfo(np.int32).max, np.int32)
                rids = np.zeros((B,), np.int32)
                slot_of = {}           # pinned: a mid-loop spill may evict
                for r in runnable:
                    slot = self.kv.slot_of(r.req_id)
                    slot_of[r.req_id] = slot
                    gen = generated_of[r.req_id]
                    tokens[slot, 0] = gen[-1] if gen else r.prompt_tokens[-1]
                    if self._spec_ok:
                        drafts = self._draft.propose(
                            r.req_id, list(r.prompt_tokens) + gen,
                            self.cfg.spec_k)
                        tokens[slot, 1:1 + len(drafts)] = drafts
                        n_drafts[slot] = len(drafts)
                    active[slot] = True
                    base_gen[slot] = r.generated
                    base_ctx[slot] = r.context_len
                    rids[slot] = r.req_id
                    if self.cfg.respect_true_len:
                        true_len[slot] = r.true_out_len
                    r.state = RequestState.RUNNING
                if self._spec_ok:
                    # one verify-k step: score the fed token and every
                    # draft, accept the longest exact-match run, sample the
                    # bonus token, terminate; one host sync for up to
                    # spec_k + 1 tokens per lane
                    samples, n_emit, reasons = self.kv.decode_verify(
                        self.params, tokens, n_drafts, active, base_gen,
                        base_ctx, true_len, rids)
                elif self.cfg.fused_decode:
                    # one step: decode + sample + terminate on the device
                    toks, reasons = self.kv.decode(
                        self.params, tokens, active, base_gen + 1,
                        base_ctx + 1, true_len, rids)
                else:
                    logits = self.kv.decode_logits(self.params, tokens,
                                                   active)
                    if logits.is_cuda:
                        torch.cuda.synchronize(logits.device)
                ctx_tokens = int(sum(r.context_len for r in runnable))
                dt = time.perf_counter() - t0
                self.iter_times.append((t0, ctx_tokens, len(runnable), dt))
                if self.bus is not None:
                    extra = {}
                    if self._spec_ok:
                        extra = dict(
                            drafted=int(n_drafts.sum()),
                            accepted=int(sum(
                                max(int(n_emit[sl]) - 1, 0)
                                for sl in slot_of.values())))
                    self.bus.emit("decode_iter", t=self._span_t(t, t0),
                                  dur=dt, replica=self.name,
                                  batch=len(runnable),
                                  ctx_tokens=ctx_tokens, **extra)
                for r in runnable:
                    # accepted even if a neighbour's mem.grow() spill
                    # offloaded r mid-loop: this decode already wrote r's
                    # fed token's KV, so skipping would duplicate it
                    slot = slot_of[r.req_id]
                    if self._spec_ok:
                        m = int(n_emit[slot])
                        r.spec_iters += 1
                        r.spec_drafted += int(n_drafts[slot])
                        r.spec_accepted += max(m - 1, 0)
                        for i in range(m):
                            self._accept_token(
                                r, int(samples[slot, i]), generated_of, t,
                                reason=(REASONS[int(reasons[slot])]
                                        if i == m - 1 else ""))
                        continue
                    if self.cfg.fused_decode:
                        tok, reason = int(toks[slot]), REASONS[
                            int(reasons[slot])]
                    else:               # legacy: sample lane by lane
                        tok, reason = self._sample_host(
                            logits[slot], r.req_id, r.generated + 1,
                            r.context_len + 1, self._true_len_of(r))
                    self._accept_token(r, tok, generated_of, t,
                                       reason=reason)
                ran_any = True
            if self.bus is not None and plan.hol_blocked:
                # charge each blocked higher-priority request the wall time
                # of the iteration that ran lower-priority work ahead of it
                iter_dt = time.perf_counter() - self._step_wall0
                for r in plan.hol_blocked:
                    self.bus.emit("hol_blocked", t=t, dur=iter_dt,
                                  req_id=r.req_id, replica=self.name,
                                  level=r.priority_level)
            self._refresh_backlog()
            stall, self._stall_debt = self._stall_debt, 0.0
        # learning happens outside step_lock, after the dispatch work
        self.predictor.drain_feedback()
        if stall > 0:
            time.sleep(stall)              # modeled transfers, lock released
        return ran_any

    def step_and_poll(self, t: float) -> Tuple[bool, List[EngineEvent]]:
        """One iteration plus its events, as one call for an executor
        thread (the gateway's pump dispatches them on the loop thread, in
        order)."""
        ran = self.step(t)
        return ran, self.poll_events()

    def _accept_token(self, req: Request, tok: int, generated_of, t: float,
                      reason: str = ""):
        """Record a sampled token; ``reason`` is the termination verdict
        from ``sample_and_reason``."""
        req.generated += 1
        # the fed token's predecessors are all materialized
        req.prefilled = req.prompt_len + max(req.generated - 1, 0)
        generated_of[req.req_id].append(tok)
        req.output_tokens.append(tok)
        if self.stream_events:
            self._emit_event(EngineEvent(
                "token", req.req_id, t, token=tok,
                index=len(req.output_tokens) - 1))
        if req.first_token_time is None:
            req.first_token_time = t
        # a request spilled mid-iteration lives in DRAM now; its byte
        # growth is settled at upload time
        if self.mem.resident_hbm(req) and not self.mem.grow(req):
            others = [r for r in self.sched.live.values()
                      if self.mem.resident_hbm(r) and r.req_id != req.req_id]
            if others:
                victim = max(others, key=lambda r: r.context_len)
                self._spill(victim, t, "hbm_grow")
                self.mem.grow(req)
        if reason:
            if (self._prefix_ok and req.prompt_tokens
                    and req.req_id not in self._lossy_kv):
                # finish-time publish: a multi-turn follow-up resends the
                # whole conversation, so the generated tokens' full pages
                # are worth caching too (materialized up to the prefilled
                # watermark; the fed token's KV is not)
                self._publish(req, self._prefill_target_tokens(req), t)
            self._drop_kv(req.req_id)      # lane/pages or host-pool copy
            self.sched.note_finished(req, t)
            if self.bus is not None:
                # self-contained: arrival, first token and prediction ride
                # along, so an engine-only trace yields length and TTFT
                # error distributions
                self.bus.emit("finish", t=t, req_id=req.req_id,
                              replica=self.name, reason=reason,
                              generated=req.generated,
                              predicted=req.predicted_len,
                              cached_prefix=req.cached_prefix_hint,
                              arrival_t=req.arrival_time,
                              first_token_t=req.first_token_time,
                              preempts=req.preempt_count,
                              demotions=req.demotions)
            self._generated_of.pop(req.req_id, None)
            if self.stream_events:
                self._emit_event(EngineEvent(
                    "finish", req.req_id, t, reason=reason))
        else:
            self.sched.note_generated(req, t)

    # ----------------------------------------------------------- profiling
    def fit_latency_model(self) -> LatencyModel:
        """Fit Eq. 3-5 coefficients from this engine's measured step
        times."""
        decode = [(ctx / max(b, 1), dt) for _, ctx, b, dt in self.iter_times]
        prefill = [(n, dt) for _, n, dt, _ in self.prefill_times]
        return LatencyModel.fit(prefill, decode)

    def autotune_token_budget(self, target_tpot: float) -> Optional[int]:
        """Set ``iter_token_budget`` from the fitted latency model: the
        budget whose predicted mixed-iteration time (a full decode batch
        plus prefill-chunk fill) meets ``target_tpot``.  Needs profiled
        iterations (serve a warm batch first); returns the chosen budget
        (None leaves the budget unbounded)."""
        lm = self.fit_latency_model()
        if self.iter_times:
            ctx = float(np.mean([c / max(b, 1)
                                 for _, c, b, _ in self.iter_times]))
        else:
            ctx = self.cfg.max_seq_len / 2
        budget = lm.budget_for_tpot(target_tpot, self.cfg.max_slots, ctx)
        with self.step_lock:
            self.sched.cfg.iter_token_budget = budget
        return budget
