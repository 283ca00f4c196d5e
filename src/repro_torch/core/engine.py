"""Real-execution serving engine of the PyTorch port: continuous batching +
ALISE scheduling over an actual model (paper §3.3), on a pluggable KV
backend chosen by the model's family: the paged KV pool for the attention
family, the dense slotted state cache for the ``ssm`` family.

The engine drives the same Scheduler / TieredKVManager policy code as the
JAX package (its own copy) and executes each
:class:`~repro_torch.core.scheduler.IterationPlan`:

  * chunked, resumable prefill: each :class:`PrefillChunk` runs through
    ``Model.paged_prefill_chunk``, KV written into the page pool on the
    device, resuming from the partially-filled pages.  A family without
    chunked prefill (``ssm``) runs the whole prompt through the monolithic
    ``Model.prefill`` and places its state in a dense lane;
  * one fused decode step per iteration (``Model.paged_decode_step_sampled``
    or ``Model.decode_step_sampled``): embedding, layer stack, KV or state
    writes, attention or the SSM recurrence, sampling and termination run
    on the device; the host copies one ``(tokens, reasons)`` pair;
  * request-level swapping between the device and a host pool: paged KV
    quantized to INT8 on the device by the ``kv_quant`` kernels (Eq. 8) so
    the host link carries the INT8 payload; an SSM request's conv and SSM
    state moved raw;
  * per-iteration wall-time profiling (bounded ring buffers) used to fit
    the Eq. 3-5 latency model.

Not ported yet (``EngineConfig`` options that ask for one raise
``NotImplementedError`` naming the ``ROADMAP.md`` Queue 1 item): the dense
backend of the attention family, packed prefill, the shared-prefix cache,
speculative decoding, and the cluster tier; the observability bus is left
out.

Correctness invariant (tested): with greedy sampling and quantization off,
generated tokens do not depend on how jobs are preempted and swapped, on
``paged_attn_impl`` (gather | kernel) or on ``Model.chunk_attn_impl``
(masked | flash).
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
from repro_torch.core.scheduler import (DecodeLane, PrefillChunk, Scheduler,
                                        SchedulerConfig)
from repro_torch.models.model import Model
from repro_torch.serving.kv_cache import (DenseKVBackend, KVBackendConfig,
                                          PagedKVBackend)
from repro_torch.serving.sampler import REASONS, sample_and_reason


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
    kv_backend: Optional[str] = None       # None = the model's own: paged
                                           # (attention family) | dense (ssm)
    page_size: int = 16                    # paged backend page granularity
    paged_attn_impl: str = "gather"        # gather (bit-exact reference) |
                                           # kernel (CUDA paged attention)
    prefill_chunk: Optional[int] = None    # max prompt tokens per prefill
                                           # chunk (None = whole prompt in
                                           # one chunk)
    iter_token_budget: Optional[int] = None  # scheduler token budget per
                                             # iteration (None = unbounded)
    prefill_buckets: Optional[Tuple[int, ...]] = None
    # fixed menu of chunk-shape buckets (sorted ascending); None = pow2
    prefill_pack: bool = False             # not ported (Queue 1 item 8)
    prefix_cache: bool = False             # not ported (Queue 1 item 7)
    spec_decode: bool = False              # not ported (Queue 1 item 9)
    warmup_compile: bool = False           # run warmup() at construction
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


def _kv_backend(cfg: EngineConfig, model: Model) -> str:
    """The KV backend: the model's own (paged for the attention family,
    dense for ``ssm``); naming the other one raises."""
    own = "paged" if model.supports_paged() else "dense"
    backend = cfg.kv_backend or own
    if backend not in ("paged", "dense"):
        raise ValueError(f"unknown kv_backend: {backend!r}")
    if backend != own and own == "paged":
        raise NotImplementedError(
            f"kv_backend='dense' for family={model.cfg.family} (the "
            "attention family's dense backend: ROADMAP.md Queue 1 item 5) "
            "is not ported yet")
    if backend != own:
        raise ValueError(f"family={model.cfg.family} has no paged KV (its "
                         "state is constant-size): use kv_backend='dense'")
    return backend


def _not_ported(cfg: EngineConfig) -> None:
    todo = [(cfg.prefill_pack, "prefill_pack (ROADMAP.md Queue 1 item 8)"),
            (cfg.prefix_cache, "prefix_cache (ROADMAP.md Queue 1 item 7)"),
            (cfg.spec_decode, "spec_decode (ROADMAP.md Queue 1 item 9)")]
    for bad, what in todo:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet")


class ServingEngine:
    def __init__(self, model: Model, params, cfg: EngineConfig,
                 predictor: Optional[LengthPredictor] = None,
                 latency: Optional[LatencyModel] = None):
        _not_ported(cfg)
        self.kv_backend = _kv_backend(cfg, model)
        self.model = model
        self.params = params
        self.cfg = cfg
        acfg = model.cfg
        bpt = kv_bytes_per_token(acfg.num_layers, acfg.num_kv_heads, acfg.hd)
        hbm = cfg.hbm_bytes or (cfg.max_slots * cfg.max_seq_len * bpt)
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
        buckets: Optional[Tuple[int, ...]] = None
        if self._chunked_ok and cfg.prefill_chunk and cfg.prefill_buckets:
            buckets = tuple(sorted({int(b) for b in cfg.prefill_buckets}))
            if buckets[0] <= 0:
                raise ValueError("prefill buckets must be positive")
        self._buckets = buckets
        sched_cfg = SchedulerConfig(
            max_batch=cfg.max_slots, n_queues=cfg.n_queues,
            base_quantum=cfg.base_quantum, quantum_growth=cfg.quantum_growth,
            age_threshold=cfg.age_threshold, strategy=cfg.strategy,
            max_new_tokens=cfg.max_new_tokens,
            prefill_chunk=(cfg.prefill_chunk if self._chunked_ok else None),
            iter_token_budget=cfg.iter_token_budget,
            prefill_buckets=buckets)
        self.sched = Scheduler(sched_cfg, self.predictor, self.latency, self.mem)

        bcfg = KVBackendConfig(
            max_slots=cfg.max_slots, max_seq_len=cfg.max_seq_len,
            eos_token=cfg.eos_token, max_new_tokens=cfg.max_new_tokens,
            greedy=cfg.greedy, temperature=cfg.temperature, top_k=cfg.top_k,
            quantize_offload=cfg.quantize_offload, page_size=cfg.page_size,
            attn_impl=cfg.paged_attn_impl, seed=cfg.seed,
            prefill_buckets=buckets)
        if self.kv_backend == "paged":
            num_pages = max(1, int(hbm // (cfg.page_size * bpt)))
            self.kv = PagedKVBackend(model, bcfg, num_pages)
        else:
            self.kv = DenseKVBackend(model, bcfg)
        self.host_pool: Dict[int, dict] = {}       # req_id -> offloaded KV
        # bounded profiling rings (entries lead with a perf_counter stamp):
        #   iter_times:    (t_mono, ctx_tokens, batch, dt)
        #   prefill_times: (t_mono, n_tokens, dt)
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
        self.device = cfg.device or default_device_label(model.device)
        if cfg.warmup_compile:
            self.warmup()

    # -------------------------------------------------------------- prefill
    def _sample_host(self, logits_row, rid: int, new_gen: int, new_ctx: int,
                     true_len: int):
        """One-row sampling + termination for prefill first tokens — the
        same ``sample_and_reason`` chain the fused decode step runs, with
        the same per-(request, token-index) draw.  Returns
        ``(token, reason_str)``."""
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
        """Monolithic prefill for families without chunked prefill
        (``ssm``): one ``Model.prefill`` pass over the whole prompt, its
        state placed into a free lane.  The prompt goes in unpadded: an SSM
        state depends on every step.  Returns the last-token logits
        (1, V)."""
        if self.kv.free_slot() is None:
            raise RuntimeError("no free decode lane: the caller must check "
                               "free_slot()")
        toks = torch.as_tensor([tokens], dtype=torch.int64,
                               device=self.model.device)
        logits, pcache = self.model.prefill(self.params, {"tokens": toks})
        self.kv.write_prefill(req.req_id, pcache, len(tokens))
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
        checks, page reservation, memory admission.  Returns ``(status,
        start, target_toks)`` with status ``"blocked"`` (cannot run this
        iteration) or ``"ready"``."""
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
        return "ready", start, target_toks

    def _exec_prefill_chunk(self, chunk: PrefillChunk, generated_of,
                            t: float) -> bool:
        """Execute one PrefillChunk: claim a lane and admit memory, run the
        chunk through the backend's resumable prefill (or, for a family
        without one, the whole target through the monolithic prefill) and,
        when the final chunk of a fresh prefill completes, sample the first
        token.  Returns whether the chunk made progress."""
        r = chunk.req
        status, start, target_toks = self._chunk_prework(chunk, t)
        if status != "ready":
            return False
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
        if chunk.last and r.generated == 0:   # fresh prefill emits a token
            tok, reason = self._sample_host(
                logits[0], r.req_id, 1, r.context_len + 1,
                self._true_len_of(r))
            dt = time.perf_counter() - t0
            self._accept_token(r, tok, generated_of, t, reason=reason)
        else:
            if logits.is_cuda:
                torch.cuda.synchronize(logits.device)
            dt = time.perf_counter() - t0
        self.prefill_times.append((t0, n_toks, dt))
        return True

    # -------------------------------------------------------------- warmup
    def warmup(self) -> Dict[int, float]:
        """Time one chunk per prefill bucket on an idle engine (twice: the
        first run loads kernels and allocator pools, the second measures)
        and the all-inactive decode step; the measured seconds land in
        ``self.latency.bucket_costs`` so EWT prices a bucketed chunk at its
        padded cost.  Warm chunks write a throwaway lane whose pages are
        freed; the inactive decode writes only the paged backend's scratch
        page (the dense backend keeps inactive lanes' state).  A family
        without chunked prefill has no bucket to time."""
        if self.sched.live:
            raise RuntimeError("warmup() requires an idle engine")
        costs: Dict[int, float] = {}
        menu = self._buckets
        if menu is None and self._chunked_ok and self.cfg.prefill_chunk:
            menu = default_bucket_menu(self.cfg.prefill_chunk)
        warm_rid = -(1 << 30)       # never collides with real request ids
        for b in (menu or ()):
            if b > self.cfg.max_seq_len:
                break
            for _ in range(2):
                t0 = time.perf_counter()
                logits = self.kv.prefill_chunk(self.params, warm_rid,
                                               [1] * b, 0)
                logits.cpu()
                costs[b] = time.perf_counter() - t0
                self.kv.clear(warm_rid)
        B = self.cfg.max_slots
        zeros = np.zeros((B,), np.int32)
        self.kv.decode(self.params, np.zeros((B, 1), np.int32),
                       np.zeros((B,), bool), zeros, zeros,
                       np.full((B,), np.iinfo(np.int32).max, np.int32), zeros)
        if costs:
            merged = dict(self.latency.bucket_costs or {})
            merged.update(costs)
            self.latency.bucket_costs = merged
        return costs

    # ------------------------------------------------------------ swapping
    def _offload(self, req: Request) -> None:
        self.host_pool[req.req_id] = self.kv.offload(req.req_id)

    def _upload(self, req: Request) -> None:
        self.kv.upload(req.req_id, self.host_pool.pop(req.req_id))

    def _drop_kv(self, req_id: int) -> None:
        """Delete all engine-side KV for a request (lane/pages + host pool)."""
        self.kv.clear(req_id)
        self.host_pool.pop(req_id, None)

    def _spill(self, victim: Request, t: float, reason: str) -> None:
        """Preempt a resident victim to host DRAM — the single offload path
        shared by the planned swap-out, page-shortfall and mid-iteration
        grow sites (KV move + memory accounting + request state)."""
        self._offload(victim)
        self.mem.offload(victim, t)
        victim.state = RequestState.PREEMPTED
        victim.preempt_count += 1

    # ------------------------------------------------------------ main loop
    def submit(self, req: Request, now: float = 0.0) -> None:
        """Enqueue a request.  Re-entrant: a released request resumes from
        its existing ``output_tokens`` via the recompute path."""
        with self.step_lock:
            self._generated_of[req.req_id] = list(req.output_tokens)
            self.sched.submit(req, now)

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
        with self.step_lock:
            req = self.sched.live.get(req_id)
            if req is None:
                return None
            self._drop_kv(req_id)
            self.sched.release(req)
            self._generated_of.pop(req_id, None)
            req.state = RequestState.QUEUED
            return req

    def drain(self) -> List[Request]:
        """Release every live request for re-enqueue elsewhere."""
        with self.step_lock:
            return [self.release(rid) for rid in list(self.sched.live.keys())]

    def cancel(self, req_id: int, t: float = 0.0) -> bool:
        """Client abort: free all engine state and emit a cancel event."""
        with self.step_lock:
            req = self.release(req_id)
            if req is None:
                return False
            req.state = RequestState.CANCELLED
            req.finish_time = t
        if self.stream_events:
            self._emit_event(EngineEvent("cancel", req_id, t))
        return True

    def serve(self, requests: List[Request], realtime: bool = False,
              max_wall_s: float = 600.0) -> List[Request]:
        """Batch driver: serve all requests to completion on the wall clock
        (a thin wrapper over submit()/step()/poll_events())."""
        t_start = time.perf_counter()
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
        with self.step_lock:
            plan = self.sched.plan(t)

            for r in plan.drop:            # recompute-strategy eviction
                self._drop_kv(r.req_id)
                self.mem.drop(r)
                r.state = RequestState.QUEUED
                r.preempt_count += 1
            for r in plan.swap_out:
                if not self.kv.has(r.req_id):
                    continue               # already off-lane; nothing to move
                self._spill(r, t, "planned")
            for r in plan.swap_in:
                if self.kv.free_slot() is None:
                    continue               # retry next iteration
                self._upload(r)
                self.mem.upload(r, t)
                r.state = RequestState.PREEMPTED
                self.sched._swap_ready_at[r.req_id] = 0.0

            ran_any = False
            # prefill chunks execute as encountered; decode lanes collect
            # into one fused batch
            decode_lanes: List[Request] = []
            for item in plan.items:
                if isinstance(item, DecodeLane):
                    decode_lanes.append(item.req)
                elif isinstance(item, PrefillChunk):
                    ran_any |= self._exec_prefill_chunk(item, generated_of, t)
                else:
                    raise NotImplementedError(
                        f"{type(item).__name__} plan items are not ported "
                        "yet (ROADMAP.md Queue 1 item 8)")

            runnable = [r for r in decode_lanes if self.kv.has(r.req_id)]
            if runnable:
                runnable = self._reserve_pages(runnable, t)
            if runnable:
                t0 = time.perf_counter()
                B = self.cfg.max_slots
                tokens = np.zeros((B, 1), np.int32)
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
                    active[slot] = True
                    base_gen[slot] = r.generated
                    base_ctx[slot] = r.context_len
                    rids[slot] = r.req_id
                    if self.cfg.respect_true_len:
                        true_len[slot] = r.true_out_len
                    r.state = RequestState.RUNNING
                # one fused step: decode + sample + terminate on the device
                toks, reasons = self.kv.decode(
                    self.params, tokens, active, base_gen + 1, base_ctx + 1,
                    true_len, rids)
                ctx_tokens = int(sum(r.context_len for r in runnable))
                dt = time.perf_counter() - t0
                self.iter_times.append((t0, ctx_tokens, len(runnable), dt))
                for r in runnable:
                    # accepted even if a neighbour's mem.grow() spill
                    # offloaded r mid-loop: this decode already wrote r's
                    # fed token's KV, so skipping would duplicate it
                    slot = slot_of[r.req_id]
                    self._accept_token(r, int(toks[slot]), generated_of, t,
                                       reason=REASONS[int(reasons[slot])])
                ran_any = True
        # learning happens outside step_lock, after the dispatch work
        self.predictor.drain_feedback()
        return ran_any

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
            self._drop_kv(req.req_id)      # lane/pages or host-pool copy
            self.sched.note_finished(req, t)
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
        prefill = [(n, dt) for _, n, dt in self.prefill_times]
        return LatencyModel.fit(prefill, decode)
