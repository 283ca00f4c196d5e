"""Iteration-level discrete-event simulator for LLM serving (paper §4).

Drives the *same* Scheduler/TieredKVManager objects as the real engine, with
execution time supplied by the analytical latency model (Eq. 3-5) that the
paper itself uses — this is what produces the paper-scale end-to-end curves
(Figs. 2/6/8/9) on a CPU-only container.

Cost model for one continuous-batching iteration (ORCA-style mixed batch,
now over the scheduler's token-budgeted :class:`IterationPlan`):
    t_iter = sum_chunks(prefill_chunk_time(start_j, size_j))
             + [beta + alpha * sum_decode(ctx_j)]
i.e. prefill chunks are compute-bound and additive (a resumed chunk pays the
per-context ``alpha`` cross-read of its prefix); the decode batch reads
weights once (beta) plus each job's KV (alpha per context token) — the
batched analog of Eq. 5.  Swaps run on a DMA queue overlapped with compute;
a job only becomes schedulable when its upload completes (paper §3.2).

The simulator executes the *same* ``IterationPlan`` contract as the real
engine (``execute_plan`` / ``account_tokens``, also driven by
``core/cluster.py``'s replicas), so scheduler-policy results stay
comparable between simulated and real execution — including chunked
prefill, where a fresh prefill's first token is emitted only by its *last*
chunk and partially-prefilled jobs resume across iterations.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.latency_model import LatencyModel, calibrated
from repro_torch.core.memory_manager import MemoryConfig, TieredKVManager
from repro_torch.core.predictor import (DefaultPredictor, LengthPredictor,
                                  OraclePredictor, ProxyPredictor,
                                  RetrievalPredictor)
from repro_torch.core.quantization import kv_bytes_per_token
from repro_torch.core.request import KVLocation, Request, RequestState
from repro_torch.core.scheduler import (DecodeLane, IterationPlan, PrefillPack,
                                  Scheduler, SchedulerConfig)
from repro_torch.core.trace import SyntheticTrace, TraceConfig, generate_trace


@dataclass
class SimConfig:
    model: str = "opt-13b"
    strategy: str = "alise"            # alise | orca | vllm | oracle | alise-defer | alise-recompute
    predictor: str = "retrieval"       # retrieval | proxy | oracle | default
                                       # | online (hit-aware quantile
                                       # regressor, serving/prediction)
    hbm_bytes: float = 8e9             # KV budget (32GB V100 minus weights)
    dram_bytes: float = 1024e9
    swap_bw: float = 32e9
    max_batch: int = 64
    n_queues: int = 4
    base_quantum: float = 1.0
    quantum_growth: float = 4.0
    age_threshold: float = 15.0
    max_new_tokens: int = 2048
    prefill_chunk: Optional[int] = None    # chunked prefill span (None = mono)
    iter_token_budget: Optional[int] = None  # per-iteration token budget
    prefill_buckets: Optional[Tuple[int, ...]] = None  # fixed chunk-shape
                                           # menu (spans round up; EWT prices
                                           # the padded dispatch)
    prefill_pack: bool = False             # fuse equal-bucket chunks from
                                           # short requests into one dispatch
    prefill_pack_width: int = 4
    prefix_cache: bool = False             # shared-prefix KV cache (hit
                                           # lengths + LRU capacity modeled;
                                           # a hit skips the cached prefix's
                                           # prefill cost)
    prefix_cache_pages: int = 4096         # index capacity (pages)
    prefix_page_size: int = 16
    kv_tier: bool = False                  # cluster-wide host-RAM KV tier:
                                           # a shared prefix pool peers
                                           # import from at upload-DMA cost
                                           # instead of re-prefilling (a
                                           # SimKVTier is built per sim, or
                                           # pass a shared one to __init__)
    tier_bytes: float = 1e9                # tier payload capacity
    spec_decode: bool = False              # verify-k speculative decoding:
                                           # lanes charge spec_k+1 budget
                                           # tokens and emit 1 + accepted
                                           # drafts per iteration
    spec_k: int = 3                        # draft tokens per lane
    spec_accept_rate: float = 0.6          # modeled per-draft accept
                                           # probability (deterministic
                                           # fractional accumulator, no RNG)
    drain_timeout: float = 600.0       # extra time after last arrival
    latency_model: Optional[LatencyModel] = None
    pretrain_requests: int = 512       # history corpus for predictor warmup
    seed: int = 0


@dataclass
class SimResult:
    strategy: str
    model: str
    rate: float
    completed: int
    total: int
    duration: float
    normalized_latency: float          # paper's headline metric (s/token)
    mean_latency: float
    p50_latency: float
    p99_latency: float
    throughput: float                  # completed requests / second
    token_throughput: float
    mean_queueing_delay: float
    preemptions: int
    swap_in_gb: float
    swap_out_gb: float
    recompute_tokens: int
    predictor_stats: Dict[str, float] = field(default_factory=dict)
    requests: List[Request] = field(default_factory=list)

    def row(self) -> Dict[str, float]:
        d = self.__dict__.copy()
        d.pop("requests")
        d.pop("predictor_stats")
        return d


def build_predictor(kind: str, trace_cfg: TraceConfig, n_history: int,
                    seed: int = 0) -> LengthPredictor:
    """Predictors are pre-trained on a *disjoint* history trace (the paper
    builds its DB from OpenChat and fine-tunes on the target dataset)."""
    if kind == "oracle":
        return OraclePredictor()
    if kind == "default":
        return DefaultPredictor()
    hist_cfg = TraceConfig(dataset=trace_cfg.dataset, rate=10.0,
                           duration=1e9, max_requests=n_history,
                           n_clusters=trace_cfg.n_clusters,
                           length_noise=trace_cfg.length_noise,
                           seed=seed + 10_000)
    hist = generate_trace(hist_cfg)
    toks = [r.prompt_tokens for r in hist.requests]
    lens = np.array([r.true_out_len for r in hist.requests], np.float32)
    if kind == "proxy":
        p = ProxyPredictor(seed=seed)
        p.pretrain(toks, lens)
        return p
    if kind == "online":
        # lazy import: core stays importable without the serving package
        from repro_torch.serving.prediction import OnlineQuantilePredictor
        p = OnlineQuantilePredictor(seed=seed)
        p.pretrain(toks, lens)
        return p
    p = RetrievalPredictor(seed=seed)
    p.pretrain(toks, lens)
    return p


class ServingSimulator:
    def __init__(self, cfg: SimConfig, trace: SyntheticTrace,
                 predictor: Optional[LengthPredictor] = None,
                 bus=None, replica: str = "sim0", tier=None):
        """``bus``: an optional virtual-clock observability EventBus —
        simulated runs emit the same event schema as the real engine, so
        trace exports and quality telemetry are comparable across both.
        ``tier``: a shared :class:`~repro_torch.serving.kv_tier.SimKVTier`
        (cluster replicas pass one instance to every member); with
        ``cfg.kv_tier`` and no instance, a private one is built."""
        self.cfg = cfg
        self.trace = trace
        self.bus = bus
        self.replica = replica
        arch = get_config(cfg.model)
        bpt = kv_bytes_per_token(arch.num_layers, arch.num_kv_heads, arch.hd)
        self.latency = cfg.latency_model or calibrated(cfg.model)

        strategy = cfg.strategy
        pred_kind = cfg.predictor
        if strategy == "oracle":
            strategy_impl, pred_kind = "alise", "oracle"
        elif strategy in ("orca", "vllm"):
            strategy_impl, pred_kind = strategy, "default"
        else:
            strategy_impl = strategy

        mem_cfg = MemoryConfig(
            hbm_bytes=cfg.hbm_bytes, dram_bytes=cfg.dram_bytes,
            bytes_per_token_fp=bpt, swap_bw=cfg.swap_bw,
            quantize_offload=True,
            reserve_policy="reserve_max" if strategy_impl == "orca" else "ondemand",
            reserve_max_tokens=cfg.max_new_tokens)
        self.mem = TieredKVManager(mem_cfg)

        self.predictor = predictor or build_predictor(
            pred_kind, trace.cfg, cfg.pretrain_requests, cfg.seed)

        sched_cfg = SchedulerConfig(
            max_batch=cfg.max_batch, n_queues=cfg.n_queues,
            base_quantum=cfg.base_quantum, quantum_growth=cfg.quantum_growth,
            age_threshold=cfg.age_threshold, strategy=strategy_impl,
            max_new_tokens=cfg.max_new_tokens,
            prefill_chunk=cfg.prefill_chunk,
            iter_token_budget=cfg.iter_token_budget,
            prefill_buckets=cfg.prefill_buckets,
            prefill_pack=cfg.prefill_pack,
            prefill_pack_width=cfg.prefill_pack_width,
            decode_width=(cfg.spec_k + 1 if cfg.spec_decode else 1))
        self.sched = Scheduler(sched_cfg, self.predictor, self.latency, self.mem)
        # per-request fractional accepted-draft accumulator: the modeled
        # accept rate emits extra tokens deterministically (no RNG), so
        # repeated runs are bit-identical
        self._spec_frac: Dict[int, float] = {}
        self.sched.bus = self.bus
        self.sched.replica = self.replica
        self.pred_overhead = 0.0
        self.prefix_index = None
        if cfg.prefix_cache:
            from repro_torch.serving.prefix_cache import SimPrefixIndex
            self.prefix_index = SimPrefixIndex(cfg.prefix_page_size,
                                               cfg.prefix_cache_pages)
            self.prefix_index.bus = self.bus
            self.prefix_index.replica = self.replica
        self.tier = tier
        if self.tier is None and cfg.kv_tier:
            from repro_torch.serving.kv_tier import SimKVTier
            pg = cfg.prefix_page_size
            self.tier = SimKVTier(pg, max(1, int(cfg.tier_bytes // (pg * bpt))),
                                  cfg.swap_bw)

    # --------------------------------------------------- plan execution
    def execute_plan(self, plan: IterationPlan, now: float):
        """Execute one IterationPlan's memory ops and cost its compute
        items (the simulated twin of ``ServingEngine.step``'s execution
        phase; also driven by ``core/cluster.py`` replicas).  Returns
        ``(t_iter, ran_any)``; the caller advances the clock and then calls
        :meth:`account_tokens`."""
        sched, mem, bus = self.sched, self.mem, self.bus
        if bus is not None:
            bus.mark(now)
        for r in plan.drop:
            dropped_ctx = r.context_len
            mem.drop(r)
            r.state = RequestState.QUEUED
            r.preempt_count += 1
            if bus is not None:
                bus.emit("drop", t=now, req_id=r.req_id,
                         replica=self.replica, tokens=dropped_ctx)
        for r in plan.swap_out:
            op = mem.offload(r, now)
            r.state = RequestState.PREEMPTED
            r.preempt_count += 1
            if bus is not None:
                bus.emit("preempt", t=now, req_id=r.req_id,
                         replica=self.replica, reason="planned")
                bus.emit("swap_out", t=now, dur=op.done_time - op.issue_time,
                         req_id=r.req_id, replica=self.replica,
                         bytes=op.bytes, quantized=mem.cfg.quantize_offload)
        for r in plan.dequantize_cold:
            mem.dequantize_cold(r, now)
        for r in plan.swap_in:
            op = mem.upload(r, now)
            r.state = RequestState.SWAPPING
            sched._swap_ready_at[r.req_id] = op.done_time
            if bus is not None:
                bus.emit("swap_in", t=now, dur=op.done_time - op.issue_time,
                         req_id=r.req_id, replica=self.replica,
                         bytes=op.bytes)

        t_iter = 0.0
        decode_ctx = 0
        ran_any = False
        tier_dma = [0.0]               # cluster-tier import DMA seconds

        def chunk_prep(chunk) -> int:
            """Admission + shared-prefix matching; returns the chunk's
            effective start (past any cached prefix)."""
            r = chunk.req
            if mem.location_of(r) == KVLocation.NONE:
                mem.admit(r)
            r.state = RequestState.RUNNING
            if r.first_scheduled_time is None:
                r.first_scheduled_time = now
            start = chunk.start
            if (chunk.start == 0 and r.prefilled == 0 and r.prompt_tokens
                    and (self.prefix_index is not None
                         or self.tier is not None)):
                # shared-prefix hit: the cached prefix costs nothing to
                # "prefill" — only the uncached suffix is charged (same
                # contract as the real engine's prefix_acquire)
                cap = r.prefill_target - 1
                hit = (self.prefix_index.hit(r.prompt_tokens, cap)
                       if self.prefix_index is not None else 0)
                if (self.tier is not None
                        and self.tier.probe(r.prompt_tokens, cap) > hit):
                    # cluster-tier import: a peer replica computed this
                    # prefix — charge upload DMA for the missing tokens
                    # instead of their prefill compute (same contract as
                    # the real engine's _tier_import)
                    moved = self.tier.hit(r.prompt_tokens, cap) - hit
                    if moved > 0:
                        bpt = mem.cfg.bytes_per_token_fp
                        tier_dma[0] += self.tier.import_time(moved, bpt)
                        if self.prefix_index is not None:
                            self.prefix_index.insert(r.prompt_tokens,
                                                     hit + moved)
                        if bus is not None:
                            bus.emit("tier_import", t=now,
                                     req_id=r.req_id,
                                     replica=self.replica, tokens=moved,
                                     bytes=moved * bpt)
                        hit += moved
                r.prefilled = hit
                r.cached_prefix_hint = hit
                start = min(hit, chunk.end)
                if hit and bus is not None:
                    bus.emit("prefix_hit", t=now, req_id=r.req_id,
                             replica=self.replica, tokens=hit)
            return start

        def chunk_finish(chunk) -> None:
            r = chunk.req
            r.prefilled = max(chunk.end, r.prefilled)
            if chunk.last and r.prompt_tokens:
                upto = min(r.prefilled, r.prompt_len)
                if self.prefix_index is not None:
                    self.prefix_index.insert(r.prompt_tokens, upto)
                if self.tier is not None:
                    self.tier.insert(r.prompt_tokens, upto)

        for item in plan.items:
            if isinstance(item, DecodeLane):
                continue                   # costed below via plan.decodes
            if isinstance(item, PrefillPack):
                # one fused dispatch: a single bucket-shaped base cost,
                # plus each member's prefix cross-read term
                members = []
                for chunk in item.chunks:
                    start = chunk_prep(chunk)
                    if chunk.end > start:
                        members.append((chunk, start))
                if members:
                    t_pack = self.latency.prefill_pack_time(
                        [c.end - s for c, s in members],
                        [s for _, s in members], item.bucket)
                    if bus is not None:
                        for chunk, start in members:
                            bus.emit("prefill_chunk", t=now + t_iter,
                                     dur=t_pack, req_id=chunk.req.req_id,
                                     replica=self.replica, start=start,
                                     end=chunk.end, tokens=chunk.end - start,
                                     last=chunk.last, fresh=chunk.fresh,
                                     bucket=chunk.bucket,
                                     pack_size=len(members))
                    t_iter += t_pack
                for chunk in item.chunks:
                    chunk_finish(chunk)
                ran_any = True
                continue
            chunk = item
            start = chunk_prep(chunk)
            if chunk.end > start:
                t_chunk = self.latency.prefill_chunk_time(
                    start, chunk.end - start, bucket=chunk.bucket)
                if bus is not None:
                    # virtual-domain span: placed at its modeled offset
                    # within the iteration, dur from the latency model
                    bus.emit("prefill_chunk", t=now + t_iter, dur=t_chunk,
                             req_id=chunk.req.req_id, replica=self.replica,
                             start=start, end=chunk.end,
                             tokens=chunk.end - start, last=chunk.last,
                             fresh=chunk.fresh, bucket=chunk.bucket,
                             pack_size=1)
                t_iter += t_chunk
            chunk_finish(chunk)
            ran_any = True
        decoders = 0
        for r in plan.decodes:
            if mem.location_of(r) != KVLocation.HBM:
                continue               # lost residency earlier this iteration
            r.state = RequestState.RUNNING
            decode_ctx += r.context_len
            decoders += 1
            ran_any = True
        if decoders:
            t_decode = self.latency.beta + self.latency.alpha * decode_ctx
            if bus is not None:
                bus.emit("decode_iter", t=now + t_iter, dur=t_decode,
                         replica=self.replica, batch=decoders,
                         ctx_tokens=decode_ctx)
            t_iter += t_decode
        t_iter += tier_dma[0]          # tier imports ride the DMA link,
                                       # serialized with this iteration
        if bus is not None and plan.hol_blocked:
            for r in plan.hol_blocked:
                bus.emit("hol_blocked", t=now, dur=t_iter,
                         req_id=r.req_id, replica=self.replica,
                         level=r.priority_level)
        return t_iter, ran_any

    def account_tokens(self, plan: IterationPlan, now: float) -> None:
        """Post-iteration token accounting for an executed plan: a *last*
        chunk of a fresh prefill and every decode lane emit one token
        (recompute completions rebuild KV without re-emitting); growth OOM
        triggers the strategy's preemption path."""
        finishing = [c.req for c in plan.chunks if c.last]
        recompute_ids = {r.req_id for r in finishing if r.generated > 0}
        lanes = {it.req.req_id: it for it in plan.items
                 if isinstance(it, DecodeLane)}
        for r in finishing + plan.decodes:
            if self.mem.location_of(r) != KVLocation.HBM:
                continue    # became an OOM victim earlier this iteration
            n_tok = 0
            if r.req_id in recompute_ids:
                pass        # recompute rebuilds KV; no new token emitted
            else:
                n_tok = 1
                lane = lanes.get(r.req_id)
                if (self.cfg.spec_decode and lane is not None
                        and lane.width > 1):
                    # modeled verify-k: each lane drafts width-1 tokens and
                    # accepts at the configured rate, accumulated
                    # fractionally so emission is deterministic
                    drafted = lane.width - 1
                    frac = (self._spec_frac.get(r.req_id, 0.0)
                            + self.cfg.spec_accept_rate * drafted)
                    extra = min(int(frac), drafted)
                    self._spec_frac[r.req_id] = frac - extra
                    cap = min(r.true_out_len,
                              self.sched.cfg.max_new_tokens)
                    extra = min(extra, max(cap - r.generated - 1, 0))
                    r.spec_iters += 1
                    r.spec_drafted += drafted
                    r.spec_accepted += extra
                    n_tok = 1 + extra
            oom_lost = False
            for _ in range(n_tok):
                r.generated += 1
                r.prefilled = r.prompt_len + max(r.generated - 1, 0)
                if r.first_token_time is None:
                    r.first_token_time = now
                if not self.mem.grow(r):
                    self._handle_oom(r, now)
                    if self.mem.location_of(r) != KVLocation.HBM:
                        oom_lost = True
                        break
            if oom_lost:
                continue
            if n_tok == 0 and not self.mem.grow(r):
                self._handle_oom(r, now)
                if self.mem.location_of(r) != KVLocation.HBM:
                    continue
            self.sched.note_generated(r, now)
            if (r.generated >= r.true_out_len
                    or r.generated >= self.sched.cfg.max_new_tokens):
                self.sched.note_finished(r, now)
                self._spec_frac.pop(r.req_id, None)
                if self.bus is not None:
                    reason = ("true_len" if r.generated >= r.true_out_len
                              else "length")
                    self.bus.emit("finish", t=now, req_id=r.req_id,
                                  replica=self.replica, reason=reason,
                                  generated=r.generated,
                                  predicted=r.predicted_len,
                                  cached_prefix=r.cached_prefix_hint,
                                  arrival_t=r.arrival_time,
                                  first_token_t=r.first_token_time,
                                  preempts=r.preempt_count,
                                  demotions=r.demotions)

    # ------------------------------------------------------------------ run
    def run(self, max_iters: int = 20_000_000) -> SimResult:
        cfg = self.cfg
        from repro_torch.core.request import reset_runtime_state
        for r in self.trace.requests:
            reset_runtime_state(r)
        arrivals = sorted(self.trace.requests, key=lambda r: r.arrival_time)
        n_total = len(arrivals)
        i_arr = 0
        now = arrivals[0].arrival_time if arrivals else 0.0
        deadline = (self.trace.duration + cfg.drain_timeout) if arrivals else 0.0
        iters = 0

        while (i_arr < n_total or self.sched.live) and now < deadline:
            iters += 1
            if iters > max_iters:
                break
            while i_arr < n_total and arrivals[i_arr].arrival_time <= now:
                req = arrivals[i_arr]
                if self.prefix_index is not None and req.prompt_tokens:
                    req.cached_prefix_hint = self.prefix_index.probe(
                        req.prompt_tokens)
                self.sched.submit(req, now)
                # prediction latency is serving-path overhead (Table 2)
                self.pred_overhead += getattr(self.predictor, "last_latency", 0.0)
                i_arr += 1

            plan = self.sched.plan(now)
            t_iter, ran_any = self.execute_plan(plan, now)

            if not ran_any:
                # idle: fast-forward to the next actionable instant
                nxt = []
                if i_arr < n_total:
                    nxt.append(arrivals[i_arr].arrival_time)
                nxt.extend(t for t in self.sched._swap_ready_at.values() if t > now)
                if not nxt:
                    break
                now = max(min(nxt), now + 1e-6)
                continue

            now += t_iter
            self.account_tokens(plan, now)
            # learning off the dispatch path, same placement as the real
            # engine: feedback queued by note_finished/overruns is applied
            # between iterations (its wall cost is tracked separately and
            # never folds into the simulated clock)
            self.predictor.drain_feedback()

        return self._result(now, n_total)

    # ------------------------------------------------------------ OOM path
    def _handle_oom(self, req: Request, now: float) -> None:
        """Growth failed: vLLM preempts the latest-arrived running job with
        recompute; ALISE offloads the highest-EWT resident."""
        live = [r for r in self.sched.live.values()
                if self.mem.resident_hbm(r) and r.req_id != req.req_id]
        if not live:
            self.mem.drop(req)
            req.state = RequestState.QUEUED
            req.preempt_count += 1
            return
        if self.sched.is_fcfs:
            victim = max(live, key=lambda r: r.arrival_time)
            self.mem.drop(victim)
            victim.state = RequestState.QUEUED
        else:
            victim = max(live, key=lambda r: self.sched.ewt(
                r, sorted(live, key=lambda x: (x.priority_level,)), now))
            self.mem.offload(victim, now)
            victim.state = RequestState.PREEMPTED
        victim.preempt_count += 1
        self.mem.grow(req)

    # -------------------------------------------------------------- result
    def _result(self, now: float, n_total: int) -> SimResult:
        done = self.sched.finished
        lat = np.array([r.e2e_latency for r in done]) if done else np.array([0.0])
        norm = np.array([r.normalized_latency for r in done
                         if r.normalized_latency is not None])
        if norm.size == 0:
            norm = np.array([0.0])
        queue_delay = np.array(
            [r.first_scheduled_time - r.arrival_time for r in done
             if r.first_scheduled_time is not None]) if done else np.array([0.0])
        toks = sum(r.generated for r in done)
        duration = max(now - (self.trace.requests[0].arrival_time
                              if self.trace.requests else 0.0), 1e-9)
        stats = dict(getattr(self.predictor, "stats", {}))
        return SimResult(
            strategy=self.cfg.strategy, model=self.cfg.model,
            rate=self.trace.cfg.rate, completed=len(done), total=n_total,
            duration=duration,
            normalized_latency=float(np.mean(norm)),
            mean_latency=float(np.mean(lat)),
            p50_latency=float(np.median(lat)),
            p99_latency=float(np.percentile(lat, 99)),
            throughput=len(done) / duration,
            token_throughput=toks / duration,
            mean_queueing_delay=float(np.mean(queue_delay)),
            preemptions=sum(r.preempt_count for r in done),
            swap_in_gb=sum(r.swap_in_bytes for r in done) / 1e9,
            swap_out_gb=sum(r.swap_out_bytes for r in done) / 1e9,
            recompute_tokens=sum(r.recompute_tokens for r in done),
            predictor_stats=stats,
            requests=done)


def run_sim(model: str = "opt-13b", strategy: str = "alise",
            dataset: str = "sharegpt", rate: float = 2.0,
            duration: float = 120.0, seed: int = 0,
            predictor: Optional[LengthPredictor] = None,
            bus=None, **overrides) -> SimResult:
    """Convenience wrapper used by benchmarks and tests.  ``bus``: an
    optional virtual-clock EventBus receiving the run's lifecycle events."""
    trace = generate_trace(TraceConfig(dataset=dataset, rate=rate,
                                       duration=duration, seed=seed))
    sim_cfg = SimConfig(model=model, strategy=strategy, seed=seed, **overrides)
    sim = ServingSimulator(sim_cfg, trace, predictor=predictor, bus=bus)
    return sim.run()
