"""Schedulers: ALISE speculative MLFQ-SRTF (paper §3.1) + FCFS baselines.

ALISE mechanics implemented faithfully:
  * priority = band of estimated *remaining* execution time (Eq. 3-5 via the
    latency model + the length predictor), re-evaluated every iteration;
  * virtual aging: waiting jobs are promoted one level after ``age_threshold``
    seconds at a level (prevents starvation);
  * misprediction handling: a job that exceeds its predicted length is demoted
    one level and its predicted length is doubled;
  * memory integration (Algorithm 2): the desired run set is made HBM-resident
    by EWT-ordered offloads of lower-priority jobs (Eq. 6-7), bounded by the
    GPU job limit M; swap ops overlap with compute.

Scheduler <-> engine contract — the :class:`IterationPlan`:

One iteration's compute is a **token-budgeted list of typed work items** in
priority order — :class:`PrefillChunk` (prefill tokens ``[start, end)`` of a
request's prompt, resumable across iterations) and :class:`DecodeLane` (one
decode step for a resident request) — plus the swap/quantize memory ops.
``plan(now, budget_tokens)`` packs items up to the budget (a decode lane
costs one token, a chunk its span), splitting long prompts into
``prefill_chunk``-sized pieces so a single long prefill can no longer stall
every resident decode lane for a whole-prompt dispatch (the long-prefill
head-of-line pathology FastServe's skip-join MLFQ targets).  Chunks are
ordered by the same speculative priorities as everything else, so an
INTERACTIVE arrival's first chunk preempts a BATCH job's remaining chunks
between iterations; a partially-prefilled job resumes from
``Request.prefilled``.

Baselines:
  * ``orca``  — iteration-level FCFS, run-to-completion, reserve-max KV;
  * ``vllm``  — iteration-level FCFS, on-demand paged KV, preempt-latest with
                recompute on OOM (PagedAttention-style memory, FCFS order);
  * ``oracle``— ALISE with a perfect predictor;
  * ablations ``alise-defer`` / ``alise-recompute`` (paper Fig. 8).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.memory_manager import TieredKVManager
from repro_torch.core.predictor import LengthPredictor
from repro_torch.core.request import KVLocation, Request, RequestState, SLOClass


@dataclass
class SchedulerConfig:
    max_batch: int = 32              # decode batch width
    max_resident: Optional[int] = None   # GPU job limit M (paper Alg. 2);
                                         # default: max_batch
    n_queues: int = 4
    base_quantum: float = 1.0        # seconds of remaining time covered by Q0
    quantum_growth: float = 4.0      # Q_i covers base * growth^i
    age_threshold: float = 15.0      # seconds before virtual-aging promotion (K)
    strategy: str = "alise"          # alise | orca | vllm | oracle |
                                     # alise-defer | alise-recompute
    max_new_tokens: int = 2048       # hard generation cap
    interactive_level_cap: int = 1   # deepest band an INTERACTIVE job may
                                     # occupy (SLO mapping onto MLFQ bands)
    prefill_chunk: Optional[int] = None  # max prompt tokens per PrefillChunk
                                         # (None = monolithic prefill)
    iter_token_budget: Optional[int] = None  # default token budget per
                                             # iteration (None = unbounded)
    prefill_buckets: Optional[Tuple[int, ...]] = None
    # sorted menu of chunk-shape buckets: every PrefillChunk span is
    # rounded up to the nearest entry (padding masked out) and charged to
    # the budget at the bucket size, so serve time only ever dispatches
    # shapes the engine warmup pass has already compiled.  None = legacy
    # pow2 bucketing inside the KV backend (shapes discovered lazily).
    prefill_pack: bool = False       # pack equal-bucket chunks from distinct
                                     # short requests into one PrefillPack
                                     # dispatch (segment rows, masked)
    prefill_pack_width: int = 4      # fixed segment count per pack dispatch
    decode_width: int = 1            # tokens a decode lane may emit per
                                     # iteration (spec_k + 1 with verify-k
                                     # speculative decoding on); each lane
                                     # charges this against the token budget
    skip_join_spread: Optional[float] = 1.5
    # FastServe-style mispredict robustness: an arrival whose predictor
    # uncertainty (p90/p50 - 1) exceeds this skips joining the band its
    # optimistic p50 earned and enters the deeper band its p90 prices —
    # a wildly-underestimated long job can't squat in Q0 starving real
    # short work.  None disables; point predictors (spread 0) never trigger.
    pricing_quantile: Optional[float] = 0.9
    # Mispredict-robust pricing: when a quantile predictor supplies a
    # calibrated p90, band joins, SRTF ordering, and the overrun-demotion
    # trigger all price at this quantile instead of the optimistic p50.
    # The cost asymmetry motivates it — over-pricing a short job delays
    # only that job one band, under-pricing a long one lets it squat in a
    # top band blocking everything until demotion churns it out (and a p50
    # price *by construction* under-prices half of all jobs).  Point
    # predictors (p90 None) are unaffected; None reverts to p50 pricing
    # with the spread-gated skip-join above as the only robustness.


@dataclass
class PrefillChunk:
    """Prefill tokens ``[start, end)`` of ``req``'s prefill target (the
    prompt, plus regenerated tokens on a recompute).  ``last`` marks the
    chunk that completes the target: executing it yields the prompt's final
    logits, and — for a fresh prefill — the request's first token."""
    req: Request
    start: int
    end: int
    last: bool
    bucket: int = 0     # dispatch-shape bucket the span rounds up to
                        # (0 = no fixed menu; backend pow2-buckets lazily)

    @property
    def size(self) -> int:
        return self.end - self.start

    @property
    def cost(self) -> int:
        """Budget tokens the chunk consumes: the dispatch shape (bucket)
        when a fixed menu is active — padded rows still burn compute —
        else the raw span."""
        return self.bucket or self.size

    @property
    def fresh(self) -> bool:
        """First-ever prefill (a completed one emits the first token);
        False = recompute of dropped KV (no token is re-emitted)."""
        return self.req.generated == 0


@dataclass
class PrefillPack:
    """Several distinct requests' prefill chunks fused into one dispatch.

    All members share the same shape ``bucket``; each occupies one segment
    row of the packed batch, so a burst of short interactive prompts costs
    one dispatch instead of ``len(chunks)``.  The engine executes the pack
    atomically; per-chunk bookkeeping (admission, events, first tokens)
    stays per-member."""
    chunks: List[PrefillChunk]
    bucket: int

    @property
    def size(self) -> int:
        return sum(c.size for c in self.chunks)

    @property
    def cost(self) -> int:
        return sum(c.cost for c in self.chunks)


@dataclass
class DecodeLane:
    """One decode step for a fully-prefilled, HBM-resident request.

    ``width`` is the lane's speculative token width (1 + draft tokens the
    verify-k dispatch scores): the budget charge, since the dispatch burns
    compute for every scored position whether or not drafts accept."""
    req: Request
    width: int = 1


WorkItem = Union[PrefillChunk, PrefillPack, DecodeLane]


@dataclass
class IterationPlan:
    """One iteration's decisions (executed by the simulator or engine).

    ``items`` holds the compute work in priority order; the remaining
    fields are memory-plane ops (executed before the compute items).
    ``used_tokens`` is the budget the packed items consume: 1 per decode
    lane, ``size`` per prefill chunk.
    """
    items: List[WorkItem] = field(default_factory=list)
    swap_in: List[Request] = field(default_factory=list)
    swap_out: List[Request] = field(default_factory=list)
    drop: List[Request] = field(default_factory=list)         # recompute-strategy evictions
    quantize_cold: List[Request] = field(default_factory=list)
    dequantize_cold: List[Request] = field(default_factory=list)
    budget_tokens: Optional[int] = None
    used_tokens: int = 0
    hol_blocked: List[Request] = field(default_factory=list)  # runnable
    # higher-priority requests left memory-blocked behind dispatched
    # lower-priority work this iteration (direct HoL-blocking signal)

    # ---------------------------------------------------- convenience views
    @property
    def chunks(self) -> List[PrefillChunk]:
        """Every prefill chunk in item order, pack members included —
        consumers that only need per-request bookkeeping (simulator
        admission, tests) see packs transparently."""
        out: List[PrefillChunk] = []
        for it in self.items:
            if isinstance(it, PrefillChunk):
                out.append(it)
            elif isinstance(it, PrefillPack):
                out.extend(it.chunks)
        return out

    @property
    def packs(self) -> List[PrefillPack]:
        return [it for it in self.items if isinstance(it, PrefillPack)]

    @property
    def decodes(self) -> List[Request]:
        return [it.req for it in self.items if isinstance(it, DecodeLane)]


class Scheduler:
    def __init__(self, cfg: SchedulerConfig, predictor: LengthPredictor,
                 latency: LatencyModel, mem: TieredKVManager):
        self.cfg = cfg
        self.predictor = predictor
        self.latency = latency
        self.mem = mem
        self.live: Dict[int, Request] = {}
        self.finished: List[Request] = []
        self._swap_ready_at: Dict[int, float] = {}   # req_id -> upload done time
        self.is_fcfs = cfg.strategy in ("orca", "vllm")
        self.bus = None                # observability EventBus (None = off)
        self.replica = ""              # lane name for emitted events

    # ------------------------------------------------------------- intake
    def submit(self, req: Request, now: float) -> None:
        pred = self.predictor.predict_for(req)
        req.predicted_len = min(pred.length, self.cfg.max_new_tokens)
        req.predicted_p90 = (min(pred.p90, self.cfg.max_new_tokens)
                             if pred.p90 is not None else None)
        req.pred_spread = pred.spread
        req.state = RequestState.QUEUED
        skip_join = False
        if self.is_fcfs:
            req.priority_level = 0
        else:
            pq = self._price_q(req)
            lvl50 = self._level_of(req, now)
            lvl = lvl50 if pq is None else self._level_of(req, now,
                                                          quantile=pq)
            spread_cap = self.cfg.skip_join_spread
            if (spread_cap is not None and req.pred_spread > spread_cap
                    and req.predicted_p90 is not None):
                if pq is None:
                    # p50 pricing: the spread-gated skip-join is the only
                    # robustness against an optimistic join
                    lvl90 = self._level_of(req, now, quantile=0.9)
                    if lvl90 > lvl:
                        skip_join, lvl = True, lvl90
                elif lvl > lvl50:
                    # robust pricing already joined the deeper band; still
                    # surface that this high-spread arrival skipped the
                    # band its optimistic p50 would have earned
                    skip_join = True
            req.priority_level = lvl
        req.level_enter_time = now
        self.live[req.req_id] = req
        if self.bus is not None:
            self.bus.emit("predict", t=now, req_id=req.req_id,
                          replica=self.replica, p50=req.predicted_len,
                          p90=req.predicted_p90, spread=req.pred_spread,
                          source=pred.source, latency_s=pred.latency_s,
                          prefix_hint=req.cached_prefix_hint,
                          slo_class=req.slo_class.value)
            if skip_join:
                self.bus.emit("skip_join", t=now, req_id=req.req_id,
                              replica=self.replica,
                              level=req.priority_level,
                              spread=req.pred_spread)
            self.bus.emit("queue_join", t=now, req_id=req.req_id,
                          replica=self.replica, level=req.priority_level,
                          predicted_len=req.predicted_len,
                          remaining_est=self._remaining(req),
                          prefix_hint=req.cached_prefix_hint)

    # ------------------------------------------------------------ priority
    def _remaining(self, req: Request,
                   quantile: Optional[float] = None) -> float:
        """Eq. 3-5 remaining time, counting partially-prefilled jobs as
        owing only their unfinished chunks (not the whole prompt).  A job
        with no KV yet is still priced from its shared-prefix cache hint:
        a cache-hit long prompt owes only its uncached suffix, so the
        speculative SRTF order ranks it like the short job it really is
        (the engine re-matches at prefill time — a stale hint skews the
        estimate, never correctness)."""
        if self.mem.location_of(req) != KVLocation.NONE:
            prefilled = req.prefilled
        else:
            prefilled = min(req.cached_prefix_hint,
                            max(req.prefill_target - 1, 0))
        # verify-k: a request's measured accept rate turns into fewer
        # remaining iterations (1 + accepted drafts per dispatch), so the
        # speculative SRTF/EWT order sees acceptance-friendly requests as
        # the shorter jobs they really are
        tpi = (req.spec_tokens_per_iter()
               if self.cfg.decode_width > 1 else 1.0)
        return self.latency.remaining_time(
            req.prompt_len, req.generated,
            req.remaining_tokens_pred(quantile),
            prefilled=prefilled, chunk=self.cfg.prefill_chunk,
            tokens_per_iter=tpi)

    def _price_q(self, req: Request) -> Optional[float]:
        """The quantile this request is *priced* at: the configured robust
        quantile when the predictor exported a calibrated p90 for it, else
        None (p50 point pricing)."""
        pq = self.cfg.pricing_quantile
        return pq if (pq is not None
                      and req.predicted_p90 is not None) else None

    def _clamp_level(self, req: Request, lvl: int) -> int:
        """SLO mapping: interactive jobs live in the top bands (§gateway)."""
        if req.slo_class == SLOClass.INTERACTIVE:
            return min(lvl, min(self.cfg.interactive_level_cap,
                                self.cfg.n_queues - 1))
        return lvl

    def _level_of(self, req: Request, now: float,
                  quantile: Optional[float] = None) -> int:
        rem = self._remaining(req, quantile)
        lvl = 0
        bound = self.cfg.base_quantum
        while rem > bound and lvl < self.cfg.n_queues - 1:
            lvl += 1
            bound *= self.cfg.quantum_growth
        return self._clamp_level(req, lvl)

    def _apply_aging(self, req: Request, now: float) -> None:
        """Virtual aging: promote one level per age_threshold spent waiting."""
        old = req.priority_level
        while (req.priority_level > 0
               and now - req.level_enter_time >= self.cfg.age_threshold):
            req.priority_level -= 1
            req.level_enter_time += self.cfg.age_threshold
        if self.bus is not None and req.priority_level != old:
            self.bus.emit("promote", t=now, req_id=req.req_id,
                          replica=self.replica, old_level=old,
                          new_level=req.priority_level)

    def note_generated(self, req: Request, now: float) -> None:
        """Called after each decoded token: misprediction demotion, fed by
        a live mid-flight re-prediction when the predictor offers one."""
        if self.is_fcfs:
            return
        # overrun fires at the *priced* estimate: under p50 pricing half of
        # all jobs overrun by construction and churn through demotion —
        # robust pricing only demotes the true ~10% tail past p90
        bound = (req.predicted_p90 if self._price_q(req) is not None
                 else req.predicted_len)
        if req.generated >= (bound or 1):
            old = req.priority_level
            # survival past the prediction is censored feedback ("true
            # length exceeds generated") — queued, drained off hot path
            self.predictor.observe(req, done=False)
            new_pred = self.predictor.repredict(req)
            source = "residual_quantile"
            if new_pred is None:
                # legacy mispredict handling: double and demote
                new_pred = (req.predicted_len or 1) * 2
                source = "double"
            req.repredictions += 1
            req.predicted_len = min(max(new_pred, req.generated + 1),
                                    self.cfg.max_new_tokens)
            if req.predicted_p90 is not None:
                req.predicted_p90 = min(
                    max(req.predicted_p90, req.predicted_len),
                    self.cfg.max_new_tokens)
            req.priority_level = self._clamp_level(
                req, min(req.priority_level + 1, self.cfg.n_queues - 1))
            req.level_enter_time = now
            req.demotions += 1
            if self.bus is not None:
                self.bus.emit("repredict", t=now, req_id=req.req_id,
                              replica=self.replica, source=source,
                              generated=req.generated,
                              p50=req.predicted_len, p90=req.predicted_p90,
                              repredictions=req.repredictions)
                self.bus.emit("demote", t=now, req_id=req.req_id,
                              replica=self.replica, old_level=old,
                              new_level=req.priority_level,
                              new_predicted_len=req.predicted_len)

    def predicted_backlog(self, quantile: Optional[float] = None) -> float:
        """Sum of predicted remaining execution time over live jobs (the
        cluster/gateway EWT routing + admission watermark signal).
        ``quantile`` selects the prediction surface: None/0.5 prices p50
        (routing), >= 0.9 the calibrated p90 heads (conservative admission)."""
        return sum(self._remaining(r, quantile) for r in self.live.values())

    def backlog_quantiles(self) -> Tuple[float, float]:
        """(p50, p90) backlog in one pass over live requests — the engine
        refreshes both cached surfaces per state change.  A request with
        no p90 head contributes its p50 remaining to both."""
        b50 = b90 = 0.0
        for r in self.live.values():
            rem = self._remaining(r)
            b50 += rem
            b90 += self._remaining(r, 0.9) if r.predicted_p90 is not None \
                else rem
        return b50, b90

    def release(self, req: Request) -> None:
        """Remove a live job without finishing it (cancel / replica drain);
        the caller owns any engine-side KV cleanup."""
        self.mem.free(req)
        self.live.pop(req.req_id, None)
        self._swap_ready_at.pop(req.req_id, None)

    def note_finished(self, req: Request, now: float) -> None:
        req.state = RequestState.FINISHED
        req.finish_time = now
        self.mem.free(req)
        self.live.pop(req.req_id, None)
        self.finished.append(req)
        # learning is off the dispatch path: enqueue bounded feedback here,
        # applied by predictor.drain_feedback() between iterations — a slow
        # (or throwing) update can no longer stall the finishing iteration
        self.predictor.observe(req, done=True)

    # ------------------------------------------------------------------ EWT
    def _ewt_table(self, ordered: List[Request], rem: Dict[int, float],
                   now: float) -> Dict[int, float]:
        """Eq. 6-7 for every job: EWT(J) = min(sum of remaining times of jobs
        ahead of J in priority order, time for aging to promote J to Q0)."""
        table: Dict[int, float] = {}
        ahead = 0.0
        for r in ordered:
            ewt = ahead
            if r.priority_level > 0:
                t_promote = (r.priority_level * self.cfg.age_threshold
                             - (now - r.level_enter_time))
                ewt = min(ahead, max(t_promote, 0.0))
            table[r.req_id] = ewt
            ahead += rem[r.req_id]
        return table

    def ewt(self, req: Request, ordered: List[Request], now: float = 0.0) -> float:
        rem = {r.req_id: self._remaining(r, self._price_q(r))
               for r in ordered}
        return self._ewt_table(ordered, rem, now).get(req.req_id, 0.0)

    # --------------------------------------------------------- item packing
    def _bucket_of(self, size: int) -> int:
        """Smallest menu bucket covering ``size`` (0 with no menu)."""
        menu = self.cfg.prefill_buckets
        if not menu:
            return 0
        for b in menu:
            if b >= size:
                return b
        raise ValueError(f"chunk span {size} exceeds the largest prefill "
                         f"bucket {menu[-1]} — spans must be clamped")

    def _chunk_span(self, req: Request, budget_left: float) -> PrefillChunk:
        """Next prefill chunk for ``req``: resumes at ``req.prefilled``,
        capped by the chunk size and the remaining token budget (always at
        least one token so a tiny budget cannot livelock a prefill).  With
        chunking disabled (``prefill_chunk=None``) the span always covers
        the whole remaining target — the engine's monolithic prefill cannot
        resume mid-prompt, so the budget may overshoot instead of splitting.

        With a ``prefill_buckets`` menu the span is additionally clamped to
        the largest bucket and stamped with the smallest bucket covering
        it: the dispatch runs at the bucket shape (padding masked), the
        budget is charged at :attr:`PrefillChunk.cost`, and the round-up
        may overshoot ``budget_left`` by at most one bucket granularity
        (same precedent as the monolithic overshoot)."""
        start = req.prefilled
        target = req.prefill_target
        size = target - start
        menu = self.cfg.prefill_buckets
        if self.cfg.prefill_chunk or menu:
            cap = self.cfg.prefill_chunk or menu[-1]
            if menu:
                cap = min(cap, menu[-1])
            size = min(size, cap)
            if budget_left != float("inf"):
                size = min(size, int(max(budget_left, 1)))
        size = max(size, 1)
        return PrefillChunk(req, start, start + size,
                            last=(start + size >= target),
                            bucket=self._bucket_of(size))

    def _pack_prefills(self, plan: IterationPlan) -> IterationPlan:
        """Post-pass: fuse equal-bucket prefill chunks from distinct
        requests into :class:`PrefillPack` items of at most
        ``prefill_pack_width`` segments.  Runs after packing/backfill/HoL
        detection so budget accounting and priority inversions are judged
        on the per-chunk plan; each pack replaces its first member's slot
        in item order, so relative priority of surviving items is kept."""
        width = self.cfg.prefill_pack_width
        if not self.cfg.prefill_pack or width < 2:
            return plan
        by_bucket: Dict[int, List[int]] = {}
        for i, it in enumerate(plan.items):
            if isinstance(it, PrefillChunk) and it.bucket:
                by_bucket.setdefault(it.bucket, []).append(i)
        replace: Dict[int, PrefillPack] = {}
        drop: set = set()
        for bucket, idxs in sorted(by_bucket.items()):
            for g in range(0, len(idxs), width):
                grp = idxs[g:g + width]
                if len(grp) < 2:
                    continue        # singleton: plain chunk dispatch
                replace[grp[0]] = PrefillPack(
                    [plan.items[i] for i in grp], bucket)   # type: ignore
                drop.update(grp[1:])
        if replace:
            plan.items = [replace.get(i, it)
                          for i, it in enumerate(plan.items)
                          if i not in drop]
        return plan

    # ----------------------------------------------------------------- plan
    def plan(self, now: float,
             budget_tokens: Optional[int] = None) -> IterationPlan:
        """Pack one iteration's work items up to ``budget_tokens`` (default
        ``cfg.iter_token_budget``; None = unbounded)."""
        if budget_tokens is None:
            budget_tokens = self.cfg.iter_token_budget
        if self.cfg.strategy == "orca":
            return self._plan_fcfs(now, budget_tokens)
        if self.cfg.strategy == "vllm":
            return self._plan_fcfs(now, budget_tokens)
        return self._plan_alise(now, budget_tokens)

    # ------------------------------------------------------ FCFS baselines
    def _plan_fcfs(self, now: float,
                   budget_tokens: Optional[int]) -> IterationPlan:
        plan = IterationPlan(budget_tokens=budget_tokens)
        left = float("inf") if budget_tokens is None else float(budget_tokens)
        running = [r for r in self.live.values()
                   if r.state == RequestState.RUNNING]
        running.sort(key=lambda r: r.arrival_time)
        queued = sorted((r for r in self.live.values()
                         if r.state == RequestState.QUEUED),
                        key=lambda r: r.arrival_time)
        # vLLM OOM handling: if a running job can't grow, preempt the latest
        # arrival (recompute).  ORCA reserves up front so growth never fails.
        for r in running:
            if left < 1:
                break
            if r.prefill_pending > 0:       # mid-chunked-prefill: continue it
                chunk = self._chunk_span(r, left)
                plan.items.append(chunk)
                left -= chunk.cost
                plan.used_tokens += chunk.cost
            else:
                lane = DecodeLane(r, width=self.cfg.decode_width)
                plan.items.append(lane)
                left -= lane.width
                plan.used_tokens += lane.width
        # admit new arrivals into free slots, FCFS order, memory permitting
        n_active = len(running)
        for r in queued:
            if n_active >= self.cfg.max_batch or left < 1:
                break
            if self.mem.can_admit(r):
                chunk = self._chunk_span(r, left)
                plan.items.append(chunk)
                left -= chunk.cost
                plan.used_tokens += chunk.cost
                n_active += 1
            else:
                break   # strict FCFS: no lookahead past a blocked head
        return self._pack_prefills(plan)

    # --------------------------------------------------------------- ALISE
    def _plan_alise(self, now: float,
                    budget_tokens: Optional[int]) -> IterationPlan:
        plan = IterationPlan(budget_tokens=budget_tokens)
        left = float("inf") if budget_tokens is None else float(budget_tokens)
        strategy = self.cfg.strategy
        live = list(self.live.values())

        for r in live:
            if r.state != RequestState.RUNNING:
                self._apply_aging(r, now)

        # remaining time at each job's *priced* quantile — robust pricing
        # orders by p90 so a 50%-probable underestimate can't jump the line
        rem = {r.req_id: self._remaining(r, self._price_q(r)) for r in live}
        # SRTF candidate order: (level, remaining, arrival)
        candidates = sorted(
            live, key=lambda r: (r.priority_level, rem[r.req_id],
                                 r.arrival_time))
        ewt_table = self._ewt_table(candidates, rem, now)

        desired: List[Request] = []
        for r in candidates:
            if len(desired) >= self.cfg.max_batch:
                break
            if r.state == RequestState.SWAPPING:
                if now >= self._swap_ready_at.get(r.req_id, 0.0):
                    r.state = RequestState.PREEMPTED
                else:
                    continue    # transfer still in flight
            desired.append(r)

        # ---- Algorithm 2: make `desired` HBM-resident via EWT-ordered swaps.
        # Two resources bound residency: the GPU job limit M (paper's
        # ``M = M - len(q)`` bookkeeping) and HBM bytes.
        desired_ids = {r.req_id for r in desired}
        residents = [r for r in live if self.mem.resident_hbm(r)
                     and r.req_id not in desired_ids]
        # offload candidates ordered by *descending* EWT (longest wait first)
        residents.sort(key=lambda r: -ewt_table.get(r.req_id, 0.0))

        def hbm_need(r: Request) -> float:
            loc = self.mem.location_of(r)
            if loc == KVLocation.HBM:
                return 0.0
            if loc == KVLocation.HBM_Q8:
                return self.mem._bytes(r.context_len + 1, False) \
                    - self.mem._bytes(r.context_len, True)
            return self.mem._bytes(r.context_len + 1, False)

        def emit(r: Request) -> None:
            """Append r's work item (chunk continuation or decode lane)."""
            nonlocal left
            if r.prefill_pending > 0 or self.mem.location_of(r) == \
                    KVLocation.NONE:
                chunk = self._chunk_span(r, left)
                plan.items.append(chunk)
                left -= chunk.cost
                plan.used_tokens += chunk.cost
            else:
                lane = DecodeLane(r, width=self.cfg.decode_width)
                plan.items.append(lane)
                left -= lane.width
                plan.used_tokens += lane.width

        max_resident = self.cfg.max_resident or self.cfg.max_batch
        n_resident = sum(1 for r in live if self.mem.resident_hbm(r))
        free = self.mem.hbm_free()
        evict_iter = iter(residents)
        mem_blocked: List[Request] = []
        for r in desired:
            if left < 1:
                break           # budget spent: the rest waits an iteration
            need = hbm_need(r)
            if need == 0.0:
                emit(r)
                continue
            # free memory/slots by offloading high-EWT residents
            while free < need or n_resident >= max_resident:
                victim = next(evict_iter, None)
                if victim is None:
                    break
                if strategy == "alise-defer":
                    break               # never evict: defer the newcomer
                freed = self.mem.hbm_bytes_of(victim)
                if strategy == "alise-recompute":
                    plan.drop.append(victim)       # delete KV, recompute later
                else:
                    plan.swap_out.append(victim)
                free += freed
                n_resident -= 1
            if free < need or n_resident >= max_resident:
                mem_blocked.append(r)
                continue                 # cannot fit this iteration
            free -= need
            n_resident += 1
            loc = self.mem.location_of(r)
            if loc == KVLocation.NONE:
                emit(r)                  # fresh prefill / recompute chunk
            elif loc == KVLocation.DRAM:
                plan.swap_in.append(r)
            elif loc == KVLocation.HBM_Q8:
                plan.dequantize_cold.append(r)

        # work-conserving backfill: idle batch width goes to resident jobs
        # that lost the SRTF race but can still make progress this iteration
        planned = ({it.req.req_id for it in plan.items}
                   | {r.req_id for r in plan.swap_out}
                   | {r.req_id for r in plan.drop})
        n_lanes = len(plan.decodes)
        if n_lanes < self.cfg.max_batch:
            for r in candidates:
                if n_lanes >= self.cfg.max_batch or left < 1:
                    break
                if (r.req_id not in planned
                        and self.mem.location_of(r) == KVLocation.HBM
                        and r.prefill_pending == 0):
                    lane = DecodeLane(r, width=self.cfg.decode_width)
                    plan.items.append(lane)
                    plan.used_tokens += lane.width
                    left -= lane.width
                    n_lanes += 1

        # HoL-blocking detection: a memory-blocked candidate whose SRTF
        # rank is *better* than some request that did get dispatched this
        # iteration is, by definition, head-of-line blocked — the exact
        # inversion speculative scheduling exists to minimize.
        if mem_blocked:
            rank = {r.req_id: i for i, r in enumerate(candidates)}
            scheduled = ({it.req.req_id for it in plan.items}
                         | {r.req_id for r in plan.swap_in}
                         | {r.req_id for r in plan.dequantize_cold})
            worst = max((rank[i] for i in scheduled if i in rank),
                        default=-1)
            plan.hol_blocked = [r for r in mem_blocked
                                if rank.get(r.req_id, worst + 1) < worst]
        return self._pack_prefills(plan)

    # ------------------------------------------------------------- summary
    def queue_depths(self) -> List[int]:
        depths = [0] * self.cfg.n_queues
        for r in self.live.values():
            depths[min(r.priority_level, self.cfg.n_queues - 1)] += 1
        return depths
