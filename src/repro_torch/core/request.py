"""Request lifecycle objects shared by the scheduler, simulator and engine."""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import List, Optional


class RequestState(enum.Enum):
    QUEUED = "queued"          # never run yet (no KV)
    RUNNING = "running"        # in the current decode batch
    PREEMPTED = "preempted"    # has KV somewhere, not in the batch
    SWAPPING = "swapping"      # KV transfer in flight
    FINISHED = "finished"
    FAILED = "failed"
    CANCELLED = "cancelled"    # client cancelled (gateway streaming path)


class SLOClass(enum.Enum):
    """Service class for online serving (gateway admission + MLFQ mapping).

    INTERACTIVE requests enter the scheduler's top priority band and are
    never shed by admission control; BATCH requests take the normal
    speculative band assignment and absorb backpressure (defer/shed) first.
    """
    INTERACTIVE = "interactive"
    BATCH = "batch"


class KVLocation(enum.Enum):
    NONE = "none"              # no KV materialized (queued or recomputed away)
    HBM = "hbm"
    HBM_Q8 = "hbm_q8"          # quantized cold tier in HBM (beyond-paper)
    DRAM = "dram"              # host memory (paper's CPU offload target)


_req_counter = itertools.count()


@dataclass
class Request:
    prompt_len: int
    arrival_time: float
    true_out_len: int                      # ground truth (sim / oracle / replay)
    req_id: int = field(default_factory=lambda: next(_req_counter))
    prompt_tokens: Optional[List[int]] = None   # engine mode
    features: Optional[object] = None           # predictor embedding (np array)
    slo_class: SLOClass = SLOClass.BATCH        # online-serving service class

    # --- prediction / scheduling state ---
    predicted_len: Optional[int] = None    # p50 (point prior for legacy
                                           # predictors) — SRTF prices this
    predicted_p90: Optional[int] = None    # calibrated upper quantile (None
                                           # for point predictors); admission
                                           # gates P90 TTFT on it
    pred_spread: float = 0.0               # p90/p50 - 1 uncertainty; high
                                           # spread triggers MLFQ skip-join
    repredictions: int = 0                 # mid-flight re-estimates taken
    priority_level: int = 0
    level_enter_time: float = 0.0          # for virtual aging
    demotions: int = 0

    # --- progress ---
    state: RequestState = RequestState.QUEUED
    generated: int = 0
    prefilled: int = 0                     # tokens with KV materialized by
                                           # (possibly chunked) prefill; reset
                                           # to 0 when KV is dropped
    cached_prefix_hint: int = 0            # expected shared-prefix cache hit
                                           # (speculative pricing signal: the
                                           # scheduler/gateway charge only the
                                           # uncached suffix; the engine
                                           # re-matches at prefill time, so a
                                           # stale hint costs accuracy, never
                                           # correctness)
    kv_location: KVLocation = KVLocation.NONE
    kv_quantized: bool = False
    output_tokens: List[int] = field(default_factory=list)

    # --- metrics ---
    first_scheduled_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    preempt_count: int = 0
    swap_in_bytes: float = 0.0
    swap_out_bytes: float = 0.0
    recompute_tokens: int = 0
    # --- speculative (verify-k) decode accounting ---
    spec_iters: int = 0                    # verify-k dispatches run
    spec_drafted: int = 0                  # draft tokens proposed
    spec_accepted: int = 0                 # draft tokens accepted

    # ------------------------------------------------------------------
    @property
    def context_len(self) -> int:
        return self.prompt_len + self.generated

    @property
    def prefill_target(self) -> int:
        """Tokens a (re-)prefill must materialize before decode can run:
        the prompt, plus all but the last generated token on a recompute
        (the engine's cache invariant keeps the most recent sampled token's
        KV unwritten — the next decode step feeds it)."""
        return self.prompt_len + max(self.generated - 1, 0)

    @property
    def prefill_pending(self) -> int:
        """Prefill tokens still to run before this request can decode."""
        return max(self.prefill_target - self.prefilled, 0)

    @property
    def remaining_tokens_true(self) -> int:
        return max(self.true_out_len - self.generated, 0)

    def remaining_tokens_pred(self, quantile: Optional[float] = None) -> int:
        """Predicted tokens still to generate.  Default (None) prices the
        p50 point prediction — the SRTF/EWT surface; ``quantile >= 0.9``
        reads the calibrated p90 head when the predictor exports one (the
        admission gate's conservative backlog), falling back to p50."""
        pred = self.predicted_len if self.predicted_len is not None else 128
        if quantile is not None and quantile >= 0.9 \
                and self.predicted_p90 is not None:
            pred = max(self.predicted_p90, pred)
        return max(pred - self.generated, 1)

    def spec_tokens_per_iter(self) -> float:
        """Measured decode tokens emitted per verify-k iteration (the
        guaranteed sample plus accepted drafts).  1.0 before any verify-k
        dispatch ran — the conservative non-speculative rate — so EWT
        estimates only speed up once acceptance is actually observed."""
        if self.spec_iters <= 0:
            return 1.0
        return 1.0 + self.spec_accepted / self.spec_iters

    @property
    def done(self) -> bool:
        return self.state in (RequestState.FINISHED, RequestState.FAILED,
                              RequestState.CANCELLED)

    @property
    def e2e_latency(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time

    @property
    def normalized_latency(self) -> Optional[float]:
        lat = self.e2e_latency
        if lat is None or self.generated == 0:
            return None
        return lat / self.generated


def reset_runtime_state(req: Request) -> None:
    """Clear everything a prior run mutated (traces are reusable objects)."""
    req.predicted_len = None
    req.predicted_p90 = None
    req.pred_spread = 0.0
    req.repredictions = 0
    req.features = None
    req.priority_level = 0
    req.level_enter_time = 0.0
    req.demotions = 0
    req.state = RequestState.QUEUED
    req.generated = 0
    req.prefilled = 0
    req.cached_prefix_hint = 0
    req.kv_location = KVLocation.NONE
    req.kv_quantized = False
    req.output_tokens = []
    req.first_scheduled_time = None
    req.first_token_time = None
    req.finish_time = None
    req.preempt_count = 0
    req.swap_in_bytes = 0.0
    req.swap_out_bytes = 0.0
    req.recompute_tokens = 0
    req.spec_iters = 0
    req.spec_drafted = 0
    req.spec_accepted = 0


def reset_request_counter():
    global _req_counter
    _req_counter = itertools.count()
