"""SLO-class admission control and backpressure.

Maps the two service classes onto ALISE's MLFQ bands (scheduler-side) and
onto front-door policy (gateway-side):

  * INTERACTIVE — admitted unless its TTFT target would be missed (the
    paper's latency-critical traffic; enters the scheduler's top band via
    ``SchedulerConfig.interactive_level_cap``).
  * BATCH — absorbs backpressure first.  Two watermark mechanisms:

      - *defer* (hysteresis): when total live depth crosses
        ``defer_high_watermark`` the gateway parks batch arrivals in a
        holding queue until depth falls below ``defer_low_watermark`` —
        smoothing bursts without dropping work (no HBM thrash from
        over-admission).
      - *shed* (hard): above ``max_queue_depth`` live requests or
        ``max_backlog_s`` of predicted remaining work (the same Eq. 6-7
        EWT signal the router uses), new batch work is rejected outright.

TTFT-attainment admission (proxy-predictor-style latency gating): when a
per-class ``ttft_target_*`` is set, the gateway computes the request's
*expected* TTFT — the best replica's ``predicted_backlog()`` (EWT queueing
delay) plus the latency-model prefill estimate plus the predictor's own
mean prediction latency — and gates on it.  The prefill estimate is the
engine's ``prefill_estimate``: with chunked prefill enabled it charges only
the *first chunk* (the remaining chunks interleave with resident decode
lanes instead of serializing behind the backlog), so long prompts that
chunking specifically de-head-of-line-blocks are no longer over-rejected
on a whole-prompt term; with the shared-prefix KV cache enabled it
charges only the *uncached suffix* of the prompt on the target replica,
so a cache-hit long prompt (a multi-turn resend, a shared system prompt)
is admitted like the short job it really is.  A request whose target would be
missed is shed (interactive default: fail fast so the client can retry a
healthier cell) or deferred (batch default: the target only shapes the
holding queue), per ``ttft_miss_policy``.  Admitting work that is already
doomed to miss its deadline would only steal capacity from requests that
can still make theirs.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.request import Request, SLOClass


# finite stand-in for +inf in release_slack: no-target requests sort after
# every targeted one, but the prefix-hint credit can still differentiate them
# (inf - x == inf would erase it)
_NO_TARGET_BASE = 1e12


class Verdict(enum.Enum):
    ADMIT = "admit"
    DEFER = "defer"
    SHED = "shed"


class MissPolicy(str, enum.Enum):
    SHED = "shed"
    DEFER = "defer"
    OBSERVE = "observe"       # record attainment but never gate on it


@dataclass
class AdmissionConfig:
    max_queue_depth: int = 256             # shed batch above this many live
    max_backlog_s: float = float("inf")    # shed batch above this predicted s
    defer_high_watermark: Optional[int] = None   # park batch at/above this
    defer_low_watermark: Optional[int] = None    # resume below this
    interactive_hard_cap: Optional[int] = None   # None = never shed interactive
    # --- TTFT-attainment admission (None = disabled for that class)
    ttft_target_interactive: Optional[float] = None   # seconds
    ttft_target_batch: Optional[float] = None
    ttft_miss_policy: MissPolicy = MissPolicy.SHED    # interactive misses
    ttft_slack: float = 1.0                # gate on slack * expected_ttft
    ttft_quantile: float = 0.5             # backlog quantile the TTFT gate
                                           # prices: 0.5 reads the p50/EWT
                                           # surface (routing's view); 0.9
                                           # reads the calibrated-p90
                                           # remaining-length surface, so
                                           # admission is conservative
                                           # exactly when predictions are
                                           # uncertain (no effect with a
                                           # point predictor — p90 falls
                                           # back to p50)
    release_order: str = "slack"           # deferred-queue release ordering:
                                           # "slack" dispatches the request
                                           # with the least predicted TTFT
                                           # headroom first (FIFO among
                                           # no-target requests); "fifo"
                                           # keeps strict arrival order
    prefix_hint_weight: float = 0.0        # release-priority credit per token
                                           # of a deferred request's
                                           # cached_prefix_hint: a held
                                           # request whose shared prefix got
                                           # published while it was parked
                                           # releases ahead of colder peers
                                           # (0 = cache-oblivious release)

    def __post_init__(self):
        if self.defer_high_watermark is not None \
                and self.defer_low_watermark is None:
            self.defer_low_watermark = max(self.defer_high_watermark // 2, 1)
        self.ttft_miss_policy = MissPolicy(self.ttft_miss_policy)

    def ttft_target(self, slo_class: SLOClass) -> Optional[float]:
        return (self.ttft_target_interactive
                if slo_class == SLOClass.INTERACTIVE
                else self.ttft_target_batch)


class AdmissionController:
    """Stateful watermark controller (hysteresis on the defer band)."""

    def __init__(self, cfg: Optional[AdmissionConfig] = None):
        self.cfg = cfg or AdmissionConfig()
        self._deferring = False
        self.ttft_misses_predicted = 0     # gate decisions taken on TTFT
        self.last_reason = "ok"            # why the last decide() gated:
                                           # ok | ttft_miss | depth | backlog
                                           # | defer_watermark
                                           # | interactive_cap

    # ------------------------------------------------------- TTFT gating
    def _ttft_verdict(self, req: Request,
                      expected_ttft: Optional[float]) -> Optional[Verdict]:
        target = self.cfg.ttft_target(req.slo_class)
        if target is None or expected_ttft is None:
            return None
        if self.cfg.ttft_slack * expected_ttft <= target:
            return None
        self.ttft_misses_predicted += 1
        if self.cfg.ttft_miss_policy == MissPolicy.OBSERVE:
            return None                    # record the miss, never gate
        if req.slo_class == SLOClass.BATCH:
            return Verdict.DEFER           # targets shape the holding queue
        if self.cfg.ttft_miss_policy == MissPolicy.SHED:
            return Verdict.SHED
        return Verdict.DEFER

    # ----------------------------------------------------------- verdicts
    def decide(self, req: Request, depth: int, backlog_s: float,
               expected_ttft: Optional[float] = None) -> Verdict:
        """depth/backlog_s: totals across all live engine replicas;
        expected_ttft: the gateway's per-request TTFT estimate (None when
        TTFT admission is disabled)."""
        cfg = self.cfg
        self.last_reason = "ok"
        if req.slo_class == SLOClass.INTERACTIVE:
            if (cfg.interactive_hard_cap is not None
                    and depth >= cfg.interactive_hard_cap):
                self.last_reason = "interactive_cap"
                return Verdict.SHED
            v = self._ttft_verdict(req, expected_ttft)
            if v is not None:
                self.last_reason = "ttft_miss"
                return v
            return Verdict.ADMIT
        if depth >= cfg.max_queue_depth:
            self.last_reason = "depth"
            return Verdict.SHED
        if backlog_s >= cfg.max_backlog_s:
            self.last_reason = "backlog"
            return Verdict.SHED
        v = self._ttft_verdict(req, expected_ttft)
        if v is not None:
            self.last_reason = "ttft_miss"
            return v
        if cfg.defer_high_watermark is not None:
            if self._deferring:
                if depth < cfg.defer_low_watermark:
                    self._deferring = False
                else:
                    self.last_reason = "defer_watermark"
                    return Verdict.DEFER
            elif depth >= cfg.defer_high_watermark:
                self._deferring = True
                self.last_reason = "defer_watermark"
                return Verdict.DEFER
        return Verdict.ADMIT

    def release_slack(self, req: Request,
                      expected_ttft: Optional[float]) -> float:
        """Predicted TTFT headroom for a deferred request:
        ``target - slack * expected_ttft``.  Smaller = more urgent, so the
        gateway releases ascending-slack (the request closest to missing its
        target that can still make it goes first).  Requests without a
        target sort after every targeted one; among themselves a warm
        shared-prefix hit (``cached_prefix_hint``, weighted by
        ``prefix_hint_weight``) releases first — its prefill is cheap *right
        now*, before the cached pages age out — with arrival order as the
        tie-break."""
        target = self.cfg.ttft_target(req.slo_class)
        hint = self.cfg.prefix_hint_weight * req.cached_prefix_hint
        if target is None or expected_ttft is None:
            return _NO_TARGET_BASE - hint
        return target - self.cfg.ttft_slack * expected_ttft - hint

    def may_release_ttft(self, req: Request, expected_ttft: float,
                         intrinsic_ttft: float) -> bool:
        """May a TTFT-deferred request be dispatched now?  Hold while the
        queueing term is what predicts the miss (waiting can still help);
        release once the gate clears, or once the miss is intrinsic
        (elapsed + prefill alone blow the target — nothing left to wait
        out, so FIFO proceeds and the miss is recorded in attainment)."""
        target = self.cfg.ttft_target(req.slo_class)
        if target is None \
                or self.cfg.ttft_miss_policy == MissPolicy.OBSERVE:
            return True
        if self.cfg.ttft_slack * expected_ttft <= target:
            return True
        return self.cfg.ttft_slack * intrinsic_ttft > target

    def may_release(self, depth: int) -> bool:
        """May a previously deferred batch request be admitted now?
        Releases stop at the high watermark (not max_queue_depth), so a
        parked backlog cannot flood past the band hysteresis protects."""
        cfg = self.cfg
        if cfg.defer_high_watermark is None:
            return depth < cfg.max_queue_depth
        if self._deferring and depth < cfg.defer_low_watermark:
            self._deferring = False
        return not self._deferring and depth < cfg.defer_high_watermark
