"""Per-SLO-class serving telemetry.

TTFT  = first_token_time - arrival_time        (queueing + prefill)
TPOT  = (finish - first_token) / (n_tokens-1)  (steady-state decode pace)
E2E   = finish - arrival

All times are in the gateway's clock domain (wall seconds in realtime mode,
virtual seconds in replay mode), so percentiles are comparable across both.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.request import Request, SLOClass


def percentile(xs: List[float], p: float) -> float:
    if not xs:
        return float("nan")
    return float(np.percentile(np.asarray(xs, dtype=float), p))


@dataclass
class ClassMetrics:
    ttft: List[float] = field(default_factory=list)
    tpot: List[float] = field(default_factory=list)
    e2e: List[float] = field(default_factory=list)
    tokens: int = 0
    completed: int = 0
    cancelled: int = 0
    shed: int = 0
    deferred: int = 0          # admission defer decisions (not unique reqs)
    timed_out: int = 0         # aborted before first token (wall budget)
    ttft_target: Optional[float] = None   # SLO target (s); None = untracked

    def record_first_token(self, req: Request, t: float) -> None:
        self.ttft.append(t - req.arrival_time)

    def record_finish(self, req: Request, t: float) -> None:
        self.completed += 1
        self.tokens += req.generated
        self.e2e.append(t - req.arrival_time)
        if req.first_token_time is not None and req.generated > 1:
            self.tpot.append((t - req.first_token_time)
                             / (req.generated - 1))

    def slo_attainment(self) -> float:
        """Fraction of *arrivals* whose TTFT met the target; sheds and
        pre-first-token aborts count as misses, so neither shedding nor
        timing out can game the SLO."""
        if self.ttft_target is None:
            return float("nan")
        n = len(self.ttft) + self.shed + self.timed_out
        if n == 0:
            return float("nan")
        met = sum(1 for t in self.ttft if t <= self.ttft_target)
        return met / n

    def summary(self) -> Dict[str, float]:
        return {
            "completed": self.completed, "shed": self.shed,
            "cancelled": self.cancelled, "deferred": self.deferred,
            "timed_out": self.timed_out, "tokens": self.tokens,
            "ttft_p50": percentile(self.ttft, 50),
            "ttft_p90": percentile(self.ttft, 90),
            "ttft_p99": percentile(self.ttft, 99),
            "tpot_p50": percentile(self.tpot, 50),
            "tpot_p99": percentile(self.tpot, 99),
            "e2e_p50": percentile(self.e2e, 50),
            "e2e_p99": percentile(self.e2e, 99),
            "ttft_target": (float("nan") if self.ttft_target is None
                            else self.ttft_target),
            "slo_attainment": self.slo_attainment(),
        }


class GatewayMetrics:
    """Aggregates per-class stats; shared by the gateway and benchmarks."""

    def __init__(self):
        self.per_class: Dict[SLOClass, ClassMetrics] = {
            c: ClassMetrics() for c in SLOClass}
        self.start_t: float = 0.0
        self.end_t: float = 0.0

    def of(self, req: Request) -> ClassMetrics:
        return self.per_class[req.slo_class]

    def set_ttft_target(self, slo_class: SLOClass,
                        target: Optional[float]) -> None:
        self.per_class[slo_class].ttft_target = target

    @property
    def duration(self) -> float:
        return max(self.end_t - self.start_t, 1e-9)

    def completed(self) -> int:
        return sum(m.completed for m in self.per_class.values())

    def goodput(self) -> float:
        """Completed requests per second of serving time."""
        return self.completed() / self.duration

    def token_throughput(self) -> float:
        return sum(m.tokens for m in self.per_class.values()) / self.duration

    def summary(self, bus=None) -> Dict[str, object]:
        """Per-class metrics; with an observability ``bus`` attached the
        summary gains ``quality`` (scheduler-quality telemetry derived
        from the event stream) and ``gauges`` (the latest occupancy
        snapshot per replica) blocks."""
        out: Dict[str, object] = {
            "duration_s": self.duration,
            "goodput_rps": self.goodput(),
            "tok_per_s": self.token_throughput(),
        }
        for c, m in self.per_class.items():
            out[c.value] = m.summary()
        if bus is not None:
            from repro_torch.serving.observability import analyze_quality
            out["quality"] = analyze_quality(bus)
            latest: Dict[str, Dict[str, float]] = {}
            for ev in bus.snapshot():
                if ev.kind == "gauge":
                    latest.setdefault(ev.replica, {}).update(
                        {k: v for k, v in ev.data.items()
                         if isinstance(v, (int, float))})
            out["gauges"] = latest
        return out

    def format_line(self, now: Optional[float] = None) -> str:
        """One-line heartbeat: aggregate progress + per-class TTFT p50
        so far (for ``--metrics-interval`` periodic printing).  ``now``
        supplies the in-flight duration (end_t is not yet set mid-serve)."""
        dur = max((self.end_t if now is None else now) - self.start_t, 1e-9)
        toks = sum(m.tokens for m in self.per_class.values())
        parts = [f"done={self.completed()}", f"{toks / dur:.1f} tok/s"]
        for c, m in self.per_class.items():
            if m.ttft:
                parts.append(f"{c.value[:5]}: n={len(m.ttft)} "
                             f"ttft_p50={percentile(m.ttft, 50):.3f}s")
            extra = m.shed + m.timed_out
            if extra:
                parts.append(f"{c.value[:5]}_lost={extra}")
        return "  ".join(parts)

    def format(self) -> str:
        lines = [f"duration {self.duration:.2f}s  "
                 f"goodput {self.goodput():.2f} req/s  "
                 f"{self.token_throughput():.1f} tok/s"]
        for c, m in self.per_class.items():
            s = m.summary()
            slo = ""
            if m.ttft_target is not None:
                slo = (f" SLO(ttft<={m.ttft_target:.2f}s)="
                       f"{s['slo_attainment']*100:.1f}%")
            lines.append(
                f"  {c.value:>11}: done={s['completed']:<4d} "
                f"shed={s['shed']:<3d} "
                f"TTFT p50/p99={s['ttft_p50']:.3f}/{s['ttft_p99']:.3f}s "
                f"TPOT p50={s['tpot_p50']*1e3:.1f}ms "
                f"E2E p50/p99={s['e2e_p50']:.3f}/{s['e2e_p99']:.3f}s"
                + slo)
        return "\n".join(lines)
