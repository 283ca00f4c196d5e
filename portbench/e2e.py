"""End-to-end metrics from the harness's own receipt stamps (host clock).

A request's times are seconds after the window opened: ``due`` from the
traffic, every other stamp ``time.perf_counter()`` at the moment the
harness received the engine's event.  The window is ``[0, seconds]``; an
event received after it closed is not in the window."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Record:
    """What the harness saw of one request."""
    due: float
    out_len: int                       # the trace's true output length
    prompt: List[int]
    submitted: Optional[float] = None  # when the harness handed it over
    token_t: List[float] = field(default_factory=list)
    tokens: List[int] = field(default_factory=list)
    index: List[int] = field(default_factory=list)
    finish_t: Optional[float] = None
    reason: str = ""


def _pct(values, q: float) -> Optional[float]:
    return float(np.percentile(values, q)) if len(values) else None


def tokens_per_s(recs: Dict[int, Record], seconds: float) -> float:
    """Output tokens received in the window, over the window."""
    n = sum(1 for r in recs.values() for t in r.token_t if t <= seconds)
    return n / seconds


def ttfts(recs: Dict[int, Record], seconds: float) -> List[float]:
    """Due -> first token of every request due in the window; one with no
    first token by the close counts its wait so far."""
    out = []
    for r in recs.values():
        if r.due >= seconds:
            continue
        first = r.token_t[0] if r.token_t else None
        out.append(first - r.due if first is not None and first <= seconds
                   else seconds - r.due)
    return out


def ttft_p90_s(recs, seconds) -> Optional[float]:
    return _pct(ttfts(recs, seconds), 90)


def itls(recs: Dict[int, Record], seconds: float) -> List[float]:
    """Every gap between consecutive tokens of a request, both received in
    the window (a swap's gap included)."""
    out = []
    for r in recs.values():
        ts = [t for t in r.token_t if t <= seconds]
        out.extend(b - a for a, b in zip(ts, ts[1:]))
    return out


def itl_p99_ms(recs, seconds) -> Optional[float]:
    v = _pct(itls(recs, seconds), 99)
    return None if v is None else v * 1e3


def norm_latency_ms_per_tok(recs: Dict[int, Record], seconds: float
                            ) -> Optional[float]:
    """Mean over requests due and finished in the window of (finish - due)
    per output token (the paper's normalized latency).  Requests still
    running at the close are not in it, so it leans to shorter ones."""
    v = [(r.finish_t - r.due) / len(r.tokens) for r in recs.values()
         if r.due < seconds and r.finish_t is not None
         and r.finish_t <= seconds and r.tokens]
    return float(np.mean(v)) * 1e3 if v else None


def lateness(recs: Dict[int, Record]) -> Dict[str, float]:
    """How late the harness handed requests over after they were due."""
    late = [r.submitted - r.due for r in recs.values()
            if r.submitted is not None]
    if not late:
        return {}
    return {"p50_ms": _pct(late, 50) * 1e3, "p99_ms": _pct(late, 99) * 1e3,
            "max_ms": max(late) * 1e3}


# name -> function of (records, seconds), for the end-to-end metrics that
# the harness takes from the host clock (setup_s is its own stamp)
HOST_CLOCK = {
    "tokens_per_s": tokens_per_s,
    "ttft_p90_s": ttft_p90_s,
    "itl_p99_ms": itl_p99_ms,
    "norm_latency_ms_per_tok": norm_latency_ms_per_tok,
}
