"""Scheduler-quality telemetry derived from the event stream.

ALISE schedules on *speculation* — predicted output length folds into an
expected-execution-time (Eq. 6-7) that drives MLFQ placement, routing,
and admission.  This module measures how good that speculation actually
was, and what each request's time-to-first-token was actually spent on:

* **Estimate error** — signed error and absolute-percentage-error
  distributions for (a) predicted vs. actual output length, (b) the
  admission-time expected TTFT vs. the realized TTFT, (c) the
  queue-join remaining-time estimate vs. realized completion time.
* **Queueing decomposition** — per-request TTFT split into admission
  defer, scheduler wait, prefill execution, swap stalls, and residual.
* **HoL blocking** — total and per-request time a runnable
  higher-priority request sat memory-blocked while lower-priority work
  ran (the direct measurement of the failure mode ALISE exists to fix).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Union

import numpy as np

from repro_torch.serving.observability.bus import EventBus, TraceEvent


def _dist(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {"n": 0, "mean": float("nan"), "p50": float("nan"),
                "p90": float("nan"), "p99": float("nan")}
    a = np.asarray(xs, dtype=float)
    return {"n": int(a.size), "mean": float(a.mean()),
            "p50": float(np.percentile(a, 50)),
            "p90": float(np.percentile(a, 90)),
            "p99": float(np.percentile(a, 99))}


def analyze_quality(events: Union[EventBus, Iterable[TraceEvent]]) -> dict:
    """Fold an event stream into scheduler-quality metrics."""
    if isinstance(events, EventBus):
        events = events.snapshot()
    evs = sorted(events, key=lambda e: e.t)

    # Per-request accumulation.
    arrival: Dict[int, float] = {}
    dispatch_t: Dict[int, float] = {}
    join_t: Dict[int, float] = {}
    join_rem: Dict[int, float] = {}          # remaining-time estimate at join
    first_chunk_t: Dict[int, float] = {}
    first_token_t: Dict[int, float] = {}
    finish_t: Dict[int, float] = {}
    expected_ttft: Dict[int, float] = {}
    predicted_len: Dict[int, int] = {}
    predicted_p90: Dict[int, int] = {}
    cached_prefix: Dict[int, int] = {}       # hit watermark at predict time
    generated: Dict[int, int] = {}
    prefill_exec: Dict[int, float] = {}      # sum of chunk durs pre-first-token
    swap_stall: Dict[int, float] = {}
    hol_wait: Dict[int, float] = {}
    counts: Dict[str, int] = {}

    for ev in evs:
        counts[ev.kind] = counts.get(ev.kind, 0) + 1
        rid = ev.req_id
        if ev.kind == "arrival":
            arrival[rid] = ev.t
        elif ev.kind == "admission":
            e = ev.data.get("expected_ttft")
            if isinstance(e, (int, float)):
                expected_ttft.setdefault(rid, float(e))
        elif ev.kind == "dispatch":
            dispatch_t.setdefault(rid, ev.t)
        elif ev.kind == "predict":
            p90 = ev.data.get("p90")
            if isinstance(p90, (int, float)):
                predicted_p90.setdefault(rid, int(p90))
            h = ev.data.get("prefix_hint")
            if isinstance(h, (int, float)):
                cached_prefix.setdefault(rid, int(h))
        elif ev.kind == "queue_join":
            join_t.setdefault(rid, ev.t)
            r = ev.data.get("remaining_est")
            if isinstance(r, (int, float)):
                join_rem.setdefault(rid, float(r))
            p = ev.data.get("predicted_len")
            if isinstance(p, (int, float)):
                predicted_len.setdefault(rid, int(p))
        elif ev.kind == "prefill_chunk":
            first_chunk_t.setdefault(rid, ev.t)
            if rid not in first_token_t:
                prefill_exec[rid] = prefill_exec.get(rid, 0.0) + ev.dur
        elif ev.kind in ("swap_out", "swap_in"):
            if rid not in first_token_t:
                swap_stall[rid] = swap_stall.get(rid, 0.0) + ev.dur
        elif ev.kind == "hol_blocked":
            if rid >= 0 and rid not in first_token_t:
                hol_wait[rid] = hol_wait.get(rid, 0.0) + ev.dur
        elif ev.kind == "first_token":
            first_token_t.setdefault(rid, ev.t)
        elif ev.kind == "finish":
            finish_t.setdefault(rid, ev.t)
            g = ev.data.get("generated")
            if isinstance(g, (int, float)):
                generated[rid] = int(g)
            # finish events are self-contained so engine-only traces
            # (no gateway) still yield length/TTFT errors.
            for key, store in (("arrival_t", arrival),
                               ("first_token_t", first_token_t)):
                v = ev.data.get(key)
                if isinstance(v, (int, float)) and rid not in store:
                    store[rid] = float(v)
            p = ev.data.get("predicted")
            if isinstance(p, (int, float)):
                predicted_len.setdefault(rid, int(p))
            c = ev.data.get("cached_prefix")
            if isinstance(c, (int, float)):
                cached_prefix.setdefault(rid, int(c))

    # ---- queueing-delay decomposition (requests that reached 1st token)
    defer_s, sched_s, prefill_s, swap_s, hol_s, other_s, ttft_s = \
        [], [], [], [], [], [], []
    for rid, ft in first_token_t.items():
        t0 = arrival.get(rid, dispatch_t.get(rid, join_t.get(rid)))
        if t0 is None:
            continue
        ttft = ft - t0
        ttft_s.append(ttft)
        d = max(dispatch_t.get(rid, t0) - t0, 0.0)
        s = max(first_chunk_t.get(rid, ft) - join_t.get(rid, t0), 0.0)
        p = prefill_exec.get(rid, 0.0)
        w = swap_stall.get(rid, 0.0)
        h = hol_wait.get(rid, 0.0)
        defer_s.append(d)
        sched_s.append(min(s, ttft))
        prefill_s.append(min(p, ttft))
        swap_s.append(w)
        hol_s.append(h)
        other_s.append(max(ttft - d - min(s, ttft) - min(p, ttft) - w, 0.0))

    # ---- estimate-error distributions
    ewt_err, ewt_ape = [], []
    for rid, exp in expected_ttft.items():
        if rid in first_token_t:
            t0 = arrival.get(rid)
            if t0 is None:
                continue
            actual = first_token_t[rid] - t0
            ewt_err.append(actual - exp)
            if actual > 1e-9:
                ewt_ape.append(abs(actual - exp) / actual)

    exec_err, exec_ape = [], []
    for rid, rem in join_rem.items():
        if rid in finish_t and rid in join_t:
            actual = finish_t[rid] - join_t[rid]
            exec_err.append(actual - rem)
            if actual > 1e-9:
                exec_ape.append(abs(actual - rem) / actual)

    # Length error is computed against ``generated`` — the suffix the
    # request actually produced — which for a prefix-cache hit is exactly
    # the work the predictor priced (the cached prefix was never
    # generated).  The hit/cold split keeps hit-aware prediction honest:
    # a predictor that ignores the hit watermark shows its bias in the
    # ``_hit`` fold while the ``_cold`` fold stays clean.
    len_err, len_ape = [], []
    len_err_hit, len_ape_hit, len_err_cold, len_ape_cold = [], [], [], []
    p90_cover = []                     # calibrated-coverage check: g <= p90
    for rid, pred in predicted_len.items():
        if rid in generated and generated[rid] > 0:
            g = generated[rid]
            len_err.append(g - pred)
            len_ape.append(abs(g - pred) / g)
            if cached_prefix.get(rid, 0) > 0:
                len_err_hit.append(g - pred)
                len_ape_hit.append(abs(g - pred) / g)
            else:
                len_err_cold.append(g - pred)
                len_ape_cold.append(abs(g - pred) / g)
            p90 = predicted_p90.get(rid)
            if p90 is not None:
                p90_cover.append(1.0 if g <= p90 else 0.0)

    return {
        "n_requests_seen": len(set(arrival) | set(join_t) | set(finish_t)),
        "counts": counts,
        "queueing": {
            "ttft": _dist(ttft_s),
            "defer": _dist(defer_s),
            "sched_wait": _dist(sched_s),
            "prefill_exec": _dist(prefill_s),
            "swap_stall": _dist(swap_s),
            "hol_blocked": _dist(hol_s),
            "other": _dist(other_s),
        },
        "estimate_error": {
            "ewt_signed_s": _dist(ewt_err),
            "ewt_ape": _dist(ewt_ape),
            "exec_signed_s": _dist(exec_err),
            "exec_ape": _dist(exec_ape),
            "len_signed_tok": _dist([float(x) for x in len_err]),
            "len_ape": _dist(len_ape),
            "len_signed_tok_hit": _dist([float(x) for x in len_err_hit]),
            "len_ape_hit": _dist(len_ape_hit),
            "len_signed_tok_cold": _dist([float(x) for x in len_err_cold]),
            "len_ape_cold": _dist(len_ape_cold),
        },
        "p90_coverage": (float(np.mean(p90_cover)) if p90_cover
                         else float("nan")),
        "hol_blocked_total_s": float(sum(hol_wait.values())),
        "scheduler": {
            "promotions": counts.get("promote", 0),
            "demotions": counts.get("demote", 0),
            "repredictions": counts.get("repredict", 0),
            "skip_joins": counts.get("skip_join", 0),
            "preemptions": counts.get("preempt", 0),
            "sheds": counts.get("shed", 0),
            "timeouts": counts.get("timeout", 0),
            "prefix_hits": counts.get("prefix_hit", 0),
            "prefix_evictions": counts.get("prefix_evict", 0),
            "prefix_cow": counts.get("prefix_cow", 0),
        },
    }
