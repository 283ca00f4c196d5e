"""Chrome-trace-event (Perfetto-loadable) export of an EventBus stream.

Layout: one *process* (pid) per replica lane — pid 0 is the gateway
lane, engines get pids 1..N in first-seen order — and, within an engine
lane, one *thread* (tid) per request so each request's prefill chunks,
decode iterations, and swaps stack into their own row.  Execution-level
events with no request scope (gauges, hol_blocked) sit on tid 0.  On the
gateway lane each request additionally gets a synthesized whole-lifecycle
span (arrival -> terminal event) so the overall shape of the run is
visible at a glance.

Open the output at https://ui.perfetto.dev (or chrome://tracing): the
JSON is the standard ``{"traceEvents": [...]}`` envelope with ts/dur in
microseconds.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Union

from repro_torch.serving.observability.bus import EventBus, TraceEvent

#: kinds rendered as complete spans ("X") — everything else with dur==0
#: becomes an instant ("i"); gauges become counters ("C").
SPAN_KINDS = ("prefill_chunk", "decode_iter", "swap_out", "swap_in",
              "hol_blocked")

#: terminal kinds closing a request's gateway lifecycle span.
TERMINAL_KINDS = ("finish", "shed", "timeout", "drop")

_US = 1e6   # seconds -> microseconds


def _jsonable(v: object) -> object:
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return str(v)


def to_chrome_trace(events: Union[EventBus, Iterable[TraceEvent]]) -> dict:
    """Render an event stream as a Chrome trace-event JSON object."""
    if isinstance(events, EventBus):
        events = events.snapshot()
    events = list(events)

    pids: Dict[str, int] = {"": 0}       # replica name -> pid (gateway = 0)
    out: List[dict] = []

    def pid_of(replica: str) -> int:
        if replica not in pids:
            pids[replica] = len(pids)
        return pids[replica]

    # Request lifecycle bounds on the gateway lane: first-seen t and the
    # terminal t per request, synthesized into one span at the end.
    first_seen: Dict[int, float] = {}
    last_seen: Dict[int, float] = {}
    terminal: Dict[int, str] = {}

    for ev in events:
        pid = pid_of(ev.replica)
        tid = ev.req_id if ev.req_id >= 0 else 0
        args = {k: _jsonable(v) for k, v in ev.data.items()}
        base = {"name": ev.kind, "pid": pid, "tid": tid,
                "ts": ev.t * _US, "args": args}
        if ev.kind == "gauge":
            # One counter track per metric, on the replica's lane.
            for k, v in ev.data.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    out.append({"name": k, "ph": "C", "pid": pid, "tid": 0,
                                "ts": ev.t * _US, "args": {k: float(v)}})
            continue
        if ev.kind in SPAN_KINDS or ev.dur > 0:
            out.append({**base, "ph": "X", "dur": max(ev.dur, 0.0) * _US})
        else:
            out.append({**base, "ph": "i", "s": "t"})
        if ev.req_id >= 0:
            first_seen.setdefault(ev.req_id, ev.t)
            last_seen[ev.req_id] = max(last_seen.get(ev.req_id, ev.t),
                                       ev.t + ev.dur)
            if ev.kind in TERMINAL_KINDS:
                terminal[ev.req_id] = ev.kind

    # Synthesized per-request lifecycle spans on the gateway lane.
    for rid, t0 in first_seen.items():
        t1 = last_seen[rid]
        out.append({"name": f"req {rid} [{terminal.get(rid, 'open')}]",
                    "ph": "X", "pid": 0, "tid": rid,
                    "ts": t0 * _US, "dur": max(t1 - t0, 0.0) * _US,
                    "args": {"req_id": rid,
                             "terminal": terminal.get(rid, "open")}})

    # Metadata: name the lanes so Perfetto shows replica names.
    meta: List[dict] = []
    for replica, pid in pids.items():
        label = replica if replica else "gateway"
        meta.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                     "args": {"name": label}})
    return {"traceEvents": meta + out,
            "displayTimeUnit": "ms"}


def validate_chrome_trace(obj: dict) -> List[str]:
    """Schema check; returns a list of problems (empty = valid)."""
    errs: List[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["missing traceEvents envelope"]
    evs = obj["traceEvents"]
    if not isinstance(evs, list) or not evs:
        return ["traceEvents empty or not a list"]
    for i, ev in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not an object")
            continue
        if not isinstance(ev.get("name"), str):
            errs.append(f"{where}: name missing or not a string")
        ph = ev.get("ph")
        if ph not in ("X", "i", "M", "C"):
            errs.append(f"{where}: unsupported ph {ph!r}")
            continue
        if "pid" not in ev or "tid" not in ev:
            errs.append(f"{where}: pid/tid missing")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                errs.append(f"{where}: ts missing or non-numeric")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"{where}: X event needs dur >= 0")
        if len(errs) > 20:
            errs.append("... (truncated)")
            break
    return errs


def write_chrome_trace(events: Union[EventBus, Iterable[TraceEvent]],
                       path: str, strict: bool = True) -> dict:
    """Export to ``path``; with ``strict`` raise on schema violations."""
    obj = to_chrome_trace(events)
    if strict:
        errs = validate_chrome_trace(obj)
        if errs:
            raise ValueError("invalid chrome trace: " + "; ".join(errs[:5]))
    with open(path, "w") as f:
        json.dump(obj, f)
    return obj
