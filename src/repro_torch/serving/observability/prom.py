"""Prometheus-exposition-style text rendering of gauge snapshots.

Scrape-shaped output without requiring a client library: for every
metric in the *latest* gauge snapshot of each replica we emit one
``<prefix>_<metric>{replica="<name>"} <value>`` line, plus cumulative
event-kind counters.  The text parses under the Prometheus exposition
format, so it can be served from a debug endpoint or diffed in tests.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, Tuple, Union

from repro_torch.serving.observability.bus import EventBus, TraceEvent

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _sanitize(name: str) -> str:
    return _NAME_RE.sub("_", name)


def render_prometheus(events: Union[EventBus, Iterable[TraceEvent]],
                      prefix: str = "alise") -> str:
    if isinstance(events, EventBus):
        events = events.snapshot()
    latest: Dict[Tuple[str, str], Tuple[float, float]] = {}
    counts: Dict[Tuple[str, str], int] = {}
    for ev in events:
        key = (ev.replica, ev.kind)
        counts[key] = counts.get(key, 0) + 1
        if ev.kind != "gauge":
            continue
        for k, v in ev.data.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                latest[(ev.replica, k)] = (ev.t, float(v))

    lines = []
    seen_help = set()
    for (replica, metric), (_, value) in sorted(latest.items()):
        name = f"{prefix}_{_sanitize(metric)}"
        if name not in seen_help:
            lines.append(f"# TYPE {name} gauge")
            seen_help.add(name)
        label = f'{{replica="{replica or "gateway"}"}}'
        lines.append(f"{name}{label} {value}")
    cname = f"{prefix}_events_total"
    if counts:
        lines.append(f"# TYPE {cname} counter")
    for (replica, kind), n in sorted(counts.items()):
        label = f'{{replica="{replica or "gateway"}",kind="{kind}"}}'
        lines.append(f"{cname}{label} {n}")
    return "\n".join(lines) + ("\n" if lines else "")
