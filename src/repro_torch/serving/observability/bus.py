"""Bounded structured event ring shared by every serving layer.

Design constraints, in priority order:

1. **Near-zero cost when disabled.**  Every emit site in the hot path is
   guarded by ``if self.bus is not None`` on an attribute that defaults to
   ``None`` — a single attribute load + branch, no allocation, no call.
2. **Bounded memory.**  Events land in a ``deque(maxlen=capacity)``; once
   full the oldest events are dropped (``n_dropped`` counts them) so a
   long-running server cannot grow without bound.
3. **Thread safe.**  In wall-clock mode the gateway's concurrent pumps
   emit from executor threads, so ``emit`` takes a lock.  The lock is
   uncontended in the common case and the critical section is one
   ``deque.append``.
4. **Two clock domains.**  A bus is either ``wall`` (timestamps are
   seconds of ``time.perf_counter`` since the bus epoch) or ``virtual``
   (timestamps are simulator/gateway virtual seconds, advanced via
   :meth:`mark`).  Callers that hold a domain-correct ``t`` pass it
   explicitly; callers with no notion of time (e.g. prefix-cache
   internals) use :meth:`now`.  Mixing domains in one bus is a bug;
   exporters treat ``t`` as opaque seconds either way.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional


@dataclass
class TraceEvent:
    """One structured lifecycle event.

    ``kind`` is a flat namespace (see KINDS below for the vocabulary);
    ``t`` is seconds in the bus's clock domain; ``dur`` > 0 marks a span
    (rendered as a Chrome "X" complete event), 0 an instant; ``req_id``
    -1 means not-request-scoped (gauges, iteration-level events);
    ``replica`` "" means gateway/global scope; ``data`` carries the
    kind-specific payload.
    """
    kind: str
    t: float
    dur: float = 0.0
    req_id: int = -1
    replica: str = ""
    data: Dict[str, object] = field(default_factory=dict)


#: Vocabulary of event kinds emitted by the stack (documentation aid and
#: exporter whitelist — unknown kinds still export as instants).
KINDS = (
    # gateway
    "arrival", "admission", "defer_release", "dispatch", "first_token",
    "shed", "timeout", "gauge",
    # scheduler (predict/repredict/skip_join come from the length-prediction
    # subsystem: arrival-time quantile estimate, mid-flight re-estimate on
    # overrun, uncertainty-driven deep-band join)
    "queue_join", "promote", "demote", "predict", "repredict", "skip_join",
    # engine / simulator execution
    "prefill_chunk", "decode_iter", "swap_out", "swap_in",
    "preempt", "drop", "hol_blocked",
    # prefix cache
    "prefix_hit", "prefix_publish", "prefix_evict", "prefix_cow",
    # cluster KV tier
    "tier_import", "tier_evict",
    # terminal
    "finish",
)


class EventBus:
    """Bounded, thread-safe, clock-domain-tagged event ring."""

    def __init__(self, capacity: int = 1 << 16, clock: str = "wall"):
        if clock not in ("wall", "virtual"):
            raise ValueError(f"clock must be 'wall' or 'virtual', got {clock!r}")
        self.capacity = capacity
        self.clock = clock
        self._ring: Deque[TraceEvent] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        self._vnow = 0.0               # last mark() in virtual mode
        self.n_emitted = 0             # total ever emitted (incl. dropped)

    # ------------------------------------------------------------- clock
    def now(self) -> float:
        """Current time in this bus's domain.  Wall: seconds since the
        bus epoch.  Virtual: the last :meth:`mark` value — emit sites
        with a better ``t`` should pass it explicitly instead."""
        if self.clock == "wall":
            return time.perf_counter() - self._epoch
        return self._vnow

    def mark(self, t: float) -> None:
        """Advance the virtual clock (no-op record in wall mode)."""
        self._vnow = t

    # -------------------------------------------------------------- emit
    def emit(self, kind: str, t: Optional[float] = None, dur: float = 0.0,
             req_id: int = -1, replica: str = "", **data: object) -> None:
        ev = TraceEvent(kind=kind, t=self.now() if t is None else t,
                        dur=dur, req_id=req_id, replica=replica, data=data)
        with self._lock:
            self._ring.append(ev)
            self.n_emitted += 1

    def gauge(self, values: Dict[str, float], replica: str = "",
              t: Optional[float] = None) -> None:
        """Record a point-in-time snapshot of numeric gauges."""
        self.emit("gauge", t=t, replica=replica, **values)

    # ------------------------------------------------------------ access
    def snapshot(self) -> List[TraceEvent]:
        """Consistent copy of the ring contents (oldest first)."""
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def n_dropped(self) -> int:
        with self._lock:
            return self.n_emitted - len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.n_emitted = 0
