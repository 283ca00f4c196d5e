"""What a per-layer metric's reader (``metrics/<name>.py``) is given, and
the small helpers they share.  A reader is ``read(ctx) -> float | None``:
None when it finds nothing to read, and the harness then leaves the
metric out of the result line."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from portbench.arch import Arch
from portbench.e2e import Record
from portbench.profiling import DeviceTrace


@dataclass
class Ctx:
    arch: Arch
    seconds: float                     # the measured window [0, seconds]
    recs: Dict[int, Record]            # by request id
    events: list                       # the engine's bus events (window clock)
    # the engine's profiling rings, stamps moved to the window clock:
    # decode (t, ctx_tokens, lanes, dt) and prefill (t, tokens, dt, rows)
    decode: List[tuple] = field(default_factory=list)
    prefill: List[tuple] = field(default_factory=list)
    offload_ms: List[float] = field(default_factory=list)
    trace: Optional[DeviceTrace] = None
    traced: Tuple[float, float] = (0.0, 0.0)   # the profiled sub-window

    @property
    def host_end(self) -> float:
        """The end of the part of the window the profiler leaves alone:
        the profiled sub-window ends the window, and its tracer slows the
        steps it records, so the engine's and scheduler's readings stop
        where it starts."""
        return self.traced[0] if self.traced[1] > self.traced[0] \
            else self.seconds

    def due(self) -> List[int]:
        """Ids of the requests due before :attr:`host_end`."""
        return [i for i, r in self.recs.items() if r.due < self.host_end]

    def in_window(self, t: float) -> bool:
        return 0.0 <= t <= self.host_end

    def in_traced(self, t0: float, t1: float) -> bool:
        return self.traced[0] <= t0 and t1 <= self.traced[1]

    def untraced_decode(self) -> List[tuple]:
        """Decode steps that ended before :attr:`host_end`."""
        return [d for d in self.decode if self.in_window(d[0] + d[3])]

    def untraced_prefill(self) -> List[tuple]:
        return [p for p in self.prefill if self.in_window(p[0] + p[2])]

    def kind(self, kind: str) -> list:
        return [e for e in self.events if e.kind == kind]


def median(values) -> Optional[float]:
    return float(np.median(values)) if len(values) else None
