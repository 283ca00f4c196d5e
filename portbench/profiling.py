"""The traced run's device trace: ``torch.profiler`` (device activity
only, as ``chip_smoke.py`` profiles) over a fixed sub-window of the
measured window, kept in memory (nothing exported), and its reduction to
device busy time, kernel time by name and the idle gaps.

The profiler records no host activity: recording every host operator
slowed the engine's steps enough to change the run (queues and swaps
that the untraced run does not have).  Host spans are the harness's own
(:class:`Spans`, ``time.time_ns()`` around its calls into the program's
layers).  Two marker kernels (``torch.cuda._sleep``) launched on an idle
device at the sub-window's ends put the window, and the offset from the
host's clock to the trace's, into the trace.  The raw events are read
from the profiler's result list, not ``prof.events()``, whose tree costs
seconds more."""
from __future__ import annotations

import re
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

MARKER = "spin_kernel"          # the kernel of torch.cuda._sleep
MARKER_CYCLES = 1000


class Spans:
    """The harness's host spans: ``(what, start, end)`` in ns of
    ``time.time_ns()``, recorded only while ``on``."""

    def __init__(self):
        self.on = False
        self.items: List[Tuple[str, int, int]] = []

    @contextmanager
    def __call__(self, what: str):
        if not self.on:
            yield
            return
        t = time.time_ns()
        try:
            yield
        finally:
            self.items.append((what, t, time.time_ns()))


def mark(cuda: bool) -> int:
    """On an idle device: the host's ``time_ns()``, then a marker
    kernel's launch."""
    import torch
    if cuda:
        torch.cuda.synchronize()
    t = time.time_ns()
    if cuda:
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
    return t


@dataclass
class DeviceTrace:
    """Device activities and host spans of the traced sub-window, in ns
    of the profiler's clock."""
    t0: int
    t1: int
    ops: List[Tuple[str, int, int]] = field(default_factory=list)
    spans: List[Tuple[str, int, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def _intervals(self) -> List[Tuple[int, int]]:
        """The union of the device activities' intervals, clipped to the
        window, sorted and merged."""
        iv = sorted((max(s, self.t0), min(s + d, self.t1))
                    for _, s, d in self.ops)
        merged: List[List[int]] = []
        for s, e in iv:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(e - s for s, e in self._intervals()) / 1e9

    def kernel_s(self, names) -> Optional[float]:
        """Seconds of the activities whose name holds one of ``names``;
        None when none ran."""
        got = [d for n, _, d in self.ops if any(k in n for k in names)]
        return sum(got) / 1e9 if got else None

    def summary(self, n: int = 25) -> List[tuple]:
        """(short name, seconds, launches) of the ``n`` largest."""
        by: Dict[str, list] = {}
        for name, _, d in self.ops:
            v = by.setdefault(short_name(name), [0.0, 0])
            v[0] += d / 1e9
            v[1] += 1
        return [(k, v[0], v[1]) for k, v in
                sorted(by.items(), key=lambda kv: -kv[1][0])[:n]]

    def top_ops(self, n: int = 10) -> List[list]:
        """``[name, seconds]`` of the ``n`` largest (the breakdown's)."""
        return [[k, sec] for k, sec, _ in self.summary(n)]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The device's idle time in the window, by the innermost host
        span open at each gap's middle (``outside spans`` where none is):
        the ``n`` largest totals."""
        gaps, at = [], self.t0
        for s, e in self._intervals() + [(self.t1, self.t1)]:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        # one sweep over the spans' bounds (closes before opens at equal
        # times); the innermost open span is the last one opened
        bounds = sorted(b for i, (name, s, f) in enumerate(self.spans)
                        for b in ((s, 1, i), (f, 0, i)))
        by: Dict[str, float] = {}
        opened: List[int] = []
        j = 0
        for s, e in gaps:
            mid = (s + e) // 2
            while j < len(bounds) and bounds[j][0] <= mid:
                _, is_open, i = bounds[j]
                if is_open:
                    opened.append(i)
                elif i in opened:
                    opened.remove(i)
                j += 1
            name = self.spans[opened[-1]][0] if opened else "outside spans"
            by[name] = by.get(name, 0.0) + (e - s) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    name = re.sub(r"\(.*$", "", name.replace("(anonymous namespace)::", ""))
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).replace("void ", "").strip()[:120]


def reduce(prof, spans: List[Tuple[str, int, int]], host0: int,
           host1: int) -> DeviceTrace:
    """The trace of the sub-window between the host stamps ``host0`` and
    ``host1`` (:func:`mark`): its window and the host's spans in the
    trace's clock from the two marker kernels where they ran, else from
    the stamps themselves (no device)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    ops = []
    if prof is not None:
        for e in prof.profiler.kineto_results.events():
            if (e.device_type() == cuda and not e.is_user_annotation()
                    and not getattr(e, "is_hidden_event", lambda: False)()):
                ops.append((e.name(), e.start_ns(), e.duration_ns()))
    marks = sorted(o[1] for o in ops if MARKER in o[0])
    t0, t1, shift = host0, host1, 0
    if len(marks) >= 2:
        t0, t1 = marks[0], marks[-1]
        shift = t0 - host0
    return DeviceTrace(
        t0, t1, [o for o in ops if t0 <= o[1] < t1 and MARKER not in o[0]],
        [(n, b + shift, f + shift) for n, b, f in spans])
