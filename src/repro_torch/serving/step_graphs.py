"""CUDA graphs of the serving steps: captured once per key, replayed at
serve time.

A KV backend runs each serving step that has a fixed shape (the fused
decode step at ``max_slots`` lanes, the fused verify-k step at
``(max_slots, spec_k + 1)``, a prefill chunk of a menu bucket, a pack of
``prefill_pack_width`` chunks of a menu bucket) through
:class:`StepGraphs`.  The step is a function of one flat int32
input tensor (:func:`pack` / :func:`unpack` lay the step's integer inputs
out in it), so one persistent device tensor per key holds every input of a
graph.  Per call the host fills one pinned staging buffer and issues one
non-blocking host-to-device copy, then replays the graph; the decode
step's ``(tokens, reasons)`` come back by one copy into pinned memory and
an event wait (:meth:`StepGraphs.to_host`), and so do the verify step's
``(samples, n_emit, reason)``.

A key is captured at its first use: two eager runs on a side stream on
the step's *neutral* input (one that writes no live state: inactive lanes,
scratch pages, rows past the stripe), which reach every lazy first-use
action (library loads, kernel attributes, CUDA entry points) before the
capture, then the capture into the engine's one graph memory pool.  Graphs
are replayed one at a time; an output of a graph lives in the pool, so a
caller copies it out before the next replay.  A capture or replay that
fails raises: there is no eager fallback.  The kernels' launch counters
move under replay as under eager runs (``kernels/counters.py``).

On the CPU, which has no graphs, and with ``enabled`` off on the card, the
same step functions run eagerly on the same staged input.  Every first use
of a key is reported to ``utils/compile_counter`` (``capture:<key>`` when
captured, else ``first-use:<key>``), so the compile gate means the same on
every device.

Replicas that serve from several threads at once (the gateway's
concurrent pump) share one process, one device and the launch counters.
A capture is therefore run alone: every engine step holds
:data:`CAPTURE_GATE` shared, and a capture holds it exclusively, so no
other thread launches work, allocates or synchronizes while a graph is
captured, the pool reading sees only the capture's memory, and the
counters that move during the capture are the capture's own.  Steps of
different replicas run side by side whenever no capture is open.  The
cyclic garbage collector is held off during a capture: it would destroy
an unreachable engine's graphs inside it.
"""
from __future__ import annotations

import contextlib
import gc
import threading
from typing import Callable, Dict, Hashable, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import counters
from repro_torch.utils.compile_counter import note


def pack(*arrays) -> np.ndarray:
    """The arrays' values as one flat int32 array, in order."""
    return np.concatenate([np.asarray(a, np.int32).ravel() for a in arrays])


def unpack(buf: torch.Tensor, *shapes) -> Tuple[torch.Tensor, ...]:
    """Views of ``buf`` (flat) with ``shapes``, in :func:`pack`'s order."""
    out, at = [], 0
    for shape in shapes:
        n = int(np.prod(shape))
        out.append(buf[at:at + n].view(shape))
        at += n
    if at != buf.numel():
        raise ValueError(f"unpack: {at} of {buf.numel()} values laid out")
    return tuple(out)


class CaptureGate:
    """A readers-writer gate: engine steps hold it shared (re-entrantly,
    per thread), a graph capture holds it alone.  A thread that holds it
    shared and opens a capture gives its hold up while it waits and takes
    it back afterwards, so two replicas that capture at once take turns.
    Waiting captures go before new steps."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer: Optional[int] = None
        self._waiting = 0                  # captures waiting for the gate
        self._local = threading.local()

    def _depth(self) -> int:
        return getattr(self._local, "depth", 0)

    @contextlib.contextmanager
    def shared(self):
        depth = self._depth()
        if depth == 0 and self._writer != threading.get_ident():
            with self._cond:
                while self._writer is not None or self._waiting:
                    self._cond.wait()
                self._readers += 1
            held = True
        else:
            held = False
        self._local.depth = depth + 1
        try:
            yield
        finally:
            self._local.depth = depth
            if held:
                with self._cond:
                    self._readers -= 1
                    self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        me = threading.get_ident()
        if self._writer == me:             # nested: already alone
            yield
            return
        reading = self._depth() > 0 and self._writer is None
        with self._cond:
            if reading:
                self._readers -= 1
                self._cond.notify_all()
            self._waiting += 1
            while self._writer is not None or self._readers:
                self._cond.wait()
            self._waiting -= 1
            self._writer = me
        try:
            yield
        finally:
            with self._cond:
                self._writer = None
                self._cond.notify_all()
                if reading:
                    while self._writer is not None:
                        self._cond.wait()
                    self._readers += 1


# the process's one gate: every engine's steps and captures go through it
CAPTURE_GATE = CaptureGate()


class _Entry:
    """One key: its staging buffer, its device input, its graph."""

    def __init__(self, n: int, device: torch.device):
        cuda = device.type == "cuda"
        self.host = torch.empty((n,), dtype=torch.int32, pin_memory=cuda)
        self.static = torch.empty((n,), dtype=torch.int32, device=device)
        self.copied = torch.cuda.Event() if cuda else None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None
        self.moved: Dict[Hashable, int] = {}   # counters per replay
        self.replays = 0


class StepGraphs:
    """One engine's step graphs, keyed by ``(kind, ...)`` tuples (``kind``
    is ``"decode"``, ``"verify"``, ``"chunk"`` or ``"pack"``).  ``enabled`` captures on
    a CUDA device; elsewhere, or when off, each key runs eagerly."""

    def __init__(self, device, enabled: bool = True):
        self.device = torch.device(device)
        self.capture = enabled and self.device.type == "cuda"
        self._entries: Dict[tuple, _Entry] = {}
        self._pool = None
        self._stream = None
        self._outs: Dict[tuple, torch.Tensor] = {}   # pinned to_host buffers
        self._done = None
        self.captures = 0
        self.replays = {"decode": 0, "chunk": 0, "pack": 0, "verify": 0}
        self.pool_bytes = 0       # reserved memory the captures added

    def __len__(self) -> int:
        return len(self._entries)

    def run(self, key: tuple, staged: np.ndarray,
            step: Callable[[torch.Tensor], torch.Tensor],
            neutral: Callable[[], np.ndarray]):
        """Run ``step`` on ``staged`` (a flat int32 array) under ``key``:
        a replay of its graph (captured now at the key's first use, from
        the staged ``neutral()`` input) or, without graphs, an eager call on
        the staged device input.  Returns the step's output; a graph's
        output is overwritten by its next replay."""
        e = self._entries.get(key)
        if e is None:
            e = self._entries[key] = _Entry(staged.size, self.device)
            if self.capture:
                with CAPTURE_GATE.exclusive():
                    self._capture(e, step, neutral())
            note(f"{'capture' if self.capture else 'first-use'}:{key}")
        self._stage(e, staged)
        if e.graph is None:
            return step(e.static)
        e.graph.replay()
        counters.advance(e.moved)
        e.replays += 1
        self.replays[key[0]] += 1
        return e.out

    def replayed(self) -> Dict[tuple, Tuple[int, Dict[Hashable, int]]]:
        """Per captured key: its replays so far and the counters one
        replay advances (what its capture launched)."""
        return {k: (e.replays, dict(e.moved))
                for k, e in self._entries.items() if e.graph is not None}

    def _stage(self, e: _Entry, staged: np.ndarray) -> None:
        """One copy of ``staged`` into the key's device input; waits first
        until the previous copy from the staging buffer has landed."""
        if e.copied is not None:
            e.copied.synchronize()
        e.host.numpy()[:] = staged
        e.static.copy_(e.host, non_blocking=e.copied is not None)
        if e.copied is not None:
            e.copied.record()

    def _capture(self, e: _Entry, step, neutral: np.ndarray) -> None:
        dev = self.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(dev)
        self._stage(e, neutral)
        side = self._stream
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                step(e.static)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = counters.snapshot()
        # torch.cuda.graph frees the allocator's unused blocks on entry:
        # free them first, so the reading below sees only the capture's
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        # no collection inside the capture: a dead engine's graphs (a cycle
        # the collector frees) destroyed mid-capture would invalidate it,
        # as CUDA forbids that call while a stream captures; the collector
        # frees them after the capture instead
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=side):
                out = step(e.static)
        finally:
            if collecting:
                gc.enable()
        self.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
        e.moved = counters.delta(before, counters.snapshot())
        counters.advance(e.moved, -1)       # the capture launched nothing
        e.graph, e.out = graph, out
        self.captures += 1

    def to_host(self, out: torch.Tensor) -> np.ndarray:
        """``out`` as a numpy array: on the card one copy into a pinned
        buffer and a wait on its event."""
        if out.device.type != "cuda":
            return out.numpy()
        key = (tuple(out.shape), out.dtype)
        host = self._outs.get(key)
        if host is None:
            host = self._outs[key] = torch.empty(
                out.shape, dtype=out.dtype, pin_memory=True)
            self._done = self._done or torch.cuda.Event()
        host.copy_(out, non_blocking=True)
        self._done.record()
        self._done.synchronize()
        return host.numpy().copy()
