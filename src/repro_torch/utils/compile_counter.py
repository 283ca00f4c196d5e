"""Count the port's compile-like events: CUDA-graph captures and kernel
library builds and loads.

The serve path is only fast (and its iteration cost only predictable, the
property ALISE's EWT estimates lean on) if every step the engine can
dispatch was captured during warmup and every kernel library it can reach
was built and loaded then.  This is the torch counterpart of the JAX
package's ``repro.utils.compile_counter``, with the same API.  The events
are reported by the code that causes them, through :func:`note`:

* ``capture:<key>``: the step-graph runner (``serving/step_graphs.py``)
  captured a serving step as a CUDA graph;
* ``first-use:<key>``: the runner ran a graph key for the first time
  without capturing it (on the CPU, which has no graphs, or with
  ``EngineConfig.cuda_graphs`` off), so the gate means the same thing on
  every device;
* ``build:<source>`` / ``load:<source>``: ``kernels/_build`` compiled a
  kernel source with ``nvcc`` or loaded its library into the process.

``tests/test_torch_graphs.py`` warms an engine, serves a mixed-length trace
and asserts that the serve-time count is zero.
"""
from __future__ import annotations

from typing import Callable, List, Optional

_LISTENERS: List[Callable[[str], None]] = []


def note(event: str) -> None:
    """Report one compile-like event to every attached counter."""
    for listen in list(_LISTENERS):
        listen(event)


class CompileCounter:
    """Counts the compile-like events observed while attached.

    Usage::

        cc = CompileCounter()            # attaches immediately
        with cc.expect_no_compiles():    # raises if any event fires
            engine.step(t)
        cc.detach()

    or sample ``cc.count`` manually around a region.
    """

    def __init__(self) -> None:
        self.count = 0
        self.events: List[str] = []
        _LISTENERS.append(self._on_event)
        self._attached = True

    @property
    def available(self) -> bool:
        return self._attached

    def require(self) -> "CompileCounter":
        """Raise if the counter is not attached."""
        if not self._attached:
            raise RuntimeError("this CompileCounter was detached; the "
                               "compile-count gate cannot run on it")
        return self

    # -- listener -----------------------------------------------------
    def _on_event(self, event: str) -> None:
        self.count += 1
        self.events.append(event)

    # -- API ----------------------------------------------------------
    def reset(self) -> int:
        """Zero the counter, returning the count so far."""
        n = self.count
        self.count = 0
        self.events.clear()
        return n

    def detach(self) -> None:
        if self._attached:
            _LISTENERS.remove(self._on_event)
            self._attached = False

    def expect_no_compiles(self, label: str = "") -> "_NoCompileGuard":
        return _NoCompileGuard(self, label)


class _NoCompileGuard:
    def __init__(self, counter: CompileCounter, label: str) -> None:
        self.counter = counter
        self.label = label
        self._start = 0

    def __enter__(self) -> "_NoCompileGuard":
        self._start = self.counter.count
        return self

    def __exit__(self, exc_type, exc, tb) -> Optional[bool]:
        if exc_type is not None:
            return None
        fresh = self.counter.count - self._start
        if fresh:
            tail = "; ".join(self.counter.events[-fresh:])
            raise AssertionError(
                f"{fresh} unexpected graph capture(s) or library build(s)/"
                "load(s)"
                + (f" during {self.label}" if self.label else "")
                + (f" [{tail}]" if tail else ""))
        return None
