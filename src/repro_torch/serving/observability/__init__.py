"""Unified request-lifecycle observability for the serving stack.

One structured :class:`EventBus` (bounded ring, wall- or virtual-clock
domain, off by default) records the full request lifecycle across the
gateway, scheduler, engine, memory manager, prefix cache, and simulator;
from the same stream the exporters derive a Chrome-trace/Perfetto
timeline, scheduler-quality telemetry (estimate error, queueing-delay
decomposition, head-of-line blocking), and Prometheus-style gauge text.

A copy of ``repro.serving.observability`` (the standard library and numpy
only).  In the port the serving engine, its scheduler and its prefix
caches emit into a bus attached by ``ServingEngine.attach_bus``.
"""
from repro_torch.serving.observability.bus import EventBus, TraceEvent
from repro_torch.serving.observability.prom import render_prometheus
from repro_torch.serving.observability.quality import analyze_quality
from repro_torch.serving.observability.trace_export import (to_chrome_trace,
                                                      validate_chrome_trace,
                                                      write_chrome_trace)

__all__ = [
    "EventBus", "TraceEvent",
    "to_chrome_trace", "validate_chrome_trace", "write_chrome_trace",
    "analyze_quality", "render_prometheus",
]
