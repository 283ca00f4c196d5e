"""The Gateway: an asyncio online front end over real ServingEngines.

Requests arrive at arbitrary times (wall-clock or virtual), pass SLO-class
admission control, are routed across engine replicas, and stream tokens back
through per-request async queues:

    gw = Gateway([eng0, eng1], GatewayConfig(virtual_dt=0.05))
    stream = gw.submit(req)
    async for ev in stream:          # EngineEvents: token / finish / ...
        ...
    await gw.run_until_drained()

Pump model — one pump per engine, two clock domains:

  * **Wall clock** (``virtual_dt=None``): one asyncio pump task per engine
    replica drives ``engine.step()`` through its own single-worker thread
    executor, so one replica's host work and device launches overlap the
    other replicas' instead of queueing behind one slow prefill or swap-in
    (the head-of-line blocking ALISE removes at the queue level must not be
    reintroduced at the execution level).  Each pump backs off
    exponentially while its engine is idle and posts events back to the
    event loop, which owns all stream/metrics state.  Dispatch goes through
    the engines' submit mailboxes while the pumps run.
  * **Virtual clock** (``virtual_dt`` set): a deterministic barrier pump
    steps every engine once per round and advances the clock one
    ``virtual_dt`` per round — bit-reproducible trace replay for tests and
    benchmarks.

Replicas that share a CUDA device share its legacy default stream, and
an engine's step times wait for the device (``torch.cuda.synchronize``),
so a replica's measured step includes the other replica's queued work, as
a JAX replica's ``block_until_ready`` follows the device's order.  A
step-graph capture in one pump thread excludes the other pumps' steps
(``serving/step_graphs.CAPTURE_GATE``), so a replica that captures while
another serves neither breaks the capture nor miscounts its replays.
A CUDA replica's executor thread starts on that replica's card
(:func:`pump_executor`), so a replica on another card launches there.

Correctness invariant inherited from the engine: with greedy sampling and
quantization off, streamed tokens are bit-identical to the batch
``ServingEngine.serve()`` output regardless of admission order, routing,
preemption, swapping, drain-and-requeue, or pump concurrency.
"""
from __future__ import annotations

import asyncio
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Union

import torch

from repro_torch.core.engine import EngineEvent, ServingEngine
from repro_torch.core.request import Request, RequestState, SLOClass
from repro_torch.serving.gateway.admission import (AdmissionConfig,
                                                   AdmissionController,
                                                   Verdict)
from repro_torch.serving.gateway.metrics import GatewayMetrics
from repro_torch.serving.gateway.router import GatewayRouter


class RequestStream:
    """Per-request async event stream (first-token, per-token, finish)."""

    def __init__(self, req: Request):
        self.request = req
        self.verdict: Optional[Verdict] = None
        self.emitted = 0                       # tokens forwarded so far
        self.events_log: List[EngineEvent] = []
        self.closed = False
        self._queue: asyncio.Queue = asyncio.Queue()

    # ----------------------------------------------------------- consumer
    def __aiter__(self):
        return self

    async def __anext__(self) -> EngineEvent:
        if self.closed and self._queue.empty():
            raise StopAsyncIteration
        ev = await self._queue.get()
        if ev is None:
            # close is per-consumer idempotent: hand the sentinel back so a
            # concurrent consumer already parked in get() wakes up too
            # (otherwise it would wait forever on a queue nobody refills)
            self._queue.put_nowait(None)
            raise StopAsyncIteration
        return ev

    @property
    def token_values(self) -> List[int]:
        return [ev.token for ev in self.events_log if ev.kind == "token"]

    @property
    def finished(self) -> bool:
        return any(ev.kind in ("finish", "cancel", "shed", "timeout")
                   for ev in self.events_log)

    # ----------------------------------------------------------- producer
    def _push(self, ev: EngineEvent) -> None:
        self.events_log.append(ev)
        self._queue.put_nowait(ev)

    def _close(self) -> None:
        if not self.closed:
            self.closed = True
            self._queue.put_nowait(None)



def pump_executor(d) -> ThreadPoolExecutor:
    """The single-worker executor of replica ``d``'s pump: for a replica
    whose model lives on a CUDA device the worker thread sets that device
    as its current one before its first step (``torch.cuda.set_device``)."""
    dev = torch.device(d.engine.model.device)
    pin = (dict(initializer=torch.cuda.set_device, initargs=(dev,))
           if dev.type == "cuda" else {})
    return ThreadPoolExecutor(max_workers=1,
                              thread_name_prefix=f"pump-{d.name}", **pin)

@dataclass
class GatewayConfig:
    router_policy: str = "ewt"         # ewt | join_shortest_queue | round_robin
    virtual_dt: Optional[float] = None  # virtual seconds per iteration round;
                                        # None => wall clock
    idle_sleep_s: float = 0.0005        # initial per-pump idle backoff
    max_idle_sleep_s: float = 0.02      # per-pump idle backoff cap
    concurrent_pump: bool = True        # wall clock: per-engine pump tasks
                                        # (False = legacy lockstep loop)
    max_wall_s: float = 600.0           # hard wall-time bound on replay/drain
    trace: bool = False                 # attach an observability EventBus
                                        # through every layer (off = the
                                        # emit sites cost one branch each)
    trace_capacity: int = 1 << 16       # bounded event ring size
    metrics_interval_s: Optional[float] = None   # periodic gauge-snapshot /
                                        # heartbeat cadence (gateway clock
                                        # domain; None = no periodic work)
    heartbeat: bool = False             # print a one-line metrics heartbeat
                                        # every metrics_interval_s


class Gateway:
    def __init__(self, engines: List[ServingEngine],
                 cfg: Optional[GatewayConfig] = None,
                 admission: Union[AdmissionConfig, AdmissionController,
                                  None] = None):
        self.cfg = cfg or GatewayConfig()
        self.router = GatewayRouter(engines, self.cfg.router_policy)
        if isinstance(admission, AdmissionController):
            self.admission = admission
        else:
            self.admission = AdmissionController(admission)
        self.metrics = GatewayMetrics()
        self.metrics.set_ttft_target(
            SLOClass.INTERACTIVE, self.admission.cfg.ttft_target_interactive)
        self.metrics.set_ttft_target(
            SLOClass.BATCH, self.admission.cfg.ttft_target_batch)
        self.streams: Dict[int, RequestStream] = {}
        self.deferred: Deque[Request] = deque()
        self._vclock = 0.0
        self._wall0: Optional[float] = None
        # observability: one bus spans the gateway and every replica, in
        # the gateway's clock domain (virtual replay traces and wall serves
        # export identically)
        self.bus = None
        self._last_sample: Optional[float] = None
        if self.cfg.trace:
            from repro_torch.serving.observability import EventBus
            self.bus = EventBus(
                capacity=self.cfg.trace_capacity,
                clock="virtual" if self.cfg.virtual_dt is not None
                else "wall")
            self.router.bus = self.bus
            for d in self.router.drivers:
                d.engine.attach_bus(self.bus, d.name)
        # concurrent-pump state (wall-clock mode only); each pump owns a
        # single-worker executor so replicas never contend for step threads
        # (and elastic add_engine scales the thread count with it)
        self._pump_tasks: List[asyncio.Task] = []
        self._pump_stop = False
        self._progress: Optional[asyncio.Event] = None
        self._executors: List[ThreadPoolExecutor] = []

    # ----------------------------------------------------------------- time
    def now(self) -> float:
        if self.cfg.virtual_dt is not None:
            return self._vclock
        if self._wall0 is None:
            self._wall0 = time.perf_counter()
        return time.perf_counter() - self._wall0

    # ---------------------------------------------------------------- intake
    def _ttft_terms(self, req: Request):
        """(queueing_wait, intrinsic) TTFT terms for ``req``: the predicted
        backlog of the replica the router would actually dispatch to
        (Eq. 6-7 signal), and the request's own prefill estimate plus the
        predictor's mean prediction latency (Table 2 counts prediction time
        against TTFT).  The prefill term is the engine's
        ``prefill_estimate`` — first-chunk latency when chunked prefill is
        on (the rest of the prompt interleaves with resident decode rather
        than serializing behind the backlog), whole-prompt when monolithic,
        and only the *uncached suffix* when the target replica's shared-
        prefix cache already holds a prefix of the prompt.  The queueing
        term reads the backlog at ``AdmissionConfig.ttft_quantile`` — 0.9
        gates on the calibrated-P90 remaining-length surface while routing
        keeps pricing p50.  None with no live replicas."""
        target = self.router.peek_driver(req)
        if target is None:
            return None
        eng = target.engine
        intrinsic = (eng.prefill_estimate(req.prompt_len, req.prompt_tokens)
                     + eng.predictor.mean_latency_s())
        return target.predicted_backlog(self.admission.cfg.ttft_quantile), \
            intrinsic

    def expected_ttft(self, req: Request) -> Optional[float]:
        """Per-request TTFT estimate for admission.  Returns None when no
        TTFT target is configured for the class (estimate unused)."""
        if self.admission.cfg.ttft_target(req.slo_class) is None:
            return None
        terms = self._ttft_terms(req)
        if terms is None:
            return None
        wait, intrinsic = terms
        return wait + intrinsic

    def submit(self, req: Request, now: Optional[float] = None) -> RequestStream:
        """Admission decision + (if admitted) dispatch.  Always returns a
        stream; a shed request's stream carries a single ``shed`` event."""
        t = self.now() if now is None else now
        if now is None:
            req.arrival_time = t
        stream = RequestStream(req)
        self.streams[req.req_id] = stream
        depth = self.router.total_depth() + len(self.deferred)
        backlog = self.router.total_backlog()
        # TTFT-gate terms computed once: decide() gates on wait+intrinsic,
        # and the admission event records the inputs the verdict saw
        exp = wait = intrinsic = None
        if self.admission.cfg.ttft_target(req.slo_class) is not None:
            terms = self._ttft_terms(req)
            if terms is not None:
                wait, intrinsic = terms
                exp = wait + intrinsic
        if self.bus is not None:
            # the *trace* arrival, not the pump tick that admitted it —
            # replay quantizes submission to virtual_dt, but TTFT (and the
            # analyzer's queueing decomposition) is measured from the
            # request's true arrival, matching GatewayMetrics
            self.bus.emit("arrival", t=req.arrival_time, req_id=req.req_id,
                          slo_class=req.slo_class.value,
                          prompt_len=req.prompt_len)
        verdict = self.admission.decide(req, depth, backlog,
                                        expected_ttft=exp)
        stream.verdict = verdict
        if self.bus is not None:
            self.bus.emit("admission", t=t, req_id=req.req_id,
                          verdict=verdict.value,
                          reason=self.admission.last_reason,
                          expected_ttft=exp, wait=wait,
                          intrinsic=intrinsic, depth=depth,
                          backlog_s=backlog)
        if verdict == Verdict.SHED:
            req.state = RequestState.FAILED
            self.metrics.of(req).shed += 1
            if self.bus is not None:
                self.bus.emit("shed", t=t, req_id=req.req_id,
                              reason=self.admission.last_reason)
            stream._push(EngineEvent("shed", req.req_id, t,
                                     reason="admission"))
            stream._close()
        elif verdict == Verdict.DEFER:
            self.metrics.of(req).deferred += 1
            self.deferred.append(req)
        elif req.slo_class == SLOClass.BATCH and self.deferred:
            # park behind earlier deferred work; releases drain the pool in
            # predicted-slack order (arrival order without TTFT targets) up
            # to the watermark
            self.deferred.append(req)
            self._release_deferred(t)
        else:
            self.router.dispatch(req, t)
        return stream

    def cancel(self, req_id: int) -> bool:
        t = self.now()
        for r in list(self.deferred):
            if r.req_id == req_id:
                self.deferred.remove(r)
                r.state = RequestState.CANCELLED
                stream = self.streams[req_id]
                self.metrics.of(r).cancelled += 1
                stream._push(EngineEvent("cancel", req_id, t))
                stream._close()
                return True
        d = self.router.owner.get(req_id)
        if d is None:
            return False
        ok = d.engine.cancel(req_id, t)
        if ok:
            for ev in d.engine.poll_events():
                self._dispatch_event(ev)
        return ok

    # -------------------------------------------------------------- topology
    def remove_engine(self, idx: int) -> int:
        """Drain an engine; in-flight work is re-routed losslessly."""
        d = self.router.drivers[idx]
        moved = self.router.remove_engine(idx, self.now())
        # the dead engine is no longer pumped: flush any events it emitted
        # since the last poll so no streamed token is silently dropped
        for ev in d.engine.poll_events():
            self._dispatch_event(ev)
        return len(moved)

    def add_engine(self, engine: ServingEngine) -> None:
        d = self.router.add_engine(engine)
        if self.bus is not None:
            engine.attach_bus(self.bus, d.name)
        # a live concurrent pump grows a task (and step thread) for the
        # new replica
        if self._pump_tasks and not self._pump_stop:
            self._spawn_pump(d)

    # ------------------------------------------------------------ event pump
    def _dispatch_event(self, ev: EngineEvent) -> None:
        stream = self.streams.get(ev.req_id)
        if stream is None or stream.closed:
            # closed: already terminal (wall-timeout abort, cancel) — late
            # engine events must not reopen metrics (e.g. a timed_out
            # request also counting as completed)
            return
        req = stream.request
        if ev.kind == "token":
            if ev.index is not None and ev.index < stream.emitted:
                return                      # duplicate after requeue/replay
            stream.emitted += 1
            if stream.emitted == 1:
                self.metrics.of(req).record_first_token(req, ev.t)
                if self.bus is not None:
                    self.bus.emit("first_token", t=ev.t, req_id=ev.req_id,
                                  ttft=ev.t - req.arrival_time)
            stream._push(ev)
        elif ev.kind == "finish":
            self.metrics.of(req).record_finish(req, ev.t)
            self.router.owner.pop(ev.req_id, None)
            stream._push(ev)
            stream._close()
        elif ev.kind == "cancel":
            self.metrics.of(req).cancelled += 1
            self.router.owner.pop(ev.req_id, None)
            stream._push(ev)
            stream._close()

    def _abort_open_streams(self, reason: str = "wall_timeout") -> None:
        """Terminate every still-open stream (wall-budget exceeded) so that
        consumers blocked on the queue observe a terminal event instead of
        hanging forever."""
        t = self.now()
        for stream in self.streams.values():
            if not stream.closed:
                stream.request.state = RequestState.FAILED
                if stream.emitted == 0:
                    # no first token ever: an SLO miss, not a served request
                    self.metrics.of(stream.request).timed_out += 1
                if self.bus is not None:
                    self.bus.emit("timeout", t=t,
                                  req_id=stream.request.req_id,
                                  reason=reason)
                stream._push(EngineEvent("timeout", stream.request.req_id, t,
                                         reason=reason))
                stream._close()

    def _expected_ttft_deferred(self, req: Request, t: float):
        """(expected, intrinsic) TTFT for a deferred request with its
        waiting time included; (None, None) when no replica is live."""
        terms = self._ttft_terms(req)
        if terms is None:
            return None, None
        wait, intrinsic = terms
        elapsed = max(t - req.arrival_time, 0.0)
        return elapsed + wait + intrinsic, elapsed + intrinsic

    def _release_order(self, t: float) -> List[Request]:
        """Candidates in release order: ascending predicted slack (the
        request with the least TTFT headroom that can still make its target
        dispatches first), arrival order as tie-break and as the whole
        order when no TTFT target is configured or release_order="fifo".
        With ``prefix_hint_weight`` set, each parked request's shared-prefix
        hint is re-probed first — a prefix published since the defer verdict
        makes that request's prefill cheap *now*, so it releases ahead of
        colder peers before the cached pages age out."""
        cfg = self.admission.cfg
        if cfg.release_order == "slack" and cfg.prefix_hint_weight > 0:
            alive = self.router.alive_drivers()
            for r in self.deferred:
                r.cached_prefix_hint = max(
                    (d.engine.prefix_probe(r.prompt_tokens) for d in alive
                     if hasattr(d.engine, "prefix_probe")), default=0)
        if cfg.release_order != "slack" or not any(
                cfg.ttft_target(r.slo_class) is not None
                or (cfg.prefix_hint_weight > 0 and r.cached_prefix_hint > 0)
                for r in self.deferred):
            return list(self.deferred)

        def key(req: Request):
            expected, _ = self._expected_ttft_deferred(req, t)
            return (self.admission.release_slack(req, expected),
                    req.arrival_time)
        return sorted(self.deferred, key=key)

    def _release_deferred(self, t: float) -> None:
        """One release pass: the ordering is computed once, then each
        candidate's TTFT gate is evaluated fresh at its dispatch point
        (earlier dispatches in the same pass grow the backlog term)."""
        if not self.deferred:
            return
        strict_fifo = self.admission.cfg.release_order == "fifo"
        for req in self._release_order(t):
            if not self.admission.may_release(self.router.total_depth()):
                break
            if self.admission.cfg.ttft_target(req.slo_class) is not None:
                # TTFT-deferred work re-checks its gate with waiting time
                # included: holding is only useful while the backlog term
                # is what predicts the miss.  In slack order a held request
                # is skipped, not head-of-line blocking — a later candidate
                # with a smaller prefill may still make its target now; in
                # strict FIFO a held head parks the whole queue (legacy).
                expected, intrinsic = self._expected_ttft_deferred(req, t)
                if expected is not None and not \
                        self.admission.may_release_ttft(req, expected,
                                                        intrinsic):
                    if strict_fifo:
                        break
                    continue
            self.deferred.remove(req)
            if self.bus is not None:
                self.bus.emit("defer_release", t=t, req_id=req.req_id,
                              waited=max(t - req.arrival_time, 0.0))
            self.router.dispatch(req, t)

    # -------------------------------------------------- periodic telemetry
    def _maybe_sample(self, t: float) -> None:
        """Periodic gauge snapshots (into the bus) and the optional
        one-line metrics heartbeat, every ``metrics_interval_s`` of the
        gateway clock.  Telemetry must never kill a serve: replica gauge
        reads race executor-thread steps in wall mode, so failures are
        swallowed (the next interval retries)."""
        interval = self.cfg.metrics_interval_s
        if interval is None:
            return
        if self._last_sample is not None and t - self._last_sample < interval:
            return
        self._last_sample = t
        if self.bus is not None:
            for d in self.router.alive_drivers():
                try:
                    self.bus.gauge(d.engine.gauges(), replica=d.name, t=t)
                except Exception:
                    pass
        if self.cfg.heartbeat:
            print(f"[gateway t={t:8.2f}s] "
                  f"{self.metrics.format_line(now=t)}", flush=True)

    def write_trace(self, path: str) -> dict:
        """Export the bus as Chrome-trace JSON (Perfetto-loadable)."""
        if self.bus is None:
            raise RuntimeError("tracing is off: set GatewayConfig.trace")
        from repro_torch.serving.observability import write_chrome_trace
        return write_chrome_trace(self.bus, path)

    def quality(self) -> dict:
        """Scheduler-quality telemetry derived from the event stream."""
        if self.bus is None:
            raise RuntimeError("tracing is off: set GatewayConfig.trace")
        from repro_torch.serving.observability import analyze_quality
        return analyze_quality(self.bus)

    def prometheus(self) -> str:
        """Prometheus-style text rendering of the latest gauge snapshots."""
        if self.bus is None:
            raise RuntimeError("tracing is off: set GatewayConfig.trace")
        from repro_torch.serving.observability import render_prometheus
        return render_prometheus(self.bus)

    def summary(self) -> Dict[str, object]:
        """Per-class serving metrics, enriched with scheduler-quality and
        gauge blocks when tracing is on."""
        return self.metrics.summary(bus=self.bus)

    def pump_once(self) -> bool:
        """One lockstep barrier iteration over all live engines; returns
        whether any engine made progress.  This is the virtual-clock pump
        (deterministic round order) and the legacy wall-clock path."""
        t = self.now()
        if self.bus is not None:
            self.bus.mark(t)
        self._maybe_sample(t)
        self._release_deferred(t)
        ran = False
        for d in self.router.alive_drivers():
            if d.engine.sched.live:
                ran |= d.engine.step(t)
            for ev in d.engine.poll_events():
                self._dispatch_event(ev)
        if ran and self.cfg.virtual_dt is not None:
            self._vclock += self.cfg.virtual_dt
        return ran

    # ----------------------------------------------- concurrent pump (wall)
    async def _pump_engine(self, d, executor: ThreadPoolExecutor) -> None:
        """Per-engine pump task: step this replica through its own executor
        worker so its work overlaps with the other replicas',
        dispatch the step's events on the loop thread, back off
        exponentially when idle."""
        loop = asyncio.get_running_loop()
        backoff = self.cfg.idle_sleep_s
        while not self._pump_stop and d.alive:
            t = self.now()
            self._release_deferred(t)
            if d.engine.queue_depth() > 0:
                ran, evs = await loop.run_in_executor(
                    executor, d.engine.step_and_poll, t)
                for ev in evs:
                    self._dispatch_event(ev)
                if ran or evs:
                    backoff = self.cfg.idle_sleep_s
                    if self._progress is not None:
                        self._progress.set()
                    await asyncio.sleep(0)   # let consumers run
                    continue
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, self.cfg.max_idle_sleep_s)

    def _spawn_pump(self, d) -> None:
        ex = pump_executor(d)
        self._executors.append(ex)
        self._pump_tasks.append(
            asyncio.ensure_future(self._pump_engine(d, ex)))

    def start_pumps(self) -> None:
        """Spawn one pump task (with its own step thread) per live engine;
        wall-clock mode only."""
        assert self.cfg.virtual_dt is None, \
            "concurrent pumps are wall-clock only; virtual mode is a barrier"
        if self._pump_tasks:
            return
        self._pump_stop = False
        self._progress = asyncio.Event()
        self.router.nowait = True          # dispatch via submit mailboxes
        for d in self.router.alive_drivers():
            self._spawn_pump(d)

    async def stop_pumps(self) -> None:
        """Stop pump tasks (each finishes its in-flight step), then flush
        any events still buffered so no token is dropped at shutdown.
        Cleanup always runs; the first pump failure is re-raised after."""
        self._pump_stop = True
        results = []
        if self._pump_tasks:
            results = await asyncio.gather(*self._pump_tasks,
                                           return_exceptions=True)
        self._pump_tasks = []
        self.router.nowait = False
        for ex in self._executors:
            ex.shutdown(wait=True)
        self._executors = []
        for d in self.router.drivers:
            for ev in d.engine.poll_events():
                self._dispatch_event(ev)
        for r in results:
            if isinstance(r, BaseException):
                raise r

    # ------------------------------------------------------------ run loops
    def _live(self) -> bool:
        return bool(self.router.total_depth() or self.deferred)

    async def run_until_drained(self) -> None:
        """Drain everything already submitted (an empty-arrival replay, so
        the pump/abort/metrics bookkeeping lives in one place)."""
        await self.replay([])

    async def replay(self, requests: List[Request]) -> List[RequestStream]:
        """Replay a trace (requests with arrival_time set) through admission,
        routing, and the engines; returns one stream per request.  Wall-clock
        mode uses the concurrent per-engine pump (unless disabled); virtual
        mode uses the deterministic barrier."""
        if self.cfg.virtual_dt is None and self.cfg.concurrent_pump:
            return await self._replay_concurrent(requests)
        return await self._replay_lockstep(requests)

    async def _replay_concurrent(self, requests: List[Request]
                                 ) -> List[RequestStream]:
        pending = sorted(requests, key=lambda r: r.arrival_time)
        streams: List[RequestStream] = []
        i = 0
        wall0 = time.perf_counter()
        self.metrics.start_t = self.now()
        self.start_pumps()
        try:
            while i < len(pending) or self._live():
                if time.perf_counter() - wall0 > self.cfg.max_wall_s:
                    self._abort_open_streams()
                    break
                t = self.now()
                self._maybe_sample(t)
                while i < len(pending) and pending[i].arrival_time <= t:
                    streams.append(self.submit(pending[i], now=t))
                    i += 1
                if i < len(pending):
                    # sleep toward the next arrival (bounded so drain
                    # progress keeps being observed)
                    gap = pending[i].arrival_time - self.now()
                    await asyncio.sleep(min(max(gap, 0.0), 0.05))
                else:
                    # idle until a pump reports progress (or a short tick,
                    # so deferred releases and the wall bound stay checked)
                    self._progress.clear()
                    if self._live():
                        try:
                            await asyncio.wait_for(self._progress.wait(),
                                                   timeout=0.05)
                        except asyncio.TimeoutError:
                            pass
        finally:
            await self.stop_pumps()
        self.metrics.end_t = self.now()
        return streams

    async def _replay_lockstep(self, requests: List[Request]
                               ) -> List[RequestStream]:
        pending = sorted(requests, key=lambda r: r.arrival_time)
        streams: List[RequestStream] = []
        i = 0
        wall0 = time.perf_counter()
        self.metrics.start_t = self.now()
        while i < len(pending) or self._live():
            if time.perf_counter() - wall0 > self.cfg.max_wall_s:
                self._abort_open_streams()
                break
            t = self.now()
            while i < len(pending) and pending[i].arrival_time <= t:
                streams.append(self.submit(pending[i], now=t))
                i += 1
            ran = self.pump_once()
            if not ran:
                if self._live():
                    if self.cfg.virtual_dt is not None:
                        self._vclock += self.cfg.virtual_dt
                    else:
                        await asyncio.sleep(self.cfg.idle_sleep_s)
                elif i < len(pending):
                    # idle gap before the next arrival
                    if self.cfg.virtual_dt is not None:
                        self._vclock = max(self._vclock,
                                           pending[i].arrival_time)
                    else:
                        await asyncio.sleep(self.cfg.idle_sleep_s)
            await asyncio.sleep(0)
        self.metrics.end_t = self.now()
        return streams
