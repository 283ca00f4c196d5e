"""One run of one cell: set-up, the measured window, the metrics and the
check of what the window served.

Set-up builds what the cell's files name: the configuration's weights on
the device from the seed (``weights.py``), the port's ``Model`` and
``ServingEngine`` with the file's options (``warmup_compile``: every step
graph the cell's shapes use is captured before the window), and the
paper's retrieval length predictor pretrained on a history drawn from the
seed.  The window opens at the first arrival into the empty engine; the
harness's own open-loop clock hands each request over once it is due
(``submit``) between engine iterations (``step_and_poll``), and stamps
every token and finish with ``time.perf_counter()`` as it receives the
event.  After the close the program's state is freed and the reference
judges a sample of what was served (``check.py``).

In the traced run (``trace``) the engine's event bus is attached, the
harness's own spans mark its calls into the program's layers, the backend's
offload is timed with the device synchronized around it, and the profiler
records a fixed sub-window in the middle of the window."""
from __future__ import annotations

import gc
import importlib.util
import sys
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import torch

from portbench import check, e2e, profiling, readers, spec, weights
from portbench.arch import Arch, from_config
from portbench.traffic import gen

# top-level module names a run must never load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the port's RMSNorm epsilon (``models/layers.apply_norm``), fixed in code
PORT_RMS_EPS = 1e-5


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is forbidden, compared whole
    (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def port_arch(a: Arch, conf: dict, dtype: str):
    """The port's ``ArchConfig`` of a configuration file: its sizes, and
    the file's ``port`` group (settings of the port's model that the
    published config has no key for)."""
    from repro_torch.models.config import ArchConfig
    if a.rms_eps != PORT_RMS_EPS:
        raise ValueError(f"{a.name}: rms_norm_eps {a.rms_eps}; the port's "
                         f"RMSNorm uses {PORT_RMS_EPS}")
    kw = dict(name=a.name, family=a.family, num_layers=a.layers,
              d_model=a.d_model, num_heads=a.heads, num_kv_heads=a.kv_heads,
              head_dim=a.head_dim, d_ff=a.d_ff, vocab_size=a.vocab,
              num_experts=a.experts, top_k=a.top_k, norm_type="rmsnorm",
              act="swiglu", tie_embeddings=True, rope_theta=a.rope_theta,
              param_dtype=dtype, compute_dtype=dtype)
    kw.update(conf.get("port", {}))
    return ArchConfig(**kw)


class Probes:
    """The harness's hooks on the engine: every INT8 offload's K/V length
    (the reference rounds what the swap rounded), and in the traced run
    the host spans of its calls into the program's layers (``spans``)
    and each offload's wall with the device synchronized around it."""

    def __init__(self, eng, traced: bool, spans: profiling.Spans):
        self.swaps: Dict[int, List[int]] = {}
        self.offload_ms: List[float] = []
        cuda = eng.model.device.type == "cuda"
        kv = eng.kv
        offload = kv.offload

        def timed_offload(rid):
            if traced and cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with spans("offload"):
                blob = offload(rid)
            if traced:
                if cuda:
                    torch.cuda.synchronize()
                self.offload_ms.append((time.perf_counter() - t0) * 1e3)
            self.swaps.setdefault(rid, []).append(int(blob["lengths"]))
            return blob
        kv.offload = timed_offload
        if traced:
            for obj, name, what in ((eng.sched, "plan", "plan"),
                                    (kv, "decode", "decode"),
                                    (kv, "prefill_chunk", "prefill"),
                                    (kv, "upload", "upload"),
                                    (eng.predictor, "predict_for",
                                     "predict")):
                setattr(obj, name, _spanned(spans, getattr(obj, name), what))


def _spanned(spans, fn, what):
    def run(*args, **kwargs):
        with spans(what):
            return fn(*args, **kwargs)
    return run


def _profiler(cuda: bool):
    """A started profiler of the device's activity alone; None without a
    device (the CPU rehearsal records host spans only)."""
    if not cuda:
        return None
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof


def warm_profiler(cuda: bool) -> None:
    """Start and stop the profiler once in set-up: its first start loads
    and initializes the tracer, seconds that would otherwise fall inside
    the window."""
    prof = _profiler(cuda)
    if prof is not None:
        profiling.mark(cuda)
        prof.stop()


def _reader(name: str):
    path = spec.HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{len(name)}_{abs(hash(name))}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def build(cell: spec.Cell, a: Arch, seed: int, dev: torch.device,
          overrides: Optional[dict] = None, log=None):
    """The engine of a cell, warmed, and its traffic mix (set-up)."""
    marks = [("start", time.perf_counter())]
    from repro_torch.core.engine import EngineConfig, ServingEngine
    from repro_torch.core.predictor import RetrievalPredictor
    from repro_torch.models.model import Model
    ov = overrides or {}
    conf = cell.config
    dtype = conf["torch_dtype"]
    model_opts = dict(conf.get("model", {}), **ov.get("model", {}))
    model = Model(port_arch(a, conf, dtype), device=dev, kv_dtype=dtype,
                  **model_opts)
    params = weights.program_params(a, seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    marks.append(("weights", time.perf_counter()))
    mix = dict(cell.traffic, **ov.get("traffic", {}))
    pred = RetrievalPredictor(seed=0)
    prompts, lengths = gen.history(mix, seed, a.vocab)
    pred.pretrain(prompts, lengths)
    marks.append(("predictor", time.perf_counter()))
    engine = dict(conf["engine"], **ov.get("engine", {}))
    engine["max_slots"] = ov.get("lanes", cell.file["lanes"])
    eng = ServingEngine(model, params, EngineConfig(
        **engine, warmup_compile=True), predictor=pred)
    eng.stream_events = True
    marks.append(("engine and warmup", time.perf_counter()))
    if log is not None:
        log("[portbench] set-up: " + ", ".join(
            f"{k} {t - marks[i][1]:.3f} s"
            for i, (k, t) in enumerate(marks[1:])))
    return eng, mix


def requests(reqs) -> tuple:
    """The port's ``Request`` of each timed request, in due order, and
    the harness's empty receipt record of each, by request id."""
    from repro_torch.core.request import Request, reset_request_counter
    reset_request_counter()
    out, recs = [], {}
    for tr in reqs:
        r = Request(prompt_len=len(tr.prompt), arrival_time=tr.due,
                    true_out_len=tr.out_len, prompt_tokens=list(tr.prompt))
        recs[r.req_id] = e2e.Record(due=tr.due, out_len=tr.out_len,
                                    prompt=list(tr.prompt))
        out.append(r)
    return out, recs


def window(eng, reqs, recs, seconds: float, traced: bool,
           trace_plan: dict, spans: profiling.Spans) -> dict:
    """The measured window over the port's requests ``reqs`` (due
    order), filling ``recs``: returns the window's perf_counter origin,
    the profiled sub-window (window clock and host ns) and its profile,
    and the tokens the engine recorded for each request."""
    pending = deque(reqs)
    by_id = {r.req_id: r for r in reqs}
    cuda = eng.model.device.type == "cuda"
    lo = trace_plan["start_frac"] * seconds
    hi_len = trace_plan["seconds"]
    prof, started = None, False
    traced_span = (0.0, 0.0)
    host = [0, 0]
    T0 = time.perf_counter()
    while True:
        now = time.perf_counter() - T0
        if now >= seconds:
            break
        if traced and not started and now >= lo:
            # the sub-window: from an idle device, as long as the cell's
            # file says; the profiler runs on to the close and stops
            # after it, so that its stop costs the window nothing
            started = True
            prof = _profiler(cuda)
            host[0] = profiling.mark(cuda)
            spans.on = True
            now = time.perf_counter() - T0
            traced_span = (now, now)
        elif spans.on and now >= traced_span[0] + hi_len:
            spans.on = False
            host[1] = profiling.mark(cuda)
            now = time.perf_counter() - T0
            traced_span = (traced_span[0], now)
        with spans("submit"):
            while pending and pending[0].arrival_time <= now:
                r = pending.popleft()
                eng.submit(r, now)
                recs[r.req_id].submitted = now
        with spans("step"):
            ran, evs = eng.step_and_poll(now)
        t_rx = time.perf_counter() - T0
        with spans("poll"):
            for ev in evs:
                rec = recs.get(ev.req_id)
                if rec is None:
                    continue
                if ev.kind == "token":
                    rec.token_t.append(t_rx)
                    rec.tokens.append(int(ev.token))
                    rec.index.append(int(ev.index))
                elif ev.kind == "finish":
                    rec.finish_t, rec.reason = t_rx, ev.reason
        if not ran:
            idle = (pending[0].arrival_time - t_rx if pending
                    and not eng.sched.live else 2e-4)
            with spans("wait"):
                time.sleep(max(0.0, min(idle, seconds - t_rx)))
    t_close = time.perf_counter()
    if spans.on:                        # the window closed first
        spans.on = False
        host[1] = profiling.mark(cuda)
        traced_span = (traced_span[0], t_close - T0)
    elif cuda:
        torch.cuda.synchronize()
    if prof is not None:
        prof.stop()
    return dict(T0=T0, prof=prof, traced=traced_span,
                host=tuple(host),
                program_tokens={i: list(r.output_tokens)
                                for i, r in by_id.items()})


def _rel(ring, T0: float) -> List[tuple]:
    """A profiling ring's entries moved to the window clock (the stamp
    first), those that started before the window dropped."""
    return [(t - T0,) + tuple(rest) for t, *rest in ring if t >= T0]


def free() -> None:
    """Collect the program's dropped state (engines, graphs and closures
    refer to each other) and give the card its memory back."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: Optional[float] = None,
             overrides: Optional[dict] = None,
             hooks: Optional[Callable] = None, control: bool = False,
             log=None) -> dict:
    """One run; returns the result object (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, optionally ``breakdown``, then
    ``checks``) and, under ``_extra``, what the caller prints or keeps
    beside it."""
    t_start = t_start if t_start is not None else time.perf_counter()
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    ov = overrides or {}
    cell = spec.cell(name)
    conf = dict(cell.config, **ov.get("config", {}))
    cell.config = conf
    a = from_config(conf)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    eng, mix = build(cell, a, seed, dev, ov, log)
    rate = ov.get("rate", cell.file["rate_rps"])
    reqs, recs = requests(gen.generate(mix, rate, seconds, seed, a.vocab))
    spans = profiling.Spans()
    probes = Probes(eng, trace, spans)
    if hooks is not None:
        hooks(eng)
    bus = None
    if trace:
        warm_profiler(cuda)
        from repro_torch.serving.observability import EventBus
        bus = EventBus(capacity=1 << 20, clock="wall")
        eng.attach_bus(bus, "engine0")
    if cuda:
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    t_open = time.perf_counter()
    setup_s = t_open - t_start
    log(f"[portbench] {name} seed {seed}: set-up {setup_s:.3f} s, "
        f"{len(reqs)} requests due at {rate} req/s over {seconds} s, "
        f"{eng.cfg.max_slots} lanes")
    got = window(eng, reqs, recs, seconds, trace, cell.file["trace_window"],
                 spans)
    gc.unfreeze()
    T0 = got["T0"]
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    bad_modules = forbidden_modules()
    decode = _rel(eng.iter_times, T0)
    prefill = _rel(eng.prefill_times, T0)
    events = bus.snapshot() if bus is not None else []
    swaps, offload_ms = probes.swaps, probes.offload_ms
    del eng, probes
    free()

    metrics: Dict[str, dict] = {}
    if trace:
        dtrace = profiling.reduce(got.pop("prof"), spans.items,
                                  *got["host"])
        ctx = readers.Ctx(arch=a, seconds=seconds, recs=recs,
                          events=events, decode=decode, prefill=prefill,
                          offload_ms=offload_ms, trace=dtrace,
                          traced=got["traced"])
        for m in cell.per_layer:
            v = _reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        log(f"[portbench] traced {dtrace.window_s:.3f} s, busy "
            f"{dtrace.busy_s():.4f} s; ops: " + "; ".join(
                f"{n} {s:.5f} s x{c}" for n, s, c in dtrace.summary()))
    else:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                v = setup_s
            else:
                v = e2e.HOST_CLOCK[m["name"]](recs, seconds)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    tails = {k: f(recs, seconds) for k, f in e2e.HOST_CLOCK.items()}
    log("[portbench] host clock: " + ", ".join(
        f"{k} {v:.6g}" for k, v in tails.items() if v is not None)
        + f"; generator late {e2e.lateness(recs)}")

    # the check: accounting, then the reference over a sample
    bad = check.faults(recs, got["program_tokens"], seconds)
    ids = check.sample(recs, swaps, seconds, seed, cell.file["sample"])
    cmp = check.compare(a, seed, dev, recs, swaps, ids, control=control)
    limits = dict(cell.file["limits"], **ov.get("limits", {}))
    checks = {k: {"value": cmp.get(k), "limit": lim}
              for k, lim in limits.items()}
    for k, rids in bad.items():
        checks[k] = {"value": len(rids), "limit": 0}
    correct = (not bad_modules
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    due = [r for r in recs.values() if r.due < seconds]
    result = {
        "correct": bool(correct),
        "attempted": len(due),
        "failed": len(set().union(*bad.values())),
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if trace:
        result["device"]["busy_s"] = dtrace.busy_s()
        result["device"]["window_s"] = dtrace.window_s
        result["breakdown"] = {"device_ops": dtrace.top_ops(),
                               "idle_gaps": dtrace.idle_gaps()}
    result["checks"] = checks
    result["_extra"] = dict(compare=cmp, bad_modules=bad_modules,
                            swapped=len(swaps), setup_s=setup_s,
                            finished=sum(1 for r in recs.values()
                                         if r.finish_t is not None
                                         and r.finish_t <= seconds))
    return result
