"""The port's online gateway (``repro_torch.serving.gateway``), the engine
API it drives and the launcher's gateway mode, against the JAX package's
(``tests/test_gateway.py`` is the model).

Against the reference, on the same scripted inputs (granite's smoke
config in float32, the same weights carried across with
``params_from_numpy``; on the CPU the port takes its kernels' plain
versions):

  * the copied modules: ``AdmissionController`` verdicts and reasons on
    every path (watermarks, TTFT shed / defer / observe, release slack,
    TTFT release), ``GatewayMetrics`` summaries and lines;
  * a virtual-clock Poisson replay over two unwarmed 2-lane replicas (so
    the latency model keeps its constants) on both backends: tokens,
    replica per request, verdicts and ``metrics.summary()`` equal;
  * admission scripts (overload watermarks, the TTFT gate's shed, observe
    and defer-then-drain paths, deferred release order), ``prefix_ewt``
    routing, drain-and-requeue and cancel;
  * the gateway's bus events and their exports;
  * ``serve_gateway`` at the smoke size, with the KV tier on and off.

In the port: the submit mailbox (``submit_nowait``, ``queue_depth``,
``predicted_backlog``, ``drain``, ``cancel``) against the reference
engine's numbers, streams equal to the batch serve under preemption, the
wall-clock concurrent pump, the launch counters under threads, the
capture gate, and the streaming example.  No test asserts a wall time.
"""
import asyncio
import dataclasses
import importlib.util
import math
import pathlib
import sys
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.core import predictor as jax_predictor  # noqa: E402
from repro.core import request as jax_request  # noqa: E402
from repro.core import trace as jax_trace  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import gateway as jax_gw  # noqa: E402
from repro.serving import observability as jax_obs  # noqa: E402
from repro.serving.gateway import metrics as jax_metrics  # noqa: E402
from repro.serving.gateway import router as jax_router  # noqa: E402
from repro_torch.core import engine as port_engine  # noqa: E402
from repro_torch.core import predictor as port_predictor  # noqa: E402
from repro_torch.core import request as port_request  # noqa: E402
from repro_torch.core import trace as port_trace  # noqa: E402
from repro_torch.kernels import counters  # noqa: E402
from repro_torch.kernels.fused_rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models.model import Model, params_from_numpy  # noqa: E402
from repro_torch.serving import gateway as port_gw  # noqa: E402
from repro_torch.serving import observability as port_obs  # noqa: E402
from repro_torch.serving.gateway import metrics as port_metrics  # noqa: E402
from repro_torch.serving.gateway import router as port_router  # noqa: E402
from repro_torch.serving.step_graphs import CaptureGate  # noqa: E402

SIDES = ("port", "jax")
MODS = {
    "port": SimpleNamespace(engine=port_engine, predictor=port_predictor,
                            request=port_request, trace=port_trace,
                            gw=port_gw, obs=port_obs, metrics=port_metrics,
                            router=port_router),
    "jax": SimpleNamespace(engine=jax_engine, predictor=jax_predictor,
                           request=jax_request, trace=jax_trace,
                           gw=jax_gw, obs=jax_obs, metrics=jax_metrics,
                           router=jax_router),
}
_ENG = dict(max_slots=2, max_seq_len=64, max_new_tokens=24,
            strategy="alise", quantize_offload=False)
# gateway-scope and terminal event kinds: their times are the gateway's
# virtual clock; an engine's execution spans (prefill_chunk, decode_iter,
# swaps, hol_blocked) carry wall-clock durations
_VIRTUAL_KINDS = ("arrival", "admission", "defer_release", "dispatch",
                  "first_token", "shed", "timeout", "queue_join", "predict",
                  "promote", "demote", "preempt", "finish")
# gauges that read a wall clock or a framework's device label
_GAUGE_SKIP = ("predictor_update_lat_ms", "device_index")


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_smoke_config("granite-3-8b"),
                              param_dtype="float32")
    jmodel = JaxModel(cfg, kv_dtype="float32", remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tmodel = Model(cfg, kv_dtype="float32", device="cpu")
    return SimpleNamespace(cfg=cfg, models={"port": (tmodel, tparams),
                                            "jax": (jmodel, jparams)})


def _engine(setup, side, **kw):
    m = MODS[side]
    model, params = setup.models[side]
    return m.engine.ServingEngine(
        model, params, m.engine.EngineConfig(**{**_ENG, **kw}),
        predictor=m.predictor.OraclePredictor())


def _gateway(setup, side, n=2, eng_kw=None, adm=None, **gw_kw):
    m = MODS[side]
    engines = [_engine(setup, side, **(eng_kw or {})) for _ in range(n)]
    return m.gw.Gateway(engines,
                        m.gw.GatewayConfig(**{"virtual_dt": 0.05, **gw_kw}),
                        admission=(m.gw.AdmissionConfig(**adm)
                                   if adm is not None else None))


def _poisson(setup, side, n=32, rate=20.0, seed=0):
    """``tests/test_gateway.py``'s Poisson trace on ``side``'s modules."""
    m = MODS[side]
    m.request.reset_request_counter()
    trace = m.trace.generate_trace(m.trace.TraceConfig(
        dataset="alpaca", rate=rate, duration=1e9, max_requests=n,
        seed=seed))
    reqs = m.trace.clamp_requests(trace.requests, vocab=setup.cfg.vocab_size,
                                  max_prompt=12, max_new=16)
    for i, r in enumerate(reqs):
        r.slo_class = (m.request.SLOClass.INTERACTIVE if i % 4 == 0
                       else m.request.SLOClass.BATCH)
        r.true_out_len = 3 if i % 4 == 0 else 16
    return reqs


def _batch_tokens(setup, reqs, max_slots=8):
    """The port's batch ``ServingEngine.serve()`` tokens for fresh
    arrival-0 copies of ``reqs``."""
    copies = [port_request.Request(
        prompt_len=r.prompt_len, arrival_time=0.0,
        true_out_len=r.true_out_len, prompt_tokens=list(r.prompt_tokens))
        for r in reqs]
    _engine(setup, "port", max_slots=max_slots).serve(copies)
    return [list(r.output_tokens) for r in copies]


def _same(a, b) -> bool:
    """Deep equality with NaN equal to NaN (empty percentiles)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    return a == b


def _ev(ev):
    return (ev.kind, ev.t, ev.token, ev.index, ev.reason)


def _stream_record(gw, streams):
    return dict(
        tokens=[s.token_values for s in streams],
        verdicts=[s.verdict.value if s.verdict is not None else None
                  for s in streams],
        events=[[_ev(e) for e in s.events_log] for s in streams],
        summary=gw.metrics.summary())


def _virtual_events(bus):
    """The bus's virtual-clock events, with the gauges' wall-clock and
    device-label keys left out."""
    out = []
    for e in bus.snapshot():
        if e.kind == "gauge":
            data = {k: v for k, v in e.data.items() if k not in _GAUGE_SKIP}
        elif e.kind in _VIRTUAL_KINDS:
            data = dict(e.data)
        else:
            continue
        out.append(port_obs.bus.TraceEvent(kind=e.kind, t=e.t, dur=e.dur,
                                           req_id=e.req_id,
                                           replica=e.replica, data=data))
    return out


# ------------------------------------------------------ the copied modules

_ADMISSION_CASES = {
    "watermarks": dict(max_queue_depth=10, defer_high_watermark=6),
    "backlog_cap": dict(max_backlog_s=2.0, interactive_hard_cap=9),
    "ttft_shed": dict(ttft_target_interactive=0.5, ttft_target_batch=1.0),
    "ttft_defer": dict(ttft_target_interactive=0.5, ttft_target_batch=1.0,
                       ttft_miss_policy="defer", ttft_slack=1.5),
    "ttft_observe": dict(ttft_target_interactive=0.5,
                         ttft_miss_policy="observe"),
    "prefix_hint": dict(ttft_target_batch=0.8, prefix_hint_weight=0.01,
                        release_order="fifo"),
}


@pytest.mark.parametrize("case", sorted(_ADMISSION_CASES))
def test_admission_controller_equals_the_reference(case):
    """The same scripted (class, depth, backlog, expected TTFT) sequence
    gives the reference's verdicts, reasons, miss counts, release slack and
    release decisions."""
    rng = np.random.default_rng(7)
    script = [(bool(rng.random() < 0.4), int(rng.integers(0, 14)),
               float(rng.uniform(0, 3)),
               None if rng.random() < 0.2 else float(rng.uniform(0, 1.5)),
               int(rng.integers(0, 40)))
              for _ in range(60)]
    got = {}
    for side in SIDES:
        m = MODS[side]
        ctl = m.gw.AdmissionController(
            m.gw.AdmissionConfig(**_ADMISSION_CASES[case]))
        rec = []
        for inter, depth, backlog, exp, hint in script:
            req = m.request.Request(
                prompt_len=8, arrival_time=0.0, true_out_len=4,
                prompt_tokens=[2] * 8,
                slo_class=(m.request.SLOClass.INTERACTIVE if inter
                           else m.request.SLOClass.BATCH))
            req.cached_prefix_hint = hint
            v = ctl.decide(req, depth, backlog, expected_ttft=exp)
            rec.append((v.value, ctl.last_reason, ctl.ttft_misses_predicted,
                        ctl.release_slack(req, exp),
                        ctl.may_release(depth),
                        None if exp is None else ctl.may_release_ttft(
                            req, exp, exp / 2)))
        got[side] = rec
    assert got["port"] == got["jax"]
    # the script gates, or (observe) records predicted misses
    assert len({r[0] for r in got["port"]}) >= 2 or got["port"][-1][2] > 0
    assert port_gw.AdmissionConfig(ttft_miss_policy="defer"
                                   ).ttft_miss_policy == port_gw.MissPolicy.DEFER


def test_gateway_metrics_equal_the_reference():
    """``GatewayMetrics`` over the same finished requests and sheds gives
    the reference's ``summary()``, ``format_line()`` and ``format()``,
    with TTFT targets set (SLO attainment) and an empty class (NaN
    percentiles)."""
    rng = np.random.default_rng(3)
    rows = [(bool(rng.random() < 0.5), float(rng.uniform(0, 2)),
             float(rng.uniform(0.01, 1)), int(rng.integers(1, 30)))
            for _ in range(25)]
    got = {}
    for side in SIDES:
        m = MODS[side]
        gm = m.metrics.GatewayMetrics()
        gm.set_ttft_target(m.request.SLOClass.INTERACTIVE, 0.4)
        gm.start_t = 0.5
        for inter, arr, ttft, n in rows:
            req = m.request.Request(
                prompt_len=4, arrival_time=arr, true_out_len=n,
                prompt_tokens=[2] * 4,
                slo_class=(m.request.SLOClass.INTERACTIVE if inter
                           else m.request.SLOClass.BATCH))
            req.first_token_time = arr + ttft
            req.generated = n
            gm.of(req).record_first_token(req, arr + ttft)
            gm.of(req).record_finish(req, arr + ttft + 0.02 * n)
        gm.per_class[m.request.SLOClass.INTERACTIVE].shed += 2
        gm.per_class[m.request.SLOClass.BATCH].timed_out += 1
        line = gm.format_line(now=3.0)
        gm.end_t = 4.25
        empty = m.metrics.GatewayMetrics().summary()
        got[side] = (gm.summary(), line, gm.format(), empty,
                     m.metrics.percentile([], 50))
    assert _same(got["port"], got["jax"])
    assert "SLO(ttft<=0.40s)" in got["port"][2]


# ------------------------------------------------ virtual-clock replay

@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_virtual_replay_equals_the_reference(setup, backend):
    """``tests/test_gateway.py``'s 32-request Poisson trace over two
    2-lane replicas: the port's Gateway gives the reference's tokens,
    replica per request, admission verdicts and ``metrics.summary()``
    exactly, under preemption, and the batch serve's tokens."""
    eng_kw = dict(kv_backend=backend, page_size=16)
    got = {}
    for side in SIDES:
        reqs = _poisson(setup, side, n=32)
        gw = _gateway(setup, side, eng_kw=eng_kw, trace=True)
        streams = asyncio.run(gw.replay(reqs))
        rec = _stream_record(gw, streams)
        rec["routes"] = [(e.req_id, e.replica) for e in gw.bus.snapshot()
                         if e.kind == "dispatch"]
        rec["preempts"] = sum(r.preempt_count for r in reqs)
        rec["served"] = [len(d.engine.sched.finished)
                         for d in gw.router.drivers]
        got[side] = rec
    port, ref = got["port"], got["jax"]
    for key in ("tokens", "verdicts", "events", "routes", "preempts",
                "served"):
        assert port[key] == ref[key], key
    assert _same(port["summary"], ref["summary"])
    assert port["preempts"] > 0 and all(port["served"])
    assert port["tokens"] == _batch_tokens(setup, _poisson(setup, "port"))


# ---------------------------------------------- admission and routing

def _req(m, cfg, rng, plen, out, arrival=0.0, inter=False):
    return m.request.Request(
        prompt_len=plen, arrival_time=arrival, true_out_len=out,
        prompt_tokens=rng.integers(2, cfg.vocab_size, plen).tolist(),
        slo_class=(m.request.SLOClass.INTERACTIVE if inter
                   else m.request.SLOClass.BATCH))


def _script_overload(setup, side):
    m = MODS[side]
    m.request.reset_request_counter()
    rng = np.random.default_rng(2)
    reqs = [_req(m, setup.cfg, rng, 8, 4 if k % 4 == 0 else 20,
                 round(k * 0.02, 3), inter=k % 4 == 0) for k in range(24)]
    gw = _gateway(setup, side, n=1, adm=dict(max_queue_depth=10,
                                             defer_high_watermark=6),
                  trace=True)
    return gw, asyncio.run(gw.replay(reqs))


def _script_ttft_shed(setup, side):
    m = MODS[side]
    m.request.reset_request_counter()
    rng = np.random.default_rng(5)
    reqs = [_req(m, setup.cfg, rng, 8, 20, round(k * 0.01, 3), inter=True)
            for k in range(20)]
    gw = _gateway(setup, side, n=1, adm=dict(ttft_target_interactive=0.5),
                  trace=True)
    return gw, asyncio.run(gw.replay(reqs))


def _script_ttft_observe(setup, side):
    m = MODS[side]
    m.request.reset_request_counter()
    rng = np.random.default_rng(6)
    reqs = [_req(m, setup.cfg, rng, 8, 12, inter=k % 2 == 0)
            for k in range(10)]
    gw = _gateway(setup, side, n=1, adm=dict(
        ttft_target_interactive=1e-6, ttft_target_batch=1e-6,
        ttft_miss_policy="observe"), trace=True)
    return gw, asyncio.run(gw.replay(reqs))


def _script_ttft_defer(setup, side):
    m = MODS[side]
    m.request.reset_request_counter()
    rng = np.random.default_rng(8)
    reqs = [_req(m, setup.cfg, rng, 8, 16, round(k * 0.01, 3))
            for k in range(16)]
    gw = _gateway(setup, side, n=1, adm=dict(ttft_target_batch=0.6),
                  trace=True)
    return gw, asyncio.run(gw.replay(reqs))


_SCRIPTS = {"overload_watermarks": _script_overload,
            "ttft_shed": _script_ttft_shed,
            "ttft_observe": _script_ttft_observe,
            "ttft_defer_then_drain": _script_ttft_defer}


@pytest.mark.parametrize("script", sorted(_SCRIPTS))
def test_admission_scripts_equal_the_reference(setup, script):
    """``tests/test_gateway.py``'s admission scripts (watermark shed and
    defer under overload, the TTFT gate shedding doomed interactive work,
    observe never gating, TTFT-deferred batch work held and then drained):
    the port's streams, verdicts, admission reasons and expected-TTFT
    terms, miss counts and metrics equal the reference's."""
    got = {}
    for side in SIDES:
        gw, streams = _SCRIPTS[script](setup, side)
        rec = _stream_record(gw, streams)
        rec["admission"] = [(e.req_id, e.data["verdict"], e.data["reason"],
                             e.data["expected_ttft"], e.data["depth"],
                             e.data["backlog_s"])
                            for e in gw.bus.snapshot()
                            if e.kind == "admission"]
        rec["releases"] = [(e.req_id, e.t) for e in gw.bus.snapshot()
                           if e.kind == "defer_release"]
        rec["misses"] = gw.admission.ttft_misses_predicted
        got[side] = rec
    port, ref = got["port"], got["jax"]
    for key in ("tokens", "verdicts", "events", "admission", "releases",
                "misses"):
        assert port[key] == ref[key], key
    assert _same(port["summary"], ref["summary"])
    assert all(any(ev[0] in ("finish", "shed") for ev in evs)
               for evs in port["events"])
    gated = {"overload_watermarks": ("shed", "defer"),
             "ttft_shed": ("shed",), "ttft_observe": (),
             "ttft_defer_then_drain": ("defer",)}[script]
    for verdict in gated:
        assert verdict in port["verdicts"] or any(
            a[1] == verdict for a in port["admission"]), verdict
    if script == "ttft_observe":
        assert set(port["verdicts"]) == {"admit"} and port["misses"] > 0


@pytest.mark.parametrize("order", ["slack", "fifo"])
def test_deferred_release_order_equals_the_reference(setup, order):
    """A short and a long deferred prompt released in one pass: slack
    order dispatches the one with less TTFT headroom (the longer prefill)
    first, FIFO keeps arrival order; the port's dispatch order is the
    reference's."""
    got = {}
    for side in SIDES:
        m = MODS[side]
        m.request.reset_request_counter()
        rng = np.random.default_rng(5)
        short = _req(m, setup.cfg, rng, 4, 4)
        long = _req(m, setup.cfg, rng, 12, 4)
        gw = _gateway(setup, side, n=1, adm=dict(ttft_target_batch=30.0,
                                                 release_order=order))
        for r in (short, long):
            gw.streams[r.req_id] = m.gw.RequestStream(r)
        gw.deferred.extend([short, long])
        gw._release_deferred(0.0)
        live = list(gw.router.drivers[0].engine.sched.live.keys())
        got[side] = (live, short.req_id, long.req_id)
    assert got["port"] == got["jax"]
    live, s_id, l_id = got["port"]
    assert live == ([l_id, s_id] if order == "slack" else [s_id, l_id])


def test_prefix_ewt_routing_equals_the_reference(setup):
    """``tests/test_prefix_cache.py``'s affinity script: the replica whose
    index holds the prompt's prefix wins over the lower-backlog one; with
    no hit anywhere EWT picks the emptier replica; backlogs and prefill
    estimates equal the reference's."""
    got = {}
    for side in SIDES:
        m = MODS[side]
        kw = dict(max_slots=4, max_seq_len=96, max_new_tokens=8,
                  prefill_chunk=6, kv_backend="paged", page_size=8,
                  prefix_cache=True)
        e0, e1 = _engine(setup, side, **kw), _engine(setup, side, **kw)
        rng = np.random.default_rng(0)
        shared = rng.integers(2, setup.cfg.vocab_size, 24).tolist()
        m.request.reset_request_counter()
        e0.serve([m.request.Request(prompt_len=24, arrival_time=0.0,
                                    true_out_len=4,
                                    prompt_tokens=list(shared))])
        parked = _req(m, setup.cfg, rng, 20, 16)
        e0.sched.submit(parked, 0.0)
        e0._backlog_cache = e0.sched.predicted_backlog()
        router = m.router.GatewayRouter([e0, e1], policy="prefix_ewt")
        follow = m.request.Request(
            prompt_len=30, arrival_time=0.0, true_out_len=4,
            prompt_tokens=shared + rng.integers(
                2, setup.cfg.vocab_size, 6).tolist())
        peek = router.peek_driver(follow).name
        went = router.dispatch(follow, 0.0).name
        cold = _req(m, setup.cfg, rng, 10, 4)
        got[side] = (peek, went, router.peek_driver(cold).name,
                     e0.prefix_probe(follow.prompt_tokens),
                     [d.predicted_backlog() for d in router.drivers],
                     e0.prefill_estimate(30, follow.prompt_tokens),
                     e1.prefill_estimate(30, follow.prompt_tokens))
    assert got["port"] == got["jax"]
    assert got["port"][:3] == ("engine0", "engine0", "engine1")


# ------------------------------------------------- drain and cancel

def test_drain_and_requeue_equals_the_reference(setup):
    """Removing a replica mid-generation re-routes its in-flight work: the
    streams equal the reference's event for event, and the batch serve's
    tokens, with no token lost or duplicated; the last alive replica
    cannot be removed."""
    got = {}
    for side in SIDES:
        m = MODS[side]
        rng = np.random.default_rng(1)
        prompts = [rng.integers(2, setup.cfg.vocab_size, 8).tolist()
                   for _ in range(6)]
        m.request.reset_request_counter()
        reqs = [m.request.Request(prompt_len=8, arrival_time=0.0,
                                  true_out_len=20, prompt_tokens=list(p))
                for p in prompts]
        gw = _gateway(setup, side)
        streams = [gw.submit(r, now=0.0) for r in reqs]

        async def run():
            for _ in range(6):
                gw.pump_once()
            busy = [d.queue_depth() for d in gw.router.drivers]
            moved = gw.remove_engine(0)
            await gw.run_until_drained()
            return busy, moved

        busy, moved = asyncio.run(run())
        with pytest.raises(ValueError):
            gw.remove_engine(1)
        got[side] = dict(busy=busy, moved=moved,
                         left=gw.router.drivers[0].engine.queue_depth(),
                         **_stream_record(gw, streams))
    port, ref = got["port"], got["jax"]
    for key in ("busy", "moved", "left", "tokens", "events"):
        assert port[key] == ref[key], key
    assert _same(port["summary"], ref["summary"])
    assert all(port["busy"]) and port["moved"] > 0 and port["left"] == 0
    for evs in port["events"]:
        idx = [e[3] for e in evs if e[0] == "token"]
        assert idx == list(range(len(idx)))        # none lost or repeated
    m = MODS["port"]
    rng = np.random.default_rng(1)
    batch = [m.request.Request(
        prompt_len=8, arrival_time=0.0, true_out_len=20,
        prompt_tokens=rng.integers(2, setup.cfg.vocab_size, 8).tolist())
        for _ in range(6)]
    assert port["tokens"] == _batch_tokens(setup, batch)


def test_cancel_equals_the_reference(setup):
    """``tests/test_gateway.py``'s cancel script: request 0 is cancelled
    after four rounds and its stream closes on a ``cancel`` event; every
    stream's events and every request's state equal the reference
    gateway's (no assertion on ``true_out_len``: the smoke weights may
    sample EOS first)."""
    got = {}
    for side in SIDES:
        m = MODS[side]
        m.request.reset_request_counter()
        rng = np.random.default_rng(3)
        reqs = [_req(m, setup.cfg, rng, 8, 20) for _ in range(3)]
        gw = _gateway(setup, side, n=1)
        streams = [gw.submit(r, now=0.0) for r in reqs]
        for _ in range(4):
            gw.pump_once()
        ok = gw.cancel(reqs[0].req_id)
        again = gw.cancel(reqs[0].req_id)
        asyncio.run(gw.run_until_drained())
        got[side] = dict(ok=(ok, again),
                         states=[r.state.value for r in reqs],
                         closed=[s.closed for s in streams],
                         **_stream_record(gw, streams))
    port, ref = got["port"], got["jax"]
    for key in ("ok", "states", "closed", "tokens", "events"):
        assert port[key] == ref[key], key
    assert _same(port["summary"], ref["summary"])
    assert port["ok"] == (True, False)
    assert port["events"][0][-1][0] == "cancel"
    assert port["states"][0] == port_request.RequestState.CANCELLED.value


# ------------------------------------------------------ bus events

def test_gateway_bus_events_and_exports_equal_the_reference(setup):
    """A traced virtual-clock replay with watermark admission and gauge
    snapshots: the virtual-clock events (arrival, admission, dispatch,
    first_token, shed, defer_release, the scheduler's and finish) equal the
    reference's, and so do their Chrome trace, Prometheus text and
    scheduler-quality analysis (gauges without the keys that read a wall
    clock or a device label)."""
    got = {}
    for side in SIDES:
        reqs = _poisson(setup, side, n=24, rate=40.0, seed=4)
        gw = _gateway(setup, side, adm=dict(max_queue_depth=7,
                                            defer_high_watermark=5),
                      trace=True, metrics_interval_s=0.2)
        asyncio.run(gw.replay(reqs))
        got[side] = _virtual_events(gw.bus)
    port, ref = got["port"], got["jax"]
    key = [(e.kind, e.t, e.req_id, e.replica, e.data) for e in port]
    assert key == [(e.kind, e.t, e.req_id, e.replica, e.data) for e in ref]
    kinds = {e.kind for e in port}
    assert {"arrival", "admission", "dispatch", "first_token", "shed",
            "defer_release", "gauge", "finish"} <= kinds
    assert port_obs.to_chrome_trace(port) == jax_obs.to_chrome_trace(ref)
    assert port_obs.render_prometheus(port) == \
        jax_obs.render_prometheus(ref)
    assert _same(port_obs.analyze_quality(port),
                 jax_obs.analyze_quality(ref))


# ------------------------------------------------------ the launcher

@pytest.mark.parametrize("kv_tier", [False, True])
def test_serve_gateway_equals_the_reference(setup, monkeypatch, kv_tier):
    """The launcher's gateway mode at the smoke size on a virtual clock:
    the port's ``serve_gateway`` and the reference's (its model made in
    float32, on the fixture's weights) stream the same tokens to the same
    replicas, with equal tier stats when ``kv_tier`` joins the replicas to
    one host tier."""
    cfg = setup.cfg
    monkeypatch.setattr(ref_serve, "get_smoke_config", lambda arch: cfg)
    monkeypatch.setattr(ref_serve, "Model", lambda c, **kw: JaxModel(
        c, **{**kw, "kv_dtype": "float32"}))
    kw = dict(n_requests=12, n_engines=2, kv_backend="paged",
              prefill_chunk=8, kv_tier=kv_tier, prefix_cache=kv_tier,
              router="prefix_ewt" if kv_tier else "ewt")
    ref_streams, ref_gw = ref_serve.serve_gateway(**kw)
    streams, gw = port_serve.serve_gateway(
        device="cpu", model_and_params=setup.models["port"], **kw)
    assert [s.token_values for s in streams] == [s.token_values
                                                 for s in ref_streams]
    assert [s.request.prompt_tokens for s in streams] == [
        s.request.prompt_tokens for s in ref_streams]
    assert all(s.finished for s in streams) and len(streams) == 12
    assert _same(gw.metrics.summary(), ref_gw.metrics.summary())
    tiers = [{d.engine.tier for d in g.router.drivers} for g in (gw, ref_gw)]
    if kv_tier:
        (tier,), (ref_tier,) = tiers
        assert tier.stats.as_dict() == ref_tier.stats.as_dict()
        assert tier.stats.published_pages > 0
        assert tier.pinned_pages() == 0
    else:
        assert tiers == [{None}, {None}]


def test_serve_gateway_main_flags(monkeypatch, capsys):
    """``--gateway`` runs through ``main()`` on the CPU (the wall clock and
    the concurrent pump, the tier and placement flags); the tier and
    placement flags in batch mode print the reference's message."""
    monkeypatch.setattr(sys, "argv", [
        "serve", "--gateway", "--device", "cpu", "--n-requests", "4",
        "--n-engines", "2", "--wall", "--kv-tier", "--devices", "cpu",
        "--kv-backend", "paged", "--prefill-chunk", "8"])
    port_serve.main()
    out = capsys.readouterr().out
    assert "4/4 streams finished" in out and "[kv-tier]" in out
    assert "[cpu:0, cpu:0]" in out and "wall/concurrent" in out
    monkeypatch.setattr(sys, "argv", [
        "serve", "--device", "cpu", "--n-requests", "2", "--kv-tier",
        "--metrics-interval", "1"])
    port_serve.main()
    out = capsys.readouterr().out
    assert "--kv-tier/--devices are gateway-mode only" in out
    assert "--metrics-interval is gateway-mode only" in out


# ------------------------------------------------------ in the port

def test_submit_mailbox_equals_the_reference(setup):
    """Parked requests: ``queue_depth`` and ``predicted_backlog`` (p50 and
    p90 surfaces, mailbox term included) equal the reference engine's for
    the same parked set, with the prefix hint priced; ``cancel`` and
    ``drain`` take parked requests; ``submit_nowait`` then ``step``
    serves what ``submit`` then ``step`` serves."""
    kw = dict(prefill_chunk=6, kv_backend="paged", page_size=8,
              prefix_cache=True, max_seq_len=96)
    got = {}
    for side in SIDES:
        m = MODS[side]
        eng = _engine(setup, side, **kw)
        rng = np.random.default_rng(9)
        shared = rng.integers(2, setup.cfg.vocab_size, 16).tolist()
        m.request.reset_request_counter()
        eng.serve([m.request.Request(prompt_len=16, arrival_time=0.0,
                                     true_out_len=3,
                                     prompt_tokens=list(shared))])
        reqs = [m.request.Request(
            prompt_len=16 + k, arrival_time=0.0, true_out_len=5 + k,
            prompt_tokens=(shared if k % 2 else rng.integers(
                2, setup.cfg.vocab_size, 16).tolist())
            + rng.integers(2, setup.cfg.vocab_size, k).tolist())
            for k in range(4)]
        eng.submit(reqs[0], 0.0)
        for r in reqs[1:]:
            eng.submit_nowait(r, 0.0)
        rec = [eng.queue_depth(), eng.predicted_backlog(),
               eng.predicted_backlog(0.9),
               [r.cached_prefix_hint for r in reqs]]
        assert eng.cancel(reqs[3].req_id, 0.5)
        rec += [reqs[3].state.value, reqs[3].finish_time, eng.queue_depth(),
                eng.predicted_backlog()]
        drained = eng.drain()
        rec += [[r.req_id for r in drained], eng.queue_depth(),
                eng.predicted_backlog()]
        got[side] = rec
    assert _same(got["port"], got["jax"])
    depth, backlog, q90, hints = got["port"][:4]
    assert depth == 4 and backlog > 0 and q90 >= backlog
    assert any(h > 0 for h in hints)
    assert got["port"][-2:] == [0, 0.0]

    def serve(nowait):
        eng = _engine(setup, "port", kv_backend="paged", prefill_chunk=6)
        port_request.reset_request_counter()
        rng = np.random.default_rng(11)
        reqs = [_req(MODS["port"], setup.cfg, rng, 10, 6) for _ in range(4)]
        for r in reqs:
            (eng.submit_nowait if nowait else eng.submit)(r, 0.0)
        t = 0.0
        while eng.queue_depth():
            ran, evs = eng.step_and_poll(t)
            t += 0.05
        return [list(r.output_tokens) for r in reqs]

    assert serve(True) == serve(False)


@pytest.mark.parametrize("policy", ["round_robin", "join_shortest_queue"])
def test_streams_equal_the_batch_serve(setup, policy):
    """Virtual-clock replay over two 2-lane replicas under each baseline
    router: streams equal the batch serve's tokens under preemption."""
    reqs = _poisson(setup, "port", n=32, rate=40.0)
    gw = _gateway(setup, "port", router_policy=policy)
    streams = asyncio.run(gw.replay(reqs))
    assert [s.token_values for s in streams] == _batch_tokens(
        setup, _poisson(setup, "port", n=32, rate=40.0))
    assert sum(r.preempt_count for r in reqs) > 0
    assert all(d.engine.sched.finished for d in gw.router.drivers)


@pytest.mark.parametrize("pump", ["concurrent", "lockstep"])
def test_wallclock_pumps_equal_the_batch_serve(setup, pump):
    """The wall clock's concurrent per-engine pump (one step thread per
    replica, dispatch through the submit mailboxes) and the lockstep
    barrier stream the batch serve's tokens; every stream finishes, the
    pumps and their threads shut down, gauges were sampled."""
    reqs = _poisson(setup, "port", n=12, rate=40.0)
    gw = _gateway(setup, "port", virtual_dt=None,
                  concurrent_pump=pump == "concurrent", max_wall_s=300.0,
                  trace=True, metrics_interval_s=0.05)
    streams = asyncio.run(gw.replay(reqs))
    assert [s.token_values for s in streams] == _batch_tokens(
        setup, _poisson(setup, "port", n=12, rate=40.0))
    assert all(s.events_log[-1].kind == "finish" for s in streams)
    assert gw.metrics.completed() == 12
    assert not gw._pump_tasks and not gw._executors
    assert not gw.router.nowait
    assert any(e.kind == "gauge" for e in gw.bus.snapshot())


def test_pump_failure_is_raised(setup):
    """A step that raises in a pump thread ends the replay with that
    error after the pumps stop."""
    reqs = _poisson(setup, "port", n=4, rate=40.0)
    gw = _gateway(setup, "port", virtual_dt=None, max_wall_s=2.0)

    def boom(t):
        raise RuntimeError("step failed")
    gw.router.drivers[1].engine.step = boom
    gw.router.drivers[0].engine.step = boom
    with pytest.raises(RuntimeError, match="step failed"):
        asyncio.run(gw.replay(reqs))
    assert not gw._pump_tasks and not gw._executors


def test_pump_threads_start_on_their_replica_card(monkeypatch):
    """Each CUDA replica's pump thread sets its own replica's device
    (``torch.cuda.set_device``, stubbed here) before its first step; a CPU
    replica's thread sets none."""
    from repro_torch.serving.gateway import server as port_server
    calls = []
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: calls.append(
        (threading.current_thread().name, torch.device(dev).index)))
    drivers = [SimpleNamespace(name=f"r{i}", engine=SimpleNamespace(
        model=SimpleNamespace(device=torch.device(dev))))
        for i, dev in enumerate(("cuda:1", "cuda:0", "cpu"))]
    executors = [port_server.pump_executor(d) for d in drivers]
    try:
        names = [ex.submit(lambda: threading.current_thread().name).result()
                 for ex in executors]
    finally:
        for ex in executors:
            ex.shutdown()
    assert [n.split("_")[0] for n in names] == ["pump-r0", "pump-r1",
                                                "pump-r2"]
    assert sorted(calls) == sorted([(names[0], 1), (names[1], 0)])


def test_launch_counters_exact_under_threads():
    """Two threads call a wrapper's CPU path (which counts nothing) and
    ``counters.advance`` many times each, with the interpreter switching
    threads as often as it can: every count lands."""
    from repro_torch.kernels.kv_quant import ops as kvq
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    x, scale = torch.randn(4, 8), torch.ones(8)
    before = counters.snapshot()
    body = kvq.DEQUANTIZE_BODIES[0]
    body_before = kvq.REPLAYED[body]
    n = 4000
    moved = {"fused_rmsnorm": 1, "paged_attention": 2, ("kv_quant", body): 1}

    def work():
        for i in range(n):
            counters.advance(moved)
            if i % 500 == 0:
                rms_ops.fused_rmsnorm(x, scale)

    try:
        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(old)
    after = counters.snapshot()
    try:
        assert after["fused_rmsnorm"] - before["fused_rmsnorm"] == 2 * n
        assert after["paged_attention"] - before["paged_attention"] == 4 * n
        assert kvq.REPLAYED[body] - body_before == 2 * n
    finally:
        counters.advance(moved, -2 * n)


def test_capture_gate_excludes_steps():
    """The capture gate: steps share it (re-entrantly), a capture runs
    alone, and a thread that holds it shared can open a capture (two such
    threads take turns instead of deadlocking)."""
    gate = CaptureGate()
    state = {"running": 0, "captures": 0}
    seen = []
    lock = threading.Lock()

    def note(kind, d_running=0, d_captures=0):
        with lock:
            state["running"] += d_running
            state["captures"] += d_captures
            seen.append((kind, state["running"], state["captures"]))

    def step_then_capture(k):
        for i in range(40):
            with gate.shared(), gate.shared():
                note("step", d_running=1)
                time.sleep(0.0002)
                if i % 10 == k:
                    note("wait", d_running=-1)
                    with gate.exclusive():
                        note("capture", d_captures=1)
                        time.sleep(0.0005)
                        note("captured", d_captures=-1)
                    note("resume", d_running=1)
                time.sleep(0.0002)
                note("done", d_running=-1)

    threads = [threading.Thread(target=step_then_capture, args=(k,))
               for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    caps = [s for s in seen if s[0] == "capture"]
    assert len(caps) == 12
    # a capture ran with no step running and no other capture open, and no
    # step ran while a capture was open
    assert all(c[1] == 0 and c[2] == 1 for c in caps)
    assert all(s[2] == 0 for s in seen if s[0] in ("step", "resume"))
    assert max(s[1] for s in seen) >= 2            # steps overlapped
    assert state == {"running": 0, "captures": 0}


def test_streaming_example_runs_on_the_cpu(capsys):
    """``examples/gateway_streaming_torch.py --device cpu``: the
    interactive request streams its 8 tokens and finishes while the batch
    trace replays; every batch stream finishes."""
    path = (pathlib.Path(__file__).resolve().parents[1] / "examples"
            / "gateway_streaming_torch.py")
    spec = importlib.util.spec_from_file_location("gateway_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    gw, vip, seen, streams = mod.main(["--device", "cpu"])
    kinds = [ev.kind for ev in seen]
    assert kinds == ["token"] * 8 + ["finish"]
    assert vip.slo_class == port_request.SLOClass.INTERACTIVE
    assert all(s.finished for s in streams) and len(streams) == 16
    out = capsys.readouterr().out
    assert "[vip] submitted" in out and "interactive: done=1" in out
