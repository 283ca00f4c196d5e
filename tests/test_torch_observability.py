"""The port's observability bus: the copied modules (bus, Prometheus text,
Chrome trace, quality analysis), the engine's emit sites against the JAX
engine's on the same trace, and the two invariants that make tracing safe
to ship: greedy tokens bit for bit traced vs untraced, and no events with
no bus attached.  Engines serve ``get_smoke_config("granite-3-8b")`` in
float32 on a virtual clock (``submit``/``step``), as in
``tests/test_torch_engine.py``."""
import dataclasses
import json
import sys
from collections import Counter, defaultdict

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.core import predictor as jax_predictor  # noqa: E402
from repro.core import request as jax_request  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import observability as jax_obs  # noqa: E402
from repro_torch.core import engine as port_engine  # noqa: E402
from repro_torch.core import predictor as port_predictor  # noqa: E402
from repro_torch.core import request as port_request  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models.model import Model, params_from_numpy  # noqa: E402
from repro_torch.serving.observability import (  # noqa: E402
    EventBus, analyze_quality, render_prometheus, to_chrome_trace,
    validate_chrome_trace)
from repro_torch.serving.observability.bus import KINDS  # noqa: E402

PORT = (port_engine, port_predictor, port_request)
JAX = (jax_engine, jax_predictor, jax_request)


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_smoke_config("granite-3-8b"),
                              param_dtype="float32")
    jmodel = JaxModel(cfg, kv_dtype="float32", remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tmodel = Model(cfg, kv_dtype="float32", device="cpu")
    return cfg, jmodel, jparams, tmodel, tparams


def _requests(req_mod, cfg, n=6, seed=0, shared=0):
    """``n`` requests at t = 0.05 i, prompts of 8 tokens after ``shared``
    tokens common to all (a system prompt the prefix cache can hit)."""
    req_mod.reset_request_counter()
    rng = np.random.default_rng(seed)
    head = rng.integers(2, cfg.vocab_size, shared).tolist()
    return [req_mod.Request(
        prompt_len=shared + 8, arrival_time=round(i * 0.05, 3),
        true_out_len=int(rng.choice([3, 8, 16])),
        prompt_tokens=head + rng.integers(2, cfg.vocab_size, 8).tolist())
        for i in range(n)]


def _serve(mods, cfg, model, params, bus=None, reqs=None, **kw):
    """Serve on a virtual clock: each request submitted at its arrival
    time, one step per 0.05 s."""
    eng_mod, pred_mod, req_mod = mods
    opts = dict(max_slots=2, max_seq_len=64, max_new_tokens=24,
                strategy="alise", quantize_offload=False)
    opts.update(kw)
    reqs = reqs or _requests(req_mod, cfg)
    eng = eng_mod.ServingEngine(model, params, eng_mod.EngineConfig(**opts),
                                predictor=pred_mod.OraclePredictor())
    if bus is not None:
        eng.attach_bus(bus, "engine0")
    pending, t = list(reqs), 0.0
    for _ in range(2000):
        while pending and pending[0].arrival_time <= t + 1e-9:
            eng.submit(pending.pop(0), t)
        if not pending and not eng.sched.live:
            break
        eng.step(t)
        t += 0.05
    assert all(r.done for r in reqs)
    return reqs, eng


def test_bus_modules_are_the_reference_copies():
    """The port's bus has the reference's vocabulary, ring bound and clock
    domains, and the exporters give the reference's output on the same
    events."""
    assert KINDS == jax_obs.bus.KINDS
    buses = (EventBus(capacity=4, clock="virtual"),
             jax_obs.EventBus(capacity=4, clock="virtual"))
    for bus in buses:
        for i in range(6):
            bus.mark(0.1 * i)
            bus.emit("decode_iter", dur=0.01, replica="engine0", batch=i)
        bus.emit("finish", t=0.7, req_id=3, replica="engine0",
                 reason="eos", generated=4)
        assert len(bus) == 4 and bus.n_dropped == 3
    port, ref = buses
    assert to_chrome_trace(port) == jax_obs.to_chrome_trace(ref)
    assert render_prometheus(port) == jax_obs.render_prometheus(ref)
    with pytest.raises(ValueError):
        EventBus(clock="gps")


def test_prometheus_rendering():
    bus = EventBus()
    bus.gauge({"hbm_utilization": 0.25, "queue_depth": 3},
              replica="engine0", t=1.0)
    bus.gauge({"hbm_utilization": 0.75}, replica="engine0", t=2.0)
    bus.emit("arrival", t=0.0, req_id=0)
    text = render_prometheus(bus)
    # the latest sample wins
    assert 'alise_hbm_utilization{replica="engine0"} 0.75' in text
    assert 'alise_queue_depth{replica="engine0"} 3.0' in text
    assert 'alise_events_total{replica="gateway",kind="arrival"} 1' in text
    assert "# TYPE alise_hbm_utilization gauge" in text


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_traced_tokens_bit_identical_with_lifecycle(setup, backend):
    """Tracing changes nothing: greedy tokens bit for bit with the bus
    attached, and the stream carries every request's lifecycle from queue
    join to finish, with self-contained finish events."""
    cfg, _, _, tmodel, tparams = setup
    kw = dict(kv_backend=backend, prefill_chunk=4)
    ref, _ = _serve(PORT, cfg, tmodel, tparams, **kw)
    bus = EventBus(clock="wall")
    reqs, eng = _serve(PORT, cfg, tmodel, tparams, bus=bus, **kw)
    assert [r.output_tokens for r in reqs] == [r.output_tokens for r in ref]
    events = bus.snapshot()
    kinds = {e.kind for e in events}
    assert {"queue_join", "predict", "prefill_chunk", "decode_iter",
            "finish"} <= kinds
    assert all(e.kind in KINDS for e in events)
    assert {e.replica for e in events} == {"engine0"}
    joined = {e.req_id for e in events if e.kind == "queue_join"}
    done = {e.req_id for e in events if e.kind == "finish"}
    assert joined == done == {r.req_id for r in reqs}
    q = analyze_quality(bus)
    assert q["estimate_error"]["len_signed_tok"]["n"] == len(reqs)
    assert q["queueing"]["ttft"]["n"] == len(reqs)
    validate_chrome_trace(to_chrome_trace(bus))


def test_engine_without_bus_emits_nothing(setup):
    """No bus attached: every emit site is skipped (no crash on any), and
    a bus built but never attached stays empty."""
    cfg, _, _, tmodel, tparams = setup
    bus = EventBus()
    _, eng = _serve(PORT, cfg, tmodel, tparams, kv_backend="paged",
                    prefill_chunk=4, prefix_cache=True, spec_decode=True,
                    reqs=_requests(port_request, cfg, shared=16))
    assert eng.bus is None and eng.sched.bus is None
    assert eng.kv.prefix.bus is None
    assert len(bus) == 0


def test_engine_gauges(setup):
    cfg, _, _, tmodel, tparams = setup
    _, eng = _serve(PORT, cfg, tmodel, tparams, kv_backend="paged")
    g = eng.gauges()
    for key in ("hbm_used_bytes", "hbm_utilization", "queue_depth",
                "live_requests", "backlog_s", "pool_free_pages"):
        assert key in g, key
    assert g["queue_depth"] == 0                 # drained
    bus = EventBus()
    bus.gauge(g, replica="engine0", t=0.0)
    assert 'alise_queue_depth{replica="engine0"} 0.0' in \
        render_prometheus(bus)


def _per_request(bus):
    """Per request: finish reason, prefill tokens summed over its
    ``prefill_chunk`` events, prefix-hit tokens."""
    out = defaultdict(lambda: {"reason": None, "prefill": 0, "hit": 0})
    for e in bus.snapshot():
        if e.kind == "finish":
            out[e.req_id]["reason"] = e.data["reason"]
        elif e.kind == "prefill_chunk":
            out[e.req_id]["prefill"] += e.data["tokens"]
        elif e.kind == "prefix_hit":
            out[e.req_id]["hit"] += e.data["tokens"]
    return dict(out)


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_events_match_jax_engine(setup, backend):
    """Against the JAX engine on the same trace (a 16-token system prompt
    shared by every request, chunked prefill, the prefix cache and spec
    decode on, two lanes): per request the same finish reason, the same
    prefill tokens over its ``prefill_chunk`` events, the same
    ``prefix_hit`` tokens, and the same tokens."""
    cfg, jmodel, jparams, tmodel, tparams = setup
    kw = dict(kv_backend=backend, prefill_chunk=8, prefix_cache=True,
              spec_decode=True, page_size=8)
    buses = (EventBus(clock="virtual"), jax_obs.EventBus(clock="virtual"))
    got = []
    for mods, model, params, bus in ((PORT, tmodel, tparams, buses[0]),
                                     (JAX, jmodel, jparams, buses[1])):
        reqs = _requests(mods[2], cfg, n=6, seed=1, shared=16)
        got.append(_serve(mods, cfg, model, params, bus=bus, reqs=reqs,
                          **kw)[0])
    assert [r.output_tokens for r in got[0]] == [r.output_tokens
                                                 for r in got[1]]
    port, ref = (_per_request(b) for b in buses)
    assert port == ref
    assert sum(v["hit"] for v in port.values()) > 0
    assert all(v["prefill"] > 0 for v in port.values())
    kinds = [Counter(e.kind for e in b.snapshot()) for b in buses]
    for kind in ("prefix_hit", "prefix_publish", "queue_join", "finish"):
        assert kinds[0][kind] == kinds[1][kind], kind


def test_spec_decode_iters_carry_drafted_and_accepted(setup):
    """A spec serve's ``decode_iter`` events carry ``drafted`` and
    ``accepted``, whose sums are the requests' own counts."""
    cfg, _, _, tmodel, tparams = setup
    bus = EventBus(clock="virtual")
    reqs, eng = _serve(PORT, cfg, tmodel, tparams, bus=bus,
                       kv_backend="paged", page_size=8, spec_decode=True,
                       max_slots=4)
    iters = [e for e in bus.snapshot() if e.kind == "decode_iter"]
    assert iters and all({"drafted", "accepted", "batch", "ctx_tokens"}
                         <= set(e.data) for e in iters)
    assert sum(e.data["drafted"] for e in iters) == \
        sum(r.spec_drafted for r in reqs) > 0
    assert sum(e.data["accepted"] for e in iters) == \
        sum(r.spec_accepted for r in reqs) > 0
    plain = EventBus(clock="virtual")
    _serve(PORT, cfg, tmodel, tparams, bus=plain, kv_backend="paged")
    assert not any("drafted" in e.data for e in plain.snapshot()
                   if e.kind == "decode_iter")


def test_preemption_events(setup):
    """Two lanes and a tight budget: every swap-out has its preempt event
    and its swap-in, on the paged backend."""
    cfg, _, _, tmodel, tparams = setup
    bus = EventBus(clock="virtual")
    reqs = _requests(port_request, cfg, n=8, seed=2)
    for i, r in enumerate(reqs):
        r.true_out_len = 24 if i < 2 else 3
    _serve(PORT, cfg, tmodel, tparams, bus=bus, reqs=reqs,
           kv_backend="paged", page_size=8, hbm_bytes=None)
    kinds = Counter(e.kind for e in bus.snapshot())
    assert kinds["preempt"] == kinds["swap_out"] == \
        sum(r.preempt_count for r in reqs) > 0
    assert kinds["swap_in"] <= kinds["swap_out"]


def test_launcher_spec_decode_trace_out(setup, tmp_path, monkeypatch,
                                        capsys):
    """``python -m repro_torch.launch.serve --device cpu --spec-decode
    --trace-out PATH`` runs to its summary and writes a Chrome trace that
    loads with ``json`` and a Prometheus ``PATH.prom``."""
    path = str(tmp_path / "trace.json")
    monkeypatch.setattr(sys, "argv", [
        "serve", "--device", "cpu", "--spec-decode", "--trace-out", path,
        "--n-requests", "4"])
    port_serve.main()
    out = capsys.readouterr().out
    assert "4/4 finished" in out and "[serve] spec decode (k=3)" in out
    assert "[trace] wrote" in out
    with open(path) as f:
        trace = json.load(f)
    validate_chrome_trace(trace)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "decode_iter" in names and "prefill_chunk" in names
    with open(path + ".prom") as f:
        prom = f.read()
    assert 'alise_events_total{replica="engine0",kind="finish"} 4' in prom
