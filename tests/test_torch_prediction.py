"""The port's online length predictor, its auto token budget and the
launcher's new flags, against the JAX package.

``repro_torch.serving.prediction`` is a copy of the reference's numpy
code, so the port's ``OnlineQuantilePredictor`` must give the reference's
predictions exactly over one feedback stream (completed and censored
updates, SLO classes, prefix-hit watermarks).  ``autotune_token_budget``
must pick the reference engine's budget from the same profiling rings.
Inside the port, the learned predictor only reorders work: greedy tokens
equal the oracle predictor's bit for bit on both KV backends, as the
reference's ``tests/test_online_predictor.py`` holds for the JAX engine.
"""
import dataclasses
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.core import request as jax_request  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import prediction as jax_prediction  # noqa: E402
from repro_torch.core import engine as port_engine  # noqa: E402
from repro_torch.core import predictor as port_predictor  # noqa: E402
from repro_torch.core import request as port_request  # noqa: E402
from repro_torch.models.model import Model, params_from_numpy  # noqa: E402
from repro_torch.serving import prediction as port_prediction  # noqa: E402


def _stream(n=200, seed=0):
    """``n`` requests: prompt tokens (some length-only), SLO class,
    prefix-hit watermark, true output length, and whether this update is
    censored (an in-flight observation of part of the output)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(4, 200))
        toks = (None if i % 11 == 5
                else rng.integers(2, 5000, plen).tolist())
        out.append(dict(
            toks=toks, plen=plen, true=int(rng.integers(1, 600)),
            hit=int(rng.integers(0, plen)) if i % 3 == 0 else 0,
            interactive=i % 4 == 1, censored=i % 5 == 2))
    return out


def _observe(pred, req_mod, item):
    """Predict for one request of the stream, then feed back its outcome
    (the whole output, or a censored part of it) and drain the queue.
    Returns the prediction's (p50, p90)."""
    req = req_mod.Request(
        prompt_len=item["plen"], arrival_time=0.0,
        true_out_len=item["true"], prompt_tokens=item["toks"],
        slo_class=(req_mod.SLOClass.INTERACTIVE if item["interactive"]
                   else req_mod.SLOClass.BATCH))
    req.cached_prefix_hint = item["hit"]
    p = pred.predict_for(req)
    done = not item["censored"]
    req.generated = item["true"] if done else max(item["true"] // 3, 1)
    pred.observe(req, done=done)
    pred.drain_feedback()
    return p.length, p.p90


def test_online_predictor_equals_the_reference():
    """200 updates (40 censored) through both predictors: every
    prediction equal, and the learned heads, conformal adjustments and
    residual rings equal, exactly."""
    port = port_prediction.OnlineQuantilePredictor(seed=0)
    ref = jax_prediction.OnlineQuantilePredictor(seed=0)
    stream = _stream()
    got = [_observe(port, port_request, it) for it in stream]
    want = [_observe(ref, jax_request, it) for it in stream]
    assert got == want
    assert port.stats == ref.stats and port.stats["censored"] == 40
    np.testing.assert_array_equal(port.heads.w, ref.heads.w)
    np.testing.assert_array_equal(port.heads.b, ref.heads.b)
    assert port._adj == ref._adj
    assert {k: list(v) for k, v in port._resid.items()} \
        == {k: list(v) for k, v in ref._resid.items()}
    for q in (0.5, 0.9):
        assert port.pinball(q) == ref.pinball(q)
    # a fresh prompt after the stream
    toks = np.random.default_rng(9).integers(2, 5000, 40).tolist()
    assert port.predict(toks).length == ref.predict(toks).length


def test_online_predictor_pretrain_equals_the_reference():
    rng = np.random.default_rng(1)
    toks = [rng.integers(2, 5000, int(rng.integers(4, 80))).tolist()
            for _ in range(64)]
    lens = rng.integers(1, 400, 64).astype(np.float32)
    port = port_prediction.OnlineQuantilePredictor(seed=3)
    ref = jax_prediction.OnlineQuantilePredictor(seed=3)
    port.pretrain(toks, lens)
    ref.pretrain(toks, lens)
    np.testing.assert_array_equal(port.heads.w, ref.heads.w)
    probe = rng.integers(2, 5000, 30).tolist()
    assert port.predict(probe).p90 == ref.predict(probe).p90


# ------------------------------------------------------------ the engine

@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_smoke_config("granite-3-8b"),
                              param_dtype="float32")
    jmodel = JaxModel(cfg, kv_dtype="float32", remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    model = Model(cfg, kv_dtype="float32", device="cpu")
    return cfg, jmodel, jparams, model, tparams


@pytest.mark.parametrize("target", [0.05, 0.004])
def test_autotune_token_budget_equals_the_reference(setup, target):
    """The same profiling rings give the same fit and the same budget in
    both engines, and the budget lands in the scheduler."""
    cfg, jmodel, jparams, model, tparams = setup
    kw = dict(max_slots=4, max_seq_len=64, max_new_tokens=8,
              strategy="alise", quantize_offload=False, prefill_chunk=4)
    port = port_engine.ServingEngine(model, tparams,
                                     port_engine.EngineConfig(**kw))
    ref = jax_engine.ServingEngine(jmodel, jparams,
                                   jax_engine.EngineConfig(**kw))
    rng = np.random.default_rng(2)
    for t in range(40):
        b = int(rng.integers(1, 5))
        ctx = int(rng.integers(8, 60)) * b
        dt = 0.004 + 2e-5 * ctx / b + float(rng.random()) * 1e-3
        for eng in (port, ref):
            eng.iter_times.append((float(t), ctx, b, dt))
    for n in (4, 8, 16, 3, 12):
        # the port's entries carry a fourth field, the rows (1: a chunk)
        port.prefill_times.append((0.0, n, 1e-3 + 2e-4 * n, 1))
        ref.prefill_times.append((0.0, n, 1e-3 + 2e-4 * n))
    got = port.autotune_token_budget(target)
    assert got == ref.autotune_token_budget(target)
    assert got is not None and got >= 5
    assert port.sched.cfg.iter_token_budget == got


def _requests(cfg, seed=0):
    rng = np.random.default_rng(seed)
    port_request.reset_request_counter()
    reqs = []
    for out in (40, 3, 16, 3, 24, 3):
        plen = int(rng.integers(6, 12))
        reqs.append(port_request.Request(
            prompt_len=plen, arrival_time=0.0, true_out_len=out,
            prompt_tokens=rng.integers(2, cfg.vocab_size, plen).tolist()))
    return reqs


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_learned_predictor_on_off_same_tokens(setup, backend):
    """The learned predictor (pretrained, so that it reorders work) gives
    the oracle's greedy tokens bit for bit; its gauges reach the
    engine's."""
    cfg, _, _, model, tparams = setup

    def serve(pred):
        reqs = _requests(cfg)
        eng = port_engine.ServingEngine(model, tparams, port_engine.
                                        EngineConfig(
            max_slots=2, max_seq_len=64, max_new_tokens=48,
            strategy="alise", quantize_offload=False, kv_backend=backend,
            page_size=8), predictor=pred)
        eng.serve(reqs)
        return [list(r.output_tokens) for r in reqs], eng

    rng = np.random.default_rng(4)
    learned = port_prediction.OnlineQuantilePredictor(seed=0)
    learned.pretrain([rng.integers(2, cfg.vocab_size, 10).tolist()
                      for _ in range(48)], rng.integers(1, 60, 48))
    got, eng = serve(learned)
    want, _ = serve(port_predictor.OraclePredictor())
    assert got == want
    g = eng.gauges()
    assert g["predictor_updates"] >= 48 + len(got)
    assert g["queue_depth"] == 0 and g["device_index"] == -1.0
    assert eng.predicted_backlog() == 0.0


def test_serve_launcher_new_flags_on_cpu(monkeypatch, capsys):
    """``main()`` takes the online predictor, the auto budget with its
    target TPOT, a bucket menu, packing, its width and the prefix cache,
    and serves on the CPU."""
    from repro_torch.launch import serve as launcher
    monkeypatch.setattr(sys, "argv", [
        "serve", "--device", "cpu", "--n-requests", "4", "--max-slots", "2",
        "--kv-backend", "paged", "--prefill-chunk", "8",
        "--predictor", "online", "--iter-token-budget", "auto",
        "--target-tpot", "0.03", "--prefill-buckets", "8,4",
        "--prefill-pack", "--prefill-pack-width", "2", "--prefix-cache",
        "--warmup"])
    launcher.main()
    out = capsys.readouterr().out
    assert "auto-tuned iter_token_budget=" in out
    assert "4/4 finished" in out and "prefix cache:" in out


def test_serve_function_takes_requests_and_an_int_budget():
    from repro_torch.launch.serve import build_model, serve
    model, params = build_model(arch_size="smoke", device="cpu")
    reqs = _requests(model.cfg)
    got, eng = serve(arch_size="smoke", max_slots=2, device="cpu",
                     model_and_params=(model, params), requests=reqs,
                     kv_backend="dense", prefill_chunk=8,
                     iter_token_budget=12, prefill_pack=True,
                     prefix_cache=True, predictor_kind="online",
                     verbose=False)
    assert got is reqs and all(r.done for r in reqs)
    assert eng.sched.cfg.iter_token_budget == 12
    assert eng._pack_ok and eng.kv.prefix is not None
    assert isinstance(eng.predictor,
                      port_prediction.OnlineQuantilePredictor)
