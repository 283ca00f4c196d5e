"""The port's serving engine against the JAX engine, and the serving
invariants inside the port.

Both engines serve the same requests with the same weights (the JAX
``Model.init`` carried over by ``params_from_numpy``) on the paged backend
with chunked prefill, driven by ``submit``/``step`` on one virtual clock
(``serve()`` reads the wall clock, so the two frameworks' plans could
differ there).  Two tight lanes and staged arrivals force preemption and
swapping, as ``tests/test_paged_serving.py`` does.  The model is
``get_smoke_config("granite-3-8b")`` in float32 with a float32 KV pool, so
greedy tokens agree exactly across frameworks.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.core import predictor as jax_predictor  # noqa: E402
from repro.core import request as jax_request  # noqa: E402
from repro.core.quantization import kv_bytes_per_token  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import kv_cache as jax_kv  # noqa: E402
from repro_torch.core import engine as port_engine  # noqa: E402
from repro_torch.core import predictor as port_predictor  # noqa: E402
from repro_torch.core import request as port_request  # noqa: E402
from repro_torch.models.model import Model, params_from_numpy  # noqa: E402
from repro_torch.serving import kv_cache as port_kv  # noqa: E402

# prompts at / around the page_size=8 boundary; chunks of 5 start and end
# mid-page
PROMPTS = (7, 8, 9, 15, 16, 17)
OUTS = (24, 24, 3, 3, 3, 3)
PAGE = 8


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_smoke_config("granite-3-8b"),
                              param_dtype="float32")
    jmodel = JaxModel(cfg, kv_dtype="float32", remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return cfg, jmodel, jparams, tparams


def _port_model(cfg, chunk="masked"):
    return Model(cfg, kv_dtype="float32", chunk_attn_impl=chunk, device="cpu")


def _requests(req_mod, cfg, prompts=PROMPTS, outs=OUTS):
    req_mod.reset_request_counter()
    rng = np.random.default_rng(3)
    return [req_mod.Request(prompt_len=p, arrival_time=0.0, true_out_len=o,
                            prompt_tokens=rng.integers(2, cfg.vocab_size,
                                                       p).tolist())
            for p, o in zip(prompts, outs)]


def _staged(eng_mod, pred_mod, req_mod, cfg, model, params, *, quant,
            tight=True, **kw):
    """Serve on a virtual clock: two requests first, the rest 0.5 s later.
    ``tight`` gives two lanes and a KV budget of two short sequences."""
    bpt = kv_bytes_per_token(cfg.num_layers, cfg.num_kv_heads, cfg.hd)
    opts = dict(max_slots=2, max_seq_len=64, max_new_tokens=48,
                strategy="alise", quantize_offload=quant,
                hbm_bytes=2 * 40 * bpt, kv_backend="paged", page_size=PAGE,
                prefill_chunk=5, iter_token_budget=16,
                eos_token=-1)       # no early stop: every trace runs out
    if not tight:
        opts.update(max_slots=8, hbm_bytes=None)
    opts.update(kw)
    reqs = _requests(req_mod, cfg)
    eng = eng_mod.ServingEngine(model, params, eng_mod.EngineConfig(**opts),
                                predictor=pred_mod.OraclePredictor())
    t = 0.0
    for r in reqs[:2]:
        eng.submit(r, t)
    for _ in range(5):
        eng.step(t)
        t += 0.1
    for r in reqs[2:]:
        eng.submit(r, t)
    for _ in range(1000):
        if not eng.sched.live:
            break
        eng.step(t)
        t += 0.1
    assert not eng.sched.live, "engine did not drain"
    assert all(r.done for r in reqs)
    return reqs, eng


def _port_run(cfg, tparams, *, quant=False, impl="gather", chunk="masked",
              **kw):
    return _staged(port_engine, port_predictor, port_request, cfg,
                   _port_model(cfg, chunk), tparams, quant=quant,
                   paged_attn_impl=impl, **kw)


def _tokens(reqs):
    return {r.req_id: list(r.output_tokens) for r in reqs}


@pytest.fixture(scope="module")
def jax_run(setup):
    cfg, jmodel, jparams, _ = setup
    reqs, _ = _staged(jax_engine, jax_predictor, jax_request, cfg, jmodel,
                      jparams, quant=False)
    return reqs


# -------------------------------------------------------- across frameworks

def test_greedy_tokens_match_jax_engine_under_preemption(setup, jax_run):
    """Acceptance: the port's engine emits the JAX engine's greedy tokens
    on the same requests, plans and preemptions (quantization off)."""
    cfg, _, _, tparams = setup
    reqs, eng = _port_run(cfg, tparams)
    assert _tokens(reqs) == _tokens(jax_run)
    assert [r.preempt_count for r in reqs] == [r.preempt_count
                                               for r in jax_run]
    assert sum(r.preempt_count for r in reqs) > 0
    assert [len(r.output_tokens) for r in reqs] == list(OUTS)
    assert not eng.host_pool and not eng.kv.pool.page_table


def test_offload_blob_matches_jax(setup):
    """One INT8 offload blob, from the same prefill on each backend: codes
    within 1, scales and zeros close (the JAX blob carries its pages
    padded to a power of two; the port's holds exactly the request's)."""
    cfg, jmodel, jparams, tparams = setup
    tokens = np.random.default_rng(4).integers(2, cfg.vocab_size, 21).tolist()
    bcfg = dict(max_slots=2, max_seq_len=64, page_size=PAGE,
                quantize_offload=True)
    jb = jax_kv.PagedKVBackend(jmodel, jax_kv.KVBackendConfig(**bcfg), 16)
    tb = port_kv.PagedKVBackend(_port_model(cfg),
                                port_kv.KVBackendConfig(**bcfg), 16)
    for be, params in ((jb, jparams), (tb, tparams)):
        be.prefill_chunk(params, 5, tokens[:13], 0)
        be.prefill_chunk(params, 5, tokens[13:], 13)
    jblob, tblob = jb.offload(5), tb.offload(5)
    assert jblob["lengths"] == tblob["lengths"] == 21
    n_pages = 3
    for key in ("k", "v"):
        (jkind, (jq, jlam, jz, jshape)), (tkind, (tq, tlam, tz, tshape)) = \
            jblob[key], tblob[key]
        assert jkind == tkind == "q8"
        assert tshape == (cfg.num_layers, n_pages, PAGE, cfg.num_kv_heads,
                          cfg.hd)
        assert tq.dtype == torch.int8 and not tq.is_cuda

        def pages(a, shape):
            return np.asarray(a).reshape(shape[:-1] + (-1,))[:, :n_pages]
        dq = np.abs(pages(tq.numpy(), tshape).astype(np.int32)
                    - pages(jq, jshape).astype(np.int32))
        assert dq.max() <= 1
        np.testing.assert_allclose(pages(tlam.numpy(), tshape),
                                   pages(jlam, jshape), rtol=1e-4, atol=1e-7)
        assert np.abs(pages(tz.numpy(), tshape) - pages(jz, jshape)).max() <= 1
        # rows past the request's length were zeroed before quantizing
        assert np.all(pages(tlam.numpy(), tshape)[:, 2, 5:] == 1e-8)
    assert not tb.pool.page_table and tb.slot_of(5) is None


# ------------------------------------------------------ inside the port

def test_page_pool_matches_jax_allocator():
    """The port's PagedKVPool hands out, extends and frees pages exactly as
    the JAX pool does, and builds the same padded block tables."""
    cfgs = dict(num_pages=10, page_size=4, num_kv_heads=2, head_dim=8,
                num_layers=2)
    jp = jax_kv.PagedKVPool(jax_kv.PagedKVConfig(**cfgs))
    tp = port_kv.PagedKVPool(port_kv.PagedKVConfig(**cfgs), device="cpu")
    assert tuple(tp.k.shape) == (2, 10, 4, 2, 8) and tp.k.dtype == torch.float32
    for pool in (jp, tp):
        assert pool.reserve_scratch() == 9
        pool.allocate(1, 5)
        pool.allocate(2, 0)
        pool.extend_to(2, 9)
        pool.extend(1, 3)           # 8 tokens: still two pages
        pool.extend(1, 1)           # 9 tokens: a third
        pool.free(2)
        pool.allocate(3, 6)
    assert tp.page_table == jp.page_table and tp.lengths == jp.lengths
    assert tp.free_pages == jp.free_pages and tp.refs == jp.refs
    tables, lens = tp.block_table_array([1, 3])
    jt, jl = jp.block_table_array([1, 3])
    np.testing.assert_array_equal(tables.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jl))
    assert tables.dtype == lens.dtype == torch.int32
    with pytest.raises(RuntimeError, match="exhausted"):
        tp.allocate(4, 4 * 10)


def test_int8_swap_round_trip_serves_every_request(setup, jax_run):
    """With INT8 offload the swapped requests come back through the
    kv_quant path (plain versions on the CPU) and every request still
    finishes with its trace length; tokens before the first swap match."""
    cfg, _, _, tparams = setup
    reqs, eng = _port_run(cfg, tparams, quant=True)
    assert sum(r.preempt_count for r in reqs) > 0
    assert [len(r.output_tokens) for r in reqs] == list(OUTS)
    for r, j in zip(reqs, jax_run):
        assert r.output_tokens[:1] == j.output_tokens[:1]


@pytest.mark.parametrize("impl,chunk", [("kernel", "masked"),
                                        ("gather", "flash"),
                                        ("kernel", "flash")])
def test_attention_paths_agree_on_greedy_tokens(setup, impl, chunk):
    cfg, _, _, tparams = setup
    ref, _ = _port_run(cfg, tparams)
    out, _ = _port_run(cfg, tparams, impl=impl, chunk=chunk)
    assert _tokens(out) == _tokens(ref)


def test_preempted_equals_unpreempted(setup):
    cfg, _, _, tparams = setup
    tight, _ = _port_run(cfg, tparams)
    roomy, _ = _port_run(cfg, tparams, tight=False)
    assert sum(r.preempt_count for r in roomy) == 0
    assert _tokens(tight) == _tokens(roomy)


def test_chunked_equals_whole_prompt(setup):
    cfg, _, _, tparams = setup
    chunked, _ = _port_run(cfg, tparams, tight=False)
    whole, _ = _port_run(cfg, tparams, tight=False, prefill_chunk=None,
                         iter_token_budget=None)
    assert _tokens(chunked) == _tokens(whole)


def test_temperature_serving_is_seed_deterministic(setup):
    cfg, _, _, tparams = setup
    runs = [_tokens(_port_run(cfg, tparams, greedy=False, temperature=0.9,
                              top_k=20, seed=s)[0]) for s in (1, 1, 2)]
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]


def test_serve_warmup_events_and_latency_fit(setup):
    """``serve()`` on the wall clock, with warmup and streaming events."""
    cfg, _, _, tparams = setup
    eng = port_engine.ServingEngine(
        _port_model(cfg), tparams, port_engine.EngineConfig(
            max_slots=4, max_seq_len=64, max_new_tokens=16, page_size=PAGE,
            prefill_chunk=8, warmup_compile=True, eos_token=-1),
        predictor=port_predictor.OraclePredictor())
    assert set(eng.latency.bucket_costs) == {8}
    eng.stream_events = True
    reqs = _requests(port_request, cfg, outs=(5,) * len(PROMPTS))
    events = []
    for r in reqs:
        eng.submit(r)
    while eng.sched.live:
        eng.step(0.0)
        events += eng.poll_events()
    assert sum(e.kind == "token" for e in events) == 5 * len(reqs)
    assert sum(e.kind == "finish" for e in events) == len(reqs)
    assert eng.fit_latency_model() is not None
    eng.serve(_requests(port_request, cfg, outs=(4,) * len(PROMPTS)))
    assert not eng.sched.live and eng.device == "cpu"


def test_cancel_and_drain_free_everything(setup):
    cfg, _, _, tparams = setup
    eng = port_engine.ServingEngine(
        _port_model(cfg), tparams, port_engine.EngineConfig(
            max_slots=4, max_seq_len=64, page_size=PAGE, prefill_chunk=4),
        predictor=port_predictor.OraclePredictor())
    eng.stream_events = True
    reqs = _requests(port_request, cfg)
    for r in reqs:
        eng.submit(r)
    for _ in range(3):
        eng.step(0.0)
    assert eng.cancel(reqs[0].req_id, 1.0)
    assert reqs[0].state == port_request.RequestState.CANCELLED
    assert any(e.kind == "cancel" for e in eng.poll_events())
    drained = eng.drain()
    assert len(drained) == len(reqs) - 1 and not eng.sched.live
    assert not eng.kv.pool.page_table
    assert len(eng.kv.pool.free_pages) == eng.kv.pool.cfg.num_pages - 1


@pytest.mark.parametrize("opt", [dict(kv_backend="dense"),
                                 dict(prefix_cache=True),
                                 dict(spec_decode=True),
                                 dict(prefill_pack=True)])
def test_options_not_ported_raise(setup, opt):
    cfg, _, _, tparams = setup
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port_engine.ServingEngine(_port_model(cfg), tparams,
                                  port_engine.EngineConfig(**opt))


def test_serve_launcher_on_cpu():
    from repro_torch.launch.serve import serve
    reqs, eng = serve(arch_size="smoke", n_requests=4, max_slots=2,
                      prefill_chunk=8, device="cpu", verbose=False)
    assert all(r.done and r.generated >= 1 for r in reqs)
    assert eng.cfg.paged_attn_impl == "gather" and eng.kv_backend == "paged"
    assert eng.model.chunk_attn_impl == "masked"


# --------------------------------------------------------------- imports

def test_port_imports_neither_jax_nor_the_jax_package():
    """In a fresh interpreter (this test process has JAX loaded): import
    the port's package, engine, model, Mamba-2 block, kernels, configs,
    sampler, kv_cache, training modules, gradient compression and both
    launchers, then check that no ``jax*`` or
    ``repro.*`` module was loaded."""
    code = (
        "import sys\n"
        "import repro_torch\n"
        "import repro_torch.core.engine, repro_torch.models.model\n"
        "import repro_torch.models.mamba2, repro_torch.configs.mamba2_2p7b\n"
        "import repro_torch.kernels.ssd_scan\n"
        "import repro_torch.kernels.fused_rmsnorm\n"
        "import repro_torch.serving.sampler, repro_torch.serving.kv_cache\n"
        "import repro_torch.launch.serve, repro_torch.launch.train\n"
        "import repro_torch.training.optimizer, repro_torch.training.data\n"
        "import repro_torch.training.train_step\n"
        "import repro_torch.training.checkpoint\n"
        "import repro_torch.distributed.collectives\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
