"""The attention family on the port's dense KV backend against the JAX
package, the INT8 paged attention kernel's plain version against the Pallas
kernel, and the serving invariants of the dense backend inside the port.

Inputs are made with numpy from a seed and handed to both packages; the
weights come from the JAX ``Model.init`` and cross into torch through
numpy.  The model is ``get_smoke_config("granite-3-8b")`` (2 layers,
d_model 64, 8/2 heads of 8) in float32 with a float32 KV cache.
Tolerances: the INT8 paged attention 2e-5 in float32 and 5e-2 in bfloat16
(``tests/test_kernels.py``'s), its distance from float attention on the
unquantized pages < 0.05 (``tests/test_kernels.py:122``'s quality bound),
float32 logits and caches 1e-4 (XLA and torch sum in different orders),
INT8 offload codes within 1.  Inside the port the invariants hold on
greedy tokens, exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.core import predictor as jax_predictor  # noqa: E402
from repro.core import request as jax_request  # noqa: E402
from repro.core.quantization import kv_bytes_per_token  # noqa: E402
from repro.kernels.kv_quant import paged_attention_q8_op  # noqa: E402
from repro.kernels.kv_quant import \
    paged_attention_q8_ref as jax_q8_ref  # noqa: E402
from repro.kernels.paged_attention import \
    paged_attention_ref as jax_paged_ref  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import kv_cache as jax_kv  # noqa: E402
from repro_torch.core import engine as port_engine  # noqa: E402
from repro_torch.core import predictor as port_predictor  # noqa: E402
from repro_torch.core import request as port_request  # noqa: E402
from repro_torch.kernels.kv_quant import (kv_quantize_ref,  # noqa: E402
                                          paged_attention_q8,
                                          paged_attention_q8_ref)
from repro_torch.models.model import Model, params_from_numpy  # noqa: E402
from repro_torch.serving import kv_cache as port_kv  # noqa: E402

ATOL = 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))         # own, writable copy


# ------------------------------------------------- INT8 paged attention

def _q8_inputs(B, H, KVH, d, page, npg, maxp, seed, full=False):
    """float32 q, k, v and their INT8 codes (kv_quantize_ref's), random
    tables (entries past a row's length included) and lengths >= 1."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    k = rng.standard_normal((npg, page, KVH, d)).astype(np.float32)
    v = rng.standard_normal((npg, page, KVH, d)).astype(np.float32)
    tables = rng.integers(0, npg, (B, maxp)).astype(np.int32)
    lengths = (np.full((B,), maxp * page) if full else
               rng.integers(1, maxp * page + 1, (B,))).astype(np.int32)
    codes = [tuple(t.numpy() for t in kv_quantize_ref(torch.from_numpy(x)))
             for x in (k, v)]
    return q, k, v, codes, tables, lengths


def _q8_args(q, codes, tables, lengths, dtype=torch.float32):
    (kq, kl, kz), (vq, vl, vz) = codes
    return (torch.from_numpy(q).to(dtype), *map(_t, (kq, kl, kz, vq, vl, vz,
                                                     tables, lengths)))


# the shapes of tests/test_kernels.py::test_paged_q8_matches_oracle and
# ::test_paged_q8_close_to_fp_attention, and granite's group of 4 query
# heads per KV head with heads of 128 on pages of 16
@pytest.mark.parametrize("B,H,KVH,d,page,npg,maxp", [
    (2, 8, 2, 64, 16, 32, 4), (2, 4, 2, 64, 16, 32, 4),
    (2, 16, 4, 128, 16, 24, 6),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_q8_matches_pallas(B, H, KVH, d, page, npg, maxp,
                                           dtype):
    q, _, _, codes, tables, lengths = _q8_inputs(B, H, KVH, d, page, npg,
                                                 maxp, seed=B * 100 + H + d)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "float32"
                else (torch.bfloat16, jnp.bfloat16))
    n0 = paged_attention_q8.launches
    out = paged_attention_q8(*_q8_args(q, codes, tables, lengths, tdt))
    assert paged_attention_q8.launches == n0      # CPU: the plain version
    assert out.dtype == tdt and tuple(out.shape) == (B, H, d)
    jargs = (jnp.asarray(q, jdt), *map(jnp.asarray, (*codes[0], *codes[1],
                                                     tables, lengths)))
    pallas = paged_attention_q8_op(*jargs, interpret=True)
    tol = 2e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_np(out), _np(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(out), _np(jax_q8_ref(*jargs)), atol=tol,
                               rtol=tol)


def test_paged_attention_q8_close_to_float_attention():
    """INT8 pages stay near float attention on the unquantized pages (the
    quality bound of tests/test_kernels.py:122)."""
    q, k, v, codes, tables, lengths = _q8_inputs(2, 4, 2, 64, 16, 32, 4,
                                                 seed=7, full=True)
    out = paged_attention_q8(*_q8_args(q, codes, tables, lengths))
    fp = jax_paged_ref(*map(jnp.asarray, (q, k, v, tables, lengths)))
    assert np.abs(_np(out) - _np(fp)).max() < 0.05


def test_paged_attention_q8_ignores_pages_past_the_length():
    """Table entries past a row's length may name any page: the output
    does not depend on them, nor on the rows past the length."""
    q, _, _, codes, tables, lengths = _q8_inputs(2, 8, 2, 64, 16, 32, 4,
                                                 seed=8)
    lengths[:] = (21, 16)                 # page 1 ragged, page 1 unused
    ref = paged_attention_q8_ref(*_q8_args(q, codes, tables, lengths))
    tables2 = tables.copy()
    tables2[0, 2:] = (tables[0, 2:] + 5) % 32
    tables2[1, 1:] = (tables[1, 1:] + 3) % 32
    codes2 = [tuple(a.copy() for a in c) for c in codes]
    codes2[0][0][tables[0, 1], 5:] = 127  # row 0: tokens 21.. of page 1
    out = paged_attention_q8(*_q8_args(q, codes2, tables2, lengths))
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


# --------------------------------------------------------------- model

def _cfg():
    return dataclasses.replace(get_smoke_config("granite-3-8b"),
                               param_dtype="float32")


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    jmodel = JaxModel(cfg, kv_dtype="float32", attn_chunk=8, remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return cfg, jmodel, jparams, tparams


def _port_model(cfg, chunk="masked"):
    return Model(cfg, kv_dtype="float32", attn_chunk=8,
                 chunk_attn_impl=chunk, device="cpu")


def test_init_cache_shapes_match_jax(setup):
    cfg, jmodel, _, _ = setup
    ref = jmodel.cache_shapes(3, 24)
    cache = _port_model(cfg).init_cache(3, 24)
    assert set(cache) == set(ref) == {"lengths", "k", "v"}
    for key, t in cache.items():
        assert tuple(t.shape) == ref[key].shape
        assert str(t.dtype).split(".")[1] == str(ref[key].dtype)


@pytest.fixture(scope="module")
def prefilled(setup):
    """Two prompts of 11 and 16 tokens right-padded to 16, through both
    models' monolithic prefill with ``last_index``."""
    cfg, jmodel, jparams, tparams = setup
    rng = np.random.default_rng(1)
    toks = rng.integers(2, cfg.vocab_size, (2, 16)).astype(np.int32)
    toks[0, 11:] = 0
    last = np.array([10, 15], np.int32)
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks),
                                          "last_index": jnp.asarray(last)})
    tl, tcache = _port_model(cfg).prefill(
        tparams, {"tokens": _t(toks).long(), "last_index": _t(last)})
    return toks, (jl, jcache), (tl, tcache)


def test_prefill_logits_and_cache_match_jax(prefilled):
    _, (jl, jcache), (tl, tcache) = prefilled
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert tcache["lengths"].tolist() == [16, 16]
    for k in ("k", "v"):
        assert tuple(tcache[k].shape) == jcache[k].shape
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                   atol=ATOL)


def _dense_caches(prefilled, Smax=24):
    """The prefill's caches padded to ``Smax`` positions, lengths (11, 16)
    (lane 0's padded rows past 11 hold stale values, as a reused lane's
    stripe does)."""
    _, (_, jcache), (_, tcache) = prefilled
    lengths = np.array([11, 16], np.int32)
    j, t = {"lengths": jnp.asarray(lengths)}, {"lengths": _t(lengths)}
    for k in ("k", "v"):
        a = np.asarray(jcache[k])
        pad = np.zeros(a.shape[:2] + (Smax,) + a.shape[3:], np.float32)
        pad[:, :, :a.shape[2]] = a
        j[k] = jnp.asarray(pad)
        b = np.zeros_like(pad)
        b[:, :, :a.shape[2]] = tcache[k].numpy()
        t[k] = _t(b)
    return j, t


def test_decode_steps_match_jax(setup, prefilled):
    """Four dense decode steps from the prefill's cache: logits, the K/V
    written at ``lengths`` and the lengths agree with JAX."""
    cfg, jmodel, jparams, tparams = setup
    jc, tc = _dense_caches(prefilled)
    model = _port_model(cfg)
    feed = np.random.default_rng(2).integers(2, cfg.vocab_size, (4, 2, 1))
    for tok in feed.astype(np.int32):
        jl, jc = jmodel.decode_step(jparams, jc, jnp.asarray(tok))
        tl = model.decode_step(tparams, tc, _t(tok).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert tc["lengths"].tolist() == np.asarray(jc["lengths"]).tolist()
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   atol=ATOL)


def test_decode_step_sampled_matches_jax(setup, prefilled):
    """Greedy tokens and termination reasons of the fused step equal JAX's;
    the inactive lane keeps its stripe and length."""
    cfg, jmodel, jparams, tparams = setup
    jc, tc = _dense_caches(prefilled)
    stripe = tc["k"][:, 1].clone()
    tokens = np.array([[17], [300]], np.int32)
    active = np.array([True, False])
    new_gen = np.array([4, 1], np.int32)
    new_ctx = np.array([12, 17], np.int32)
    true_len = np.array([4, 1 << 30], np.int32)
    rids = np.array([3, 8], np.int32)
    jtok, jreason, _ = jmodel.decode_step_sampled(
        jparams, jc, *map(jnp.asarray, (tokens, active, new_gen, new_ctx,
                                        true_len, rids)),
        jax.random.PRNGKey(0), max_new_tokens=48, max_seq_len=24)
    ttok, treason = _port_model(cfg).decode_step_sampled(
        tparams, tc, _t(tokens).long(), *map(_t, (active, new_gen, new_ctx,
                                                  true_len, rids)),
        max_new_tokens=48, max_seq_len=24)
    assert ttok[0].item() == int(jtok[0])
    np.testing.assert_array_equal(treason.numpy(), np.asarray(jreason))
    assert treason.tolist()[1] == 0
    assert tc["lengths"].tolist() == [12, 16]
    assert torch.equal(tc["k"][:, 1], stripe)


@pytest.mark.parametrize("impl", ["masked", "flash"])
def test_prefill_chunk_matches_jax(setup, impl):
    """Two chunks of one lane's stripe: 11 tokens, then 9 starting at 11,
    each padded to a 16-row bucket; logits and stripes agree with JAX
    after each chunk (the padded rows are written in both)."""
    cfg, _, jparams, tparams = setup
    jm = JaxModel(cfg, kv_dtype="float32", remat=False, chunk_attn_impl=impl)
    tm = _port_model(cfg, impl)
    rng = np.random.default_rng(3)
    shape = (cfg.num_layers, 32, cfg.num_kv_heads, cfg.hd)
    stale = {k: rng.standard_normal(shape).astype(np.float32)
             for k in ("k", "v")}
    jk, jv = jnp.asarray(stale["k"]), jnp.asarray(stale["v"])
    tk, tv = _t(stale["k"]), _t(stale["v"])
    for start, n in ((0, 11), (11, 9)):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :n] = rng.integers(2, cfg.vocab_size, n)
        jl, jk, jv = jm.prefill_chunk(jparams, jk, jv, jnp.asarray(toks),
                                      jnp.asarray(start, jnp.int32),
                                      jnp.asarray(n, jnp.int32))
        tl = tm.prefill_chunk(tparams, tk, tv, _t(toks).long(), start, n)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


# -------------------------------------------------------------- engine

def _requests(req_mod, cfg, outs=(40, 40, 3, 3, 3, 3), prompts=None,
              seed=0):
    """tests/test_engine.py's requests (prompts of 6-11 tokens), or
    ``prompts`` lengths with tests/test_paged_serving.py's seed."""
    req_mod.reset_request_counter()
    rng = np.random.default_rng(seed if prompts is None else 3)
    reqs = []
    for i, out in enumerate(outs):
        plen = int(rng.integers(6, 12)) if prompts is None else prompts[i]
        reqs.append(req_mod.Request(
            prompt_len=plen, arrival_time=0.0, true_out_len=out,
            prompt_tokens=rng.integers(2, cfg.vocab_size, plen).tolist()))
    return reqs


def _staged(eng_mod, pred_mod, req_mod, cfg, model, params, tight=True,
            **kw):
    """tests/test_engine.py:69's scenario on a virtual clock: two requests
    run 5 steps, then four more arrive; ``tight`` gives 2 lanes and a KV
    budget of 110 tokens, else 8 lanes and room for all."""
    bpt = kv_bytes_per_token(cfg.num_layers, cfg.num_kv_heads, cfg.hd)
    opts = dict(max_slots=2, max_seq_len=64, max_new_tokens=48,
                strategy="alise", quantize_offload=False,
                hbm_bytes=2 * 55 * bpt, kv_backend="dense")
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
    for _ in range(800):
        if not eng.sched.live:
            break
        eng.step(t)
        t += 0.1
    assert not eng.sched.live, "engine did not drain"
    assert all(r.done for r in reqs)
    return reqs, eng


def _port_staged(cfg, tparams, chunk="masked", **kw):
    return _staged(port_engine, port_predictor, port_request, cfg,
                   _port_model(cfg, chunk), tparams, **kw)


def _tokens(reqs):
    return {r.req_id: list(r.output_tokens) for r in reqs}


@pytest.fixture(scope="module")
def port_swap(setup):
    cfg, _, _, tparams = setup
    return _port_staged(cfg, tparams)


def test_greedy_tokens_match_jax_engine_under_swap(setup, port_swap):
    """The port's dense engine emits the JAX engine's greedy tokens, with
    the same preemptions, under forced swaps (quantization off)."""
    cfg, jmodel, jparams, _ = setup
    jreqs, _ = _staged(jax_engine, jax_predictor, jax_request, cfg, jmodel,
                       jparams)
    reqs, eng = port_swap
    assert _tokens(reqs) == _tokens(jreqs)
    assert [r.preempt_count for r in reqs] == [r.preempt_count
                                               for r in jreqs]
    assert sum(r.preempt_count for r in reqs) > 0
    assert not eng.host_pool and all(s is None for s in eng.kv.slot_req)


def test_offload_codes_match_jax(setup):
    """One INT8 offload blob of a lane prefilled in two chunks (13 + 8
    tokens) on each dense backend: the same pow2 span of 32 positions,
    codes within 1, scales and zeros close, pad rows zeroed; the upload
    restores the lane within the quantization step."""
    cfg, jmodel, jparams, tparams = setup
    tokens = np.random.default_rng(4).integers(2, cfg.vocab_size, 21).tolist()
    bcfg = dict(max_slots=2, max_seq_len=64, quantize_offload=True)
    jb = jax_kv.DenseKVBackend(jmodel, jax_kv.KVBackendConfig(**bcfg))
    tb = port_kv.DenseKVBackend(_port_model(cfg),
                                port_kv.KVBackendConfig(**bcfg))
    for be, params in ((jb, jparams), (tb, tparams)):
        be.prefill_chunk(params, 5, tokens[:13], 0)
        be.prefill_chunk(params, 5, tokens[13:], 13)
    before = {k: tb.cache[k][:, 0, :21].clone() for k in ("k", "v")}
    jblob, tblob = jb.offload(5), tb.offload(5)
    assert jblob["lengths"] == tblob["lengths"] == 21
    for key in ("k", "v"):
        (jkind, (jq, jlam, jz, jshape)), (tkind, (tq, tlam, tz, tshape)) = \
            jblob[key], tblob[key]
        assert jkind == tkind == "q8" and tshape == jshape
        assert tshape == (cfg.num_layers, 32, cfg.num_kv_heads, cfg.hd)
        assert tq.dtype == torch.int8 and not tq.is_cuda
        dq = np.abs(tq.numpy().astype(np.int32) - np.asarray(jq, np.int32))
        assert dq.max() <= 1
        np.testing.assert_allclose(tlam.numpy(), np.asarray(jlam),
                                   rtol=1e-4, atol=1e-7)
        assert np.abs(tz.numpy() - np.asarray(jz)).max() <= 1
        rows = tlam.numpy().reshape(tshape[:-1])
        assert np.all(rows[:, 21:] == 1e-8)     # zeroed pad rows
    assert tb.slot_of(5) is None
    tb.upload(5, tblob)
    slot = tb.slot_of(5)
    assert int(tb.cache["lengths"][slot]) == 21
    for k in ("k", "v"):
        lane = tb.cache[k][:, slot]
        step = (before[k].amax(-1) - before[k].amin(-1)).max() / 255
        assert (lane[:, :21] - before[k]).abs().max() <= step
        assert not lane[:, 32:].any()


# ------------------------------------------------------ inside the port

def test_dense_equals_paged_gather(setup):
    """tests/test_paged_serving.py:224 inside the port: prompts at and
    around the page boundary, pages of 8 with Smax 64 (8 pages x 8), no
    preemption; the dense backend (whole-prompt chunks over the stripe)
    and the paged one (whole-prompt chunks, page gather) emit the same
    greedy tokens."""
    cfg, _, _, tparams = setup
    outs = (24, 24, 3, 3, 3, 3)
    runs = []
    for backend in ("dense", "paged"):
        reqs = _requests(port_request, cfg, outs=outs,
                         prompts=(7, 8, 9, 15, 16, 17))
        eng = port_engine.ServingEngine(
            _port_model(cfg), tparams, port_engine.EngineConfig(
                max_slots=8, max_seq_len=64, max_new_tokens=48,
                strategy="vllm", quantize_offload=False, kv_backend=backend,
                page_size=8, eos_token=-1),
            predictor=port_predictor.OraclePredictor())
        eng.serve(reqs)
        assert [len(r.output_tokens) for r in reqs] == list(outs)
        runs.append(_tokens(reqs))
    assert runs[0] == runs[1]


def test_preempted_equals_unpreempted(setup, port_swap):
    cfg, _, _, tparams = setup
    roomy, _ = _port_staged(cfg, tparams, tight=False)
    assert sum(r.preempt_count for r in roomy) == 0
    assert _tokens(port_swap[0]) == _tokens(roomy)


@pytest.mark.parametrize("chunk,budget,impl", [(5, None, "masked"),
                                               (3, 8, "masked"),
                                               (64, 4, "masked"),
                                               (5, None, "flash")])
def test_chunked_equals_monolithic(setup, chunk, budget, impl):
    """tests/test_chunked_prefill.py:60 inside the port: chunked prefill
    over the lane's stripe emits the tokens of the whole-prompt prefill
    (``prefill_chunk`` None: each prompt one chunk)."""
    cfg, _, _, tparams = setup
    mono, _ = _port_staged(cfg, tparams, tight=False, strategy="vllm")
    out, _ = _port_staged(cfg, tparams, chunk=impl, tight=False,
                          strategy="vllm", prefill_chunk=chunk,
                          iter_token_budget=budget)
    assert _tokens(out) == _tokens(mono)


def test_fused_equals_per_slot(setup):
    """tests/test_engine.py:123 inside the port: the legacy per-slot path
    (decode logits, then host sampling lane by lane) emits the fused
    step's tokens, here under forced swaps too."""
    cfg, _, _, tparams = setup
    for tight in (False, True):
        fused, _ = _port_staged(cfg, tparams, tight=tight)
        legacy, _ = _port_staged(cfg, tparams, tight=tight,
                                 fused_decode=False)
        assert _tokens(legacy) == _tokens(fused)


def test_per_slot_decode_needs_the_dense_backend(setup):
    cfg, _, _, tparams = setup
    with pytest.raises(ValueError, match="fused"):
        port_engine.ServingEngine(
            _port_model(cfg), tparams, port_engine.EngineConfig(
                kv_backend="paged", fused_decode=False))
    eng = port_engine.ServingEngine(
        _port_model(cfg), tparams, port_engine.EngineConfig(
            kv_backend="dense", fused_decode=False, max_seq_len=64,
            warmup_compile=True))
    assert isinstance(eng.kv, port_kv.DenseKVBackend)


def test_int8_swap_serves_every_request(setup, port_swap):
    """INT8 stripe swaps (the kv_quant plain versions on the CPU) still
    finish every request with its trace length; tokens before the first
    swap equal the unquantized run's."""
    cfg, _, _, tparams = setup
    reqs, _ = _port_staged(cfg, tparams, quantize_offload=True)
    assert sum(r.preempt_count for r in reqs) > 0
    assert [len(r.output_tokens) for r in reqs] == [
        len(r.output_tokens) for r in port_swap[0]]
    for r, ref in zip(reqs, port_swap[0]):
        assert r.output_tokens[:1] == ref.output_tokens[:1]


def test_serve_launcher_dense_on_cpu():
    from repro_torch.launch.serve import serve
    reqs, eng = serve(arch_size="smoke", n_requests=4, max_slots=2,
                      kv_backend="dense", device="cpu", verbose=False)
    assert all(r.done and r.generated >= 1 for r in reqs)
    assert eng.kv_backend == "dense" and eng._chunked_ok
    # each prompt went through the stripe as one chunk (prefill_chunk None)
    assert sorted(n for _, n, _, _ in eng.prefill_times) == sorted(
        r.prompt_len for r in reqs)
