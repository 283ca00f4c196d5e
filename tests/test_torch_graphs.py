"""The port's graph-ready serving steps and its compile gate, on the CPU.

On the card the fused decode step and the menu's prefill chunks run as
CUDA graphs (``serving/step_graphs.py``) that read their inputs from one
staged int32 tensor and take ``start`` and the chunk length as device
tensors.  Here, with no graphs, the same step functions run eagerly, and
they must give the bits of the eager code they replace: the chunk
prefills that sliced rows with host ints and the decode steps fed one
host copy per input (both kept below as ``_old_*``), on float32 smoke
models whose seeds give no exact logit ties.  The port's
``CompileCounter`` counts the first use of a graph key after an engine
was built (a capture on the card), so a warmed engine must serve a
mixed-length trace, swaps included, with zero new events, as the JAX
package's ``tests/test_prefill_buckets.py::test_zero_compiles_after_warmup``
asserts for XLA compiles.  The warmed engine is also held against the
JAX engine's greedy tokens.
"""
import ctypes
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.core import predictor as jax_predictor  # noqa: E402
from repro.core import request as jax_request  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import engine as port_engine  # noqa: E402
from repro_torch.core import predictor as port_predictor  # noqa: E402
from repro_torch.core import request as port_request  # noqa: E402
from repro_torch.core.quantization import kv_bytes_per_token  # noqa: E402
from repro_torch.kernels import _build, counters  # noqa: E402
from repro_torch.kernels.fused_rmsnorm import fused_rmsnorm  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import Model, params_from_numpy  # noqa: E402
from repro_torch.serving.kv_cache import (DenseKVBackend,  # noqa: E402
                                          KVBackendConfig, PagedKVBackend)
from repro_torch.serving.step_graphs import StepGraphs, pack  # noqa: E402
from repro_torch.utils.compile_counter import CompileCounter, note  # noqa: E402

PAGE = 8


def _cfg(arch="granite-3-8b"):
    return dataclasses.replace(get_smoke_config(arch), param_dtype="float32")


@pytest.fixture(scope="module")
def granite():
    cfg = _cfg()
    model = Model(cfg, kv_dtype="float32", device="cpu")
    return cfg, model, model.init(torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def mamba():
    cfg = _cfg("mamba2-2.7b")
    model = Model(cfg, kv_dtype="float32", device="cpu")
    return cfg, model, model.init(torch.Generator().manual_seed(1))


def _tokens(rng, cfg, n):
    return rng.integers(2, cfg.vocab_size, n).tolist()


# ------------------------------------------------- the eager code replaced

@torch.no_grad()
def _old_paged_prefill_chunk(model, params, kv, tokens, block_tables,
                             write_page, write_off, start, chunk_len):
    cfg = model.cfg
    C = tokens.shape[1]
    page = kv["k"].shape[2]
    Smax = block_tables.shape[1] * page
    x = model._embed_in(params, tokens)
    q_pos = (start + torch.arange(C))[None, :]
    kv_pos = torch.arange(Smax)[None, :]
    start_vec = torch.full((1,), start, dtype=torch.int32)
    wp, wo = write_page.long(), write_off.long()
    tables = block_tables[0].long()
    for li, p_l in enumerate(params["layers"]):
        k_pool, v_pool = kv["k"][li], kv["v"][li]
        q, k, v = L._project_qkv(cfg, p_l["attn"], model._norm(p_l["ln1"], x),
                                 q_pos)
        k_pool.index_put_((wp, wo), k[0].to(k_pool.dtype))
        v_pool.index_put_((wp, wo), v[0].to(v_pool.dtype))
        kg = k_pool[tables].reshape(1, Smax, *k_pool.shape[2:])
        vg = v_pool[tables].reshape(1, Smax, *v_pool.shape[2:])
        attn = model._chunk_attn(q, kg, vg, q_pos, kv_pos, start_vec)
        x = x + attn.reshape(1, C, -1) @ p_l["attn"]["wo"]
        x, _ = model._ffn_block(p_l, x)
    last = min(max(chunk_len - 1, 0), C - 1)
    return model._logits(params, model._norm(params["final_norm"],
                                             x[:, last])).float()


@torch.no_grad()
def _old_prefill_chunk(model, params, k_stripe, v_stripe, tokens, start,
                       chunk_len):
    cfg = model.cfg
    C = tokens.shape[1]
    Smax = k_stripe.shape[1]
    x = model._embed_in(params, tokens)
    q_pos = (start + torch.arange(C))[None, :]
    kv_pos = torch.arange(Smax)[None, :]
    n_in = max(0, min(C, Smax - start))
    start_vec = torch.full((1,), start, dtype=torch.int32)
    for li, p_l in enumerate(params["layers"]):
        k_l, v_l = k_stripe[li], v_stripe[li]
        q, k, v = L._project_qkv(cfg, p_l["attn"], model._norm(p_l["ln1"], x),
                                 q_pos)
        k_l[start:start + n_in] = k[0, :n_in].to(k_l.dtype)
        v_l[start:start + n_in] = v[0, :n_in].to(v_l.dtype)
        attn = model._chunk_attn(q, k_l[None], v_l[None], q_pos, kv_pos,
                                 start_vec)
        x = x + attn.reshape(1, C, -1) @ p_l["attn"]["wo"]
        x, _ = model._ffn_block(p_l, x)
    last = min(max(chunk_len - 1, 0), C - 1)
    return model._logits(params, model._norm(params["final_norm"],
                                             x[:, last])).float()


def _t(a, dtype=torch.int32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _old_decode(kv, params, tokens, active, new_gen, new_ctx, true_len,
                rids):
    """The backends' decode before the staged input: one host copy per
    array, then ``torch.stack(...).cpu()``."""
    if isinstance(kv, PagedKVBackend):
        B, pg = kv.cfg.max_slots, kv.cfg.page_size
        tables = np.full((B, kv.max_pages_per_seq), kv.scratch_page, np.int32)
        lens = np.zeros((B,), np.int32)
        wp = np.full((B,), kv.scratch_page, np.int64)
        wo = np.zeros((B,), np.int64)
        for slot, rid in enumerate(kv.slot_req):
            if rid is None or not active[slot]:
                continue
            kv.pool.extend(rid, 1)
            pos = kv.pool.lengths[rid] - 1
            pt = kv.pool.page_table[rid]
            tables[slot, :len(pt)] = pt
            lens[slot] = pos
            wp[slot], wo[slot] = pt[pos // pg], pos % pg
        tok, reason = kv.model.paged_decode_step_sampled(
            params, kv._kv(), _t(tokens, torch.int64), _t(tables), _t(lens),
            _t(wp, torch.int64), _t(wo, torch.int64), _t(active, torch.bool),
            _t(new_gen), _t(new_ctx), _t(true_len), _t(rids),
            attn_impl=kv.cfg.attn_impl, **kv._sample_kwargs())
    else:
        tok, reason = kv.model.decode_step_sampled(
            params, kv.cache, _t(tokens, torch.int64), _t(active, torch.bool),
            _t(new_gen), _t(new_ctx), _t(true_len), _t(rids),
            **kv._sample_kwargs())
    out = torch.stack([tok, reason]).cpu().numpy()
    return out[0], out[1]


# ------------------------------------------------------- the chunk steps

@pytest.mark.parametrize("start,n,Cb", [
    (0, 5, 8),        # a first chunk inside one page
    (5, 7, 8),        # straddles the page boundary at 8
    (13, 12, 16),     # starts mid-page, spans two boundaries
])
def test_paged_chunk_with_device_start_matches_the_int_code(granite, start,
                                                            n, Cb):
    """``paged_prefill_chunk`` with ``start`` and ``chunk_len`` as (1,)
    tensors (as the graphed step passes them) gives the logits and the
    pool writes of the code that took them as ints, bit for bit."""
    cfg, model, params = granite
    rng = np.random.default_rng(start + n)
    shape = (cfg.num_layers, 8, PAGE, cfg.num_kv_heads, cfg.hd)
    pool = {k: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for k in ("k", "v")}
    tables = torch.tensor([[3, 1, 6, 0]], dtype=torch.int32)
    pos = start + np.arange(Cb)
    wp = torch.from_numpy(np.where(np.arange(Cb) < n,
                                   tables[0].numpy()[np.minimum(pos // PAGE,
                                                                3)], 7))
    wo = torch.from_numpy(np.where(np.arange(Cb) < n, pos % PAGE,
                                   np.arange(Cb) % PAGE))
    toks = torch.tensor([_tokens(rng, cfg, n) + [0] * (Cb - n)])
    old_pool = {k: v.clone() for k, v in pool.items()}
    old = _old_paged_prefill_chunk(model, params, old_pool, toks, tables, wp,
                                   wo, start, n)
    new = model.paged_prefill_chunk(
        params, pool, toks.int(), tables, wp.int(), wo.int(),
        torch.tensor([start], dtype=torch.int32),
        torch.tensor([n], dtype=torch.int32))
    assert torch.equal(new, old)
    for k in ("k", "v"):
        assert torch.equal(pool[k], old_pool[k])


@pytest.mark.parametrize("start,n,Cb", [
    (0, 5, 8),
    (40, 20, 32),     # the bucket runs 8 rows past Smax 64
    (60, 3, 8),       # 4 rows past Smax, the tokens themselves inside
    (24, 40, 64),     # a bucket as long as the stripe, 24 rows past it
])
def test_dense_chunk_with_device_rows_matches_the_slice_code(granite, start,
                                                             n, Cb):
    """``prefill_chunk`` writing rows through ``(start + i) mod Smax`` (rows
    past Smax write back an old row) gives the logits and the stripe of
    the code that sliced ``[start, start + n_in)``, bit for bit, also when
    the bucket runs past Smax; ints and tensors give the same bits."""
    cfg, model, params = granite
    Smax = 64
    rng = np.random.default_rng(Cb + start)
    shape = (cfg.num_layers, Smax, cfg.num_kv_heads, cfg.hd)
    stripes = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for _ in range(2)]
    toks = torch.tensor([_tokens(rng, cfg, n) + [0] * (Cb - n)])
    old_s = [s.clone() for s in stripes]
    old = _old_prefill_chunk(model, params, *old_s, toks, start, n)
    int_s = [s.clone() for s in stripes]
    by_int = model.prefill_chunk(params, *int_s, toks, start, n)
    new = model.prefill_chunk(params, *stripes, toks.int(),
                              torch.tensor([start], dtype=torch.int32),
                              torch.tensor([n], dtype=torch.int32))
    assert torch.equal(new, old) and torch.equal(by_int, old)
    for a, b, c in zip(stripes, old_s, int_s):
        assert torch.equal(a, b) and torch.equal(c, b)


# ------------------------------------------------------ the decode steps

def _prefilled_pair(model, params, backend, prompts, lanes):
    """Two backends in the same state: ``prompts`` prefilled through the
    backends' own prefill, each in its lane of ``lanes``."""
    out = []
    for _ in range(2):
        bcfg = KVBackendConfig(max_slots=4, max_seq_len=64, page_size=PAGE,
                               greedy=False, temperature=0.9, top_k=8,
                               eos_token=-1)
        if backend == "paged":
            kv = PagedKVBackend(model, bcfg, num_pages=40)
        else:
            kv = DenseKVBackend(model, bcfg)
        for lane, (rid, p) in zip(lanes, prompts.items()):
            if model.cfg.family == "ssm":     # the first free lane is next
                logits, cache = model.prefill(params,
                                              {"tokens": torch.tensor([p])})
                kv.write_prefill(rid, cache, len(p))
            else:
                kv.prefill_chunk(params, rid, p, 0, slot=lane)
        out.append(kv)
    return out


@pytest.mark.parametrize("backend", ["paged", "dense", "mamba"])
def test_staged_decode_matches_the_per_array_code(granite, mamba, backend):
    """``decode`` through the staged input (one int32 buffer, one copy in,
    one copy of ``(tokens, reasons)`` out) gives the tokens, reasons and
    KV or state writes of the code that copied each array on its own, bit
    for bit, over steps with an idle lane, temperature sampling and a
    termination."""
    cfg, model, params = mamba if backend == "mamba" else granite
    rng = np.random.default_rng(11)
    prompts = {7: _tokens(rng, cfg, 5), 9: _tokens(rng, cfg, 11),
               4: _tokens(rng, cfg, 16)}
    kind = "dense" if backend == "mamba" else backend
    lanes = [0, 1, 2] if backend == "mamba" else [0, 2, 3]
    a, b = _prefilled_pair(model, params, kind, prompts, lanes)
    B = 4
    toks = np.zeros((B, 1), np.int32)
    toks[lanes, 0] = [p[-1] for p in prompts.values()]
    gen = np.zeros((B,), np.int32)
    ctx = np.zeros((B,), np.int32)
    ctx[lanes] = [len(p) for p in prompts.values()]
    active = np.zeros((B,), bool)
    active[lanes] = True
    true_len = np.full((B,), 2 ** 31 - 1, np.int32)
    true_len[lanes] = [3, 9, 9]
    rids = np.zeros((B,), np.int32)
    rids[lanes] = list(prompts)
    for _ in range(4):
        args = (toks, active, gen + 1, ctx + 1, true_len, rids)
        want = _old_decode(a, params, *args)
        got = b.decode(params, *args)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        state_a = a._kv() if kind == "paged" else a.cache
        state_b = b._kv() if kind == "paged" else b.cache
        for k in state_a:
            assert torch.equal(state_a[k], state_b[k]), k
        toks[:, 0] = got[0]
        gen, ctx = gen + active, ctx + active
        active = active & (got[1] == 0)
    assert not active[0], "lane 0's trace stop (true_len 3) never fired"


# ------------------------------------------------------- compile counter

def test_compile_counter_api():
    """The reference's API: attached at construction, ``count`` and
    ``events``, ``reset`` returns the count, ``detach`` stops counting,
    ``require`` raises once detached."""
    cc = CompileCounter()
    assert cc.available and cc.require() is cc
    note("capture:('decode',)")
    note("load:fused_rmsnorm")
    assert cc.count == 2
    assert cc.events == ["capture:('decode',)", "load:fused_rmsnorm"]
    assert cc.reset() == 2 and cc.count == 0 and cc.events == []
    cc.detach()
    note("build:kv_quant")
    assert cc.count == 0 and not cc.available
    with pytest.raises(RuntimeError, match="detached"):
        cc.require()
    cc.detach()                             # a second detach is harmless


def test_expect_no_compiles_raises_naming_the_events():
    cc = CompileCounter()
    with cc.expect_no_compiles("quiet"):
        pass
    with pytest.raises(AssertionError) as err:
        with cc.expect_no_compiles("serve[paged]"):
            note("first-use:('chunk', 16)")
            note("load:kv_quant")
    msg = str(err.value)
    assert msg.startswith("2 unexpected")
    assert "during serve[paged]" in msg
    assert "first-use:('chunk', 16)" in msg and "load:kv_quant" in msg
    with pytest.raises(ValueError):         # an error inside passes through
        with cc.expect_no_compiles():
            note("capture:x")
            raise ValueError
    cc.detach()


def test_step_graphs_note_each_key_once_on_the_cpu():
    """Without graphs each key's first use is noted once, as a capture
    would be, and the step runs on the staged input."""
    graphs = StepGraphs("cpu")
    cc = CompileCounter()
    seen = []

    def step(buf):
        seen.append(buf.clone())
        return buf * 2

    for vals in ([1, 2], [3, 4], [5, 6]):
        out = graphs.run(("decode",), pack(vals), step, lambda: pack([0, 0]))
        assert graphs.to_host(out).tolist() == [2 * v for v in vals]
    graphs.run(("chunk", 8), pack([1]), step, lambda: pack([0]))
    assert cc.events == ["first-use:('decode',)", "first-use:('chunk', 8)"]
    assert [s.tolist() for s in seen] == [[1, 2], [3, 4], [5, 6], [1]]
    assert len(graphs) == 2 and graphs.captures == 0
    assert graphs.replays == {"decode": 0, "chunk": 0, "pack": 0,
                              "verify": 0}
    cc.detach()


class _FakePagedLib:
    """Stands in for the paged-attention library's body counters."""

    def __init__(self):
        self.counts = [0, 0]

    @property
    def paged_attention_body_launches(self):
        def read(addr):
            for i, n in enumerate(self.counts):
                ctypes.c_longlong.from_address(addr + 8 * i).value = n
            return 0
        return read


def test_counters_advance_replays_like_launches(monkeypatch):
    """The replay arithmetic: a capture's counted launches are taken back
    (a capture launches nothing) and added once per replay, to the
    wrappers' ``launches`` and to a loaded library's body counters alike;
    libraries not loaded are not read (and not loaded to read them)."""
    lib = _FakePagedLib()
    monkeypatch.setattr(_build, "loaded", lambda n: n == "paged_attention")
    monkeypatch.setattr(_build, "load", lambda n: lib)
    monkeypatch.setattr(paged_ops, "REPLAYED", {"body": 0, "merge": 0})
    for name, fn in counters.WRAPPERS.items():
        monkeypatch.setattr(fn, "launches", 0)
    before = counters.snapshot()
    assert set(before) == set(counters.WRAPPERS) | {
        ("paged_attention", "body"), ("paged_attention", "merge")}
    # what a capture of one decode step of 2 layers counts
    fused_rmsnorm.launches += 5
    paged_ops.paged_attention.launches += 2
    lib.counts = [2, 2]
    moved = counters.delta(before, counters.snapshot())
    assert moved == {"fused_rmsnorm": 5, "paged_attention": 2,
                     ("paged_attention", "body"): 2,
                     ("paged_attention", "merge"): 2}
    counters.advance(moved, -1)
    assert counters.snapshot() == before
    for _ in range(3):                      # three replays
        counters.advance(moved)
    after = counters.snapshot()
    assert counters.delta(before, after) == {k: 3 * n
                                             for k, n in moved.items()}
    assert paged_ops.body_launches() == {"body": 6, "merge": 6}


# -------------------------------------------------------------- engines

def _engine(cfg, model, params, backend, *, quant, warm, tight=True):
    bpt = kv_bytes_per_token(cfg.num_layers, cfg.num_kv_heads, cfg.hd)
    kw = dict(max_slots=2 if tight else 4, max_seq_len=64, max_new_tokens=24,
              strategy="alise", quantize_offload=quant, eos_token=-1,
              warmup_compile=warm, kv_backend="dense")
    if tight:
        kw["hbm_bytes"] = 2 * 40 * bpt
    if backend == "paged":
        kw.update(kv_backend="paged", page_size=PAGE)
    if cfg.family != "ssm":
        kw.update(prefill_chunk=16, iter_token_budget=24)
    return port_engine.ServingEngine(
        model, params, port_engine.EngineConfig(**kw),
        predictor=port_predictor.OraclePredictor())


# mixed lengths: chunks of 1..16 tokens land in buckets 8 and 16
PROMPTS = (7, 30, 9, 17, 3, 12)
OUTS = (20, 20, 4, 6, 3, 5)


def _staged_serve(eng, cfg, req_mod=port_request):
    """Serve on a virtual clock: two requests first, the rest 0.5 s
    later, so the two lanes force preemption."""
    req_mod.reset_request_counter()
    rng = np.random.default_rng(5)
    reqs = [req_mod.Request(prompt_len=p, arrival_time=0.0, true_out_len=o,
                            prompt_tokens=_tokens(rng, cfg, p))
            for p, o in zip(PROMPTS, OUTS)]
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
    assert not eng.sched.live and all(r.done for r in reqs)
    return reqs


@pytest.mark.parametrize("backend", ["paged", "dense"])
def test_zero_compiles_after_warmup(granite, backend):
    """The compile gate: after ``warmup``, a mixed-length serve (chunks of
    two buckets, INT8 swaps forced by two lanes, decode) makes no graph
    key's first use, and builds or loads no library."""
    cfg, model, params = granite
    eng = _engine(cfg, model, params, backend, quant=True, warm=True)
    w = eng.warm_stats
    lanes = 2 if backend == "dense" else 1
    assert w["keys"] == w["compiles"] == 1 + 2 * lanes   # decode + buckets
    assert w["captures"] == 0 and w["pool_bytes"] == 0  # no graphs here
    assert set(eng.latency.bucket_costs) == {8, 16}
    counter = CompileCounter().require()
    with counter.expect_no_compiles(f"serve[{backend}]"):
        reqs = _staged_serve(eng, cfg)
    assert counter.count == 0
    counter.detach()
    assert sum(r.preempt_count for r in reqs) > 0
    assert all(r.output_tokens for r in reqs)
    assert len(eng.kv.graphs) == w["keys"]


def test_cold_engine_counts_each_key_once(granite):
    """Without warmup the gate sees each key the serve uses, once."""
    cfg, model, params = granite
    eng = _engine(cfg, model, params, "paged", quant=True, warm=False)
    counter = CompileCounter()
    _staged_serve(eng, cfg)
    assert eng.warm_stats is None
    assert counter.count == len(set(counter.events)) == len(eng.kv.graphs)
    assert "first-use:('decode',)" in counter.events
    assert all(e.startswith("first-use:('chunk', ") for e in counter.events
               if "decode" not in e) and counter.count >= 2
    counter.detach()


@pytest.mark.parametrize("backend", ["paged", "dense", "mamba"])
def test_warm_engine_serves_the_cold_engines_tokens(granite, mamba, backend):
    """Warm runs touch only state they release: a warmed engine emits a
    cold one's greedy tokens bit for bit (quantization off, so the swap
    schedule, which the warm bucket costs may move, changes no token)."""
    cfg, model, params = mamba if backend == "mamba" else granite
    kind = "dense" if backend == "mamba" else backend
    out = []
    for warm in (True, False):
        eng = _engine(cfg, model, params, kind, quant=False, warm=warm)
        reqs = _staged_serve(eng, cfg)
        out.append([list(r.output_tokens) for r in reqs])
    assert out[0] == out[1]
    assert [len(t) for t in out[0]] == list(OUTS)


def test_warmed_engine_matches_the_jax_engine():
    """The slice as a whole against the reference: a warmed port engine on
    the paged backend and the JAX engine, both with the JAX
    ``Model.init``'s weights, emit the same greedy tokens with the same
    preemptions on the same staged trace (quantization off; the port's
    measured bucket costs are cleared, so that both engines plan alike)."""
    jcfg = dataclasses.replace(jax_smoke_config("granite-3-8b"),
                               param_dtype="float32")
    jmodel = JaxModel(jcfg, kv_dtype="float32", remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = _cfg()
    tparams = params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    model = Model(cfg, kv_dtype="float32", device="cpu")
    eng = _engine(cfg, model, tparams, "paged", quant=False, warm=True)
    eng.latency.bucket_costs = None
    port = _staged_serve(eng, cfg)
    bpt = kv_bytes_per_token(cfg.num_layers, cfg.num_kv_heads, cfg.hd)
    jeng = jax_engine.ServingEngine(jmodel, jparams, jax_engine.EngineConfig(
        max_slots=2, max_seq_len=64, max_new_tokens=24, strategy="alise",
        quantize_offload=False, eos_token=-1, hbm_bytes=2 * 40 * bpt,
        kv_backend="paged", page_size=PAGE, prefill_chunk=16,
        iter_token_budget=24), predictor=jax_predictor.OraclePredictor())
    ref = _staged_serve(jeng, cfg, jax_request)
    assert ([list(r.output_tokens) for r in port]
            == [list(r.output_tokens) for r in ref])
    assert ([r.preempt_count for r in port]
            == [r.preempt_count for r in ref])
    assert sum(r.preempt_count for r in port) > 0
