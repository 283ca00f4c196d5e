"""The port's shared-prefix KV cache, against the JAX package.

``repro_torch.serving.prefix_cache`` keeps the reference's radix index
(pure Python, copied) and rewrites its two storage front-ends for torch.
The index and the simulator's twin must give the reference's results on
the same operation sequence, and the paged front-end the reference's page
tables and refcounts.  The engine with the cache on must emit the JAX
engine's greedy tokens (both KV backends), and its own with the cache off
bit for bit, as ``tests/test_prefix_cache.py`` holds for the JAX engine:
over multi-turn sessions, a copy-on-write page, forced eviction and swap
churn (no refcount leaks after the drain), and INT8 swaps, whose lossy KV
is never published.
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
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import kv_cache as jax_kv  # noqa: E402
from repro.serving import prefix_cache as jax_pc  # noqa: E402
from repro_torch.core import engine as port_engine  # noqa: E402
from repro_torch.core import predictor as port_predictor  # noqa: E402
from repro_torch.core import request as port_request  # noqa: E402
from repro_torch.core.quantization import kv_bytes_per_token  # noqa: E402
from repro_torch.models.model import Model, params_from_numpy  # noqa: E402
from repro_torch.serving import kv_cache as port_kv  # noqa: E402
from repro_torch.serving import prefix_cache as port_pc  # noqa: E402

PAGE = 8


# ------------------------------------------------------------ radix core

def _radix_ops(mod):
    """The reference tests' radix sequences plus a seeded random one,
    on ``mod``'s ``RadixPageIndex``; returns every observable result."""
    out = []
    idx = mod.RadixPageIndex(page_size=4)
    pages = iter(range(100))
    toks = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]
    out.append([n.page for n in idx.insert(toks, 8, lambda i: next(pages))])
    full, partial = idx.match(toks)
    out.append(([n.page for n in full], partial))
    full, partial = idx.match([1, 2, 3, 4, 5, 6, 99, 99])
    out.append(([n.page for n in full], partial[0].page, partial[1]))
    out.append(idx.probe_len([1, 2, 3, 4, 5, 6, 99, 99]))
    idx.insert([1, 2, 3, 4, 9, 9, 9, 9], 8, lambda i: next(pages))
    out.append((idx.n_pages, idx.probe_len([1, 2, 3, 4, 9, 9, 9, 9])))
    lru = mod.RadixPageIndex(page_size=2)
    lru.insert([1, 2, 3, 4, 5, 6], 6, lambda i: i)
    lru.match([1, 2])
    out.append(lru.evict_lru(1, can_evict=lambda p: True))
    out.append((lru.evict_lru(2, can_evict=lambda p: p != 0), lru.n_pages))
    rng = np.random.default_rng(7)
    rand = mod.RadixPageIndex(page_size=3)
    ids = iter(range(10_000))
    for _ in range(300):
        t = rng.integers(0, 3, int(rng.integers(1, 14))).tolist()
        op = int(rng.integers(0, 4))
        if op == 0:
            got = [n.page for n in rand.insert(t, len(t),
                                               lambda i: next(ids))]
        elif op == 1:
            full, partial = rand.match(t)
            got = ([n.page for n in full],
                   None if partial is None else (partial[0].page,
                                                 partial[1]))
        elif op == 2:
            got = rand.probe_len(t, touch=bool(rng.integers(0, 2)))
        else:
            got = rand.evict_lru(int(rng.integers(1, 4)),
                                 can_evict=lambda p: p % 3 != 0)
        out.append((op, got, rand.n_pages))
    return out


def test_radix_index_equals_the_reference():
    assert _radix_ops(port_pc) == _radix_ops(jax_pc)


def _sim_ops(mod):
    idx = mod.SimPrefixIndex(page_size=2, capacity_pages=3)
    out = [idx.insert(list(range(10)), 10), idx.index.n_pages,
           idx.hit(list(range(10)), cap=9), idx.hit([99, 98, 97], cap=2)]
    rng = np.random.default_rng(8)
    for _ in range(100):
        t = rng.integers(0, 3, int(rng.integers(1, 10))).tolist()
        if rng.integers(0, 2):
            out.append(idx.insert(t, len(t)))
        else:
            out.append((idx.hit(t, int(rng.integers(0, 10))),
                        idx.probe(t)))
    out.append(idx.stats.as_dict())
    return out


def test_sim_prefix_index_equals_the_reference():
    assert _sim_ops(port_pc) == _sim_ops(jax_pc)


# ----------------------------------------------------------- pool + cache

def _pool(mod, pages=16, **kw):
    return mod.PagedKVPool(mod.PagedKVConfig(
        num_pages=pages, page_size=4, num_kv_heads=1, head_dim=8,
        num_layers=1), **kw)


def test_pool_refcounts_and_cow():
    pool = _pool(port_kv, 8)
    pool.k.copy_(torch.randn(pool.k.shape))
    pool.allocate(0, 8)                                    # two pages, ref 1
    p0, p1 = pool.page_table[0]
    pool.incref(p0)                                        # index reference
    pool.free(0)
    assert pool.refs[p0] == 1 and p1 not in pool.refs
    assert p0 not in pool.free_pages and p1 in pool.free_pages
    cow = pool.cow_page(p0)
    assert cow != p0 and pool.refs[cow] == 1
    assert torch.equal(pool.k[:, cow], pool.k[:, p0])
    assert torch.equal(pool.v[:, cow], pool.v[:, p0])
    assert pool.decref(p0) == 0 and p0 in pool.free_pages
    pool.decref(cow)
    assert sorted(pool.free_pages) == list(range(8)) and not pool.refs


def _paged_cache_ops(kv_mod, pc_mod):
    """The reference test's acquire / publish / evict sequence and a
    copy-on-write hit and a dedupe; returns tables, refs and stats."""
    pool = _pool(kv_mod)
    cache = pc_mod.PagedPrefixCache(pool, page_size=4)
    toks = list(range(100, 112))                           # 3 full pages
    out = []
    pool.allocate(7, 12)
    out.append(cache.publish(7, toks, 12))
    pool.free(7)
    out.append(cache.held_pages())
    out.append(cache.acquire(8, toks[:8] + [1, 2, 3, 4]))
    out.append((list(pool.page_table[8]), dict(pool.refs)))
    out.append(cache.acquire(9, toks[:10] + [5, 6, 7]))    # partial: CoW
    out.append((list(pool.page_table[9]), pool.lengths[9]))
    pool.allocate(10, 12)                                  # same prompt:
    out.append(cache.publish(10, toks, 12))                # dedupe
    out.append((list(pool.page_table[10]), dict(pool.refs)))
    out.append(cache.reclaim(10))
    for rid in (8, 9, 10):
        pool.free(rid)
    out.append((cache.reclaim(10), cache.held_pages(), pool.refs,
                sorted(pool.free_pages), cache.stats.as_dict()))
    return out


def test_paged_prefix_cache_equals_the_reference():
    assert (_paged_cache_ops(port_kv, port_pc)
            == _paged_cache_ops(jax_kv, jax_pc))


def test_dense_publish_fetch_and_overflow():
    """A publish copies the stripe's full pages into the store and a fetch
    gives them back; a prefix longer than the store stays rooted and
    matchable (no orphaned pages), as the reference's."""
    k = torch.arange(24, dtype=torch.float32).reshape(1, 24, 1, 1)
    cache = port_pc.DensePrefixCache(num_layers=1, num_kv_heads=1,
                                     head_dim=1, page_size=2,
                                     capacity_pages=8, dtype=torch.float32)
    toks = list(range(24))
    assert cache.publish(toks, 10, k, -k) == 5
    hit, kf, vf = cache.fetch(toks[:7] + [99])
    assert hit == 7 and torch.equal(kf[:, :8], k[:, :8])
    assert torch.equal(vf[:, :8], -k[:, :8])
    small = port_pc.DensePrefixCache(num_layers=1, num_kv_heads=1,
                                     head_dim=4, page_size=2,
                                     capacity_pages=2, dtype=torch.float32)
    k4 = torch.arange(48, dtype=torch.float32).reshape(1, 12, 1, 4)
    small.publish(toks[:12], 12, k4, k4)
    reachable, frontier = set(), list(small.index.root.values())
    while frontier:
        n = frontier.pop()
        reachable.add(n.page)
        frontier.extend(n.children.values())
    assert {n.page for n in small.index.nodes} == reachable
    assert len(reachable) + len(small.free_pages) == small.capacity
    assert small.probe(toks[:12]) == small.index.n_pages * 2
    small.publish(toks[:12], 12, k4, k4)
    assert small.probe(toks[:12]) > 0


# --------------------------------------------------- engine-level identity

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


def _engine(setup, jax_side=False, **kw):
    cfg, jmodel, jparams, model, tparams = setup
    opts = dict(max_slots=4, max_seq_len=96, max_new_tokens=8,
                strategy="alise", quantize_offload=False, prefill_chunk=6,
                page_size=PAGE)
    opts.update(kw)
    if jax_side:
        return jax_engine.ServingEngine(
            jmodel, jparams, jax_engine.EngineConfig(**opts),
            predictor=jax_predictor.OraclePredictor())
    return port_engine.ServingEngine(
        model, tparams, port_engine.EngineConfig(**opts),
        predictor=port_predictor.OraclePredictor())


def _drive(eng, reqs, staged=False):
    """Serve on a virtual clock: all at t = 0, or with ``staged`` two
    requests first and the rest 0.5 s later."""
    t = 0.0
    for r in (reqs[:2] if staged else reqs):
        eng.submit(r, t)
    for i in range(800):
        if staged and i == 5:
            for r in reqs[2:]:
                eng.submit(r, t)
        if i > 5 and not eng.sched.live:
            break
        eng.step(t)
        t += 0.1
    assert not eng.sched.live, "engine did not drain"


SYS, USER, OUT, SESSIONS, TURNS = 20, 5, 6, 2, 3


def _sessions(eng, cfg, req_mod):
    """Sessions over one system prompt, turn by turn (each turn resends
    the whole conversation); returns every turn's greedy tokens."""
    rng = np.random.default_rng(0)
    system = rng.integers(2, cfg.vocab_size, SYS).tolist()
    msgs = [[rng.integers(2, cfg.vocab_size, USER).tolist()
             for _ in range(TURNS)] for _ in range(SESSIONS)]
    req_mod.reset_request_counter()
    hists = [system + msgs[s][0] for s in range(SESSIONS)]
    outs = []
    for turn in range(TURNS):
        reqs = [req_mod.Request(prompt_len=len(h), arrival_time=0.0,
                                true_out_len=OUT, prompt_tokens=list(h))
                for h in hists]
        _drive(eng, reqs)
        outs.append([list(r.output_tokens) for r in reqs])
        for s, r in enumerate(reqs):
            hists[s] = hists[s] + list(r.output_tokens)
            if turn + 1 < TURNS:
                hists[s] += msgs[s][turn + 1]
    return outs


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_prefix_cache_on_off_bit_identity_multiturn(setup, backend):
    cfg = setup[0]
    ref = _sessions(_engine(setup, kv_backend=backend), cfg, port_request)
    eng = _engine(setup, kv_backend=backend, prefix_cache=True)
    assert _sessions(eng, cfg, port_request) == ref
    st = eng.kv.prefix_stats()
    assert st.hits >= SESSIONS * (TURNS - 1) and st.hit_tokens > 0
    g = eng.gauges()
    assert g["prefix_hit_ratio"] > 0 and g["prefix_hits"] == st.hits


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_prefix_cache_engine_matches_the_jax_engine(setup, backend):
    cfg = setup[0]
    eng = _engine(setup, kv_backend=backend, prefix_cache=True)
    got = _sessions(eng, cfg, port_request)
    jeng = _engine(setup, jax_side=True, kv_backend=backend,
                   prefix_cache=True)
    assert got == _sessions(jeng, cfg, jax_request)
    assert (eng.kv.prefix_stats().as_dict()
            == jeng.kv.prefix_stats().as_dict())


def test_prefix_probe_and_prefill_estimate(setup):
    cfg = setup[0]
    eng = _engine(setup, kv_backend="paged", prefix_cache=True)
    _sessions(eng, cfg, port_request)
    rng = np.random.default_rng(0)
    system = rng.integers(2, cfg.vocab_size, SYS).tolist()
    prompt = system + [3] * 30
    hit = eng.prefix_probe(prompt)
    assert hit >= 16 and eng.prefix_probe([5] * 30) == 0
    # a hit prices the first uncached chunk at the hit's context
    lm = eng.latency
    assert (eng.prefill_estimate(len(prompt), prompt)
            == lm.prefill_chunk_time(hit, 6))
    assert (eng.prefill_estimate(len(prompt))
            == lm.first_chunk_time(len(prompt), 6))
    assert _engine(setup).prefix_probe(prompt) == 0


def test_partial_page_divergence_cow(setup):
    cfg = setup[0]
    rng = np.random.default_rng(7)
    base = rng.integers(2, cfg.vocab_size, 13).tolist()   # 8 + 5 shared
    prompts = [base + rng.integers(2, cfg.vocab_size, 3).tolist()
               for _ in range(2)]

    def run(pc):
        port_request.reset_request_counter()
        eng = _engine(setup, max_slots=2, max_seq_len=64, kv_backend="paged",
                      prefix_cache=pc)
        outs = []
        for toks in prompts:              # one after the other
            r = port_request.Request(prompt_len=len(toks), arrival_time=0.0,
                                     true_out_len=5,
                                     prompt_tokens=list(toks))
            _drive(eng, [r])
            outs.append(list(r.output_tokens))
        return outs, eng

    ref, _ = run(False)
    out, eng = run(True)
    assert out == ref
    st = eng.kv.prefix_stats()
    assert st.partial_hits >= 1 and st.cow_pages >= 1


def _assert_no_leaks(eng):
    """After the drain every pool page is free, held by the index alone
    (refcount 1) or the scratch page."""
    pool = eng.kv.pool
    assert not pool.page_table, pool.page_table
    index_pages = {n.page for n in eng.kv.prefix.index.nodes}
    for page, refs in pool.refs.items():
        assert refs == 1 and (page == eng.kv.scratch_page
                              or page in index_pages), (page, refs)
    eng.kv.prefix.drop_all()
    assert sorted(pool.free_pages + [eng.kv.scratch_page]) \
        == list(range(pool.cfg.num_pages))
    assert list(pool.refs) == [eng.kv.scratch_page]


def _churn(setup, prompts, outs, **kw):
    cfg = setup[0]
    bpt = kv_bytes_per_token(cfg.num_layers, cfg.num_kv_heads, cfg.hd)
    port_request.reset_request_counter()
    reqs = [port_request.Request(prompt_len=len(p), arrival_time=0.0,
                                 true_out_len=o, prompt_tokens=list(p))
            for p, o in zip(prompts, outs)]
    eng = _engine(setup, max_slots=2, max_seq_len=64, max_new_tokens=32,
                  hbm_bytes=2 * 56 * bpt, kv_backend="paged", **kw)
    _drive(eng, reqs, staged=True)
    return reqs, eng


def test_refcounts_under_forced_eviction_and_swap_churn(setup):
    """A tight pool and staged shared-prefix arrivals force preemption,
    swap churn (exact swaps, which re-link shared pages on upload) and
    cache eviction: tokens equal the cache-off run's, and no refcount
    leaks after the drain."""
    cfg = setup[0]
    rng = np.random.default_rng(3)
    system = rng.integers(2, cfg.vocab_size, 16).tolist()
    prompts = [system + rng.integers(2, cfg.vocab_size, n).tolist()
               for n in (3, 5, 7, 2)]
    outs = (24, 24, 3, 3)
    ref, _ = _churn(setup, prompts, outs, prefix_cache=False)
    reqs, eng = _churn(setup, prompts, outs, prefix_cache=True)
    assert ([list(r.output_tokens) for r in reqs]
            == [list(r.output_tokens) for r in ref])
    assert sum(r.preempt_count for r in reqs) > 0, "no churn was forced"
    assert eng.kv.prefix_stats().hits > 0
    _assert_no_leaks(eng)


def test_lossy_quantized_swap_is_never_published(setup):
    """KV that went through an INT8 offload/upload is lossy: a swapped
    request's finish-time publish is suppressed (its prefill-time publish,
    made before the swap, stays).  Without quantization the same churn
    publishes the whole conversation at finish."""
    cfg = setup[0]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, cfg.vocab_size, 17).tolist()
               for _ in range(4)]
    outs = (24, 24, 3, 3)
    reqs, eng = _churn(setup, prompts, outs, prefix_cache=True,
                       quantize_offload=True)
    swapped = [r for r in reqs if r.swap_out_bytes > 0]
    assert swapped, "no quantized swap was forced"
    for r in swapped:
        conv = list(r.prompt_tokens) + list(r.output_tokens)[:-1]
        assert eng.kv.prefix_probe(conv) <= (r.prompt_len // PAGE) * PAGE
    assert not eng._lossy_kv
    reqs, eng = _churn(setup, prompts, outs, prefix_cache=True)
    swapped = [r for r in reqs if r.swap_out_bytes > 0 and r.generated > 8]
    assert any(eng.kv.prefix_probe(list(r.prompt_tokens)
                                   + list(r.output_tokens)[:-1])
               > (r.prompt_len // PAGE) * PAGE for r in swapped)


def test_dense_store_is_charged_and_sized(setup):
    """The dense backend's private store (one batch of stripes by
    default, or ``prefix_cache_pages``) is charged against the HBM budget
    and grows the default budget by its size."""
    cfg = setup[0]
    bpt = kv_bytes_per_token(cfg.num_layers, cfg.num_kv_heads, cfg.hd)
    eng = _engine(setup, kv_backend="dense", prefix_cache=True)
    store = 4 * 96 // PAGE * PAGE * bpt
    assert eng.kv.prefix.capacity == 4 * 96 // PAGE
    assert eng.mem.static_bytes == store
    assert eng.mem.cfg.hbm_bytes == 4 * 96 * bpt + store
    small = _engine(setup, kv_backend="dense", prefix_cache=True,
                    prefix_cache_pages=5)
    assert small.kv.prefix.capacity == 5 and tuple(
        small.kv.prefix.k.shape) == (cfg.num_layers, 5, PAGE,
                                     cfg.num_kv_heads, cfg.hd)
    jeng = _engine(setup, jax_side=True, kv_backend="dense",
                   prefix_cache=True)
    assert jeng.mem.cfg.hbm_bytes == eng.mem.cfg.hbm_bytes
    assert isinstance(jeng.kv.prefix.k, jnp.ndarray)
