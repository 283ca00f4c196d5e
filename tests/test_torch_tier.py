"""The port's cluster KV tier and replica placement, against the JAX
package's (``tests/test_kv_tier.py`` is the model).

``repro_torch.serving.kv_tier`` keeps the reference's semantics:
refcounted pins, a byte-capacity LRU that evicts leaves first and skips
pinned pages, touch-free probes, ``tier_evict`` events; its payloads are
CPU torch tensors, or INT8 blobs quantized on the page's device.  The
tests hold:

  * the reference's tier unit cases, re-run on the port;
  * placement spec resolution on the CPU, and ``place_params`` keeping the
    tensors that already live on the target device;
  * cross-replica import inside the port on both backends: tier on equals
    tier off bit for bit (an fp tier), with no pin left;
  * a multi-replica drain with no refcount leak, a quantized import that
    is lossy and never republished (both backends), ``prefill_estimate``
    pricing an import as a transfer, ``tier_import`` / ``tier_evict`` on
    the bus and in the Prometheus text, ``realtime_swap`` stalls;
  * across frameworks: the same trace through two reference engines and
    two port engines, each pair sharing a tier, gives equal greedy tokens
    and tier stats, and the port's INT8 page payload equals the
    reference's ``quantize_kv_device`` codes within 1 (scales and zeros
    within 1e-6 relative).

Engines run the smoke granite config in float32 on the CPU.
"""
import dataclasses
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.core import predictor as jax_predictor  # noqa: E402
from repro.core import request as jax_request  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import kv_tier as jax_tier  # noqa: E402
from repro_torch.core import engine as port_engine  # noqa: E402
from repro_torch.core import predictor as port_predictor  # noqa: E402
from repro_torch.core import request as port_request  # noqa: E402
from repro_torch.distributed.placement import (  # noqa: E402
    assign_devices, available_devices, default_device_label, device_label,
    device_scope, place_params)
from repro_torch.models.model import Model, params_from_numpy  # noqa: E402
from repro_torch.serving import kv_tier as port_tier  # noqa: E402
from repro_torch.serving.kv_tier import HostKVTier  # noqa: E402
from repro_torch.serving.observability import (  # noqa: E402
    EventBus, render_prometheus, to_chrome_trace)

PAGE = 8


# ------------------------------------------------------------ tier units

def _page(seed: int, pg: int = 4, shape=None):
    g = torch.Generator().manual_seed(seed)
    shape = shape or (1, pg, 1, 2)             # (layers, page, heads, dim)
    return torch.randn(shape, generator=g), torch.randn(shape, generator=g)


def test_tier_publish_probe_acquire_release():
    tier = HostKVTier(1e6, page_size=4)
    toks = list(range(100, 112))               # 3 full pages
    fetched = []

    def fetch(i):
        fetched.append(i)
        return _page(i)

    assert tier.publish(toks, 12, fetch) == 3
    assert fetched == [0, 1, 2]
    assert tier.probe(toks) == 12
    assert tier.probe(toks, cap=7) == 4        # full-page floor under cap
    hit, nbytes = tier.probe_bytes(toks)
    assert hit == 12 and nbytes == tier.bytes > 0
    # probes touch nothing: the LRU order is the publish order
    assert tier.publish(toks, 12, fetch) == 0  # known prefix: no copy
    assert fetched == [0, 1, 2]

    h = tier.acquire(toks, 8)
    assert h is not None and h.tokens == 8 and not h.lossy
    assert tier.pinned_pages() == 2
    mats = h.materialize(torch.float32, "cpu")
    assert torch.equal(mats[0][0], _page(0)[0])
    assert torch.equal(mats[1][1], _page(1)[1])
    assert [m[0].dtype for m in h.materialize(torch.bfloat16)] == [
        torch.bfloat16] * 2
    h.release()
    h.release()                                # idempotent
    assert tier.pinned_pages() == 0
    assert tier.stats.imports == 1 and tier.stats.imported_pages == 2
    assert tier.stats.hit_bytes > 0
    g = tier.gauges()
    assert g["tier_pages"] == 3.0 and g["tier_imports_total"] == 1.0
    assert 0 < g["tier_utilization"] <= 1.0
    assert set(g) == set(jax_tier.HostKVTier(1e6, 4).gauges())
    assert tier.drop_all() == 3 and tier.bytes == 0


def test_tier_payload_is_a_host_copy():
    """A raw payload copies the page: writing the source afterwards (a
    pool page reused) leaves the tier's bytes unchanged."""
    tier = HostKVTier(1e6, page_size=4)
    k, v = _page(3)
    src = (k.clone(), v.clone())
    tier.publish(list(range(4)), 4, lambda i: src)
    src[0].zero_()
    h = tier.acquire(list(range(4)), 4)
    assert torch.equal(h.materialize(torch.float32)[0][0], k)
    h.release()


def test_tier_byte_cap_lru_skips_pinned():
    page_bytes = sum(t.numel() * t.element_size() for t in _page(0))
    tier = HostKVTier(2 * page_bytes, page_size=4)
    a = list(range(0, 8))
    tier.publish(a, 8, lambda i: _page(i))
    h = tier.acquire(a, 8)                     # pin both pages of A
    b = list(range(50, 58))
    tier.publish(b, 8, lambda i: _page(10 + i))
    # over capacity, but A's pinned pages must survive the eviction sweep
    assert tier.probe(a) == 8
    assert tier.pinned_pages() == 2
    assert tier.stats.evicted_pages >= 1
    assert tier.bytes <= tier.capacity_bytes
    h.release()
    c = list(range(70, 78))
    tier.publish(c, 8, lambda i: _page(20 + i))
    assert tier.bytes <= tier.capacity_bytes
    assert len(tier.entries) <= 2


def test_tier_under_concurrent_replicas():
    """Replicas' threads publish, probe, acquire and release on one
    byte-capped tier at once (more threads than cores, a short switch
    interval): no exception, every handle's payloads intact, the byte
    count equal to the entries' sum and within the cap once nothing is
    pinned, and no pin left."""
    import os
    import sys
    import threading
    page_bytes = sum(t.numel() * t.element_size() for t in _page(0))
    tier = HostKVTier(12 * page_bytes, page_size=4)
    prefixes = [[p] * 4 + list(range(100 * p, 100 * p + 12))
                for p in range(6)]
    errors = []

    def replica(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(60):
                toks = prefixes[int(rng.integers(len(prefixes)))]
                tier.publish(toks, 16, lambda i: _page(toks[0] * 10 + i))
                tier.probe(toks)
                tier.probe_bytes(toks)
                h = tier.acquire(toks, 16)
                if h is not None:
                    k0 = h.materialize(torch.float32)[0][0]
                    assert torch.equal(k0, _page(toks[0] * 10)[0])
                    h.release()
        except Exception as e:      # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=replica, args=(i,))
                   for i in range(2 * (os.cpu_count() or 2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert tier.pinned_pages() == 0
    tier.publish(list(range(900, 904)), 4, lambda i: _page(9))
    assert tier.bytes == sum(e.nbytes for e in tier.entries.values())
    assert tier.bytes <= tier.capacity_bytes
    assert tier.stats.imports > 0 and tier.stats.evicted_pages > 0
    assert len(tier.entries) == tier.index.n_pages


def test_tier_quantized_payloads_are_lossy_and_smaller():
    def big(i):                        # a realistic page: the scales'
        return _page(i, shape=(2, 4, 2, 32))   # overhead amortizes

    raw = HostKVTier(1e6, page_size=4)
    q8 = HostKVTier(1e6, page_size=4, quantize=True)
    toks = list(range(200, 208))
    for t in (raw, q8):
        t.publish(toks, 8, big)
    assert q8.bytes < raw.bytes
    h = q8.acquire(toks, 8)
    assert h.lossy and h.payloads[0][0] == "q8"
    k0 = h.materialize(torch.float32, "cpu")[0][0]
    assert (k0 - big(0)[0]).abs().max() < 0.1
    h.release()


def test_sim_tier_hit_floor_and_import_time():
    for mod in (jax_tier, port_tier):
        st = mod.SimKVTier(page_size=2, capacity_pages=4, swap_bw=100.0)
        toks = list(range(8))
        st.insert(toks, 8)
        # probe caps at len-1 (the final token is always computed), then
        # floors to full pages: 7 -> 6
        assert st.probe(toks) == 6 and st.probe(toks, cap=5) == 4
        assert st.hit(toks, cap=7) == 6
        assert st.imports == 1 and st.imported_tokens == 6
        assert st.import_time(4, bytes_per_token=50.0) == pytest.approx(2.0)


def test_q8_page_payload_matches_the_reference():
    """One page of (layers, page, KV heads, head dim) through both tiers'
    quantized publish: the port's INT8 codes within 1 of the reference's
    ``quantize_kv_device`` codes, its scales and zeros within 1e-6
    relative, one row per (token, head)."""
    shape = (3, PAGE, 2, 16)
    rng = np.random.default_rng(9)
    k = (rng.standard_normal(shape) * 3).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    toks = list(range(PAGE))
    ref = jax_tier.HostKVTier(1e6, PAGE, quantize=True)
    ref.publish(toks, PAGE, lambda i: (k, v))
    port = HostKVTier(1e6, PAGE, quantize=True)
    port.publish(toks, PAGE, lambda i: (torch.from_numpy(k),
                                        torch.from_numpy(v)))
    (_, rk, rv), = [e.payload for e in ref.entries.values()]
    (_, pk, pv), = [e.payload for e in port.entries.values()]
    for r, p in ((rk, pk), (rv, pv)):
        q, lam, z, shp = r
        assert tuple(p[3]) == tuple(shp) == shape
        assert p[0].shape == q.shape == (3 * PAGE * 2, 16)
        assert np.abs(p[0].numpy().astype(np.int32)
                      - np.asarray(q).astype(np.int32)).max() <= 1
        np.testing.assert_allclose(p[1].numpy(), np.asarray(lam),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(p[2].numpy(), np.asarray(z), rtol=1e-6,
                                   atol=0)
    assert port.bytes == ref.bytes


# ------------------------------------------------------------- placement

def test_placement_spec_resolution_on_the_cpu():
    cpu = torch.device("cpu")
    assert available_devices("cpu") == [cpu]
    assert available_devices("cpu:0") == [cpu]
    assert available_devices("cpu:0,cpu:0") == [cpu, cpu]
    assert device_label(cpu) == "cpu:0"
    assert device_label("cuda:1") == "cuda:1"
    assert assign_devices(3, "cpu") == [cpu] * 3
    if torch.cuda.is_available():
        return
    assert available_devices("0") == [cpu]
    assert default_device_label() == "cpu:0"
    for bad in ("nonsense", "tpu", "cuda", "1"):
        with pytest.raises(ValueError):
            available_devices(bad)
    for auto in (None, "auto"):                # no CUDA device here
        with pytest.raises(ValueError):
            available_devices(auto)


def test_place_params_keeps_tensors_on_their_device():
    w, b = torch.ones(2, 2), torch.zeros(2)
    tree = {"embed": w, "layers": [{"attn": {"b": b}}]}
    assert place_params(tree, None) is tree
    placed = place_params(tree, "cpu")
    assert placed["embed"] is w and placed["layers"][0]["attn"]["b"] is b
    assert place_params(w, torch.device("cpu", 0)) is w
    with device_scope("cpu"):
        assert torch.arange(3).device.type == "cpu"
    with device_scope(None):
        pass


# --------------------------------------------------- engine-level paths

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


_ENG = dict(max_slots=2, max_seq_len=160, max_new_tokens=8,
            strategy="alise", quantize_offload=False, prefill_chunk=6,
            page_size=PAGE, prefix_cache=True)


def _engine(setup, tier=None, jax_side=False, **kw):
    cfg, jmodel, jparams, model, tparams = setup
    opts = {**_ENG, **kw}
    if jax_side:
        eng = jax_engine.ServingEngine(
            jmodel, jparams, jax_engine.EngineConfig(**opts),
            predictor=jax_predictor.OraclePredictor())
    else:
        eng = port_engine.ServingEngine(
            model, tparams, port_engine.EngineConfig(**opts),
            predictor=port_predictor.OraclePredictor())
    if tier is not None:
        eng.attach_tier(tier)
    return eng


def _session(e0, e1, p1, follow, req_mod=port_request, out_len=6):
    """Turn 1 on e0; turn 2 (the whole conversation) re-routed to e1."""
    r1 = req_mod.Request(prompt_len=len(p1), arrival_time=0.0,
                         true_out_len=out_len, prompt_tokens=list(p1))
    e0.serve([r1])
    conv = list(p1) + list(r1.output_tokens) + list(follow)
    r2 = req_mod.Request(prompt_len=len(conv), arrival_time=0.0,
                         true_out_len=out_len, prompt_tokens=list(conv))
    e1.serve([r2])
    return [list(r1.output_tokens), list(r2.output_tokens)], conv


def _prompts(cfg, seed, n1=37, n2=5):
    rng = np.random.default_rng(seed)
    return (rng.integers(2, cfg.vocab_size, n1).tolist(),
            rng.integers(2, cfg.vocab_size, n2).tolist())


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_cross_replica_import_bit_identity(setup, backend):
    """A re-routed turn imports the peer's prefix through the shared fp
    tier, and the greedy tokens equal the tier-off run's bit for bit."""
    cfg = setup[0]
    p1, follow = _prompts(cfg, 1)

    def run(tier_on):
        port_request.reset_request_counter()
        tier = HostKVTier(64e6, page_size=PAGE) if tier_on else None
        e0 = _engine(setup, tier, kv_backend=backend)
        e1 = _engine(setup, tier, kv_backend=backend)
        outs, _ = _session(e0, e1, p1, follow)
        return outs, e1, tier

    ref, e1_off, _ = run(False)
    out, e1_on, tier = run(True)
    assert out == ref, "the shared KV tier changed greedy tokens"
    assert e1_off.kv.prefix_stats().hit_tokens == 0
    assert e1_on.kv.prefix_stats().hit_tokens > 0
    assert tier.stats.imports >= 1 and tier.stats.published_pages >= 4
    assert tier.pinned_pages() == 0, "import handles leaked pins"
    assert not e1_on._lossy_kv


def test_paged_tier_fill_writes_the_pool_in_place(setup):
    """``tier_fill`` lands the imported pages in the existing pool storage
    (captured step graphs hold its address), only past the local match,
    with each page owned by the index alone."""
    cfg = setup[0]
    p1, _ = _prompts(cfg, 2, n1=29)
    tier = HostKVTier(64e6, page_size=PAGE)
    e0 = _engine(setup, tier, kv_backend="paged")
    e1 = _engine(setup, tier, kv_backend="paged")
    port_request.reset_request_counter()
    e0.serve([port_request.Request(prompt_len=29, arrival_time=0.0,
                                   true_out_len=2, prompt_tokens=list(p1))])
    pool = e1.kv.pool
    ptrs = (pool.k.data_ptr(), pool.v.data_ptr())
    h = tier.acquire(p1, 24)
    assert e1.kv.tier_fill(p1, h) == 24
    h.release()
    assert (pool.k.data_ptr(), pool.v.data_ptr()) == ptrs
    pages = [n.page for n in e1.kv.prefix.index.match(p1, 24,
                                                      touch=False)[0]]
    src = [n.page for n in e0.kv.prefix.index.match(p1, 24,
                                                    touch=False)[0]]
    assert len(pages) == 3 and all(pool.refs[p] == 1 for p in pages)
    for a, b in zip(pages, src):
        assert torch.equal(pool.k[:, a], e0.kv.pool.k[:, b])
        assert torch.equal(pool.v[:, a], e0.kv.pool.v[:, b])
    h = tier.acquire(p1, 24)                   # already local: no pages
    free = len(pool.free_pages)
    assert e1.kv.tier_fill(p1, h) == 24 and len(pool.free_pages) == free
    h.release()


def test_multi_replica_drain_zero_refcount_leaks(setup):
    """Three replicas share one tier; sessions hop across them; a
    mid-flight drain on every replica leaves no page reference beyond the
    index's and no pinned tier page."""
    cfg = setup[0]
    tier = HostKVTier(64e6, page_size=PAGE)
    engs = [_engine(setup, tier, kv_backend="paged") for _ in range(3)]
    rng = np.random.default_rng(3)
    port_request.reset_request_counter()
    prompts = [rng.integers(2, cfg.vocab_size, 21).tolist()
               for _ in range(3)]
    for i, p in enumerate(prompts):            # publish from each replica
        engs[i].serve([port_request.Request(
            prompt_len=len(p), arrival_time=0.0, true_out_len=4,
            prompt_tokens=list(p))])
    live, t = [], 0.0
    for i, p in enumerate(prompts):            # each to the next replica
        r = port_request.Request(prompt_len=len(p), arrival_time=0.0,
                                 true_out_len=16, prompt_tokens=list(p))
        e = engs[(i + 1) % 3]
        e.submit(r, t)
        for _ in range(3):
            e.step(t)
            t += 0.1
        live.append(r)
    assert tier.stats.imports >= 1, "no cross-replica import happened"
    assert len([r for e in engs for r in e.drain()]) == len(live)
    for e in engs:
        pool = e.kv.pool
        assert not pool.page_table, pool.page_table
        index_pages = {n.page for n in e.kv.prefix.index.nodes}
        for page, refs in pool.refs.items():
            assert refs == 1 and (page == e.kv.scratch_page
                                  or page in index_pages), (page, refs)
        e.kv.prefix.drop_all()
        assert sorted(pool.free_pages + [e.kv.scratch_page]) \
            == list(range(pool.cfg.num_pages))
    assert tier.pinned_pages() == 0, "drain leaked tier pins"


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_quantized_tier_import_is_lossy_never_republished(setup, backend):
    """An INT8 tier: the importer is marked lossy, so its finish-time
    publish is suppressed and nothing derived from the import reaches the
    exact index or the tier."""
    cfg = setup[0]
    tier = HostKVTier(64e6, page_size=PAGE, quantize=True)
    p1, follow = _prompts(cfg, 4)
    port_request.reset_request_counter()
    e0 = _engine(setup, tier, kv_backend=backend)
    e1 = _engine(setup, tier, kv_backend=backend)
    published = []
    real = e1._publish
    e1._publish = lambda req, toks, t: published.append(req.req_id) or \
        real(req, toks, t)
    outs, conv2 = _session(e0, e1, p1, follow)
    assert tier.stats.imports >= 1 and len(outs[1]) > 0
    assert published == [], "a lossy importer published"
    full = conv2 + outs[1][:-1]
    assert e1.kv.prefix_probe(full) <= (len(conv2) // PAGE) * PAGE
    assert tier.probe(full) <= (len(conv2) // PAGE) * PAGE
    assert tier.pinned_pages() == 0 and not e1._lossy_kv


def test_prefill_estimate_prices_a_tier_import_as_a_transfer(setup):
    cfg = setup[0]
    tier = HostKVTier(64e6, page_size=PAGE)
    rng = np.random.default_rng(5)
    p1 = rng.integers(2, cfg.vocab_size, 64).tolist()
    port_request.reset_request_counter()
    e0 = _engine(setup, tier, kv_backend="paged")
    e0.serve([port_request.Request(prompt_len=64, arrival_time=0.0,
                                   true_out_len=4, prompt_tokens=list(p1))])
    e1 = _engine(setup, tier, kv_backend="paged", prefill_chunk=0)
    assert e1.prefix_probe(p1) == 0            # locally cold
    assert tier.probe(p1, len(p1) - 1) > 0     # cluster-hot
    cold = rng.integers(2, cfg.vocab_size, 64).tolist()
    assert e1.prefill_estimate(64, p1) < e1.prefill_estimate(64, cold)
    assert e1.prefill_estimate(64, cold) == pytest.approx(
        e1.prefill_estimate(64))
    hit, nbytes = tier.probe_bytes(p1, 63)
    assert e1.prefill_estimate(64, p1) == pytest.approx(
        nbytes / e1.cfg.swap_bw
        + e1.latency.prefill_chunk_time(hit, 64 - hit))


def test_tier_events_gauges_and_prometheus(setup):
    cfg = setup[0]
    tier = HostKVTier(64e6, page_size=PAGE)
    bus = EventBus(clock="virtual")
    p1, follow = _prompts(cfg, 6)
    port_request.reset_request_counter()
    e0 = _engine(setup, tier, kv_backend="paged")
    e1 = _engine(setup, tier, kv_backend="paged")
    e0.attach_bus(bus, "engine0")
    e1.attach_bus(bus, "engine1")
    assert tier.bus is bus                     # the first replica wires it
    _session(e0, e1, p1, follow)
    imports = [ev for ev in bus.snapshot() if ev.kind == "tier_import"]
    assert imports and imports[0].replica == "engine1"
    assert imports[0].data["tokens"] > 0 and imports[0].data["bytes"] > 0
    g = e1.gauges()
    assert g["tier_imports_total"] >= 1.0
    assert g["tier_pages"] > 0 and g["tier_bytes"] > 0
    assert g["tier_dma_imports_total"] >= 1.0
    bus.gauge(g, replica="engine1", t=1.0)
    names = {ev["name"] for ev in to_chrome_trace(bus)["traceEvents"]}
    assert "tier_import" in names
    text = render_prometheus(bus)
    assert "alise_tier_bytes" in text and 'kind="tier_import"' in text
    small = HostKVTier(2 * 2 * PAGE * 2 * 4, page_size=PAGE)
    small.bus = bus
    toks = list(range(48))
    small.publish(toks, 48, lambda i: _page(i, pg=PAGE))
    assert small.stats.evicted_pages >= 1
    assert 'kind="tier_evict"' in render_prometheus(bus)


def test_realtime_swap_adds_stall_time(setup):
    """``realtime_swap`` charges a swap and a tier import their modeled
    transfer time (less the copy's own), and ``step`` sleeps it off after
    releasing ``step_lock``; off, nothing is charged.  The copies are timed
    here around the calls, so the bounds hold however loaded the host is:
    the debt lies between the modeled time less those walls and the
    modeled time (a missing charge falls below, a double one above), and
    the bandwidth is low enough that the modeled time dwarfs a copy."""
    cfg = setup[0]
    bw = 5e4
    p1, _ = _prompts(cfg, 7, n1=30)

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t0

    for on in (False, True):
        port_request.reset_request_counter()
        eng = _engine(setup, kv_backend="paged", realtime_swap=on,
                      swap_bw=bw)
        r = port_request.Request(prompt_len=30, arrival_time=0.0,
                                 true_out_len=8, prompt_tokens=list(p1))
        eng.submit(r, 0.0)
        eng.step(0.0)
        _, wall_off = timed(eng._offload, r)
        n = eng.host_pool[r.req_id]["lengths"]
        debt = eng._stall_debt
        _, wall_up = timed(eng._upload, r)
        assert n > 0
        assert (debt > 0) == on and (eng._stall_debt > debt) == on
        one = n * eng.mem.cfg.bytes_per_token_fp / bw
        if on:
            assert one - wall_off <= debt <= one
            assert 2 * one - wall_off - wall_up <= eng._stall_debt <= 2 * one
        owed = eng._stall_debt
        t0 = time.perf_counter()
        eng.step(0.1)
        assert eng._stall_debt == 0.0
        assert time.perf_counter() - t0 >= owed
    tier = HostKVTier(64e6, page_size=PAGE)
    e0 = _engine(setup, tier, kv_backend="paged")
    e0.serve([port_request.Request(prompt_len=30, arrival_time=0.0,
                                   true_out_len=2, prompt_tokens=list(p1))])
    e1 = _engine(setup, tier, kv_backend="paged", realtime_swap=True,
                 swap_bw=bw)
    got, wall = timed(e1._tier_import, 99, p1, 0.0)
    assert got == 24
    want = tier.probe_bytes(p1, 29)[1] / bw
    assert want - wall <= e1._stall_debt <= want


# ---------------------------------------------------- across frameworks

@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_tier_engines_match_the_jax_engines(setup, backend):
    """Two replicas sharing an fp tier in each framework, on the same
    sessions (each turn re-routed to the other replica): equal greedy
    tokens and equal tier stats."""
    cfg = setup[0]
    sessions = [_prompts(cfg, s) for s in (11, 12)]

    def run(jax_side):
        mod = jax_tier if jax_side else port_tier
        req = jax_request if jax_side else port_request
        req.reset_request_counter()
        tier = mod.HostKVTier(64e6, page_size=PAGE)
        engs = [_engine(setup, tier, jax_side=jax_side, kv_backend=backend)
                for _ in range(2)]
        outs = [_session(engs[i % 2], engs[(i + 1) % 2], p, f, req)[0]
                for i, (p, f) in enumerate(sessions)]
        st = tier.stats.as_dict()
        return outs, {k: st[k] for k in ("publishes", "published_pages",
                                         "imports", "imported_pages")}

    port = run(False)
    assert port == run(True)
    assert port[1]["imports"] >= 2


# ------------------------------------------------------ core/quantization

@pytest.mark.parametrize("bits,axis", [(8, -1), (8, 0), (4, -1)])
def test_quantization_equals_the_reference(bits, axis):
    """``core/quantization``'s torch rewrite against the JAX functions on
    the same float32 input: codes equal, scales and zeros within 1e-6
    relative, the dequantized values within 1e-6 relative of the largest;
    the numpy twins are copies and agree exactly."""
    import jax.numpy as jnp
    from repro.core import quantization as ref_q
    from repro_torch.core import quantization as port_q
    x = (np.random.default_rng(bits).standard_normal((6, 5, 16)) * 3
         ).astype(np.float32)
    rq = ref_q.quantize(jnp.asarray(x), bits=bits, axis=axis)
    pq = port_q.quantize(torch.from_numpy(x), bits=bits, axis=axis)
    assert pq.q.dtype == torch.int8 and pq.nbytes == rq.nbytes
    assert np.array_equal(pq.q.numpy(), np.asarray(rq.q))
    np.testing.assert_allclose(pq.scale.numpy(), np.asarray(rq.scale),
                               rtol=1e-6)
    np.testing.assert_allclose(pq.zero.numpy(), np.asarray(rq.zero),
                               rtol=1e-6)
    rd = np.asarray(ref_q.dequantize(rq, jnp.float32))
    pd = port_q.dequantize(pq, torch.float32).numpy()
    assert np.abs(pd - rd).max() <= 1e-6 * np.abs(rd).max()
    assert port_q.roundtrip_rel_error(torch.from_numpy(x), bits, axis) == \
        pytest.approx(ref_q.roundtrip_rel_error(jnp.asarray(x), bits, axis),
                      rel=1e-5)
    for a, b in zip(port_q.quantize_np(x, bits, axis),
                    ref_q.quantize_np(x, bits, axis)):
        assert np.array_equal(a, b)
    q8, lam, z = ref_q.quantize_np(x, bits, axis)
    assert np.array_equal(port_q.dequantize_np(q8, lam, z, bits),
                          ref_q.dequantize_np(q8, lam, z, bits))
