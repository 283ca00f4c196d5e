"""Packed prefill in the port, against the JAX package.

``Model.paged_prefill_pack`` / ``Model.prefill_pack`` run N requests'
chunks as the rows of one call.  On the same inputs (a pool or a cache
with earlier chunks' K/V, mixed starts, ragged chunk lengths and a padding
row of length 0) their logits and the K/V they write must match the JAX
``Model``'s within 2e-5 (float32, smoke config).  Against the port's own
single chunks run one by one, the K/V must be equal bit for bit and the
logits within 2e-5: the head's product over one row (a matrix-vector
product on the CPU) sums in another order than over N rows.  The engine packs
equal-bucket chunks when ``prefill_pack`` is set: its greedy tokens must
equal the JAX engine's with packing on, and its own with packing off, on
both KV backends (as ``tests/test_prefill_buckets.py`` holds for the JAX
engine), and a warmed engine serves packs without a new graph key.
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
from repro_torch.core import engine as port_engine  # noqa: E402
from repro_torch.core import predictor as port_predictor  # noqa: E402
from repro_torch.core import request as port_request  # noqa: E402
from repro_torch.core.quantization import kv_bytes_per_token  # noqa: E402
from repro_torch.models.model import Model, params_from_numpy  # noqa: E402
from repro_torch.utils.compile_counter import CompileCounter  # noqa: E402

TOL = 2e-5
PAGE = 8
CB = 8                                 # the pack's bucket
# rows: (start, chunk length); the last row is pack padding
PAGED_ROWS = ((0, 8), (8, 5), (21, 7), (0, 0))
DENSE_ROWS = ((0, 8), (8, 5), (57, 7), (0, 0))   # row 2 reaches Smax


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


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _kv_shape(cfg, n):
    return (cfg.num_layers, n, PAGE, cfg.num_kv_heads, cfg.hd)


def _paged_inputs(cfg, rng):
    """A pool of 40 pages (page 39 the scratch) holding earlier chunks'
    K/V, and one pack's staged arrays: each member's pages run
    consecutively from page 4 * member."""
    N, maxp, scratch = len(PAGED_ROWS), 8, 39
    k = rng.standard_normal(_kv_shape(cfg, 40)).astype(np.float32)
    v = rng.standard_normal(_kv_shape(cfg, 40)).astype(np.float32)
    toks = np.zeros((N, CB), np.int32)
    tables = np.full((N, maxp), scratch, np.int32)
    wp = np.full((N, CB), scratch, np.int32)
    wo = np.tile(np.arange(CB, dtype=np.int32) % PAGE, (N, 1))
    tabs = []
    for i, (start, n) in enumerate(PAGED_ROWS):
        pt = list(range(4 * i, 4 * i + -(-(start + n) // PAGE))) if n else []
        tabs.append(pt)
        toks[i, :n] = rng.integers(2, cfg.vocab_size, n)
        tables[i, :len(pt)] = pt
        for j in range(n):
            wp[i, j] = pt[(start + j) // PAGE]
            wo[i, j] = (start + j) % PAGE
    starts = np.array([s for s, _ in PAGED_ROWS], np.int32)
    lens = np.array([n for _, n in PAGED_ROWS], np.int32)
    return k, v, toks, tables, wp, wo, starts, lens, tabs


def test_paged_pack_matches_the_jax_model(setup):
    cfg, jmodel, jparams, model, tparams = setup
    rng = np.random.default_rng(0)
    k, v, toks, tables, wp, wo, starts, lens, _ = _paged_inputs(cfg, rng)
    jl, jkv = jmodel.paged_prefill_pack(
        jparams, {"k": jnp.asarray(k), "v": jnp.asarray(v)},
        jnp.asarray(toks), jnp.asarray(tables), jnp.asarray(wp),
        jnp.asarray(wo), jnp.asarray(starts), jnp.asarray(lens))
    kv = {"k": _t(k), "v": _t(v)}
    logits = model.paged_prefill_pack(tparams, kv, _t(toks), _t(tables),
                                      _t(wp), _t(wo), _t(starts), _t(lens))
    assert logits.shape == (4, cfg.vocab_size)
    np.testing.assert_allclose(logits[:3].numpy(), np.asarray(jl)[:3],
                               rtol=TOL, atol=TOL)
    for key in ("k", "v"):              # every page but the scratch page
        np.testing.assert_allclose(kv[key][:, :39].numpy(),
                                   np.asarray(jkv[key])[:, :39],
                                   rtol=TOL, atol=TOL)


def test_paged_pack_equals_its_single_chunks(setup):
    """Each member through ``paged_prefill_chunk`` alone, on a copy of
    the pool: the same pages bit for bit, the logits within 2e-5."""
    cfg, _, _, model, tparams = setup
    rng = np.random.default_rng(1)
    k, v, toks, tables, wp, wo, starts, lens, _ = _paged_inputs(cfg, rng)
    packed = {"k": _t(k), "v": _t(v)}
    logits = model.paged_prefill_pack(tparams, packed, _t(toks), _t(tables),
                                      _t(wp), _t(wo), _t(starts), _t(lens))
    single = {"k": _t(k), "v": _t(v)}
    for i in range(3):
        row = model.paged_prefill_chunk(
            tparams, single, _t(toks[i:i + 1]), _t(tables[i:i + 1]),
            _t(wp[i]), _t(wo[i]), int(starts[i]), int(lens[i]))
        torch.testing.assert_close(row[0], logits[i], rtol=TOL, atol=TOL)
    for key in ("k", "v"):
        assert torch.equal(packed[key][:, :39], single[key][:, :39])


def _dense_inputs(cfg, rng, lanes=(3, 0, 4)):
    Smax, n_lanes = 64, 5
    shape = (cfg.num_layers, n_lanes, Smax, cfg.num_kv_heads, cfg.hd)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    N = len(DENSE_ROWS)
    toks = np.zeros((N, CB), np.int32)
    for i, (_, n) in enumerate(DENSE_ROWS):
        toks[i, :n] = rng.integers(2, cfg.vocab_size, n)
    lane = np.array(list(lanes) + [lanes[0]], np.int32)   # padding: row 0's
    starts = np.array([s for s, _ in DENSE_ROWS], np.int32)
    lens = np.array([n for _, n in DENSE_ROWS], np.int32)
    return k, v, lane, toks, starts, lens


def test_dense_pack_matches_the_jax_model(setup):
    """The reference packs gathered stripes and scatters the members'
    back (its padding row's write is dropped out of range); the port
    gathers per layer and masks the padding row's write-back."""
    cfg, jmodel, jparams, model, tparams = setup
    rng = np.random.default_rng(2)
    k, v, lane, toks, starts, lens = _dense_inputs(cfg, rng)
    jl, jk, jv = jmodel.prefill_pack(
        jparams, jnp.asarray(k[:, lane]), jnp.asarray(v[:, lane]),
        jnp.asarray(toks), jnp.asarray(starts), jnp.asarray(lens))
    want = {"k": k.copy(), "v": v.copy()}
    for i in range(3):
        want["k"][:, lane[i]] = np.asarray(jk)[:, i]
        want["v"][:, lane[i]] = np.asarray(jv)[:, i]
    kc, vc = _t(k), _t(v)
    logits = model.prefill_pack(tparams, kc, vc, _t(lane), _t(toks),
                                _t(starts), _t(lens))
    np.testing.assert_allclose(logits[:3].numpy(), np.asarray(jl)[:3],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(kc.numpy(), want["k"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(vc.numpy(), want["v"], rtol=TOL, atol=TOL)
    for other in (1, 2):                # lanes outside the pack: untouched
        assert torch.equal(kc[:, other], _t(k[:, other]))


def test_dense_pack_equals_its_single_chunks(setup):
    cfg, _, _, model, tparams = setup
    rng = np.random.default_rng(3)
    k, v, lane, toks, starts, lens = _dense_inputs(cfg, rng)
    kc, vc = _t(k), _t(v)
    logits = model.prefill_pack(tparams, kc, vc, _t(lane), _t(toks),
                                _t(starts), _t(lens))
    ks, vs = _t(k), _t(v)
    for i in range(3):
        row = model.prefill_chunk(tparams, ks[:, lane[i]], vs[:, lane[i]],
                                  _t(toks[i:i + 1]), int(starts[i]),
                                  int(lens[i]))
        torch.testing.assert_close(row[0], logits[i], rtol=TOL, atol=TOL)
    assert torch.equal(kc, ks) and torch.equal(vc, vs)


def test_dense_pack_of_padding_only_writes_nothing(setup):
    """A pack whose rows all start at Smax (the neutral input a graph is
    captured on) leaves the cache as it was."""
    cfg, _, _, model, tparams = setup
    k, v, _, toks, _, _ = _dense_inputs(cfg, np.random.default_rng(4))
    kc, vc = _t(k), _t(v)
    model.prefill_pack(tparams, kc, vc, torch.zeros(4, dtype=torch.int32),
                       _t(toks), torch.full((4,), 64, dtype=torch.int32),
                       torch.zeros(4, dtype=torch.int32))
    assert torch.equal(kc, _t(k)) and torch.equal(vc, _t(v))


# ------------------------------------------------------------ the engine

# mixed lengths: 3 < the smallest bucket; 17 and 23 take two chunks
PROMPTS = (3, 8, 9, 15, 17, 23, 5, 12)
OUTS = (6, 6, 4, 4, 4, 3, 6, 4)


def _serve(eng, cfg, req_mod, prompts=PROMPTS, outs=OUTS, staged=False):
    """Serve on a virtual clock (all at t = 0, or with ``staged`` two
    requests first and the rest 0.2 s later); returns the greedy
    tokens."""
    req_mod.reset_request_counter()
    rng = np.random.default_rng(3)
    reqs = [req_mod.Request(prompt_len=p, arrival_time=0.0, true_out_len=o,
                            prompt_tokens=rng.integers(
                                2, cfg.vocab_size, p).tolist())
            for p, o in zip(prompts, outs)]
    t = 0.0
    first = reqs[:2] if staged else reqs
    for r in first:
        eng.submit(r, t)
    for i in range(800):
        if staged and i == 2:
            for r in reqs[2:]:
                eng.submit(r, t)
        if i > 2 and not eng.sched.live:
            break
        eng.step(t)
        t += 0.1
    assert not eng.sched.live and all(r.done for r in reqs)
    return [list(r.output_tokens) for r in reqs], reqs


def _packs(eng):
    """The member counts of the engine's packs (prefill entries of more
    than one row)."""
    return [m for _, _, _, m in eng.prefill_times if m > 1]


def _kw(backend, **extra):
    kw = dict(max_slots=4, max_seq_len=64, max_new_tokens=16,
              strategy="alise", quantize_offload=False, kv_backend=backend,
              prefill_chunk=16, iter_token_budget=48)
    if backend == "paged":
        kw["page_size"] = PAGE
    kw.update(extra)
    return kw


def _port(setup, **kw):
    _, _, _, model, tparams = setup
    return port_engine.ServingEngine(
        model, tparams, port_engine.EngineConfig(**kw),
        predictor=port_predictor.OraclePredictor())


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_packed_engine_matches_the_jax_engine(setup, backend):
    cfg, jmodel, jparams, _, _ = setup
    kw = _kw(backend, prefill_pack=True, prefill_buckets=(16,))
    eng = _port(setup, **kw)
    got, _ = _serve(eng, cfg, port_request)
    assert _packs(eng), "no pack ran"
    jeng = jax_engine.ServingEngine(jmodel, jparams,
                                    jax_engine.EngineConfig(**kw),
                                    predictor=jax_predictor.OraclePredictor())
    want, _ = _serve(jeng, cfg, jax_request)
    assert got == want


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_packed_vs_unpacked_bit_identity(setup, backend):
    cfg = setup[0]
    plain, _ = _serve(_port(setup, **_kw(backend)), cfg, port_request)
    eng = _port(setup, **_kw(backend, prefill_pack=True))
    packed, _ = _serve(eng, cfg, port_request)
    assert packed == plain
    assert _packs(eng) and all(2 <= m <= 4 for m in _packs(eng))
    assert eng._buckets == port_engine.default_bucket_menu(16)


def test_pack_members_preempted_mid_prefill(setup):
    """Two long prompts start prefilling, then short ones arrive under a
    tight KV budget: residents are swapped out mid-prefill and resume
    their chunks, through packs, to the unpacked run's tokens."""
    cfg = setup[0]
    bpt = kv_bytes_per_token(cfg.num_layers, cfg.num_kv_heads, cfg.hd)
    kw = dict(max_slots=2, max_seq_len=64, max_new_tokens=48,
              strategy="alise", quantize_offload=False, prefill_chunk=8,
              iter_token_budget=16, hbm_bytes=2 * 55 * bpt)
    args = dict(prompts=(23, 23, 9, 9, 9, 9), outs=(40, 40, 3, 3, 3, 3),
                staged=True)
    plain, _ = _serve(_port(setup, **kw), cfg, port_request, **args)
    packed, reqs = _serve(_port(setup, prefill_pack=True, **kw), cfg,
                          port_request, **args)
    assert packed == plain
    assert sum(r.preempt_count for r in reqs) > 0


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_zero_compiles_after_warmup_with_packs_and_prefix_cache(setup,
                                                                backend):
    """The compile gate: a warmed engine with packing and the prefix cache
    serves a mixed trace (chunks, packs, hits, decode) with no new graph
    key.  Warmup makes one pack key per bucket."""
    cfg = setup[0]
    eng = _port(setup, **_kw(backend, prefill_pack=True, prefix_cache=True,
                             warmup_compile=True))
    w = eng.warm_stats
    lanes = 4 if backend == "dense" else 1
    assert w["keys"] == w["compiles"] == 1 + 2 * lanes + 2
    counter = CompileCounter().require()
    with counter.expect_no_compiles(f"serve[{backend}]"):
        _serve(eng, cfg, port_request)
    counter.detach()
    assert _packs(eng) and len(eng.kv.graphs) == w["keys"]


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_backend_pack_checks_its_members(setup, backend):
    eng = _port(setup, **_kw(backend, prefill_pack=True))
    params = eng.params
    with pytest.raises(ValueError, match="width"):
        eng.kv.prefill_pack(params, [(i, [2], 0) for i in range(5)], 8)
    with pytest.raises(ValueError, match="bucket"):
        eng.kv.prefill_pack(params, [(0, [2] * 9, 0)], 8)
    out = eng.kv.prefill_pack(params, [(0, [2, 3], 0), (1, [4], 0)], 8)
    assert out.shape == (2, setup[0].vocab_size)
    assert eng.kv.slot_of(0) is not None and eng.kv.slot_of(1) is not None
