"""The port's speculative (verify-k) decoding against the JAX package, and
its invariants inside the port.

The draft sources and ``verify_and_reason`` must give exactly what the
reference's give; ``decode_verify`` and ``paged_decode_verify`` must give
the reference's logits (atol 1e-4) and write its K/V rows (atol 1e-5),
the tolerances of ``tests/test_torch_model.py``, with two differences by
design: a dense lane's positions at or past Smax are dropped explicitly
(the reference's scatter drops them silently) and an inactive lane writes
nothing.  Engines serve on one virtual clock (``submit``/``step``), the
model is ``get_smoke_config("granite-3-8b")`` in float32 with a float32
KV cache, and greedy tokens must equal the JAX engine's, and, inside the
port, spec on must equal spec off and real drafts no drafts, bit for bit.
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
from repro.serving import draft as jax_draft  # noqa: E402
from repro.serving import prefix_cache as jax_prefix  # noqa: E402
from repro.serving import sampler as jax_sampler  # noqa: E402
from repro_torch.core import engine as port_engine  # noqa: E402
from repro_torch.core import predictor as port_predictor  # noqa: E402
from repro_torch.core import request as port_request  # noqa: E402
from repro_torch.models.model import Model, params_from_numpy  # noqa: E402
from repro_torch.serving import draft as port_draft  # noqa: E402
from repro_torch.serving import prefix_cache as port_prefix  # noqa: E402
from repro_torch.serving import sampler as port_sampler  # noqa: E402
from repro_torch.utils.compile_counter import CompileCounter  # noqa: E402

PAGE = 8
BACKENDS = [dict(kv_backend="dense"),
            dict(kv_backend="paged", page_size=PAGE)]
BACKEND_IDS = ["dense", "paged"]


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


# ----------------------------------------------------------- draft sources

def test_ngram_drafts_match_reference():
    """On seeded random streams over a small vocabulary (so n-grams
    repeat), grown one token at a time, the port's n-gram source proposes
    exactly what the reference's does, for each n range and k."""
    rng = np.random.default_rng(0)
    for max_n, min_n in ((3, 1), (2, 2), (1, 1)):
        ref = jax_draft.NGramDraftSource(max_n=max_n, min_n=min_n)
        port = port_draft.NGramDraftSource(max_n=max_n, min_n=min_n)
        for rid in range(3):
            stream = rng.integers(0, 5, 48).tolist()
            for n in range(len(stream) + 1):
                for k in (1, 3, 4):
                    assert (port.propose(rid, stream[:n], k)
                            == ref.propose(rid, stream[:n], k)), (max_n, n)
            ref.release(rid)
            port.release(rid)
            assert not port._state
        # a stream that restarts shorter (request id reuse) re-indexes
        for src in (ref, port):
            src.propose(7, [1, 2, 1, 2, 1], 2)
        assert port.propose(7, [1, 2], 2) == ref.propose(7, [1, 2], 2)
    with pytest.raises(ValueError):
        port_draft.NGramDraftSource(max_n=1, min_n=2)


def test_radix_and_chain_drafts_match_reference():
    """Both frameworks' radix indexes publish the same sequences (shared
    prefixes, page-aligned and mid-page ends); every prefix of each, and
    divergent probes, get the same radix and chain proposals, and
    ``make_draft_source`` builds the same stack."""
    rng = np.random.default_rng(1)
    base = rng.integers(2, 50, 24).tolist()
    seqs = [base, base[:12] + rng.integers(2, 50, 12).tolist(),
            rng.integers(2, 50, 20).tolist()]
    ridx = jax_prefix.RadixPageIndex(page_size=4)
    pidx = port_prefix.RadixPageIndex(page_size=4)
    for i, seq in enumerate(seqs):
        upto = len(seq) - (i % 2) * 3
        for idx in (ridx, pidx):
            idx.insert(seq, upto, page_of=lambda j, i=i: 100 * i + j)
    ref = jax_draft.make_draft_source(ridx)
    port = port_draft.make_draft_source(pidx)
    assert isinstance(port, port_draft.ChainDraftSource)
    assert isinstance(port_draft.make_draft_source(None),
                      port_draft.NGramDraftSource)
    rradix, pradix = (jax_draft.RadixDraftSource(ridx),
                      port_draft.RadixDraftSource(pidx))
    probes = [seq[:n] for seq in seqs for n in range(len(seq) + 1)]
    probes += [seq[:n] + [1] for seq in seqs for n in (3, 4, 9)]
    proposed = 0
    for toks in probes:
        for k in (1, 3):
            got = pradix.propose(0, toks, k)
            assert got == rradix.propose(0, toks, k), toks
            assert port.propose(0, toks, k) == ref.propose(0, toks, k)
            proposed += bool(got)
    assert proposed > 20
    assert port_draft.RadixDraftSource(None).propose(0, base, 3) == []


# -------------------------------------------------------- verify_and_reason

def test_verify_and_reason_matches_reference():
    """Greedy, on the same logits and drafts, the port's samples, emit
    counts and reasons equal the reference's exactly, lane by lane: no
    drafts; all drafts accepted; an EOS inside an accepted run; the
    length, ctx and true_len limits; a partial acceptance; an inactive
    lane."""
    B, K1, V, eos = 8, 4, 32, 1
    max_new, max_seq = 40, 64
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((B, K1, V)).astype(np.float32)
    logits[..., eos] -= 10.0                   # no EOS unless put there
    logits[2, 1, eos] = 50.0                   # lane 2: EOS at position 1
    s = logits.argmax(-1)
    drafts = rng.integers(2, V, (B, K1)).astype(np.int32)
    drafts[:, 1:] = s[:, :-1]                  # every draft right ...
    drafts[7, 2] = (s[7, 1] + 1) % V           # ... but lane 7's second
    n_drafts = np.full((B,), 3, np.int32)
    n_drafts[0] = 0                            # lane 0: no drafts
    base_gen = np.full((B,), 5, np.int32)
    base_ctx = np.full((B,), 20, np.int32)
    true_len = np.full((B,), 1000, np.int32)
    base_gen[3] = max_new - 2                  # lane 3: length at pos 1
    base_ctx[4] = max_seq - 3                  # lane 4: ctx at pos 1
    true_len[6] = base_gen[6] + 3              # lane 6: true_len at pos 2
    active = np.ones((B,), bool)
    active[5] = False
    kw = dict(greedy_sampling=True, temp=1.0, top_k=0, eos_token=eos,
              max_new_tokens=max_new, max_seq_len=max_seq)
    rs, rn, rr = jax_sampler.verify_and_reason(
        jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(n_drafts),
        None, jnp.asarray(active), base_gen=jnp.asarray(base_gen),
        base_ctx=jnp.asarray(base_ctx), true_len=jnp.asarray(true_len), **kw)
    t = torch.from_numpy
    ps, pn, pr = port_sampler.verify_and_reason(
        t(logits), t(drafts), t(n_drafts), t(np.arange(B, dtype=np.int32)),
        t(active), base_gen=t(base_gen), base_ctx=t(base_ctx),
        true_len=t(true_len), seed=0, **kw)
    assert ps.dtype == pn.dtype == pr.dtype == torch.int32
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(rn))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(rr))
    R = port_sampler
    assert pn.tolist() == [1, 4, 2, 2, 2, 0, 3, 2]
    assert pr.tolist() == [0, 0, R.REASON_EOS, R.REASON_LENGTH,
                           R.REASON_CTX, 0, R.REASON_TRUE_LEN, 0]


def test_verify_samples_use_the_decode_steps_draws():
    """With temperature, position i of a lane draws as the fused decode
    step draws the token at generation index base_gen + i, so one token
    gets one draw on every path."""
    B, K1, V = 3, 4, 64
    g = torch.Generator().manual_seed(3)
    logits = torch.randn((B, K1, V), generator=g)
    rids = torch.tensor([4, 9, 2], dtype=torch.int32)
    base_gen = torch.tensor([0, 7, 30], dtype=torch.int32)
    kw = dict(greedy_sampling=False, seed=5, temp=0.8, top_k=16)
    s, _, _ = port_sampler.verify_and_reason(
        logits, torch.zeros((B, K1), dtype=torch.int32),
        torch.zeros((B,), dtype=torch.int32), rids,
        torch.ones((B,), dtype=torch.bool), eos_token=-1, max_new_tokens=99,
        max_seq_len=999, base_gen=base_gen,
        base_ctx=torch.zeros((B,), dtype=torch.int32),
        true_len=torch.full((B,), 999, dtype=torch.int32), **kw)
    for i in range(K1):
        want = port_sampler.sample_tokens(logits[:, i], rids, base_gen + i,
                                          **kw)
        assert torch.equal(s[:, i], want)


# ---------------------------------------------------- the model's verify

def _kv_rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_decode_verify_matches_reference(setup):
    """Dense verify: the logits of every active lane and position within
    1e-4 of the reference's, its written stripes within 1e-5.  Lane 1 sits
    two tokens from Smax: its positions Smax and Smax + 1 are dropped, as
    the reference's scatter drops them.  Lane 2 is inactive: its stripe is
    untouched.  The sampled form accepts the same drafts and advances
    ``lengths`` by ``n_emit``."""
    cfg, jmodel, jparams, tmodel, tparams = setup
    B, K1, Smax = 4, 4, 32
    rng = np.random.default_rng(4)
    shape = (cfg.num_layers, B, Smax, cfg.num_kv_heads, cfg.hd)
    k0, v0 = _kv_rand(rng, shape), _kv_rand(rng, shape)
    lengths = np.array([5, Smax - 2, 12, 17], np.int32)
    active = np.array([True, True, False, True])
    tokens = rng.integers(2, cfg.vocab_size, (B, K1)).astype(np.int32)

    def port_cache():
        return {"k": torch.from_numpy(k0.copy()),
                "v": torch.from_numpy(v0.copy()),
                "lengths": torch.from_numpy(lengths.copy())}
    jcache = {"k": jnp.asarray(k0), "v": jnp.asarray(v0),
              "lengths": jnp.asarray(lengths)}
    rlog, rnew = jmodel.decode_verify(jparams, jcache, jnp.asarray(tokens))
    cache = port_cache()
    plog = tmodel.decode_verify(tparams, cache, torch.from_numpy(tokens),
                                torch.from_numpy(active))
    assert plog.shape == (B, K1, cfg.vocab_size) and plog.dtype == \
        torch.float32
    np.testing.assert_allclose(plog.numpy()[active], np.asarray(rlog)[active],
                               atol=1e-4, rtol=0)
    for key, init in (("k", k0), ("v", v0)):
        got, want = cache[key].numpy(), np.asarray(rnew[key])
        np.testing.assert_allclose(got[:, active], want[:, active],
                                   atol=1e-5, rtol=0)
        np.testing.assert_array_equal(got[:, 2], init[:, 2])
        # the reference dropped lane 1's two positions past Smax too
        np.testing.assert_array_equal(want[:, 1, :Smax - 2],
                                      init[:, 1, :Smax - 2])
    assert cache["lengths"].tolist() == lengths.tolist()

    # the sampled form: drafts are each lane's greedy continuation, from
    # sequential decode steps on a copy of the cache
    drafts = tokens.copy()
    seq = port_cache()
    for i in range(1, K1):
        step = tmodel.decode_step(tparams, seq,
                                  torch.from_numpy(drafts[:, i - 1:i]))
        drafts[:, i] = step.argmax(-1).numpy()
    n_drafts = np.array([3, 3, 3, 1], np.int32)
    base_gen = np.array([1, 4, 2, 3], np.int32)
    base_ctx = lengths + 1
    true_len = np.full((B,), 1000, np.int32)
    rids = np.arange(B, dtype=np.int32)
    kw = dict(greedy_sampling=True, eos_token=-1, max_new_tokens=100,
              max_seq_len=Smax)
    rs, rn, rr, rc = jmodel.decode_verify_sampled(
        jparams, jcache, jnp.asarray(drafts), jnp.asarray(n_drafts),
        jnp.asarray(active), jnp.asarray(base_gen), jnp.asarray(base_ctx),
        jnp.asarray(true_len), jnp.asarray(rids), jax.random.PRNGKey(0),
        **kw)
    cache = port_cache()
    t = torch.from_numpy
    ps, pn, pr = tmodel.decode_verify_sampled(
        tparams, cache, t(drafts), t(n_drafts), t(active), t(base_gen),
        t(base_ctx), t(true_len), t(rids), **kw)
    np.testing.assert_array_equal(ps.numpy()[active], np.asarray(rs)[active])
    np.testing.assert_array_equal(pn.numpy(), np.asarray(rn))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(rr))
    assert pn.tolist() == [4, 1, 0, 2]
    assert pr.tolist() == [0, port_sampler.REASON_CTX, 0, 0]
    assert cache["lengths"].tolist() == np.asarray(rc["lengths"]).tolist()


def test_paged_decode_verify_matches_reference(setup):
    """Paged verify at host-made destinations: lane 0's span crosses from
    its last page into its scratch page (appended to its table), lane 1's
    stays inside a page, lane 2 is inactive (the shared scratch page).
    Logits of the active lanes within 1e-4 of the reference's, every page
    but the shared scratch one within 1e-5."""
    cfg, jmodel, jparams, tmodel, tparams = setup
    B, K1, maxp, n_pages = 3, 4, 4, 12
    scratch, lane_scratch = 11, [8, 9, 10]
    rng = np.random.default_rng(5)
    shape = (cfg.num_layers, n_pages, PAGE, cfg.num_kv_heads, cfg.hd)
    k0, v0 = _kv_rand(rng, shape), _kv_rand(rng, shape)
    page_tables = [[0, 1], [2], []]
    lengths = np.array([2 * PAGE - 2, 3, 0], np.int32)
    active = [True, True, False]
    tables = np.full((B, maxp + 1), scratch, np.int32)
    wp = np.full((B, K1), scratch, np.int32)
    wo = np.tile(np.arange(K1, dtype=np.int32) % PAGE, (B, 1))
    for b, pt in enumerate(page_tables):
        if not active[b]:
            continue
        tables[b, :len(pt)] = pt
        tables[b, len(pt)] = lane_scratch[b]
        for i in range(K1):
            p = int(lengths[b]) + i
            wp[b, i] = pt[p // PAGE] if p // PAGE < len(pt) else \
                lane_scratch[b]
            wo[b, i] = p % PAGE
    assert wp[0].tolist() == [1, 1, 8, 8]
    tokens = rng.integers(2, cfg.vocab_size, (B, K1)).astype(np.int32)
    rlog, rkv = jmodel.paged_decode_verify(
        jparams, {"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
        jnp.asarray(tokens), jnp.asarray(tables), jnp.asarray(lengths),
        jnp.asarray(wp), jnp.asarray(wo))
    kv = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy())}
    t = torch.from_numpy
    plog = tmodel.paged_decode_verify(tparams, kv, t(tokens), t(tables),
                                      t(lengths), t(wp), t(wo))
    np.testing.assert_allclose(plog.numpy()[:2], np.asarray(rlog)[:2],
                               atol=1e-4, rtol=0)
    live = [p for p in range(n_pages) if p != scratch]
    for key in ("k", "v"):
        np.testing.assert_allclose(kv[key].numpy()[:, live],
                                   np.asarray(rkv[key])[:, live],
                                   atol=1e-5, rtol=0)


def test_verify_logits_equal_sequential_decode(setup):
    """Inside the port: the dense verify's logits at its K1 positions
    equal K1 sequential decode steps fed the same tokens (1e-4), and the
    K/V rows they write agree (1e-5)."""
    cfg, _, _, tmodel, tparams = setup
    B, K1, Smax = 2, 4, 32
    rng = np.random.default_rng(6)
    shape = (cfg.num_layers, B, Smax, cfg.num_kv_heads, cfg.hd)
    k0, v0 = _kv_rand(rng, shape), _kv_rand(rng, shape)
    lengths = np.array([7, 20], np.int32)
    tokens = torch.from_numpy(
        rng.integers(2, cfg.vocab_size, (B, K1)).astype(np.int32))
    caches = [{"k": torch.from_numpy(k0.copy()),
               "v": torch.from_numpy(v0.copy()),
               "lengths": torch.from_numpy(lengths.copy())} for _ in "ab"]
    ver = tmodel.decode_verify(tparams, caches[0], tokens)
    seq = torch.stack([tmodel.decode_step(tparams, caches[1],
                                          tokens[:, i:i + 1])
                       for i in range(K1)], dim=1)
    torch.testing.assert_close(ver, seq, atol=1e-4, rtol=0)
    for key in ("k", "v"):
        torch.testing.assert_close(caches[0][key], caches[1][key],
                                   atol=1e-5, rtol=0)


# --------------------------------------------------------------- engines

class NullDraft(port_draft.DraftSource):
    """Proposes nothing: the verify step runs with n_drafts == 0."""

    def propose(self, rid, tokens, k):
        return []


class ReplayDraft(port_draft.DraftSource):
    """Oracle drafts: replays a known output stream."""

    def __init__(self, outs, plens):
        self.outs, self.plens = outs, plens

    def propose(self, rid, tokens, k):
        gen = len(tokens) - self.plens[rid]
        return list(self.outs[rid][gen:gen + k])


def _requests(req_mod, cfg, n=6, seed=0, out=24):
    """Prompts of 4-15 random tokens (the reference's spec tests' mix)."""
    rng = np.random.default_rng(seed)
    req_mod.reset_request_counter()
    reqs = []
    for _ in range(n):
        toks = rng.integers(2, cfg.vocab_size,
                            int(rng.integers(4, 16))).tolist()
        reqs.append(req_mod.Request(prompt_len=len(toks), arrival_time=0.0,
                                    true_out_len=out, prompt_tokens=toks))
    return reqs


def _drive(eng, reqs, staged: bool):
    """Serve on a virtual clock; ``staged``: two requests first, the rest
    0.5 s later (preemption with two lanes)."""
    t = 0.0
    first = reqs[:2] if staged else reqs
    for r in first:
        eng.submit(r, t)
    if staged:
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
    return reqs


def _serve(mods, cfg, model, params, *, spec, draft=None, staged=False,
           reqs=None, seed=0, **kw):
    eng_mod, pred_mod, req_mod = mods
    opts = dict(max_slots=4, max_seq_len=64, max_new_tokens=48,
                strategy="alise", prefill_chunk=8, quantize_offload=False,
                spec_decode=spec, spec_k=3)
    if staged:
        opts.update(max_slots=2, prefill_chunk=None)
    opts.update(kw)
    reqs = reqs or _requests(req_mod, cfg, seed=seed,
                             out=40 if staged else 24)
    if staged:            # bimodal output lengths: SRTF reorders
        for i, r in enumerate(reqs):
            r.true_out_len = 40 if i < 2 else 3
    eng = eng_mod.ServingEngine(model, params, eng_mod.EngineConfig(**opts),
                                predictor=pred_mod.OraclePredictor())
    if draft is not None:
        eng._draft = draft
    return _drive(eng, reqs, staged), eng


PORT = (port_engine, port_predictor, port_request)
JAX = (jax_engine, jax_predictor, jax_request)


def _tokens(reqs):
    return [list(r.output_tokens) for r in reqs]


def _no_leaks(eng):
    assert not eng.host_pool
    pool = getattr(eng.kv, "pool", None)
    if pool is not None:
        assert not pool.page_table


@pytest.mark.parametrize("backend_kw", BACKENDS, ids=BACKEND_IDS)
def test_spec_greedy_tokens_match_jax_engine(setup, backend_kw):
    """Acceptance: a greedy spec serve (spec_k 3) of the port gives the
    JAX engine's spec serve's tokens on the same requests and plan, with
    drafts proposed and accepted, and no page left after the drain."""
    cfg, jmodel, jparams, tmodel, tparams = setup
    ref, _ = _serve(JAX, cfg, jmodel, jparams, spec=True, **backend_kw)
    got, eng = _serve(PORT, cfg, tmodel, tparams, spec=True, **backend_kw)
    assert eng._spec_ok and eng.sched.cfg.decode_width == 4
    assert _tokens(got) == _tokens(ref)
    assert [r.spec_accepted for r in got] == [r.spec_accepted for r in ref]
    assert sum(r.spec_drafted for r in got) > 0
    assert sum(r.spec_accepted for r in got) > 0
    for r in got:
        assert 1.0 <= r.spec_tokens_per_iter() <= 4.0
    _no_leaks(eng)


@pytest.mark.parametrize("backend_kw", BACKENDS, ids=BACKEND_IDS)
def test_spec_identity_under_preemption(setup, backend_kw):
    """Two lanes and staged arrivals force preemption: spec on equals spec
    off, and real drafts equal no drafts through the same verify step, bit
    for bit (the port of the reference's test of the same name)."""
    cfg, _, _, tmodel, tparams = setup

    def run(spec, draft=None):
        return _serve(PORT, cfg, tmodel, tparams, spec=spec, draft=draft,
                      staged=True, seed=2, **backend_kw)
    base, _ = run(False)
    null, _ = run(True, NullDraft())
    spec, eng = run(True)
    assert sum(r.preempt_count for r in spec) > 0
    assert _tokens(spec) == _tokens(null) == _tokens(base)
    assert sum(r.spec_accepted for r in spec) > 0
    _no_leaks(eng)


@pytest.mark.parametrize("backend_kw", BACKENDS, ids=BACKEND_IDS)
def test_spec_identity_with_prefix_cache(setup, backend_kw):
    """The shared-prefix cache on: published pages feed the radix draft
    source and the prefill hits; tokens equal the spec-off, cache-off
    serve's."""
    cfg, _, _, tmodel, tparams = setup
    rng = np.random.default_rng(7)
    shared = rng.integers(2, cfg.vocab_size, 12).tolist()

    def run(**kw):
        port_request.reset_request_counter()
        reqs = [port_request.Request(
            prompt_len=12 + i, arrival_time=0.0, true_out_len=16,
            prompt_tokens=shared + list(range(2, 2 + i))) for i in range(4)]
        eng = port_engine.ServingEngine(
            tmodel, tparams, port_engine.EngineConfig(
                max_slots=4, max_seq_len=64, max_new_tokens=24,
                strategy="alise", prefill_chunk=8, quantize_offload=False,
                spec_k=3, **kw), predictor=port_predictor.OraclePredictor())
        for r in reqs:      # one at a time: each publishes before the next
            _drive(eng, [r], staged=False)
        return reqs, eng
    base, _ = run()
    spec, eng = run(spec_decode=True, prefix_cache=True, **backend_kw)
    assert isinstance(eng._draft, port_draft.ChainDraftSource)
    assert _tokens(spec) == _tokens(base)
    assert eng.kv.prefix_stats().hits > 0
    assert sum(r.spec_accepted for r in spec) > 0


def test_temperature_drafts_vs_no_drafts(setup):
    """With temperature, per-(request, token index) draws make acceptance
    independent of the drafts: the same verify step fed n-gram drafts and
    fed none emits the same streams."""
    cfg, _, _, tmodel, tparams = setup
    kw = dict(greedy=False, temperature=0.8, top_k=40, seed=11)
    base, _ = _serve(PORT, cfg, tmodel, tparams, spec=True,
                     draft=NullDraft(), **kw)
    spec, _ = _serve(PORT, cfg, tmodel, tparams, spec=True, **kw)
    assert _tokens(spec) == _tokens(base)
    assert sum(r.spec_drafted for r in spec) > 0


@pytest.mark.parametrize("backend_kw", BACKENDS, ids=BACKEND_IDS)
def test_temperature_oracle_draft_replay(setup, backend_kw):
    """Oracle drafts replaying the no-draft serve's own outputs are
    accepted at a high rate and reproduce its streams exactly."""
    cfg, _, _, tmodel, tparams = setup
    kw = dict(greedy=False, temperature=0.8, top_k=40, seed=11, **backend_kw)
    base, _ = _serve(PORT, cfg, tmodel, tparams, spec=True,
                     draft=NullDraft(), **kw)
    outs = {r.req_id: list(r.output_tokens) for r in base}
    plens = {r.req_id: r.prompt_len for r in base}
    spec, eng = _serve(PORT, cfg, tmodel, tparams, spec=True,
                       draft=ReplayDraft(outs, plens), **kw)
    assert _tokens(spec) == [outs[r.req_id] for r in spec]
    assert sum(r.spec_accepted for r in spec) >= 20
    _no_leaks(eng)


@pytest.mark.parametrize("backend_kw", BACKENDS, ids=BACKEND_IDS)
def test_no_serve_time_captures_with_spec(setup, backend_kw):
    """A warmed spec engine (the verify step captured, its cost recorded)
    serves a mixed trace with zero new graph keys, and its tokens equal a
    cold engine's."""
    cfg, _, _, tmodel, tparams = setup
    cold, _ = _serve(PORT, cfg, tmodel, tparams, spec=True, seed=3,
                     max_new_tokens=12, **backend_kw)
    counter = CompileCounter()
    try:
        opts = dict(max_slots=4, max_seq_len=64, max_new_tokens=12,
                    strategy="alise", prefill_chunk=8,
                    quantize_offload=False, spec_decode=True, spec_k=3,
                    warmup_compile=True, **backend_kw)
        eng = port_engine.ServingEngine(
            tmodel, tparams, port_engine.EngineConfig(**opts),
            predictor=port_predictor.OraclePredictor())
        assert eng._spec_ok and eng.latency.verify_cost is not None
        assert ("verify",) in eng.kv.graphs._entries
        counter.reset()
        warm = _drive(eng, _requests(port_request, cfg, seed=3), False)
        assert counter.count == 0, counter.events
    finally:
        counter.detach()
    assert _tokens(warm) == _tokens(cold)
    assert sum(r.spec_drafted for r in warm) > 0


def test_spec_config_edges(setup):
    """spec_k must stay below the page size on the paged backend; a
    family without chunked prefill (ssm) ignores spec_decode, as the
    reference does."""
    cfg, _, _, tmodel, tparams = setup
    with pytest.raises(ValueError, match="page_size"):
        port_engine.ServingEngine(tmodel, tparams, port_engine.EngineConfig(
            max_slots=2, max_seq_len=64, kv_backend="paged", page_size=4,
            spec_decode=True, spec_k=4))
    from repro_torch.configs import get_smoke_config as port_smoke
    mcfg = port_smoke("mamba2-2.7b")
    mmodel = Model(mcfg, device="cpu")
    mparams = mmodel.init(torch.Generator().manual_seed(0))
    eng = port_engine.ServingEngine(mmodel, mparams, port_engine.EngineConfig(
        max_slots=2, max_seq_len=64, spec_decode=True))
    assert not eng._spec_ok and eng._draft is None
    assert eng.sched.cfg.decode_width == 1
