"""The port's model layers, model entry points and sampler against the JAX
package, on the same weights and inputs.

Weights come from the JAX ``Model.init`` and cross into torch through numpy
(``params_from_numpy``); inputs are made with numpy from a seed.  The model
is ``get_smoke_config("granite-3-8b")`` (2 layers, d_model 64, 8/2 heads)
in float32 with a float32 KV pool.  Logits are compared with atol 1e-4:
XLA and torch sum in different orders, so the two frameworks agree to
float32 rounding, not bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import sampler as JS  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import Model, params_from_numpy  # noqa: E402
from repro_torch.serving import sampler as S  # noqa: E402

ATOL = 1e-4          # float32 logits, XLA vs torch summation order
PAGE = 8
NUM_PAGES = 12
SCRATCH = 0


def _cfg(**kw):
    return dataclasses.replace(get_smoke_config("granite-3-8b"),
                               param_dtype="float32", **kw)


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    jparams = JaxModel(cfg, kv_dtype="float32").init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = params_from_numpy(cfg, np_params, device="cpu")
    return cfg, jparams, tparams


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pool(cfg, seed=1):
    """A float32 page pool full of stale values (masking must hide them)."""
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, NUM_PAGES, PAGE, cfg.num_kv_heads, cfg.hd)
    return {k: rng.standard_normal(shape).astype(np.float32)
            for k in ("k", "v")}


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_apply_norm_matches_jax(norm_type):
    cfg = _cfg(norm_type=norm_type)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    out = L.apply_norm(cfg, {k: _t(v) for k, v in p.items()}, _t(x))
    ref = JL.apply_norm(cfg, {k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 7, 16)).astype(np.float32)
    pos = rng.integers(0, 3000, (2, 1, 7)).astype(np.int32)
    out = L.apply_rope(_t(x), _t(pos), 10000.0)
    ref = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_project_qkv_matches_jax(qkv_bias):
    cfg = _cfg(qkv_bias=qkv_bias)
    rng = np.random.default_rng(2)
    p = {"wq": rng.standard_normal((64, 64)), "wk": rng.standard_normal((64, 16)),
         "wv": rng.standard_normal((64, 16)), "bq": rng.standard_normal(64),
         "bk": rng.standard_normal(16), "bv": rng.standard_normal(16)}
    p = {k: (v / 8).astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    pos = rng.integers(0, 100, (2, 5)).astype(np.int32)
    out = L._project_qkv(cfg, {k: _t(v) for k, v in p.items()}, _t(x), _t(pos))
    ref = JL._project_qkv(cfg, {k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), jnp.asarray(pos))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_full_attention_matches_jax():
    cfg = _cfg()
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 6, 8, 8)).astype(np.float32)
    k = rng.standard_normal((2, 20, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 20, 2, 8)).astype(np.float32)
    qpos = (np.array([[3], [14]]) + np.arange(6)[None]).astype(np.int32)
    kpos = np.broadcast_to(np.arange(20), (2, 20)).astype(np.int32)
    out = L.full_attention(cfg, _t(q), _t(k), _t(v), causal=True,
                           q_positions=_t(qpos), kv_positions=_t(kpos))
    ref = JL.full_attention(cfg, *map(jnp.asarray, (q, k, v)), causal=True,
                            q_positions=jnp.asarray(qpos),
                            kv_positions=jnp.asarray(kpos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_decode_attention_matches_jax():
    cfg = _cfg()
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 8, 8)).astype(np.float32)
    k = rng.standard_normal((3, 24, 2, 8)).astype(np.float32)
    v = rng.standard_normal((3, 24, 2, 8)).astype(np.float32)
    lens = np.array([1, 13, 24], np.int32)
    out = L.decode_attention(cfg, _t(q), _t(k), _t(v), _t(lens))
    ref = JL.decode_attention(cfg, *map(jnp.asarray, (q, k, v, lens)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu"])
def test_apply_ffn_matches_jax(act):
    cfg = _cfg(act=act)
    rng = np.random.default_rng(5)
    p = {k: (rng.standard_normal(s) / 8).astype(np.float32)
         for k, s in (("wi", (64, 128)), ("wg", (64, 128)), ("wo", (128, 64)))}
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    out = L.apply_ffn(cfg, {k: _t(v) for k, v in p.items()}, _t(x))
    ref = JL.apply_ffn(cfg, {k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


# ------------------------------------------------------------------ params

def test_params_from_numpy_keeps_names_and_values(setup):
    cfg, jparams, tparams = setup
    assert set(tparams) == {"embed", "final_norm", "layers"}
    assert len(tparams["layers"]) == cfg.num_layers
    np.testing.assert_array_equal(tparams["embed"].numpy(),
                                  np.asarray(jparams["embed"]))
    for i, layer in enumerate(tparams["layers"]):
        assert set(layer) == {"ln1", "attn", "ln2", "ffn"}
        for sub, leaves in layer.items():
            for name, t in leaves.items():
                np.testing.assert_array_equal(
                    t.numpy(), np.asarray(jparams["layers"][sub][name][i]))


def test_params_from_numpy_carries_bfloat16():
    cfg = get_smoke_config("granite-3-8b")
    jparams = JaxModel(cfg).init(jax.random.PRNGKey(1))
    tparams = params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    assert tparams["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tparams["layers"][1]["ffn"]["wg"].float().numpy(),
        np.asarray(jparams["layers"]["ffn"]["wg"][1], np.float32))


def test_model_init_shapes_and_scales():
    """The port's own init: the JAX init's names and shapes, drawn on the
    device from a torch.Generator with ``_dense_init``'s scales."""
    cfg = _cfg(d_model=256, num_heads=8, num_kv_heads=2, d_ff=512,
               vocab_size=2048)
    jshapes = jax.eval_shape(JaxModel(cfg).init, jax.random.PRNGKey(0))
    model = Model(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    assert tuple(params["embed"].shape) == jshapes["embed"].shape
    for layer in params["layers"]:
        for sub, leaves in layer.items():
            for name, t in leaves.items():
                assert tuple(t.shape) == jshapes["layers"][sub][name].shape[1:]
    assert abs(params["embed"].std().item() - 0.02) < 0.002
    wq = params["layers"][0]["attn"]["wq"]
    assert abs(wq.std().item() * 16.0 - 1.0) < 0.05        # 1/sqrt(256)
    assert torch.equal(params["layers"][0]["ln1"]["scale"], torch.ones(256))
    again = model.init(torch.Generator().manual_seed(0))
    assert torch.equal(again["layers"][1]["ffn"]["wo"],
                       params["layers"][1]["ffn"]["wo"])


def test_model_requires_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(_cfg())


# ------------------------------------------------- chunked paged prefill

def _chunk_inputs(start, n, bucket, pages):
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :n] = np.random.default_rng(start + 11).integers(2, 500, n)
    wp = np.full((bucket,), SCRATCH, np.int32)
    wo = (np.arange(bucket) % PAGE).astype(np.int32)
    pos = start + np.arange(n)
    wp[:n] = np.asarray(pages)[pos // PAGE]
    wo[:n] = pos % PAGE
    tables = np.full((1, 4), SCRATCH, np.int32)
    tables[0, :len(pages)] = pages
    return toks, tables, wp, wo


@pytest.mark.parametrize("impl", ["masked", "flash"])
def test_paged_prefill_chunk_matches_jax(setup, impl):
    """Two chunks of one request: 11 tokens then 9 (each padded to a
    16-row bucket), the second starting mid-page.  Logits and the page
    pool agree with the JAX model after each chunk."""
    cfg, jparams, tparams = setup
    jm = JaxModel(cfg, kv_dtype="float32", chunk_attn_impl=impl)
    tm = Model(cfg, kv_dtype="float32", chunk_attn_impl=impl, device="cpu")
    pool = _pool(cfg)
    jkv = {k: jnp.asarray(v) for k, v in pool.items()}
    tkv = {k: _t(v.copy()) for k, v in pool.items()}
    pages = [5, 2, 9]
    for start, n in ((0, 11), (11, 9)):
        toks, tables, wp, wo = _chunk_inputs(start, n, 16, pages)
        jl, jkv = jm.paged_prefill_chunk(
            jparams, jkv, jnp.asarray(toks), jnp.asarray(tables),
            jnp.asarray(wp), jnp.asarray(wo), jnp.asarray(start, jnp.int32),
            jnp.asarray(n, jnp.int32))
        tl = tm.paged_prefill_chunk(tparams, tkv, _t(toks), _t(tables),
                                    _t(wp), _t(wo), start, n)
        assert tl.dtype == torch.float32 and tuple(tl.shape) == (1, 512)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(tkv[k].numpy(), np.asarray(jkv[k]),
                                       atol=1e-5)


# ------------------------------------------------------- paged decode

def _decode_inputs():
    """Three lanes: a request at length 20 on pages [5, 2, 9], an inactive
    lane (scratch page, length 0) and a request at length 9 on [7, 3]."""
    tables = np.full((3, 4), SCRATCH, np.int32)
    tables[0, :3] = [5, 2, 9]
    tables[2, :2] = [7, 3]
    lengths = np.array([20, 0, 9], np.int32)
    wp = np.array([9, SCRATCH, 3], np.int32)
    wo = np.array([4, 0, 1], np.int32)
    tokens = np.array([[17], [0], [300]], np.int32)
    return tokens, tables, lengths, wp, wo


@pytest.mark.parametrize("attn_impl", ["gather", "kernel"])
def test_paged_decode_step_matches_jax(setup, attn_impl):
    cfg, jparams, tparams = setup
    jm = JaxModel(cfg, kv_dtype="float32")
    tm = Model(cfg, kv_dtype="float32", device="cpu")
    pool = _pool(cfg, seed=2)
    tokens, tables, lengths, wp, wo = _decode_inputs()
    jl, jkv = jm.paged_decode_step(
        jparams, {k: jnp.asarray(v) for k, v in pool.items()},
        *map(jnp.asarray, (tokens, tables, lengths, wp, wo)),
        attn_impl=attn_impl, interpret=True)
    tkv = {k: _t(v.copy()) for k, v in pool.items()}
    tl = tm.paged_decode_step(tparams, tkv, *map(_t, (tokens, tables, lengths,
                                                       wp, wo)),
                              attn_impl=attn_impl)
    assert torch.isfinite(tl).all()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tkv[k].numpy(), np.asarray(jkv[k]),
                                   atol=1e-5)


def test_paged_decode_gather_equals_kernel_path(setup):
    """Inside the port the two decode attention paths agree (on the CPU
    both run plain torch; on the card ``kernel`` is the CUDA kernel)."""
    cfg, _, tparams = setup
    tm = Model(cfg, kv_dtype="float32", device="cpu")
    pool = _pool(cfg, seed=3)
    outs = []
    for impl in ("gather", "kernel"):
        tkv = {k: _t(v.copy()) for k, v in pool.items()}
        outs.append(tm.paged_decode_step(
            tparams, tkv, *map(_t, _decode_inputs()), attn_impl=impl))
    torch.testing.assert_close(outs[0], outs[1], atol=1e-5, rtol=0)
    assert torch.equal(outs[0].argmax(-1), outs[1].argmax(-1))


def test_paged_decode_step_sampled_greedy_matches_jax(setup):
    cfg, jparams, tparams = setup
    jm = JaxModel(cfg, kv_dtype="float32")
    tm = Model(cfg, kv_dtype="float32", device="cpu")
    pool = _pool(cfg, seed=4)
    tokens, tables, lengths, wp, wo = _decode_inputs()
    active = np.array([True, False, True])
    new_gen = np.array([5, 1, 48], np.int32)
    new_ctx = lengths + 1
    true_len = np.array([5, 1 << 30, 100], np.int32)
    rids = np.array([3, 0, 8], np.int32)
    jtok, jreason, _ = jm.paged_decode_step_sampled(
        jparams, {k: jnp.asarray(v) for k, v in pool.items()},
        *map(jnp.asarray, (tokens, tables, lengths, wp, wo, active, new_gen,
                           new_ctx, true_len, rids)),
        jax.random.PRNGKey(0), attn_impl="gather", max_new_tokens=48,
        max_seq_len=32)
    ttok, treason = tm.paged_decode_step_sampled(
        tparams, {k: _t(v.copy()) for k, v in pool.items()},
        *map(_t, (tokens, tables, lengths, wp, wo, active, new_gen, new_ctx,
                  true_len, rids)),
        attn_impl="kernel", max_new_tokens=48, max_seq_len=32)
    np.testing.assert_array_equal(ttok.numpy()[active],
                                  np.asarray(jtok)[active])
    np.testing.assert_array_equal(treason.numpy(), np.asarray(jreason))
    assert treason.tolist() == [S.REASON_TRUE_LEN, 0, S.REASON_LENGTH]


# ------------------------------------------------------------------ sampler

def test_greedy_matches_jax_on_ties():
    logits = np.zeros((3, 10), np.float32)
    logits[0, [2, 7]] = 1.0                       # tie: first index wins
    logits[1, 9] = 2.0
    logits[2] = np.random.default_rng(0).standard_normal(10)
    np.testing.assert_array_equal(S.greedy(_t(logits)).numpy(),
                                  np.asarray(JS.greedy(jnp.asarray(logits))))


def test_reason_of_matches_jax():
    rng = np.random.default_rng(1)
    n = 64
    tok = rng.integers(0, 4, n).astype(np.int32)
    gen = rng.integers(0, 20, n).astype(np.int32)
    ctx = rng.integers(0, 40, n).astype(np.int32)
    true_len = rng.integers(0, 20, n).astype(np.int32)
    kw = dict(eos_token=1, max_new_tokens=16, max_seq_len=32)
    out = S._reason_of(*map(_t, (tok, gen, ctx, true_len)), **kw)
    ref = JS._reason_of(*map(jnp.asarray, (tok, gen, ctx, true_len)), **kw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert set(out.tolist()) == {0, 1, 2, 3, 4}


def _draws(logits, n, **kw):
    """``n`` draws, token indices 0..n-1 of request 7."""
    lg = torch.from_numpy(np.repeat(logits[None], n, 0))
    return S.sample_tokens(lg, torch.full((n,), 7, dtype=torch.int32),
                           torch.arange(n, dtype=torch.int32),
                           greedy_sampling=False, seed=3, **kw).numpy()


def test_temperature_sampling_follows_softmax():
    """Distribution check: 20k draws match softmax(logits / temp) (the
    JAX sampler's distribution; its bits differ by design)."""
    logits = np.array([2.0, 1.0, 0.5, 0.0, -1.0, -3.0], np.float32)
    n, temp = 20000, 0.8
    freq = np.bincount(_draws(logits, n, temp=temp), minlength=6) / n
    p = np.exp(logits / temp - (logits / temp).max())
    p /= p.sum()
    assert np.abs(freq - p).max() < 4 * np.sqrt(p.max() / n)


def test_top_k_sampling_stays_in_top_k():
    logits = np.random.default_rng(2).standard_normal(50).astype(np.float32)
    draws = _draws(logits, 2000, temp=5.0, top_k=4)
    assert set(draws) <= set(np.argsort(logits)[-4:].tolist())
    assert len(set(draws)) == 4


def test_temperature_draw_is_named_by_request_and_index():
    """A draw depends only on (seed, request id, token index): the same
    lane gives the same token in any batch, at any position."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    rids = torch.tensor([5, 9, 5, 2], dtype=torch.int32)
    idx = torch.tensor([0, 3, 1, 7], dtype=torch.int32)
    kw = dict(greedy_sampling=False, seed=0, temp=1.0)
    full = S.sample_tokens(logits, rids, idx, **kw)
    perm = torch.tensor([3, 1, 0, 2])
    shuffled = S.sample_tokens(logits[perm], rids[perm], idx[perm], **kw)
    assert torch.equal(full[perm], shuffled)
    single = S.sample_tokens(logits[1:2], rids[1:2], idx[1:2], **kw)
    assert single.item() == full[1].item()
    noise = S.uniform_noise(0, rids, idx, 64)
    assert noise.min() > 0 and noise.max() < 1
    assert not torch.equal(noise, S.uniform_noise(1, rids, idx, 64))
