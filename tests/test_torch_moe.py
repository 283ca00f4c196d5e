"""The port's MoE family against the JAX package, and the serving
invariants inside the port.

The MoE is capacity-based (GShard): each expert takes at most
``max(int(cf * T * K / E), 1)`` of a call's ``(token, k)`` assignments in
token-major order and drops the rest, so one token's output depends on
the other tokens of its call, inactive decode lanes' included.  Across
frameworks the port must equal the reference at the config's own
capacity factor (1.25): the same expert choices and drops in ``apply_moe``,
every serving method's logits within 1e-4 (float32, the tolerance of
``tests/test_torch_model.py``), and the JAX engine's greedy tokens on a
staged, preempting trace.  The in-port invariants (dense == paged,
chunked == whole, spec on == off, prefix on == off, preempted ==
unpreempted) hold only when nothing is dropped, so they run at a dropless
factor (cf = E).  Weights come from the JAX ``Model.init`` through
``params_from_numpy``; the models are the smoke configs of granite-moe-3b-
a800m (RMSNorm, 4 experts top-2) and dbrx-132b (LayerNorm, G = 4).
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
from repro.models import layers as JL  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.training import data as jax_data  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.core import engine as port_engine  # noqa: E402
from repro_torch.core import predictor as port_predictor  # noqa: E402
from repro_torch.core import request as port_request  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import Model, params_from_numpy  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402
from repro_torch.utils.compile_counter import CompileCounter  # noqa: E402

MOE = ["granite-moe-3b-a800m", "dbrx-132b"]
ATOL = 1e-4          # float32 logits, XLA vs torch summation order
PAGE = 8
SCRATCH = 0


def _cfg(name, **kw):
    """The port's copy of ``name``'s smoke config in float32; it must
    equal the reference's."""
    cfg = dataclasses.replace(port_configs.get_smoke_config(name),
                              param_dtype="float32", **kw)
    ref = dataclasses.replace(get_smoke_config(name), param_dtype="float32",
                              **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    return cfg


_MODELS = {}


def _models(name, **kw):
    """(cfg, JAX model, JAX params, port model, port params), built once
    per config; the same weights at every capacity factor."""
    key = (name, tuple(sorted(kw.items())))
    if key not in _MODELS:
        cfg = _cfg(name, **kw)
        jm = JaxModel(cfg, kv_dtype="float32", remat=False)
        jp = jm.init(jax.random.PRNGKey(0))
        tp = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
        _MODELS[key] = (cfg, jm, jp,
                        Model(cfg, kv_dtype="float32", device="cpu"), tp)
    return _MODELS[key]


def _dropless(name):
    cfg = get_smoke_config(name)
    return _models(name, capacity_factor=float(cfg.num_experts))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_keep(gate_idx, E_alloc, capacity):
    """The reference's kept mask, with its own expressions
    (``layers._dispatch_compute_combine``)."""
    G = gate_idx.shape[0]
    flat = gate_idx.reshape(G, -1)
    onehot = jax.nn.one_hot(flat, E_alloc, dtype=jnp.float32)
    pos = ((jnp.cumsum(onehot, axis=1) * onehot).sum(-1) - 1.0).astype(
        jnp.int32)
    return np.asarray(pos < capacity)


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("pad", [0, 6])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("name", MOE)
def test_apply_moe_matches_jax(name, groups, pad):
    """Router, dispatch and combine at cf 1.25 over 16 tokens, with expert
    0 over capacity: the same
    expert choices (each token's k-th and (k+1)-th probabilities apart,
    so the order is not a rounding tie) and the same kept and dropped
    assignments, exactly; outputs and the aux loss within float32
    rounding.  Padded experts are never chosen."""
    cfg = _cfg(name)
    p = JL.init_moe(cfg, jax.random.PRNGKey(1), jnp.float32,
                    pad_experts_to=pad)
    tp = {k: _t(np.asarray(v)) for k, v in p.items()}
    assert tp["router"].dtype == torch.float32
    # steered toward expert 0, so that it overflows its capacity
    x = np.random.default_rng(groups + pad).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32) + 40 * np.asarray(
            p["router"][:, 0])
    G = groups
    Tg = 16 // G
    jw, ji, jaux, jE = JL._route(cfg, p, jnp.asarray(x).reshape(G, Tg, -1))
    tw, ti, taux, tE = L._route(cfg, tp, _t(x).reshape(G, Tg, -1))
    assert tE == jE == max(cfg.num_experts, pad)
    probs = np.sort(np.asarray(jax.nn.softmax(
        jnp.asarray(x).reshape(G, Tg, -1) @ p["router"][:, :cfg.num_experts],
        axis=-1)), axis=-1)[..., ::-1]
    assert (probs[..., cfg.top_k - 1] - probs[..., cfg.top_k]).min() > 1e-6
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert int(ti.max()) < cfg.num_experts
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    cap = L.moe_capacity(cfg, Tg)
    assert cap == max(int(cfg.capacity_factor * Tg * cfg.top_k
                          / cfg.num_experts), 1)
    keep = L._dispatch_plan(ti.reshape(G, -1), tE, cap)[1]
    want = _jax_keep(ji, jE, cap)
    np.testing.assert_array_equal(keep.numpy(), want)
    assert want.any() and not want.all()       # some dropped, some kept
    y, aux = L.apply_moe(cfg, tp, _t(x), groups=groups)
    jy, jaux2 = JL.apply_moe(cfg, p, jnp.asarray(x), groups=groups)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-5,
                               rtol=2e-5)
    assert float(aux) == pytest.approx(float(jaux2), rel=1e-5)


def test_last_writer_names_each_slots_last_row():
    """Paged steps of an MoE write each destination slot the value of the
    last row aimed at it, as a sequential scatter leaves it."""
    from repro_torch.models.model import _last_writer
    wp = torch.tensor([[3, 0], [3, 0], [5, 3]])
    wo = torch.tensor([[1, 0], [1, 0], [2, 1]])
    assert _last_writer(wp, wo).tolist() == [5, 3, 5, 3, 4, 5]


def test_moe_capacity_is_the_references_expression():
    """The capacity is ``int`` of the product in the reference's order, in
    Python floats; granite-moe's full-size values are the ones the
    serving steps see."""
    cfg = port_configs.get_config("granite-moe-3b-a800m")
    assert [L.moe_capacity(cfg, t) for t in (8, 32, 256, 4096)] == \
        [2, 8, 64, 1024]
    for t in range(1, 200):
        for cf in (1.0, 1.25, 1.1, 2.0 / 3.0):
            c = dataclasses.replace(cfg, capacity_factor=cf)
            assert L.moe_capacity(c, t) == max(int(cf * t * 8 / 40), 1)


def test_model_init_moe_layout_and_dtypes():
    """``Model.init`` builds ``ln2`` and the MoE ``ffn`` per layer: a
    float32 router whatever the param dtype, the experts stacked on a
    leading axis (padded by ``pad_experts_to``), as
    ``params_from_numpy`` carries them from the reference."""
    cfg = dataclasses.replace(port_configs.get_smoke_config(
        "granite-moe-3b-a800m"), param_dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    params = Model(cfg, pad_experts_to=6, device="cpu").init(gen)
    E, D, Fd = 6, cfg.d_model, cfg.d_ff
    for p_l in params["layers"]:
        ffn = p_l["ffn"]
        assert ffn["router"].dtype == torch.float32
        assert tuple(ffn["router"].shape) == (D, E)
        assert tuple(ffn["wi"].shape) == tuple(ffn["wg"].shape) == (E, D, Fd)
        assert tuple(ffn["wo"].shape) == (E, Fd, D)
        assert ffn["wi"].dtype == torch.bfloat16 and "ln2" in p_l
    shapes = jax.eval_shape(JaxModel(cfg, pad_experts_to=6).init,
                            jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    tp = params_from_numpy(cfg, jp, device="cpu")
    want = {str(k): tuple(v.shape) for k, v in tree_leaves(params)}
    got = {str(k): tuple(v.shape) for k, v in tree_leaves(tp)}
    assert got == want
    assert tp["layers"][0]["ffn"]["router"].dtype == torch.float32
    assert tp["layers"][1]["ffn"]["wo"].dtype == torch.bfloat16


# ------------------------------------------------------- model methods

def _pool(cfg, n_pages=12, seed=1):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, n_pages, PAGE, cfg.num_kv_heads, cfg.hd)
    return {k: rng.standard_normal(shape).astype(np.float32)
            for k in ("k", "v")}


def _stripes(cfg, B, Smax, seed=2):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, B, Smax, cfg.num_kv_heads, cfg.hd)
    return {k: rng.standard_normal(shape).astype(np.float32)
            for k in ("k", "v")}


@pytest.mark.parametrize("name", MOE)
def test_chunk_methods_match_jax(name):
    """Two chunks of one request (11 then 9 tokens, bucket 16) through
    ``paged_prefill_chunk`` and ``prefill_chunk`` (padded rows route and
    take capacity after the real ones, as in the reference): logits within
    1e-4 and the written K/V within 1e-5 after each chunk."""
    cfg, jm, jp, tm, tp = _models(name)
    pool = _pool(cfg)
    jkv = {k: jnp.asarray(v) for k, v in pool.items()}
    tkv = {k: _t(v.copy()) for k, v in pool.items()}
    st = _stripes(cfg, 1, 32)
    js = {k: jnp.asarray(v[:, 0]) for k, v in st.items()}
    ts = {k: _t(v[:, 0].copy()) for k, v in st.items()}
    pages = [5, 2, 9]
    for start, n in ((0, 11), (11, 9)):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :n] = np.random.default_rng(start).integers(2, 500, n)
        wp = np.full((16,), SCRATCH, np.int32)
        wo = (np.arange(16) % PAGE).astype(np.int32)
        pos = start + np.arange(n)
        wp[:n], wo[:n] = np.asarray(pages)[pos // PAGE], pos % PAGE
        tables = np.full((1, 4), SCRATCH, np.int32)
        tables[0, :3] = pages
        jl, jkv = jm.paged_prefill_chunk(
            jp, jkv, *map(jnp.asarray, (toks, tables, wp, wo)),
            jnp.asarray(start, jnp.int32), jnp.asarray(n, jnp.int32))
        tl = tm.paged_prefill_chunk(tp, tkv, *map(_t, (toks, tables, wp,
                                                        wo)), start, n)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(tkv[k].numpy(), np.asarray(jkv[k]),
                                       atol=1e-5)
        jl, jsk, jsv = jm.prefill_chunk(
            jp, js["k"], js["v"], jnp.asarray(toks),
            jnp.asarray(start, jnp.int32), jnp.asarray(n, jnp.int32))
        js = {"k": jsk, "v": jsv}
        tl = tm.prefill_chunk(tp, ts["k"], ts["v"], _t(toks), start, n)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       atol=1e-5)


def _decode_lanes(cfg):
    """Four lanes: lane 1 inactive (before two active lanes, so its routed
    token competes with theirs for capacity)."""
    rng = np.random.default_rng(7)
    tokens = np.array([[17], [0], [300], [41]], np.int32)
    lengths = np.array([20, 0, 9, 13], np.int32)
    active = np.array([True, False, True, True])
    return rng, tokens, lengths, active


@pytest.mark.parametrize("name", MOE)
def test_paged_decode_methods_match_jax(name):
    """``paged_decode_step`` (gather and kernel paths) and its sampled
    form: the inactive lane writes the scratch page in both packages, so
    every lane's logits agree within 1e-4 and the greedy tokens exactly."""
    cfg, jm, jp, tm, tp = _models(name)
    _, tokens, lengths, active = _decode_lanes(cfg)
    tables = np.full((4, 4), SCRATCH, np.int32)
    tables[0, :3], tables[2, :2], tables[3, :2] = [5, 2, 9], [7, 3], [4, 6]
    wp = np.array([9, SCRATCH, 3, 6], np.int32)
    wo = np.array([4, 0, 1, 5], np.int32)
    pool = _pool(cfg, seed=3)
    args = (tokens, tables, lengths, wp, wo)
    jl, _ = jm.paged_decode_step(
        jp, {k: jnp.asarray(v) for k, v in pool.items()},
        *map(jnp.asarray, args))
    for impl in ("gather", "kernel"):
        tl = tm.paged_decode_step(tp, {k: _t(v.copy()) for k, v in
                                       pool.items()}, *map(_t, args),
                                  attn_impl=impl)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    new_gen = np.array([5, 1, 30, 2], np.int32)
    true_len = np.full((4,), 1000, np.int32)
    rids = np.arange(4, dtype=np.int32)
    extra = (active, new_gen, lengths + 1, true_len, rids)
    jt, jr, _ = jm.paged_decode_step_sampled(
        jp, {k: jnp.asarray(v) for k, v in pool.items()},
        *map(jnp.asarray, args + extra), jax.random.PRNGKey(0),
        max_new_tokens=48, max_seq_len=64)
    tt, tr = tm.paged_decode_step_sampled(
        tp, {k: _t(v.copy()) for k, v in pool.items()},
        *map(_t, args + extra), max_new_tokens=48, max_seq_len=64)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("name", MOE)
def test_dense_decode_methods_match_jax(name):
    """``decode_step`` and its sampled form over the dense cache, with an
    inactive lane ahead of active ones.  The reference's step writes every
    lane's K/V; the port's inactive lane attends its new K/V all the same
    and then keeps its stripe, so every lane's logits agree within 1e-4,
    the active lanes' K/V within 1e-5, and the inactive lane's stripe is
    untouched."""
    cfg, jm, jp, tm, tp = _models(name)
    _, tokens, lengths, active = _decode_lanes(cfg)
    st = _stripes(cfg, 4, 32)

    def caches():
        return ({"k": jnp.asarray(st["k"]), "v": jnp.asarray(st["v"]),
                 "lengths": jnp.asarray(lengths)},
                {"k": _t(st["k"].copy()), "v": _t(st["v"].copy()),
                 "lengths": _t(lengths.copy())})
    jc, tc = caches()
    jl, jnew = jm.decode_step(jp, jc, jnp.asarray(tokens))
    tl = tm.decode_step(tp, tc, _t(tokens), _t(active))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for k in ("k", "v"):
        got = tc[k].numpy()
        np.testing.assert_allclose(got[:, active],
                                   np.asarray(jnew[k])[:, active], atol=1e-5)
        np.testing.assert_array_equal(got[:, 1], st[k][:, 1])
    assert tc["lengths"].tolist() == (lengths + active).tolist()
    new_gen = np.array([5, 1, 30, 2], np.int32)
    extra = (active, new_gen, lengths + 1, np.full((4,), 1000, np.int32),
             np.arange(4, dtype=np.int32))
    jc, tc = caches()
    jt, jr, jc = jm.decode_step_sampled(
        jp, jc, jnp.asarray(tokens), *map(jnp.asarray, extra),
        jax.random.PRNGKey(0), max_new_tokens=48, max_seq_len=64)
    tt, tr = tm.decode_step_sampled(tp, tc, _t(tokens), *map(_t, extra),
                                    max_new_tokens=48, max_seq_len=64)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert tc["lengths"].tolist() == np.asarray(jc["lengths"]).tolist()


@pytest.mark.parametrize("name", MOE)
def test_verify_methods_match_jax(name):
    """``decode_verify`` (dense, lane 1 inactive, lane 2 crossing Smax) and
    ``paged_decode_verify`` (lane 1 inactive at the shared scratch page):
    B * (k + 1) tokens share the capacity; every lane's logits within
    1e-4."""
    cfg, jm, jp, tm, tp = _models(name)
    B, K1, Smax = 4, 4, 32
    rng = np.random.default_rng(9)
    tokens = rng.integers(2, cfg.vocab_size, (B, K1)).astype(np.int32)
    tokens[1] = 0
    lengths = np.array([5, 0, Smax - 2, 17], np.int32)
    active = np.array([True, False, True, True])
    st = _stripes(cfg, B, Smax, seed=4)
    jl, _ = jm.decode_verify(jp, {"k": jnp.asarray(st["k"]),
                                  "v": jnp.asarray(st["v"]),
                                  "lengths": jnp.asarray(lengths)},
                             jnp.asarray(tokens))
    tc = {"k": _t(st["k"].copy()), "v": _t(st["v"].copy()),
          "lengths": _t(lengths.copy())}
    tl = tm.decode_verify(tp, tc, _t(tokens), _t(active))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for k in ("k", "v"):
        np.testing.assert_array_equal(tc[k].numpy()[:, 1], st[k][:, 1])

    scratch, lane_scratch, maxp = 11, [8, 9, 10, 7], 4
    page_tables = [[0, 1], [], [2], [3, 4, 5]]
    plen = np.array([2 * PAGE - 2, 0, 3, 17], np.int32)
    tables = np.full((B, maxp + 1), scratch, np.int32)
    wp = np.full((B, K1), scratch, np.int32)
    wo = np.tile(np.arange(K1, dtype=np.int32) % PAGE, (B, 1))
    for b, pt in enumerate(page_tables):
        if not active[b]:
            continue
        tables[b, :len(pt)] = pt
        tables[b, len(pt)] = lane_scratch[b]
        for i in range(K1):
            p = int(plen[b]) + i
            wp[b, i] = pt[p // PAGE] if p // PAGE < len(pt) else \
                lane_scratch[b]
            wo[b, i] = p % PAGE
    pool = _pool(cfg, seed=5)
    args = (tokens, tables, plen, wp, wo)
    jl, _ = jm.paged_decode_verify(
        jp, {k: jnp.asarray(v) for k, v in pool.items()},
        *map(jnp.asarray, args))
    tl = tm.paged_decode_verify(tp, {k: _t(v.copy()) for k, v in
                                     pool.items()}, *map(_t, args))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


@pytest.mark.parametrize("name", MOE)
def test_prefill_matches_jax_and_packs_are_refused(name):
    """Monolithic ``prefill`` (right-padded prompts, ``last_index``):
    logits within 1e-4, the cache within 1e-5.  Packed prefill stays off
    for MoE: co-batched chunks would share one capacity."""
    cfg, jm, jp, tm, tp = _models(name)
    rng = np.random.default_rng(11)
    toks = rng.integers(2, cfg.vocab_size, (2, 12)).astype(np.int32)
    last = np.array([11, 6], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "last_index": jnp.asarray(last)})
    tl, tc = tm.prefill(tp, {"tokens": _t(toks), "last_index": _t(last)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   atol=1e-5)
    assert tm.supports_chunked_prefill() and tm.supports_paged()
    assert tm.supports_spec_decode() and not tm.supports_prefill_pack()
    with pytest.raises(ValueError, match="packed prefill"):
        tm.prefill_pack(tp, None, None, None, torch.zeros((2, 8)), None,
                        None)


# ------------------------------------------------------------- training

@pytest.fixture(scope="module")
def grads():
    cfg, jm, jp, tm, _ = _models("granite-moe-3b-a800m")
    batch = jax_data.SyntheticLM(cfg, jax_data.DataConfig(
        batch_size=2, seq_len=16)).batch_at(0)
    (loss, parts), g = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(jp, batch)
    jg = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, g),
                           device="cpu")
    return cfg, tm, jp, batch, float(loss), parts, jg


def test_loss_and_every_gradient_leaf_match_jax(grads):
    """The loss with its MoE aux term (``MOE_AUX_COEF * sum of the
    layers' aux``) and every gradient leaf, the router's included, against
    ``jax.value_and_grad`` of the reference's loss."""
    cfg, tm, jp, batch, jloss, jparts, jg = grads
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
    for _, p in tree_leaves(params):
        p.requires_grad_(True)
    loss, parts = tm.loss(params, {k: _t(np.asarray(v))
                                   for k, v in batch.items()})
    assert float(loss.detach()) == pytest.approx(jloss, rel=1e-5)
    for k in ("ce", "zloss", "moe_aux"):
        assert float(parts[k].detach()) == pytest.approx(float(jparts[k]),
                                                         rel=1e-5)
    assert float(parts["moe_aux"].detach()) > 0
    leaves = list(tree_leaves(params))
    got = torch.autograd.grad(loss, [p for _, p in leaves])
    want = dict((str(k), v) for k, v in tree_leaves(jg))
    assert sorted(want) == sorted(str(k) for k, _ in leaves)
    for (path, _), g in zip(leaves, got):
        assert float(g.abs().max()) > 0, path
        np.testing.assert_allclose(g.numpy(), want[str(path)].numpy(),
                                   atol=1e-4, err_msg=str(path))


def test_train_launcher_trains_moe_on_the_cpu():
    from repro_torch.launch.train import train
    _, losses, _ = train("granite-moe-3b-a800m", smoke=True, steps=2,
                         batch_size=2, seq_len=16, log_every=100,
                         device="cpu")
    assert len(losses) == 2 and all(np.isfinite(losses))


# --------------------------------------------------------- the configs

DENSE_COPIES = ["command-r-35b", "qwen1.5-32b", "stablelm-3b",
                "internvl2-2b"]


@pytest.mark.parametrize("name", DENSE_COPIES + MOE)
def test_copied_configs_prefill_and_decode_match_jax(name):
    """Each copied config the port runs (the VLM through its token
    backbone): a prefill of two 8-token prompts and one decode step over
    the cache padded to 16 positions, logits within 1e-4."""
    cfg, jm, jp, tm, tp = _models(name)
    rng = np.random.default_rng(13)
    toks = rng.integers(2, cfg.vocab_size, (2, 8)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": _t(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    pad = ((0, 0), (0, 0), (0, 8), (0, 0), (0, 0))
    kv = {k: np.pad(np.asarray(jc[k]), pad) for k in ("k", "v")}
    nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    jl, _ = jm.decode_step(jp, {"lengths": jc["lengths"],
                                **{k: jnp.asarray(v) for k, v in kv.items()}},
                           jnp.asarray(nxt))
    tl = tm.decode_step(tp, {"lengths": tc["lengths"],
                             **{k: _t(v) for k, v in kv.items()}}, _t(nxt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


@pytest.mark.parametrize("name", ["jamba-1.5-large-398b"])
def test_hybrid_smoke_config_builds(name):
    """The hybrid config (jamba's smoke size, equal to the reference's)
    builds a model whose layers follow ``cfg.layer_kind`` and
    ``cfg.ffn_kind`` (tests/test_torch_hybrid.py holds it to the
    reference)."""
    cfg = port_configs.get_smoke_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        get_smoke_config(name))
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    assert len(params["layers"]) == cfg.num_layers
    for i, p_l in enumerate(params["layers"]):
        assert ("attn" in p_l) == (cfg.layer_kind(i) == "attn")
        assert ("router" in p_l["ffn"]) == (cfg.ffn_kind(i) == "moe")
    assert not model.supports_chunked_prefill()


def test_registry_holds_the_references_ten():
    from repro.configs import ASSIGNED_ARCHS, get_config
    assert port_configs.ASSIGNED_ARCHS == ASSIGNED_ARCHS
    for name in ASSIGNED_ARCHS:
        assert dataclasses.asdict(port_configs.get_config(name)) == \
            dataclasses.asdict(get_config(name))


# -------------------------------------------------------------- engines

PROMPTS = (7, 8, 9, 15, 16, 17)
OUTS = (24, 24, 3, 3, 3, 3)


def _requests(req_mod, cfg, prefix=0):
    """tests/test_torch_engine.py's requests; ``prefix`` > 0 gives every
    prompt the same first ``prefix`` tokens."""
    req_mod.reset_request_counter()
    rng = np.random.default_rng(3)
    shared = rng.integers(2, cfg.vocab_size, prefix).tolist()
    return [req_mod.Request(
        prompt_len=prefix + p, arrival_time=0.0, true_out_len=o,
        prompt_tokens=shared + rng.integers(2, cfg.vocab_size, p).tolist())
        for p, o in zip(PROMPTS, OUTS)]


def _staged(mods, cfg, model, params, *, tight=True, prefix=0, **kw):
    """tests/test_torch_engine.py's staged trace on a virtual clock: two
    requests, five steps, then four more; ``tight`` gives two lanes and a
    KV budget of two short sequences, so requests are preempted and
    swapped."""
    eng_mod, pred_mod, req_mod = mods
    bpt = kv_bytes_per_token(cfg.num_layers, cfg.num_kv_heads, cfg.hd)
    opts = dict(max_slots=2, max_seq_len=64, max_new_tokens=48,
                strategy="alise", quantize_offload=False,
                hbm_bytes=2 * 40 * bpt, kv_backend="paged", page_size=PAGE,
                prefill_chunk=5, iter_token_budget=16, eos_token=-1)
    if not tight:
        opts.update(max_slots=4, hbm_bytes=None)
    opts.update(kw)
    reqs = _requests(req_mod, cfg, prefix)
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
    assert not eng.sched.live and all(r.done for r in reqs)
    return reqs, eng


PORT = (port_engine, port_predictor, port_request)
JAX = (jax_engine, jax_predictor, jax_request)
ENGINE_CASES = [dict(kv_backend="paged"), dict(kv_backend="dense"),
                dict(kv_backend="paged", spec_decode=True, spec_k=3),
                dict(kv_backend="dense", spec_decode=True, spec_k=3),
                dict(kv_backend="dense", quantize_offload=True),
                dict(kv_backend="paged", tight=False)]
ENGINE_IDS = ["paged", "dense", "paged-spec", "dense-spec", "dense-int8",
              "paged-4-lanes"]


def _tokens(reqs):
    return [list(r.output_tokens) for r in reqs]


@pytest.mark.parametrize("kw", ENGINE_CASES, ids=ENGINE_IDS)
def test_greedy_tokens_match_jax_engine(kw):
    """Acceptance at cf 1.25: the port's engine emits the JAX engine's
    greedy tokens, with the same preemptions, on the staged trace (decode
    steps drop assignments, so the lanes' coupling is exercised: an
    inactive lane's token competes with the active ones in both)."""
    cfg, jm, jp, tm, tp = _models("granite-moe-3b-a800m")
    ref, _ = _staged(JAX, cfg, jm, jp, **kw)
    drops = []
    tm.moe_tap = lambda shape, idx, keep: drops.append(
        (shape, int((~keep).sum())))
    try:
        got, eng = _staged(PORT, cfg, tm, tp, **kw)
    finally:
        tm.moe_tap = None
    assert _tokens(got) == _tokens(ref)
    assert [r.preempt_count for r in got] == [r.preempt_count for r in ref]
    if kw.get("tight", True):
        assert sum(r.preempt_count for r in got) > 0
    lanes = eng.cfg.max_slots                  # decode and verify steps
    assert sum(n for shape, n in drops if shape[0] == lanes) > 0
    assert not eng.host_pool


def test_dbrx_greedy_tokens_match_jax_engine():
    """The LayerNorm MoE (dbrx, G = 4) on the dense backend with spec
    decoding, at cf 1.25."""
    cfg, jm, jp, tm, tp = _models("dbrx-132b")
    kw = dict(kv_backend="dense", spec_decode=True, spec_k=3)
    ref, _ = _staged(JAX, cfg, jm, jp, **kw)
    got, _ = _staged(PORT, cfg, tm, tp, **kw)
    assert _tokens(got) == _tokens(ref)


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_in_port_invariants_hold_when_nothing_drops(backend):
    """At a dropless capacity factor (cf = E) the reference's invariants
    hold bit for bit inside the port: dense == paged, chunked == whole
    prompt, spec on == off, prefix cache on == off, preempted ==
    unpreempted."""
    cfg, _, _, tm, tp = _dropless("granite-moe-3b-a800m")
    other = "paged" if backend == "dense" else "dense"
    base, eng = _staged(PORT, cfg, tm, tp, kv_backend=backend)
    assert sum(r.preempt_count for r in base) > 0
    want = _tokens(base)
    for kw in (dict(kv_backend=other), dict(prefill_chunk=None,
                                            iter_token_budget=None),
               dict(spec_decode=True, spec_k=3), dict(tight=False)):
        got, _ = _staged(PORT, cfg, tm, tp, **{"kv_backend": backend, **kw})
        assert _tokens(got) == want, kw
    pre = [_staged(PORT, cfg, tm, tp, kv_backend=backend, tight=False,
                   prefix=16, prefix_cache=on) for on in (False, True)]
    assert _tokens(pre[0][0]) == _tokens(pre[1][0])
    assert pre[1][1].kv.prefix_stats().hits > 0


@pytest.mark.parametrize("backend", ["paged", "dense"])
def test_warmed_moe_engine_compiles_nothing_while_serving(backend):
    """The compile gate with MoE steps: after ``warmup`` a staged serve
    with INT8 swaps makes no graph key's first use, and every request
    gets its full output (the warmup's measured chunk costs may reorder
    the plan, and with it an MoE's tokens, so these are not compared)."""
    cfg, _, _, tm, tp = _models("granite-moe-3b-a800m")
    cold, _ = _staged(PORT, cfg, tm, tp, kv_backend=backend,
                      quantize_offload=True)
    bpt = kv_bytes_per_token(cfg.num_layers, cfg.num_kv_heads, cfg.hd)
    eng = port_engine.ServingEngine(tm, tp, port_engine.EngineConfig(
        max_slots=2, max_seq_len=64, max_new_tokens=48, strategy="alise",
        quantize_offload=True, hbm_bytes=2 * 40 * bpt, kv_backend=backend,
        page_size=PAGE, prefill_chunk=5, iter_token_budget=16, eos_token=-1,
        warmup_compile=True), predictor=port_predictor.OraclePredictor())
    assert eng.warm_stats["keys"] >= 2
    counter = CompileCounter().require()
    with counter.expect_no_compiles(f"moe serve[{backend}]"):
        reqs = _requests(port_request, cfg)
        t = 0.0
        for r in reqs[:2]:
            eng.submit(r, t)
        for _ in range(5):
            eng.step(t)
            t += 0.1
        for r in reqs[2:]:
            eng.submit(r, t)
        while eng.sched.live:
            eng.step(t)
            t += 0.1
    counter.detach()
    assert counter.count == 0 and all(r.done for r in reqs)
    assert sum(r.preempt_count for r in reqs) > 0
    assert [len(r.output_tokens) for r in reqs] == [len(o) for o in
                                                    _tokens(cold)]


@pytest.mark.parametrize("backend", ["paged", "dense"])
def test_serve_launcher_serves_moe_on_the_cpu(backend):
    """``launch/serve.py --arch granite-moe-3b-a800m`` at the smoke size:
    every request finishes on either backend, warmed."""
    from repro_torch.launch.serve import serve
    reqs, eng = serve(arch="granite-moe-3b-a800m", n_requests=6,
                      kv_backend=backend, prefill_chunk=8, warmup=True,
                      device="cpu", verbose=False)
    assert eng.model.cfg.has_moe and eng.warm_stats is not None
    assert all(r.finish_time is not None and r.output_tokens for r in reqs)
