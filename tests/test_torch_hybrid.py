"""The port's hybrid family (Jamba: Mamba-2 and attention layers, dense and
MoE FFNs) against the JAX package, the expert share of an MoE layer, and
the SSD chunk's split of a 128-column head.

jamba-1.5-large-398b's smoke config (one 8-layer group: Mamba layers 0-2
and 4-7, attention at 3, MoE on odd layers, d_model 64, 4 experts top 2,
Mamba heads of 16, state 16) in float32, at the config's capacity factor
(1.25) for the model methods: ``prefill`` (logits and the whole cache in
the reference's ``(g, ...)`` / ``(g, 7, ...)`` layout), four
``decode_step``s, the loss and every gradient leaf (the reference's
group-stacked gradient carried through ``params_from_numpy``).  The
engine serve runs at a dropless capacity factor (cf = E): MoE capacity
couples the lanes of a step, and the port leaves an idle lane's Mamba
state unstepped where the reference steps it with token 0, so an idle
lane's routing may differ from the reference's; at cf = E nothing drops
and no lane's tokens depend on another's.  Weights come from the JAX
``Model.init`` through ``params_from_numpy``.  Tolerances: logits 1e-4
(float32, XLA vs torch summation order), K/V and conv state 1e-5, the f32
SSM state 1e-4 (a sum over every position of the prompt), gradients
1e-4, the MoE layer's shares 2e-5 absolute and relative (float32 sums of
the same products in another order, as ``tests/test_torch_moe.py`` holds
the layer).
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
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.core import engine as port_engine  # noqa: E402
from repro_torch.core import predictor as port_predictor  # noqa: E402
from repro_torch.core import request as port_request  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import plan as ssd_plan  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import (HYBRID_ORDER, Model,  # noqa: E402
                                      params_from_numpy)
from repro_torch.serving import kv_cache as port_kv  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

JAMBA = "jamba-1.5-large-398b"
ATOL = 1e-4          # float32 logits and gradients
CACHE_ATOL = 1e-5    # float32 K/V and conv windows
SSM_ATOL = 1e-4      # the float32 SSM state, a sum over the prompt

_MODELS = {}


def _cfg(name, **kw):
    """The port's copy of ``name``'s smoke config in float32; it must equal
    the reference's."""
    cfg = dataclasses.replace(port_configs.get_smoke_config(name),
                              param_dtype="float32", **kw)
    ref = dataclasses.replace(get_smoke_config(name), param_dtype="float32",
                              **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    return cfg


def _models(name=JAMBA, **kw):
    """(cfg, JAX model, JAX params, numpy params, port model, port params),
    built once per config; the same weights at every capacity factor."""
    key = (name, tuple(sorted(kw.items())))
    if key not in _MODELS:
        cfg = _cfg(name, **kw)
        jm = JaxModel(cfg, kv_dtype="float32", remat=False)
        jp = jm.init(jax.random.PRNGKey(0))
        npp = jax.tree_util.tree_map(np.asarray, jp)
        _MODELS[key] = (cfg, jm, jp, npp,
                        Model(cfg, kv_dtype="float32", device="cpu"),
                        params_from_numpy(cfg, npp, device="cpu"))
    return _MODELS[key]


def _dropless():
    return _models(capacity_factor=float(get_smoke_config(JAMBA)
                                         .num_experts))


def _t(a):
    return torch.from_numpy(np.array(a))      # an own, writable copy


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want), atol=atol, rtol=0,
                               err_msg=what)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, shape).astype(np.int32)


# ------------------------------------------------------------ the model

def test_params_follow_the_references_group_layout():
    """``params_from_numpy`` unstacks the reference's group (``sd`` (g, 4),
    ``sm`` (g, 3), ``am`` (g,)) into one dict per absolute layer ``8 g +
    j`` from stack ``HYBRID_ORDER[j]``, each layer's mixer and FFN the
    kinds ``cfg.layer_kind``/``cfg.ffn_kind`` name; ``Model.init`` draws
    the same tree."""
    cfg, _, _, npp, tm, tp = _models()
    assert len(tp["layers"]) == cfg.num_layers == 8
    for i, p_l in enumerate(tp["layers"]):
        stack, idx = HYBRID_ORDER[i]
        want = npp["layers"][stack]
        src = (want["ln1"]["scale"][0] if stack == "am"
               else want["ln1"]["scale"][0, idx])
        np.testing.assert_array_equal(p_l["ln1"]["scale"].numpy(), src)
        mixer = "attn" if cfg.layer_kind(i) == "attn" else "ssm"
        assert set(p_l) == {"ln1", mixer, "ln2", "ffn"}
        assert ("router" in p_l["ffn"]) == (cfg.ffn_kind(i) == "moe")
    np.testing.assert_array_equal(
        tp["layers"][5]["ffn"]["wi"].numpy(), npp["layers"]["sm"]["ffn"]
        ["wi"][0, 1])
    drawn = tm.init(torch.Generator().manual_seed(0))
    want = sorted((p, tuple(t.shape)) for p, t in tree_leaves(tp))
    assert sorted((p, tuple(t.shape)) for p, t in tree_leaves(drawn)) == want


def test_cache_shapes_and_capabilities_follow_the_reference():
    """The dense cache's keys, shapes and dtypes are the reference's
    (``k``/``v`` (g, B, S, KVH, hd), ``conv``/``ssm`` (g, 7, B, ...)); the
    hybrid family has no chunked prefill, paged backend, packs or
    speculation, as the reference's; the chunked and paged entry points
    refuse it."""
    cfg, jm, _, _, tm, _ = _models()
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in jm.cache_shapes(3, 40).items()}
    got = {k: (tuple(s), str(d).replace("torch.", ""))
           for k, (s, d) in tm.cache_shapes(3, 40).items()}
    assert got == want
    assert list(got) == list(want)
    assert not (tm.supports_chunked_prefill() or tm.supports_paged()
                or tm.supports_prefill_pack() or tm.supports_spec_decode())
    assert tm.supports_chunked_prefill() == jm.supports_chunked_prefill()
    with pytest.raises(ValueError, match="family=hybrid"):
        tm.prefill_chunk({}, None, None, torch.zeros((1, 4)), 0, 4)
    with pytest.raises(ValueError, match="family=hybrid"):
        tm.paged_decode_step({}, {}, torch.zeros((1, 1)), None, None, None,
                             None)
    with pytest.raises(ValueError, match="no paged KV"):
        port_engine.ServingEngine(tm, {}, port_engine.EngineConfig(
            kv_backend="paged"))


@pytest.fixture(scope="module")
def prefilled():
    """Both packages' prefill of two unpadded 11-token prompts (one SSD
    chunk of 11 rows in each)."""
    cfg, jm, jp, _, tm, tp = _models()
    toks = _tokens(cfg, (2, 11), 1)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": _t(toks)})
    return jl, jc, tl, tc


def test_prefill_logits_and_cache_match_jax(prefilled):
    jl, jc, tl, tc = prefilled
    _close(tl, jl, ATOL, "logits")
    assert list(tc) == list(jc) == ["lengths", "k", "v", "conv", "ssm"]
    assert tc["lengths"].tolist() == [11, 11]
    for key, tol in (("k", CACHE_ATOL), ("v", CACHE_ATOL),
                     ("conv", CACHE_ATOL), ("ssm", SSM_ATOL)):
        assert tuple(tc[key].shape) == np.asarray(jc[key]).shape, key
        _close(tc[key], jc[key], tol, key)


def _padded(jc, extra):
    """The reference's prefill cache with ``extra`` free K/V positions."""
    pad = ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0))
    return {**jc, **{k: jnp.asarray(np.pad(np.asarray(jc[k]), pad))
                     for k in ("k", "v")}}


def test_decode_steps_match_jax(prefilled):
    """Four ``decode_step``s over both lanes, each fed the reference's
    greedy token: logits within 1e-4, and the cache after them."""
    cfg, jm, jp, _, tm, tp = _models()
    jl, jc, _, _ = prefilled
    jcache = _padded(jc, 5)
    tcache = {k: _t(v) for k, v in jcache.items()}
    nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    for step in range(4):
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(nxt))
        tl = tm.decode_step(tp, tcache, _t(nxt))
        _close(tl, jl, ATOL, f"step {step}")
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    assert tcache["lengths"].tolist() == [15, 15]
    for key, tol in (("k", CACHE_ATOL), ("v", CACHE_ATOL),
                     ("conv", CACHE_ATOL), ("ssm", SSM_ATOL)):
        _close(tcache[key], jcache[key], tol, key)


def test_decode_leaves_inactive_lanes_untouched(prefilled):
    """With ``active``, an inactive lane keeps its K/V stripe, conv window
    and SSM state bit for bit and its length, while the active lane
    advances exactly as a full-lane step advances it."""
    cfg, _, _, _, tm, tp = _dropless()
    _, jc, _, _ = prefilled
    cache = {k: _t(v) for k, v in _padded(jc, 5).items()}
    full = {k: v.clone() for k, v in cache.items()}
    toks = _t(np.array([[5], [9]], np.int32))
    tm.decode_step(tp, full, toks)
    tm.decode_step(tp, cache, toks, active=torch.tensor([True, False]))
    before = {k: _t(v) for k, v in _padded(jc, 5).items()}
    assert cache["lengths"].tolist() == [12, 11]
    for key, lane_axis in (("k", 1), ("v", 1), ("conv", 2), ("ssm", 2)):
        assert torch.equal(cache[key].select(lane_axis, 1),
                           before[key].select(lane_axis, 1)), key
        assert torch.equal(cache[key].select(lane_axis, 0),
                           full[key].select(lane_axis, 0)), key


@pytest.fixture(scope="module")
def jamba_grads():
    cfg, jm, jp, _, _, _ = _models()
    toks = _tokens(cfg, (2, 16), 2)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    (loss, parts), g = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    jg = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, g),
                           device="cpu")
    return batch, float(loss), parts, jg


def test_loss_and_every_gradient_leaf_match_jax(jamba_grads):
    """The loss (cross-entropy, z-loss, the four MoE layers' aux term) and
    every gradient leaf, the Mamba layers', the attention layer's and the
    routers' included, against ``jax.value_and_grad`` of the reference's
    loss, its group-stacked gradient carried through ``params_from_numpy``:
    the loss within 1e-5 relative, each leaf nonzero and within 1e-4."""
    batch, jloss, jparts, jg = jamba_grads
    cfg, _, _, npp, tm, _ = _models()
    params = params_from_numpy(cfg, npp, device="cpu")
    for _, p in tree_leaves(params):
        p.requires_grad_(True)
    loss, parts = tm.loss(params, {k: _t(v) for k, v in batch.items()})
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
                                   atol=ATOL, err_msg=str(path))


# ----------------------------------------------------- the expert share

@pytest.mark.parametrize("name,layer", [(JAMBA, 1),
                                        ("granite-moe-3b-a800m", 0)])
def test_expert_shares_sum_to_the_whole_layer(name, layer):
    """One MoE layer over 24 tokens in 2 dispatch groups, steered toward
    expert 0 so that it overflows its capacity at the config's factor:
    the shares (0, 2) + (1, 2), and the four shares of 4, each with only
    its experts' ``wi``/``wg``/``wo``, sum to the port's whole layer and
    to the JAX ``apply_moe``; the aux loss is the whole layer's in every
    share."""
    cfg, _, _, npp, _, _ = _models(name)
    tp = params_from_numpy(cfg, npp, device="cpu")
    p = tp["layers"][layer]["ffn"]
    jp_l = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    x = (np.random.default_rng(7).standard_normal((2, 12, cfg.d_model))
         + 40 * p["router"][:, 0].numpy()).astype(np.float32)
    _, idx, _, E_alloc = L._route(cfg, p, _t(x).reshape(2, 12, -1))
    keep = L._dispatch_plan(idx.reshape(2, -1), E_alloc,
                            L.moe_capacity(cfg, 12))[1]
    assert keep.any() and not keep.all()       # some dropped, some kept
    whole, aux = L.apply_moe(cfg, p, _t(x), groups=2)
    jy, jaux = JL.apply_moe(cfg, jp_l, jnp.asarray(x), groups=2)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    np.testing.assert_allclose(whole.numpy(), np.asarray(jy), atol=2e-5,
                               rtol=2e-5)
    E = cfg.num_experts
    for count in (2, 4):
        total = torch.zeros_like(whole)
        for index in range(count):
            lo, hi = index * E // count, (index + 1) * E // count
            held = {**p, **{k: p[k][lo:hi] for k in ("wi", "wg", "wo")
                            if k in p}}
            y, a = L.apply_moe(cfg, held, _t(x), groups=2,
                               experts=(lo, hi))
            assert torch.equal(a, aux)
            total += y
        for want, what in ((whole.numpy(), "whole"), (np.asarray(jy), "JAX")):
            np.testing.assert_allclose(total.numpy(), want, atol=2e-5,
                                       rtol=2e-5,
                                       err_msg=f"{count} shares vs {what}")


def test_model_expert_shard_holds_its_share():
    """``Model(expert_shard=(i, n))`` draws only experts ``[i E / n,
    (i + 1) E / n)`` of every MoE layer (the router whole): its leaves
    have the shapes of that slice of the whole model's; a count that does
    not divide E, a share with padded experts and a family without
    experts are refused."""
    cfg, _, _, npp, _, _ = _models()
    E = cfg.num_experts
    half = Model(cfg, expert_shard=(1, 2), device="cpu")
    drawn = half.init(torch.Generator().manual_seed(0))
    whole = params_from_numpy(cfg, npp, device="cpu")
    n_moe = 0
    for p_d, p_w in zip(drawn["layers"], whole["layers"]):
        if "router" not in p_w.get("ffn", {}):
            continue
        n_moe += 1
        for name, w in p_w["ffn"].items():
            want = w[E // 2:] if name in ("wi", "wg", "wo") else w
            assert p_d["ffn"][name].shape == want.shape, name
        assert tuple(p_d["ffn"]["router"].shape) == (cfg.d_model, E)
    assert n_moe == cfg.num_layers // 2
    assert half.experts == (E // 2, E)
    with pytest.raises(ValueError, match="equal shares"):
        Model(cfg, expert_shard=(0, 3), device="cpu")
    with pytest.raises(ValueError, match="pad_experts_to"):
        Model(cfg, expert_shard=(0, 2), pad_experts_to=8, device="cpu")
    with pytest.raises(ValueError, match="equal shares"):
        Model(_cfg("mamba2-2.7b"), expert_shard=(0, 2), device="cpu")


# ------------------------------------------------- the SSD chunk split

def test_ssd_chunk_split_of_a_128_column_head():
    """jamba's Mamba heads have 128 columns; the tensor-core body takes
    64, so the wrapper runs a head as two of 64 with the same decay
    (``split_heads``, ``join_heads``).  At P 128 the plan names that body
    and a split of 2; the plain version on the split inputs, joined, equals
    the plain version on the whole heads (float32: one head's columns
    never mix, 1e-5 for the reordered sums)."""
    assert ssd_plan.head_split(128) == 2 and ssd_plan.head_split(64) == 1
    assert ssd_plan.body(256, 128, 128) == "tf32x3"
    assert ssd_plan.body(256, 128, 64) == ssd_plan.body(256, 96, 128) == \
        "fma"
    rng = np.random.default_rng(31)
    B, C, Q, H, P, N = 1, 2, 32, 3, 128, 16
    xbar = _t(rng.standard_normal((B, C, Q, H, P)).astype(np.float32))
    dA = _t(-np.log1p(np.exp(rng.standard_normal((B, C, Q, H))))
            .astype(np.float32))
    Bc, Cc = (_t(rng.standard_normal((B, C, Q, N)).astype(np.float32))
              for _ in range(2))
    xs, dAs = ssd_ops.split_heads(xbar, dA, 2)
    assert tuple(xs.shape) == (B, C, Q, 2 * H, 64)
    assert xs.data_ptr() == xbar.data_ptr()          # a view, no copy
    got = ssd_ops.join_heads(*ssd_chunk_ref(xs, dAs, Bc, Cc), 2)
    want = ssd_chunk(xbar, dA, Bc, Cc)               # CPU: the plain one
    for g, w, name in zip(got, want, ("y", "states", "decay")):
        assert g.shape == w.shape, name
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ serving

PROMPTS = (7, 8, 9, 15, 16, 17)
OUTS = (24, 24, 3, 3, 3, 3)


def _staged(mods, cfg, model, params, offloads=None):
    """tests/test_torch_moe.py's staged trace on the dense backend at a
    virtual clock: two requests, five steps, then four more, two lanes
    and a memory budget of two short sequences, so requests are preempted
    and swapped out (INT8 K/V) and back; ``offloads`` collects the port
    backend's blobs' kinds."""
    eng_mod, pred_mod, req_mod = mods
    req_mod.reset_request_counter()
    rng = np.random.default_rng(3)
    reqs = [req_mod.Request(
        prompt_len=p, arrival_time=0.0, true_out_len=o,
        prompt_tokens=rng.integers(2, cfg.vocab_size, p).tolist())
        for p, o in zip(PROMPTS, OUTS)]
    bpt = kv_bytes_per_token(cfg.num_layers, cfg.num_kv_heads, cfg.hd)
    eng = eng_mod.ServingEngine(model, params, eng_mod.EngineConfig(
        max_slots=2, max_seq_len=64, max_new_tokens=48, strategy="alise",
        quantize_offload=True, hbm_bytes=2 * 40 * bpt, kv_backend="dense",
        eos_token=-1), predictor=pred_mod.OraclePredictor())
    if offloads is not None:
        inner = eng.kv.offload

        def offload(rid):
            blob = inner(rid)
            offloads.append({k: v[0] for k, v in blob.items()
                             if k != "lengths"})
            return blob
        eng.kv.offload = offload
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


def test_engine_serve_matches_jax_engine():
    """The engine on the dense backend (each prompt prefilled whole and
    unpadded, the fused decode step over both lanes) with preemptions
    swapped through INT8 (K/V quantized, conv and SSM state raw) emits
    the JAX engine's greedy tokens, with the same preemptions, at a
    dropless capacity factor."""
    cfg, jm, jp, _, tm, tp = _dropless()
    ref = _staged((jax_engine, jax_predictor, jax_request), cfg, jm, jp)
    kinds = []
    got = _staged((port_engine, port_predictor, port_request), cfg, tm, tp,
                  kinds)
    assert [list(r.output_tokens) for r in got] == \
        [list(r.output_tokens) for r in ref]
    assert [r.preempt_count for r in got] == [r.preempt_count for r in ref]
    assert sum(r.preempt_count for r in got) > 0
    assert kinds and all(k == {"k": "q8", "v": "q8", "conv": "raw",
                               "ssm": "raw"} for k in kinds)


def test_dense_backend_swap_round_trip(prefilled):
    """``write_prefill`` places a prefill's lane (K/V trimmed to its
    length, conv and SSM state whole) and ``offload`` sends it to the
    host: K/V as INT8 over a pow2 span of the sequence axis of each
    (g, S, KVH, hd) lane, conv and SSM state raw; ``upload`` into another
    lane restores conv and SSM bit for bit, the length, and K/V within the
    INT8 round trip (2% of the row's range)."""
    cfg, _, _, _, tm, _ = _models()
    _, _, _, tc = prefilled
    kv = port_kv.DenseKVBackend(tm, port_kv.KVBackendConfig(
        max_slots=3, max_seq_len=40, quantize_offload=True))
    kv.slot_req[0] = 99
    kv.write_prefill(5, tc, 11)
    assert kv.slot_of(5) == 1 and int(kv.cache["lengths"][1]) == 11
    assert torch.equal(kv.cache["ssm"][:, :, 1], tc["ssm"][:, :, 0])
    assert not kv.cache["k"][:, 1, 11:].any()
    blob = kv.offload(5)
    assert {k: v[0] for k, v in blob.items() if k != "lengths"} == {
        "k": "q8", "v": "q8", "conv": "raw", "ssm": "raw"}
    assert blob["k"][1][3][:2] == (1, 16)          # a pow2 span of 11
    kv.slot_req[1] = 98                    # the lane is taken meanwhile
    kv.cache["ssm"].normal_()
    kv.upload(5, blob)
    lane = kv.slot_of(5)
    assert lane == 2 and int(kv.cache["lengths"][lane]) == 11
    for key in ("conv", "ssm"):
        assert torch.equal(kv.cache[key][:, :, lane], tc[key][:, :, 0])
    span = kv.cache["k"][:, lane]
    assert not span[:, 11:].any()
    for key in ("k", "v"):
        got, want = kv.cache[key][:, lane, :11], tc[key][:, 0]
        width = want.amax(-1, keepdim=True) - want.amin(-1, keepdim=True)
        assert bool(((got - want).abs() <= 0.02 * width + 1e-6).all()), key


def test_serve_launcher_serves_jamba_on_the_cpu():
    """``serve(arch="jamba-1.5-large-398b", arch_size="smoke",
    device="cpu")``, warmed: every request finishes on the dense
    backend."""
    from repro_torch.launch.serve import serve
    reqs, eng = serve(arch=JAMBA, n_requests=6, warmup=True, device="cpu",
                      verbose=False)
    assert eng.model.cfg.family == "hybrid" and eng.kv_backend == "dense"
    assert eng.warm_stats is not None
    assert all(r.finish_time is not None and r.output_tokens for r in reqs)
