"""The port's encoder-decoder family and ``embeds`` input against the JAX
package, and the invariants inside the port.

seamless-m4t-large-v2's smoke config (2 + 2 layers, d_model 64, 4 heads,
LayerNorm, gelu, 32 encoder frames) in float32: ``_encode``, ``_cross_kv``,
``prefill`` (logits and its ``k``/``v``/``xk``/``xv``), four
``decode_step``s, the loss and every gradient leaf (the encoder's and the
cross sublayers' included), and a serve driven through each package's
``DenseKVBackend`` (``Model.prefill``, ``write_prefill``, the fused
decode, an INT8 ``offload``/``upload``): the reference's engine cannot
prefill an encoder-decoder (its requests carry no ``enc_embeds``), so the
backend is the serving path, and the port's engine refuses the family.
internvl2-2b's smoke config feeds patch embeddings (``embeds``) to
``prefill`` and ``loss``; ``embeds = embed[tokens]`` must give the token
path bit for bit.  stablelm-3b at head dim 80 (the flash kernels' new
width on the card) runs its plain path against the reference.  Weights
come from the JAX ``Model.init`` through ``params_from_numpy``; logits
within 1e-4 and caches within 1e-5 (float32, XLA vs torch summation
order), as ``tests/test_torch_moe.py`` holds them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import kv_cache as jax_kv  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.models.model import Model, params_from_numpy  # noqa: E402
from repro_torch.serving import kv_cache as port_kv  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

SEAMLESS = "seamless-m4t-large-v2"
VLM = "internvl2-2b"
ATOL = 1e-4          # float32 logits, XLA vs torch summation order
CACHE_ATOL = 1e-5    # float32 K/V

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


def _models(name, **kw):
    """(cfg, JAX model, JAX params, port model, port params), built once
    per config."""
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


def _t(a):
    return torch.from_numpy(np.array(a))      # an own, writable copy


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0, err_msg=what)


def _frames(cfg, B, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.cross_kv_len, cfg.d_model)).astype(np.float32)


# -------------------------------------------------------- seamless: model

def test_params_split_every_stack():
    """``params_from_numpy`` splits ``layers``, ``cross`` (decoder depth)
    and ``encoder`` (encoder depth) into one dict per layer, in the
    reference's layout, and ``Model.init`` draws the same tree."""
    cfg, _, jp, tm, tp = _models(SEAMLESS)
    assert len(tp["layers"]) == len(tp["cross"]) == cfg.num_layers
    assert len(tp["encoder"]) == cfg.num_encoder_layers
    assert sorted(tp["cross"][0]) == ["lnx", "xattn"]
    assert sorted(tp["encoder"][0]) == ["attn", "ffn", "ln1", "ln2"]
    np.testing.assert_array_equal(tp["encoder"][1]["attn"]["wq"].numpy(),
                                  np.asarray(jp["encoder"]["attn"]["wq"][1]))
    drawn = tm.init(torch.Generator().manual_seed(0))
    want = sorted((p, tuple(t.shape)) for p, t in tree_leaves(tp))
    assert sorted((p, tuple(t.shape)) for p, t in tree_leaves(drawn)) == want


def test_encode_and_cross_kv_match_jax():
    cfg, jm, jp, tm, tp = _models(SEAMLESS)
    x = _frames(cfg, 2)
    jenc = jm._encode(jp, jnp.asarray(x))
    tenc = tm._encode(tp, _t(x))
    _close(tenc, jenc, CACHE_ATOL, "encoder output")
    jx = jm._cross_kv(jp, jenc)
    tx = tm._cross_kv(tp, _t(np.asarray(jenc)))
    for key in ("xk", "xv"):
        assert tuple(tx[key].shape) == (cfg.num_layers, 2, cfg.cross_kv_len,
                                        cfg.num_kv_heads, cfg.hd)
        _close(tx[key], jx[key], CACHE_ATOL, key)


@pytest.fixture(scope="module")
def prefilled():
    """Both packages' prefill of two requests (32 frames, a 1-token
    decoder start each)."""
    cfg, jm, jp, tm, tp = _models(SEAMLESS)
    x = _frames(cfg, 2, seed=1)
    toks = np.array([[3], [7]], np.int32)
    jl, jc = jm.prefill(jp, {"enc_embeds": jnp.asarray(x),
                             "tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"enc_embeds": _t(x), "tokens": _t(toks)})
    return jl, jc, tl, tc


def test_prefill_matches_jax(prefilled):
    jl, jc, tl, tc = prefilled
    _close(tl, jl, ATOL, "logits")
    assert sorted(tc) == sorted(jc) == ["k", "lengths", "v", "xk", "xv"]
    assert tc["lengths"].tolist() == [1, 1]
    for key in ("k", "v", "xk", "xv"):
        assert tuple(tc[key].shape) == tuple(jc[key].shape)
        _close(tc[key], jc[key], CACHE_ATOL, key)


def _decode_caches(cfg, jm, tm, jc, tc, B, Smax):
    """Both packages' decode caches of ``B`` lanes and ``Smax`` positions
    holding a prefill's 1-token K/V and its cross K/V."""
    jcache = jm.init_cache(B, Smax)
    tcache = tm.init_cache(B, Smax)
    for key in ("k", "v"):
        jcache[key] = jcache[key].at[:, :, :1].set(jc[key])
        tcache[key][:, :, :1] = tc[key]
    for key in ("xk", "xv"):
        jcache[key] = jc[key]
        tcache[key].copy_(tc[key])
    jcache["lengths"] = jnp.ones((B,), jnp.int32)
    tcache["lengths"][:] = 1
    return jcache, tcache


def test_decode_steps_match_jax(prefilled):
    """Four decode steps over caches of 8 positions, each fed the
    reference's greedy tokens: self-attention, cross-attention against the
    static ``xk``/``xv``, the FFN; logits within 1e-4 and the written K/V
    within 1e-5."""
    cfg, jm, jp, tm, tp = _models(SEAMLESS)
    jl, jc, _, tc = prefilled
    jcache, tcache = _decode_caches(cfg, jm, tm, jc, tc, 2, 8)
    nxt = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
    for _ in range(4):
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(nxt))
        tl = tm.decode_step(tp, tcache, _t(nxt))
        _close(tl, jl, ATOL, "decode logits")
        for key in ("k", "v", "xk", "xv"):
            _close(tcache[key], jcache[key], CACHE_ATOL, key)
        assert tcache["lengths"].tolist() == np.asarray(
            jcache["lengths"]).tolist()
        nxt = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)


def test_decode_leaves_inactive_lanes_untouched(prefilled):
    """The port's ``active`` semantics on an encoder-decoder: an inactive
    lane's K/V, cross K/V and length stay as they were, and the active
    lane's logits equal those of a step where every lane is active."""
    cfg, jm, _, tm, tp = _models(SEAMLESS)
    _, jc, _, tc = prefilled
    _, c_all = _decode_caches(cfg, jm, tm, jc, tc, 2, 8)
    _, c_one = _decode_caches(cfg, jm, tm, jc, tc, 2, 8)
    before = {k: v.clone() for k, v in c_one.items()}
    feed = torch.tensor([[5], [9]])
    want = tm.decode_step(tp, c_all, feed)
    got = tm.decode_step(tp, c_one, feed, torch.tensor([True, False]))
    assert torch.equal(got[0], want[0])
    assert c_one["lengths"].tolist() == [2, 1]
    for key in ("k", "v", "xk", "xv"):
        assert torch.equal(c_one[key][:, 1], before[key][:, 1]), key
        assert torch.equal(c_one[key][:, 0], c_all[key][:, 0]), key


@pytest.fixture(scope="module")
def seamless_grads():
    cfg, jm, jp, _, _ = _models(SEAMLESS)
    rng = np.random.default_rng(2)
    tokens = rng.integers(2, cfg.vocab_size, (2, 8)).astype(np.int32)
    batch = {"enc_embeds": rng.standard_normal(
                 (2, 12, cfg.d_model)).astype(np.float32),
             "tokens": tokens,
             "targets": np.roll(tokens, -1, axis=1)}
    (loss, parts), g = jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True)(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    jg = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, g),
                           device="cpu")
    return batch, float(loss), parts, jg


def _loss_and_grads(name, batch):
    """The port's loss on ``batch`` and its gradient leaves (a leaf the
    loss does not read, as ``embed`` under ``embeds``, gets zeros, as
    ``jax.grad`` gives it)."""
    cfg, _, jp, tm, _ = _models(name)
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
    for _, p in tree_leaves(params):
        p.requires_grad_(True)
    loss, parts = tm.loss(params, {k: _t(v) for k, v in batch.items()})
    leaves = list(tree_leaves(params))
    got = torch.autograd.grad(loss, [p for _, p in leaves],
                              allow_unused=True)
    return loss, parts, leaves, [torch.zeros_like(p) if g is None else g
                                 for (_, p), g in zip(leaves, got)]


def test_loss_and_every_gradient_leaf_match_jax(seamless_grads):
    """The loss (cross-entropy over the decoder, the encoder reading 12
    frames) and every gradient leaf, the encoder's, the cross sublayers'
    and ``enc_final_norm``'s included, against ``jax.value_and_grad``."""
    batch, jloss, jparts, jg = seamless_grads
    loss, parts, leaves, got = _loss_and_grads(SEAMLESS, batch)
    assert float(loss.detach()) == pytest.approx(jloss, rel=1e-5)
    for k in ("ce", "zloss"):
        assert float(parts[k].detach()) == pytest.approx(float(jparts[k]),
                                                         rel=1e-5)
    want = dict((str(k), v) for k, v in tree_leaves(jg))
    assert sorted(want) == sorted(str(k) for k, _ in leaves)
    assert any(p[0] == "encoder" for p, _ in leaves)
    assert any(p[0] == "cross" for p, _ in leaves)
    for (path, _), g in zip(leaves, got):
        assert float(g.abs().max()) > 0, path
        np.testing.assert_allclose(g.numpy(), want[str(path)].numpy(),
                                   atol=1e-4, err_msg=str(path))


# ------------------------------------------------- seamless: the backend

def _drive(backend, prefill, decode, requests, swap_step):
    """Serve ``requests`` ``(rid, frames (1, T, D), start token, output
    length)`` through a dense backend, as an engine of the reference's
    backend path would: each request prefilled alone (``prefill(frames,
    tokens) -> (logits, cache)``) when a lane is free, its first token the
    prefill's greedy one, ``write_prefill`` of its 1-token cache, then
    fused decode steps over all lanes (``decode(tokens, active, new_gen,
    new_ctx, true_len, rids) -> (tokens, reasons)``, the backend's
    ``decode``) until every request ends; at decode step ``swap_step``
    the lowest-numbered live request is offloaded and uploaded again.
    Returns ({rid: tokens}, the swap's blob)."""
    B = backend.cfg.max_slots
    pending = list(requests)
    out, true_len, blob = {}, {}, None
    step = 0
    while pending or any(r is not None for r in backend.slot_req):
        while pending and backend.free_slot() is not None:
            rid, frames, start, n = pending.pop(0)
            logits, cache = prefill(frames, np.array([[start]], np.int32))
            out[rid] = [int(np.asarray(logits).argmax(-1)[0])]
            true_len[rid] = n
            backend.write_prefill(rid, cache, 1)
        if step == swap_step:
            rid = min(r for r in backend.slot_req if r is not None)
            blob = backend.offload(rid)
            backend.upload(rid, blob)
        toks = np.zeros((B, 1), np.int32)
        active = np.zeros((B,), bool)
        gen, ctx, tl, rids = (np.zeros((B,), np.int32) for _ in range(4))
        for slot, rid in enumerate(backend.slot_req):
            if rid is None:
                continue
            toks[slot, 0], active[slot], rids[slot] = out[rid][-1], True, rid
            gen[slot] = len(out[rid]) + 1
            ctx[slot] = len(out[rid]) + 1
            tl[slot] = true_len[rid]
        got, reason = decode(toks, active, gen, ctx, tl, rids)
        for slot, rid in enumerate(list(backend.slot_req)):
            if rid is None:
                continue
            out[rid].append(int(got[slot]))
            if int(reason[slot]):
                backend.clear(rid)
        step += 1
    return out, blob


def _serve_requests(cfg):
    rng = np.random.default_rng(5)
    return [(rid, rng.standard_normal((1, cfg.cross_kv_len, cfg.d_model))
             .astype(np.float32), int(rng.integers(2, cfg.vocab_size)), n)
            for rid, n in ((1, 9), (2, 5), (3, 7))]


def test_dense_backend_serve_matches_jax():
    """Three requests through two lanes of each package's
    ``DenseKVBackend`` (``max_seq_len`` 16, INT8 offload, no EOS): the
    third waits for a lane, and one live request is swapped out and back
    at the third step (k/v through INT8, xk/xv raw).  The greedy tokens
    must equal the reference backend's."""
    cfg, jm, jp, tm, tp = _models(SEAMLESS)
    bcfg = dict(max_slots=2, max_seq_len=16, quantize_offload=True,
                eos_token=-1)
    jb = jax_kv.DenseKVBackend(jm, jax_kv.KVBackendConfig(**bcfg))
    tb = port_kv.DenseKVBackend(tm, port_kv.KVBackendConfig(**bcfg))
    reqs = _serve_requests(cfg)
    want, jblob = _drive(
        jb, lambda f, t: jm.prefill(jp, {"enc_embeds": jnp.asarray(f),
                                         "tokens": jnp.asarray(t)}),
        lambda *a: jb.decode(jp, *a), reqs, swap_step=2)
    got, tblob = _drive(
        tb, lambda f, t: tm.prefill(tp, {"enc_embeds": _t(f),
                                         "tokens": _t(t)}),
        lambda *a: tb.decode(tp, *a), reqs, swap_step=2)
    assert got == want
    assert [len(got[r]) for r in (1, 2, 3)] == [9, 5, 7]
    for blob in (jblob, tblob):
        assert [blob[k][0] for k in ("k", "v", "xk", "xv")] == [
            "q8", "q8", "raw", "raw"]
    assert all(r is None for r in tb.slot_req)


def test_write_prefill_and_offload_keep_the_cross_cache():
    """``write_prefill`` trims K/V to the length and zeroes the stripe
    past it, places the cross K/V whole, and refuses a cross cache whose
    frame count is not ``cross_kv_len``; a raw round trip through
    ``offload``/``upload`` restores the lane bit for bit."""
    cfg, _, _, tm, tp = _models(SEAMLESS)
    tb = port_kv.DenseKVBackend(tm, port_kv.KVBackendConfig(
        max_slots=2, max_seq_len=16, quantize_offload=False))
    frames = _t(_frames(cfg, 1, seed=3))
    _, cache = tm.prefill(tp, {"enc_embeds": frames,
                               "tokens": torch.tensor([[4, 6, 8]])})
    tb.cache["k"].fill_(7.0)                      # stale values
    tb.write_prefill(11, cache, 2)
    slot = tb.slot_of(11)
    lane = tb.cache["k"][:, slot]
    assert torch.equal(lane[:, :2], cache["k"][:, 0, :2])
    assert not lane[:, 2:].any()
    assert torch.equal(tb.cache["xk"][:, slot], cache["xk"][:, 0])
    snap = {k: v[:, slot].clone() for k, v in tb.cache.items()
            if k != "lengths"}
    blob = tb.offload(11)
    assert [blob[k][0] for k in ("k", "v", "xk", "xv")] == ["raw"] * 4
    tb.upload(11, blob)
    slot = tb.slot_of(11)
    for key, want in snap.items():
        assert torch.equal(tb.cache[key][:, slot], want), key
    _, short = tm.prefill(tp, {"enc_embeds": frames[:, :20],
                               "tokens": torch.tensor([[4]])})
    with pytest.raises(ValueError, match="cross_kv_len"):
        tb.write_prefill(12, short, 1)
    assert tb.slot_of(12) is None


@pytest.mark.parametrize("call", ["prefill_chunk", "paged_prefill_chunk",
                                  "paged_decode_step", "decode_verify",
                                  "prefill_pack"])
def test_chunked_paged_pack_and_spec_paths_refuse(call):
    """An encoder-decoder has no chunked prefill, paged KV, packs or
    verify-k decode, as in the reference: each guarded entry raises its
    message."""
    cfg, _, _, tm, tp = _models(SEAMLESS)
    assert not (tm.supports_chunked_prefill() or tm.supports_paged()
                or tm.supports_prefill_pack() or tm.supports_spec_decode())
    z = torch.zeros((1, 1), dtype=torch.int64)
    args = {"prefill_chunk": (tp, None, None, z, 0, 1),
            "paged_prefill_chunk": (tp, None, z, None, None, None, 0, 1),
            "paged_decode_step": (tp, None, z, None, None, None, None),
            "decode_verify": (tp, None, z),
            "prefill_pack": (tp, None, None, None, z, None, None)}[call]
    with pytest.raises(ValueError, match="enc_dec=True"):
        getattr(tm, call)(*args)


def test_engine_and_launcher_refuse_the_encoder_decoder():
    """The serving engine refuses an encoder-decoder (its requests carry
    no encoder frames; the reference's engine fails with ``KeyError:
    'enc_embeds'``), and so do ``serve`` and ``serve_gateway``, which
    build engines."""
    from repro_torch.core.engine import EngineConfig, ServingEngine
    from repro_torch.launch.serve import serve, serve_gateway
    _, _, _, tm, tp = _models(SEAMLESS)
    with pytest.raises(NotImplementedError, match="enc_embeds"):
        ServingEngine(tm, tp, EngineConfig(max_slots=2, max_seq_len=16))
    for fn in (serve, serve_gateway):
        with pytest.raises(NotImplementedError, match="encoder-decoder"):
            fn(arch=SEAMLESS, device="cpu")


# ------------------------------------------------------ internvl2: embeds

def _vlm_batch(cfg, seed=6):
    rng = np.random.default_rng(seed)
    embeds = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    embeds[0, 9:] = 0.0                           # right padding
    return embeds, np.array([8, 11], np.int32)


def test_embeds_prefill_matches_jax():
    """Patch embeddings, one row right-padded, its true last position
    named by ``last_index``: logits within 1e-4, K/V within 1e-5."""
    cfg, jm, jp, tm, tp = _models(VLM)
    embeds, last = _vlm_batch(cfg)
    jl, jc = jm.prefill(jp, {"embeds": jnp.asarray(embeds),
                             "last_index": jnp.asarray(last)})
    tl, tc = tm.prefill(tp, {"embeds": _t(embeds), "last_index": _t(last)})
    _close(tl, jl, ATOL, "logits")
    for key in ("k", "v"):
        _close(tc[key], jc[key], CACHE_ATOL, key)


def test_embeds_loss_and_gradients_match_jax():
    cfg, jm, jp, _, _ = _models(VLM)
    embeds, _ = _vlm_batch(cfg, seed=7)
    targets = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    batch = {"embeds": embeds, "targets": targets}
    (jloss, _), g = jax.value_and_grad(lambda p, b: jm.loss(p, b),
                                       has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    jg = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, g),
                           device="cpu")
    loss, _, leaves, got = _loss_and_grads(VLM, batch)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    want = dict((str(k), v) for k, v in tree_leaves(jg))
    for (path, _), g in zip(leaves, got):
        np.testing.assert_allclose(g.numpy(), want[str(path)].numpy(),
                                   atol=1e-4, err_msg=str(path))


def test_embeds_of_the_embedding_rows_equal_the_token_path():
    """``embeds = embed[tokens]`` gives the token path's prefill logits,
    K/V and loss bit for bit."""
    cfg, _, _, tm, tp = _models(VLM)
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        2, cfg.vocab_size, (2, 10)))
    embeds = tp["embed"][tokens]
    a = tm.prefill(tp, {"tokens": tokens})
    b = tm.prefill(tp, {"embeds": embeds})
    assert torch.equal(a[0], b[0])
    for key in ("k", "v"):
        assert torch.equal(a[1][key], b[1][key])
    targets = torch.roll(tokens, -1, 1)
    la, _ = tm.loss(tp, {"tokens": tokens, "targets": targets})
    lb, _ = tm.loss(tp, {"embeds": embeds, "targets": targets})
    assert torch.equal(la, lb)


# --------------------------------------------------------------- training

@pytest.mark.parametrize("name", [SEAMLESS, VLM])
def test_train_step_with_the_references_batches(name):
    """``launch/train.py`` builds the reference launcher's batches (the
    one-hot frames of ``tokens % d_model`` as ``enc_embeds`` beside the
    tokens, or as ``embeds`` in their place), equal to the reference's
    ``jax.nn.one_hot``, and its first step's loss is ``Model.loss`` of the
    initial parameters on that batch."""
    from repro_torch.launch.train import model_batch, train
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.train_step import init_train_state
    cfg = port_configs.get_smoke_config(name).scaled(param_dtype="float32")
    stream = next(SyntheticLM(cfg, DataConfig(batch_size=2, seq_len=16))
                  .iterate(device="cpu"))
    batch = model_batch(cfg, stream)
    key = "enc_embeds" if cfg.is_encoder_decoder else "embeds"
    assert ("tokens" in batch) == cfg.is_encoder_decoder
    want = jax.nn.one_hot(jnp.asarray(stream["tokens"].numpy())
                          % cfg.d_model, cfg.d_model)
    np.testing.assert_array_equal(batch[key].numpy(), np.asarray(want))
    _, losses, _ = train(name, smoke=True, steps=2, batch_size=2, seq_len=16,
                         log_every=100, device="cpu")
    model = Model(cfg, attn_chunk=8, ssd_chunk=16, device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        first, _ = model.loss(state["params"], batch)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[0] == pytest.approx(float(first), rel=1e-6)


@pytest.mark.parametrize("embeds", [False, True])
def test_train_step_refuses_a_leaf_the_loss_does_not_reach(embeds):
    """Under ``embeds`` the untied ``embed`` table alone may go unread (it
    gets a zero gradient); any other leaf the loss does not reach raises,
    with or without ``embeds``."""
    from repro_torch.launch.train import model_batch
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    cfg = port_configs.get_smoke_config(VLM).scaled(param_dtype="float32")
    assert not cfg.tie_embeddings
    stream = next(SyntheticLM(cfg, DataConfig(batch_size=2, seq_len=16))
                  .iterate(device="cpu"))
    batch = model_batch(cfg, stream) if embeds else stream
    assert ("embeds" in batch) == embeds
    model = Model(cfg, attn_chunk=8, ssd_chunk=16, device="cpu")
    step = make_train_step(model)
    state = init_train_state(model, torch.Generator().manual_seed(0))
    state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    stray = torch.zeros(3, requires_grad=True)
    state["params"]["stray"] = stray
    state["m"]["stray"] = torch.zeros(3)
    state["v"]["stray"] = torch.zeros(3)
    with pytest.raises(RuntimeError, match="stray"):
        step(state, batch)


# ---------------------------------------------------- stablelm at head 80

def test_stablelm_head_dim_80_plain_path_matches_jax():
    """stablelm-3b's head dim 80 (the flash kernels' third width on the
    card) on the CPU's plain path: a prefill of two 9-token prompts and a
    decode step over the cache padded to 16 positions, logits within
    1e-4; the kernels' head dims name 80."""
    from repro_torch.kernels.flash_prefill.ops import HEAD_DIMS
    assert 80 in HEAD_DIMS
    cfg, jm, jp, tm, tp = _models("stablelm-3b", head_dim=80)
    assert cfg.hd == 80
    toks = np.random.default_rng(10).integers(
        2, cfg.vocab_size, (2, 9)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": _t(toks)})
    _close(tl, jl, ATOL, "prefill logits")
    kv = {k: np.pad(np.asarray(jc[k]),
                    ((0, 0), (0, 0), (0, 7), (0, 0), (0, 0)))
          for k in ("k", "v")}
    nxt = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
    jl, _ = jm.decode_step(jp, {"lengths": jc["lengths"],
                                **{k: jnp.asarray(v) for k, v in kv.items()}},
                           jnp.asarray(nxt))
    tl = tm.decode_step(tp, {"lengths": tc["lengths"],
                             **{k: _t(v) for k, v in kv.items()}}, _t(nxt))
    _close(tl, jl, ATOL, "decode logits")
