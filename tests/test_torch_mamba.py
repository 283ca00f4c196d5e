"""The port's Mamba-2 path against the JAX package: the SSD chunk and fused
RMSNorm kernels' plain versions, the SSD scan, the Mamba-2 block, the
model's monolithic prefill and recurrent decode, and the engine on the
dense state backend; plus the serving invariants inside the port.

Inputs are made with numpy from a seed and handed to both packages; the
weights come from the JAX ``init`` functions and cross into torch through
numpy.  The model is ``get_smoke_config("mamba2-2.7b")`` (2 layers,
d_model 64, 8 heads of 16, state 16) in float32.  Tolerances: the SSD
kernel 1e-4 (as ``tests/test_kernels_ssd.py``), RMSNorm float32 2e-5 and
bfloat16 5e-2 (as ``tests/test_kernels.py``), float32 logits 1e-4 (XLA and
torch sum in different orders).
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
from repro.kernels.fused_rmsnorm import fused_rmsnorm_op, rmsnorm_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_chunk as jax_ssd_chunk  # noqa: E402
from repro.kernels.ssd_scan import ssd_chunked_fused as jax_fused  # noqa: E402
from repro.models import mamba2 as JM  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro_torch.core import engine as port_engine  # noqa: E402
from repro_torch.core import predictor as port_predictor  # noqa: E402
from repro_torch.core import request as port_request  # noqa: E402
from repro_torch.kernels.fused_rmsnorm import fused_rmsnorm  # noqa: E402
from repro_torch.kernels.ssd_scan import (ssd_chunk, ssd_chunk_ref,  # noqa: E402
                                          ssd_chunked_fused)
from repro_torch.models import mamba2 as M  # noqa: E402
from repro_torch.models.model import Model, params_from_numpy  # noqa: E402
from repro_torch.serving.kv_cache import (DenseKVBackend,  # noqa: E402
                                          KVBackendConfig)

ATOL = 1e-4
SSD_TOL = 1e-4


def _cfg():
    return dataclasses.replace(get_smoke_config("mamba2-2.7b"),
                               param_dtype="float32")


def _t(a):
    return torch.from_numpy(np.array(a))         # own, writable copy


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _ssd_inputs(rng, B, S, H, P, N):
    """(x, dt, A, Bmat, Cmat) float32 numpy, as the Mamba block makes them:
    dt = softplus(normal), A = -exp(0.2 * normal)."""
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(0.2 * rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    jmodel = JaxModel(cfg, ssd_chunk=8, remat=False, kv_dtype="float32")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return cfg, jmodel, jparams, tparams


def _port_model(cfg):
    return Model(cfg, ssd_chunk=8, kv_dtype="float32", device="cpu")


# ------------------------------------------------------------ the kernels

@pytest.mark.parametrize("B,C,Q,H,P,N", [
    (1, 2, 16, 2, 16, 16), (2, 4, 32, 4, 16, 16), (1, 2, 64, 2, 32, 8),
])
def test_ssd_chunk_plain_matches_pallas(B, C, Q, H, P, N):
    """The wrapper on CPU tensors (its plain version) against the Pallas
    kernel in interpret mode, at the shapes of tests/test_kernels_ssd.py."""
    rng = np.random.default_rng(Q + H)
    xbar = rng.standard_normal((B, C, Q, H, P)).astype(np.float32)
    dA = (-np.abs(rng.standard_normal((B, C, Q, H))) * 0.1).astype(np.float32)
    Bc = rng.standard_normal((B, C, Q, N)).astype(np.float32)
    Cc = rng.standard_normal((B, C, Q, N)).astype(np.float32)
    n0 = ssd_chunk.launches
    out = ssd_chunk(_t(xbar), _t(dA), _t(Bc), _t(Cc))
    assert ssd_chunk.launches == n0          # CPU: the plain version
    ref = jax_ssd_chunk(jnp.asarray(xbar), jnp.asarray(dA), jnp.asarray(Bc),
                        jnp.asarray(Cc), interpret=True)
    assert [tuple(o.shape) for o in out] == [(B, C, Q, H, P), (B, C, H, P, N),
                                             (B, C, H)]
    for o, r in zip(out, ref):
        np.testing.assert_allclose(_np(o), np.asarray(r), rtol=SSD_TOL,
                                   atol=SSD_TOL)


def test_ssd_chunk_plain_is_finite_under_strong_decay():
    """Masking before the exp: a chunk whose decay underflows to 0 far from
    the diagonal gives finite outputs (no inf * 0)."""
    rng = np.random.default_rng(5)
    B, C, Q, H, P, N = 1, 1, 64, 2, 8, 8
    dA = np.full((B, C, Q, H), -30.0, np.float32)
    out = ssd_chunk_ref(_t(rng.standard_normal((B, C, Q, H, P)).astype(
        np.float32)), _t(dA), _t(np.ones((B, C, Q, N), np.float32)),
        _t(np.ones((B, C, Q, N), np.float32)))
    assert all(torch.isfinite(o).all() for o in out)


@pytest.mark.parametrize("S,chunk", [(64, 16), (37, 8), (5, 8)])
def test_ssd_chunked_matches_jax(S, chunk):
    """A multiple of the chunk, a prime S (the reference runs chunks of 1,
    the port pads to a multiple of 8 with dt = 0 rows) and S < chunk."""
    x, dt, A, Bm, Cm = _ssd_inputs(np.random.default_rng(S), 2, S, 4, 16, 8)
    y, s = M.ssd_chunked(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), chunk=chunk)
    jy, js = JM.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                            chunk=chunk)
    assert tuple(y.shape) == (2, S, 4, 16) and tuple(s.shape) == (2, 4, 16, 8)
    np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=SSD_TOL,
                               atol=SSD_TOL)
    np.testing.assert_allclose(_np(s), np.asarray(js), rtol=SSD_TOL,
                               atol=SSD_TOL)


def test_ssd_chunked_continues_from_an_initial_state():
    """Both halves with the state carried == the reference over the whole
    sequence, and the fused op == the JAX fused op (Pallas interpret)."""
    x, dt, A, Bm, Cm = _ssd_inputs(np.random.default_rng(9), 1, 48, 2, 16, 8)
    args = [_t(a) for a in (x, dt, A, Bm, Cm)]
    h = 29                                   # halves of 29 and 19 rows
    y1, s1 = M.ssd_chunked(*[a[:, :h] if a.dim() > 1 else a for a in args],
                           chunk=16)
    y2, s2 = M.ssd_chunked(*[a[:, h:] if a.dim() > 1 else a for a in args],
                           chunk=16, initial_state=s1)
    jy, js = JM.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=16)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), np.asarray(jy),
                               rtol=SSD_TOL, atol=SSD_TOL)
    np.testing.assert_allclose(_np(s2), np.asarray(js), rtol=SSD_TOL,
                               atol=SSD_TOL)
    fy, fs = ssd_chunked_fused(*args, chunk=16, initial_state=s1)
    jfy, jfs = jax_fused(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=16,
                         initial_state=jnp.asarray(_np(s1)), interpret=True)
    np.testing.assert_allclose(_np(fy), np.asarray(jfy), rtol=SSD_TOL,
                               atol=SSD_TOL)
    np.testing.assert_allclose(_np(fs), np.asarray(jfs), rtol=SSD_TOL,
                               atol=SSD_TOL)


@pytest.mark.parametrize("T,d", [(128, 256), (256, 512), (64, 2048)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_rmsnorm_plain_matches_jax(T, d, dtype):
    tol = 5e-2 if dtype == "bfloat16" else 2e-5
    rng = np.random.default_rng(T + d)
    x = rng.standard_normal((T, d)).astype(np.float32)
    s = rng.standard_normal(d).astype(np.float32)
    tdt = getattr(torch, dtype)
    n0 = fused_rmsnorm.launches
    out = fused_rmsnorm(_t(x).to(tdt), _t(s))
    assert fused_rmsnorm.launches == n0 and out.dtype == tdt
    jx = jnp.asarray(x, getattr(jnp, dtype))
    for ref in (rmsnorm_ref(jx, jnp.asarray(s)),
                fused_rmsnorm_op(jx, jnp.asarray(s), interpret=True)):
        np.testing.assert_allclose(_np(out), np.asarray(ref, np.float32),
                                   rtol=tol, atol=tol)


# ------------------------------------------------------------ the block

def _block_params(cfg, seed=1):
    jp = JM.init_mamba_block(cfg, jax.random.PRNGKey(seed), jnp.float32)
    # a non-trivial A, D and dt bias (the reference's init sets constants)
    rng = np.random.default_rng(seed)
    H = cfg.ssm_heads
    jp = {**jp, "A_log": jnp.asarray(0.3 * rng.standard_normal(H), jnp.float32),
          "D_skip": jnp.asarray(rng.standard_normal(H), jnp.float32),
          "dt_bias": jnp.asarray(0.5 * rng.standard_normal(H), jnp.float32)}
    tp = jax.tree_util.tree_map(lambda a: _t(np.asarray(a)), jp)
    return jp, tp


def test_mamba_block_matches_jax():
    """Whole-sequence block from zero state and continued from a state,
    with its returned conv and SSM state."""
    cfg = _cfg()
    jp, tp = _block_params(cfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    out, st = M.mamba_block(cfg, tp, _t(x), chunk=8, return_state=True)
    jout, jst = JM.mamba_block(cfg, jp, jnp.asarray(x), chunk=8,
                               return_state=True)
    np.testing.assert_allclose(_np(out), np.asarray(jout), atol=ATOL,
                               rtol=ATOL)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(_np(st[k]), np.asarray(jst[k]), atol=ATOL,
                                   rtol=ATOL)
    x2 = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    out2 = M.mamba_block(cfg, tp, _t(x2), chunk=8, initial=st)
    jout2 = JM.mamba_block(cfg, jp, jnp.asarray(x2), chunk=8, initial=jst)
    np.testing.assert_allclose(_np(out2), np.asarray(jout2), atol=ATOL,
                               rtol=ATOL)


def test_mamba_decode_step_matches_jax():
    cfg = _cfg()
    jp, tp = _block_params(cfg, seed=3)
    rng = np.random.default_rng(4)
    B, W = 3, cfg.conv_width
    ch = cfg.d_inner + 2 * cfg.ssm_state
    state = {"conv": rng.standard_normal((B, W - 1, ch)).astype(np.float32),
             "ssm": rng.standard_normal((B, cfg.ssm_heads, cfg.ssm_headdim,
                                         cfg.ssm_state)).astype(np.float32)}
    x = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    tstate = {k: _t(v) for k, v in state.items()}
    out, new = M.mamba_decode_step(cfg, tp, _t(x), tstate)
    jout, jnew = JM.mamba_decode_step(
        cfg, jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in state.items()})
    np.testing.assert_allclose(_np(out), np.asarray(jout), atol=ATOL,
                               rtol=ATOL)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(_np(new[k]), np.asarray(jnew[k]),
                                   atol=ATOL, rtol=ATOL)
        np.testing.assert_array_equal(tstate[k].numpy(), state[k])  # inputs


# ------------------------------------------------------------ the model

def test_prefill_and_decode_logits_match_jax(setup):
    """Monolithic prefill of a prime-length prompt, then three decode steps
    over the dense cache: logits and state within 1e-4 of JAX."""
    cfg, jmodel, jparams, tparams = setup
    model = _port_model(cfg)
    rng = np.random.default_rng(6)
    toks = rng.integers(2, cfg.vocab_size, (2, 13)).astype(np.int32)
    logits, cache = model.prefill(tparams, {"tokens": _t(toks).long()})
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL)
    assert cache["lengths"].tolist() == [13, 13]
    for k in ("conv", "ssm"):
        assert tuple(cache[k].shape) == tuple(jcache[k].shape)
        np.testing.assert_allclose(_np(cache[k]), np.asarray(jcache[k]),
                                   atol=ATOL, rtol=ATOL)
    feed = rng.integers(2, cfg.vocab_size, (3, 2, 1)).astype(np.int32)
    for tok in feed:
        out = model.decode_step(tparams, cache, _t(tok).long())
        jout, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(tok))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    assert cache["lengths"].tolist() == [16, 16]
    np.testing.assert_allclose(_np(cache["ssm"]), np.asarray(jcache["ssm"]),
                               atol=ATOL, rtol=ATOL)


def test_decode_step_leaves_inactive_lanes_alone(setup):
    """With ``active``, an inactive lane's state and length stay as they
    were and the active lanes advance exactly as in a full step."""
    cfg, _, _, tparams = setup
    model = _port_model(cfg)
    toks = _t(np.random.default_rng(7).integers(2, cfg.vocab_size, (3, 9))
              ).long()
    _, full = model.prefill(tparams, {"tokens": toks})
    part = {k: v.clone() for k, v in full.items()}
    feed = torch.tensor([[5], [6], [7]])
    a = model.decode_step(tparams, full, feed)
    b = model.decode_step(tparams, part, feed,
                          active=torch.tensor([True, False, True]))
    _, fresh = model.prefill(tparams, {"tokens": toks})
    assert torch.equal(a[[0, 2]], b[[0, 2]])
    assert part["lengths"].tolist() == [10, 9, 10]
    for k in ("conv", "ssm"):
        assert torch.equal(part[k][:, [0, 2]], full[k][:, [0, 2]])
        assert torch.equal(part[k][:, 1], fresh[k][:, 1])


def test_model_family_switches(setup):
    cfg, _, _, tparams = setup
    model = _port_model(cfg)
    assert not model.supports_chunked_prefill() and not model.supports_paged()
    assert set(tparams["layers"][0]) == {"ln1", "ssm"}     # d_ff == 0
    jcache = JM.init_ssm_cache(cfg, 3, jnp.float32)
    tcache = M.init_ssm_cache(cfg, 3, torch.float32)
    assert {k: tuple(v.shape) for k, v in tcache.items()} == {
        k: tuple(v.shape) for k, v in jcache.items()}
    assert tcache["ssm"].dtype == torch.float32
    assert {k: v[0] for k, v in model.cache_shapes(3).items()} == {
        "lengths": (3,), "conv": (cfg.num_layers, *tcache["conv"].shape),
        "ssm": (cfg.num_layers, *tcache["ssm"].shape)}
    init = model.init(torch.Generator().manual_seed(0))
    assert set(init["layers"][0]) == {"ln1", "ssm"}
    assert {k: tuple(v.shape) for k, v in init["layers"][0]["ssm"].items()
            if k != "gate_norm"} == {
        k: tuple(v.shape) for k, v in tparams["layers"][0]["ssm"].items()
        if k != "gate_norm"}
    gran = dataclasses.replace(get_smoke_config("granite-3-8b"),
                               param_dtype="float32")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Model(gran, device="cpu").prefill(None, {"tokens": None})


def test_dense_backend_offload_upload_round_trip(setup):
    """A lane's conv and SSM state cross to the host raw and come back
    bit for bit, into another lane."""
    cfg, _, _, tparams = setup
    model = _port_model(cfg)
    kv = DenseKVBackend(model, KVBackendConfig(max_slots=3, max_seq_len=64,
                                               quantize_offload=True))
    toks = _t(np.random.default_rng(8).integers(2, cfg.vocab_size, (1, 11))
              ).long()
    _, pcache = model.prefill(tparams, {"tokens": toks})
    kv.slot_req[0] = 99                       # lane 0 taken by another rid
    kv.write_prefill(5, pcache, 11)
    assert kv.slot_of(5) == 1
    blob = kv.offload(5)
    assert not kv.has(5) and blob["lengths"] == 11
    assert blob["ssm"][0] == blob["conv"][0] == "raw"
    assert blob["ssm"][1].dtype == torch.float32
    kv.cache["ssm"].normal_()                 # the lane is reused meanwhile
    kv.slot_req[1] = 98
    kv.upload(5, blob)
    slot = kv.slot_of(5)
    assert slot == 2 and int(kv.cache["lengths"][slot]) == 11
    for k in ("conv", "ssm"):
        assert torch.equal(kv.cache[k][:, slot], pcache[k][:, 0])


# ------------------------------------------------------------ the engine

OUTS = (12, 4, 4)


def _requests(req_mod, cfg, outs=OUTS, seed=0):
    """The requests of tests/test_engine.py's Mamba scenario."""
    rng = np.random.default_rng(seed)
    req_mod.reset_request_counter()
    reqs = []
    for out in outs:
        plen = int(rng.integers(6, 12))
        reqs.append(req_mod.Request(
            prompt_len=plen, arrival_time=0.0, true_out_len=out,
            prompt_tokens=rng.integers(2, cfg.vocab_size, plen).tolist()))
    return reqs


def _swap_run(eng_mod, pred_mod, req_mod, cfg, model, params, slots=2,
              **kw):
    """tests/test_engine.py:153's scenario: one request runs three steps,
    then two short ones arrive on a virtual clock."""
    reqs = _requests(req_mod, cfg)
    eng = eng_mod.ServingEngine(model, params, eng_mod.EngineConfig(
        max_slots=slots, max_seq_len=64, max_new_tokens=16, strategy="alise",
        quantize_offload=False, kv_backend="dense", **kw),
        predictor=pred_mod.OraclePredictor())
    t = 0.0
    eng.submit(reqs[0], t)
    for _ in range(3):
        eng.step(t)
        t += 0.1
    for r in reqs[1:]:
        eng.submit(r, t)
    for _ in range(300):
        if not eng.sched.live:
            break
        eng.step(t)
        t += 0.1
    assert not eng.sched.live, "engine did not drain"
    return reqs, eng


def _tokens(reqs):
    return {r.req_id: list(r.output_tokens) for r in reqs}


@pytest.fixture(scope="module")
def port_swap(setup):
    cfg, _, _, tparams = setup
    return _swap_run(port_engine, port_predictor, port_request, cfg,
                     _port_model(cfg), tparams)


def test_engine_tokens_match_jax_under_state_swap(setup, port_swap):
    cfg, jmodel, jparams, _ = setup
    jreqs, _ = _swap_run(jax_engine, jax_predictor, jax_request, cfg, jmodel,
                         jparams)
    reqs, eng = port_swap
    assert _tokens(reqs) == _tokens(jreqs)
    assert [r.preempt_count for r in reqs] == [r.preempt_count for r in jreqs]
    assert sum(r.preempt_count for r in reqs) > 0
    assert all(r.done and r.generated >= 1 for r in reqs)
    assert not eng.host_pool and all(s is None for s in eng.kv.slot_req)


def test_preempted_equals_unpreempted(setup, port_swap):
    """Inside the port, bit for bit: the state-swap run's tokens equal a run
    with lanes for everyone (no preemption)."""
    cfg, _, _, tparams = setup
    roomy, _ = _swap_run(port_engine, port_predictor, port_request, cfg,
                         _port_model(cfg), tparams, slots=4)
    assert sum(r.preempt_count for r in roomy) == 0
    assert _tokens(port_swap[0]) == _tokens(roomy)


def test_prefill_beside_a_decode_keeps_the_new_state(setup):
    """A request prefilled in an iteration that also decodes another one
    emits the tokens it emits alone: the decode step leaves its freshly
    written lane alone.  (The JAX reference advances every lane's SSM
    state in that step, inactive ones with token 0, so there the late
    request's tokens after the first differ; ROADMAP.md Queue 3.)"""
    cfg, _, _, tparams = setup
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, cfg.vocab_size, n).tolist() for n in (9, 7)]

    def run(staged, which):
        port_request.reset_request_counter()
        reqs = [port_request.Request(prompt_len=len(prompts[i]),
                                     arrival_time=0.0, true_out_len=10,
                                     prompt_tokens=prompts[i])
                for i in which]
        eng = port_engine.ServingEngine(
            _port_model(cfg), tparams, port_engine.EngineConfig(
                max_slots=4, max_seq_len=64, max_new_tokens=16,
                strategy="vllm", quantize_offload=False, kv_backend="dense",
                eos_token=-1), predictor=port_predictor.OraclePredictor())
        eng.submit(reqs[0], 0.0)
        for _ in range(2 if staged else 0):
            eng.step(0.0)
        for r in reqs[1:]:
            eng.submit(r, 0.0)
        while eng.sched.live:
            eng.step(0.0)
        return [r.output_tokens for r in reqs]

    assert run(True, [0, 1])[1] == run(False, [1])[0]


def test_engine_backend_choice_is_checked(setup):
    """The backend is the model's own (dense for ``ssm``) unless named;
    naming paged for an ``ssm`` model, or an unknown one, raises."""
    cfg, _, _, tparams = setup
    eng = port_engine.ServingEngine(_port_model(cfg), tparams,
                                    port_engine.EngineConfig(max_slots=2))
    assert eng.kv_backend == "dense" and isinstance(eng.kv, DenseKVBackend)
    with pytest.raises(ValueError, match="kv_backend='dense'"):
        port_engine.ServingEngine(_port_model(cfg), tparams,
                                  port_engine.EngineConfig(kv_backend="paged"))
    with pytest.raises(ValueError, match="unknown kv_backend"):
        port_engine.ServingEngine(_port_model(cfg), tparams,
                                  port_engine.EngineConfig(kv_backend="x"))


def test_serve_launcher_mamba_on_cpu():
    from repro_torch.launch.serve import serve
    reqs, eng = serve(arch="mamba2-2.7b", arch_size="smoke", n_requests=4,
                      max_slots=2, kv_backend="dense", prefill_chunk=8,
                      device="cpu", verbose=False, warmup=True)
    assert all(r.done and r.generated >= 1 for r in reqs)
    assert isinstance(eng.kv, DenseKVBackend) and eng.sched.cfg.prefill_chunk \
        is None
