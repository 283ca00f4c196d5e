"""The port's training path against the JAX package, on the same weights
and batches.

Weights come from the JAX ``Model.init`` and cross into torch through numpy
(``params_from_numpy``); batches come from both frameworks'
``SyntheticLM`` (equal bit for bit).  The model is
``get_smoke_config("granite-3-8b")`` (2 layers, d_model 64, 8/2 heads) in
float32, with attention chunks of 16 over sequences of 24, so the plain
``chunked_attention`` pads its queries and masks padded keys.  Tolerances:
attention 2e-5 (the kernel tests' float32 tolerance), the loss 1e-5
relative, gradients 1e-4, params after three AdamW steps 1e-6 from the
same gradients and 1e-4 relative L2 end to end (see that test): XLA and
torch sum in different orders, so the frameworks agree to float32
rounding, not bit for bit.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config  # noqa: E402
from repro.distributed.collectives import \
    compress_grads_int8 as jax_compress  # noqa: E402
from repro.kernels.flash_prefill import flash_attention  # noqa: E402
from repro.kernels.flash_prefill import \
    flash_prefill_ref as jax_flash_ref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.training import data as jax_data  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training import train_step as jax_train  # noqa: E402
from repro_torch.configs import \
    get_smoke_config as port_smoke_config  # noqa: E402
from repro_torch.distributed.collectives import \
    compress_grads_int8  # noqa: E402
from repro_torch.kernels.flash_prefill import (FlashPrefill,  # noqa: E402
                                               flash_prefill,
                                               flash_prefill_prefix,
                                               flash_prefill_ref)
from repro_torch.kernels.fused_rmsnorm import (FusedRMSNorm,  # noqa: E402
                                               fused_rmsnorm, rmsnorm_ref)
from repro_torch.kernels.kv_quant import (kv_dequantize,  # noqa: E402
                                          kv_quantize)
from repro_torch.kernels.paged_attention import paged_attention  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunk  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import Model, params_from_numpy  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.training.optimizer import (AdamWConfig,  # noqa: E402
                                            decays, init_opt_state)
from repro_torch.training.train_step import (init_train_state,  # noqa: E402
                                             make_decode_step,
                                             make_prefill_step,
                                             make_train_step)
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

BATCH, SEQ, CHUNK = 2, 24, 16
OPT = dict(lr=1e-2, warmup_steps=1, weight_decay=0.1)   # decay visible


def _cfg():
    return dataclasses.replace(get_smoke_config("granite-3-8b"),
                               param_dtype="float32")


def _port_layout(jtree, n_layers):
    """A JAX tree (numpy leaves, ``layers`` stacked on axis 0) in the
    port's layout: ``layers`` a list of per-layer dicts."""
    out = {k: v for k, v in jtree.items() if k != "layers"}
    out["layers"] = [jax.tree_util.tree_map(lambda a, i=i: np.asarray(a)[i],
                                            jtree["layers"])
                     for i in range(n_layers)]
    return out


def _np_leaves(tree):
    return {path: np.asarray(leaf) for path, leaf in tree_leaves(tree)}


def _t_leaves(tree):
    return {path: leaf.detach().numpy() for path, leaf in tree_leaves(tree)}


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    jmodel = JaxModel(cfg, attn_chunk=CHUNK, remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    model = Model(cfg, attn_chunk=CHUNK, device="cpu")
    data = jax_data.SyntheticLM(cfg, jax_data.DataConfig(batch_size=BATCH,
                                                         seq_len=SEQ))
    return cfg, jmodel, jparams, np_params, model, data


@pytest.fixture(scope="module")
def jax_grad_fn(setup):
    """``(params, batch) -> ((loss, parts), grads)`` of the JAX model,
    compiled once."""
    jmodel = setup[1]
    return jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss(p, b),
                                      has_aux=True))


def _port_params(cfg, np_params):
    params = params_from_numpy(cfg, np_params, device="cpu")
    for _, p in tree_leaves(params):
        p.requires_grad_(True)
    return params


def _torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


@pytest.fixture(scope="module")
def jax_loss_and_grads(setup, jax_grad_fn):
    cfg, jmodel, jparams, _, _, data = setup
    (loss, parts), grads = jax_grad_fn(jparams, data.batch_at(0))
    return (float(loss), {k: float(v) for k, v in parts.items()},
            _port_layout(jax.tree_util.tree_map(np.asarray, grads),
                         cfg.num_layers))


# --------------------------------------------------------------- attention

ATTN_CASES = [(2, 4, 2, 37, 16, 16), (1, 8, 1, 64, 32, 16),
              (2, 4, 4, 24, 8, 7)]


@pytest.mark.parametrize("B,H,KVH,S,hd,chunk", ATTN_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_matches_jax_and_pallas(setup, B, H, KVH, S, hd,
                                                  chunk, causal):
    """The port's plain chunked attention (padding a ragged S) against the
    jnp ``chunked_attention`` and the Pallas ``flash_prefill`` kernel in
    interpret mode, GQA included, within 2e-5."""
    cfg = setup[0]
    rng = np.random.default_rng(S + hd)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, hd), (B, S, KVH, hd), (B, S, KVH, hd)))
    out = L.chunked_attention(cfg, *map(torch.from_numpy, (q, k, v)),
                              causal=causal, q_chunk=chunk, kv_chunk=chunk)
    ref = JL.chunked_attention(cfg, q, k, v, causal=causal, q_chunk=chunk,
                               kv_chunk=chunk)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)
    blk = 32 if S % 32 == 0 else S
    pallas = flash_attention(*(jnp.asarray(a.transpose(0, 2, 1, 3))
                               for a in (q, k, v)), causal=causal,
                             q_blk=blk, kv_blk=blk, interpret=True)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(pallas).transpose(0, 2, 1, 3),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_prefill_ref_and_function_match_jax(causal):
    """The plain ``flash_prefill_ref`` against the JAX oracle, and the
    ``FlashPrefill`` Function (on the CPU: the plain forward, the
    recomputed backward) against autograd through the plain version."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 8, 19, 16), (2, 2, 19, 16), (2, 2, 19, 16)))
    ref = jax_flash_ref(q, k, v, causal=causal)
    out = flash_prefill_ref(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)
    go = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    ins_a = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    ins_b = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out_a = FlashPrefill.apply(*ins_a, causal)
    out_b = flash_prefill_ref(*ins_b, causal=causal)
    torch.testing.assert_close(out_a, out_b, atol=0, rtol=0)
    for ga, gb in zip(torch.autograd.grad(out_a, ins_a, go),
                      torch.autograd.grad(out_b, ins_b, go)):
        torch.testing.assert_close(ga, gb, atol=1e-6, rtol=1e-6)


def test_rmsnorm_function_gradients_match_plain():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((12, 64)).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    go = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    ins_a = [torch.from_numpy(a).requires_grad_(True) for a in (x, s)]
    ins_b = [torch.from_numpy(a).requires_grad_(True) for a in (x, s)]
    out_a = FusedRMSNorm.apply(*ins_a, 1e-5)
    out_b = rmsnorm_ref(*ins_b, 1e-5)
    torch.testing.assert_close(out_a, out_b, atol=0, rtol=0)
    for ga, gb in zip(torch.autograd.grad(out_a, ins_a, go),
                      torch.autograd.grad(out_b, ins_b, go)):
        torch.testing.assert_close(ga, gb, atol=1e-6, rtol=1e-6)


# ------------------------------------------------------- raw wrapper guard

def _grad_inputs():
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g).requires_grad_(True)

    lengths = torch.tensor([3, 5], dtype=torch.int32)
    tables = torch.tensor([[0], [1]], dtype=torch.int32)
    q8 = torch.zeros((4, 8), dtype=torch.int8)
    return {
        "fused_rmsnorm": lambda: fused_rmsnorm(r(4, 8), torch.ones(8)),
        "flash_prefill": lambda: flash_prefill(r(1, 2, 5, 8), r(1, 2, 5, 8),
                                               r(1, 2, 5, 8)),
        "flash_prefill_prefix": lambda: flash_prefill_prefix(
            r(1, 2, 3, 8), r(1, 2, 6, 8), r(1, 2, 6, 8),
            torch.zeros((1,), dtype=torch.int32)),
        "paged_attention": lambda: paged_attention(
            r(2, 2, 8), r(2, 8, 1, 8), r(2, 8, 1, 8), tables, lengths),
        "ssd_chunk": lambda: ssd_chunk(r(1, 1, 4, 2, 3), r(1, 1, 4, 2),
                                       r(1, 1, 4, 5), r(1, 1, 4, 5)),
        "kv_quantize": lambda: kv_quantize(r(4, 8)),
        "kv_dequantize": lambda: kv_dequantize(q8, r(4, 1), r(4, 1)),
    }


@pytest.mark.parametrize("name", sorted(_grad_inputs()))
def test_raw_kernel_wrappers_refuse_grad(name):
    """A raw wrapper never cuts the graph silently: with grad mode on and a
    floating input requiring grad it raises (on every device, so here
    too); under ``no_grad`` the same call runs."""
    call = _grad_inputs()[name]
    with pytest.raises(RuntimeError, match="requires grad"):
        call()
    with torch.no_grad():
        call()


def test_apply_norm_keeps_the_graph(setup):
    cfg = setup[0]
    x = torch.randn((2, 3, cfg.d_model), requires_grad=True)
    scale = torch.ones(cfg.d_model, requires_grad=True)
    y = L.apply_norm(cfg, {"scale": scale}, x)
    gx, gs = torch.autograd.grad(y.square().sum(), (x, scale))
    assert gx.abs().sum() > 0 and gs.abs().sum() > 0


# ------------------------------------------------------------ loss, grads

def test_loss_matches_jax(setup, jax_loss_and_grads):
    cfg, _, _, np_params, model, data = setup
    jloss, jparts, _ = jax_loss_and_grads
    with torch.no_grad():
        loss, parts = model.loss(params_from_numpy(cfg, np_params, "cpu"),
                                 _torch_batch(data.batch_at(0)))
    assert float(loss) == pytest.approx(jloss, rel=1e-5)
    for name in ("ce", "zloss"):
        assert float(parts[name]) == pytest.approx(jparts[name], rel=1e-5)
    assert float(parts["moe_aux"]) == 0.0


def test_every_gradient_leaf_matches_jax(setup, jax_loss_and_grads):
    cfg, _, _, np_params, model, data = setup
    jgrads = _np_leaves(jax_loss_and_grads[2])
    params = _port_params(cfg, np_params)
    loss, _ = model.loss(params, _torch_batch(data.batch_at(0)))
    paths = [path for path, _ in tree_leaves(params)]
    grads = torch.autograd.grad(loss, [p for _, p in tree_leaves(params)])
    assert sorted(map(str, paths)) == sorted(map(str, jgrads))
    for path, g in zip(paths, grads):
        assert float(g.abs().max()) > 0, path
        np.testing.assert_allclose(g.numpy(), jgrads[path], atol=1e-4,
                                   err_msg=str(path))


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                    1e-30))


def test_three_adamw_steps_match_jax(setup):
    """Three train steps from the same params on the same batches, with a
    learning rate and weight decay large enough that the decay term
    (lr * wd * p = 1e-3 a step on a norm scale of 1) dwarfs the
    tolerance: the per-layer norm scales must be decayed, as the
    reference's stacked leaves are, and ``final_norm`` must not.

    Loss and gradient norm agree to 1e-5 relative at each step; every leaf
    of params and moments to a relative L2 of 1e-4, not 1e-5.  Where a
    gradient is ~1e-7 its float32 rounding differs between the frameworks
    by a few percent, and Adam, which divides by the gradient's own scale,
    turns that into a few percent of lr on that element (seen: 1.1e-4 on
    one element, 1.4e-5 relative L2 on ``layers.1.ffn.wo``; both shrink
    tenfold at lr 1e-3).  A wrong decay rule moves a leaf by ~3e-3
    relative after three steps, 30x the tolerance.  The optimizer alone,
    fed the same gradients, agrees element by element to 1e-6 (next
    test)."""
    cfg, jmodel, jparams, np_params, model, data = setup
    jstep = jax.jit(jax_train.make_train_step(jmodel,
                                              jax_opt.AdamWConfig(**OPT)))
    jstate = {"params": jparams, **jax_opt.init_opt_state(jparams)}
    params = _port_params(cfg, np_params)
    state = {"params": params, **init_opt_state(params)}
    step = make_train_step(model, AdamWConfig(**OPT))
    for i in range(3):
        jstate, jm = jstep(jstate, data.batch_at(i))
        state, m = step(state, _torch_batch(data.batch_at(i)))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                      rel=1e-5)
    assert int(state["step"]) == int(jstate["step"]) == 3
    moved = 0.0
    for key in ("params", "m", "v"):
        want = _np_leaves(_port_layout(
            jax.tree_util.tree_map(np.asarray, jstate[key]), cfg.num_layers))
        for path, got in _t_leaves(state[key]).items():
            assert _rel_l2(got, want[path]) <= 1e-4, (key, path)
    # the decay moved the per-layer norm scales far beyond the tolerance
    for path, p in _t_leaves(state["params"]).items():
        if path[-1] == "scale":
            moved = max(moved, float(np.abs(p - 1.0).max()))
    assert moved > 1e-3


def test_adamw_update_matches_jax_on_the_same_grads(setup, jax_grad_fn):
    """The optimizer alone: three updates of the same params by the same
    gradients (JAX's, at each step's params) agree element by element to
    1e-6, weight decay included."""
    cfg, jmodel, jparams, np_params, _, data = setup
    ocfg = AdamWConfig(**OPT)
    jupdate = jax.jit(lambda p, g, s: jax_opt.adamw_update(
        jax_opt.AdamWConfig(**OPT), p, g, s))
    jstate = jax_opt.init_opt_state(jparams)
    params = params_from_numpy(cfg, np_params, "cpu")
    state = init_opt_state(params)
    from repro_torch.training.optimizer import adamw_update
    for i in range(3):
        _, jgrads = jax_grad_fn(jparams, data.batch_at(i))
        grads = params_from_numpy(
            cfg, jax.tree_util.tree_map(np.asarray, jgrads), "cpu")
        jparams, jstate, _ = jupdate(jparams, jgrads, jstate)
        params, state, _ = adamw_update(ocfg, params, grads, state)
    want = _np_leaves(_port_layout(jax.tree_util.tree_map(np.asarray,
                                                          jparams),
                                   cfg.num_layers))
    for path, got in _t_leaves(params).items():
        np.testing.assert_allclose(got, want[path], atol=1e-6,
                                   err_msg=str(path))


def test_weight_decay_follows_the_stacked_ndim(setup):
    cfg, _, _, np_params, _, _ = setup
    params = params_from_numpy(cfg, np_params, "cpu")
    got = {path: decays(path, p) for path, p in tree_leaves(params)}
    assert got[("embed",)] and not got[("final_norm", "scale")]
    assert all(v for path, v in got.items() if path[0] == "layers")
    assert got[("layers", 0, "ln1", "scale")]        # (d,) here, (L, d) there


def test_training_the_ssm_family_raises():
    from repro_torch.launch.train import train
    model = Model(port_smoke_config("mamba2-2.7b"), device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        model.loss({}, {"tokens": toks, "targets": toks})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        train("mamba2-2.7b", steps=1, device="cpu")


def test_prefill_and_decode_step_builders_match_jax():
    """``make_prefill_step`` and ``make_decode_step`` against the JAX
    package's, on the family whose monolithic prefill and dense decode the
    port has (the mamba smoke config in float32): logits within 1e-4."""
    cfg = dataclasses.replace(get_smoke_config("mamba2-2.7b"),
                              param_dtype="float32")
    jmodel = JaxModel(cfg, ssd_chunk=8, remat=False, kv_dtype="float32")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    model = Model(cfg, ssd_chunk=8, kv_dtype="float32", device="cpu")
    rng = np.random.default_rng(8)
    toks = rng.integers(2, cfg.vocab_size, (2, 11)).astype(np.int32)
    logits, cache = make_prefill_step(model)(
        params, {"tokens": torch.from_numpy(toks).long()})
    jlogits, jcache = jax_train.make_prefill_step(jmodel)(
        jparams, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4)
    tok = rng.integers(2, cfg.vocab_size, (2, 1)).astype(np.int32)
    out = make_decode_step(model)(params, cache, torch.from_numpy(tok).long())
    jout, _ = jax_train.make_decode_step(jmodel)(jparams, jcache,
                                                 jnp.asarray(tok))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-4)


# ------------------------------------------------- data, compression, ckpt

def test_synthetic_lm_batches_equal_jax_bitwise():
    cfg = _cfg()
    for seed in (0, 7):
        dc = dict(batch_size=3, seq_len=40, seed=seed)
        jd = jax_data.SyntheticLM(cfg, jax_data.DataConfig(**dc))
        pd = SyntheticLM(cfg, DataConfig(**dc))
        np.testing.assert_array_equal(pd.succ, jd.succ)
        it = pd.iterate(start_step=5, device="cpu")
        for step in (5, 6, 7):
            want, got, yielded = jd.batch_at(step), pd.batch_at(step), next(it)
            for k in ("tokens", "targets"):
                np.testing.assert_array_equal(got[k], want[k])
                assert got[k].dtype == want[k].dtype == np.int32
                np.testing.assert_array_equal(yielded[k].numpy(), want[k])


def test_compress_grads_int8_matches_jax():
    rng = np.random.default_rng(3)
    tree = {"a": (rng.standard_normal((7, 5)) * 3).astype(np.float32),
            "b": [rng.standard_normal(11).astype(np.float32),
                  np.zeros((3,), np.float32)]}
    want = jax_compress({"a": tree["a"], "b": tree["b"]})
    got = compress_grads_int8(tree_map(torch.from_numpy, tree))
    for (path, g), (_, w) in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=str(path))


def _port_train_setup():
    """The port alone, as the reference's checkpoint tests set it up."""
    cfg = port_smoke_config("granite-3-8b").scaled(param_dtype="float32")
    model = Model(cfg, attn_chunk=16, device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    step = make_train_step(model, AdamWConfig(lr=1e-3))
    data = SyntheticLM(cfg, DataConfig(batch_size=4, seq_len=32))
    return state, step, data


def _clone(state):
    return tree_map(lambda t: t.detach().clone().requires_grad_(
        t.requires_grad), state)


def test_checkpoint_restart_bitwise(tmp_path):
    """Six steps straight equal three steps, a save, a restore and three
    more, bit for bit (torch on the CPU is deterministic)."""
    state, step_fn, data = _port_train_setup()
    s = _clone(state)
    for i in range(6):
        s, m = step_fn(s, _torch_batch(data.batch_at(i)))
    s2 = _clone(state)
    for i in range(3):
        s2, _ = step_fn(s2, _torch_batch(data.batch_at(i)))
    ckpt.save_checkpoint(tmp_path, s2, 3)
    assert ckpt.latest_step(tmp_path) == 3
    s3, start = ckpt.restore_checkpoint(tmp_path, state)
    assert start == 3
    assert all(p.requires_grad for _, p in tree_leaves(s3["params"]))
    for i in range(3, 6):
        s3, m3 = step_fn(s3, _torch_batch(data.batch_at(i)))
    assert float(m3["loss"]) == float(m["loss"])
    for (path, a), (_, b) in zip(tree_leaves(s), tree_leaves(s3)):
        assert torch.equal(a, b), path


def test_checkpoint_atomic_overwrite(tmp_path):
    state, _, _ = _port_train_setup()
    ckpt.save_checkpoint(tmp_path, state, 1)
    ckpt.save_checkpoint(tmp_path, state, 2)
    ckpt.save_checkpoint(tmp_path, state, 2)      # overwrite in place
    assert ckpt.latest_step(tmp_path) == 2
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".tmp")]
    restored, step = ckpt.restore_checkpoint(tmp_path, state, step=1)
    assert step == 1


def test_checkpoint_keeps_bfloat16_bits(tmp_path):
    g = torch.Generator().manual_seed(1)
    state = {"w": torch.randn((5, 3), generator=g).to(torch.bfloat16),
             "n": [torch.arange(4, dtype=torch.int32)]}
    ckpt.save_checkpoint(tmp_path, state, 9)
    got, step = ckpt.restore_checkpoint(tmp_path, tree_map(torch.zeros_like,
                                                           state))
    assert step == 9 and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16),
                       state["w"].view(torch.int16))
    assert torch.equal(got["n"][0], state["n"][0])


# ---------------------------------------------------------------- launcher

def test_train_launcher_runs_on_cpu():
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--steps", "3", "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=src), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert "first loss" in out.stdout
