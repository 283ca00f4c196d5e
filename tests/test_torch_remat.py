"""Layer rematerialisation (``Model(remat=True)``, the reference's
``jax.checkpoint`` of each scanned layer body) and ``ssm_state_dtype``.

On the CPU, at the smoke size in float32:

- per family (granite, granite-moe, mamba2, jamba, seamless) the loss and
  every gradient leaf with remat equal those without bit for bit, and
  match ``jax.value_and_grad`` of the reference's ``Model(remat=True)``
  loss within the repo's float32 tolerance (2e-5, absolute and relative);
- ``moe_tap`` sees each MoE call once though the backward runs it again;
- the saved-bytes tally (``training.saved.SavedBytes``, on meta tensors)
  grows by one layer input a layer with remat and by far more without;
- two ``gloo`` ranks (this file run as a script: it imports no JAX at
  module level) on ``data`` 2 (FSDP) and on ``model`` 2 (tensor): the
  loss and gradient blocks with remat equal those without bit for bit,
  every rank issues the same collectives in the same order, the
  recompute adds collectives, and under FSDP the tally grows by the
  layer input alone (no gathered weight is kept for the backward);
- a dry train cell on a small mesh records the tally and counts each
  layer leaf's FSDP gather twice (forward and recompute);
- ``ssm_state_dtype="bfloat16"`` on mamba2 and jamba: the reference's
  cache shapes and dtypes, a float32 prefill state, and a decode step on
  the bf16 cache that matches the reference's logits and returns its
  float32 state.
"""
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_distributed as D  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed import ctx as C  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.model import Model, params_from_numpy  # noqa: E402
from repro_torch.serving.kv_cache import (  # noqa: E402
    DenseKVBackend, KVBackendConfig)
from repro_torch.training.saved import saved_at_loss  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

B, S, CHUNK = 2, 16, 8
TOL = 2e-5                       # tests/test_kernels.py's float32 tolerance
FAMILIES = ["granite-3-8b", "granite-moe-3b-a800m", "mamba2-2.7b",
            "jamba-1.5-large-398b", "seamless-m4t-large-v2"]


def _cfg(arch, **over):
    return get_smoke_config(arch).scaled(param_dtype="float32", **over)


def _batch(cfg, rng, batch=B, seq=S):
    toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:].copy()}
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = rng.standard_normal(
            (batch, seq, cfg.d_model)).astype(np.float32)
    return out


def _model(cfg, **kw):
    return Model(cfg, attn_chunk=CHUNK, ssd_chunk=CHUNK, kv_dtype="float32",
                 device="cpu", **kw)


def _loss_and_grads(model, params, batch):
    leaves = [p.requires_grad_(True) for _, p in tree_leaves(params)]
    loss, _ = model.loss(params, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_equals_no_remat_and_the_reference(arch):
    """Remat on equals remat off bit for bit (loss and every gradient
    leaf), and matches the reference's rematerialised loss and gradients
    (its weights through the numpy path) within 2e-5."""
    import jax
    import jax.numpy as jnp
    from repro.models.model import Model as JaxModel
    cfg = _cfg(arch)
    batch = _batch(cfg, np.random.default_rng(0))
    jm = JaxModel(cfg, kv_dtype="float32", attn_chunk=CHUNK,
                  ssd_chunk=CHUNK, remat=True)
    jp = jm.init(jax.random.PRNGKey(0))
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    want = [g for _, g in tree_leaves(params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jg), "cpu"))]
    out = {}
    for remat in (False, True):
        model = _model(cfg, remat=remat)
        out[remat] = _loss_and_grads(
            model, params_from_numpy(cfg, np_params, "cpu"), batch)
    (l0, g0), (l1, g1) = out[False], out[True]
    assert torch.equal(l0, l1)
    assert len(g1) == len(want) and all(torch.equal(a, b)
                                        for a, b in zip(g0, g1))
    np.testing.assert_allclose(float(l1), float(jloss), rtol=TOL)
    for got, ref in zip(g1, want):
        assert float(got.abs().max()) > 0
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=TOL,
                                   atol=TOL)


def test_remat_runs_each_unit_again_and_the_tap_once():
    """The backward runs every MoE call again (the router is called twice
    a layer) while ``moe_tap`` sees each call once, in the forward; no
    remat where nothing requires grad."""
    from repro_torch.models import layers as L
    cfg = _cfg("granite-moe-3b-a800m")
    model = _model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    taps, routes, route = [], [], L._route

    def counted(*a):
        routes.append(1)
        return route(*a)
    model.moe_tap = lambda shape, idx, keep: taps.append(shape)
    L._route = counted
    try:
        _loss_and_grads(model, params, _batch(cfg, np.random.default_rng(1)))
        assert len(taps) == cfg.num_layers
        assert len(routes) == 2 * cfg.num_layers
        taps.clear()
        routes.clear()
        with torch.no_grad():
            model.loss(params, {k: torch.from_numpy(v) for k, v in
                                _batch(cfg, np.random.default_rng(1)).items()})
        assert len(taps) == len(routes) == cfg.num_layers
    finally:
        L._route = route


@pytest.mark.parametrize("arch", ["granite-3-8b", "mamba2-2.7b",
                                  "jamba-1.5-large-398b"])
def test_saved_bytes_grow_by_the_layer_input_with_remat(arch):
    """The dry run's tally at L and at L + one unit of layers: with remat
    it grows by the unit's input, B * S * D * 4 bytes, alone; without it
    grows by the layer's activations, many times that."""
    per = 8 if arch.startswith("jamba") else 1      # jamba's unit: a group
    cfg = _cfg(arch)
    L0 = cfg.num_layers
    grow = {}
    for remat in (True, False):
        n = [dryrun.saved_activation_bytes(cfg.scaled(num_layers=L), B, S,
                                           remat=remat)
             for L in (L0, L0 + per)]
        grow[remat] = n[1] - n[0]
    assert grow[True] == B * S * cfg.d_model * 4
    assert grow[False] > 4 * grow[True]


def test_saved_bytes_of_a_cpu_step_equal_the_meta_tally():
    """With remat, the tally of a real CPU loss equals the meta one."""
    cfg = _cfg("granite-3-8b")
    model = _model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    for _, p in tree_leaves(params):
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(cfg, np.random.default_rng(2)).items()}
    _, saved = saved_at_loss(model.loss, params, batch)
    assert saved == dryrun.saved_activation_bytes(cfg, B, S, remat=True) > 0


def test_dry_train_cell_counts_the_recompute_gathers(monkeypatch):
    """A dry train cell of smoke granite on 2x2 records the tally, and the
    remat step issues one more all-gather per layer leaf that FSDP
    gathers (its recompute) than the same step without remat, whose
    tally is larger."""
    cfg = _cfg("granite-3-8b")
    mesh = C.Mesh(("data", "model"), (2, 2))
    rec = dryrun.dry_cell("granite-3-8b", "train_4k", mesh, cfg=cfg)
    made = dryrun._model_for

    def no_remat(*a, **kw):
        m = made(*a, **kw)
        m.remat = False
        return m
    monkeypatch.setattr(dryrun, "_model_for", no_remat)
    off = dryrun.dry_cell("granite-3-8b", "train_4k", mesh, cfg=cfg)
    model = Model(cfg, mesh=mesh, device="meta")
    specs = model.layouts("train")
    gathered = sum(
        bool(C._fsdp_layout(mesh, tuple(dryrun.spec_at(specs, path)),
                            t.dim())[0])
        for path, t in tree_leaves(model._whole_shapes()["layers"],
                                   ("layers",)))
    assert gathered >= 7 * cfg.num_layers
    on_c, off_c = rec["collectives"]["counts"], off["collectives"]["counts"]
    assert on_c["all-gather"] - off_c["all-gather"] == gathered
    assert on_c["reduce-scatter"] == off_c["reduce-scatter"]
    saved = rec["memory"]["saved_activation_bytes"]
    assert 0 < saved < off["memory"]["saved_activation_bytes"]
    decode = dryrun.dry_cell("granite-3-8b", "decode_32k", mesh, cfg=cfg)
    assert "saved_activation_bytes" not in decode["memory"]


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-1.5-large-398b"])
def test_ssm_state_dtype(arch):
    """``ssm_state_dtype="bfloat16"``: the reference's cache shapes and
    dtypes (the dry run's too), a float32 state from prefill, and a decode
    step on the bf16 cache with the reference's logits (5e-2) and its
    float32 state; a serving backend refuses such a model."""
    import jax
    import jax.numpy as jnp
    from repro.models.model import Model as JaxModel
    cfg = _cfg(arch)
    jm = JaxModel(cfg, kv_dtype="float32", attn_chunk=CHUNK,
                  ssd_chunk=CHUNK, remat=False, ssm_state_dtype="bfloat16")
    tm = _model(cfg, ssm_state_dtype="bfloat16")
    shapes = tm.cache_shapes(B, S + 1)
    ref = jm.cache_shapes(B, S + 1)
    assert sorted(shapes) == sorted(ref)
    for k, (shape, dt) in shapes.items():
        assert shape == ref[k].shape, k
        assert str(dt).replace("torch.", "") == str(ref[k].dtype), k
    assert tm.init_cache(B, S + 1)["ssm"].dtype == torch.bfloat16
    dry = dryrun._model_for(cfg, {"ssm_state_dtype": "bfloat16"})
    assert dry.remat and dry.cache_shapes(B, S)["ssm"][1] == torch.bfloat16
    assert dryrun._model_for(cfg, {}).cache_shapes(B, S)["ssm"][1] == \
        torch.float32
    with pytest.raises(ValueError, match="ssm_state_dtype"):
        DenseKVBackend(tm, KVBackendConfig(max_slots=B, max_seq_len=S))

    jp = jm.init(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                               "cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    step = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    assert jcache["ssm"].dtype == jnp.float32
    jfull = jm.init_cache(B, S + 1)
    jfull = {k: (jfull[k].at[:, :, :S].set(t) if k in ("k", "v") else
                 t.astype(jfull[k].dtype)) for k, t in jcache.items()}
    assert jfull["ssm"].dtype == jnp.bfloat16
    jlogits, jnew = jm.decode_step(jp, jfull, jnp.asarray(step))
    with torch.no_grad():
        _, cache = tm.prefill(params, {"tokens": torch.from_numpy(toks)})
        assert cache["ssm"].dtype == torch.float32
        full = tm.decode_cache(cache, S + 1)
        assert full["ssm"].dtype == torch.bfloat16
        logits = tm.decode_step(params, full, torch.from_numpy(step))
    assert str(full["ssm"].dtype).replace("torch.", "") == \
        str(jnew["ssm"].dtype) == "float32"
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=5e-2)
    np.testing.assert_allclose(full["ssm"].numpy(), np.asarray(jnew["ssm"]),
                               atol=5e-2)


# ------------------------------------------------------------- rank side

LOG = []


def _logged(kind, fn):
    def run(mesh, axes, t, *rest, **kw):
        LOG.append((kind, tuple(C._as_tuple(axes)), tuple(t.shape)))
        return fn(mesh, axes, t, *rest, **kw)
    return run


def _rank_task(task, mesh):
    """Remat off and on: the loss, this rank's gradient blocks, the
    collectives in issue order and the saved-bytes tally at the loss."""
    cfg = _cfg(task["arch"], num_layers=task["layers"])
    whole = _model(cfg).init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v[D._rows(mesh, v.shape[0])])
             for k, v in task["batch"].items()}
    out = {}
    for remat in (False, True):
        model = _model(cfg, remat=remat, mesh=mesh)
        params = model.shard(whole, "train")
        leaves = [p.requires_grad_(True) for _, p in tree_leaves(params)]
        LOG.clear()
        (loss, _), saved = saved_at_loss(model.loss, params, batch)
        grads = torch.autograd.grad(loss, leaves)
        out[remat] = {"loss": loss.detach().numpy(), "log": list(LOG),
                      "grads": [g.numpy() for g in grads],
                      "saved": saved, "rows": batch["tokens"].shape}
    # the bytes of the layers' whole (gathered) matrices
    out["matrices"] = sum(
        t.numel() * t.element_size() for path, t in
        tree_leaves(model._whole_shapes()["layers"][0]) if t.dim() == 2)
    return out


def _rank_main(rank, world, port, jobdir):
    rank, world, jobdir = int(rank), int(world), Path(jobdir)
    job = pickle.loads((jobdir / "job.pkl").read_bytes())
    from repro_torch.launch.mesh import init_distributed, make_test_mesh
    init_distributed(rank, world, int(port), "cpu", backend="gloo")
    mesh = make_test_mesh(*job["mesh"])
    for name in ("_all_reduce", "_all_gather", "_reduce_scatter"):
        setattr(C, name, _logged(name[1:], getattr(C, name)))
    out = {name: _rank_task(task, mesh)
           for name, task in job["tasks"].items()}
    out["jax_loaded"] = sorted(m for m in sys.modules
                               if m == "jax" or m.startswith(("jax.",
                                                              "repro.")))
    (jobdir / f"out_{rank}.pkl").write_bytes(pickle.dumps(out))
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])


# ----------------------------------------------------------- parent side

JOBS = {"fsdp": ((2, 1), {"granite": ("granite-3-8b", 2),
                          "granite3": ("granite-3-8b", 3),
                          "granite-moe": ("granite-moe-3b-a800m", 2)}),
        "tensor": ((1, 2), {"granite": ("granite-3-8b", 2),
                            "mamba2": ("mamba2-2.7b", 2),
                            "granite-moe": ("granite-moe-3b-a800m", 2)})}


def test_gloo_ranks_remat_equals_no_remat(tmp_path):
    """Two gloo ranks, on ``data`` 2 (FSDP: each layer gathered inside its
    unit; granite-moe's dispatch counts gathered across the ranks) and on
    ``model`` 2 (tensor: Megatron pairs, Mamba's head split and split-row
    norm, the MoE exchange): remat equals no remat bit for bit in the loss
    and every gradient block, both ranks issue the same collectives in
    the same order, remat issues more of them, and under FSDP the tally
    grows by the layer input alone from 2 to 3 layers (without remat it
    grows by more than the layer's gathered matrices)."""
    rng = np.random.default_rng(5)
    started = {}
    for job, (mesh, tasks) in JOBS.items():
        started[job] = D.start_ranks({"mesh": mesh, "tasks": {
            name: {"arch": arch, "layers": layers,
                   "batch": _batch(_cfg(arch), rng, batch=4)}
            for name, (arch, layers) in tasks.items()}},
            tmp_path / job, 2, script=__file__)
    for job, (mesh, tasks) in JOBS.items():
        outs = D.wait_ranks(started[job])
        for out in outs:
            assert out["jax_loaded"] == []
            for name in tasks:
                off, on = out[name][False], out[name][True]
                assert np.array_equal(off["loss"], on["loss"]), (job, name)
                assert all(np.array_equal(a, b) for a, b in
                           zip(off["grads"], on["grads"])), (job, name)
                assert len(on["log"]) > len(off["log"]), (job, name)
        for name in tasks:
            for remat in (False, True):
                assert outs[0][name][remat]["log"] == \
                    outs[1][name][remat]["log"], (job, name, remat)
        if job == "fsdp":
            for out in outs:
                two, three = out["granite"], out["granite3"]
                rows, seq = two[True]["rows"]
                D_ = _cfg("granite-3-8b").d_model
                assert three[True]["saved"] - two[True]["saved"] == \
                    rows * seq * D_ * 4
                assert three[False]["saved"] - two[False]["saved"] > \
                    rows * seq * D_ * 4 + two["matrices"]
