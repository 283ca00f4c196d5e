"""The port's sharded layouts that the ``model`` axis does not split evenly,
and the context-split decode cache, on CPU ranks against one rank and
against the JAX package.

Ranks are ``gloo`` processes that run this file as a script (see
:func:`_rank_main`; ``test_torch_distributed.launch_ranks`` starts them):
they import torch, numpy and the port, never JAX.  In float32, on three
meshes:

- (data 1, model 4): KV heads replicated on two ranks each (smoke granite,
  8/2 heads: 1 KV and 2 query heads a rank; smoke granite-moe, 4/2 heads
  and 4 experts at 1 a rank; smoke jamba);
- (data 1, model 3): heads and ``d_ff`` padded (granite: 3 KV / 12 query
  head slots, rank 0's all padding, and ``d_ff`` 128 as 42, 43, 43;
  qwen1.5, 4 = 4 heads with QKV bias as 6 = 6 slots; granite-moe, 4
  experts as 1, 1, 2 of 6 slots, and with the reference's
  ``pad_experts_to`` 6, 2 a rank, the padding experts rank 2's); SSM
  heads the axis does not split whole (smoke mamba2's 8 as 2, 3, 3, the
  conv and SSM state by the same heads; smoke jamba's 8 as 2, 3, 3 and its
  4 experts as 1, 1, 2); fewer experts than ranks (granite-moe with 2
  experts, top 2: rank 0's share empty);
- (data 2, model 2) with a global batch of 1: the context-split decode
  cache (jamba, a prompt of 12 in a cache of 20 split at 10; granite with
  one KV head, replicated on both ``model`` ranks, a prompt of 6 in a
  cache of 16 split at 8, the decode writes crossing the split's edge),
  and FSDP x TP training of that granite (the replicated KV head's
  gradient summed over its ranks, then reduce-scattered over ``data``).

Each serve's prefill and 8 decode steps equal one rank within 1e-5 and
the JAX model within the port's tolerance (the f32 2e-5 for the SSM
layouts and the empty share); its decode cache (every leaf), gathered by
``sharding.cache_layouts``, equals one rank's, and its padding head slots
are exactly 0.  Two AdamW steps follow one rank as
``test_torch_distributed`` holds them (loss, norm, every gradient leaf,
then every weight and moment), with no padding slot in the gathered state
and a replicated KV head's copies equal on its ranks; a checkpoint saved on
one mesh restores onto another (and onto one rank) bit for bit.
"""
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_distributed as D  # noqa: E402
from repro_torch.distributed.sharding import spec_at  # noqa: E402

STEPS = 8
# name: (arch, config overrides, Model options)
CONFIGS = {"granite": ("granite-3-8b", {}, {}),
           "granite-moe": ("granite-moe-3b-a800m", {}, {}),
           "jamba": ("jamba-1.5-large-398b", {}, {}),
           "qwen": ("qwen1.5-32b", {}, {}),
           "granite-kv1": ("granite-3-8b", {"num_kv_heads": 1}, {}),
           "granite-moe-pad": ("granite-moe-3b-a800m", {},
                               {"pad_experts_to": 6}),
           "mamba2": ("mamba2-2.7b", {}, {}),
           "granite-moe-e2": ("granite-moe-3b-a800m",
                              {"num_experts": 2, "top_k": 2}, {})}
# the f32 tolerance against the JAX model where it is not the port's 1e-4
JAX_ATOL = {**D.JAX_ATOL, "granite-moe-e2": 2e-5}
# each config's serve on every mesh that runs it: (batch, prompt, cache
# positions); a batch of 1 splits the cache's positions over ``data``
SERVE = {"granite": (1, 6, 16), "granite-moe": (2, 12, 20),
         "jamba": (1, 12, 20), "qwen": (2, 12, 20),
         "granite-kv1": (1, 6, 16), "granite-moe-pad": (2, 12, 20),
         "mamba2": (2, 12, 20), "granite-moe-e2": (2, 12, 20)}
# per mesh: the served configs, the trained ones and the mesh each one's
# checkpoint restores onto
JOBS = {"1x4": dict(mesh=(1, 4), serve=["granite", "granite-moe", "jamba"],
                    train=["granite", "granite-moe", "jamba"],
                    restore=(2, 2)),
        "1x3": dict(mesh=(1, 3), serve=["granite", "qwen", "granite-moe",
                                        "granite-moe-pad", "mamba2", "jamba",
                                        "granite-moe-e2"],
                    train=["granite", "qwen", "granite-moe", "mamba2",
                           "jamba", "granite-moe-e2"],
                    restore=(3, 1)),
        "2x2": dict(mesh=(2, 2), serve=["jamba", "granite-kv1"],
                    train=["granite-kv1"], restore=(1, 4))}
# the train steps' bounds against one rank: every gradient leaf's rel_l2,
# the clipped global norm's relative difference and every moment's rel_l2
TRAIN_REL = {"grad": 1e-5, "norm": 1e-6, "moment": 1e-5}
# jamba on data 1 x model 4 splits its Mamba heads four ways, and the
# stack's float32 gradients spread past those: its worst leaf 1.085e-5 (a
# conv bias; 1.05e-5 on data 1 x model 2, split two ways),
# the norm 2.24e-6, the moments 1.96e-5 (the second moment of an
# in_proj), its worst leaf outside the Mamba mixers 6.1e-6 (the norm
# before a Mamba layer).  Its bounds are about twice those readings.
TRAIN_REL_OF = {"jamba": {"grad": 2e-5, "norm": 5e-6, "moment": 4e-5}}
SERVES = [f"{job}/{name}" for job, j in JOBS.items() for name in j["serve"]]
TRAINS = [f"{job}/{name}" for job, j in JOBS.items() for name in j["train"]]


# ------------------------------------------------------------- rank side

def _cache_specs(cfg, model, batch, max_len, mesh):
    """The whole decode cache's shapes and the specs by which ``model``'s
    rank holds it (``sharding.cache_layouts`` of a decode cell of global
    ``batch``)."""
    from repro_torch.distributed.sharding import cache_layouts
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.model import Model
    one = Model(cfg, kv_dtype="float32", device="meta")
    whole = {k: s for k, (s, _) in one.cache_shapes(batch, max_len).items()}
    return whole, cache_layouts(cfg, whole, ShapeSpec(
        "cell", max_len, batch, "decode"), mesh)


def _serve(task, mesh, dev):
    """The prefill and decode steps of ``task`` on this rank (every rank
    the whole batch with ``seq_split``, else its rows), its decode cache
    gathered whole, and whether its padding KV head slots stayed 0.  Where
    ``seq_split`` splits the cache's positions over more than one ``data``
    rank, the prefill is one rank's, as the long-context cell's decode
    cache is laid out: its whole decode cache, each rank's block of it by
    ``sharding.cache_layouts``."""
    from repro_torch.distributed.ctx import gather_full
    from repro_torch.distributed.sharding import shard_leaf
    from repro_torch.models.model import Model, params_from_numpy
    cfg = D._port_cfg(task["arch"], task["overrides"])
    model = Model(cfg, mesh=mesh, attn_chunk=D.CHUNK, kv_dtype="float32",
                  device=dev, **task["model_kw"])
    whole_params = params_from_numpy(cfg, task["params"], dev)
    params = model.shard(whole_params)
    seq = task["seq_split"]
    rows = slice(None) if seq else D._rows(mesh, task["tokens"].shape[0])
    tokens = torch.from_numpy(task["tokens"][rows])
    whole, specs = _cache_specs(cfg, model, task["tokens"].shape[0],
                                task["max_len"], mesh)
    if seq and mesh.sizes["data"] > 1:
        one = Model(cfg, attn_chunk=D.CHUNK, kv_dtype="float32", device=dev,
                    **task["model_kw"])
        logits, cache = one.prefill(whole_params, {"tokens": tokens})
        full = {k: shard_leaf(t, specs[k], mesh) for k, t in
                one.decode_cache(cache, task["max_len"]).items()}
        cache = full
    else:
        logits, cache = model.prefill(params, {"tokens": tokens})
        full = model.decode_cache(cache, task["max_len"])
    out = {"prefill": logits.numpy(), "decode": [], "rows": rows}
    for step in task["decode"]:
        out["decode"].append(model.decode_step(
            params, full, torch.from_numpy(step[rows]),
            seq_split=seq).numpy())
    out["cache"] = {k: gather_full(full[k], specs[k], whole[k],
                                   mesh).numpy() for k in full
                    if k != "lengths"}
    real = len(model.layouts()["layers"][_attn_layer(cfg)]["attn"]["wk"]
               .stored(mesh)) // cfg.hd if model.heads else None
    out["pads_zero"] = real is None or all(
        not t[..., real:, :].any() for t in (full["k"], full["v"],
                                            cache["k"], cache["v"]))
    out["heads"] = model.heads
    out["units"] = (model.ssm_heads, model.experts)
    return out


def _attn_layer(cfg) -> int:
    return next(i for i in range(cfg.num_layers)
                if cfg.layer_kind(i) == "attn")


def _train(task, mesh, dev, jobdir):
    """``test_torch_distributed``'s training task, with the rank's head
    layout."""
    from repro_torch.models.model import Model
    out = D._train(task, mesh, dev, jobdir)
    cfg = D._port_cfg(task["arch"], task["overrides"])
    out["heads"] = Model(cfg, mesh=mesh, device="meta").heads
    return out


def _rank_main(rank, world, port, jobdir):
    """One rank: join the gloo group, build the job's mesh and run its
    tasks, then check that no JAX module was loaded."""
    rank, world, jobdir = int(rank), int(world), Path(jobdir)
    job = pickle.loads((jobdir / "job.pkl").read_bytes())
    from repro_torch.launch.mesh import init_distributed, make_test_mesh
    init_distributed(rank, world, int(port), "cpu", backend="gloo")
    mesh = make_test_mesh(*job["mesh"])
    out = {}
    for name, task in job["tasks"].items():
        out[name] = (_serve(task, mesh, "cpu") if task["kind"] == "serve"
                     else _train(task, mesh, "cpu", jobdir))
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

def _one_rank_serve(cfg_name, np_params, tokens, decode, max_len):
    """One rank's prefill and decode logits, and its final decode cache."""
    from repro_torch.models.model import Model, params_from_numpy
    arch, ov, kw = CONFIGS[cfg_name]
    cfg = D._port_cfg(arch, ov)
    model = Model(cfg, attn_chunk=D.CHUNK, kv_dtype="float32", device="cpu",
                  **kw)
    params = params_from_numpy(cfg, np_params, "cpu")
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(
        tokens)})
    full = model.decode_cache(cache, max_len)
    outs = [logits.numpy()]
    for step in decode:
        outs.append(model.decode_step(params, full,
                                      torch.from_numpy(step)).numpy())
    return outs, {k: t.numpy() for k, t in full.items() if k != "lengths"}


def _jax_serve(jm, jparams, tokens, decode):
    """The JAX model's prefill and decode logits (its decode step jitted:
    eager, a jamba step takes seconds)."""
    import jax
    import jax.numpy as jnp
    logits, cache = jm.prefill(jparams, {"tokens": jnp.asarray(tokens)})
    full = jm.init_cache(tokens.shape[0], tokens.shape[1] + len(decode))
    s = tokens.shape[1]
    full = {k: (full[k].at[:, :, :s].set(t) if k in ("k", "v") else t)
            for k, t in cache.items()}
    step = jax.jit(jm.decode_step)
    outs = [np.asarray(logits)]
    for tok in decode:
        lg, full = step(jparams, full, jnp.asarray(tok))
        outs.append(np.asarray(lg))
    return outs


@pytest.fixture(scope="module")
def layout_run(tmp_path_factory):
    """Every job's ranks' outputs, and the parent's one-rank and JAX
    values (computed while the ranks run)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(29)
    jax_models = {name: D._jax_params(*spec)
                  for name, spec in CONFIGS.items()}
    serves, batches = {}, {}
    for name, (B, S, max_len) in SERVE.items():
        vocab = jax_models[name][0].cfg.vocab_size
        serves[name] = {"tokens": rng.integers(0, vocab, (B, S)).astype(
            np.int32), "decode": [rng.integers(0, vocab, (B, 1)).astype(
                np.int32) for _ in range(STEPS)], "max_len": max_len,
            "seq_split": B == 1}
        batches[name] = D._batches(jax_models[name][0].cfg, 31)
    started, dirs = {}, {}
    for job, j in JOBS.items():
        tasks = {}
        for name in j["serve"] + j["train"]:
            arch, ov, kw = CONFIGS[name]
            common = {"arch": arch, "overrides": ov, "model_kw": kw,
                      "params": jax_models[name][2]}
            if name in j["serve"]:
                tasks[name] = {"kind": "serve", **common, **serves[name]}
            if name in j["train"]:
                tasks[name + "/train"] = {
                    "kind": "train", **common, "batches": batches[name],
                    "checkpoint": f"ckpt_{name}",
                    "restore_to": j["restore"]}
        dirs[job] = tmp_path_factory.mktemp(f"layouts{job}")
        started[job] = D.start_ranks(
            {"mesh": j["mesh"], "tasks": tasks}, dirs[job],
            j["mesh"][0] * j["mesh"][1], script=__file__)
    ref = {}
    for name, (jm, jparams, np_params) in jax_models.items():
        arch, ov, kw = CONFIGS[name]
        one, cache = _one_rank_serve(name, np_params, serves[name]["tokens"],
                                     serves[name]["decode"],
                                     serves[name]["max_len"])
        ref[name] = {"one": one, "cache": cache, "jax": _jax_serve(
            jm, jparams, serves[name]["tokens"], serves[name]["decode"])}
        if any(name in j["train"] for j in JOBS.values()):
            jloss, _ = jm.loss(jparams, {k: jnp.asarray(v)
                                         for k, v in batches[name][0].items()})
            ref[name].update(train=D._one_rank_train(
                arch, ov, kw, np_params, batches[name]),
                jax_loss=float(jloss))
    outs = {job: D.wait_ranks(s) for job, s in started.items()}
    return outs, ref, dirs


def test_layout_ranks_import_no_jax(layout_run):
    outs, _, _ = layout_run
    assert all(o["jax_loaded"] == [] for job in outs.values() for o in job)


def test_the_meshes_lay_out_the_table_s_heads(layout_run):
    """Each rank's (query slots, KV slots, ranks a KV head is on)."""
    outs, _, _ = layout_run
    want = {"1x4/granite": (2, 1, 2), "1x4/granite-moe": (1, 1, 2),
            "1x3/granite": (4, 1, 1), "1x3/qwen": (2, 2, 1),
            "1x3/granite-moe": (2, 1, 1), "2x2/granite-kv1": (4, 1, 2)}
    for key, heads in want.items():
        job, name = key.split("/")
        assert all(o[name]["heads"] == heads for o in outs[job]), key
    assert all(o["jamba"]["heads"] is None for o in outs["2x2"])


def test_the_1x3_mesh_spreads_ssm_heads_and_experts_unevenly(layout_run):
    """Each rank's (SSM heads, experts held) on model 3: 8 SSM heads as
    2, 3, 3; 4 experts as 1, 1, 2; 2 experts as none, 1, 1."""
    outs, _, _ = layout_run
    want = {"mamba2": [(2, None), (3, None), (3, None)],
            "jamba": [(2, (0, 1)), (3, (1, 2)), (3, (2, 4))],
            "granite-moe-e2": [(0, (0, 0)), (0, (0, 1)), (0, (1, 2))]}
    for name, units in want.items():
        assert [o[name]["units"] for o in outs["1x3"]] == units, name


@pytest.mark.parametrize("key", SERVES)
def test_layout_prefill_and_decode_match_one_rank_and_jax(layout_run, key):
    outs, ref, _ = layout_run
    job, name = key.split("/")
    one, jx = ref[name]["one"], ref[name]["jax"]
    for o in outs[job]:
        r = o[name]
        got = [r["prefill"]] + r["decode"]
        assert len(got) == len(one) == STEPS + 1
        for g, w, j in zip(got, one, jx):
            np.testing.assert_allclose(g, w[r["rows"]], atol=1e-5, rtol=0)
            np.testing.assert_allclose(
                g, j[r["rows"]], atol=JAX_ATOL.get(name, 1e-4), rtol=0)
        assert r["pads_zero"], "a padding head slot of the cache is not 0"
        assert r["cache"].keys() == ref[name]["cache"].keys()
        for k, want in ref[name]["cache"].items():
            # the SSM state sums every position's update (entries near 5
            # after 20): 1e-5 of its size on top of the absolute 1e-5
            np.testing.assert_allclose(r["cache"][k], want, atol=1e-5,
                                       rtol=1e-5 if k == "ssm" else 0,
                                       err_msg=k)


@pytest.mark.parametrize("key", TRAINS)
def test_layout_train_steps_match_one_rank_and_jax(layout_run, key):
    outs, ref, _ = layout_run
    job, name = key.split("/")
    one = ref[name]["train"]
    rel = TRAIN_REL_OF.get(name, TRAIN_REL)
    assert one["loss"][0] == pytest.approx(ref[name]["jax_loss"], rel=1e-5)
    for o in outs[job]:
        r = o[name + "/train"]
        for step in range(2):
            assert r["loss"][step] == pytest.approx(one["loss"][step],
                                                    rel=1e-5)
            assert r["grad_norm"][step] == pytest.approx(
                one["grad_norm"][step], rel=rel["norm"])
            grads = one["grads"][step]
            assert sorted(map(str, r["grads"][step])) == \
                sorted(map(str, grads))
            for path, g in grads.items():
                got = r["grads"][step][path]
                assert got.shape == g.shape, path       # no padding slot
                assert D._rel_l2(got, g) < rel["grad"], path
        for path, t in r["state"].items():        # no padding slot
            assert t.shape == tuple(spec_at(one["state"], path).shape), path
        D._assert_state_follows(r["state"], one["state"], r["grads"],
                                one["grads"], one["lr"],
                                (r["grad_norm"], one["grad_norm"]),
                                moment_rel=rel["moment"])
    # a replicated KV head's copies stay equal on its ranks
    heads = outs[job][0][name + "/train"]["heads"]
    if heads and heads[2] > 1:
        wk = ("layers", _attn_layer(D._port_cfg(*CONFIGS[name][:2])),
              "attn", "wk")
        for a, b in zip(outs[job][::heads[2]], outs[job][1::heads[2]]):
            assert np.array_equal(a[name + "/train"]["blocks"][wk],
                                  b[name + "/train"]["blocks"][wk])


@pytest.mark.parametrize("key", TRAINS)
def test_layout_checkpoint_restores_across_meshes_bit_for_bit(layout_run,
                                                              key):
    """A state saved on the job's mesh, gathered on every rank, equal bit
    for bit to its restore onto the other mesh and onto one rank."""
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.utils import tree_leaves, tree_map
    outs, ref, dirs = layout_run
    job, name = key.split("/")
    saved = outs[job][0][name + "/train"]["state"]
    for o in outs[job]:
        for restored in (o[name + "/train"]["restored"],
                         o[name + "/train"]["state"]):
            assert restored.keys() == saved.keys()
            for path, a in saved.items():
                np.testing.assert_array_equal(restored[path], a,
                                              err_msg=str(path))
    template = tree_map(lambda t: t.detach(), ref[name]["train"]["state"])
    state, step = ckpt.restore_checkpoint(dirs[job] / f"ckpt_{name}",
                                          template)
    assert step == 2
    for path, t in tree_leaves(state):
        np.testing.assert_array_equal(t.numpy(), saved[path],
                                      err_msg=str(path))
