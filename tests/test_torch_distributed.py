"""The port's sharded execution on a 2x2 mesh of CPU ranks against one rank
and against the JAX package.

Ranks are ``gloo`` processes that run this file as a script (see
:func:`_rank_main`): they import torch, numpy and the port, never JAX.  The
parent test draws the weights with the JAX ``Model.init``, computes the
JAX values, and hands the ranks numpy arrays; each rank keeps its block
(``Model.shard``), runs its rows, and writes its outputs for the parent.

On a (``data`` 2, ``model`` 2) mesh, in float32:

- ``Model.prefill`` and three ``Model.decode_step`` calls of smoke granite
  (vocab 512: embed and head split by vocab), of smoke granite with vocab
  257 (the reference's spec re-homes ``model`` to d_model: the lookup
  all-gathers d_model and the tied head all-reduces the logits) and of
  smoke granite-moe (experts over ``model``: the exchange) at cf = E,
  where nothing drops, and at cf 1 (tokens dropped: the whole batch's
  dispatch, one group spanning the two batch ranks, and with
  ``moe_groups`` 2 a group a rank) equal one rank within 1e-5 and the JAX
  model within the port's 1e-4;
- two FSDP x TP AdamW steps (the default schedule) of each: the loss, the
  clipped global norm and every gathered gradient leaf within rel_l2 1e-5
  of one rank's, the loss within the port's 1e-5 relative of the JAX
  loss, and after the second step every gathered parameter and moment
  against one rank's (below); smoke granite's steps also with INT8
  gradient compression;
- a checkpoint saved on 2x2 restores onto 1x4 and onto one rank with
  every leaf equal bit for bit.

The same for the ``ssm``, hybrid and encoder-decoder families' smoke
configs (mamba2-2.7b, jamba-1.5-large-398b, seamless-m4t-large-v2): a
Mamba-2 layer's rank holds its heads (B and C whole, the gated norm over
``d_inner`` split over ``model``), seamless's encoder and cross-attention
their heads; prefill, decode steps (the conv and SSM state and the cross
K/V carried in the rank's cache), loss, global norm and every gradient
leaf equal one rank within 1e-5 and the JAX model within the port's f32
tolerance of 2e-5; a mamba2 checkpoint saved on 2x2 restores onto 1x4
bit for bit.
"""
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
B, S, T, CHUNK = 4, 12, 3, 8
TRAIN_B, TRAIN_S = 4, 16
# the reference's default AdamW (lr 3e-4 after a 100-step warmup): a first
# Adam step moves a weight by about lr * g / (|g| + eps), so where |g| is
# near eps float32 rounding in g moves the weight by a share of lr; at the
# default schedule that share stays far below what the second step's
# gradients can see (with lr 1e-2 it reaches 5e-5 in a weight)
OPT = dict()
# name: (arch, config overrides, Model options)
VARIANTS = {"granite": ("granite-3-8b", {}, {}),
            "granite-odd-vocab": ("granite-3-8b", {"vocab_size": 257}, {}),
            "granite-moe": ("granite-moe-3b-a800m", {"capacity_factor": 4.0},
                            {}),
            "granite-moe-drop": ("granite-moe-3b-a800m",
                                 {"capacity_factor": 1.0}, {}),
            "granite-moe-groups": ("granite-moe-3b-a800m",
                                   {"capacity_factor": 1.0},
                                   {"moe_groups": 2}),
            "mamba2": ("mamba2-2.7b", {}, {}),
            "jamba": ("jamba-1.5-large-398b", {}, {}),
            "seamless": ("seamless-m4t-large-v2", {}, {})}
# each variant's tolerance against the JAX model's logits: the port's 1e-4
# (PR 26's variants), the repo's f32 2e-5 for the three families
JAX_ATOL = {"mamba2": 2e-5, "jamba": 2e-5, "seamless": 2e-5}
# the variants whose FSDP x TP state is saved and restored onto 1x4
CHECKPOINTED = ("granite", "mamba2")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(job: dict, jobdir: Path, world: int,
                script: str = __file__):
    """Start ``world`` ranks of ``script`` (default this file) on ``job``;
    :func:`wait_ranks` collects them."""
    jobdir.mkdir(parents=True, exist_ok=True)
    (jobdir / "job.pkl").write_bytes(pickle.dumps(job))
    port = _free_port()
    # one thread a rank: the ranks share the machine with the other tests
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = []
    for r in range(world):
        err = open(jobdir / f"err_{r}.txt", "w")
        procs.append((subprocess.Popen(
            [sys.executable, script, str(r), str(world), str(port),
             str(jobdir)], env=env, stdout=err, stderr=subprocess.STDOUT),
            err))
    return jobdir, procs


def wait_ranks(started, timeout: float = 240):
    """The outputs (one per rank) of :func:`start_ranks`' ranks.  A rank
    that fails fails the call, with its error output."""
    jobdir, procs = started
    world = len(procs)
    deadline = time.monotonic() + timeout
    try:      # until all end, one fails (the others would wait on it) or
        while time.monotonic() < deadline:        # the time runs out
            codes = [p.poll() for p, _ in procs]
            if all(c is not None for c in codes) or any(codes):
                break
            time.sleep(0.1)
    finally:
        for p, err in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            err.close()
    # a rank that failed first, then those stopped because of it
    for r in sorted(range(world), key=lambda r: procs[r][0].returncode < 0):
        p = procs[r][0]
        assert p.returncode == 0, (
            f"rank {r} exited {p.returncode}:\n"
            + (jobdir / f"err_{r}.txt").read_text()[-4000:])
    return [pickle.loads((jobdir / f"out_{r}.pkl").read_bytes())
            for r in range(world)]


def launch_ranks(job: dict, jobdir: Path, world: int, timeout: float = 240):
    """Run ``world`` ranks of this file on ``job`` and return their
    outputs (one per rank)."""
    return wait_ranks(start_ranks(job, jobdir, world), timeout)


# ------------------------------------------------------------- rank side

def _port_cfg(arch, overrides):
    from repro_torch.configs import get_smoke_config
    return get_smoke_config(arch).scaled(param_dtype="float32", **overrides)


def _rows(mesh, n):
    d, nd = mesh.coord("data"), mesh.sizes["data"]
    return slice(d * n // nd, (d + 1) * n // nd)


def _serve(task, mesh, dev):
    from repro_torch.models.model import Model, params_from_numpy
    cfg = _port_cfg(task["arch"], task["overrides"])
    model = Model(cfg, mesh=mesh, attn_chunk=CHUNK, kv_dtype="float32",
                  device=dev, **task.get("model_kw", {}))
    if task.get("layout") == "port":          # the port's own tree
        from repro_torch.utils import tree_map
        whole = tree_map(lambda a: torch.from_numpy(a).to(dev),
                         task["params"])
    else:                                     # the reference's numpy tree
        whole = params_from_numpy(cfg, task["params"], dev)
    params = model.shard(whole)
    rows = _rows(mesh, task["tokens"].shape[0])
    batch = {k: torch.from_numpy(task[k][rows]).to(dev)
             for k in ("tokens", "enc_embeds") if k in task}
    logits, cache = model.prefill(params, batch)
    full = model.decode_cache(
        cache, batch["tokens"].shape[1] + len(task["decode"]))
    out = {"prefill": logits.cpu().numpy(), "decode": [], "rows": rows}
    for step in task["decode"]:
        out["decode"].append(model.decode_step(
            params, full, torch.from_numpy(step[rows]).to(dev)).cpu().numpy())
    return out


def _gathered(tree, specs, whole, mesh):
    from repro_torch.distributed.ctx import gather_full
    from repro_torch.distributed.sharding import spec_at
    from repro_torch.utils import tree_leaves
    return {path: gather_full(t.detach(), spec_at(specs, path),
                              tuple(spec_at(whole, path).shape),
                              mesh).numpy()
            for path, t in tree_leaves(tree)}


def _train(task, mesh, dev, jobdir):
    from repro_torch.models.model import Model, params_from_numpy
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step
    from repro_torch.utils import tree_leaves
    cfg = _port_cfg(task["arch"], task["overrides"])
    # float32 cross K/V (an encoder-decoder's loss reads them in
    # kv_dtype), as the JAX model's
    model = Model(cfg, mesh=mesh, attn_chunk=CHUNK, kv_dtype="float32",
                  device=dev, **task.get("model_kw", {}))
    whole = params_from_numpy(cfg, task["params"], dev)
    params = model.shard(whole, "train")
    for _, p in tree_leaves(params):
        p.requires_grad_(True)
    state = {"params": params, **init_opt_state(params)}
    step = make_train_step(model, AdamWConfig(**OPT), keep_grads=True,
                           grad_compression=task.get("q8", False))
    specs = model.layouts("train")
    out = {"loss": [], "grad_norm": [], "grads": []}
    for batch in task["batches"]:
        rows = _rows(mesh, batch["tokens"].shape[0])
        state, m = step(state, {k: torch.from_numpy(v[rows]).to(dev)
                                for k, v in batch.items()})
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["grads"].append(_gathered(m["grads"], specs, whole, mesh))
    spec_tree = {"params": specs, "m": specs, "v": specs, "step": ()}
    whole_state = {"params": whole, "m": whole, "v": whole,
                   "step": state["step"]}
    out["state"] = _gathered(state, spec_tree, whole_state, mesh)
    out["blocks"] = {path: t.detach().numpy()
                     for path, t in tree_leaves(state["params"])}
    if task.get("checkpoint"):
        where = jobdir / task["checkpoint"]
        ckpt.save_checkpoint(where, state, 2, mesh=mesh, spec_tree=spec_tree)
        out["restored"] = _restore(cfg, whole, state, where,
                                   task.get("restore_to", (1, 4)))
    return out


def _restore(cfg, whole, template, where, shape=(1, 4)):
    """The checkpoint at ``where`` restored onto a (data, model) mesh of
    ``shape`` over the same ranks (by that mesh's layouts: a Mamba layer's
    heads are regrouped, attention heads laid out anew), every leaf
    gathered back whole."""
    from repro_torch.distributed.sharding import param_layouts
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.training import checkpoint as ckpt
    mesh = make_test_mesh(*shape)
    specs = param_layouts(cfg, whole, "train", mesh)
    spec_tree = {"params": specs, "m": specs, "v": specs, "step": ()}
    state, step = ckpt.restore_checkpoint(where, template, mesh=mesh,
                                          spec_tree=spec_tree)
    whole_state = {"params": whole, "m": whole, "v": whole,
                   "step": template["step"]}
    return _gathered(state, spec_tree, whole_state, mesh)


def _norm(task, mesh):
    """The gated norm's split form on this rank's columns of ``x`` (T, d)
    (``layers.apply_norm(over_model=True)``, kernel entries and plain twins
    alike): its output and the gradients of ``sum(out * g)`` with respect
    to its columns of ``x`` and ``scale``."""
    from repro_torch.distributed.ctx import mesh_context
    from repro_torch.models import layers as L
    cfg = _port_cfg("mamba2-2.7b", {})
    c, m = mesh.coord("model"), mesh.sizes["model"]
    d = task["x"].shape[1]
    cols = slice(c * d // m, (c + 1) * d // m)
    out = {}
    for use_kernel in (True, False):
        x = torch.from_numpy(task["x"][:, cols].copy()).requires_grad_(True)
        scale = torch.from_numpy(task["scale"][cols].copy()).requires_grad_(
            True)
        with mesh_context(mesh):
            y = L.apply_norm(cfg, {"scale": scale}, x, use_kernel=use_kernel,
                             over_model=True)
        (y * torch.from_numpy(task["g"][:, cols].copy())).sum().backward()
        out[use_kernel] = {"y": y.detach().numpy(), "dx": x.grad.numpy(),
                           "dscale": scale.grad.numpy(), "cols": cols}
    return out


def _rank_main(rank, world, port, jobdir):
    """One rank: join the gloo group, build the job's mesh and run its
    tasks, then check that no JAX module was loaded."""
    rank, world, jobdir = int(rank), int(world), Path(jobdir)
    job = pickle.loads((jobdir / "job.pkl").read_bytes())
    from repro_torch.launch.mesh import init_distributed, make_test_mesh
    dev = job.get("device", "cpu")
    init_distributed(rank, world, int(port), dev, backend="gloo")
    mesh = make_test_mesh(*job["mesh"])
    out = {}
    for name, task in job["tasks"].items():
        if task["kind"] == "serve":
            out[name] = _serve(task, mesh, dev)
        elif task["kind"] == "norm":
            out[name] = _norm(task, mesh)
        else:
            out[name] = _train(task, mesh, dev, jobdir)
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

def _jax_params(arch, overrides, model_kw):
    import jax
    from repro.configs import get_smoke_config
    from repro.models.model import Model as JaxModel
    cfg = get_smoke_config(arch).scaled(param_dtype="float32", **overrides)
    jm = JaxModel(cfg, kv_dtype="float32", attn_chunk=CHUNK, remat=False,
                  **model_kw)
    p = jm.init(jax.random.PRNGKey(0))
    return jm, p, jax.tree_util.tree_map(np.asarray, p)


def _jax_serve(jm, jparams, batch, decode):
    import jax.numpy as jnp
    tokens = batch["tokens"]
    logits, cache = jm.prefill(jparams, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    full = jm.init_cache(tokens.shape[0], tokens.shape[1] + len(decode))
    s = tokens.shape[1]
    full = {k: (full[k].at[:, :, :s].set(t) if k in ("k", "v") else t)
            for k, t in cache.items()}
    outs = [np.asarray(logits)]
    for step in decode:
        lg, full = jm.decode_step(jparams, full, jnp.asarray(step))
        outs.append(np.asarray(lg))
    return outs


def _one_rank_serve(arch, overrides, model_kw, np_params, batch, decode):
    """The one-rank logits of the prefill and each decode step, and how
    many of the MoE's assignments were dropped (0 without experts)."""
    from repro_torch.models.model import Model, params_from_numpy
    cfg = _port_cfg(arch, overrides)
    model = Model(cfg, attn_chunk=CHUNK, kv_dtype="float32", device="cpu",
                  **model_kw)
    dropped = []
    model.moe_tap = lambda shape, idx, keep: dropped.append(
        int((~keep).sum()))
    params = params_from_numpy(cfg, np_params, "cpu")
    logits, cache = model.prefill(params, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
    full = model.decode_cache(cache,
                              batch["tokens"].shape[1] + len(decode))
    outs = [logits.numpy()]
    for step in decode:
        outs.append(model.decode_step(params, full,
                                      torch.from_numpy(step)).numpy())
    return outs, sum(dropped)


def _one_rank_train(arch, overrides, model_kw, np_params, batches,
                    q8=False):
    from repro_torch.models.model import Model, params_from_numpy
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step
    from repro_torch.utils import tree_leaves
    cfg = _port_cfg(arch, overrides)
    model = Model(cfg, attn_chunk=CHUNK, kv_dtype="float32", device="cpu",
                  **model_kw)
    params = params_from_numpy(cfg, np_params, "cpu")
    for _, p in tree_leaves(params):
        p.requires_grad_(True)
    state = {"params": params, **init_opt_state(params)}
    step = make_train_step(model, AdamWConfig(**OPT), keep_grads=True,
                           grad_compression=q8)
    out = {"loss": [], "grad_norm": [], "grads": [], "lr": []}
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["lr"].append(float(m["lr"]))
        out["grads"].append({path: g.detach().numpy()
                             for path, g in tree_leaves(m["grads"])})
    out["state"] = state
    return out


def _batches(cfg, seed):
    """Two training batches; an encoder-decoder's with ``enc_embeds``
    frames (TRAIN_B, TRAIN_S, D)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        b = {k: rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S)).astype(
            np.int32) for k in ("tokens", "targets")}
        if cfg.is_encoder_decoder:
            b["enc_embeds"] = rng.standard_normal(
                (TRAIN_B, TRAIN_S, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The 2x2 ranks' outputs and the parent's one-rank and JAX values."""
    import jax.numpy as jnp
    tasks, ref = {}, {}
    rng = np.random.default_rng(7)
    for name, (arch, ov, kw) in VARIANTS.items():
        jm, jparams, np_params = _jax_params(arch, ov, kw)
        cfg = jm.cfg
        vocab = cfg.vocab_size
        if cfg.is_encoder_decoder:       # frames, then a decoder start
            batch = {"enc_embeds": rng.standard_normal(
                (B, cfg.cross_kv_len, cfg.d_model)).astype(np.float32),
                "tokens": rng.integers(0, vocab, (B, 1)).astype(np.int32)}
        else:
            batch = {"tokens": rng.integers(0, vocab, (B, S)).astype(
                np.int32)}
        decode = [rng.integers(0, vocab, (B, 1)).astype(np.int32)
                  for _ in range(T)]
        common = {"arch": arch, "overrides": ov, "model_kw": kw,
                  "params": np_params}
        tasks[name] = {"kind": "serve", **common, **batch,
                       "decode": decode}
        batches = _batches(cfg, 11)
        tasks[name + "/train"] = {
            "kind": "train", **common, "batches": batches,
            "checkpoint": f"ckpt_{name}" if name in CHECKPOINTED else None}
        jloss, _ = jm.loss(jparams, {k: jnp.asarray(v)
                                     for k, v in batches[0].items()})
        one, dropped = _one_rank_serve(arch, ov, kw, np_params, batch,
                                       decode)
        ref[name] = {"jax": _jax_serve(jm, jparams, batch, decode),
                     "one": one, "dropped": dropped,
                     "train": _one_rank_train(arch, ov, kw, np_params,
                                              batches),
                     "jax_loss": float(jloss)}
        if name == "granite":
            tasks[name + "/train-q8"] = {**tasks[name + "/train"],
                                         "checkpoint": False, "q8": True}
            ref[name + "-q8"] = {"train": _one_rank_train(
                arch, ov, kw, np_params, batches, q8=True)}
    nrng = np.random.default_rng(5)
    tasks["norm"] = {"kind": "norm",
                     "x": nrng.standard_normal((6, 128)).astype(np.float32),
                     "scale": nrng.standard_normal(128).astype(np.float32),
                     "g": nrng.standard_normal((6, 128)).astype(np.float32)}
    ref["norm"] = tasks["norm"]
    jobdir = tmp_path_factory.mktemp("mesh2x2")
    outs = launch_ranks({"mesh": (2, 2), "device": "cpu", "tasks": tasks},
                        jobdir, world=4)
    return outs, ref, jobdir


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def test_ranks_import_no_jax(mesh_run):
    outs, _, _ = mesh_run
    assert all(o["jax_loaded"] == [] for o in outs)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_sharded_prefill_and_decode_match_one_rank_and_jax(mesh_run, name):
    outs, ref, _ = mesh_run
    one, jx = ref[name]["one"], ref[name]["jax"]
    if VARIANTS[name][1].get("capacity_factor") == 1.0:
        assert ref[name]["dropped"] > 0     # the capacity binds
    for o in outs:
        r = o[name]
        got = [r["prefill"]] + r["decode"]
        assert len(got) == len(one) == T + 1
        for g, w, j in zip(got, one, jx):
            np.testing.assert_allclose(g, w[r["rows"]], atol=1e-5, rtol=0)
            np.testing.assert_allclose(g, j[r["rows"]],
                                       atol=JAX_ATOL.get(name, 1e-4), rtol=0)


TRAIN_RUNS = {**{name: name + "/train" for name in VARIANTS},
              "granite-q8": "granite/train-q8"}


def _assert_state_follows(got, one, grads_got, grads_one, lrs, norms,
                          moments=True, moment_rel=1e-5):
    """The gathered state after the steps against one rank's: each moment
    within rel_l2 ``moment_rel`` (with ``moments``), and each weight within
    8 ulps plus what its gradients' float32 differences can move an Adam
    step:
    an update ``m / (sqrt(v) + eps)`` changes by at most about
    ``|dg| / eps`` (and by 2 at most) where ``|g|`` is near ``eps``, so
    the weight by ``lr`` times that, each step.  ``norms`` (the two runs'
    global norms, step by step) add the clip's share: where the norm
    passes the clip, every gradient is scaled by ``clip / norm``, and the
    norms' relative float32 difference ``d`` moves each step's scale by
    ``d``; scales that differ from step to step move an update by at most
    ``d / (1 - b1)``."""
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.utils import tree_leaves
    cfg = AdamWConfig(**OPT)
    eps = cfg.eps
    d = max(abs(a - b) / b for a, b in zip(*norms))
    for path, t in tree_leaves(one):
        want = t.detach().numpy()
        if path[0] == "params":
            dg = sum(np.abs(gg[path[1:]] - go[path[1:]])
                     for gg, go in zip(grads_got, grads_one))
            tol = (8 * np.spacing(np.abs(want))
                   + sum(lrs) * np.minimum(2.0, 4.0 * dg / eps)
                   + sum(lrs) * 2 * d / (1 - cfg.b1))
            assert np.all(np.abs(got[path] - want) <= tol), path
        elif path[0] in ("m", "v") and moments:
            assert _rel_l2(got[path], want) < moment_rel, path


def _assert_same_int8(got, want, path):
    """Two INT8 round trips of gradients that agree within float32
    rounding: the whole leaf's scale within 1e-5 relative, and each code
    within 1 of the other's (a value near a rounding boundary may fall
    either way), for at most 1 in 1000 elements."""
    s_got, s_want = np.abs(got).max() / 127, np.abs(want).max() / 127
    assert s_got == pytest.approx(s_want, rel=1e-5), path
    codes = np.rint(got / s_got) - np.rint(want / s_want)
    assert np.abs(codes).max() <= 1, path
    assert np.count_nonzero(codes) <= want.size // 1000, path


@pytest.mark.parametrize("name", list(TRAIN_RUNS))
def test_fsdp_tp_train_steps_match_one_rank_and_jax(mesh_run, name):
    outs, ref, _ = mesh_run
    one = ref[name]["train"]
    if "jax_loss" in ref[name]:
        assert one["loss"][0] == pytest.approx(ref[name]["jax_loss"],
                                               rel=1e-5)
    for o in outs:
        r = o[TRAIN_RUNS[name]]
        for step in range(2):
            assert r["loss"][step] == pytest.approx(one["loss"][step],
                                                    rel=1e-5)
            assert r["grad_norm"][step] == pytest.approx(
                one["grad_norm"][step], rel=1e-6)
            grads = one["grads"][step]
            assert sorted(map(str, r["grads"][step])) == \
                sorted(map(str, grads))
            for path, g in grads.items():
                assert float(np.abs(g).max()) > 0, path
                if name.endswith("-q8"):
                    _assert_same_int8(r["grads"][step][path], g, path)
                else:
                    assert _rel_l2(r["grads"][step][path], g) < 1e-5, path
        # the INT8 run's moments carry the codes held above
        _assert_state_follows(r["state"], one["state"], r["grads"],
                              one["grads"], one["lr"],
                              (r["grad_norm"], one["grad_norm"]),
                              moments=not name.endswith("-q8"))


def _assert_restores(mesh_run, name):
    """The 2x2 state of ``name``'s training, gathered on every rank, equal
    bit for bit to its restore onto 1x4 and onto one rank."""
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.utils import tree_leaves, tree_map
    outs, ref, jobdir = mesh_run
    saved = outs[0][name + "/train"]["state"]
    for o in outs:
        for restored in (o[name + "/train"]["restored"],
                         o[name + "/train"]["state"]):
            assert restored.keys() == saved.keys()
            for path, a in saved.items():
                np.testing.assert_array_equal(restored[path], a,
                                              err_msg=str(path))
    one_state = ref[name]["train"]["state"]
    template = tree_map(lambda t: t.detach(), one_state)
    state, step = ckpt.restore_checkpoint(jobdir / f"ckpt_{name}", template)
    assert step == 2
    for path, t in tree_leaves(state):
        np.testing.assert_array_equal(t.numpy(), saved[path],
                                      err_msg=str(path))


def test_checkpoint_restores_onto_other_meshes_bit_for_bit(mesh_run):
    _assert_restores(mesh_run, "granite")


def test_mamba2_checkpoint_restores_onto_other_meshes_bit_for_bit(mesh_run):
    """The Mamba leaves' head-aware blocks (B and C on both ``model``
    ranks of 2x2) regroup onto 1x4's four ranks of two heads each."""
    _assert_restores(mesh_run, "mamba2")


@pytest.mark.parametrize("use_kernel", [True, False])
def test_split_rmsnorm_across_ranks_matches_the_whole_row_and_jax(
        mesh_run, use_kernel):
    """The gated norm's split form on two ``model`` ranks (each 64 of the
    row's 128 columns), its pieces concatenated: the output against the
    whole-row norm and the JAX ``apply_norm``, and the gradients of
    ``sum(out * g)`` (crossing the ranks through the summed statistic)
    against ``jax.grad`` of the whole row's, in float32."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.models import layers as JL
    from repro_torch.kernels.fused_rmsnorm import rmsnorm_ref
    outs, ref, _ = mesh_run
    task = ref["norm"]
    by_model = {}
    for o in outs:                   # the two data rows hold equal copies
        r = o["norm"][use_kernel]
        by_model[r["cols"].start] = r
    parts = [by_model[k] for k in sorted(by_model)]
    assert len(parts) == 2
    got = {k: np.concatenate([p[k] for p in parts], axis=-1)
           for k in ("y", "dx", "dscale")}
    whole = rmsnorm_ref(torch.from_numpy(task["x"]),
                        torch.from_numpy(task["scale"])).numpy()
    np.testing.assert_allclose(got["y"], whole, atol=1e-6, rtol=0)
    jcfg = get_smoke_config("mamba2-2.7b")

    def f(x, scale):
        y = JL.apply_norm(jcfg, {"scale": scale}, x)
        return jnp.sum(y * task["g"]), y
    (_, jy), (jdx, jdscale) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(task["x"]),
                                         jnp.asarray(task["scale"]))
    np.testing.assert_allclose(got["y"], np.asarray(jy), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got["dx"], np.asarray(jdx), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(got["dscale"], np.asarray(jdscale),
                               atol=2e-5, rtol=0)
