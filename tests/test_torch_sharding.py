"""The port's sharding rules, mesh refusals, dry run and small copies against
the JAX package, in process and with no ranks.

- Spec equality: for all ten registered configs, full and smoke, every
  ``SHAPES`` entry and the meshes 16x16, 2x16x16, 2x4, 2x2 and 1x4, the
  port's sanitized param specs (serving and train), batch specs and cache
  specs equal the reference's leaf by leaf.  Each port leaf maps to the
  reference's stacked leaf as ``params_from_numpy`` maps them
  (``sharding.ref_leaf``).  The reference's rules read only
  ``mesh.axis_names`` and ``mesh.devices.shape``, so a stand-in with
  ``devices = np.empty(shape)`` serves and no JAX devices are needed.
- Layouts and refusals: heads the ``model`` axis does not split evenly
  take ``sharding.head_layout``'s slots (replicated KV heads on a model
  axis of 4, padded ones on 3), every config constructs on both
  production meshes and, on the meta device, on every (data 1 or 2) x
  (model 1..16) mesh, its layouts holding each leaf's units once; what
  stays refused raises (the one-rank entry points on a mesh of more than
  one rank); the ``ssm``, hybrid and encoder-decoder families construct
  and shard on 2x2, and jamba also on 1x4.
- The port's Mamba blocks: a rank's ``in_proj`` and ``conv_w`` hold its
  heads' z, x and dt and B and C whole, and reassemble into the
  reference's whole leaf, on model 2 and with uneven heads on model 3
  (2, 3, 3; the SSD kernel's plan at odd head counts); the split-row
  RMSNorm's plain twins against the whole-row norm and the JAX
  ``apply_norm``.
- The dry run on full granite-3-8b's ``decode_32k`` cell: on 16x16 the
  port's per-rank bytes (a replicated KV head a rank) beside the sum over
  the reference's sanitized specs, and collectives; on 2x4 bytes equal to
  the spec's; the CLI writes its JSONL records.  mamba2-2.7b,
  seamless-m4t-large-v2 and jamba-1.5-large-398b record collectives on
  the production meshes, jamba's ``long_500k`` the context split's, and
  mamba2 on model 3 each rank's bytes; no supported cell of either
  production mesh is refused.
- The copies: the tokenizer and the utils helpers.
"""
import json
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import utils as JU  # noqa: E402
from repro.configs import ASSIGNED_ARCHS, SHAPES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import tokenizer as JT  # noqa: E402
from repro_torch import utils as U  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.distributed import ctx as C  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.distributed.ctx import Mesh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import tokenizer as T  # noqa: E402

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "2x4": (("data", "model"), (2, 4)),
          "2x2": (("data", "model"), (2, 2)),
          "1x4": (("data", "model"), (1, 4))}


class _RefMesh:
    """What the reference's rules read of a mesh."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.empty(shape)


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): leaf for kp, leaf in flat}


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_specs_equal_the_reference(arch, size):
    jcfg = jax_config(arch) if size == "full" else jax_smoke(arch)
    cfg = get_config(arch) if size == "full" else get_smoke_config(arch)
    jm = JaxModel(jcfg)
    jshape = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    jleaves = _ref_leaves(jshape)
    whole = Model(cfg, device="meta").init(torch.Generator())
    mapped = {}
    for path, t in U.tree_leaves(whole):
        ref, shape = S.ref_leaf(cfg, path, t.shape)
        assert tuple(jleaves[ref].shape) == shape, (path, ref)
        mapped[path] = ref
    assert set(mapped.values()) == set(jleaves)
    port_model = Model(cfg, device="meta")
    for mname, (names, shape) in MESHES.items():
        jmesh, mesh = _RefMesh(names, shape), Mesh(names, shape)
        for mode in ("serving", "train"):
            jspecs = _ref_leaves(JS.sanitize_specs(
                jshape, JS.param_specs(jcfg, jshape, mode), jmesh))
            specs = S.sanitized_param_specs(cfg, whole, mode, mesh)
            for path, ref in mapped.items():
                assert S.spec_at(specs, path) == tuple(jspecs[ref]), \
                    (mname, mode, path)
        for sname, shp in SHAPES.items():
            jins = jm.input_specs(shp)
            batch_shapes = {k: v.shape for k, v in jins.items()
                            if k != "cache"}
            if shp.kind == "decode":
                batch_shapes = {"tokens": jins["tokens"].shape}
            jb = JS.sanitize_specs(
                {k: jins[k] for k in batch_shapes},
                {k: v for k, v in JS.batch_specs(jcfg, shp, jmesh).items()
                 if k in batch_shapes}, jmesh)
            pb = S.sanitize_specs(batch_shapes,
                                  S.batch_specs(cfg, shp, mesh), mesh)
            assert pb == {k: tuple(v) for k, v in jb.items()}, (mname,
                                                                 sname)
            jcache = jm.cache_shapes(shp.global_batch, shp.seq_len)
            cshapes = {k: s for k, (s, _) in port_model.cache_shapes(
                shp.global_batch, shp.seq_len).items()}
            assert cshapes == {k: tuple(v.shape) for k, v in jcache.items()}
            jc = JS.sanitize_specs(jcache, JS.cache_specs(jcfg, shp, jmesh),
                                   jmesh)
            pc = S.sanitize_specs(cshapes, S.cache_specs(cfg, shp, mesh),
                                  mesh)
            assert pc == {k: tuple(v) for k, v in jc.items()}, (mname,
                                                                 sname)


def _smoke(arch, **kw):
    return get_smoke_config(arch).scaled(param_dtype="float32", **kw)


def test_a_head_split_inside_a_head_raises():
    """Heads the ``model`` axis would split inside take whole-head slots
    instead (``sharding.head_layout``), as the table of the layouts says:
    smoke granite's 8/2 heads on 4 ranks (1 KV head on 2 ranks, 2 query
    heads a rank) and on 3 (padded to 3 KV / 12 query slots, rank 0's all
    padding), full granite-moe's 24/8 on 16 (G 3 padded to 4) and
    qwen1.5's 40/40 (padded to 48/48); every rank's blocks of ``wq``,
    ``wk`` and ``wo`` gather back into the whole leaf.  SSM heads that do
    not split whole construct too: smoke jamba's 8 on 3 ranks as 2, 3, 3
    (they raised until the port spread them)."""
    from repro_torch.distributed.ctx import _whole_columns
    cfg = _smoke("granite-3-8b")
    assert (cfg.num_heads, cfg.num_kv_heads) == (8, 2)
    want = {4: (2, 1, 2, [([0, 1], [0]), ([2, 3], [0]), ([4, 5], [1]),
                          ([6, 7], [1])]),
            3: (4, 1, 1, [([], []), ([0, 1, 2, 3], [0]),
                          ([4, 5, 6, 7], [1])])}
    whole = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    for m, (q, kv, rep, blocks) in want.items():
        assert tuple(S.head_layout(cfg, m)) == (q, kv, rep, blocks)
        for name in ("wq", "wk", "wo"):
            parts = []
            for c in range(m):
                model = Model(cfg, mesh=Mesh(("data", "model"), (1, m),
                                             coords=(0, c)), device="cpu")
                assert model.heads == (q, kv, rep)
                spec = S.spec_at(model.layouts(), ("layers", 0, "attn",
                                                   name))
                parts.append(C._expanded_block(
                    model.shard(whole)["layers"][0]["attn"][name], spec,
                    model.mesh))
            np.testing.assert_array_equal(
                _whole_columns(torch.cat(parts, spec.dim), spec),
                whole["layers"][0]["attn"][name])
    assert tuple(S.head_layout(get_config("granite-moe-3b-a800m"),
                               16))[:3] == (2, 1, 2)
    assert tuple(S.head_layout(get_config("qwen1.5-32b"), 16))[:3] == \
        (3, 3, 1)
    assert [Model(_smoke("jamba-1.5-large-398b"),
                  mesh=Mesh(("data", "model"), (1, 3), coords=(0, c)),
                  device="cpu").ssm_heads for c in range(3)] == [2, 3, 3]


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2"])
def test_families_without_sharded_execution_raise(arch):
    """The ``ssm``, hybrid and encoder-decoder families construct and
    shard on 2x2 (every rank's blocks of every leaf, in both modes, equal
    to the blocks ``Model.init(gen, mode)`` keeps layer by layer); jamba
    also on 1x4 (its 2 KV heads at smoke size replicated on two ranks
    each) and its ``long_500k`` cell (the context split) records the
    merge's max and sum all-reduces on 2x2; the engine's one-rank entry
    points still raise."""
    from repro_torch.models.config import SHAPES as PSHAPES
    cfg = _smoke(arch)
    whole = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    for coords in ((0, 0), (1, 1)):
        m = Model(cfg, mesh=Mesh(("data", "model"), (2, 2), coords=coords),
                  device="cpu")
        for mode in ("serving", "train"):
            blocks = m.shard(whole, mode)
            drawn = m.init(torch.Generator().manual_seed(0), mode)
            for (path, t), (path2, t2) in zip(U.tree_leaves(blocks),
                                              U.tree_leaves(drawn)):
                assert path == path2 and torch.equal(t, t2), path
                assert tuple(t.shape) == S.local_shape(
                    S.spec_at(m._whole_shapes(), path).shape,
                    S.spec_at(m.layouts(mode), path), m.mesh), path
    with pytest.raises(ValueError, match="does not run sharded"):
        m.prefill_chunk(None, None, None, None, None, None)
    m4 = Model(cfg, mesh=Mesh(("data", "model"), (1, 4)), device="cpu")
    if arch == "jamba-1.5-large-398b":
        assert m4.heads == (1, 1, 2)
        mesh = Mesh(("data", "model"), (2, 2))
        rec = dryrun.dry_cell(arch, "long_500k", mesh, cfg=cfg)
        assert PSHAPES["long_500k"].global_batch == 1
        assert rec["collectives_reason"] is None
        merges = [r for r in mesh.records if r["axes"] == ["data"]]
        attn = sum(cfg.layer_kind(i) == "attn"
                   for i in range(cfg.num_layers))
        # each attention layer's max and sum over the positions' ranks
        assert len(merges) == 2 * attn
        assert rec["collectives"]["counts"]["all-reduce"] > 2 * attn


def test_mamba_blocks_hold_their_heads_and_gather_back_whole():
    """On a model axis of 2, rank r's ``in_proj`` columns are z and x of
    its heads, B and C whole and dt of its heads, and ``conv_w``'s the
    same channels; the ranks' blocks laid side by side (the expanded leaf)
    give back the reference's whole leaf.  At full width mamba2-2.7b's
    rank holds 5416 columns of ``in_proj``, where the spec's block is
    5288."""
    from repro_torch.distributed.ctx import HeadSplit, _whole_columns
    cfg = _smoke("mamba2-2.7b")
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    whole = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    p = whole["layers"][0]["ssm"]
    for name, kind in (("in_proj", "proj"), ("conv_w", "conv")):
        blocks = []
        for r in range(2):
            m = Model(cfg, mesh=Mesh(("data", "model"), (1, 2),
                                     coords=(0, r)), device="cpu")
            spec = S.spec_at(m.layouts(), ("layers", 0, "ssm", name))
            assert isinstance(spec, HeadSplit)
            blk = m.shard(whole)["layers"][0]["ssm"][name]
            heads = slice(r * di // 2, (r + 1) * di // 2)
            w = p[name]
            if kind == "proj":
                want = torch.cat([w[:, heads], w[:, di:2 * di][:, heads],
                                  w[:, 2 * di:2 * di + 2 * N],
                                  w[:, 2 * di + 2 * N:][:, r * H // 2:
                                                        (r + 1) * H // 2]],
                                 dim=-1)
            else:
                want = torch.cat([w[:, heads], w[:, di:di + 2 * N]], dim=-1)
            assert torch.equal(blk, want), (name, r)
            blocks.append(blk)
        assert torch.equal(_whole_columns(torch.cat(blocks, -1), spec),
                           p[name])
    full = get_config("mamba2-2.7b")
    meta = Model(full, device="meta").init(torch.Generator())
    mesh = Mesh(("data", "model"), (1, 2))
    shape = meta["layers"][0]["ssm"]["in_proj"].shape
    lay = S.param_layouts(full, meta, "serving", mesh)
    spec = S.sanitized_param_specs(full, meta, "serving", mesh)
    path = ("layers", 0, "ssm", "in_proj")
    assert S.local_shape(shape, S.spec_at(lay, path), mesh)[-1] == 5416
    assert S.local_shape(shape, S.spec_at(spec, path), mesh)[-1] == 5288


def test_head_split_index_of_uneven_heads():
    """On a model axis of 3, smoke mamba2's 8 SSM heads of 16 columns lie
    2, 3, 3 on the ranks: each rank's ``in_proj`` holds exactly its heads'
    z and x columns, B and C whole and its heads' dt; ``conv_w`` and
    ``conv_b`` its heads' x and B and C; ``A_log``, ``D_skip`` and
    ``dt_bias`` its heads; ``out_proj`` its heads' rows and the gated
    norm's ``scale`` their columns; its cache the conv channels and SSM
    state of its heads.  The blocks gather back into the whole leaf, and
    ``owned_columns`` counts every column once over the ranks (B and C
    at rank 0).  Full mamba2's 80 heads of 64 lie 26, 27, 27: 1664, 1728
    and 1728 columns of z, x and the gated norm a rank."""
    from repro_torch.distributed.ctx import _expanded_block, _whole_columns
    from repro_torch.models.config import ShapeSpec
    cfg = _smoke("mamba2-2.7b")
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    assert (H, P) == (8, 16)
    heads = [[0, 1], [2, 3, 4], [5, 6, 7]]
    assert S.even_blocks(H, 3) == heads
    whole = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    p = whole["layers"][0]["ssm"]
    parts, owned = {}, {}
    for c, hs in enumerate(heads):
        model = Model(cfg, mesh=Mesh(("data", "model"), (1, 3),
                                     coords=(0, c)), device="cpu")
        assert model.ssm_heads == len(hs)
        blk = model.shard(whole)["layers"][0]["ssm"]
        x = [h * P + i for h in hs for i in range(P)]
        conv = x + list(range(di, di + 2 * N))
        want = {"in_proj": x + [di + i for i in x]
                + list(range(2 * di, 2 * di + 2 * N))
                + [2 * di + 2 * N + h for h in hs],
                "conv_w": conv, "conv_b": conv, "A_log": hs, "D_skip": hs,
                "dt_bias": hs}
        for name, cols in want.items():
            assert torch.equal(blk[name], p[name][..., cols]), (name, c)
        assert torch.equal(blk["out_proj"], p["out_proj"][x])
        assert torch.equal(blk["gate_norm"]["scale"],
                           p["gate_norm"]["scale"][x])
        layouts = model.layouts()["layers"][0]["ssm"]
        for name in list(want) + ["out_proj", "gate_norm"]:
            spec = layouts[name]["scale"] if name == "gate_norm" \
                else layouts[name]
            t = blk[name]["scale"] if name == "gate_norm" else blk[name]
            parts.setdefault(name, []).append(
                (C._expanded_block(t, spec, model.mesh), spec))
            owned.setdefault(name, []).extend(
                np.asarray(spec.stored(model.mesh))[
                    S.owned_columns(spec, model.mesh).numpy()].tolist())
        cache = model.cache_shapes(2, 8)
        whole_cache = {k: sh for k, (sh, _) in Model(
            cfg, device="meta").cache_shapes(2, 8).items()}
        lay = S.cache_layouts(cfg, whole_cache, ShapeSpec("d", 8, 2,
                                                          "decode"),
                              model.mesh)
        for k in ("conv", "ssm"):
            assert S.local_shape(whole_cache[k], lay[k], model.mesh) == \
                cache[k][0], k
        assert cache["conv"][0][-1] == len(conv)
        assert cache["ssm"][0][-3] == len(hs)
    for name, blocks in parts.items():
        spec = blocks[0][1]
        got = _whole_columns(torch.cat([b for b, _ in blocks], spec.dim),
                             spec)
        w = p["gate_norm"]["scale"] if name == "gate_norm" else p[name]
        assert torch.equal(got, w), name
        assert sorted(owned[name]) == list(range(w.shape[spec.dim])), name
    full = get_config("mamba2-2.7b")
    idx = S.head_split_index(full, 3, "inner")
    per = len(idx) // 3
    assert [sum(u >= 0 for u in idx[c * per:(c + 1) * per])
            for c in range(3)] == [1664, 1728, 1728]


def _covers_once(shape, spec, mesh):
    """Whether the blocks of ``spec`` (a leaf of ``shape``) hold every unit
    once over the ranks that differ on the axes it splits: each axis on
    one dim of the layer (never on a layer stack), each rank's block of
    whole units (``local_shape``), and a :class:`HeadSplit`'s units each
    owned by one rank (``owned_columns``: a replicated unit at its first
    copy only)."""
    ndim = len(shape)
    assert not any(C._as_tuple(e) for e in tuple(spec)[:len(spec) - ndim])
    used = [a for e in C._entries(spec, ndim) for a in e]
    assert len(used) == len(set(used)), spec
    for rank in range(mesh.size):
        S.local_shape(shape, spec, Mesh(mesh.axis_names, mesh.shape,
                                        coords=mesh.coords_of(rank)))
    if not isinstance(spec, C.HeadSplit):
        return True
    owned = []
    for c in range(mesh.sizes["model"]):
        at = Mesh(mesh.axis_names, mesh.shape, coords=tuple(
            c if a == "model" else 0 for a in mesh.axis_names))
        lo, hi = spec.block(at)
        units = spec.index_array[lo:hi]
        owned.append(units[units >= 0][S.owned_columns(spec, at).numpy()])
    counts = np.bincount(np.concatenate(owned), minlength=shape[spec.dim])
    return len(counts) == shape[spec.dim] and bool((counts == 1).all())


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_every_model_axis_constructs_and_covers_each_leaf_once(arch):
    """On the meta device, ``arch`` at full size on (data 1 or 2) x
    (model 1..16), an MoE also with its experts padded to 48 (the
    reference's ``pad_experts_to``, as the production meshes' test):
    ``Model``
    constructs, accepts its ``serving`` and ``train`` layouts
    (``_check_layout``), each of whose leaves the ranks hold once
    (:func:`_covers_once`), and ``dryrun._refusal`` is '' for every
    supported cell.  Before the port spread SSM heads and experts over
    the ranks as evenly as they go, mamba2 and jamba raised on every
    ``model`` axis their heads do not divide (3, 6, 7, 9, ...)."""
    from repro_torch.models.config import SHAPES as PSHAPES
    from repro_torch.models.config import cell_is_supported
    cfg = get_config(arch)
    shapes = [s for s in PSHAPES.values() if cell_is_supported(cfg, s)[0]]
    for d in (1, 2):
        for m in range(1, 17):
            mesh = Mesh(("data", "model"), (d, m))
            for pad in ((0, 48) if cfg.has_moe else (0,)):
                model = Model(cfg, mesh=mesh, pad_experts_to=pad,
                              device="meta")
                whole = model._whole_shapes()
                for mode in ("serving", "train"):
                    model._check_layout(mode)
                    specs, done = model.layouts(mode), set()
                    for path, leaf in U.tree_leaves(whole):
                        spec = S.spec_at(specs, path)
                        if (id(spec), tuple(leaf.shape)) in done:
                            continue
                        done.add((id(spec), tuple(leaf.shape)))
                        assert _covers_once(tuple(leaf.shape), spec,
                                            mesh), (d, m, pad, mode, path)
                for shape in shapes:
                    assert dryrun._refusal(cfg, shape, mesh,
                                           {"pad_experts_to": pad}) == "", \
                        (d, m, pad, shape.name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_rmsnorm_twins_match_the_whole_row_and_jax(dtype):
    """The split-row entries' plain twins over two ranks' halves of each
    row (their sums of squares added, then each half scaled), laid side by
    side, against the whole-row norm and the JAX ``apply_norm``; on the
    CPU the wrappers take the twins, count no launch, and refuse a raw
    call under grad."""
    import jax.numpy as jnp
    from repro.models import layers as JL
    from repro_torch.kernels import fused_rmsnorm as K
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((7, 96)).astype(
        np.float32)).to(tdt)
    scale = torch.from_numpy(rng.standard_normal(96).astype(np.float32))
    halves = (slice(0, 48), slice(48, 96))
    n0 = (K.rmsnorm_sumsq.launches, K.rmsnorm_apply.launches)
    total = sum(K.rmsnorm_sumsq(x[:, h].contiguous()) for h in halves)
    got = torch.cat([K.rmsnorm_apply(x[:, h].contiguous(), total, scale[h],
                                     96) for h in halves], dim=-1)
    assert (K.rmsnorm_sumsq.launches, K.rmsnorm_apply.launches) == n0
    assert got.dtype == tdt
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    torch.testing.assert_close(got.float(), K.rmsnorm_ref(x, scale).float(),
                               atol=tol, rtol=0)
    jcfg = jax_smoke("mamba2-2.7b")
    want = np.asarray(JL.apply_norm(
        jcfg, {"scale": jnp.asarray(scale.numpy())},
        jnp.asarray(x.float().numpy()).astype(dtype))).astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2e-5 if dtype == "float32" else 2 ** -7,
                               rtol=0)
    with pytest.raises(RuntimeError, match="requires grad"):
        K.rmsnorm_sumsq(x.float().requires_grad_(True))
    with pytest.raises(RuntimeError, match="requires grad"):
        K.rmsnorm_apply(x.float(), total, scale.requires_grad_(True), 96)


def test_one_rank_entry_points_raise_on_a_mesh():
    cfg = _smoke("granite-3-8b")
    m = Model(cfg, mesh=Mesh(("data", "model"), (1, 2)), device="cpu")
    for name in ("paged_prefill_chunk", "paged_decode_step",
                 "paged_decode_verify", "prefill_chunk", "prefill_pack",
                 "paged_prefill_pack", "decode_verify"):
        with pytest.raises(ValueError, match="does not run sharded"):
            getattr(m, name)(None, None, None, None, None, None, None)


def test_the_mesh_sets_the_expert_share():
    """The rank's ``model`` coordinate sets its part of the experts; an
    explicit share (a card-fitting cut) is split further over ``model``,
    and one that does not split raises."""
    cfg = _smoke("granite-moe-3b-a800m")
    E = cfg.num_experts
    m = Model(cfg, mesh=Mesh(("data", "model"), (1, 2), coords=(0, 1)),
              device="cpu")
    assert m.experts == (E // 2, E)
    m = Model(cfg, mesh=Mesh(("data", "model"), (1, 2), coords=(0, 1)),
              expert_shard=(0, 2), device="cpu")
    assert (m.share, m.experts) == ((0, E // 2), (E // 4, E // 2))
    with pytest.raises(ValueError, match="does not split"):
        Model(cfg, mesh=Mesh(("data", "model"), (1, 2)),
              expert_shard=(0, E), device="cpu")


@pytest.mark.parametrize("groups", [2, 4])
def test_moe_groups_that_do_not_tile_the_batch_ranks_raise(groups):
    """On 3 batch ranks, 2 or 4 dispatch groups neither cover whole ranks
    nor split into whole ranks: the whole batch's dispatch cannot be
    kept, so the MoE refuses (before any collective)."""
    from repro_torch.distributed.ctx import mesh_context
    from repro_torch.models import layers as L
    cfg = _smoke("granite-moe-3b-a800m")
    p = L.init_moe(cfg, torch.Generator().manual_seed(0), torch.float32)
    x = torch.zeros((4, 3, cfg.d_model))
    with mesh_context(Mesh(("data", "model"), (3, 1))):
        with pytest.raises(ValueError, match="neither divides"):
            L.apply_moe(cfg, p, x, groups=groups)


def _ref_bytes(jcfg, shp, names, shape, mode):
    """Per-rank param (+ cache) bytes summed over the reference's
    sanitized specs."""
    jmesh = _RefMesh(names, shape)
    sizes = dict(zip(names, shape))
    jm = JaxModel(jcfg)
    pshape = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))

    def total(shapes, specs):
        n = 0
        for k, leaf in shapes.items():
            loc = [d // math.prod(sizes[a] for a in
                                  ((e,) if isinstance(e, str) else e or ()))
                   for d, e in zip(leaf.shape, specs[k])]
            n += math.prod(loc) * leaf.dtype.itemsize
        return n
    p = total(_ref_leaves(pshape), _ref_leaves(JS.sanitize_specs(
        pshape, JS.param_specs(jcfg, pshape, mode), jmesh)))
    cache = jm.input_specs(shp)["cache"]
    c = total(cache, JS.sanitize_specs(cache, JS.cache_specs(jcfg, shp,
                                                             jmesh), jmesh))
    return p, c


def test_dryrun_decode_cell_on_the_production_and_a_small_mesh():
    """On 16x16 granite's 8 KV heads sit one a rank, each on two ranks:
    a rank's ``wk`` and ``wv`` hold a whole head (128 columns, where the
    spec's block is 64) and its cache its head's positions whole (where
    the spec splits them over ``model``); the spec's bytes stand beside
    them.  On 2x4 the blocks are the spec's."""
    jcfg = jax_config("granite-3-8b")
    shp = SHAPES["decode_32k"]
    rec = dryrun.dry_cell("granite-3-8b", "decode_32k",
                          make_production_mesh(multi_pod=False))
    p, c = _ref_bytes(jcfg, shp, ("data", "model"), (16, 16), "serving")
    mem = rec["memory"]
    assert (mem["spec_param_bytes"], mem["spec_cache_bytes"]) == (p, c)
    L, D, hd = jcfg.num_layers, jcfg.d_model, jcfg.hd
    assert mem["param_bytes"] == p + 2 * L * D * (hd - hd // 2) * 2
    B = shp.global_batch // 16
    assert mem["cache_bytes"] == 2 * L * B * shp.seq_len * hd * 2 + B * 4
    assert rec["collectives"]["counts"]["all-reduce"] >= 2 * L
    assert rec["collectives_reason"] is None
    assert rec["roofline"]["dominant"] in ("compute", "memory")
    assert rec["device"].startswith("NVIDIA H100")
    rec = dryrun.dry_cell("granite-3-8b", "decode_32k",
                          Mesh(("data", "model"), (2, 4)))
    p, c = _ref_bytes(jcfg, shp, ("data", "model"), (2, 4), "serving")
    assert (rec["memory"]["param_bytes"], rec["memory"]["cache_bytes"]) \
        == (p, c)
    coll = rec["collectives"]
    # each layer's two row-parallel all-reduces, and the head's
    assert coll["counts"]["all-reduce"] >= 2 * jcfg.num_layers
    assert coll["per_kind_bytes"]["all-reduce"] > 0
    assert coll["per_device_bytes"] == sum(coll["per_kind_bytes"].values())


def test_dryrun_records_collectives_of_the_families():
    """mamba2-2.7b's and seamless-m4t-large-v2's decode cells record
    collectives on the production meshes (each Mamba layer's
    ``out_proj`` all-reduce and its gated norm's sum of squares;
    seamless's self- and cross-attention and FFN all-reduces), with
    mamba's per-rank bytes by the port's blocks beside the spec's;
    jamba-1.5-large-398b's too (its 8 KV heads one a rank on the 16-way
    ``model`` axis, its 16 experts one a rank), with its bytes beside
    the spec's."""
    single = make_production_mesh(multi_pod=False)
    rec = dryrun.dry_cell("mamba2-2.7b", "decode_32k", single)
    cfg = get_config("mamba2-2.7b")
    coll = rec["collectives"]
    assert coll["counts"]["all-reduce"] >= 2 * cfg.num_layers
    assert coll["per_device_bytes"] > 0
    mem = rec["memory"]
    assert mem["param_bytes"] > mem["spec_param_bytes"] > 0
    assert mem["cache_bytes"] > mem["spec_cache_bytes"] > 0
    rec = dryrun.dry_cell("seamless-m4t-large-v2", "decode_32k",
                          make_production_mesh(multi_pod=True))
    scfg = get_config("seamless-m4t-large-v2")
    assert rec["collectives"]["counts"]["all-reduce"] >= 3 * scfg.num_layers
    assert "spec_param_bytes" not in rec["memory"]
    rec = dryrun.dry_cell("jamba-1.5-large-398b", "decode_32k", single)
    jcfg = get_config("jamba-1.5-large-398b")
    assert rec["collectives"]["counts"]["all-reduce"] >= 2 * jcfg.num_layers
    mem = rec["memory"]
    assert mem["param_bytes"] > mem["spec_param_bytes"] > 0
    assert mem["cache_bytes"] > mem["spec_cache_bytes"] > 0


def test_no_supported_cell_of_the_production_meshes_is_refused():
    """``dryrun._refusal`` is '' for every supported (config x shape)
    cell of both production meshes, and ``Model`` constructs there (with
    the reference's ``pad_experts_to`` option too); and on a ``model``
    axis of 3, which mamba2's 80 SSM heads do not divide (refused until
    the port spread them as 26, 27, 27)."""
    from repro_torch.models.config import SHAPES as PSHAPES
    from repro_torch.models.config import cell_is_supported
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for arch in ASSIGNED_ARCHS:
            cfg = get_config(arch)
            Model(cfg, mesh=mesh, device="meta")
            if cfg.has_moe:
                Model(cfg, mesh=mesh, pad_experts_to=48, device="meta")
            for name, shape in PSHAPES.items():
                if cell_is_supported(cfg, shape)[0]:
                    assert dryrun._refusal(cfg, shape, mesh, {}) == "", \
                        (arch, name)
    reason = dryrun._refusal(get_config("mamba2-2.7b"), PSHAPES["decode_32k"],
                             Mesh(("data", "model"), (1, 3)), {})
    assert reason == ""
    rec = dryrun.dry_cell("granite-moe-3b-a800m", "decode_32k",
                          make_production_mesh(multi_pod=False),
                          opt={"pad_experts_to": 48})
    assert rec["collectives"]["counts"]["all-reduce"] > 0


def test_dryrun_cell_of_uneven_ssm_heads_records_each_rank():
    """mamba2-2.7b's decode cell on (data 1, model 3), whose 80 SSM heads
    lie 26, 27, 27: the rank's step runs and records collectives, and the
    record gives each ``model`` rank's bytes (rank 0's fewer, its heads'
    blocks and state), the largest its total."""
    rec = dryrun.dry_cell("mamba2-2.7b", "decode_32k",
                          Mesh(("data", "model"), (1, 3)))
    assert rec["collectives_reason"] is None
    cfg = get_config("mamba2-2.7b")
    assert rec["collectives"]["counts"]["all-reduce"] >= 2 * cfg.num_layers
    ranks = rec["memory"]["rank_bytes"]
    assert len(ranks) == 3 and ranks[0] < ranks[1] == ranks[2]
    assert rec["memory"]["total_bytes"] == ranks[1]


def test_ssd_plan_covers_odd_head_counts():
    """The SSD kernel's y blocks for a rank's odd head counts (mamba2's 26
    and 27 of 80 on 3 ranks; jamba's 43 of 128, split into 86 heads of
    64): each (b, c, q tile)'s groups cover its heads once, none past the
    kernel's group size."""
    from repro_torch.kernels.ssd_scan import plan
    for H in (26, 27, 86):
        blocks = plan.y_blocks(4, 256, H)
        for bc in range(4):
            for qt in range(plan.q_tiles(256)):
                groups = sorted((h0, h1) for b, q, h0, h1 in blocks
                                if (b, q) == (bc, qt))
                assert groups[0][0] == 0 and groups[-1][1] == H
                assert all(a[1] == b[0] for a, b in zip(groups, groups[1:]))
                assert all(0 < h1 - h0 <= plan.MAX_GROUP
                           for h0, h1 in groups)


def test_dryrun_cli_writes_records(tmp_path):
    out = tmp_path / "dry.jsonl"
    dryrun.main(["--arch", "granite-3-8b", "--mesh", "single", "--out",
                 str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["shape"] for r in recs] == list(SHAPES)
    for r in recs:
        if r.get("skipped"):
            assert r["shape"] == "long_500k"
            continue
        assert r["mesh"] == "16x16" and r["chips"] == 256
        assert r["memory"]["total_bytes"] > 0
        assert r["memory"]["spec_param_bytes"] > 0
        assert r["collectives"]["per_device_bytes"] > 0
        assert r["collectives_reason"] is None
        assert r["roofline"]["bound_s"] > 0
    dryrun.main(["--arch", "granite-3-8b", "--mesh", "single", "--out",
                 str(out)])               # resumes: nothing new
    assert len(out.read_text().splitlines()) == len(recs)


def test_tokenizer_copy():
    text = "naïve café, 東京 ✓"
    assert T.encode(text) == JT.encode(text)
    assert T.encode(text, add_bos=False) == JT.encode(text, add_bos=False)
    toks = T.encode(text) + [T.EOS, T.PAD, 300]
    assert T.decode(toks) == JT.decode(toks) == text
    assert (T.BOS, T.EOS, T.PAD, T.VOCAB_SIZE) == \
        (JT.BOS, JT.EOS, JT.PAD, JT.VOCAB_SIZE)


def test_utils_copies():
    rng = np.random.default_rng(0)
    arrays = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": [rng.standard_normal(5).astype(np.float32),
                    rng.integers(0, 9, (2, 2)).astype(np.int32)]}
    tt = U.tree_map(torch.from_numpy, arrays)
    jt = jax.tree_util.tree_map(jax.numpy.asarray, arrays)
    assert U.tree_size_bytes(tt) == JU.tree_size_bytes(jt)
    assert U.tree_param_count(tt) == JU.tree_param_count(jt)
    for n in (0, 1023, 1024, 5.5e6, 3e9, 7e12, 2e16):
        assert U.human_bytes(n) == JU.human_bytes(n)
    U.assert_no_nans(tt)
    arrays["b"][0][2] = np.nan
    tt = U.tree_map(torch.from_numpy, arrays)
    with pytest.raises(AssertionError) as mine:
        U.assert_no_nans(tt, "here")
    with pytest.raises(AssertionError) as theirs:
        JU.assert_no_nans(jax.tree_util.tree_map(jax.numpy.asarray, arrays),
                          "here")
    assert str(mine.value) == str(theirs.value)
