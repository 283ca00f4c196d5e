"""Sharding rules: map every param/input/cache leaf to a partition spec,
the torch twin of ``repro.distributed.sharding`` (its rules copied with
their behaviour unchanged).

Two modes:
  * ``serving``  — Megatron-style TP over the ``model`` axis only (weights
    replicated across ``data``/``pod``), batch over (pod, data);
  * ``train``    — FSDP x TP: each weight's natural TP dim goes to ``model``
    and its largest remaining dim to ``data`` (ZeRO-3-style fully sharded;
    optimizer moments share the param spec).

MoE experts shard over ``model`` (EP).

A spec is a tuple with one entry per dimension: ``None``, an axis name or
a tuple of names.  The reference stacks the layers of a stack on a
leading axis (a hybrid's on two: group and layer); the port holds a list
of per-layer dicts.  So the port's spec of a per-layer leaf is the
reference's spec of the stacked leaf it belongs to, computed on the
stacked shape (:func:`ref_leaf`), leading stack entries included; a rank
holds a layer's block by the entries of the leaf's own dims
(:func:`shard_leaf` refuses a spec that splits the stack itself).

Where the reference's rules let GSPMD cut a leaf anywhere and reshard
after, the port executes blocks that follow the computation: a Mamba-2
layer's ``model`` rank holds whole heads, ``even_blocks(H, m)`` of them
(26, 27 and 27 of mamba2's 80 on 3 ranks).  ``in_proj`` packs the
columns z, x, B, C and dt (D, 2 di + 2 N + H), so a contiguous block of
them (the spec's) mixes all five; the port's rank holds z and x of its
heads, B and C whole (one group: they feed every head, as in Mamba's own
tensor parallelism) and dt of its heads; the same channels of
``conv_w``/``conv_b`` and of the ``conv`` cache; its heads of
``A_log``/``D_skip``/``dt_bias`` (replicated in the spec) and of the
``ssm`` cache; its heads' rows of ``out_proj`` and columns of the gated
norm's ``scale``.  :func:`param_layouts` and :func:`cache_layouts` give
these leaves a :class:`~repro_torch.distributed.ctx.HeadSplit` spec in
place of the reference's, whatever the sanitized spec kept of ``model``
(where it does not divide a dim it re-homes or drops the axis).  Where
the ``model`` axis does not split the attention heads evenly (the
reference's spec splits inside a head, or re-homes the axis, and GSPMD
pads), :func:`head_layout` gives every rank the same query and KV head
slots: KV heads replicated on several ranks, or padded with zero heads;
an uneven ``d_ff``, expert count or SSM head count spreads over the ranks
as evenly as it goes (:func:`even_blocks`; a rank past the last expert
holds none).  Those leaves, and the cache's ``k``/``v``, take a
:class:`HeadSplit` with padding slots; every other leaf keeps the
sanitized spec.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.ctx import (HeadSplit, Mesh, Spec, _as_tuple,
                                        _entries, block_region,
                                        expanded_shape, take_units)
from repro_torch.models.config import ArchConfig, ShapeSpec

# the reference's hybrid group layout (repro_torch.models.model's
# HYBRID_ORDER; repeated here so that the rules import no model code)
_HYBRID_ORDER = [("sd", 0), ("sm", 0), ("sd", 1), ("am", 0),
                 ("sd", 2), ("sm", 1), ("sd", 3), ("sm", 2)]
_HYBRID_STACK = {"sd": 4, "sm": 3}


def _mesh_sizes(mesh) -> Dict[str, int]:
    """Axis sizes of a port :class:`Mesh` or of anything with
    ``axis_names`` and ``devices.shape`` (the reference's reading)."""
    if isinstance(mesh, Mesh):
        return mesh.sizes
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _batch_axes(mesh):
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return axes if axes else None


def _pad(spec_tail, ndim) -> Spec:
    """Left-pad a trailing spec with None for leading stack dims."""
    return tuple([None] * (ndim - len(spec_tail)) + list(spec_tail))


def param_partition_spec(cfg: ArchConfig, path: str, shape: tuple,
                         mode: str) -> Spec:
    """Spec for one parameter leaf.  `path` is the '/'-joined key path."""
    name = path.split("/")[-1]
    nd = len(shape)
    train = mode == "train"
    E = cfg.num_experts

    def tp_last():                      # (.., D, F) -> F on model, D on data
        return _pad(["data" if train else None, "model"], nd)

    def tp_penult():                    # (.., F, D) -> F on model, D on data
        return _pad(["model", "data" if train else None], nd)

    if name == "embed":
        return ("model", "data" if train else None)
    if name == "lm_head":
        return ("data" if train else None, "model")
    if name in ("wq", "wk", "wv"):
        return tp_last()
    if name in ("bq", "bk", "bv"):
        return _pad(["model"], nd)
    if name in ("wi", "wg"):
        if nd >= 3 and shape[-3] == E and shape[-1] == cfg.d_ff:
            return _pad(["model", "data" if train else None, None], nd)  # MoE EP
        return tp_last()
    if name == "wo":
        if nd >= 3 and shape[-3] == E and shape[-2] == cfg.d_ff:
            return _pad(["model", None, "data" if train else None], nd)  # MoE EP
        return tp_penult()
    if name == "router":
        return _pad([None, None], nd)
    if name == "in_proj":
        return tp_last()
    if name == "out_proj":
        return tp_penult()
    if name == "conv_w":
        return _pad([None, "model"], nd)
    if name == "conv_b":
        return _pad(["model"], nd)
    if name in ("A_log", "D_skip", "dt_bias"):
        return _pad([None], nd)
    if name in ("scale", "bias"):       # norms (gate_norm scale is sharded)
        if shape[-1] == cfg.d_inner and cfg.has_ssm:
            return _pad(["model"], nd)
        return _pad([None], nd)
    return tuple([None] * nd)


def ref_leaf(cfg: ArchConfig, path: tuple, shape) -> Tuple[str, tuple]:
    """The reference's '/'-joined path and stacked shape of the port's
    leaf at ``path`` (a tuple of keys and list indices) of ``shape``:
    ``("layers", i, "attn", "wq")`` is ``layers/attn/wq`` of (L, *shape);
    a hybrid's layer ``8 g + j`` sits in stack ``sd`` (g, 4, ...), ``sm``
    (g, 3, ...) or ``am`` (g, ...) as ``params_from_numpy`` maps it."""
    shape = tuple(shape)
    if path and path[0] in ("layers", "encoder", "cross"):
        rest = "/".join(str(p) for p in path[2:])
        if path[0] == "layers" and cfg.family == "hybrid":
            stack = _HYBRID_ORDER[path[1] % len(_HYBRID_ORDER)][0]
            g = cfg.num_layers // len(_HYBRID_ORDER)
            lead = (g, _HYBRID_STACK[stack]) if stack in _HYBRID_STACK \
                else (g,)
            return f"layers/{stack}/{rest}", lead + shape
        n = cfg.num_encoder_layers if path[0] == "encoder" \
            else cfg.num_layers
        return f"{path[0]}/{rest}", (n,) + shape
    return "/".join(str(p) for p in path), shape


def param_specs(cfg: ArchConfig, params, mode: str):
    """Spec tree matching the port's params tree (tensors or anything with
    ``.shape``): each leaf's reference spec on its stacked shape."""
    def visit(path, leaf):
        ref_path, shape = ref_leaf(cfg, path, leaf.shape)
        return param_partition_spec(cfg, ref_path, shape, mode)
    return map_with_path(visit, params)


def sanitized_param_specs(cfg: ArchConfig, params, mode: str, mesh):
    """:func:`param_specs` repaired by :func:`sanitize_spec` on each
    leaf's stacked shape, as the reference's ``sanitize_specs`` does (once
    for each stacked leaf: its layers share it)."""
    done = {}

    def visit(path, leaf):
        key = ref_leaf(cfg, path, leaf.shape)
        if key not in done:
            ref_path, shape = key
            done[key] = sanitize_spec(shape, param_partition_spec(
                cfg, ref_path, shape, mode), mesh)
        return done[key]
    return map_with_path(visit, params)


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists, the same
    structure out (a path as :func:`repro_torch.utils.tree_leaves` gives
    it)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def batch_specs(cfg: ArchConfig, shape: ShapeSpec, mesh) -> Dict[str, Spec]:
    """Input specs for train/prefill batches."""
    b = _batch_axes(mesh)
    specs: Dict[str, Spec] = {}
    if shape.kind == "train":
        specs["targets"] = (b, None)
        if cfg.input_mode == "embeds" and not cfg.is_encoder_decoder:
            specs["embeds"] = (b, None, None)
        else:
            specs["tokens"] = (b, None)
        if cfg.is_encoder_decoder:
            specs["enc_embeds"] = (b, None, None)
    elif shape.kind == "prefill":
        if cfg.is_encoder_decoder:
            specs["enc_embeds"] = (b, None, None)
            specs["tokens"] = (b, None)
        elif cfg.input_mode == "embeds":
            specs["embeds"] = (b, None, None)
        else:
            specs["tokens"] = (b, None)
    else:
        specs["tokens"] = (b, None)
    return specs


def cache_specs(cfg: ArchConfig, shape: ShapeSpec, mesh) -> Dict[str, Spec]:
    """Decode-cache specs.  batch over (pod,data); kv heads over model.
    For global_batch=1 (long_500k) the KV sequence dim shards over data
    instead (flash-decoding-style context split)."""
    b = _batch_axes(mesh)
    B = shape.global_batch
    seq_shard = B == 1
    bb = None if seq_shard else b
    sd = "data" if (seq_shard and "data" in mesh.axis_names) else None
    specs: Dict[str, Spec] = {"lengths": (bb,)}
    if cfg.family == "ssm":
        specs["conv"] = (None, bb, None, "model")
        specs["ssm"] = (None, bb, "model", None, None)
    elif cfg.family == "hybrid":
        specs["k"] = (None, bb, sd, "model", None)
        specs["v"] = (None, bb, sd, "model", None)
        specs["conv"] = (None, None, bb, None, "model")
        specs["ssm"] = (None, None, bb, "model", None, None)
    else:
        specs["k"] = (None, bb, sd, "model", None)
        specs["v"] = (None, bb, sd, "model", None)
        if cfg.is_encoder_decoder:
            specs["xk"] = (None, bb, None, "model", None)
            specs["xv"] = (None, bb, None, "model", None)
    return specs


def _astuple(a):
    if a is None:
        return ()
    return tuple(a) if isinstance(a, (tuple, list)) else (a,)


def sanitize_spec(shape: tuple, spec: Spec, mesh) -> Spec:
    """Repair a spec for jit-boundary divisibility.

    GSPMD pads *internal* ops but jit inputs must divide evenly.  Axes that
    don't divide their dim are re-homed onto the largest dim where they do
    (e.g. kv_heads=8 on a 16-way ``model`` axis falls through to the KV
    *sequence* dim -> flash-decoding-style context sharding; a non-multiple
    vocab moves its axis to d_model).  Axes that fit nowhere are dropped
    (replicated).
    """
    sizes = _mesh_sizes(mesh)
    dims = [list(_astuple(spec[i])) if i < len(spec) else []
            for i in range(len(shape))]
    orphans = []
    for i, axes in enumerate(dims):
        keep = []
        for ax in axes:
            factor = int(np.prod([sizes[a] for a in keep + [ax]]))
            if shape[i] % factor == 0:
                keep.append(ax)
            else:
                orphans.append(ax)
        dims[i] = keep
    for ax in orphans:
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in order:
            factor = int(np.prod([sizes[a] for a in dims[i] + [ax]]))
            if shape[i] >= factor and shape[i] % factor == 0:
                dims[i].append(ax)
                break
    return tuple(tuple(d) if len(d) > 1 else (d[0] if d else None)
                 for d in dims)


def sanitize_specs(shape_tree, spec_tree, mesh):
    """Tree-wide sanitize over dicts of shapes (tuples) and specs."""
    return {k: sanitize_spec(tuple(shape_tree[k]), spec_tree[k], mesh)
            for k in spec_tree if k in shape_tree}


# ------------------------------------------------------------ rank blocks

# --------------------------------------------------- the port's Mamba blocks

# the Mamba leaves the port holds by heads: the kind of their split dim
# (:func:`head_split_index`) and the dim.  The packed projection, the
# conv's channels, one entry per head, and the heads' ``d_inner`` columns
# (``out_proj``'s rows, the gated norm's columns)
MAMBA_LEAVES = {"in_proj": ("proj", -1), "conv_w": ("conv", -1),
                "conv_b": ("conv", -1), "A_log": ("head", -1),
                "D_skip": ("head", -1), "dt_bias": ("head", -1),
                "out_proj": ("inner", -2)}


def head_split_index(cfg: ArchConfig, m: int, kind: str) -> np.ndarray:
    """The whole leaf's column at each position of the expanded split dim
    of a Mamba leaf of ``kind`` (``proj``: in_proj's z, x, B, C, dt;
    ``conv``: x, B, C; ``head``: one per head; ``inner``: the ``d_inner``
    columns of its heads) on a ``model`` axis of ``m``: rank by rank, its
    heads (:func:`even_blocks`, padded to ``ceil(H / m)`` slots, -1 a
    padding slot) in z and x, B and C whole, its heads in dt."""
    di, N, H, P = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                   cfg.ssm_headdim)
    blocks, slots = even_blocks(H, m), -(-H // m)
    bc = np.arange(2 * N)

    def shift(index, by):                # padding slots stay -1
        return np.where(index >= 0, index + by, -1)
    out = []
    for hs in blocks:
        cols = unit_index([hs], slots, P)
        heads = unit_index([hs], slots)
        if kind == "proj":
            out += [cols, shift(cols, di), bc + 2 * di,
                    shift(heads, 2 * di + 2 * N)]
        elif kind == "conv":
            out += [cols, bc + di]
        else:
            out.append(cols if kind == "inner" else heads)
    return np.concatenate(out)


def _head_split(cfg: ArchConfig, kind: str, spec: Spec, mesh: Mesh,
                dim: int = -1):
    """``spec`` (sanitized, on the stacked leaf) as the port's
    :class:`HeadSplit` of a Mamba leaf of ``kind`` over its dim ``dim``,
    ``model`` taken off every other dim; the spec itself where the
    ``model`` axis has one rank."""
    m = mesh.sizes.get("model", 1)
    if m == 1:
        return tuple(spec)
    return _split_on(tuple(spec), dim, head_split_index(cfg, m, kind))


# ----------------------------------------- heads, d_ff and experts padded

class HeadLayout(NamedTuple):
    """The attention heads a ``model`` rank holds (:func:`head_layout`):
    ``q_slots`` query and ``kv_slots`` KV head slots a rank (real heads
    first, then zero padding), each KV head on ``rep`` ranks, and per rank
    its real ``(query heads, KV heads)``."""
    q_slots: int
    kv_slots: int
    rep: int
    blocks: list


def head_layout(cfg: ArchConfig, m: int) -> HeadLayout:
    """The heads of ``cfg`` on a ``model`` axis of ``m``, every rank with
    the same slots and the same group size.  KVH' is the smallest count
    at or above KVH that ``m`` divides or that divides ``m``.  With KVH'
    >= m a rank holds KVH'/m KV head slots, its real KV heads
    ``[c KVH/m, (c+1) KVH/m)`` and the G query heads of each.  With KVH'
    < m each KV head is replicated on r = m/KVH' ranks, and its G query
    heads spread over them, ``ceil(G/r)`` slots a rank (G' = r ceil(G/r)
    padded).  A padding slot is a zero head."""
    H, KVH = cfg.num_heads, cfg.num_kv_heads
    G = H // KVH
    kvp = next(k for k in itertools.count(KVH) if k % m == 0 or m % k == 0)
    if kvp >= m:
        blocks = []
        for c in range(m):
            kv = list(range(c * KVH // m, (c + 1) * KVH // m))
            blocks.append(([h * G + g for h in kv for g in range(G)], kv))
        return HeadLayout(G * kvp // m, kvp // m, 1, blocks)
    r = m // kvp
    blocks = []
    for c in range(m):
        j, s = divmod(c, r)
        blocks.append(([j * G + g for g in range(s * G // r,
                                                 (s + 1) * G // r)], [j])
                      if j < KVH else ([], []))
    return HeadLayout(-(-G // r), 1, r, blocks)


def even_blocks(n: int, m: int) -> list:
    """``n`` units over ``m`` ranks as evenly as they go: rank ``c`` holds
    ``[c n/m, (c+1) n/m)``."""
    return [list(range(c * n // m, (c + 1) * n // m)) for c in range(m)]


def unit_index(blocks, slots: int, unit: int = 1) -> np.ndarray:
    """The expanded index of ranks holding ``blocks`` (each rank's units,
    padded to ``slots``), each unit ``unit`` columns wide."""
    out = np.full((len(blocks), slots, unit), -1, dtype=np.int64)
    for r, units in enumerate(blocks):
        units = np.asarray(units, dtype=np.int64)
        out[r, :len(units)] = units[:, None] * unit + np.arange(unit)
    return out.reshape(-1)


# the attention leaves held by heads: which heads, and the dim they lie on
_ATTN_UNITS = {"wq": ("q", -1), "bq": ("q", -1), "wo": ("q", -2),
               "wk": ("kv", -1), "bk": ("kv", -1), "wv": ("kv", -1),
               "bv": ("kv", -1)}
_FFN_DIM = {"wi": -1, "wg": -1, "wo": -2}


def _split_on(spec: Spec, dim: int, index, holds_pads: bool = False
              ) -> HeadSplit:
    """``spec`` with ``model`` taken off every dim and put on ``dim`` alone,
    as the :class:`HeadSplit` of ``index``."""
    dims = [tuple(a for a in _as_tuple(e) if a != "model") for e in spec]
    dims[dim] = ("model",)
    return HeadSplit(tuple(d[0] if len(d) == 1 else (d or None)
                           for d in dims), index, dim, holds_pads)


def _unit_split(cfg: ArchConfig, path: tuple, leaf, params, m: int):
    """``(dim, index)`` of a leaf the port holds by whole units on a
    ``model`` axis of ``m`` where the axis does not split them evenly:
    attention heads (:func:`head_layout`), a dense FFN's ``d_ff`` and an
    MoE's experts (each padded to a multiple of ``m``,
    :func:`even_blocks`; experts padded by ``pad_experts_to`` always);
    None for any other leaf."""
    name, parent = path[-1], (path[-2] if len(path) >= 2 else None)
    if parent in ("attn", "xattn") and name in _ATTN_UNITS and \
            cfg.num_kv_heads % m:
        lay = head_layout(cfg, m)
        which, dim = _ATTN_UNITS[name]
        i, slots = (0, lay.q_slots) if which == "q" else (1, lay.kv_slots)
        return dim, unit_index([b[i] for b in lay.blocks], slots, cfg.hd)
    if parent == "ffn" and name in _FFN_DIM:
        moe = "router" in spec_at(params, path[:-1])
        dim = -3 if moe else _FFN_DIM[name]
        n = leaf.shape[dim]
        # the reference's MoE rule reads experts by their count, so it
        # takes padding experts (``pad_experts_to``) for a dense FFN's
        if n % m or (moe and n != cfg.num_experts):
            return dim, unit_index(even_blocks(n, m), -(-n // m))
    return None


def param_layouts(cfg: ArchConfig, params, mode: str, mesh: Mesh,
                  specs=None):
    """The spec tree by which the port holds ``params`` (whole leaves or
    anything with ``.shape``) on ``mesh``: ``specs`` (default
    :func:`sanitized_param_specs`), with each Mamba leaf of
    :data:`MAMBA_LEAVES` under a layer's ``ssm`` (and its gated norm) as
    its :class:`HeadSplit`, each attention, dense-FFN and MoE leaf whose
    heads, ``d_ff`` or experts the ``model`` axis does not split evenly as
    the :class:`HeadSplit` of :func:`_unit_split` (the reference's spec
    would split inside a unit or re-home the axis; GSPMD pads), and a spec
    that splits a layer stack replaced by the leaf's own rule sanitized on
    its per-layer shape (the reference's MoE rule, which reads the stacked
    shape, takes a hybrid's stack of 4 dense FFNs for experts when there
    are 4 experts, as in jamba's smoke config, and puts ``model`` on the
    stack; ``sanitize_spec`` re-homes an axis that divides no dim of a
    layer onto a stack, as ``data`` 3 onto jamba's stacks of 3 Mamba
    layers; the port holds every layer on every rank, so such a leaf is
    held as the layer it is, an axis that fits none of its dims dropped).
    The layers of one stack share their specs, so each is worked out
    once."""
    if specs is None:
        specs = sanitized_param_specs(cfg, params, mode, mesh)
    m = mesh.sizes.get("model", 1)
    done = {}

    def visit(path, leaf):
        spec = spec_at(specs, path)
        ref_path, stacked = ref_leaf(cfg, path, leaf.shape)
        moe = "router" in spec_at(params, path[:-1])
        key = (ref_path, stacked, tuple(spec), moe)
        if key not in done:
            done[key] = _layout(cfg, path, leaf, params, spec, mode, mesh, m)
        return done[key]
    return map_with_path(visit, params)


def _layout(cfg, path, leaf, params, spec, mode, mesh, m):
    """One leaf's spec by :func:`param_layouts`."""
    extra = len(spec) - len(leaf.shape)
    if extra > 0 and any(_as_tuple(e) for e in spec[:extra]):
        shape = tuple(leaf.shape)
        own = param_partition_spec(cfg, ref_leaf(cfg, path, shape)[0],
                                   shape, mode)
        spec = (None,) * extra + sanitize_spec(shape, own, mesh)
    split = _unit_split(cfg, path, leaf, params, m) if m > 1 else None
    if split is not None:
        return _split_on(spec, *split)
    if path[-3:-1] == ("ssm", "gate_norm"):
        return _head_split(cfg, "inner", spec, mesh)
    if path[-2:-1] == ("ssm",) and path[-1] in MAMBA_LEAVES:
        kind, dim = MAMBA_LEAVES[path[-1]]
        return _head_split(cfg, kind, spec, mesh, dim)
    return spec


def cache_layouts(cfg: ArchConfig, shapes: Dict[str, tuple],
                  shape: ShapeSpec, mesh) -> Dict[str, Spec]:
    """The sanitized cache specs of a cache of ``shapes`` (whole shapes by
    key) as the port holds it: the ``conv`` state's channels and the
    ``ssm`` state's heads by :func:`_head_split` (a rank's real heads
    only); where the ``model`` axis does not split the KV heads evenly,
    each rank's KV head slots of ``k``/``v`` (and the cross ``xk``/``xv``)
    by :func:`head_layout`, padding slots held as zeros."""
    specs = sanitize_specs(shapes, cache_specs(cfg, shape, mesh), mesh)
    if "conv" in specs:
        specs["conv"] = _head_split(cfg, "conv", specs["conv"], mesh)
        specs["ssm"] = _head_split(cfg, "head", specs["ssm"], mesh, -3)
    m = mesh.sizes.get("model", 1)
    if cfg.family != "ssm" and cfg.num_kv_heads % m:
        lay = head_layout(cfg, m)
        index = unit_index([b[1] for b in lay.blocks], lay.kv_slots)
        for k in ("k", "v", "xk", "xv"):
            if k in specs:
                specs[k] = _split_on(specs[k], -2, index, holds_pads=True)
    return specs


def owned_columns(spec: Spec, mesh: Mesh) -> Optional[torch.Tensor]:
    """The positions along a :class:`HeadSplit` leaf's split dim of this
    rank's stored block whose unit this rank owns: each replicated unit's
    first copy (rank 0's B and C of a Mamba layer, the first of a KV
    head's ranks), so that a sum over the ranks counts every unit once;
    None for any other spec (every position)."""
    if not isinstance(spec, HeadSplit):
        return None
    lo, hi = spec.block(mesh)
    units = spec.index_array[lo:hi]
    stored = np.flatnonzero((units >= 0) | spec.holds_pads)
    return torch.from_numpy(np.flatnonzero(spec.owner[lo + stored] >= 0))


def local_shape(shape, spec: Spec, mesh: Mesh) -> tuple:
    """The shape of one rank's block of a leaf of ``shape`` by ``spec``
    (a stacked spec's leading entries split the leading dims of a stacked
    ``shape``, or are dropped for a per-layer one; a :class:`HeadSplit`
    splits the expanded dim, whose block a parameter's rank stores less
    its padding slots)."""
    sizes = mesh.sizes
    shape = expanded_shape(shape, spec)
    out = []
    for n, axes in zip(shape, _entries(spec, len(shape))):
        parts = math.prod(sizes[a] for a in axes)
        if n % parts:
            raise ValueError(f"dim {n} does not split {parts} ways "
                             f"({spec} on {mesh.describe()})")
        out.append(n // parts)
    if isinstance(spec, HeadSplit):
        out[spec.dim % len(out)] = len(spec.stored(mesh))
    return tuple(out)


def shard_leaf(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the whole leaf ``t`` by ``spec`` (a copy).  A
    per-layer leaf whose stacked spec splits the layer stack raises: the
    port keeps every layer on every rank."""
    extra = len(spec) - t.dim()
    if extra > 0 and any(_as_tuple(e) for e in spec[:extra]):
        raise ValueError(f"spec {spec} splits the layer stack of a leaf "
                         f"of shape {tuple(t.shape)} on {mesh.describe()}")
    if isinstance(spec, HeadSplit):
        t = take_units(t, spec.dim, spec.stored(mesh))
    region = block_region(mesh, tuple(t.shape), tuple(spec), mesh.coords)
    if isinstance(spec, HeadSplit):
        d = spec.dim % t.dim()
        region[d] = (0, t.shape[d])
    return t[tuple(slice(a, b) for a, b in region)].clone()


def shard_params(params, specs, mesh: Mesh):
    """:func:`shard_leaf` over a tree of whole leaves and its spec tree."""
    return zip_map(lambda t, s: shard_leaf(t, s, mesh), params, specs)


def spec_at(specs, path):
    """The spec at ``path`` (a tuple of keys and list indices, as
    :func:`repro_torch.utils.tree_leaves` gives it) of a spec tree."""
    for p in path:
        specs = specs[p]
    return specs


def split_axes(spec: Spec, ndim: int, mesh: Mesh) -> Tuple[str, ...]:
    """The axes of more than one rank that ``spec`` splits a leaf of
    ``ndim`` dims over (its blocks are disjoint over their ranks)."""
    own = _entries(spec, ndim)
    return tuple(a for a in mesh.axis_names
                 if mesh.sizes[a] > 1 and any(a in e for e in own))


def zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of leaves and its spec tree."""
    return map_with_path(lambda path, t: fn(t, spec_at(specs, path)), tree)
