"""Mesh context, logical axes and the port's collectives, the torch twin of
``repro.distributed.ctx``.

A :class:`Mesh` names its axes (``data``, ``model``, with ``pod`` on two
pods) and their sizes, and knows this process's coordinate on each.  A
*real* mesh sits over an initialised ``torch.distributed`` process group
(:func:`repro_torch.launch.mesh.make_test_mesh` builds one with
``init_device_mesh``); a *dry* mesh has sizes and no process group (the
production meshes of the dry run).  Model code names *logical* axes
(``batch``, ``model``, ``expert``, ``seq``, ``fsdp``); the active mesh
resolves them to physical axes (:func:`resolve_axis`, the reference's
map).

The reference's ``shard_hint`` has no counterpart: a rank here already
holds only its rows and its heads, so a layout hint has nothing to do.
In its place this module holds the port's only collectives, each named by
a logical axis and each an autograd Function with the Megatron pairing:

- :func:`reduce_from`: the all-reduce that follows a row-parallel product
  (forward sum, backward identity);
- :func:`copy_to`: the input of a column-parallel product (forward
  identity, backward sum);
- :func:`gather_from` / :func:`split_to`: the all-gather of a split
  activation and its inverse;
- :func:`fsdp_gather`: a parameter's FSDP gather, whose backward is the
  reduce-scatter of its gradient;
- :func:`all_sum`: a sum over ranks whose gradient is a sum too (each
  rank uses the summed statistic for its own columns: the split-row
  RMSNorm's sum of squares);
- :func:`copy_to_replicas`: a block that several ``model`` ranks hold
  alike (a replicated KV head's ``wk``/``wv``), its gradient summed over
  them.

A leaf whose rank block is not one contiguous block of the whole leaf
(Mamba-2's ``in_proj``, whose rank holds its heads' z, x and dt columns and
the B and C columns whole; attention heads, a ``d_ff`` or experts that
``model`` does not split evenly, replicated or padded to equal slots a
rank) has a :class:`HeadSplit` spec: the blocks are contiguous in the leaf
with one dim re-ordered rank by rank, padding slots added.  Inside
:func:`replicated_batch` (the long-context cell, global batch 1) the
collectives named ``batch`` are identities.

Each is the identity outside a mesh (and over axes of size 1), so every
single-device path runs bit for bit as before.  Under a dry mesh each
records its kind and operand bytes in ``mesh.records`` and returns a
tensor of the right shape without communicating.  On a ``gloo`` group a
CUDA tensor is staged through a host copy for every collective, by design
(ranks that share one card cannot use NCCL).
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Logical = Union[None, str, Sequence[str]]
Spec = Tuple            # one entry per dim: None, an axis name or a tuple


class HeadSplit(tuple):
    """A spec over the *expanded* leaf: the whole leaf with its dim ``dim``
    re-ordered (some units repeated, padding slots added) so that each
    rank's block is contiguous; ``index[j]`` is the whole leaf's unit
    (column, row or expert) at expanded position ``j``, -1 a padding slot.
    A unit that appears more than once is replicated (the first copy
    counts as its owner's, :func:`owned_columns`).  A padding slot is a
    zero block: a parameter's rank stores its real units only (its block
    less its padding slots, so ranks may hold different counts), while a
    cache's (``holds_pads``) stores the whole expanded block, its padding
    slots zero.  As a tuple it is the spec's entries on the expanded
    leaf."""

    def __new__(cls, spec, index, dim: int = -1, holds_pads: bool = False):
        obj = super().__new__(cls, spec)
        idx = np.asarray(index, dtype=np.int64).reshape(-1)
        obj.index = tuple(idx.tolist())
        obj.index_array = idx
        obj.dim = dim
        obj.holds_pads = holds_pads
        # the expanded position of each whole unit's first copy (the units
        # are 0 .. width-1)
        at = np.flatnonzero(idx >= 0)
        _, first = np.unique(idx[at], return_index=True)
        obj.first = tuple(at[first].tolist())
        obj.width = len(obj.first)
        # at each expanded position, the unit whose first copy it is, else
        # -1 (:func:`owned_columns`)
        obj.owner = np.full(len(idx), -1, dtype=np.int64)
        obj.owner[at[first]] = idx[at[first]]
        obj._stored = {}
        return obj

    def block(self, mesh: "Mesh", coords=None) -> Tuple[int, int]:
        """``[lo, hi)`` of the expanded positions of the block of the rank
        at ``coords`` (default: this rank)."""
        return block_region(mesh, (len(self.index),), (self[self.dim],),
                            mesh.coords if coords is None else coords)[0]

    def units(self, mesh: "Mesh", coords=None) -> Tuple[int, ...]:
        """The whole units at the expanded positions of the block of the
        rank at ``coords`` (default: this rank), -1 where a slot pads."""
        lo, hi = self.block(mesh, coords)
        return self.index[lo:hi]

    def stored(self, mesh: "Mesh", coords=None) -> Tuple[int, ...]:
        """The whole units a rank stores, in order: its block's real units,
        or with ``holds_pads`` every slot (-1 for a zero one)."""
        lo, hi = self.block(mesh, coords)
        if self.holds_pads:
            return self.index[lo:hi]
        if (lo, hi) not in self._stored:
            units = self.index_array[lo:hi]
            self._stored[lo, hi] = tuple(units[units >= 0].tolist())
        return self._stored[lo, hi]


def expanded_shape(shape, spec) -> tuple:
    """``shape`` of a whole leaf as its spec splits it: the split dim of a
    :class:`HeadSplit` leaf is its expanded width."""
    shape = tuple(shape)
    if isinstance(spec, HeadSplit):
        d = spec.dim % len(shape)
        return shape[:d] + (len(spec.index),) + shape[d + 1:]
    return shape


def _whole_columns(x: torch.Tensor, spec: HeadSplit) -> torch.Tensor:
    """The whole leaf from the expanded one: each unit's first copy."""
    return x.index_select(spec.dim, torch.tensor(spec.first,
                                                 device=x.device))


def take_units(t: torch.Tensor, dim: int, units) -> torch.Tensor:
    """``t``'s units ``units`` along ``dim`` (a copy), a zero block where a
    unit is -1."""
    dim = dim % t.dim()
    real = [j for j, u in enumerate(units) if u >= 0]
    src = t.index_select(dim, torch.tensor([units[j] for j in real],
                                           dtype=torch.long,
                                           device=t.device))
    if len(real) == len(units):
        return src
    shape = list(t.shape)
    shape[dim] = len(units)
    return src.new_zeros(shape).index_copy(
        dim, torch.tensor(real, dtype=torch.long, device=t.device), src)


def _expanded_block(local: torch.Tensor, spec: HeadSplit,
                    mesh: "Mesh") -> torch.Tensor:
    """A rank's stored block of a :class:`HeadSplit` leaf as its whole
    expanded block (its padding slots zero)."""
    if spec.holds_pads:
        return local
    units = spec.units(mesh)
    at = itertools.count()
    return take_units(local, spec.dim, [next(at) if u >= 0 else -1
                                        for u in units])


class Mesh:
    """A mesh of ranks: ``axis_names`` and ``shape`` (their sizes, in
    order), this process's ``coords`` on each axis (global rank = the
    coordinates' mixed radix, the last axis fastest), and for a real mesh
    the ``torch.distributed`` groups of every set of axes (``group(axes)``:
    the ranks that differ only on ``axes``) and the ``DeviceMesh``.  A dry
    mesh (``dry=True``) has no groups; its collectives append
    ``{"kind", "axes", "bytes"}`` to ``records``."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int], *,
                 coords: Optional[Sequence[int]] = None, dry: bool = True,
                 groups: Optional[Dict[frozenset, object]] = None,
                 device_mesh=None, backend: Optional[str] = None):
        if len(axis_names) != len(shape):
            raise ValueError(f"axes {axis_names} and shape {shape} differ")
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(s) for s in shape)
        self.coords = tuple(coords) if coords is not None else \
            (0,) * len(self.shape)
        self.dry = dry
        self.groups = groups or {}
        self.device_mesh = device_mesh
        self.backend = backend
        self.records: List[dict] = []

    # ------------------------------------------------------------- layout
    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def coord(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)] \
            if axis in self.axis_names else 0

    def axis_size(self, axes) -> int:
        sizes = self.sizes
        return math.prod(sizes.get(a, 1) for a in _as_tuple(axes))

    def rank_of(self, coords: Sequence[int]) -> int:
        r = 0
        for c, s in zip(coords, self.shape):
            r = r * s + c
        return r

    def coords_of(self, rank: int) -> Tuple[int, ...]:
        out = []
        for s in reversed(self.shape):
            out.append(rank % s)
            rank //= s
        return tuple(reversed(out))

    @property
    def rank(self) -> int:
        return self.rank_of(self.coords)

    def members(self, axes) -> List[Tuple[int, ...]]:
        """Coordinates of the ranks of this rank's group over ``axes``, in
        group order (the mixed radix of their ``axes`` coordinates, in
        mesh-axis order)."""
        axes = set(_as_tuple(axes))
        ranges = [range(s) if a in axes else (c,)
                  for a, s, c in zip(self.axis_names, self.shape,
                                     self.coords)]
        return list(itertools.product(*ranges))

    def group(self, axes):
        return self.groups[frozenset(_as_tuple(axes))]

    def describe(self) -> str:
        return " x ".join(f"{a} {s}" for a, s in zip(self.axis_names,
                                                      self.shape))


_MESH: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)
_BATCH_WHOLE: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_batch_whole", default=False)


@contextlib.contextmanager
def mesh_context(mesh: Optional[Mesh]):
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh() -> Optional[Mesh]:
    return _MESH.get()


@contextlib.contextmanager
def replicated_batch(on: bool = True):
    """With ``on``, the batch is whole on every rank of the batch axes
    (the long-context cell's global batch of 1, whose cache splits its
    positions over ``data`` instead): the collectives named ``batch`` are
    identities inside."""
    token = _BATCH_WHOLE.set(on)
    try:
        yield
    finally:
        _BATCH_WHOLE.reset(token)


def resolve_axis(mesh: Mesh, logical: Logical):
    """Map a logical axis name to physical mesh axes present on `mesh`."""
    if logical is None:
        return None
    if isinstance(logical, (tuple, list)):
        phys = sum((_as_tuple(resolve_axis(mesh, l)) for l in logical), ())
        return phys if phys else None
    names = mesh.axis_names
    if logical == "batch":
        phys = tuple(n for n in ("pod", "data") if n in names)
        return phys if phys else None
    if logical in ("model", "expert"):
        return "model" if "model" in names else None
    if logical == "seq":   # long-context sequence sharding reuses the data axis
        return "data" if "data" in names else None
    if logical == "fsdp":  # parameter sharding axis for ZeRO/FSDP
        return "data" if "data" in names else None
    if logical in names:
        return logical
    return None


def _as_tuple(x):
    if x is None:
        return ()
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def logical_to_spec(mesh: Mesh, axes: Sequence[Logical]) -> Spec:
    return tuple(resolve_axis(mesh, a) for a in axes)


# ------------------------------------------------------------ primitives

def _active(logical) -> Tuple[Optional[Mesh], Tuple[str, ...]]:
    """The current mesh and the physical axes of ``logical`` on it that
    have more than one rank (an empty tuple: nothing to do)."""
    mesh = _MESH.get()
    if mesh is None or (logical == "batch" and _BATCH_WHOLE.get()):
        return mesh, ()
    sizes = mesh.sizes
    axes = tuple(a for a in _as_tuple(resolve_axis(mesh, logical))
                 if sizes[a] > 1)
    return mesh, axes


def _record(mesh: Mesh, kind: str, axes, t: torch.Tensor) -> None:
    mesh.records.append({"kind": kind, "axes": list(_as_tuple(axes)),
                         "bytes": t.numel() * t.element_size()})


def _staged(mesh: Mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.is_cuda


def _all_reduce(mesh: Mesh, axes, t: torch.Tensor,
                op: str = "sum") -> torch.Tensor:
    """Sum (or, with ``op="max"``, maximum) of ``t`` over the group of
    ``axes`` (a new tensor)."""
    if mesh.dry:
        _record(mesh, "all-reduce", axes, t)
        return t.clone()
    import torch.distributed as dist
    buf = t.detach().cpu() if _staged(mesh, t) else t.detach().clone()
    buf = buf.contiguous()
    dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX}[op],
                    group=mesh.group(axes))
    return buf.to(t.device)


def _all_gather(mesh: Mesh, axes, t: torch.Tensor) -> torch.Tensor:
    """(n, *t.shape): every member's ``t`` over the group of ``axes``, in
    group order."""
    n = mesh.axis_size(axes)
    if mesh.dry:
        _record(mesh, "all-gather", axes, t)
        return t.new_empty((n, *t.shape))
    import torch.distributed as dist
    src = (t.detach().cpu() if _staged(mesh, t) else t.detach()).contiguous()
    out = src.new_empty((n * src.numel(),))
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, src.reshape(-1), group=mesh.group(axes))
    return out.reshape(n, *t.shape).to(t.device)


def _reduce_scatter(mesh: Mesh, axes, t: torch.Tensor) -> torch.Tensor:
    """``t`` (n, *block): member ``i`` gets the sum over members of
    ``t[i]``."""
    if mesh.dry:
        _record(mesh, "reduce-scatter", axes, t)
        return t.new_empty(t.shape[1:])
    import torch.distributed as dist
    src = (t.detach().cpu() if _staged(mesh, t) else t.detach()).contiguous()
    out = src.new_empty(src.shape[1:])
    scatter = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    scatter(out.reshape(-1), src.reshape(-1), group=mesh.group(axes))
    return out.to(t.device)


def _my_index(mesh: Mesh, axes) -> int:
    """This rank's index in its group over ``axes``."""
    idx = 0
    for a in mesh.axis_names:
        if a in _as_tuple(axes):
            idx = idx * mesh.sizes[a] + mesh.coord(a)
    return idx


# ---------------------------------------------------- Megatron functions

class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(mesh, axes, x)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.mesh, ctx.axes, g), None, None


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_reduce(mesh, axes, x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.mesh, ctx.axes, g), None, None


def _split(mesh, axes, x, dim):
    n = mesh.axis_size(axes)
    return x.chunk(n, dim=dim)[_my_index(mesh, axes)].contiguous()


def _gather(mesh, axes, x, dim):
    parts = _all_gather(mesh, axes, x.contiguous())
    return torch.cat(list(parts.unbind(0)), dim=dim)


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather(mesh, axes, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _split(ctx.mesh, ctx.axes, g, ctx.dim), None, None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _split(mesh, axes, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(ctx.mesh, ctx.axes, g, ctx.dim), None, None, None


def reduce_from(x: torch.Tensor, logical: Logical = "model") -> torch.Tensor:
    """Sum ``x`` over the ranks of ``logical`` (the all-reduce after a
    row-parallel product; backward: identity).  Identity outside a
    mesh."""
    mesh, axes = _active(logical)
    return x if not axes else _ReduceFrom.apply(x, mesh, axes)


def copy_to(x: torch.Tensor, logical: Logical = "model") -> torch.Tensor:
    """``x`` as the replicated input of a column-parallel product:
    forward identity, backward the sum of the ranks' gradients."""
    mesh, axes = _active(logical)
    return x if not axes else _CopyTo.apply(x, mesh, axes)


def replica_axis(rep: int) -> str:
    """The group name of the runs of ``rep`` consecutive ``model`` ranks
    (the ranks that hold one replicated KV head), ``rep`` a proper divisor
    of the axis; a real mesh holds each rank's run as
    ``groups[frozenset({replica_axis(rep)})]``."""
    return f"model/{rep}"


def copy_to_replicas(w: torch.Tensor, rep: int) -> torch.Tensor:
    """``w``, a block held alike by ``rep`` consecutive ``model`` ranks
    (a replicated KV head's ``wk``/``wv``), whose gradient is summed over
    them: each rank's gradient is that of its own query heads.  Identity
    outside a mesh, for ``rep`` 1 and where no gradient flows."""
    mesh = _MESH.get()
    if mesh is None or rep == 1 or not (torch.is_grad_enabled()
                                        and w.requires_grad):
        return w
    axes = "model" if rep == mesh.sizes["model"] else replica_axis(rep)
    return _CopyTo.apply(w, mesh, (axes,))


def all_sum(x: torch.Tensor, logical: Logical = "model") -> torch.Tensor:
    """Sum ``x`` over the ranks of ``logical``, where every rank then uses
    the sum for its own part of the output (the split-row RMSNorm's
    statistic): the gradient of each rank's ``x`` is the sum of the ranks'
    gradients of the sum (where :func:`reduce_from`'s is the identity).
    Identity outside a mesh."""
    mesh, axes = _active(logical)
    return x if not axes else _AllSum.apply(x, mesh, axes)


def gather_from(x: torch.Tensor, logical: Logical = "model",
                dim: int = -1) -> torch.Tensor:
    """All-gather of a split activation along ``dim`` (backward: this
    rank's chunk)."""
    mesh, axes = _active(logical)
    return x if not axes else _GatherFrom.apply(x, mesh, axes, dim)


def split_to(x: torch.Tensor, logical: Logical = "model",
             dim: int = -1) -> torch.Tensor:
    """This rank's chunk of a replicated ``x`` along ``dim`` (backward:
    the all-gather)."""
    mesh, axes = _active(logical)
    return x if not axes else _SplitTo.apply(x, mesh, axes, dim)


def axis_index(logical: Logical) -> Tuple[int, int]:
    """``(index, count)`` of this rank over the ranks of ``logical``
    (``(0, 1)`` outside a mesh)."""
    mesh, axes = _active(logical)
    if not axes:
        return 0, 1
    return _my_index(mesh, axes), mesh.axis_size(axes)


# ------------------------------------------------------- blocks and FSDP

def _entries(spec: Spec, ndim: int):
    """The last ``ndim`` entries of ``spec`` (leading stack entries of a
    per-layer leaf dropped), each as a tuple of axis names."""
    spec = tuple(spec)[len(spec) - ndim:] if len(spec) >= ndim else \
        tuple(spec) + (None,) * (ndim - len(spec))
    return [_as_tuple(e) for e in spec]


def block_region(mesh: Mesh, full_shape, spec: Spec, coords,
                 keep=None) -> List[Tuple[int, int]]:
    """``[start, stop)`` per dim of the block that the rank at ``coords``
    holds of a leaf of ``full_shape`` laid out by ``spec``; with ``keep``
    (a set of axis names) only those axes split (the others are
    gathered)."""
    sizes = mesh.sizes
    region = []
    for n, axes in zip(full_shape, _entries(spec, len(full_shape))):
        axes = [a for a in axes if keep is None or a in keep]
        parts, idx = 1, 0
        for a in axes:
            parts *= sizes[a]
            idx = idx * sizes[a] + coords[mesh.axis_names.index(a)]
        step = n // parts
        region.append((idx * step, (idx + 1) * step))
    return region


def _fsdp_layout(mesh: Mesh, spec: Spec, ndim: int):
    """``(gather_axes, keep)`` of a parameter: the axes its FSDP gather
    runs over (every axis of its spec but ``model``, with ``model`` too
    where a dim splits over another axis before ``model``, whose model
    block the gather alone cannot make contiguous) and the axes its
    compute block stays split over."""
    sizes = mesh.sizes
    gather, model_too = set(), False
    for axes in _entries(spec, ndim):
        for a in axes:
            if a != "model" and sizes[a] > 1:
                gather.add(a)
        if "model" in axes and axes.index("model") > 0 and any(
                sizes[a] > 1 for a in axes[:axes.index("model")]):
            model_too = True
    if model_too and sizes.get("model", 1) > 1:
        gather.add("model")
    keep = set() if "model" in gather else {"model"}
    return tuple(a for a in mesh.axis_names if a in gather), keep


def _assemble(mesh, full_shape, spec, members, blocks, region):
    """The tensor over ``region`` of a leaf from the ``blocks`` (one per
    member coordinate) that overlap it."""
    out = blocks.new_zeros([b - a for a, b in region])
    for c, blk in zip(members, blocks.unbind(0)):
        src = block_region(mesh, full_shape, spec, c)
        sl_out, sl_blk = [], []
        for (a, b), (s, e) in zip(region, src):
            lo, hi = max(a, s), min(b, e)
            if lo >= hi:
                break
            sl_out.append(slice(lo - a, hi - a))
            sl_blk.append(slice(lo - s, hi - s))
        else:
            out[tuple(sl_out)] = blk[tuple(sl_blk)]
    return out


def _pieces(mesh, full_shape, spec, members, g, region, block_shape):
    """Per member, the part of ``g`` (over ``region``) inside that
    member's block, zero elsewhere: (n, *block_shape)."""
    out = g.new_zeros((len(members), *block_shape))
    for i, c in enumerate(members):
        if c is None:           # this rank sends that member nothing
            continue
        dst = block_region(mesh, full_shape, spec, c)
        sl_g, sl_blk = [], []
        for (a, b), (s, e) in zip(region, dst):
            lo, hi = max(a, s), min(b, e)
            if lo >= hi:
                break
            sl_g.append(slice(lo - a, hi - a))
            sl_blk.append(slice(lo - s, hi - s))
        else:
            out[i][tuple(sl_blk)] = g[tuple(sl_g)]
    return out


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, mesh, spec, full_shape):
        gather, keep = _fsdp_layout(mesh, spec, local.dim())
        region = block_region(mesh, full_shape, spec, mesh.coords, keep)
        ctx.mesh, ctx.spec, ctx.full_shape = mesh, spec, full_shape
        ctx.gather, ctx.region = gather, region
        ctx.block_shape = tuple(local.shape)
        if not gather:
            return local.view_as(local)
        members = mesh.members(gather)
        blocks = _all_gather(mesh, gather, local.contiguous())
        return _assemble(mesh, full_shape, spec, members, blocks, region)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        if ctx.gather:
            members = mesh.members(ctx.gather)
            if "model" in ctx.gather:
                # the compute view is replicated over ``model`` and so is
                # its gradient: each block takes it from the ranks of its
                # own model coordinate only (once per data rank)
                mi = mesh.axis_names.index("model")
                members_w = [c if c[mi] == mesh.coords[mi] else None
                             for c in members]
            else:
                members_w = members
            pieces = _pieces(mesh, ctx.full_shape, ctx.spec, members_w, g,
                             ctx.region, ctx.block_shape)
            g = _reduce_scatter(mesh, ctx.gather, pieces)
        rest = tuple(a for a in ("pod", "data") if a in mesh.axis_names
                     and mesh.sizes[a] > 1 and a not in ctx.gather)
        if rest:             # replicated over these batch axes: sum
            g = _all_reduce(mesh, rest, g)
        return g, None, None, None


def fsdp_gather(local: torch.Tensor, spec: Spec, full_shape
                ) -> torch.Tensor:
    """A parameter's compute block from its FSDP block: its shards over
    the batch axes (``data``) gathered, leaving only its ``model`` split
    (a contiguous block).  Backward: the reduce-scatter of its gradient
    over the gathered axes (an all-reduce over the batch axes it is
    replicated on).  Identity outside a mesh or where nothing is sharded
    over a batch axis of more than one rank."""
    mesh = _MESH.get()
    if mesh is None or all(mesh.sizes[a] == 1 for a in ("pod", "data")
                           if a in mesh.axis_names):
        return local
    full = list(expanded_shape(full_shape, spec))
    if isinstance(spec, HeadSplit):
        # the ranks of a gather share this rank's ``model`` coordinate and
        # so its stored units: the split dim is gathered at their width
        d = spec.dim % local.dim()
        full[d] = local.shape[d] * mesh.axis_size(_entries(spec,
                                                           local.dim())[d])
    return _FsdpGather.apply(local, mesh, tuple(spec), tuple(full))


def gather_full(local: torch.Tensor, spec: Spec, full_shape,
                mesh: Mesh) -> torch.Tensor:
    """The whole leaf of ``full_shape`` from every rank's block by
    ``spec`` (a collective over every axis the spec splits on)."""
    if isinstance(spec, HeadSplit):
        local = _expanded_block(local, spec, mesh)
    axes = tuple(a for a in mesh.axis_names
                 if any(a in e for e in _entries(spec, local.dim()))
                 and mesh.sizes[a] > 1)
    if not axes:
        out = local.detach().clone()
    else:
        blocks = _all_gather(mesh, axes, local.detach().contiguous())
        shape = expanded_shape(full_shape, spec)
        out = _assemble(mesh, shape, tuple(spec), mesh.members(axes),
                        blocks, [(0, n) for n in shape])
    return _whole_columns(out, spec) if isinstance(spec, HeadSplit) else out


def all_reduce_sum(x: torch.Tensor, axes, mesh: Optional[Mesh] = None,
                   op: str = "sum") -> torch.Tensor:
    """Plain (non-autograd) sum of ``x`` (or, with ``op="max"``, its
    maximum) over the physical ``axes`` of ``mesh`` (default: the current
    mesh); identity over axes of size 1."""
    mesh = mesh or _MESH.get()
    if mesh is None:
        return x
    axes = tuple(a for a in _as_tuple(axes) if mesh.sizes.get(a, 1) > 1)
    return _all_reduce(mesh, axes, x, op) if axes else x


def gather_counts(x: torch.Tensor, logical: Logical) -> torch.Tensor:
    """Plain (non-autograd) all-gather of ``x`` over the ranks of
    ``logical``: (n, *x.shape) in group order (``x[None]`` outside a mesh
    or over axes of one rank)."""
    mesh, axes = _active(logical)
    return _all_gather(mesh, axes, x) if axes else x[None]
