"""INT8 gradient compression, the torch twin of
``repro.distributed.collectives``.

Each gradient leaf is quantized to symmetric per-tensor INT8 and back
before the optimizer, as the reference's train step does to the whole
(already reduced) gradient.  On one device there is no reduction: the
round trip is what the optimizer sees.  On a mesh a rank holds blocks of
each gradient leaf, and its scale is the whole leaf's.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.ctx import all_reduce_sum
from repro_torch.distributed.sharding import (map_with_path, spec_at,
                                             split_axes)
from repro_torch.utils import tree_map


def _q8(x, amax=None):
    xf = x.float()
    amax = torch.clamp(xf.abs().max() if amax is None else amax, min=1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return (q.float() * scale).to(x.dtype)


def compress_grads_int8(grads, mesh=None, specs=None):
    """Symmetric per-tensor INT8 round-trip on every gradient leaf.  On a
    ``mesh`` (``specs`` the tree's specs) ``grads`` are the rank's blocks,
    and each leaf's amax is the maximum over the ranks its blocks split
    over: the round trip of the whole leaf."""
    if mesh is None:
        return tree_map(_q8, grads)

    def leaf(path, g):
        axes = split_axes(spec_at(specs, path), g.dim(), mesh)
        return _q8(g, all_reduce_sum(g.float().abs().max(), axes, mesh,
                                     op="max"))
    return map_with_path(leaf, grads)
