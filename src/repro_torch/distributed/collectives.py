"""INT8 gradient compression, the torch twin of
``repro.distributed.collectives``.

Each gradient leaf is quantized to symmetric per-tensor INT8 and back
before the optimizer, as the reference does ahead of its data-parallel
reduction.  On one device there is no reduction: the round trip is what the
optimizer sees.
"""
from __future__ import annotations

import torch

from repro_torch.utils import tree_map


def _q8(x):
    xf = x.float()
    amax = torch.clamp(xf.abs().max(), min=1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return (q.float() * scale).to(x.dtype)


def compress_grads_int8(grads):
    """Symmetric per-tensor INT8 round-trip on every gradient leaf."""
    return tree_map(_q8, grads)
