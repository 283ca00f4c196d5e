"""The bytes autograd holds for the backward.

:class:`SavedBytes` is a context in which every tensor that autograd saves
for the backward (``torch.autograd.graph.saved_tensors_hooks``) is tallied
once by its storage, so a tensor saved by several ops, or views of one
storage, count once, at the storage's size.  Tensors of the ``exclude``
storages (the parameters and the batch: held whether or not autograd
saves them) do not count.  Inside a remat unit (``Model(remat=True)``)
``torch.utils.checkpoint`` saves through its own hooks, so the tally sees
only each unit's inputs.  Enter it around the forward alone (the loss): a
backward that differentiates under grad mode (the flash kernel's Function
recomputes its plain version) would save under it too.

It works on any device; on meta tensors (the dry run) it costs no memory.
It keeps every tallied storage alive until the context ends.
:func:`saved_at_loss` is the tally of one loss.
"""
from __future__ import annotations

import torch

from repro_torch.utils import tree_leaves


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class SavedBytes:
    """``with SavedBytes(exclude) as saved: ...``; then ``saved.bytes`` is
    the tally."""

    def __init__(self, exclude=()):
        self._skip = {_key(t) for t in exclude}
        self._held = {}
        self._hooks = torch.autograd.graph.saved_tensors_hooks(
            self._pack, lambda t: t)

    def _pack(self, t: torch.Tensor) -> torch.Tensor:
        key = _key(t)
        if key not in self._skip:
            self._held.setdefault(key, t.untyped_storage())
        return t

    def __enter__(self) -> "SavedBytes":
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._hooks.__exit__(*exc)
        self.bytes = sum(st.nbytes() for st in self._held.values())
        self._held.clear()


def saved_at_loss(loss, params, batch):
    """``loss(params, batch)`` under :class:`SavedBytes`, the leaves of
    ``params`` and ``batch`` not counted: ``(its output, the tally)``."""
    held = [t for tree in (params, batch) for _, t in tree_leaves(tree)]
    with SavedBytes(held) as tally:
        out = loss(params, batch)
    return out, tally.bytes
