"""Sharded checkpointing with elastic resharding, the torch twin of
``repro.training.checkpoint``.

A checkpoint is a directory ``step_<8 digits>`` holding ``arrays.npz``
(every leaf as a host array) and ``manifest.json`` (each leaf's tree path,
dtype and shape, and the step).  It is written into a temporary directory
and renamed into place, so a crash mid-save never leaves a partial
checkpoint under the final name; ``LATEST`` names the newest step.
bfloat16 leaves, which numpy cannot hold, are stored losslessly as their
raw 16 bits (``uint16``) with ``bfloat16`` in the manifest, and viewed back
as bfloat16 on restore.

On a mesh, :func:`save_checkpoint` gathers each leaf's blocks into the
whole array and rank 0 alone writes; :func:`restore_checkpoint` reads the
whole arrays and keeps each rank's block by the target mesh's layout
(``Model.layouts``: the sanitized specs, a Mamba layer's leaves by its
heads), so a checkpoint written on one mesh restores onto any other (or
onto one device): the elastic path.  The file holds every leaf whole, in
the reference's layout, whatever the mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.distributed.ctx import HeadSplit, _entries, gather_full
from repro_torch.distributed.sharding import shard_leaf, spec_at
from repro_torch.utils import tree_leaves, tree_map


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _whole(state, mesh, spec_tree):
    """``(path, whole leaf)`` of ``state``: each rank's blocks gathered by
    ``spec_tree`` on a mesh (a collective every rank joins), else the
    leaves themselves."""
    leaves = list(tree_leaves(state))
    if mesh is None:
        return [(p, t.detach()) for p, t in leaves]
    out = []
    for path, t in leaves:
        spec = spec_at(spec_tree, path)
        full = _full_shape(t, spec, mesh)
        out.append((path, gather_full(t, spec, full, mesh)))
    return out


def _full_shape(t, spec, mesh):
    """The whole leaf's shape from a rank's block ``t`` by ``spec`` (a
    :class:`HeadSplit` leaf's split dim is its whole width)."""
    full = [n * mesh.axis_size(axes)
            for n, axes in zip(t.shape, _entries(spec, t.dim()))]
    if isinstance(spec, HeadSplit):
        full[spec.dim % t.dim()] = spec.width
    return tuple(full)


def save_checkpoint(ckpt_dir: str | Path, state, step: int, mesh=None,
                    spec_tree=None) -> Path:
    """Write ``state`` as checkpoint ``step``.  On a mesh every rank calls
    this with its blocks and ``spec_tree`` (the state's specs, a tree of
    its structure); the leaves are gathered whole and rank 0 writes."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    leaves = _whole(state, mesh, spec_tree)
    if mesh is not None and mesh.rank != 0:
        _barrier(mesh)
        return final
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_"))
    manifest, arrays = {}, {}
    for path, leaf in leaves:
        key = _key(path)
        t = leaf.cpu()
        if t.dtype == torch.bfloat16:
            arr = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arr = t.numpy()
        arrays[key.replace("/", "__")] = arr
        manifest[key] = {"dtype": str(t.dtype).replace("torch.", ""),
                         "shape": list(t.shape)}
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(
        {"step": step, "leaves": manifest}))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                    # atomic publish
    (ckpt_dir / "LATEST").write_text(str(step))
    if mesh is not None:
        _barrier(mesh)
    return final


def _barrier(mesh) -> None:
    if not mesh.dry:
        import torch.distributed as dist
        dist.barrier()


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    marker = Path(ckpt_dir) / "LATEST"
    if not marker.exists():
        return None
    return int(marker.read_text().strip())


def restore_checkpoint(ckpt_dir: str | Path, state_template,
                       step: Optional[int] = None, mesh=None,
                       spec_tree=None):
    """Restore onto ``state_template``'s tree: each leaf takes the
    template's dtype and device, and requires grad where the template's
    leaf does.  With ``mesh`` and ``spec_tree`` (the target mesh's
    layouts of the state, as ``Model.layouts`` gives them) each rank keeps
    its block of the whole array; the target mesh need not match the one
    that wrote the checkpoint.  Returns ``(state, step)``."""
    ckpt_dir = Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())["leaves"]
    paths = iter(p for p, _ in tree_leaves(state_template))
    sharded = mesh is not None and spec_tree is not None
    with np.load(d / "arrays.npz") as data:
        def load(tmpl):
            path = next(paths)
            key = _key(path)
            arr = data[key.replace("/", "__")]
            if manifest[key]["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            if sharded:
                t = shard_leaf(t, spec_at(spec_tree, path), mesh)
            t = t.to(device=tmpl.device, dtype=tmpl.dtype, copy=True)
            return t.requires_grad_(tmpl.requires_grad)
        state = tree_map(load, state_template)
    return state, step
