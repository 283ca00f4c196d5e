"""Checkpoint/restart on one device, the torch twin of
``repro.training.checkpoint`` (sharded restore onto a mesh is not ported).

A checkpoint is a directory ``step_<8 digits>`` holding ``arrays.npz``
(every leaf as a host array) and ``manifest.json`` (each leaf's tree path,
dtype and shape, and the step).  It is written into a temporary directory
and renamed into place, so a crash mid-save never leaves a partial
checkpoint under the final name; ``LATEST`` names the newest step.
bfloat16 leaves, which numpy cannot hold, are stored losslessly as their
raw 16 bits (``uint16``) with ``bfloat16`` in the manifest, and viewed back
as bfloat16 on restore.
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

from repro_torch.utils import tree_leaves, tree_map


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def save_checkpoint(ckpt_dir: str | Path, state, step: int) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_"))
    manifest, arrays = {}, {}
    for path, leaf in tree_leaves(state):
        key = _key(path)
        t = leaf.detach().cpu()
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
    final = ckpt_dir / f"step_{step:08d}"
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                    # atomic publish
    (ckpt_dir / "LATEST").write_text(str(step))
    return final


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    marker = Path(ckpt_dir) / "LATEST"
    if not marker.exists():
        return None
    return int(marker.read_text().strip())


def restore_checkpoint(ckpt_dir: str | Path, state_template,
                       step: Optional[int] = None):
    """Restore onto ``state_template``'s tree: each leaf takes the
    template's dtype and device, and requires grad where the template's
    leaf does.  Returns ``(state, step)``."""
    ckpt_dir = Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())["leaves"]
    keys = iter(_key(p) for p, _ in tree_leaves(state_template))
    with np.load(d / "arrays.npz") as data:
        def load(tmpl):
            key = next(keys)
            arr = data[key.replace("/", "__")]
            if manifest[key]["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            t = t.to(device=tmpl.device, dtype=tmpl.dtype, copy=True)
            return t.requires_grad_(tmpl.requires_grad)
        state = tree_map(load, state_template)
    return state, step
