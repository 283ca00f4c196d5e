"""Small shared utilities."""
from __future__ import annotations

import math

import torch

DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
    "int8": torch.int8,
    "int32": torch.int32,
}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  There is no automatic CPU fallback: without a GPU the caller
    must pass ``device="cpu"`` explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return dev


def tree_map(fn, tree):
    """Apply ``fn`` leaf by leaf over nested dicts and lists (the port's
    parameter and state trees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree, path=()):
    """``(path, leaf)`` pairs of nested dicts and lists, depth first in
    insertion order; a path is the tuple of keys and list indices."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, path + (i,))
    else:
        yield path, tree


def tree_size_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for _, x in tree_leaves(tree))


def tree_param_count(tree) -> int:
    return sum(math.prod(x.shape) for _, x in tree_leaves(tree))


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f}{unit}"
        n /= 1024.0
    return f"{n:.2f}PiB"


def _keystr(path) -> str:
    return "".join(f"[{p!r}]" for p in path)


def assert_no_nans(tree, where: str = ""):
    for path, leaf in tree_leaves(tree):
        t = torch.as_tensor(leaf)
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite values at {_keystr(path)} "
                                 f"{where}")
