"""Build and load the port's hand-written CUDA kernels.

Each source in ``repro_torch/csrc/*.cu`` exposes a plain C interface and
is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own shared
library, loaded with ``ctypes``.  Nothing here includes PyTorch's headers,
so a build takes seconds.  Libraries land in ``build/repro_torch/`` at the
repository root (listed in ``.gitignore``), keyed by a hash of the source,
of every ``csrc/`` header it includes (``#include "..."``, followed
through headers) and of the flags, so an edited source or header is
rebuilt at its next use.  :func:`build_all` starts one ``nvcc`` per source, all at once.

Nothing is built or loaded at import time: the first kernel launch (or an
explicit :func:`build_all`) does it.  Each build and each load is reported
to ``utils/compile_counter`` (``build:<name>``, ``load:<name>``), so that
a warmed engine can show that serving built and loaded nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

import torch

from repro_torch.utils.compile_counter import note

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# the launch counters' one lock: a wrapper holds it across its launch entry
# (whose library counts its bodies in C) and its ``launches`` bump, and
# ``kernels/counters`` holds it to read and advance them, so threads that
# launch or replay at once lose no count
COUNT_LOCK = threading.RLock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def includes(name: str) -> List[Path]:
    """The ``csrc/`` files that ``csrc/<name>.cu`` includes with
    ``#include "..."``, directly or through another header, sorted."""
    seen: Dict[Path, None] = {}
    todo = [CSRC / f"{name}.cu"]
    while todo:
        text = todo.pop().read_text()
        for inc in _LOCAL_INCLUDE.findall(text):
            path = (CSRC / inc).resolve()
            if path not in seen and path.is_file():
                seen[path] = None
                todo.append(path)
    return sorted(seen)


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for inc in includes(name):
        h.update(inc.name.encode() + b"\0" + inc.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def sources() -> List[str]:
    """Kernel source names (``csrc/<name>.cu``), sorted."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(verbose: bool = False) -> Dict[str, str]:
    """Compile every source that has no up-to-date library, one ``nvcc``
    process per source, all started together.  Raises with the compiler's
    output if any build fails.  Returns ``{name: compiler output}`` (the
    ``-Xptxas -v`` register/shared-memory report when ``verbose``)."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name in sources():
            out = _target(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        logs, failed = {}, []
        for name, (proc, tmp, out) in procs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(name)
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
                note(f"build:{name}")
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                               + "\n".join(logs[n] for n in failed))
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first
    use)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    if not _target(name).exists():
        build_all()
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_target(name)))
            note(f"load:{name}")
        return _libs[name]


def loaded(name: str) -> bool:
    """Whether the library of ``csrc/<name>.cu`` is loaded (nothing is
    built or loaded to answer)."""
    return name in _libs


def check(err: int, what: str) -> None:
    """Raise when a launch returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def refuse_grad(what: str, *tensors) -> None:
    """Raise when grad mode is on and a floating input requires grad.

    A kernel launched through ``ctypes`` writes into a tensor autograd knows
    nothing of, so its output has no ``grad_fn`` and the graph would be cut
    without a word.  Raw wrappers call this first, on every device; a
    caller that needs gradients goes through the kernel's
    ``torch.autograd.Function`` (whose forward runs with grad mode off)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in tensors
            if t is not None and t.is_floating_point()):
        raise RuntimeError(
            f"{what}: an input requires grad, but the raw kernel wrapper "
            "records no backward; call it under torch.no_grad() or through "
            "its autograd Function")


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(dtype) -> int:
    """The kernels' code for a torch dtype: 0 = float32, 1 = bfloat16."""
    code = _DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    return code
