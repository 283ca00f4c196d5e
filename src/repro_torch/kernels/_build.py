"""Build and load the port's hand-written CUDA kernels.

Each source in ``repro_torch/csrc/*.cu`` exposes a plain C interface and
is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own shared
library, loaded with ``ctypes``.  Nothing here includes PyTorch's headers,
so a build takes seconds.  Libraries land in ``build/repro_torch/`` at the
repository root (listed in ``.gitignore``), keyed by a hash of the source,
so an edited source is rebuilt at its next use.  :func:`build_all` starts
one ``nvcc`` per source, all at once.

Nothing is built or loaded at import time: the first kernel launch (or an
explicit :func:`build_all`) does it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


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


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


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
        return _libs[name]


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


def dtype_code(dtype) -> int:
    """The kernels' code for a torch dtype: 0 = float32, 1 = bfloat16."""
    code = {"torch.float32": 0, "torch.bfloat16": 1}.get(str(dtype))
    if code is None:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    return code
