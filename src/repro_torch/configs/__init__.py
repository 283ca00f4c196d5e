"""Architecture registry of the PyTorch port.

Only the architectures the port runs are registered.  Each lives in its
own module (``repro_torch/configs/<id>.py``) exposing ``CONFIG`` (full
size) and ``smoke_config()`` (reduced, CPU-runnable), as in the JAX
package's registry.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig

# architecture id -> module name
_ASSIGNED = {
    "granite-3-8b": "granite_3_8b",
    "mamba2-2.7b": "mamba2_2p7b",
}

ASSIGNED_ARCHS = tuple(_ASSIGNED)


def _module(name: str):
    if name not in _ASSIGNED:
        raise KeyError(f"unknown architecture {name!r}; the port runs "
                       f"{sorted(_ASSIGNED)}")
    return importlib.import_module(f"repro_torch.configs.{_ASSIGNED[name]}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    return _module(name).smoke_config()


__all__ = ["ArchConfig", "ASSIGNED_ARCHS", "get_config", "get_smoke_config"]
