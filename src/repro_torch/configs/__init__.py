"""Architecture registry of the PyTorch port: the ten assigned
architectures, as in the JAX package's registry.

Each lives in its own module (``repro_torch/configs/<id>.py``) exposing
``CONFIG`` (full size) and ``smoke_config()`` (reduced, CPU-runnable).
The port's ``Model`` runs every family: the attention family (dense and
MoE FFNs, the VLM's token and embeds inputs), Mamba-2, the hybrid family
(Jamba) and the encoder-decoder family (seamless).
:func:`get_config` also knows the paper's own models
(``paper_models.CONFIGS``: OPT, LLaMA, Pythia), which the analytic
simulator and cluster models price; the port runs none of them, so
:func:`get_smoke_config` and the launchers take only the registered ids.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig

# architecture id -> module name
_ASSIGNED = {
    "internvl2-2b": "internvl2_2b",
    "mamba2-2.7b": "mamba2_2p7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "command-r-35b": "command_r_35b",
    "qwen1.5-32b": "qwen1p5_32b",
    "granite-3-8b": "granite_3_8b",
    "stablelm-3b": "stablelm_3b",
    "dbrx-132b": "dbrx_132b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "jamba-1.5-large-398b": "jamba_1p5_large_398b",
}

ASSIGNED_ARCHS = tuple(_ASSIGNED)


def _module(name: str):
    if name not in _ASSIGNED:
        raise KeyError(f"unknown architecture {name!r}; the port runs "
                       f"{sorted(_ASSIGNED)}")
    return importlib.import_module(f"repro_torch.configs.{_ASSIGNED[name]}")


def get_config(name: str) -> ArchConfig:
    """The full-size config of a registered architecture, else of one of
    the paper's models (the analytic models' inputs)."""
    if name in _ASSIGNED:
        return _module(name).CONFIG
    from repro_torch.configs import paper_models
    if name in paper_models.CONFIGS:
        return paper_models.CONFIGS[name]
    raise KeyError(f"unknown architecture {name!r}; known: "
                   f"{sorted(list(_ASSIGNED) + list(paper_models.CONFIGS))}")


def get_smoke_config(name: str) -> ArchConfig:
    """The reduced config of an architecture the port runs."""
    return _module(name).smoke_config()


__all__ = ["ArchConfig", "ASSIGNED_ARCHS", "get_config", "get_smoke_config"]
