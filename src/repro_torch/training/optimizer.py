"""AdamW with global-norm clipping over the port's parameter tree, the
torch twin of ``repro.training.optimizer``.

Moments are float32 and the update is computed in float32 whatever the
parameter dtype.  Parameters and moments are updated **in place** (under
``torch.no_grad``), so a step holds no second copy of the state; the bias
corrections and the warmup schedule are float32 tensors on the device, as
in JAX.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from repro_torch.utils import tree_leaves, tree_map

# the subtree whose leaves the reference stacks on a leading layer axis
STACKED = "layers"


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100


def _device(params) -> torch.device:
    return next(leaf for _, leaf in tree_leaves(params)).device


def init_opt_state(params) -> Dict[str, Any]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=_device(params))}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for _, x in tree_leaves(tree)))


def _schedule(cfg: AdamWConfig, step):
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def decays(path, p) -> bool:
    """Whether a leaf takes weight decay: the reference decays leaves of
    ``ndim >= 2`` (matrices), but it stacks every leaf under ``layers`` on
    a leading layer axis, so each per-layer leaf there (norm scales and
    biases included) counts one more axis than its shape here.  So the
    port decays every leaf under ``layers`` and the matrices outside it
    (``embed``, ``lm_head``), and leaves ``final_norm`` alone, as the
    reference does."""
    return p.dim() + (1 if path and path[0] == STACKED else 0) >= 2


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, opt_state):
    """One AdamW step, writing ``params`` and the moments in place.
    Returns ``(params, opt_state, metrics)`` (the same param tree, the
    moments and the advanced step; ``grad_norm`` and ``lr``)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = opt_state["step"] + 1
    lr = _schedule(cfg, step)
    stepf = step.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=stepf.device), stepf)
    m_tree, v_tree = opt_state["m"], opt_state["v"]
    flat = zip(tree_leaves(params), tree_leaves(grads), tree_leaves(m_tree),
               tree_leaves(v_tree))
    for (path, p), (_, g), (_, m), (_, v) in flat:
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if decays(path, p):     # decoupled weight decay
            update += cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * update)
    return params, {"m": m_tree, "v": v_tree, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
