"""Train and serve step builders, the torch twin of
``repro.training.train_step``, on one device."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.distributed.collectives import compress_grads_int8
from repro_torch.models.model import Model
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state)
from repro_torch.utils import tree_leaves, tree_map


def make_train_step(model: Model, opt_cfg: Optional[AdamWConfig] = None,
                    grad_compression: bool = False):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    state = {"params", "m", "v", "step"}, params requiring grad (see
    :func:`init_train_state`); batch = {"tokens", "targets"} tensors on the
    model's device.  The step differentiates ``model.loss``, optionally
    round-trips the gradients through INT8 (``grad_compression``), and
    runs AdamW, which writes params and moments in place."""
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(state, batch):
        params = state["params"]
        loss, metrics = model.loss(params, batch)
        leaves = [p for _, p in tree_leaves(params)]
        flat = iter(torch.autograd.grad(loss, leaves))
        grads = tree_map(lambda _: next(flat), params)
        if grad_compression:
            grads = compress_grads_int8(grads)
        opt_state = {"m": state["m"], "v": state["v"], "step": state["step"]}
        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, params, grads, opt_state)
        new_state = {"params": new_params, **new_opt}
        metrics = {**{k: v.detach() for k, v in metrics.items()},
                   **opt_metrics, "loss": loss.detach()}
        return new_state, metrics

    return train_step


def init_train_state(model: Model, generator: torch.Generator
                     ) -> Dict[str, Any]:
    """Random params from ``generator`` (on the model's device), each
    requiring grad, with zero AdamW moments and step 0."""
    params = model.init(generator)
    for _, p in tree_leaves(params):
        p.requires_grad_(True)
    return {"params": params, **init_opt_state(params)}


def make_prefill_step(model: Model):
    def prefill_step(params, batch):
        return model.prefill(params, batch)
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)
    return decode_step
