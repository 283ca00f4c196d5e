"""Train and serve step builders, the torch twin of
``repro.training.train_step``: on one device, or as one rank of FSDP x TP
over the model's mesh (parameters and both AdamW moments stored as the
train-mode layouts say)."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.distributed.collectives import compress_grads_int8
from repro_torch.models.model import Model
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state)
from repro_torch.utils import tree_leaves, tree_map


def make_train_step(model: Model, opt_cfg: Optional[AdamWConfig] = None,
                    grad_compression: bool = False,
                    keep_grads: bool = False):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    state = {"params", "m", "v", "step"}, params requiring grad (see
    :func:`init_train_state`); batch = {"tokens", "targets"} tensors on the
    model's device (on a mesh: the rank's blocks and rows).  The step
    differentiates ``model.loss``, optionally round-trips the gradients
    through INT8 (``grad_compression``: on a mesh, each leaf's rank blocks
    at its whole leaf's scale), and runs AdamW, which writes params and
    moments in place.
    ``keep_grads`` puts the gradient tree in the metrics (``grads``)."""
    opt_cfg = opt_cfg or AdamWConfig()
    mesh = model.mesh
    specs = model.layouts("train") if mesh is not None else None

    def train_step(state, batch):
        params = state["params"]
        loss, metrics = model.loss(params, batch)
        paths, leaves = zip(*tree_leaves(params))
        # under ``embeds`` the loss need not read ``embed`` (an untied
        # table): it gets zeros, as jax.grad gives it; any other leaf the
        # loss does not reach is an error
        may_skip = {("embed",)} if "embeds" in batch else set()
        raw = torch.autograd.grad(loss, leaves, allow_unused=True)
        for path, g in zip(paths, raw):
            if g is None and path not in may_skip:
                raise RuntimeError(f"the loss does not reach {path}")
        flat = iter(torch.zeros_like(p) if g is None else g
                    for p, g in zip(leaves, raw))
        grads = tree_map(lambda _: next(flat), params)
        if grad_compression:
            grads = compress_grads_int8(grads, mesh, specs)
        opt_state = {"m": state["m"], "v": state["v"], "step": state["step"]}
        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, params, grads, opt_state, mesh=mesh, specs=specs)
        new_state = {"params": new_params, **new_opt}
        metrics = {**{k: v.detach() for k, v in metrics.items()},
                   **opt_metrics, "loss": loss.detach()}
        if keep_grads:
            metrics["grads"] = grads
        return new_state, metrics

    return train_step


def init_train_state(model: Model, generator: torch.Generator
                     ) -> Dict[str, Any]:
    """Random params from ``generator`` (on the model's device), each
    requiring grad, with zero AdamW moments and step 0; on a mesh the
    rank's train-mode blocks of the whole draw."""
    params = model.init(generator)
    if model.mesh is not None:
        params = model.shard(params, "train")
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
