"""Plain reference of the attention-family decoder with a mixture-of-experts
FFN (granite-3.0 MoE): ``dense.py``'s model with each layer's FFN replaced
by a top-k router over SwiGLU experts.

The router is float32: softmax over every expert of ``x router``, the
``top_k`` largest probabilities renormalised to sum 1 (the same as a
softmax over the top-k logits, as the published model computes it).
Every token reaches all of its ``top_k`` experts (dropless), as the
published model routes; the configuration file sets the program's
capacity so that it drops none either.  Imports nothing of the
program."""
from __future__ import annotations

from typing import List

import torch

from portbench.arch import Arch
from portbench.reference import dense
from portbench.reference.dense import Products, Seq  # noqa: F401


def moe_ffn(a: Arch, p: dict, x, mm: Products):
    """Each token's ``top_k`` experts, weighted by its renormalised router
    probabilities; ``p``'s expert weights as :meth:`Products.weight` gave
    them, its router in float32."""
    probs = torch.softmax(x @ p["router"], dim=-1)
    w, idx = torch.topk(probs, a.top_k, dim=-1)
    w = w / w.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(a.experts):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        h = mm(xe, p["wi"][e])
        g = mm(xe, p["wg"][e])
        y = mm(torch.nn.functional.silu(g) * h, p["wo"][e])
        out.index_add_(0, rows, y * w[rows, slot, None])
    return out


def run(a: Arch, seed: int, device, seqs: List[Seq],
        precision: str = "f32") -> List[torch.Tensor]:
    return dense.run(a, seed, device, seqs, precision, ffn=moe_ffn)
