"""Model operations of one decode step: 2 per active parameter per token
(the tied head included, an MoE's router and ``top_k`` experts only) and
4 per attended position, head and head dim in every layer, over the
step's active lanes (padding lanes do no useful work)."""
from __future__ import annotations

from portbench.arch import Arch


def decode_flops(a: Arch, lanes: int, ctx_tokens: int) -> float:
    return (2.0 * a.active_params() * lanes
            + 4.0 * a.layers * ctx_tokens * a.heads * a.head_dim)
