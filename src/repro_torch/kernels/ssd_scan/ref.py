"""Plain PyTorch version of the SSD chunk kernel: the intra-chunk terms of
Mamba-2's chunked algorithm (steps 1-2 of ``models.mamba2.ssd_chunked``)."""
from __future__ import annotations

import torch


def segsum(dA):
    """dA: (..., Q) -> (..., Q, Q) lower-triangular segment sums,
    ``out[..., i, j] = sum_{j < t <= i} dA[..., t]``, -inf above the
    diagonal (masked before any ``exp``: above it the difference is
    positive and could overflow)."""
    Q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=dA.device).tril()
    return torch.where(mask, seg, torch.full_like(seg, float("-inf")))


def ssd_chunk_ref(xbar, dA, Bc, Cc):
    """xbar: (B,C,Q,H,P) dt-folded values; dA: (B,C,Q,H); Bc/Cc: (B,C,Q,N),
    all float32.

    Returns (y_diag (B,C,Q,H,P), states (B,C,H,P,N), chunk_decay (B,C,H))."""
    cumA = torch.cumsum(dA, dim=2)                            # (B,C,Q,H)
    L = torch.exp(segsum(dA.permute(0, 1, 3, 2)))             # (B,C,H,Q,Q)
    scores = torch.einsum("bcqn,bcsn->bcqs", Cc, Bc)
    y_diag = torch.einsum("bchqs,bcshp->bcqhp", scores[:, :, None] * L, xbar)
    decay_states = torch.exp(cumA[:, :, -1:, :] - cumA)       # (B,C,Q,H)
    states = torch.einsum("bcshp,bcsn->bchpn",
                          xbar * decay_states[..., None], Bc)
    chunk_decay = torch.exp(cumA[:, :, -1, :])
    return y_diag, states, chunk_decay
