"""Mamba-2 (SSD — state-space duality) block in PyTorch.

The torch rewrite of ``repro.models.mamba2``: the chunked SSD algorithm
[arXiv:2405.21060] for prefill and the O(1) recurrent step for decode,
ngroups=1 (B/C shared across heads), with the reference's dtypes step by
step: the prefill conv runs in the working dtype, the decode conv in
float32 cast back, the SSM state in float32.

Shapes:  x (B,S,H,P), dt (B,S,H), A (H,), Bmat/Cmat (B,S,N).
State:   ssm (B,H,P,N) float32, conv (B,W-1,di+2N).

``use_kernel`` (default True) sends the gate RMSNorm and the SSD chunk
step to their kernel wrappers, which launch the CUDA kernels for CUDA
tensors and take the plain versions for CPU tensors; False runs the plain
versions on any device.

Under tensor parallelism (a mesh whose ``model`` axis has m > 1 ranks) a
block's parameters are the rank's heads (``distributed/sharding.py``:
``in_proj`` columns z and x of its heads, ``even_blocks(H, m)``: H/m
where m divides H, else 26, 27 and 27 of 80 on 3 ranks; B and C whole,
dt of its heads; the conv's channels likewise; its heads of ``A_log``,
``D_skip``, ``dt_bias``, of the gated norm's scale and of ``out_proj``'s
rows).  The block then takes its input through ``copy_to``, runs the
conv, the SSD scan and the recurrent step on its heads (B and C on every
rank), the gated norm over ``d_inner`` in its split form (the sum of
squares summed over the ranks) and ``out_proj``'s partial sum through
``reduce_from``.  The sizes come from the parameters, so one code path
serves one device and a rank, whatever its count of heads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.ctx import axis_index, copy_to, reduce_from
from repro_torch.kernels.ssd_scan import ssd_chunked_fused
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _dense_init, apply_norm, init_norm

# ------------------------------------------------------------------ SSD core


def ssd_chunked(x, dt, A, Bmat, Cmat, *, chunk: int, initial_state=None,
                use_kernel: bool = True):
    """Chunked SSD scan.  Returns (y, final_state).

    x: (B,S,H,P) values; dt: (B,S,H) positive step sizes; A: (H,) negative;
    Bmat/Cmat: (B,S,N).  final_state: (B,H,P,N) float32.

    Where the reference falls back to the largest divisor of S as the chunk
    (chunks of 1 for a prime S), this pads S up to a multiple of
    ``min(chunk, S)`` with rows whose ``dt`` is 0: such a row adds nothing
    to any state and decays nothing, so ``y`` and the final state are
    unchanged in exact arithmetic.
    """
    Bsz, S, H, P = x.shape
    Q = max(1, min(chunk, S))
    pad = -S % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bmat = F.pad(Bmat, (0, 0, 0, pad))
        Cmat = F.pad(Cmat, (0, 0, 0, pad))
    y, state = ssd_chunked_fused(x, dt, A, Bmat, Cmat, chunk=Q,
                                 initial_state=initial_state,
                                 use_kernel=use_kernel)
    return y[:, :S], state


def ssd_decode_step(state, x, dt, A, Bmat, Cmat):
    """One recurrent step.  x:(B,H,P) dt:(B,H) Bmat/Cmat:(B,N)
    state:(B,H,P,N) float32."""
    dtf = dt.float()
    dA = torch.exp(dtf * A.float())                                 # (B,H)
    dBx = (dtf[:, :, None, None] * Bmat.float()[:, None, None, :]
           * x.float()[..., None])                                  # (B,H,P,N)
    new_state = state * dA[..., None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", Cmat.float(), new_state)
    return y.to(x.dtype), new_state


# -------------------------------------------------------------- Mamba2 block

def init_mamba_block(cfg: ArchConfig, gen: torch.Generator, dtype,
                     device=None):
    """Random block parameters drawn on ``device`` from ``gen``, with the
    reference's scales and constants (A = -exp(0) = -1, D = 1, dt bias 0)."""
    D, di, N, H, W = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                      cfg.ssm_heads, cfg.conv_width)
    conv_ch = di + 2 * N
    f32 = torch.float32
    return {
        "in_proj": _dense_init(gen, (D, 2 * di + 2 * N + H), dtype=dtype,
                               device=device),
        "conv_w": _dense_init(gen, (W, conv_ch), scale=0.5, dtype=dtype,
                              device=device),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.zeros((H,), dtype=f32, device=device),
        "D_skip": torch.ones((H,), dtype=f32, device=device),
        "dt_bias": torch.zeros((H,), dtype=f32, device=device),
        "gate_norm": init_norm(cfg, di, dtype, device),
        "out_proj": _dense_init(gen, (di, D), dtype=dtype, device=device),
    }


def _sizes(cfg: ArchConfig, p):
    """``(di, N, H, P)`` of the block ``p``: its heads (a rank's share
    of them, all of them on one device), their ``di = H P`` columns, the
    state size and the head dim."""
    H = p["A_log"].shape[0]
    return H * cfg.ssm_headdim, cfg.ssm_state, H, cfg.ssm_headdim


def _shared_bc(w, lo: int, hi: int):
    """``w`` whose columns ``[lo, hi)`` (B and C, held whole by every
    ``model`` rank) take the sum of the ranks' gradients (each rank's B and
    C feed only its heads), when gradients flow and the axis has more
    than one rank; else ``w`` itself."""
    if not (torch.is_grad_enabled() and w.requires_grad) or \
            axis_index("model")[1] == 1:
        return w
    return torch.cat([w[..., :lo], copy_to(w[..., lo:hi], "model"),
                      w[..., hi:]], dim=-1)


def _split_proj(cfg: ArchConfig, zxbcdt, H: int):
    di, N = H * cfg.ssm_headdim, cfg.ssm_state
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * N]
    dt = zxbcdt[..., di + di + 2 * N:]
    if dt.shape[-1] != H:
        raise ValueError(f"in_proj width gives {dt.shape[-1]} dt heads, "
                         f"want {H}")
    return z, xBC, dt


def _project(cfg: ArchConfig, p, x, di: int, N: int):
    """``x @ in_proj`` (replicated ``x`` for the rank's columns) and the
    conv's weight and bias, B and C's gradients summed over ``model``."""
    x = copy_to(x, "model")
    zxbcdt = x @ _shared_bc(p["in_proj"], 2 * di, 2 * di + 2 * N)
    return (zxbcdt, _shared_bc(p["conv_w"], di, di + 2 * N),
            _shared_bc(p["conv_b"], di, di + 2 * N))


def _causal_conv(xBC, w, b, initial=None):
    """Depthwise causal conv in xBC's dtype.  xBC:(B,S,Ch), w:(W,Ch),
    initial:(B,W-1,Ch).  Returns (silu(conv + b), last W-1 input rows)."""
    W = w.shape[0]
    S = xBC.shape[1]
    pad = (initial if initial is not None
           else torch.zeros((xBC.shape[0], W - 1, xBC.shape[-1]),
                            dtype=xBC.dtype, device=xBC.device))
    xp = torch.cat([pad.to(xBC.dtype), xBC], dim=1)         # (B, S+W-1, Ch)
    out = xp[:, 0:S, :] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S, :] * w[i]
    new_state = xp[:, xp.shape[1] - (W - 1):, :]
    return F.silu(out + b), new_state


def mamba_block(cfg: ArchConfig, p, x, *, chunk: int = 256, initial=None,
                return_state: bool = False, use_kernel: bool = True):
    """Full-sequence Mamba-2 mixer.  x: (B,S,D) -> (B,S,D) (and the final
    ``{"conv", "ssm"}`` state when ``return_state``)."""
    Bsz, S, D = x.shape
    di, N, H, P = _sizes(cfg, p)
    zxbcdt, conv_w, conv_b = _project(cfg, p, x, di, N)
    z, xBC, dt = _split_proj(cfg, zxbcdt, H)
    conv_init = initial["conv"] if initial is not None else None
    xBC, conv_state = _causal_conv(xBC, conv_w, conv_b, conv_init)
    xs = xBC[..., :di].reshape(Bsz, S, H, P)
    Bmat = xBC[..., di:di + N]
    Cmat = xBC[..., di + N:]
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    ssm_init = initial["ssm"] if initial is not None else None
    y, ssm_state = ssd_chunked(xs, dt, A, Bmat, Cmat, chunk=min(chunk, S),
                               initial_state=ssm_init, use_kernel=use_kernel)
    y = y + xs * p["D_skip"][None, None, :, None].to(y.dtype)
    y = y.reshape(Bsz, S, di)
    y = apply_norm(cfg, p["gate_norm"], y * F.silu(z), use_kernel=use_kernel,
                   over_model=True)
    out = reduce_from(y @ p["out_proj"], "model")
    if return_state:
        return out, {"conv": conv_state, "ssm": ssm_state}
    return out


def mamba_decode_step(cfg: ArchConfig, p, x, state, *,
                      use_kernel: bool = True):
    """One-token decode.  x: (B,D); state: {conv:(B,W-1,Ch), ssm:(B,H,P,N)}.
    Returns (out (B,D), new state); the inputs are not modified."""
    Bsz, D = x.shape
    di, N, H, P = _sizes(cfg, p)
    zxbcdt, conv_w, conv_b = _project(cfg, p, x, di, N)
    z, xBC, dt = _split_proj(cfg, zxbcdt, H)
    # conv: shift register, in float32
    window = torch.cat([state["conv"], xBC[:, None, :].to(state["conv"].dtype)],
                       dim=1)                                      # (B,W,Ch)
    out = torch.einsum("bwc,wc->bc", window.float(), conv_w.float())
    xBC = F.silu(out + conv_b.float()).to(x.dtype)
    new_conv = window[:, 1:, :]
    xs = xBC[..., :di].reshape(Bsz, H, P)
    Bmat = xBC[..., di:di + N]
    Cmat = xBC[..., di + N:]
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, new_ssm = ssd_decode_step(state["ssm"], xs, dt, A, Bmat, Cmat)
    y = y + xs * p["D_skip"][None, :, None].to(y.dtype)
    y = y.reshape(Bsz, di)
    y = apply_norm(cfg, p["gate_norm"], y * F.silu(z), use_kernel=use_kernel,
                   over_model=True)
    return (reduce_from(y @ p["out_proj"], "model"),
            {"conv": new_conv, "ssm": new_ssm})


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype=torch.bfloat16,
                   device=None):
    di, N, H, P, W = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                      cfg.ssm_headdim, cfg.conv_width)
    return {"conv": torch.zeros((batch, W - 1, di + 2 * N), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32,
                               device=device)}
