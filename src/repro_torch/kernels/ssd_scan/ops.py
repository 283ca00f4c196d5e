"""SSD chunk scan: the CUDA kernel's wrapper and the fused SSD forward
built on it.

``ssd_chunk`` launches ``csrc/ssd_chunk.cu`` for CUDA tensors and takes the
plain version (:mod:`.ref`) for CPU tensors; there is no fallback from one
to the other.  ``ssd_chunk.launches`` counts kernel launches.
``ssd_chunked_fused`` is the torch twin of the JAX package's
``kernels/ssd_scan/ops.ssd_chunked_fused``: the intra-chunk part through
``ssd_chunk`` and the inter-chunk recurrence (C steps over (B,H,P,N)) and
``y_off`` in torch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref

_P, _I = ctypes.c_void_p, ctypes.c_int

# the kernel's limits (csrc/ssd_chunk.cu kMaxQ / kMaxP / kMaxN)
MAX_Q, MAX_P, MAX_N = 1024, 128, 256


def _fn():
    f = _build.load("ssd_chunk").ssd_chunk_launch
    f.argtypes = [_P] * 7 + [_I] * 5 + [_P]
    f.restype = _I
    return f


def ssd_chunk(xbar, dA, Bc, Cc):
    """Intra-chunk SSD.  xbar: (B,C,Q,H,P); dA: (B,C,Q,H); Bc/Cc: (B,C,Q,N),
    all float32 and contiguous.  Returns (y_diag (B,C,Q,H,P), states
    (B,C,H,P,N), chunk_decay (B,C,H)), float32."""
    _build.refuse_grad("ssd_chunk", xbar, dA, Bc, Cc)
    if not xbar.is_cuda:
        return ssd_chunk_ref(xbar, dA, Bc, Cc)
    if xbar.dim() != 5:
        raise ValueError(f"ssd_chunk: xbar must be (B,C,Q,H,P), got "
                         f"{tuple(xbar.shape)}")
    B, C, Q, H, P = xbar.shape
    N = Bc.shape[-1]
    want = {"xbar": (B, C, Q, H, P), "dA": (B, C, Q, H), "Bc": (B, C, Q, N),
            "Cc": (B, C, Q, N)}
    for name, t in (("xbar", xbar), ("dA", dA), ("Bc", Bc), ("Cc", Cc)):
        if t.device != xbar.device or tuple(t.shape) != want[name]:
            raise ValueError(f"ssd_chunk: {name} {tuple(t.shape)} on "
                             f"{t.device}, want {want[name]} on {xbar.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_chunk: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_chunk: {name} must be contiguous")
    if Q > MAX_Q or P > MAX_P or N > MAX_N:
        raise ValueError(f"ssd_chunk kernel takes Q <= {MAX_Q}, P <= {MAX_P}, "
                         f"N <= {MAX_N} (got Q={Q}, P={P}, N={N})")
    dev = xbar.device
    y = torch.empty_like(xbar)
    st = torch.empty((B, C, H, P, N), dtype=torch.float32, device=dev)
    dk = torch.empty((B, C, H), dtype=torch.float32, device=dev)
    err = _fn()(xbar.data_ptr(), dA.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
                y.data_ptr(), st.data_ptr(), dk.data_ptr(), B * C, Q, H, P, N,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ssd_chunk")
    ssd_chunk.launches += 1
    return y, st, dk


ssd_chunk.launches = 0


def ssd_chunked_fused(x, dt, A, Bmat, Cmat, *, chunk: int = 128,
                      initial_state=None, use_kernel: bool = True):
    """x: (B,S,H,P); dt: (B,S,H); A: (H,); Bmat/Cmat: (B,S,N); S a multiple
    of ``chunk``.  Returns (y (B,S,H,P) in x's dtype, final_state (B,H,P,N)
    float32).  ``use_kernel=False`` runs the plain ``ssd_chunk_ref`` on any
    device (the reference path the kernel is held against on the card)."""
    Bsz, S, H, P = x.shape
    N = Bmat.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {chunk}")
    C = S // chunk
    dtf = dt.float()
    dA = (dtf * A.float()).reshape(Bsz, C, chunk, H).contiguous()
    xbar = (x.float() * dtf[..., None]).reshape(Bsz, C, chunk, H, P)
    Bc = Bmat.float().reshape(Bsz, C, chunk, N).contiguous()
    Cc = Cmat.float().reshape(Bsz, C, chunk, N).contiguous()
    intra = ssd_chunk if use_kernel else ssd_chunk_ref
    y_diag, states, chunk_decay = intra(xbar.contiguous(), dA, Bc, Cc)

    s = (initial_state.float() if initial_state is not None
         else torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                          device=x.device))
    prev = []                                  # state before each chunk
    for c in range(C):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)     # (B,C,H,P,N)

    cumA = torch.cumsum(dA, dim=2)
    y_off = (torch.einsum("bcqn,bchpn->bcqhp", Cc, prev_states)
             * torch.exp(cumA)[..., None])
    y = (y_diag + y_off).reshape(Bsz, S, H, P)
    return y.to(x.dtype), s
