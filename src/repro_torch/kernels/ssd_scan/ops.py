"""SSD chunk scan: the CUDA kernel's wrapper and the fused SSD forward
built on it.

``ssd_chunk`` launches ``csrc/ssd_chunk.cu`` for CUDA tensors and takes the
plain version (:mod:`.ref`) for CPU tensors; there is no fallback from one
to the other.  :mod:`.plan` names the body a call takes, from the shapes
and addresses, and sizes the tensor-core body's blocks and score scratch.
``ssd_chunk.launches`` counts the calls that launched the kernel (the
tensor-core body's two launches are one call, one count);
:func:`body_launches` counts each body's launches.
The raw wrapper records no backward and raises when grad mode is on and
an input requires grad; :class:`SsdChunk` is its differentiable form.
``ssd_chunked_fused`` is the torch twin of the JAX package's
``kernels/ssd_scan/ops.ssd_chunked_fused``: the intra-chunk part through
``ssd_chunk`` (through ``SsdChunk`` when an input requires grad) and the
inter-chunk recurrence (C steps over (B,H,P,N)) and ``y_off`` in torch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import plan
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref

_P, _I = ctypes.c_void_p, ctypes.c_int

# the kernel's limits (csrc/ssd_chunk.cu kMaxQ / kMaxP / kMaxN)
MAX_Q, MAX_P, MAX_N = 1024, 128, 256

_FNS = {}


def _entry(name, argtypes):
    """The C entry point ``name`` of the library, typed once."""
    f = _FNS.get(name)
    if f is None:
        f = getattr(_build.load("ssd_chunk"), name)
        f.argtypes = argtypes
        f.restype = _I
        _FNS[name] = f
    return f


def _fn():
    return _entry("ssd_chunk_launch", [_P] * 9 + [_I] * 5 + [_P])


# launches of each body by replayed CUDA graphs (kernels/counters.py)
REPLAYED = dict.fromkeys(plan.BODIES, 0)


def body_launches():
    """Launches of each device body since the library was loaded:
    ``{"fma": n, "tf32x3_states": n, "tf32x3_y": n}`` (the FMA body, and
    the tensor-core body's states-and-scores kernel and its y kernel, one
    each a call).  The difference across a call says which body it took.
    A replayed CUDA graph's launches are in it too (``REPLAYED``, which
    ``kernels/counters.py`` advances)."""
    got = (ctypes.c_longlong * len(plan.BODIES))()
    with _build.COUNT_LOCK:
        _entry("ssd_chunk_body_launches", [_P])(ctypes.addressof(got))
        return {k: n + REPLAYED[k] for k, n in zip(plan.BODIES, got)}


def split_heads(xbar, dA, split: int):
    """The inputs of a call over (H, P) heads as those of one over ``split
    * H`` heads of ``P / split`` columns (``plan.head_split``): xbar
    viewed (no copy; a head's parts lie side by side), each head's dA
    repeated for its parts."""
    if split == 1:
        return xbar, dA
    B, C, Q, H, P = xbar.shape
    return (xbar.view(B, C, Q, H * split, P // split),
            dA.repeat_interleave(split, dim=3))


def join_heads(y, states, decay, split: int):
    """The outputs of a call on :func:`split_heads`' inputs as those of the
    unsplit call: y (B,C,Q,H,P) and states (B,C,H,P,N) reshaped (views of
    the kernel's contiguous outputs: a head's parts' columns lie in
    order), the decay of each head's first part."""
    if split == 1:
        return y, states, decay
    B, C, Q, H, P = y.shape
    N = states.shape[-1]
    return (y.reshape(B, C, Q, H // split, P * split),
            states.reshape(B, C, H // split, P * split, N),
            decay[..., ::split])


def ssd_chunk(xbar, dA, Bc, Cc):
    """Intra-chunk SSD.  xbar: (B,C,Q,H,P); dA: (B,C,Q,H); Bc/Cc: (B,C,Q,N),
    all float32 and contiguous.  Returns (y_diag (B,C,Q,H,P), states
    (B,C,H,P,N), chunk_decay (B,C,H)), float32.  A head of 128 columns
    takes the tensor-core body as two heads of 64 (:func:`split_heads`,
    :func:`join_heads`), one launch."""
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
    score, heads, split = None, None, 1
    if plan.body(Q, P, N, [t.data_ptr() for t in (xbar, Bc, Cc)]) == "tf32x3":
        split = plan.head_split(P)
        H, P = H * split, P // split
        score = torch.empty(plan.score_floats(B * C, Q), dtype=torch.float32,
                            device=dev)
        groups = plan.heads_per_block(B * C, Q, H)
        heads = (ctypes.c_int * len(groups))(*groups)
    xbar, dA = split_heads(xbar, dA, split)
    # fresh outputs: the allocator aligns them to 512 bytes
    y = torch.empty_like(xbar)
    st = torch.empty((B, C, H, P, N), dtype=torch.float32, device=dev)
    dk = torch.empty((B, C, H), dtype=torch.float32, device=dev)
    fn = _fn()
    with _build.COUNT_LOCK:
        err = fn(xbar.data_ptr(), dA.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
                 y.data_ptr(), st.data_ptr(), dk.data_ptr(),
                 None if score is None else score.data_ptr(),
                 None if heads is None else ctypes.addressof(heads), B * C, Q,
                 H, P, N, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "ssd_chunk")
        ssd_chunk.launches += 1
    return join_heads(y, st, dk, split)


ssd_chunk.launches = 0


class SsdChunk(torch.autograd.Function):
    """Differentiable ``ssd_chunk``: ``SsdChunk.apply(xbar, dA, Bc, Cc)``.
    The forward launches the kernel (the plain version on the CPU) and
    saves its inputs; the backward recomputes ``ssd_chunk_ref`` under grad
    mode and returns its gradients, as the JAX package, which has no
    backward kernel, differentiates its jnp scan.  The recompute
    materializes the (Q, Q) decay of every head, as the plain version
    does."""

    @staticmethod
    def forward(ctx, xbar, dA, Bc, Cc):
        ctx.save_for_backward(xbar, dA, Bc, Cc)
        return ssd_chunk(xbar, dA, Bc, Cc)

    @staticmethod
    def backward(ctx, g_y, g_states, g_decay):
        with torch.enable_grad(), torch.profiler.record_function(
                "ssd_chunk.backward_plain"):
            ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            outs = ssd_chunk_ref(*ins)
            return torch.autograd.grad(outs, ins, (g_y, g_states, g_decay))


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
    xbar = xbar.contiguous()
    if not use_kernel:
        intra = ssd_chunk_ref
    elif torch.is_grad_enabled() and any(
            t.requires_grad for t in (xbar, dA, Bc, Cc)):
        intra = SsdChunk.apply
    else:
        intra = ssd_chunk
    y_diag, states, chunk_decay = intra(xbar, dA, Bc, Cc)

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
