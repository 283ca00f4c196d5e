"""Composable model layers, attention-family subset: norms (RMSNorm through
the fused kernel), RoPE, GQA attention (full / chunked through the flash
kernel / decode), dense FFN, capacity-based (GShard) MoE.

Everything is a plain function over an explicit parameter dict, mirroring
``repro.models.layers`` so each function can be checked against its jnp
twin on the same inputs.  Initialisers draw from an explicit
``torch.Generator`` on the target device (no global RNG state).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.ctx import (_active, all_reduce_sum, all_sum,
                                        axis_index, copy_to,
                                        copy_to_replicas, gather_counts,
                                        reduce_from)
from repro_torch.kernels.flash_prefill import FlashPrefill
from repro_torch.kernels.fused_rmsnorm import (FusedRMSNorm, RMSNormApply,
                                               RMSNormSumsq, fused_rmsnorm,
                                               rmsnorm_apply,
                                               rmsnorm_apply_ref,
                                               rmsnorm_ref, rmsnorm_sumsq,
                                               rmsnorm_sumsq_ref)
from repro_torch.models.config import ArchConfig

# --------------------------------------------------------------------- init


def _dense_init(gen: torch.Generator, shape, scale=None,
                dtype=torch.float32, device=None):
    """Normal init scaled by 1/sqrt(fan_in) (embeddings pass 0.02), drawn
    in float32 on ``device`` then cast, as ``layers._dense_init``."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / (fan_in ** 0.5)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def init_norm(cfg: ArchConfig, dim: int, dtype, device=None):
    p = {"scale": torch.ones((dim,), dtype=dtype, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=dtype, device=device)
    return p


def apply_norm(cfg: ArchConfig, p, x, eps: float = 1e-5, *,
               use_kernel: bool = True, over_model: bool = False):
    """RMSNorm or LayerNorm over the last axis, in float32, returned in x's
    dtype.  RMSNorm goes through the fused kernel (the CUDA kernel for a
    CUDA tensor, its plain version for a CPU tensor) over x viewed as
    (rows, d): through its autograd Function when grad mode is on and an
    input requires grad, else through the raw wrapper, which costs less
    host time per call (the decode steps); ``use_kernel=False`` takes the
    plain version on any device.  LayerNorm stays plain.

    ``over_model``: x holds this rank's columns of rows of ``d_inner``
    split over the ``model`` axis (Mamba-2's gated norm, each rank holding
    its heads' columns, as many as its heads: the ranks may hold unequal
    widths).  Where that axis has more than one rank the norm takes the
    split form (:func:`_split_rmsnorm`) over the config's ``d_inner``;
    elsewhere it is the norm above, bit for bit."""
    if cfg.norm_type != "layernorm":
        rows = x.reshape(-1, x.shape[-1]).contiguous()
        scale = p["scale"]
        m = axis_index("model")[1] if over_model else 1
        if m > 1:
            y = _split_rmsnorm(rows, scale, cfg.d_inner, eps, use_kernel)
        elif not use_kernel:
            y = rmsnorm_ref(rows, scale, eps)
        elif torch.is_grad_enabled() and (rows.requires_grad
                                          or scale.requires_grad):
            y = FusedRMSNorm.apply(rows, scale, eps)
        else:
            y = fused_rmsnorm(rows, scale, eps)
        return y.reshape(x.shape)
    if over_model and axis_index("model")[1] > 1:
        raise ValueError("a LayerNorm over columns split over 'model' is "
                         "not executed")
    xf = x.float()
    xf = xf - xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def _split_rmsnorm(rows, scale, d_full: int, eps: float, use_kernel: bool):
    """RMSNorm of rows whose ``d_full`` columns lie on the ``model`` ranks,
    ``rows`` (T, d) and ``scale`` (d,) this rank's: each rank's float32
    sum of squares, summed over the ranks (:func:`ctx.all_sum`, whose
    gradient is summed too), then each rank's scale-and-store from the
    sum.  Row 7's split entries (``rmsnorm_sumsq``, ``rmsnorm_apply``)
    through their autograd Functions when an input requires grad, their
    raw wrappers otherwise, or their plain twins with ``use_kernel``
    off."""
    if not use_kernel:
        total = all_sum(rmsnorm_sumsq_ref(rows), "model")
        return rmsnorm_apply_ref(rows, total, scale, d_full, eps)
    if torch.is_grad_enabled() and (rows.requires_grad
                                    or scale.requires_grad):
        total = all_sum(RMSNormSumsq.apply(rows), "model")
        return RMSNormApply.apply(rows, total, scale, d_full, eps)
    total = all_sum(rmsnorm_sumsq(rows), "model")
    return rmsnorm_apply(rows, total, scale, d_full, eps)


# --------------------------------------------------------------------- RoPE

def rope_freqs(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x, positions, theta: float):
    """x: (..., S, hd) with matching positions (..., S) or (S,).  Split-
    halves rotation (not interleaved)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    angles = positions[..., None].float() * freqs            # (..., S, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention

def init_attention(cfg: ArchConfig, gen, dtype, device=None):
    D, H, KVH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    p = {
        "wq": _dense_init(gen, (D, H * hd), dtype=dtype, device=device),
        "wk": _dense_init(gen, (D, KVH * hd), dtype=dtype, device=device),
        "wv": _dense_init(gen, (D, KVH * hd), dtype=dtype, device=device),
        "wo": _dense_init(gen, (H * hd, D), dtype=dtype, device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((KVH * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((KVH * hd,), dtype=dtype, device=device)
    return p


def pad_heads(t, n: int):
    """``t`` (B, S, h, hd) with zero heads after its h up to ``n`` (``t``
    itself where it has them)."""
    return F.pad(t, (0, 0, 0, n - t.shape[2])) if n > t.shape[2] else t


def _project_qkv(cfg: ArchConfig, p, x, positions, rope: bool = True,
                 heads=None):
    """q (B, S, H, hd), k and v (B, S, KVH, hd) of x (B, S, D); the head
    counts are the projections' (a rank's H/m and KVH/m under tensor
    parallelism, whose column-parallel products take ``copy_to(x)``).
    ``heads`` (``Model.heads``: a rank's query and KV head slots and the
    ranks each KV head is on) pads q, k and v with zero heads to the
    rank's slots, and sums the gradients of ``wk``/``wv`` (``bk``/``bv``)
    over the ranks that hold the same KV head."""
    B, S, _ = x.shape
    hd = cfg.hd
    x = copy_to(x, "model")
    rep = heads[2] if heads else 1
    q = x @ p["wq"]
    k = x @ copy_to_replicas(p["wk"], rep)
    v = x @ copy_to_replicas(p["wv"], rep)
    if cfg.qkv_bias:
        q, k, v = (q + p["bq"], k + copy_to_replicas(p["bk"], rep),
                   v + copy_to_replicas(p["bv"], rep))
    q = q.reshape(B, S, q.shape[-1] // hd, hd)
    k = k.reshape(B, S, k.shape[-1] // hd, hd)
    v = v.reshape(B, S, v.shape[-1] // hd, hd)
    if rope:
        pos = positions[:, None, :]
        q = apply_rope(q.transpose(1, 2), pos, cfg.rope_theta).transpose(1, 2)
        k = apply_rope(k.transpose(1, 2), pos, cfg.rope_theta).transpose(1, 2)
    if heads:
        q, k, v = (pad_heads(q, heads[0]), pad_heads(k, heads[1]),
                   pad_heads(v, heads[1]))
    return q, k, v


def full_attention(cfg: ArchConfig, q, k, v, *, causal: bool,
                   q_positions=None, kv_positions=None):
    """Reference (materialized-scores) attention.  q:(B,S,H,hd)
    k/v:(B,T,KVH,hd)."""
    B, S, H, hd = q.shape
    T, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qg = q.reshape(B, S, KVH, G, hd)
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    if causal:
        dev = q.device
        qpos = (q_positions if q_positions is not None
                else torch.arange(S, device=dev)[None].expand(B, S))
        kpos = (kv_positions if kv_positions is not None
                else torch.arange(T, device=dev)[None].expand(B, T))
        mask = kpos[:, None, None, None, :] <= qpos[:, None, None, :, None]
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


def chunked_attention(cfg: ArchConfig, q, k, v, *, causal: bool,
                      q_chunk: int = 1024, kv_chunk: int = 1024,
                      use_kernel: bool = True):
    """Full-sequence attention without the S x T score matrix.
    q:(B,S,H,hd) k/v:(B,T,KVH,hd) -> (B,S,H,hd) in q's dtype.

    For CUDA tensors (and ``use_kernel``) it runs the flash kernel through
    :class:`FlashPrefill` over (B, H, S, hd) views (strided, no copy),
    which needs T == S; meta tensors take the same Function (its plain
    version inside), so that a dry run saves for the backward what the
    card's path saves.  Otherwise it is the plain online-softmax version
    of ``layers.chunked_attention``: query chunks, each walking the kv
    chunks with a running (max, sum, acc), queries padded to a chunk
    multiple and padded keys masked by the original T.  The chunk sizes
    only shape the plain version; the kernel tiles by itself."""
    if use_kernel and (q.is_cuda or q.is_meta):
        out = FlashPrefill.apply(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal)
        return out.transpose(1, 2)
    B, S, H, hd = q.shape
    T, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    q_chunk, kv_chunk = min(q_chunk, S), min(kv_chunk, T)
    S_orig, T_orig = S, T
    if S % q_chunk:                      # pad queries to a chunk multiple
        q = F.pad(q, (0, 0, 0, 0, 0, -S % q_chunk))
        S = q.shape[1]
    if T % kv_chunk:                     # pad keys/values; masked out below
        k = F.pad(k, (0, 0, 0, 0, 0, -T % kv_chunk))
        v = F.pad(v, (0, 0, 0, 0, 0, -T % kv_chunk))
        T = k.shape[1]
    nq, nk = S // q_chunk, T // kv_chunk
    scale = 1.0 / (hd ** 0.5)
    dev = q.device
    qg = q.reshape(B, nq, q_chunk, KVH, G, hd).permute(1, 0, 3, 4, 2, 5)
    kc = k.reshape(B, nk, kv_chunk, KVH, hd).permute(1, 0, 3, 2, 4)
    vc = v.reshape(B, nk, kv_chunk, KVH, hd).permute(1, 0, 3, 2, 4)
    outs = []
    for qi in range(nq):                 # (B, KVH, G, Cq, hd) per chunk
        qb = qg[qi].float()
        m = torch.full((B, KVH, G, q_chunk), float("-inf"), device=dev)
        lsum = torch.zeros((B, KVH, G, q_chunk), device=dev)
        acc = torch.zeros((B, KVH, G, q_chunk, hd), device=dev)
        qpos = qi * q_chunk + torch.arange(q_chunk, device=dev)
        for kj in range(nk):
            s = torch.einsum("bkgqd,bkcd->bkgqc", qb, kc[kj].float()) * scale
            kpos = kj * kv_chunk + torch.arange(kv_chunk, device=dev)
            ok = (kpos < T_orig)[None, :]                 # mask kv padding
            if causal:
                ok = ok & (kpos[None, :] <= qpos[:, None])
            s = torch.where(ok, s, torch.full_like(s, -1e30))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            lsum = lsum * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqc,bkcd->bkgqd", p, vc[kj].float())
            m = m_new
        outs.append(acc / torch.clamp(lsum, min=1e-30)[..., None])
    # (nq, B, KVH, G, Cq, hd) -> (B, S, H, hd)
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, S, H, hd)
    return out[:, :S_orig].to(q.dtype)


def decode_attention(cfg: ArchConfig, q, k_cache, v_cache, lengths,
                     over=None):
    """Single-token decode.  q:(B,H,hd), caches:(B,Smax,KVH,hd), lengths:(B,)
    = number of valid cached tokens (including the token just written).

    ``over`` names the logical axis whose ranks each hold a block of the
    positions (``"seq"``, flash-decoding's context split; ``lengths`` then
    counts this rank's valid ones, 0 where it has none): each rank's
    partial softmax in float32 (scores against the ranks' common row
    maximum, one max all-reduce; its weighted V and sum of exponentials)
    is summed over them (one sum all-reduce).  Both are the identity
    without ``over`` or over an axis of one rank."""
    B, H, hd = q.shape
    Smax, KVH = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    mesh, axes = _active(over)
    qg = q.reshape(B, KVH, G, hd)
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) * scale
    valid = (torch.arange(Smax, device=q.device)[None, :]
             < lengths.long()[:, None])                         # (B, Smax)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, -1e30))
    top = all_reduce_sum(s.amax(-1), axes, mesh, op="max")      # (B, KVH, G)
    p = torch.exp(s - top[..., None])
    part = torch.cat([torch.einsum("bkgs,bskd->bkgd", p, v_cache.float()),
                      p.sum(-1)[..., None]], dim=-1)
    total = all_reduce_sum(part, axes, mesh)
    o = total[..., :hd] / total[..., hd:]
    return o.reshape(B, H, hd).to(q.dtype)


# --------------------------------------------------------------------- FFN

def init_ffn(cfg: ArchConfig, gen, dtype, device=None):
    D, Fd = cfg.d_model, cfg.d_ff
    p = {"wi": _dense_init(gen, (D, Fd), dtype=dtype, device=device),
         "wo": _dense_init(gen, (Fd, D), dtype=dtype, device=device)}
    if cfg.act == "swiglu":
        p["wg"] = _dense_init(gen, (D, Fd), dtype=dtype, device=device)
    return p


def _act(cfg: ArchConfig, h, g=None):
    if cfg.act == "swiglu":
        return F.silu(g) * h
    if cfg.act == "gelu":
        return F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    return F.relu(h)


def apply_ffn(cfg: ArchConfig, p, x):
    """The dense FFN.  Under tensor parallelism ``wi``/``wg`` hold a
    rank's columns and ``wo`` its rows: the product of the rank's d_ff/m
    is a partial sum, all-reduced over ``model``."""
    x = copy_to(x, "model")
    h = x @ p["wi"]
    g = x @ p["wg"] if cfg.act == "swiglu" else None
    return reduce_from(_act(cfg, h, g) @ p["wo"], "model")


# --------------------------------------------------------------------- MoE

def init_moe(cfg: ArchConfig, gen, dtype, device=None,
             pad_experts_to: int = 0, experts=None):
    """Router (D, E_alloc) in float32 whatever ``dtype`` is, and the
    experts' ``wi``/``wg`` (E_held, D, F) and ``wo`` (E_held, F, D) in
    ``dtype``; ``pad_experts_to`` allocates padding experts the router
    never picks.  ``experts=(lo, hi)`` holds experts ``[lo, hi)`` only (a
    device's share under the reference's expert parallelism, whose
    ``distributed/sharding.py`` shards the expert axis of ``wi``/``wg``/
    ``wo``); the router stays whole.  Default: every expert."""
    D, Fd = cfg.d_model, cfg.d_ff
    E_alloc = max(cfg.num_experts, pad_experts_to)
    lo, hi = experts or (0, E_alloc)
    p = {
        "router": _dense_init(gen, (D, E_alloc), scale=0.02,
                              dtype=torch.float32, device=device),
        "wi": _dense_init(gen, (hi - lo, D, Fd), dtype=dtype, device=device),
        "wo": _dense_init(gen, (hi - lo, Fd, D), dtype=dtype, device=device),
    }
    if cfg.act == "swiglu":
        p["wg"] = _dense_init(gen, (hi - lo, D, Fd), dtype=dtype,
                              device=device)
    return p


def _onehot(idx, n: int):
    """float32 one-hot over the last axis by comparison with ``arange``
    (``F.one_hot`` checks its range on the host, a sync on CUDA)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _route(cfg: ArchConfig, p, xf):
    """Router: softmax in float32 over the real experts (padded slots
    masked to -1e30), top-k, weights renormalised to sum 1.  Returns
    ``(gate_w, gate_idx, aux_loss, E_alloc)``; the aux loss is the
    load-balancing term ``E * sum(density * mean prob)``, density counted
    on each token's first choice.  On a mesh whose batch axes split the
    tokens both means are over every rank's tokens (equal counts a
    rank), as the whole batch's."""
    E = cfg.num_experts
    logits = xf.float() @ p["router"]
    E_alloc = logits.shape[-1]
    if E_alloc > E:
        pad = torch.arange(E_alloc, device=logits.device) >= E
        logits = torch.where(pad, torch.full_like(logits, -1e30), logits)
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    lead = tuple(range(gate_idx.dim() - 1))
    density = _onehot(gate_idx[..., 0], E_alloc).mean(dim=lead)
    density_proxy = probs.mean(dim=lead)
    nb = axis_index("batch")[1]
    if nb > 1:
        density = reduce_from(density, "batch") / nb
        density_proxy = reduce_from(density_proxy, "batch") / nb
    aux_loss = E * torch.sum(density * density_proxy)
    return gate_w, gate_idx, aux_loss, E_alloc


def _dispatch_plan(flat_idx, E_alloc: int, capacity: int, before=None,
                   limit=None):
    """Each flat ``(token, k)`` assignment's destination row and whether it
    was kept: in token-major order an assignment takes the next free of
    its expert's ``capacity`` rows (position by a cumsum over a float32
    one-hot, as the reference counts); past capacity it goes to the drop
    row ``E_alloc * capacity``.  flat_idx: (G, T*K).  Where the group's
    earlier tokens lie on other ranks, ``before`` (E_alloc,) counts their
    assignments to each expert; ``limit`` (default ``capacity``) is the
    group's capacity: an assignment is kept while its position in the
    whole group is below ``limit``, and takes its row by its position
    here.  Returns ``(dest,
    keep)``, int64 and bool (G, T*K)."""
    onehot = _onehot(flat_idx, E_alloc)                          # (G,TK,E)
    pos_in_e = ((torch.cumsum(onehot, dim=1) * onehot).sum(-1)
                - 1.0).to(torch.int64)
    ahead = pos_in_e if before is None else pos_in_e + before[flat_idx]
    keep = ahead < (capacity if limit is None else limit)
    dest = torch.where(keep, flat_idx * capacity + pos_in_e,
                       torch.full_like(flat_idx, E_alloc * capacity))
    return dest, keep


def _dispatch_compute_combine(cfg, p, xg, gate_w, gate_idx, E_alloc,
                              capacity, experts=None, before=None,
                              limit=None):
    """Grouped capacity dispatch (:func:`_dispatch_plan` per group), the
    held experts as one batched product over (E_held, capacity) rows (so
    every held expert's weights are read), and the combine: each token's
    kept outputs weighted by its gates and summed over k in xg's dtype; a
    dropped assignment contributes 0.  ``experts=(lo, hi)`` (default every
    expert) names the held experts, ``p``'s ``wi``/``wg``/``wo`` rows: the
    plan is the whole layer's (every expert's capacity counted over every
    assignment, in token-major order), and an assignment to an expert
    outside ``[lo, hi)`` contributes 0 here, as it would on the device
    that holds its expert.  ``before`` and ``limit``: the group's
    assignments on earlier ranks and its capacity (:func:`_dispatch_plan`;
    ``capacity`` sizes the rows).

    xg: (G, Tg, D); gate_*: (G, Tg, K).  Returns ``(y (G, Tg, D) in xg's
    dtype, keep (G, Tg*K) bool)``, ``keep`` over every expert.  Every
    shape is static and nothing reads a value back to the host, so the
    block can be captured in a CUDA graph."""
    G, Tg, D = xg.shape
    K = cfg.top_k
    lo, hi = experts or (0, E_alloc)
    xg = copy_to(xg, "model")           # the experts' input (EP: a share)
    gate_w = copy_to(gate_w, "model")
    rows = (hi - lo) * capacity            # the held experts' rows
    flat_idx = gate_idx.reshape(G, Tg * K)
    dest, keep = _dispatch_plan(flat_idx, E_alloc, capacity, before, limit)
    held = keep & (flat_idx >= lo) & (flat_idx < hi)
    dest = torch.where(held, dest - lo * capacity, torch.full_like(dest, rows))
    xk = xg[:, :, None, :].expand(G, Tg, K, D).reshape(G, Tg * K, D)
    buf = torch.zeros((G, rows + 1, D), dtype=xg.dtype, device=xg.device)
    # held rows have distinct destinations; the rest share the drop row,
    # which is cut off before the experts run
    buf.scatter_(1, dest[..., None].expand(G, Tg * K, D), xk)
    buf = buf[:, :-1].reshape(G, hi - lo, capacity, D)
    h = torch.matmul(buf, p["wi"])                       # (G, E, cap, F)
    if cfg.act == "swiglu":
        h = F.silu(torch.matmul(buf, p["wg"])) * h
    else:
        h = _act(cfg, h)
    out = torch.matmul(h, p["wo"])                       # (G, E, cap, D)
    outf = out.reshape(G, rows, D)
    if rows == 0:
        # a share of no expert (fewer experts than ``model`` ranks): one
        # zero row to gather from, the products kept in the graph so that
        # the backward's ``model`` collectives run on every rank
        outf = torch.cat([outf, outf.new_zeros((G, 1, D))], dim=1)
    safe = torch.clamp(dest, 0, outf.shape[1] - 1)
    gathered = torch.gather(outf, 1, safe[..., None].expand(G, Tg * K, D))
    gathered = torch.where(held[..., None], gathered,
                           torch.zeros_like(gathered))
    return (gathered.reshape(G, Tg, K, D)
            * gate_w[..., None].to(xg.dtype)).sum(dim=2), keep


def moe_capacity(cfg: ArchConfig, tokens: int) -> int:
    """Rows per expert for a group of ``tokens`` tokens, evaluated as the
    reference writes it (Python floats, then ``int``)."""
    return max(int(cfg.capacity_factor * tokens * cfg.top_k
                   / cfg.num_experts), 1)


def _earlier(flat_idx, E_alloc: int, span: int):
    """(E_alloc,) assignments to each expert made on the earlier ranks of
    this rank's dispatch group, which spans ``span`` consecutive ranks of
    the batch axes: each rank's counts all-gathered over them."""
    counts = _onehot(flat_idx, E_alloc).sum(dim=(0, 1)).to(torch.int64)
    every = gather_counts(counts, "batch")                     # (nb, E)
    me = axis_index("batch")[0]
    first = me - me % span
    return every[first:me].sum(dim=0)


def apply_moe(cfg: ArchConfig, p, x, *, groups: int = 1, tap=None,
              experts=None):
    """Capacity-based top-k MoE (GShard): x (B, S, D) -> ``(y (B, S, D),
    aux_loss)``.  The B*S tokens split into ``groups`` equal groups (1 when
    ``groups`` does not divide them), each with its own capacity
    ``max(int(cf * Tg * K / E), 1)``; an assignment past its expert's
    capacity is dropped (the residual passes it through).  So one token's
    output depends on the other tokens of its group.

    ``experts=(lo, hi)`` computes the share of a device that holds
    experts ``[lo, hi)`` (``p``'s ``wi``/``wg``/``wo`` hold those rows
    only; the router is whole): the routing, the capacity, each
    assignment's position and the aux loss are the whole layer's, and
    only the held experts' products are computed and combined, so the
    shares of a partition of the experts sum to the whole layer's output.
    Under a mesh (expert parallelism over ``model``, tokens replicated
    across it) that sum is the exchange: the shares' combines are
    all-reduced over ``model``; outside one a share's absent experts add
    0.  On a mesh whose batch axes split the tokens over ``nb`` ranks
    (each rank's rows consecutive, in rank order), ``x`` is a rank's
    tokens and the groups, capacities and positions stay the whole
    batch's: with ``groups`` a multiple of ``nb`` a rank's tokens are
    ``groups / nb`` whole groups; with ``groups`` dividing ``nb`` a group
    spans ``nb / groups`` ranks, and each assignment's position in it
    counts the earlier ranks' assignments (an all-gather of per-expert
    counts, :func:`_earlier`); any other pair raises.  The aux term is
    over every rank's tokens.

    ``tap``, when given, is called as ``tap(x.shape, gate_idx, keep)``
    with the (G, Tg, K) expert choices and the (G, Tg*K) bool kept mask,
    device tensors (nothing is read back): a measurement hook (routing
    decisions, drop shares) that a captured graph does not call."""
    B, S, D = x.shape
    T = B * S
    nb = axis_index("batch")[1]
    G = groups if (groups > 1 and T * nb % groups == 0) else 1
    if G % nb and nb % G:
        raise ValueError(f"{groups} MoE dispatch groups over {nb} batch "
                         f"ranks: neither divides the other")
    span = nb // G if G < nb else 1         # ranks a group spans
    G = max(G // nb, 1)                     # this rank's groups
    Tg = T // G
    xg = x.reshape(G, Tg, D)
    gate_w, gate_idx, aux_loss, E_alloc = _route(cfg, p, xg)
    limit = moe_capacity(cfg, Tg * span)    # the whole group's capacity
    before, rows = None, limit
    if span > 1:      # a rank's own positions stay below its Tg tokens
        before = _earlier(gate_idx.reshape(1, Tg * cfg.top_k), E_alloc,
                          span)
        rows = min(limit, Tg)
    y, keep = _dispatch_compute_combine(cfg, p, xg, gate_w, gate_idx,
                                        E_alloc, rows, experts, before,
                                        limit)
    if experts is not None:
        y = reduce_from(y, "model")     # the exchange: sum of the shares
    if tap is not None:
        tap(tuple(x.shape), gate_idx, keep)
    return y.reshape(B, S, D), aux_loss
