"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100 target).

    python3 chip_smoke.py            # from the repository root

Phases, each printing its own line(s); any failure exits non-zero before
the final line:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA kernel of ``src/repro_torch/csrc`` with nvcc for
     sm_90a, one process per source, with seconds and ptxas usage;
  3. kernels: each kernel against its plain PyTorch version at the serving
     path's shapes, under ``torch.no_grad`` as the serving paths call them
     (tolerances: float32 2e-5, bfloat16 5e-2 for the paged and prefix
     kernels, the bfloat16 RMSNorm and full-sequence flash kernel within
     one bfloat16 rounding step of the plain output element by element
     (the flash kernel plus 2e-5), INT8 codes within 1, round-trip relative error < 0.02, SSD
     chunk rtol = atol = 1e-4 x sqrt(Q N / 1024)), with its time, the plain
     version's time, the least time the card could take (bytes over
     3.35 TB/s or operations over the dtype's peak rate, whichever is
     larger) and, where one PyTorch call computes the same function, that
     call's time as a yardstick (the port never calls it);
  4. reference: the full-width model's kernel path (paged-attention
     kernel + prefix flash kernel + RMSNorm kernel) against its plain path
     (page gather + masked attention + plain RMSNorm) on one short
     request's logits;
  5. serve: granite-3-8b at full width and depth (random weights from a
     seed) through ``ServingEngine.serve`` with chunked paged prefill and
     the fused paged decode; every request must finish and the paged-
     attention and prefix-flash kernels must have launched;
  6. swap: the same model with 2 lanes and a KV budget of a little over
     two sequences, staged arrivals on a virtual clock: requests must be
     preempted, swapped out and in as INT8 through the kv_quant kernels,
     and all finish;
  7. profile: where a full-batch decode step's time goes, with each decode
     attention path, under ``torch.profiler``;
  8. mamba reference: mamba2-2.7b at full width and depth (64 layers,
     d_model 2560, 80 heads of 64, state 128; random bf16 weights from a
     seed), its kernel path (fused RMSNorm + SSD chunk kernels) against its
     plain path on one prompt's prefill and 4 decode steps, in f32 (must
     agree to 1e-3) and in bf16 (printed beside bf16's own distance from
     f32);
  9. mamba serve: 8 requests through ``ServingEngine.serve`` on the dense
     state backend (monolithic prefill, fused recurrent decode);
 10. mamba swap: 2 lanes and staged arrivals force preemptions that swap a
     request's conv and SSM state to the host and back; each preempted
     request's greedy tokens must equal, bit for bit, those of a run of the
     same engine that serves it alone (no preemption);
 11. mamba profile: one full-batch decode step and one 1024-token prefill
     under ``torch.profiler``, kernel and plain paths;
 12. train reference: granite-3-8b at full width and 8 of its 40 layers in
     float32 (random weights from a seed, one 4 x 1024 batch of the
     synthetic stream), the loss and every gradient leaf through the
     kernels (flash forward and RMSNorm kernel, plain recomputed
     backwards) against ``use_kernels=False``: loss within 1e-4 relative,
     every leaf present, nonzero and within a relative L2 of 1e-3;
 13. train: ``launch/train.train`` on the card, the same configuration, five
     AdamW steps; every loss finite; ms per step, tokens/s, peak memory;
 14. train profile: one step under ``torch.profiler``, wall against device
     busy, and the shares of the flash kernel, the plain attention
     backward, the RMSNorm kernel and the weight products.

Phase 3 also holds the full-sequence flash kernel at the training shape
(B 4, H 32, KVH 8, S 1024, d 128: f32 causal and bidirectional, bf16
causal, a ragged S of 1000, d 64 bidirectional; SDPA timed as the
yardstick), the RMSNorm kernel (rows of 2560 and 5120 for mamba,
4096 for granite, bf16 and f32, with ``torch.nn.functional.rms_norm`` timed
as the library yardstick) and the SSD chunk kernel (B 1, S 1024 = 4 chunks
of 256, and one ragged chunk of 200 rows; 80 heads of 64, state 128, f32)
against their plain versions.  There are three main paths,
each driven with every kernel's launch count set to 0 just before it and
read just after: granite's phases 5 and 6 (the paged-attention, prefix
flash and INT8 quant kernels must have launched), mamba's phases 9 and
10 (the RMSNorm and SSD chunk kernels must have launched) and training's
phase 13 (the flash and RMSNorm kernels must have launched).  Each phase
prints its seconds.  Then a ``kernels`` JSON line, the card's name and
power limit, and the final ``{"ok": true, "device": {...}}`` line.  Needs
one CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

HBM_BYTES_PER_S = 3.35e12               # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,       # dense tensor-core rate
              "float32": 67e12}         # float32 outside the tensor cores
SEED = 0


class Clock:
    """Prints each phase's seconds as it ends."""

    def __init__(self, t0: float):
        self.t = t0

    def lap(self, what: str) -> None:
        now = time.perf_counter()
        print(f"[time] {what}: {now - self.t:.1f}s", flush=True)
        self.t = now


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events,
    after one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ------------------------------------------------------------- phase 3

def check_paged_attention(torch, dev):
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_ref)
    B, H, KVH, d, page = 8, 32, 8, 128, 16
    max_pages = 2048 // page
    num_pages = B * max_pages + 1
    g = torch.Generator(device=dev).manual_seed(SEED)
    lengths = torch.tensor(np.linspace(1, 2048, B).astype(np.int32),
                           device=dev)
    tables = torch.randperm(num_pages - 1, generator=g, device=dev)[
        :B * max_pages].reshape(B, max_pages).to(torch.int32)
    rows = {}
    for name in ("float32", "bfloat16"):
        dt = getattr(torch, name)
        q = torch.randn((B, H, d), generator=g, device=dev).to(dt)
        kc = torch.randn((num_pages, page, KVH, d), generator=g,
                         device=dev).to(dt)
        vc = torch.randn((num_pages, page, KVH, d), generator=g,
                         device=dev).to(dt)
        out = paged_attention(q, kc, vc, tables, lengths)
        ref = paged_attention_ref(q, kc, vc, tables, lengths)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = 2e-5 if name == "float32" else 5e-2
        if not err <= tol:
            fail(f"paged_attention {name}: max_abs_err {err} > {tol}")
        ms = time_ms(lambda: paged_attention(q, kc, vc, tables, lengths))
        plain = time_ms(lambda: paged_attention_ref(q, kc, vc, tables,
                                                    lengths), 5)
        toks = int(lengths.sum())
        moved = (nbytes(q, tables, lengths) * 2 - nbytes(tables, lengths)
                 + 2 * toks * KVH * d * kc.element_size())
        b_ms, b_by = bound(moved, 4.0 * toks * H * d, name)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                          bound_ms=b_ms, bound_by=b_by, library_ms=None)
        print(f"[kernel] paged_attention {name} B={B} H={H} KVH={KVH} "
              f"d={d} page={page} lengths 1..2048: max_err={err:.3g} "
              f"kernel_ms={ms:.4f} plain_ms={plain:.4f} bound_ms={b_ms:.4f} "
              f"({b_by}) library_ms=none", flush=True)
    return rows["bfloat16"]


def check_flash_prefix(torch, dev):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_prefill import (flash_prefill_prefix,
                                                   flash_prefill_prefix_ref)
    B, H, KVH, d, Smax = 1, 32, 8, 128, 2048
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    main = None
    for name, C, st in (("float32", 256, 1000), ("bfloat16", 16, 0),
                        ("bfloat16", 16, 1000), ("bfloat16", 256, 0),
                        ("bfloat16", 256, 1000)):
        dt = getattr(torch, name)
        q = torch.randn((B, H, C, d), generator=g, device=dev).to(dt)
        # k/v as the serve path passes them: transposed views of the
        # page-gathered (B, Smax, KVH, d) stripe
        k = torch.randn((B, Smax, KVH, d), generator=g,
                        device=dev).to(dt).transpose(1, 2)
        v = torch.randn((B, Smax, KVH, d), generator=g,
                        device=dev).to(dt).transpose(1, 2)
        start = torch.full((B,), st, dtype=torch.int32, device=dev)
        out = flash_prefill_prefix(q, k, v, start)
        ref = flash_prefill_prefix_ref(q, k, v, start)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = 2e-5 if name == "float32" else 5e-2
        if not err <= tol:
            fail(f"flash_prefill_prefix {name} C={C} start={st}: "
                 f"max_abs_err {err} > {tol}")
        ms = time_ms(lambda: flash_prefill_prefix(q, k, v, start))
        plain = time_ms(lambda: flash_prefill_prefix_ref(q, k, v, start), 5)
        qpos = st + torch.arange(C, device=dev)
        mask = torch.arange(Smax, device=dev)[None, :] <= qpos[:, None]
        try:
            def lib():
                return F.scaled_dot_product_attention(q, k, v,
                                                      attn_mask=mask,
                                                      enable_gqa=True)
            lib()
        except TypeError:          # torch without enable_gqa: expand heads
            ke = k.repeat_interleave(H // KVH, dim=1)
            ve = v.repeat_interleave(H // KVH, dim=1)

            def lib():
                return F.scaled_dot_product_attention(q, ke, ve,
                                                      attn_mask=mask)
        lib_ms = time_ms(lib)
        visible = C * st + C * (C + 1) // 2       # keys each row attends
        n_kv = st + C
        moved = nbytes(q) * 2 + 2 * n_kv * KVH * d * k.element_size() + 4
        b_ms, b_by = bound(moved, 4.0 * visible * H * d, name)
        print(f"[kernel] flash_prefill_prefix {name} C={C} start={st} "
              f"Smax={Smax}: max_err={err:.3g} kernel_ms={ms:.4f} "
              f"plain_ms={plain:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              f"library_ms={lib_ms:.4f}", flush=True)
        if name == "bfloat16" and C == 256 and st == 1000:
            main = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib_ms)
    return main


def _sdpa(torch, q, k, v, causal):
    """``F.scaled_dot_product_attention`` over GQA heads, the yardstick
    (expanding the kv heads where this torch has no ``enable_gqa``)."""
    import torch.nn.functional as F
    try:
        F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                       enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)
    except TypeError:
        G = q.shape[1] // k.shape[1]
        ke, ve = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
        return lambda: F.scaled_dot_product_attention(q, ke, ve,
                                                      is_causal=causal)


def check_flash_prefill(torch, dev):
    """The full-sequence flash kernel at the training path's shape (B 4,
    H 32, KVH 8, S 1024, d 128, the (B, S, H, d) projections viewed as
    (B, H, S, d) without a copy): f32 causal and bidirectional (2e-5),
    bf16 causal (each element within one bf16 rounding step of the plain
    output, 2^-7 of it, plus 2e-5), a ragged S of 1000 and d 64
    bidirectional (f32, 2e-5).  The bound counts the visible (query, key) pairs: 4 d flops
    each.  Returns the f32 causal row, the shape training runs."""
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_ref)
    B, H, KVH = 4, 32, 8
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    main = None
    for name, S, d, causal in (("float32", 1024, 128, True),
                               ("float32", 1024, 128, False),
                               ("bfloat16", 1024, 128, True),
                               ("float32", 1000, 128, True),
                               ("float32", 1024, 64, False)):
        dt = getattr(torch, name)

        def mk(heads):
            return torch.randn((B, S, heads, d), generator=g,
                               device=dev).to(dt).transpose(1, 2)
        q, k, v = mk(H), mk(KVH), mk(KVH)
        out = flash_prefill(q, k, v, causal=causal)
        ref = flash_prefill_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        kind = "causal" if causal else "bidirectional"
        if name == "float32":
            ok = err <= 2e-5
        else:
            # both sides accumulate in f32 and round once: at most one
            # bf16 step of the plain output apart, plus f32's 2e-5
            ok = bool((diff <= 2.0 ** -7 * ref.float().abs() + 2e-5).all())
        if not ok:
            fail(f"flash_prefill {name} {kind} S={S} d={d}: max_abs_err "
                 f"{err} beyond its tolerance")
        ms = time_ms(lambda: flash_prefill(q, k, v, causal=causal), 10)
        plain = time_ms(lambda: flash_prefill_ref(q, k, v, causal=causal), 5)
        lib_ms = time_ms(_sdpa(torch, q, k, v, causal), 10)
        visible = S * (S + 1) // 2 if causal else S * S
        b_ms, b_by = bound(nbytes(q, k, v, out), 4.0 * B * H * d * visible,
                           name)
        print(f"[kernel] flash_prefill {name} {kind} B={B} H={H} KVH={KVH} "
              f"S={S} d={d}: max_err={err:.3g} kernel_ms={ms:.4f} "
              f"plain_ms={plain:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              f"library_ms={lib_ms:.4f} (SDPA)", flush=True)
        if main is None:
            main = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib_ms)
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    return main


def check_kv_quant(torch, dev):
    from repro_torch.kernels.kv_quant import (kv_dequantize,
                                              kv_dequantize_ref, kv_quantize,
                                              kv_quantize_ref)
    T, d = 40 * 64 * 16 * 8, 128          # one swap's rows at full width
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    x = torch.randn((T, d), generator=g, device=dev) * 4.0
    q, lam, z = kv_quantize(x)
    qr, lamr, zr = kv_quantize_ref(x)
    torch.cuda.synchronize()
    code_err = (q.int() - qr.int()).abs().max().item()
    if code_err > 1:
        fail(f"kv_quantize: codes differ by {code_err} > 1")
    if not (torch.allclose(lam, lamr, rtol=1e-6, atol=0)
            and (z - zr).abs().max().item() <= 1):
        fail("kv_quantize: scales/zeros differ from the plain version")
    xh = kv_dequantize(q, lam, z, dtype=torch.float32)
    xr = kv_dequantize_ref(q, lam, z, dtype=torch.float32)
    torch.cuda.synchronize()
    deq_err = (xh - xr).abs().max().item()
    rel = ((xh - x).abs().max() / x.abs().max()).item()
    if not deq_err <= 2e-5 * x.abs().max().item():
        fail(f"kv_dequantize: max_abs_err {deq_err} vs plain")
    if not rel < 0.02:
        fail(f"kv quant round trip: relative error {rel} >= 0.02")
    qm = time_ms(lambda: kv_quantize(x))
    qp = time_ms(lambda: kv_quantize_ref(x), 5)
    dm = time_ms(lambda: kv_dequantize(q, lam, z))
    dp = time_ms(lambda: kv_dequantize_ref(q, lam, z), 5)
    qb, qby = bound(nbytes(x, q, lam, z), 6.0 * T * d, "float32")
    db, dby = bound(nbytes(q, lam, z, xh), 3.0 * T * d, "float32")
    print(f"[kernel] kv_quantize T={T} d={d} f32->int8: code_err={code_err} "
          f"kernel_ms={qm:.4f} plain_ms={qp:.4f} bound_ms={qb:.4f} ({qby}) "
          f"library_ms=none", flush=True)
    print(f"[kernel] kv_dequantize T={T} d={d} int8->f32: max_err="
          f"{deq_err:.3g} roundtrip_rel={rel:.4f} kernel_ms={dm:.4f} "
          f"plain_ms={dp:.4f} bound_ms={db:.4f} ({dby}) library_ms=none",
          flush=True)
    return (dict(max_abs_err=float(code_err), ms=qm, plain_ms=qp,
                 bound_ms=qb, bound_by=qby, library_ms=None),
            dict(max_abs_err=deq_err, ms=dm, plain_ms=dp, bound_ms=db,
                 bound_by=dby, library_ms=None))


def check_fused_rmsnorm(torch, dev):
    """The RMSNorm kernel at each main path's widths, bf16 and f32: mamba's
    d_model 2560 and gate-norm d_inner 5120 for a decode batch (8 rows) and
    a 1024-token prefill, granite's d_model 4096 for a decode batch and a
    256-token prefill chunk; ``torch.nn.functional.rms_norm`` is the
    library yardstick.  float32 must agree to 2e-5 (relative beyond 1);
    bfloat16 must be within one bfloat16 rounding step of the plain output,
    element by element (both sum in float32, so only the final rounding can
    differ).  Returns the bf16 (1024, 5120) row."""
    import torch.nn.functional as F
    from repro_torch.kernels.fused_rmsnorm import fused_rmsnorm, rmsnorm_ref
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    main = None
    shapes = ((8, 2560), (1024, 2560), (8, 5120), (1024, 5120), (8, 4096),
              (256, 4096))
    for name in ("float32", "bfloat16"):
        dt = getattr(torch, name)
        for T, d in shapes:
            x = (torch.randn((T, d), generator=g, device=dev) * 3).to(dt)
            scale = (1 + 0.1 * torch.randn((d,), generator=g,
                                           device=dev)).to(dt)
            out = fused_rmsnorm(x, scale)
            ref = rmsnorm_ref(x, scale)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            if name == "float32":
                ok = err <= 2e-5 * max(1.0, ref.float().abs().max().item())
            else:
                ok = bool((diff <= 2.0 ** -7 * ref.float().abs()).all())
            if not ok:
                fail(f"fused_rmsnorm {name} ({T}, {d}): max_abs_err {err}")
            ms = time_ms(lambda: fused_rmsnorm(x, scale), 50)
            plain = time_ms(lambda: rmsnorm_ref(x, scale), 20)
            try:
                lib_ms = time_ms(lambda: F.rms_norm(x, (d,), scale, 1e-5), 50)
            except AttributeError:             # torch without rms_norm
                lib_ms = None
            b_ms, b_by = bound(nbytes(x, scale, out), 4.0 * T * d, name)
            print(f"[kernel] fused_rmsnorm {name} T={T} d={d}: max_err="
                  f"{err:.3g} kernel_ms={ms:.4f} plain_ms={plain:.4f} "
                  f"bound_ms={b_ms:.4f} ({b_by}) library_ms="
                  f"{'none' if lib_ms is None else f'{lib_ms:.4f}'}",
                  flush=True)
            if name == "bfloat16" and T == 1024 and d == 5120:
                main = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    return main


def ssd_flops(B, C, Q, H, P, N) -> float:
    """Operations the SSD chunk step needs: the lower-triangular C . B^T
    once per chunk (it is shared by the heads), and per head the decayed
    scores, their product with xbar and the chunk state."""
    tri = Q * (Q + 1) / 2
    return B * C * (2.0 * tri * N + H * (tri + 2.0 * tri * P
                                         + 2.0 * Q * P * N + 2.0 * Q))


def check_ssd_chunk(torch, dev):
    """The SSD chunk kernel at one full-width mamba2-2.7b prefill layer of
    1024 tokens (B 1, C 4 chunks of Q 256, H 80, P 64, N 128, f32), and at
    a prompt shorter than a chunk, whose single chunk of Q 200 is not a
    multiple of the kernel's 32-row tiles.  Returns the Q 256 row."""
    from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_ref
    B, H, P, N = 1, 80, 64, 128
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    main = None
    for C, Q in ((4, 256), (1, 200)):
        xbar = torch.randn((B, C, Q, H, P), generator=g, device=dev)
        dA = -torch.randn((B, C, Q, H), generator=g, device=dev).abs() * 0.1
        Bc = torch.randn((B, C, Q, N), generator=g, device=dev)
        Cc = torch.randn((B, C, Q, N), generator=g, device=dev)
        outs = ssd_chunk(xbar, dA, Bc, Cc)
        refs = ssd_chunk_ref(xbar, dA, Bc, Cc)
        torch.cuda.synchronize()
        err = 0.0
        # 1e-4 at the Pallas tests' shapes (Q * N <= 1024), scaled by the
        # square root of the sums' lengths beyond them (float32 sums)
        tol = 1e-4 * (Q * N / 1024) ** 0.5
        for name, o, r in zip(("y_diag", "states", "chunk_decay"), outs,
                              refs):
            if not torch.isfinite(o).all():
                fail(f"ssd_chunk Q={Q}: non-finite {name}")
            if not torch.allclose(o, r, rtol=tol, atol=tol):
                fail(f"ssd_chunk Q={Q}: {name} differs from the plain "
                     f"version by {(o - r).abs().max().item()}")
            err = max(err, (o - r).abs().max().item())
        ms = time_ms(lambda: ssd_chunk(xbar, dA, Bc, Cc))
        plain = time_ms(lambda: ssd_chunk_ref(xbar, dA, Bc, Cc), 5)
        b_ms, b_by = bound(nbytes(xbar, dA, Bc, Cc, *outs),
                           ssd_flops(B, C, Q, H, P, N), "float32")
        print(f"[kernel] ssd_chunk f32 B={B} C={C} Q={Q} H={H} P={P} N={N}: "
              f"max_err={err:.3g} (tol {tol:.2g}) kernel_ms={ms:.4f} "
              f"plain_ms={plain:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) library_ms=none", flush=True)
        if Q == 256:
            main = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return main


# ------------------------------------------------------- phases 4 to 6

def reference_check(torch, model, params):
    """Kernel path vs plain path of the full-width model on one short
    request: prefill 100 tokens in two chunks, then 4 decode steps, each
    path on its own pool; the plain path takes no kernel (page gather,
    masked chunk attention, plain RMSNorm).  Every logit row finite,
    relative L2 error of the kernel path's logits < 0.05 (bf16 rounding
    through 40 layers), and the same greedy tokens fed to both."""
    from repro_torch.serving.kv_cache import KVBackendConfig, PagedKVBackend
    rng = np.random.default_rng(SEED + 3)
    prompt = rng.integers(2, model.cfg.vocab_size, 100).tolist()
    outs = {}
    impl0 = model.chunk_attn_impl
    for impl, chunk in (("kernel", "flash"), ("gather", "masked")):
        model.chunk_attn_impl = chunk
        model.use_kernels = impl == "kernel"
        kv = PagedKVBackend(model, KVBackendConfig(
            max_slots=1, max_seq_len=2048, page_size=16, attn_impl=impl),
            num_pages=16)
        rows = [kv.prefill_chunk(params, 7, prompt[:64], 0),
                kv.prefill_chunk(params, 7, prompt[64:], 64)]
        tok = int(rows[-1].argmax()) if impl == "kernel" else outs["tok"][0]
        toks = [tok]
        for i in range(4):
            kv.pool.extend(7, 1)
            pos = kv.pool.lengths[7] - 1
            pt = kv.pool.page_table[7]
            tables = torch.full((1, kv.max_pages_per_seq), kv.scratch_page,
                                dtype=torch.int32, device=model.device)
            tables[0, :len(pt)] = torch.tensor(pt, dtype=torch.int32)
            t = torch.tensor([[toks[-1]]], device=model.device)
            logits = model.paged_decode_step(
                params, {"k": kv.pool.k, "v": kv.pool.v}, t, tables,
                torch.tensor([pos], dtype=torch.int32, device=model.device),
                torch.tensor([pt[pos // 16]], device=model.device),
                torch.tensor([pos % 16], device=model.device),
                attn_impl=impl)
            rows.append(logits)
            if impl == "kernel":
                toks.append(int(logits.argmax()))
            else:
                toks.append(outs["tok"][i + 1])
        outs[impl] = torch.cat(rows).float()
        outs.setdefault("tok", toks)
    model.chunk_attn_impl = impl0
    model.use_kernels = True
    a, b = outs["kernel"], outs["gather"]
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        fail("reference: non-finite logits")
    if tuple(a.shape) != (6, model.cfg.vocab_size):
        fail(f"reference: logits shape {tuple(a.shape)}")
    rel = ((a - b).norm() / b.norm()).item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    print(f"[reference] full-width kernel vs plain path, 6 logit rows: "
          f"rel_l2={rel:.4g} argmax_agree={agree:.2f}", flush=True)
    if not rel < 0.05:
        fail(f"reference: kernel-path logits differ (rel_l2 {rel})")


def reset_counts(kernels):
    for k in kernels.values():
        k.launches = 0


def read_counts(kernels):
    return {n: k.launches for n, k in kernels.items()}


def phase_serve(torch, model, params, kernels):
    from repro_torch.launch.serve import serve
    t0 = time.perf_counter()
    reqs, eng = serve(arch_size="full", strategy="alise", n_requests=16,
                      max_slots=8, seed=SEED, predictor_kind="oracle",
                      prefill_chunk=256, paged_attn_impl="kernel",
                      chunk_attn="flash", page_size=16, device=model.device,
                      model_and_params=(model, params))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(kernels)
    done = [r for r in reqs if r.finish_time is not None]
    gen = sum(r.generated for r in reqs)
    ttft = [r.first_token_time - r.arrival_time for r in done]
    step_ms = [dt * 1e3 for *_, dt in eng.iter_times]
    batch = [b for _, _, b, _ in eng.iter_times]
    chunk_ms = [dt * 1e3 for *_, dt in eng.prefill_times]
    print(f"[serve] granite-3-8b full (40L d4096 32/8H ff12800 V49155 bf16) "
          f"kernel/flash chunk=256 slots=8: {len(done)}/{len(reqs)} finished, "
          f"{gen} tokens generated, {gen / wall:.1f} tok/s, wall {wall:.2f}s, "
          f"TTFT p50 {np.median(ttft):.3f}s, preemptions "
          f"{sum(r.preempt_count for r in reqs)}, {len(step_ms)} decode steps "
          f"p50 {np.median(step_ms):.2f} ms (mean batch {np.mean(batch):.2f}), "
          f"{len(chunk_ms)} prefill chunks p50 {np.median(chunk_ms):.2f} ms, "
          f"launches {counts}", flush=True)
    if len(done) != len(reqs):
        fail("serve: not every request finished")
    for r in reqs:
        if len(r.output_tokens) != r.generated or r.generated < 1:
            fail(f"serve: request {r.req_id} produced no tokens")
        if not all(0 <= t < model.cfg.vocab_size for t in r.output_tokens):
            fail(f"serve: request {r.req_id} emitted an out-of-vocab token")
    for n in ("paged_attention", "flash_prefill_prefix"):
        if counts[n] <= 0:
            fail(f"serve: kernel {n} never launched on the serve path")
    return counts


def phase_swap(torch, model, params, kernels):
    from repro_torch.core.engine import EngineConfig, ServingEngine
    from repro_torch.core.predictor import OraclePredictor
    from repro_torch.core.quantization import kv_bytes_per_token
    from repro_torch.core.request import Request, reset_request_counter
    cfg = model.cfg
    bpt = kv_bytes_per_token(cfg.num_layers, cfg.num_kv_heads, cfg.hd)
    prompts, outs = (200, 264, 120, 136, 150, 170), (48, 48, 6, 6, 6, 6)
    reset_request_counter()
    rng = np.random.default_rng(SEED + 4)
    reqs = [Request(prompt_len=p, arrival_time=0.0, true_out_len=o,
                    prompt_tokens=rng.integers(2, cfg.vocab_size, p).tolist())
            for p, o in zip(prompts, outs)]
    eng = ServingEngine(model, params, EngineConfig(
        max_slots=2, max_seq_len=2048, max_new_tokens=64, strategy="alise",
        quantize_offload=True, hbm_bytes=2 * 336 * bpt, kv_backend="paged",
        page_size=16, paged_attn_impl="kernel", prefill_chunk=256),
        predictor=OraclePredictor())
    before = read_counts(kernels)
    t = 0.0
    for r in reqs[:2]:
        eng.submit(r, t)
    for _ in range(5):
        eng.step(t)
        t += 0.1
    for r in reqs[2:]:
        eng.submit(r, t)
    for _ in range(2000):
        if not eng.sched.live:
            break
        eng.step(t)
        t += 0.1
    torch.cuda.synchronize()
    counts = {n: c - before[n] for n, c in read_counts(kernels).items()}
    pre = sum(r.preempt_count for r in reqs)
    print(f"[swap] 2 lanes, KV budget {2 * 336} tokens, INT8 offload: "
          f"{sum(r.finish_time is not None for r in reqs)}/{len(reqs)} "
          f"finished, preemptions {pre}, launches {counts}", flush=True)
    if eng.sched.live or any(r.finish_time is None for r in reqs):
        fail("swap: engine did not drain")
    if pre <= 0:
        fail("swap: no preemption was forced")
    for n in ("kv_quantize", "kv_dequantize"):
        if counts[n] <= 0:
            fail(f"swap: kernel {n} never launched")
    return counts


def _kernel_name(name: str) -> str:
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0][:40]


def _is_kernel(torch, e) -> bool:
    """A device event that is a kernel or copy (not a user annotation's
    span on the device timeline)."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def profile_step(torch, label: str, step, n: int = 5) -> None:
    """One line on where ``step``'s time goes: host wall ms per call
    without the profiler (``n`` calls, synchronized), then the device's
    busy time per call (sum of kernel times) and its top kernels from
    ``torch.profiler`` over ``n`` more calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.events():
        if _is_kernel(torch, e):
            name = _kernel_name(e.name)
            by_kernel[name] = (by_kernel.get(name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / n)
    busy = sum(by_kernel.values())
    if busy <= 0:
        print(f"[profile] {label}: wall {wall:.2f} ms; the profiler saw no "
              "device time (device busy not measured)", flush=True)
        return
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:4]
    print(f"[profile] {label}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
          f"(idle {max(0.0, 1 - busy / wall):.1%}), {len(by_kernel)} kernel "
          "names; top: " + "; ".join(f"{k} {v:.2f} ms ({v / busy:.1%})"
                                     for k, v in top), flush=True)


def phase_profile(torch, model, params):
    """Where the time goes in the two model steps of the serve path, with
    each attention implementation: a full-batch decode step (8 lanes at
    contexts spread over 64..1600 tokens, the serve phase's range) and one
    256-token prefill chunk starting at position 1024."""
    from repro_torch.serving.kv_cache import KVBackendConfig, PagedKVBackend
    B, pg = 8, 16
    kv = PagedKVBackend(model, KVBackendConfig(
        max_slots=B, max_seq_len=2048, page_size=pg), num_pages=B * 128)
    pool = {"k": kv.pool.k, "v": kv.pool.v}
    dev = model.device
    ctx = np.linspace(64, 1600, B).astype(int)
    tables = torch.full((B, kv.max_pages_per_seq), kv.scratch_page,
                        dtype=torch.int32)
    wp, wo = torch.zeros(B, dtype=torch.long), torch.zeros(B, dtype=torch.long)
    for i, c in enumerate(ctx):
        pages = kv.pool.allocate(i, int(c) + 1)
        tables[i, :len(pages)] = torch.tensor(pages, dtype=torch.int32)
        wp[i], wo[i] = pages[c // pg], c % pg
    dec = [x.to(dev) for x in (torch.full((B, 1), 7), tables,
                               torch.tensor(ctx, dtype=torch.int32), wp, wo)]
    for impl in ("kernel", "gather"):
        profile_step(torch, f"decode step ({impl}, B={B}, ctx 64..1600)",
                     lambda: model.paged_decode_step(params, pool, *dec,
                                                     attn_impl=impl))
    start, C = 1024, 256
    pos = start + torch.arange(C)
    pages = torch.tensor(kv.pool.page_table[B - 1], dtype=torch.long)
    pre = [torch.full((1, C), 7, device=dev), tables[B - 1:].to(dev),
           pages[pos // pg].to(dev), (pos % pg).to(dev)]
    impl0 = model.chunk_attn_impl
    for chunk in ("flash", "masked"):
        model.chunk_attn_impl = chunk
        profile_step(torch, f"prefill chunk ({chunk}, C={C}, start={start})",
                     lambda: model.paged_prefill_chunk(params, pool, *pre,
                                                       start, C))
    model.chunk_attn_impl = impl0


# ------------------------------------------------------ phases 8 to 11

def mamba_reference_check(torch, model, params):
    """Kernel path vs plain path of the full-width mamba2-2.7b on one
    300-token prompt (one chunk of 256 and a ragged one padded to 256) and
    4 decode steps, all fed the bf16 kernel path's greedy tokens, with the
    weights in bf16 and upcast to f32.  In f32 the two paths must agree to
    a relative L2 below 1e-3 with equal argmax: there the only difference
    is the kernels' summation order.  In bf16 the relative L2 is printed
    beside each bf16 path's distance from the f32 plain path, which is what
    bf16 rounding alone does to this random-weight model over 64 layers."""
    rng = np.random.default_rng(SEED + 7)
    prompt = torch.tensor(rng.integers(2, model.cfg.vocab_size, (1, 300)),
                          device=model.device)
    from repro_torch.utils import tree_map
    p32 = tree_map(lambda t: t.float(), params)
    toks = []

    def run(ps, use):
        model.use_kernels = use
        logits, cache = model.prefill(ps, {"tokens": prompt})
        rows = [logits]
        for i in range(4):
            if len(toks) == i:
                toks.append(int(rows[-1].argmax()))
            t = torch.tensor([[toks[i]]], device=model.device)
            rows.append(model.decode_step(ps, cache, t))
        return torch.cat(rows).float()

    outs = {(dt, use): run(ps, use)
            for dt, ps in (("bf16", params), ("f32", p32))
            for use in (True, False)}
    model.use_kernels = True
    del p32
    if not all(torch.isfinite(o).all() for o in outs.values()):
        fail("mamba reference: non-finite logits")
    if any(tuple(o.shape) != (5, model.cfg.vocab_size) for o in outs.values()):
        fail("mamba reference: logits of the wrong shape")

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    def agree(a, b):
        return (a.argmax(-1) == b.argmax(-1)).float().mean().item()

    ref = outs[("f32", False)]
    r32, r16 = rel(outs[("f32", True)], ref), rel(outs[("bf16", True)],
                                                   outs[("bf16", False)])
    print(f"[mamba-reference] full-width kernel vs plain path, 300-token "
          f"prefill + 4 decode steps, 5 logit rows: f32 rel_l2={r32:.4g} "
          f"argmax_agree={agree(outs[('f32', True)], ref):.2f}; bf16 "
          f"rel_l2={r16:.4g} argmax_agree="
          f"{agree(outs[('bf16', True)], outs[('bf16', False)]):.2f}; "
          f"bf16 kernel vs f32 plain rel_l2="
          f"{rel(outs[('bf16', True)], ref):.4g}, bf16 plain vs f32 plain "
          f"rel_l2={rel(outs[('bf16', False)], ref):.4g}", flush=True)
    if not (r32 < 1e-3 and agree(outs[("f32", True)], ref) == 1.0):
        fail(f"mamba reference: f32 kernel-path logits differ (rel_l2 {r32})")


def phase_mamba_serve(torch, model, params):
    from repro_torch.launch.serve import serve
    t0 = time.perf_counter()
    reqs, eng = serve(arch="mamba2-2.7b", arch_size="full", strategy="alise",
                      n_requests=8, max_slots=8, seed=SEED,
                      predictor_kind="oracle", kv_backend="dense",
                      device=model.device, model_and_params=(model, params),
                      verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = [r for r in reqs if r.finish_time is not None]
    gen = sum(r.generated for r in reqs)
    # the engine stamps a token with its iteration's start; all 8 prompts
    # are prefilled in the first iteration, one after another, so each
    # request's first token is measured at the end of its own (single)
    # prefill instead, from the serve call
    ttft = [t1 + dt - t0 for t1, _, dt in eng.prefill_times]
    step_ms = [dt * 1e3 for *_, dt in eng.iter_times]
    batch = [b for _, _, b, _ in eng.iter_times]
    pre_ms = [dt * 1e3 for *_, dt in eng.prefill_times]
    pre_tok = [n for _, n, _ in eng.prefill_times]
    print(f"[mamba-serve] mamba2-2.7b full (64L d2560 80x64 heads N128 "
          f"V50280 bf16) dense state, slots=8: {len(done)}/{len(reqs)} "
          f"finished, {gen} tokens generated, {gen / wall:.1f} tok/s, wall "
          f"{wall:.2f}s, TTFT p50 {np.median(ttft):.3f}s, preemptions "
          f"{sum(r.preempt_count for r in reqs)}, {len(step_ms)} decode steps "
          f"p50 {np.median(step_ms):.2f} ms (mean batch {np.mean(batch):.2f}), "
          f"{len(pre_ms)} prefills p50 {np.median(pre_ms):.2f} ms "
          f"({sum(pre_tok)} tokens, {sum(pre_tok) / sum(pre_ms) * 1e3:.0f} "
          f"tok/s)", flush=True)
    if len(done) != len(reqs):
        fail("mamba serve: not every request finished")
    if len(pre_ms) != len(reqs):
        fail(f"mamba serve: {len(pre_ms)} prefills for {len(reqs)} requests")
    for r in reqs:
        if len(r.output_tokens) != r.generated or r.generated < 1:
            fail(f"mamba serve: request {r.req_id} produced no tokens")
        if not all(0 <= t < model.cfg.vocab_size for t in r.output_tokens):
            fail(f"mamba serve: request {r.req_id} emitted an out-of-vocab "
                 "token")


def _mamba_swap_run(model, params, prompts, outs, staged: bool):
    """Serve on a virtual clock with 2 dense lanes, no early EOS; with
    ``staged`` the first two requests run 5 steps before the rest
    arrive."""
    from repro_torch.core.engine import EngineConfig, ServingEngine
    from repro_torch.core.predictor import OraclePredictor
    from repro_torch.core.request import Request, reset_request_counter
    reset_request_counter()
    reqs = [Request(prompt_len=len(p), arrival_time=0.0, true_out_len=o,
                    prompt_tokens=list(p)) for p, o in zip(prompts, outs)]
    eng = ServingEngine(model, params, EngineConfig(
        max_slots=2, max_seq_len=2048, max_new_tokens=64, strategy="alise",
        quantize_offload=False, kv_backend="dense", eos_token=-1),
        predictor=OraclePredictor())
    t = 0.0
    first = reqs[:2] if staged else reqs
    for r in first:
        eng.submit(r, t)
    for _ in range(5 if staged else 0):
        eng.step(t)
        t += 0.1
    for r in reqs[len(first):]:
        eng.submit(r, t)
    for _ in range(2000):
        if not eng.sched.live:
            break
        eng.step(t)
        t += 0.1
    if eng.sched.live or any(r.finish_time is None for r in reqs):
        fail("mamba swap: engine did not drain")
    return reqs, eng


def phase_mamba_swap(torch, model, params, kernels):
    """Forced state swaps with 2 lanes; returns the launch counts read
    right after the swap run.  Then every preempted request is served alone
    by the same engine configuration (2 lanes, so the decode batch shape is
    the same) and its greedy tokens must be equal bit for bit."""
    rng = np.random.default_rng(SEED + 8)
    lens, outs = (300, 520, 90, 140, 200, 64), (40, 40, 6, 6, 6, 6)
    prompts = [rng.integers(2, model.cfg.vocab_size, n).tolist()
               for n in lens]
    before = read_counts(kernels)
    t0 = time.perf_counter()
    reqs, eng = _mamba_swap_run(model, params, prompts, outs, staged=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = read_counts(kernels)
    counts = {n: c - before[n] for n, c in total.items()}
    lane_bytes = sum(t[:, 0].numel() * t.element_size()
                     for k, t in eng.kv.cache.items() if k != "lengths")
    pre = sum(r.preempt_count for r in reqs)
    # one lane's round trip over the host link, timed alone
    rid = -1
    eng.kv.slot_req[0] = rid
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    blob = eng.kv.offload(rid)
    t2 = time.perf_counter()
    eng.kv.upload(rid, blob)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    eng.kv.clear(rid)
    print(f"[mamba-swap] 2 lanes, staged arrivals, raw state offload: "
          f"{sum(r.finish_time is not None for r in reqs)}/{len(reqs)} "
          f"finished in {wall:.2f}s, preemptions {pre}, "
          f"{lane_bytes / 1e6:.1f} MB swapped per preemption (conv + f32 SSM "
          f"state of 64 layers), offload {1e3 * (t2 - t1):.1f} ms / upload "
          f"{1e3 * (t3 - t2):.1f} ms, launches {counts}", flush=True)
    if pre <= 0:
        fail("mamba swap: no preemption was forced")
    victims = [(i, r) for i, r in enumerate(reqs) if r.preempt_count > 0]
    for i, r in victims:
        alone, _ = _mamba_swap_run(model, params, [prompts[i]], [outs[i]],
                                   staged=False)
        if alone[0].preempt_count or alone[0].output_tokens != r.output_tokens:
            fail(f"mamba swap: request {i} ({r.preempt_count} preemptions) "
                 "emitted other greedy tokens than its unpreempted run")
    print(f"[mamba-swap] {len(victims)} preempted requests: greedy tokens "
          "equal to their unpreempted runs, bit for bit", flush=True)
    return total


def phase_mamba_profile(torch, model, params):
    """Where the time goes in the mamba path's two model steps, kernel and
    plain: a full-batch decode step (8 lanes, every lane active) and one
    1024-token prefill."""
    B = 8
    cache = model.init_cache(B)
    dev = model.device
    toks = torch.full((B, 1), 7, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    prompt = torch.full((1, 1024), 7, device=dev)
    for use in (True, False):
        model.use_kernels = use
        path = "kernel" if use else "plain"
        profile_step(torch, f"mamba decode step ({path}, B={B})",
                     lambda: model.decode_step(params, cache, toks, active))
        profile_step(torch, f"mamba prefill ({path}, S=1024)",
                     lambda: model.prefill(params, {"tokens": prompt}), n=3)
    model.use_kernels = True


# ---------------------------------------------------- phases 12 to 14

TRAIN = dict(layers=8, batch=4, seq=1024, steps=5)


def _train_setup(torch, dev):
    """granite-3-8b at full width and 8 of its 40 layers in float32, as
    ``launch/train.py`` builds it for ``seq_len`` 1024 (attention chunks of
    512 for the plain version), and the first batch of the synthetic
    stream."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.training.data import DataConfig, SyntheticLM
    cfg = get_config("granite-3-8b").scaled(param_dtype="float32",
                                            num_layers=TRAIN["layers"])
    model = Model(cfg, attn_chunk=TRAIN["seq"] // 2, device=dev)
    data = SyntheticLM(cfg, DataConfig(batch_size=TRAIN["batch"],
                                       seq_len=TRAIN["seq"]))
    return model, next(data.iterate(device=dev))


def train_reference(torch, dev):
    """The training path's loss and gradients through the kernels (flash
    forward + plain recomputed backward, RMSNorm kernel + plain backward)
    against ``use_kernels=False`` (the plain online-softmax attention and
    plain RMSNorm, autograd throughout) on the same random params and
    batch: the loss within 1e-4 relative, every gradient leaf present,
    finite, nonzero and within a relative L2 of 1e-3.  A kernel that cut
    the graph would leave its inputs' leaves without gradient or with a
    wrong one."""
    from repro_torch.utils import tree_leaves
    model, batch = _train_setup(torch, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    named = [(path, p.requires_grad_(True)) for path, p in
             tree_leaves(params)]
    leaves = [p for _, p in named]
    out = {}
    for use in (True, False):
        model.use_kernels = use
        t0 = time.perf_counter()
        loss, parts = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        torch.cuda.synchronize()
        out[use] = (loss.item(), parts["ce"].item(), grads,
                    time.perf_counter() - t0)
        del loss, parts
    model.use_kernels = True
    (lk, cek, gk, tk), (lp, cep, gp, tp) = out[True], out[False]
    worst, worst_at = -1.0, None
    for (path, _), a, b in zip(named, gk, gp):
        if a is None or b is None:
            fail(f"train reference: no gradient for {path}")
        if not (torch.isfinite(a).all() and a.abs().max().item() > 0):
            fail(f"train reference: gradient of {path} is zero or "
                 "non-finite")
        rel = ((a - b).norm() / b.norm()).item()
        if rel > worst:
            worst, worst_at = rel, path
    rel_loss = abs(lk - lp) / abs(lp)
    n_params = sum(p.numel() for p in leaves)
    print(f"[train-reference] granite-3-8b full width, {TRAIN['layers']} "
          f"layers, f32, {n_params:,} params, batch {TRAIN['batch']}x"
          f"{TRAIN['seq']}: loss kernel {lk:.6f} plain {lp:.6f} (rel "
          f"{rel_loss:.3g}, ce {cek:.6f}/{cep:.6f}); {len(leaves)} gradient "
          f"leaves, worst rel_l2 {worst:.3g} at {'.'.join(map(str, worst_at))}"
          f"; loss+grad {tk:.2f}s kernel path, {tp:.2f}s plain path "
          "(first calls)", flush=True)
    if not rel_loss <= 1e-4:
        fail(f"train reference: loss differs by {rel_loss} relative")
    if not worst <= 1e-3:
        fail(f"train reference: gradient of {worst_at} differs by rel_l2 "
             f"{worst}")
    del out, gk, gp, params, named, leaves
    torch.cuda.empty_cache()


def phase_train(torch, dev, kernels):
    """``launch/train.train`` on the card: full width, depth 8, float32,
    batch 4 x 1024, five AdamW steps.  Every loss finite; the flash and
    RMSNorm kernels must launch.  Returns (state, launch counts)."""
    from repro_torch.launch.train import train
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    t0 = time.perf_counter()
    state, losses, step_s = train(
        "granite-3-8b", smoke=False, num_layers=TRAIN["layers"],
        batch_size=TRAIN["batch"], seq_len=TRAIN["seq"],
        steps=TRAIN["steps"], log_every=TRAIN["steps"], device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    p50 = float(np.median(step_s))
    toks = TRAIN["batch"] * TRAIN["seq"]
    print(f"[train] granite-3-8b full width (d4096 32/8H ff12800 V49155), "
          f"{TRAIN['layers']} of 40 layers, f32, AdamW, batch "
          f"{TRAIN['batch']}x{TRAIN['seq']}: {len(losses)} steps, ms/step "
          f"p50 {p50 * 1e3:.1f} (each: "
          f"{', '.join(f'{t * 1e3:.1f}' for t in step_s)}), "
          f"{toks / p50:.0f} tokens/s, peak memory {peak / 2**30:.2f} GiB "
          f"({peak:,} B), loss first {losses[0]:.4f} last {losses[-1]:.4f}, "
          f"wall {wall:.1f}s with init, launches {counts}", flush=True)
    if len(losses) != TRAIN["steps"] or not all(np.isfinite(losses)):
        fail(f"train: losses {losses}")
    for n in ("flash_prefill", "fused_rmsnorm"):
        if counts[n] <= 0:
            fail(f"train: kernel {n} never launched on the training path")
    return state, counts


def _kernels_under(e):
    """(name, microseconds) of the device kernels launched inside a CPU
    event and its children."""
    for k in e.kernels:
        yield k.name, k.duration
    for c in e.cpu_children:
        yield from _kernels_under(c)


def phase_train_profile(torch, dev, state):
    """One training step under ``torch.profiler``: host wall time against
    the device's busy time, and the shares of the flash kernel, the plain
    attention backward (the device time inside the Function's
    ``flash_prefill.backward_plain`` range), the RMSNorm kernel and the
    weight products (gemm kernels outside that range)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import make_train_step
    model, batch = _train_setup(torch, dev)
    step = make_train_step(model, AdamWConfig())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    events = prof.events()
    busy = flash = norm = gemm = 0.0
    for e in events:
        if _is_kernel(torch, e):
            ms = e.time_range.elapsed_us() / 1e3
            busy += ms
            name = e.name.lower()
            flash += ms if "flash_attn_kernel" in name else 0.0
            norm += ms if "rmsnorm_kernel" in name else 0.0
            gemm += ms if "gemm" in name else 0.0
    back = back_gemm = 0.0
    for e in events:
        if (e.name == "flash_prefill.backward_plain"
                and e.device_type == torch.autograd.DeviceType.CPU):
            for name, us in _kernels_under(e):
                back += us / 1e3
                back_gemm += us / 1e3 if "gemm" in name.lower() else 0.0
    if busy <= 0:
        print(f"[train-profile] one step: wall {wall:.1f} ms; the profiler "
              "saw no device time (device busy not measured)", flush=True)
        return

    def share(ms):
        return f"{ms:.1f} ms ({ms / busy:.1%})"
    weights = gemm - back_gemm
    back_txt = (share(back) if back > 0 else
                "not measured (no kernels under the backward's range)")
    print(f"[train-profile] one step (batch {TRAIN['batch']}x{TRAIN['seq']}, "
          f"{TRAIN['layers']} layers): wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms (idle {max(0.0, 1 - busy / wall):.1%}); flash "
          f"kernel {share(flash)}, plain attention backward {back_txt}, "
          f"RMSNorm kernel {share(norm)}, weight products "
          f"{share(weights)}, other {share(busy - flash - norm - back - weights)}",
          flush=True)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    if not os.path.isdir(os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "src", "repro_torch")):
        fail("src/repro_torch not found next to this script: run it from a "
             "checkout of the repository")
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_prefix)
    from repro_torch.kernels.fused_rmsnorm import fused_rmsnorm
    from repro_torch.kernels.kv_quant import kv_dequantize, kv_quantize
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ssd_scan import ssd_chunk
    from repro_torch.launch.serve import build_model
    from repro_torch.utils import tree_leaves

    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    print(f"[device] {name} | {smi_line} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t_start = t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    print(f"[build] {len(_build.sources())} sources with nvcc for sm_90a in "
          f"{build_s:.1f}s", flush=True)
    for src, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line.lower():
                print(f"[build] {src}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clock = Clock(time.perf_counter())
    # the raw wrappers are timed under no_grad, the mode the serving paths
    # call them in (training reaches them through their Functions)
    with torch.no_grad():
        pa = check_paged_attention(torch, dev)
        fp = check_flash_prefix(torch, dev)
        fa = check_flash_prefill(torch, dev)
        kq, kd = check_kv_quant(torch, dev)
        rn = check_fused_rmsnorm(torch, dev)
        sc = check_ssd_chunk(torch, dev)
    clock.lap("kernels (phase 3)")

    kernels = {"paged_attention": paged_attention,
               "flash_prefill_prefix": flash_prefill_prefix,
               "flash_prefill": flash_prefill,
               "kv_quantize": kv_quantize, "kv_dequantize": kv_dequantize,
               "fused_rmsnorm": fused_rmsnorm, "ssd_chunk": ssd_chunk}
    t0 = time.perf_counter()
    model, params = build_model("granite-3-8b", "full", dev, "flash", SEED)
    torch.cuda.synchronize()
    n_params = params["embed"].numel() + sum(
        t.numel() for layer in params["layers"] for sub in layer.values()
        for t in sub.values())
    print(f"[model] granite-3-8b full width/depth, {n_params:,} params bf16, "
          f"init {time.perf_counter() - t0:.1f}s", flush=True)
    reference_check(torch, model, params)
    clock.lap("granite init + reference (phase 4)")
    # granite's main path is phases 5 and 6 together: counts start at 0
    # here and are read after both (launches made by the parity checks
    # above are not counted)
    reset_counts(kernels)
    phase_serve(torch, model, params, kernels)
    phase_swap(torch, model, params, kernels)
    launches = read_counts(kernels)
    print(f"[main-path] granite-3-8b (phases 5-6) launches {launches}",
          flush=True)
    clock.lap("granite serve + swap (phases 5-6)")
    phase_profile(torch, model, params)
    clock.lap("granite profile (phase 7)")
    del model, params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model, params = build_model("mamba2-2.7b", "full", dev, None, SEED)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    print(f"[model] mamba2-2.7b full width/depth, {n_params:,} params bf16 "
          f"(SSM constants f32), init {time.perf_counter() - t0:.1f}s",
          flush=True)
    mamba_reference_check(torch, model, params)
    clock.lap("mamba init + reference (phase 8)")
    # mamba's main path is phases 9 and 10 together (the unpreempted
    # comparison runs of phase 10 are not counted)
    reset_counts(kernels)
    phase_mamba_serve(torch, model, params)
    m_launches = phase_mamba_swap(torch, model, params, kernels)
    print(f"[main-path] mamba2-2.7b (phases 9-10) launches {m_launches}",
          flush=True)
    clock.lap("mamba serve + swap (phases 9-10)")
    phase_mamba_profile(torch, model, params)
    clock.lap("mamba profile (phase 11)")
    del model, params
    torch.cuda.empty_cache()

    train_reference(torch, dev)
    clock.lap("train reference (phase 12)")
    # the training main path is phase 13: counts start at 0 there and are
    # read right after it
    state, t_launches = phase_train(torch, dev, kernels)
    print(f"[main-path] granite-3-8b training (phase 13) launches "
          f"{t_launches}", flush=True)
    clock.lap("train (phase 13)")
    phase_train_profile(torch, dev, state)
    del state
    torch.cuda.empty_cache()
    clock.lap("train profile (phase 14)")

    src = "src/repro_torch/csrc/"
    rows = [
        dict(name="paged_attention", route="cuda",
             source=src + "paged_attention.cu",
             replaces="src/repro/kernels/paged_attention/paged_attention.py:66",
             launches=launches["paged_attention"], **pa),
        dict(name="flash_prefill_prefix", route="cuda",
             source=src + "flash_prefill_prefix.cu",
             replaces="src/repro/kernels/flash_prefill/flash_prefill.py:119",
             launches=launches["flash_prefill_prefix"], **fp),
        dict(name="flash_prefill", route="cuda",
             source=src + "flash_prefill_prefix.cu",
             replaces="src/repro/kernels/flash_prefill/flash_prefill.py:165",
             launches=t_launches["flash_prefill"], **fa),
        dict(name="kv_quantize", route="cuda", source=src + "kv_quant.cu",
             replaces="src/repro/kernels/kv_quant/kv_quant.py:37",
             launches=launches["kv_quantize"], **kq),
        dict(name="kv_dequantize", route="cuda", source=src + "kv_quant.cu",
             replaces="src/repro/kernels/kv_quant/kv_quant.py:62",
             launches=launches["kv_dequantize"], **kd),
        dict(name="fused_rmsnorm", route="cuda",
             source=src + "fused_rmsnorm.cu",
             replaces="src/repro/kernels/fused_rmsnorm/fused_rmsnorm.py:23",
             launches=m_launches["fused_rmsnorm"], **rn),
        dict(name="ssd_chunk", route="cuda", source=src + "ssd_chunk.cu",
             replaces="src/repro/kernels/ssd_scan/ssd_scan.py:51",
             launches=m_launches["ssd_chunk"], **sc),
    ]
    for r in rows:
        if r["launches"] <= 0:
            fail(f"kernel {r['name']} never launched on its main path")
    print("[kernels] " + ", ".join(
        f"{r['name']}: launches={r['launches']} parity=ok" for r in rows),
        flush=True)
    print(f"[time] total {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
