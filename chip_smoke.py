"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100 target).

    python3 chip_smoke.py            # from the repository root

Phases, each printing its own line(s); any failure exits non-zero before
the final line:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA kernel of ``src/repro_torch/csrc`` with nvcc for
     sm_90a, one process per source, with seconds and ptxas usage;
  3. kernels: each kernel against its plain PyTorch version at the serving
     path's shapes (tolerances: float32 2e-5, bfloat16 5e-2, INT8 codes
     within 1, round-trip relative error < 0.02), with its time, the plain
     version's time, the least time the card could take (bytes over
     3.35 TB/s or operations over the dtype's peak rate, whichever is
     larger) and, where one PyTorch call computes the same function, that
     call's time as a yardstick (the port never calls it);
  4. reference: the full-width model's kernel path (paged-attention
     kernel + prefix flash kernel) against its plain path (page gather +
     masked attention) on one short request's logits;
  5. serve: granite-3-8b at full width and depth (random weights from a
     seed) through ``ServingEngine.serve`` with chunked paged prefill and
     the fused paged decode; every request must finish and the paged-
     attention and prefix-flash kernels must have launched;
  6. swap: the same model with 2 lanes and a KV budget of a little over
     two sequences, staged arrivals on a virtual clock: requests must be
     preempted, swapped out and in as INT8 through the kv_quant kernels,
     and all finish;
  7. profile: where a full-batch decode step's time goes, with each decode
     attention path, under ``torch.profiler``.

Phases 5 and 6 are the main path: every kernel's launch count is set to 0
before them and read after them, and each kernel must have launched.  Then
a ``kernels`` JSON line, the card's name and power limit, and the final
``{"ok": true, "device": {...}}`` line.  Needs one CUDA card; exits
non-zero without one.
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


# ------------------------------------------------------- phases 4 to 6

def reference_check(torch, model, params):
    """Kernel path vs plain path of the full-width model on one short
    request: prefill 100 tokens in two chunks, then 4 decode steps, each
    path on its own pool; every logit row finite, relative L2 error of the
    kernel path's logits < 0.05 (bf16 rounding through 40 layers), and the
    same greedy tokens fed to both."""
    from repro_torch.serving.kv_cache import KVBackendConfig, PagedKVBackend
    rng = np.random.default_rng(SEED + 3)
    prompt = rng.integers(2, model.cfg.vocab_size, 100).tolist()
    outs = {}
    impl0 = model.chunk_attn_impl
    for impl, chunk in (("kernel", "flash"), ("gather", "masked")):
        model.chunk_attn_impl = chunk
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
        if e.device_type == torch.autograd.DeviceType.CUDA:
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


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    if not os.path.isdir(os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "src", "repro_torch")):
        fail("src/repro_torch not found next to this script: run it from a "
             "checkout of the repository")
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_prefill import flash_prefill_prefix
    from repro_torch.kernels.kv_quant import kv_dequantize, kv_quantize
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.launch.serve import build_model

    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    print(f"[device] {name} | {smi_line} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
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
    pa = check_paged_attention(torch, dev)
    fp = check_flash_prefix(torch, dev)
    kq, kd = check_kv_quant(torch, dev)

    kernels = {"paged_attention": paged_attention,
               "flash_prefill_prefix": flash_prefill_prefix,
               "kv_quantize": kv_quantize, "kv_dequantize": kv_dequantize}
    t0 = time.perf_counter()
    model, params = build_model("granite-3-8b", "full", dev, "flash", SEED)
    torch.cuda.synchronize()
    n_params = params["embed"].numel() + sum(
        t.numel() for layer in params["layers"] for sub in layer.values()
        for t in sub.values())
    print(f"[model] granite-3-8b full width/depth, {n_params:,} params bf16, "
          f"init {time.perf_counter() - t0:.1f}s", flush=True)
    reference_check(torch, model, params)
    # the main path is phases 5 and 6 together: counts start at 0 here and
    # are read after both (launches made by the parity checks above are
    # not counted)
    reset_counts(kernels)
    phase_serve(torch, model, params, kernels)
    phase_swap(torch, model, params, kernels)
    launches = read_counts(kernels)

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
        dict(name="kv_quantize", route="cuda", source=src + "kv_quant.cu",
             replaces="src/repro/kernels/kv_quant/kv_quant.py:37",
             launches=launches["kv_quantize"], **kq),
        dict(name="kv_dequantize", route="cuda", source=src + "kv_quant.cu",
             replaces="src/repro/kernels/kv_quant/kv_quant.py:62",
             launches=launches["kv_dequantize"], **kd),
    ]
    for r in rows:
        if r["launches"] <= 0:
            fail(f"kernel {r['name']} never launched on the main path")
    phase_profile(torch, model, params)
    print("[kernels] " + ", ".join(
        f"{r['name']}: launches={r['launches']} parity=ok" for r in rows),
        flush=True)
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
