"""Serving launcher of the PyTorch port: end-to-end ALISE serving of a real
model, in batch mode or through the online gateway.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch-size full \
        --kv-backend paged --n-requests 16 --prefill-chunk 256
    PYTHONPATH=src python -m repro_torch.launch.serve --arch-size full \
        --n-requests 16 --max-slots 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
        --arch-size full --n-requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-3b-a800m --arch-size full --kv-backend paged \
        --prefill-chunk 256 --max-slots 8 --warmup
    PYTHONPATH=src python -m repro_torch.launch.serve --arch-size full \
        --kv-backend paged --prefill-chunk 256 --prefill-pack \
        --prefix-cache --predictor online --iter-token-budget auto \
        --target-tpot 0.03 --warmup

run granite-3-8b (or another attention-family config: granite-moe-3b-
a800m and dbrx-132b with a capacity-based MoE FFN, command-r-35b,
qwen1.5-32b, stablelm-3b, internvl2-2b's token backbone; the engine
refuses an encoder-decoder such as seamless-m4t-large-v2, as the
reference's engine cannot prefill one either) on the dense KV
backend (a K/V stripe per lane; the default, as in the JAX launcher;
without ``--prefill-chunk`` each prompt is one chunk over the lane's
stripe) or on the paged backend, and mamba2-2.7b (dense state) and
jamba-1.5-large-398b (dense K/V and state, each prompt prefilled whole;
its full size needs more than one card, so ``serve(model_and_params=...)``
takes a model that holds a share of its experts,
``Model(expert_shard=...)``) on the dense backend, at full width on the
GPU with
random weights from ``--seed``; ``--arch-size smoke --device cpu`` runs
the reduced config on the CPU.  On a GPU the paged decode attention and
the chunk attention default to the CUDA kernels (``--paged-attn-impl
kernel --chunk-attn flash``); ``gather``/``masked`` are the plain
reference modes.  RMSNorm and the SSD chunk step always take their
kernels on a GPU; the dense decode attention is plain torch, as in the
reference.  On a GPU the fused decode step and the prefill chunks of the
bucket menu run as CUDA graphs; ``--warmup`` captures them (and loads
every kernel library serving can reach) before the first request, so
serving captures and loads nothing.

``--spec-decode`` turns on speculative verify-k decoding (``--spec-k``
model-free drafts per lane scored in one step, greedy and sampled outputs
unchanged; the attention family.  An MoE's expert capacity is shared by
the tokens of a step, so its outputs depend on what shares the step:
with speculation, packs (never used for MoE) or prefix hits they may
differ).  ``--trace-out PATH`` attaches an observability
event bus and, after serving, writes a Chrome/Perfetto trace to PATH, its
Prometheus gauge text to ``PATH.prom`` and the scheduler-quality
highlights to the console.

``--predictor online`` is the learned hit-aware quantile length predictor
(``serving/prediction``); ``--iter-token-budget auto`` serves a warm batch,
fits the latency model to it and picks the budget whose predicted
iteration time meets ``--target-tpot``; ``--prefill-pack`` runs
equal-bucket chunks of up to ``--prefill-pack-width`` requests as one
call (over the pow2 bucket menu of ``--prefill-chunk`` unless
``--prefill-buckets`` names one); ``--prefix-cache`` shares the K/V of
repeated prompt prefixes across requests.

Gateway mode (``--gateway``) replays a Poisson trace (``--dataset``,
``--rate``, ``--n-requests``) through SLO-class admission, routing over
``--n-engines`` replicas and streaming delivery (``serving/gateway``), on
a virtual clock, or in wall clock with ``--wall`` (``--pump concurrent``:
one step thread per replica; ``lockstep``: one barrier loop):

    PYTHONPATH=src python -m repro_torch.launch.serve --gateway \
        --arch-size full --kv-backend paged --prefill-chunk 256 \
        --max-slots 8 --n-engines 2 --dataset sharegpt --rate 6 \
        --n-requests 24 --wall --warmup

Replicas on one device share one copy of the weights; ``--devices``
places them round-robin over devices (``distributed/placement``), and
``--kv-tier`` joins them to one shared host-RAM prefix tier
(``serving/kv_tier``; ``--tier-bytes``, ``--tier-quantize``).
"""
from __future__ import annotations

import argparse
import asyncio
import copy
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config, get_smoke_config
from repro_torch.core.engine import EngineConfig, ServingEngine
from repro_torch.core.predictor import OraclePredictor, RetrievalPredictor
from repro_torch.core.request import Request, SLOClass, reset_request_counter
from repro_torch.core.trace import (TraceConfig, clamp_requests,
                                    generate_trace)
from repro_torch.distributed.placement import (assign_devices, device_label,
                                               device_scope, place_params)
from repro_torch.models.model import Model
from repro_torch.serving.gateway import (AdmissionConfig, Gateway,
                                         GatewayConfig)
from repro_torch.serving.kv_tier import HostKVTier
from repro_torch.serving.prediction import OnlineQuantilePredictor
from repro_torch.utils import resolve_device

# per arch size: (max_seq_len, max_new_tokens); the smoke size is the JAX
# launcher's
SIZES = {"smoke": (96, 48), "full": (2048, 64)}
# gateway mode's prompt clamp per arch size (the smoke one is the JAX
# launcher's; the full one is build_requests' longest prompt)
GATEWAY_MAX_PROMPT = {"smoke": 24, "full": 1536}


def _mk_predictor(kind: str, seed: int = 0):
    if kind == "oracle":
        return OraclePredictor()
    if kind == "online":
        return OnlineQuantilePredictor(seed=seed)
    return RetrievalPredictor(seed=seed)


def _export_trace(bus, quality: dict, trace_out: str) -> None:
    """Write the Chrome/Perfetto trace (and a .prom gauge dump) and print
    the scheduler-quality highlights derived from the same stream."""
    from repro_torch.serving.observability import (render_prometheus,
                                                   write_chrome_trace)
    obj = write_chrome_trace(bus, trace_out)
    print(f"[trace] wrote {len(obj['traceEvents'])} trace events -> "
          f"{trace_out} (load in https://ui.perfetto.dev)")
    with open(trace_out + ".prom", "w") as f:
        f.write(render_prometheus(bus))
    print(f"[trace] wrote Prometheus gauges -> {trace_out}.prom")
    q = quality.get("queueing", {})
    e = quality.get("estimate_error", {})
    for label, d in [("ttft decomposition p50 (s): ",
                      {k: v.get("p50") for k, v in q.items()
                       if isinstance(v, dict) and v.get("n", 0)}),
                     ("EWT err (s) ", e.get("ewt_signed_s", {})),
                     ("len err (tok) ", e.get("len_signed_tok", {}))]:
        if isinstance(d, dict) and d and d.get("n", 1):
            stats = ", ".join(f"{k}={v:.3f}" for k, v in d.items()
                              if isinstance(v, float))
            print(f"[quality] {label}{stats}")


def build_model(arch: str = "granite-3-8b", arch_size: str = "smoke",
                device=None, chunk_attn: Optional[str] = None,
                seed: int = 0):
    """(model, params) with random weights drawn on ``device`` from
    ``seed``.  ``chunk_attn`` defaults to ``flash`` on a GPU, ``masked``
    elsewhere."""
    dev = resolve_device(device)
    if arch not in ASSIGNED_ARCHS:      # the paper's models are priced only
        raise KeyError(f"the port runs {list(ASSIGNED_ARCHS)}, not {arch!r}")
    cfg = get_config(arch) if arch_size == "full" else get_smoke_config(arch)
    chunk_attn = chunk_attn or ("flash" if dev.type == "cuda" else "masked")
    model = Model(cfg, chunk_attn_impl=chunk_attn, device=dev,
                  kv_dtype=cfg.param_dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return model, model.init(gen)


def build_requests(cfg, n: int, seed: int = 0, arch_size: str = "smoke"):
    """``n`` requests arriving at t=0 with random prompt token ids and
    trace output lengths drawn from ``seed``: at the smoke size the JAX
    launcher's mix (prompts 4-23 tokens, outputs 3-40), at full size
    prompts of 64-1536 tokens and outputs of 16-64."""
    rng = np.random.default_rng(seed)
    reset_request_counter()
    reqs = []
    for _ in range(n):
        if arch_size == "smoke":
            plen = int(rng.integers(4, 24))
            out = int(rng.choice([3, 5, 8, 30, 40],
                                 p=[0.3, 0.25, 0.2, 0.15, 0.1]))
        else:
            plen = int(rng.integers(64, 1537))
            out = int(rng.integers(16, 65))
        reqs.append(Request(
            prompt_len=plen, arrival_time=0.0, true_out_len=out,
            prompt_tokens=rng.integers(2, cfg.vocab_size, plen).tolist()))
    return reqs


def serve(arch: str = "granite-3-8b", arch_size: str = "smoke",
          strategy: str = "alise", n_requests: int = 12, max_slots: int = 4,
          seed: int = 0, predictor_kind: str = "oracle",
          quantize: bool = True, prefill_chunk: Optional[int] = None,
          iter_token_budget=None, target_tpot: float = 0.05,
          prefill_buckets=None, prefill_pack: bool = False,
          prefill_pack_width: int = 4, prefix_cache: bool = False,
          paged_attn_impl: Optional[str] = None,
          chunk_attn: Optional[str] = None, page_size: int = 16,
          kv_backend: str = "dense", device=None, model_and_params=None,
          warmup: bool = False, verbose: bool = True,
          cuda_graphs: bool = True, requests=None,
          spec_decode: bool = False, spec_k: int = 3,
          trace_out: Optional[str] = None):
    """Build (or take) the model, serve ``n_requests`` (or ``requests``)
    through ``ServingEngine.serve`` and print a summary.  ``kv_backend``
    is ``dense`` (the default, as in the JAX launcher) or ``paged``
    (attention family only).  ``iter_token_budget`` is an int, None
    (unbounded) or ``"auto"``: then a warm batch of ``max(4, max_slots)``
    requests is served first and ``autotune_token_budget(target_tpot)``
    sets the budget from its fitted latency model.  ``cuda_graphs=False``
    runs the serving steps eagerly on the card (``EngineConfig.
    cuda_graphs``).  ``spec_decode``/``spec_k`` are the engine's verify-k
    decoding; ``trace_out`` attaches a wall-clock ``EventBus`` and exports
    its trace there after serving.  Returns ``(requests, engine)``."""
    dev = resolve_device(device)
    model, params = model_and_params or build_model(
        arch, arch_size, dev, chunk_attn, seed)
    impl = paged_attn_impl or ("kernel" if dev.type == "cuda" else "gather")
    max_seq, max_new = SIZES[arch_size]
    autotune = iter_token_budget == "auto"
    eng = ServingEngine(model, params, EngineConfig(
        max_slots=max_slots, max_seq_len=max_seq, max_new_tokens=max_new,
        strategy=strategy, quantize_offload=quantize, kv_backend=kv_backend,
        page_size=page_size, paged_attn_impl=impl,
        prefill_chunk=prefill_chunk,
        iter_token_budget=None if autotune else iter_token_budget,
        prefill_buckets=prefill_buckets, prefill_pack=prefill_pack,
        prefill_pack_width=prefill_pack_width, prefix_cache=prefix_cache,
        spec_decode=spec_decode, spec_k=spec_k, warmup_compile=warmup,
        cuda_graphs=cuda_graphs, seed=seed),
        predictor=_mk_predictor(predictor_kind, seed))
    if trace_out:
        from repro_torch.serving.observability import EventBus
        eng.attach_bus(EventBus(clock="wall"), "engine0")
    if autotune:
        # profile a warm batch, then pick the budget whose predicted
        # mixed-iteration time meets the target TPOT
        eng.serve(build_requests(model.cfg, max(4, max_slots), seed + 1,
                                 arch_size))
        budget = eng.autotune_token_budget(target_tpot)
        if verbose:
            lm = eng.fit_latency_model()
            print(f"[serve] auto-tuned iter_token_budget={budget} (target "
                  f"TPOT {target_tpot * 1e3:.1f}ms; fit t0={lm.t0:.2e}s/tok "
                  f"alpha={lm.alpha:.2e} beta={lm.beta:.2e})")
    reqs = (requests if requests is not None
            else build_requests(model.cfg, n_requests, seed, arch_size))
    eng.serve(reqs)
    if verbose:
        lat = [r.e2e_latency for r in reqs if r.e2e_latency is not None]
        norm = [r.normalized_latency for r in reqs if r.normalized_latency]
        if eng.kv_backend == "paged":
            path = f"paged, attn {impl}/{model.chunk_attn_impl}"
        elif model.cfg.family == "ssm":
            path = "dense state"
        elif model.cfg.family == "hybrid":
            path = "dense KV and state, whole prompts"
        else:
            path = (f"dense KV, prefill chunks of {prefill_chunk or 'a prompt'}"
                    f" ({model.chunk_attn_impl})")
        print(f"[serve] {strategy} on {eng.device} ({model.cfg.name} "
              f"{arch_size}, {path}): "
              f"{len(lat)}/{len(reqs)} finished; "
              f"mean latency {np.mean(lat) if lat else float('nan'):.3f}s; "
              f"normalized {np.mean(norm) * 1e3 if norm else float('nan'):.1f}"
              f" ms/token; preemptions {sum(r.preempt_count for r in reqs)}")
        if eng.warm_stats is not None:
            w = eng.warm_stats
            print(f"[serve] warmup: {w['keys']} step keys, {w['captures']} "
                  f"CUDA graphs captured (pool {w['pool_bytes'] / 2**20:.1f}"
                  f" MiB), {w['compiles']} compile events")
        members = [m for t, _, _, m in eng.prefill_times
                   if m > 1 and t >= eng.serve_started]
        if members:     # this serve's packs (not the auto warm batch's)
            print(f"[serve] prefill packs: {len(members)} dispatched, mean "
                  f"{np.mean(members):.2f} of {prefill_pack_width} rows")
        st = eng.kv.prefix_stats()
        if st is not None:
            print(f"[serve] prefix cache: {st.hits} hits ({st.partial_hits} "
                  f"partial), {st.misses} misses, {st.hit_tokens} tokens "
                  f"served from cache, {st.inserted_pages} pages published")
        if eng._spec_ok:
            drafted = sum(r.spec_drafted for r in reqs)
            accepted = sum(r.spec_accepted for r in reqs)
            iters = sum(r.spec_iters for r in reqs)
            print(f"[serve] spec decode (k={spec_k}): {accepted}/{drafted} "
                  f"drafts accepted, "
                  f"{(iters + accepted) / max(iters, 1):.2f} tokens per "
                  "lane iteration")
        lm = eng.fit_latency_model()
        print(f"[serve] fitted latency model: t0={lm.t0:.2e}s/tok "
              f"alpha={lm.alpha:.2e} beta={lm.beta:.2e}")
    if trace_out:
        from repro_torch.serving.observability import analyze_quality
        _export_trace(eng.bus, analyze_quality(eng.bus), trace_out)
    return reqs, eng


def serve_gateway(arch: str = "granite-3-8b", strategy: str = "alise",
                  dataset: str = "alpaca", rate: float = 8.0,
                  n_requests: int = 32, n_engines: int = 2,
                  max_slots: int = 4, router: str = "ewt",
                  interactive_frac: float = 0.25, seed: int = 0,
                  predictor_kind: str = "oracle",
                  virtual_dt: Optional[float] = 0.05,
                  pump: str = "concurrent",
                  ttft_target_interactive: Optional[float] = None,
                  ttft_target_batch: Optional[float] = None,
                  ttft_miss_policy: str = "shed",
                  ttft_quantile: float = 0.5,
                  kv_backend: str = "dense",
                  prefill_chunk: Optional[int] = None,
                  iter_token_budget: Optional[int] = None,
                  prefix_cache: bool = False,
                  trace_out: Optional[str] = None,
                  metrics_interval: Optional[float] = None,
                  prefill_buckets=None, prefill_pack: bool = False,
                  prefill_pack_width: int = 4,
                  warmup: bool = False, chunk_attn: Optional[str] = None,
                  spec_decode: bool = False, spec_k: int = 3,
                  kv_tier: bool = False, tier_bytes: float = 256e6,
                  tier_quantize: bool = False,
                  devices: Optional[str] = None,
                  arch_size: str = "smoke", device=None,
                  model_and_params=None, requests=None,
                  paged_attn_impl: Optional[str] = None,
                  trace: Optional[bool] = None, on_ready=None):
    """Replay a synthetic Poisson trace (or ``requests``) through the
    online Gateway and print per-class TTFT/E2E percentiles (and SLO
    attainment when targets are set).  ``virtual_dt=None`` serves in wall
    clock; ``pump`` selects the concurrent per-engine pump or the lockstep
    barrier there.

    The trace's prompts are clamped to ``GATEWAY_MAX_PROMPT[arch_size]``
    tokens and its outputs to the size's ``max_new_tokens`` (``SIZES``),
    inside the model's vocabulary.  ``devices`` places each replica on its
    own device (round-robin, ``distributed/placement``); without it every
    replica runs on ``device`` and they share one copy of the weights.
    ``kv_tier`` joins every replica to one shared host-RAM prefix tier
    (``serving/kv_tier``).  The engines swap raw (``quantize_offload``
    off), as the reference launcher's do.  ``trace`` attaches the
    observability bus without writing a file (default: when
    ``trace_out`` is set).  ``on_ready`` is called with the gateway once
    the replicas are built (and warmed) and before the replay starts.
    Returns ``(streams, gateway)``."""
    dev = resolve_device(device)
    model, params = model_and_params or build_model(
        arch, arch_size, dev, chunk_attn, seed)
    impl = paged_attn_impl or ("kernel" if dev.type == "cuda" else "gather")
    max_seq, max_new = SIZES[arch_size]

    dev_list = (assign_devices(n_engines, devices) if devices is not None
                else [None] * n_engines)
    tier = None
    if kv_tier:
        tier = HostKVTier(tier_bytes, EngineConfig().page_size,
                          quantize=tier_quantize)

    def mk_engine(d):
        m = model
        if d is not None and device_label(d) != device_label(model.device):
            m = copy.copy(model)        # the same model, on another device
            m.device = d
        with device_scope(d):
            eng = ServingEngine(m, place_params(params, d), EngineConfig(
                max_slots=max_slots, max_seq_len=max_seq,
                max_new_tokens=max_new, strategy=strategy,
                quantize_offload=False, kv_backend=kv_backend,
                paged_attn_impl=impl,
                prefill_chunk=prefill_chunk,
                iter_token_budget=iter_token_budget,
                prefix_cache=prefix_cache, prefill_buckets=prefill_buckets,
                prefill_pack=prefill_pack,
                prefill_pack_width=prefill_pack_width,
                spec_decode=spec_decode, spec_k=spec_k,
                device=device_label(d) if d is not None else None,
                warmup_compile=warmup, seed=seed),
                predictor=_mk_predictor(predictor_kind, seed))
        if tier is not None:
            eng.attach_tier(tier)
        return eng

    if requests is None:
        reset_request_counter()
        trace_reqs = generate_trace(TraceConfig(
            dataset=dataset, rate=rate, duration=1e9,
            max_requests=n_requests, seed=seed)).requests
        requests = clamp_requests(trace_reqs, vocab=model.cfg.vocab_size,
                                  max_prompt=GATEWAY_MAX_PROMPT[arch_size],
                                  max_new=max_new)
        rng = np.random.default_rng(seed)
        for r in requests:
            if rng.random() < interactive_frac:
                r.slo_class = SLOClass.INTERACTIVE

    gw = Gateway([mk_engine(d) for d in dev_list],
                 GatewayConfig(virtual_dt=virtual_dt, router_policy=router,
                               concurrent_pump=(pump == "concurrent"),
                               trace=(bool(trace_out) if trace is None
                                      else trace),
                               metrics_interval_s=metrics_interval,
                               heartbeat=metrics_interval is not None),
                 admission=AdmissionConfig(
                     max_queue_depth=max(8 * n_engines * max_slots, 32),
                     defer_high_watermark=4 * n_engines * max_slots,
                     ttft_target_interactive=ttft_target_interactive,
                     ttft_target_batch=ttft_target_batch,
                     ttft_miss_policy=ttft_miss_policy,
                     ttft_quantile=ttft_quantile))
    if on_ready is not None:
        on_ready(gw)
    streams = asyncio.run(gw.replay(requests))
    done = sum(1 for s in streams if s.finished)
    clock = "virtual" if virtual_dt is not None else f"wall/{pump}"
    placement = (" [" + ", ".join(device_label(d) for d in dev_list)
                 + "]") if devices is not None else ""
    print(f"[gateway] {strategy}/{router} x{n_engines} engines{placement} "
          f"on {dev} ({model.cfg.name} {arch_size}, {kv_backend}) "
          f"({clock}), {dataset}@{rate}/s: {done}/{len(requests)} streams "
          "finished")
    print(gw.metrics.format())
    if tier is not None:
        st = tier.stats
        print(f"[kv-tier] {tier.bytes / 1e6:.1f}/"
              f"{tier.capacity_bytes / 1e6:.1f} MB, {st.published_pages} "
              f"pages published, {st.imports} imports "
              f"({st.imported_pages} pages, {st.hit_bytes / 1e6:.1f} MB), "
              f"{st.evicted_pages} evicted")
    if trace_out:
        _export_trace(gw.bus, gw.quality(), trace_out)
    return streams, gw


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=ASSIGNED_ARCHS)
    ap.add_argument("--arch-size", default="smoke", choices=sorted(SIZES),
                    help="'full' is the published config (CONFIG), "
                         "'smoke' the reduced one (smoke_config())")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' on request)")
    ap.add_argument("--strategy", default="alise",
                    choices=["alise", "orca", "vllm", "alise-recompute",
                             "alise-defer"])
    ap.add_argument("--n-requests", type=int, default=12)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--predictor", default="oracle",
                    choices=["oracle", "retrieval", "online"],
                    help="length predictor: 'oracle' (true lengths), "
                         "'retrieval' (static hashed-ngram KNN) or "
                         "'online' (hit-aware p50/p90 quantile regressor "
                         "that learns from served traffic)")
    ap.add_argument("--no-quantize", action="store_true",
                    help="swap KV to the host in the working dtype instead "
                         "of INT8")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="max prompt tokens per prefill chunk")
    ap.add_argument("--iter-token-budget", default=None,
                    help="scheduler token budget per iteration: an "
                         "integer, or 'auto' to fit it from a profiled "
                         "warm batch against --target-tpot (default: "
                         "unbounded)")
    ap.add_argument("--target-tpot", type=float, default=0.05,
                    help="TPOT target (s) for --iter-token-budget auto")
    ap.add_argument("--prefill-buckets", default=None, metavar="B1,B2,...",
                    help="fixed menu of prefill chunk-shape buckets "
                         "(comma-separated token counts); default: the "
                         "pow2 ladder up to --prefill-chunk")
    ap.add_argument("--prefill-pack", action="store_true",
                    help="run equal-bucket prefill chunks of several "
                         "requests as one call (greedy outputs unchanged on "
                         "the CPU in float32)")
    ap.add_argument("--prefill-pack-width", type=int, default=4,
                    help="requests per packed prefill call")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="cross-request shared-prefix KV cache: repeated "
                         "prompt prefixes reuse cached K/V instead of "
                         "being prefilled again (greedy outputs "
                         "unchanged on the CPU in float32)")
    ap.add_argument("--paged-attn-impl", default=None,
                    choices=["gather", "kernel"],
                    help="decode attention: page gather + masked softmax "
                         "(reference) or the CUDA paged-attention kernel "
                         "(default on a GPU)")
    ap.add_argument("--chunk-attn", default=None,
                    choices=["masked", "flash"],
                    help="chunk attention: dense masked (reference) or the "
                         "CUDA prefix flash kernel (default on a GPU)")
    ap.add_argument("--kv-backend", default="dense",
                    choices=["dense", "paged"],
                    help="device KV storage: the dense slotted cache (the "
                         "default; a K/V stripe per lane for the attention "
                         "family, the only backend of mamba2-2.7b) or the "
                         "paged pool (the attention family; CUDA paged "
                         "attention)")
    ap.add_argument("--warmup", action="store_true",
                    help="capture the serving steps (decode or verify, "
                         "every prefill bucket) as CUDA graphs, load every "
                         "kernel library and time each bucket before "
                         "serving")
    ap.add_argument("--spec-decode", action="store_true",
                    help="verify-k speculative decoding: model-free "
                         "n-gram/prefix-index drafts scored k+1 positions "
                         "at a time in one fused step; outputs equal plain "
                         "decoding's (greedy and sampled; bit for bit on "
                         "the CPU in float32). Pair with --warmup so the "
                         "verify step is captured before serving")
    ap.add_argument("--spec-k", type=int, default=3,
                    help="draft tokens per decode lane per verify step "
                         "(paged backend: must be < page size)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record the request lifecycle on the "
                         "observability event bus and export a Chrome/"
                         "Perfetto trace JSON to PATH after serving (plus "
                         "PATH.prom gauge dump and scheduler-quality "
                         "highlights)")
    ap.add_argument("--kv-tier", action="store_true",
                    help="gateway mode: join every replica to one shared "
                         "host-RAM prefix pool: re-routed sessions import "
                         "a peer's prefix pages at transfer cost instead "
                         "of prefilling them again (implies "
                         "--prefix-cache)")
    ap.add_argument("--tier-bytes", type=float, default=256e6,
                    help="shared tier payload capacity in bytes "
                         "(default 256e6; LRU-evicts unpinned pages)")
    ap.add_argument("--tier-quantize", action="store_true",
                    help="store tier payloads INT8 through the kv_quant "
                         "kernels (about 2x the prefixes per byte; lossy: "
                         "greedy tier-on/off bit identity no longer "
                         "holds)")
    ap.add_argument("--devices", default=None, metavar="SPEC",
                    help="gateway mode: place each replica on its own "
                         "device, round-robin over SPEC: 'auto' (every "
                         "CUDA device), a type ('cuda', 'cpu') or a list "
                         "('cuda:0,cuda:1' or '0,1')")
    ap.add_argument("--gateway", action="store_true",
                    help="online mode: replay a Poisson trace through the "
                         "streaming gateway instead of a pre-built batch")
    ap.add_argument("--dataset", default="alpaca",
                    choices=["alpaca", "sharegpt"])
    ap.add_argument("--rate", type=float, default=8.0)
    ap.add_argument("--n-engines", type=int, default=2)
    ap.add_argument("--router", default="ewt",
                    choices=["ewt", "join_shortest_queue", "round_robin",
                             "prefix_ewt"])
    ap.add_argument("--interactive-frac", type=float, default=0.25)
    ap.add_argument("--wall", action="store_true",
                    help="gateway mode: serve in wall clock (default is "
                         "deterministic virtual-clock replay)")
    ap.add_argument("--pump", default="concurrent",
                    choices=["concurrent", "lockstep"],
                    help="wall-clock pump: one step thread per replica or "
                         "the lockstep barrier")
    ap.add_argument("--ttft-target-interactive", type=float, default=None,
                    help="TTFT SLO target (s) for interactive traffic; "
                         "enables TTFT-attainment admission")
    ap.add_argument("--ttft-target-batch", type=float, default=None)
    ap.add_argument("--ttft-miss-policy", default="shed",
                    choices=["shed", "defer", "observe"])
    ap.add_argument("--ttft-quantile", type=float, default=0.5,
                    help="backlog quantile the TTFT admission gate prices: "
                         "0.5 = the routing/EWT p50 surface (default); "
                         "0.9 = the calibrated-P90 remaining-length "
                         "surface (needs --predictor online to differ "
                         "from 0.5)")
    ap.add_argument("--metrics-interval", type=float, default=None,
                    metavar="SECONDS",
                    help="gateway mode: print a one-line metrics "
                         "heartbeat every SECONDS (gauges are sampled "
                         "at the same cadence when tracing)")
    args = ap.parse_args()
    buckets = None
    if args.prefill_buckets:
        buckets = tuple(sorted({int(x) for x in
                                args.prefill_buckets.split(",") if x.strip()}))
    budget = args.iter_token_budget
    if budget is not None and budget != "auto":
        budget = int(budget)
    if args.gateway and budget == "auto":
        print("[serve] --iter-token-budget auto is batch-mode only "
              "(per-replica profiling); gateway runs unbounded")
    if args.kv_tier and not args.prefix_cache:
        args.prefix_cache = True       # the tier extends the prefix cache
    if (args.kv_tier or args.devices) and not args.gateway:
        print("[serve] --kv-tier/--devices are gateway-mode only "
              "(batch mode runs a single replica); ignoring")
    if args.gateway:
        serve_gateway(args.arch, args.strategy, args.dataset, args.rate,
                      args.n_requests, args.n_engines, args.max_slots,
                      router=args.router,
                      interactive_frac=args.interactive_frac,
                      seed=args.seed, predictor_kind=args.predictor,
                      virtual_dt=None if args.wall else 0.05,
                      pump=args.pump,
                      ttft_target_interactive=args.ttft_target_interactive,
                      ttft_target_batch=args.ttft_target_batch,
                      ttft_miss_policy=args.ttft_miss_policy,
                      ttft_quantile=args.ttft_quantile,
                      kv_backend=args.kv_backend,
                      prefill_chunk=args.prefill_chunk,
                      iter_token_budget=(None if budget == "auto"
                                         else budget),
                      prefix_cache=args.prefix_cache,
                      prefill_buckets=buckets,
                      prefill_pack=args.prefill_pack,
                      prefill_pack_width=args.prefill_pack_width,
                      warmup=args.warmup, chunk_attn=args.chunk_attn,
                      spec_decode=args.spec_decode, spec_k=args.spec_k,
                      kv_tier=args.kv_tier, tier_bytes=args.tier_bytes,
                      tier_quantize=args.tier_quantize,
                      devices=args.devices, trace_out=args.trace_out,
                      metrics_interval=args.metrics_interval,
                      arch_size=args.arch_size, device=args.device,
                      paged_attn_impl=args.paged_attn_impl)
        return
    if args.metrics_interval is not None:
        print("[serve] --metrics-interval is gateway-mode only "
              "(batch serving prints a final summary)")
    serve(args.arch, args.arch_size, args.strategy, args.n_requests,
          args.max_slots, seed=args.seed, predictor_kind=args.predictor,
          quantize=not args.no_quantize, prefill_chunk=args.prefill_chunk,
          iter_token_budget=budget, target_tpot=args.target_tpot,
          prefill_buckets=buckets, prefill_pack=args.prefill_pack,
          prefill_pack_width=args.prefill_pack_width,
          prefix_cache=args.prefix_cache,
          paged_attn_impl=args.paged_attn_impl, chunk_attn=args.chunk_attn,
          kv_backend=args.kv_backend, device=args.device, warmup=args.warmup,
          spec_decode=args.spec_decode, spec_k=args.spec_k,
          trace_out=args.trace_out)


if __name__ == "__main__":
    main()
