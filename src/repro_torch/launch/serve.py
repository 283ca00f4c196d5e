"""Serving launcher of the PyTorch port: end-to-end ALISE serving of a real
model on the paged KV backend (batch mode).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch-size full \
        --strategy alise --n-requests 16 --prefill-chunk 256

runs granite-3-8b at full width on the GPU with random weights from
``--seed``; ``--arch-size smoke --device cpu`` runs the reduced config on
the CPU.  On a GPU the paged decode attention and the chunk attention
default to the CUDA kernels (``--paged-attn-impl kernel --chunk-attn
flash``); ``gather``/``masked`` are the plain reference modes.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.engine import EngineConfig, ServingEngine
from repro_torch.core.predictor import OraclePredictor, RetrievalPredictor
from repro_torch.core.request import Request, reset_request_counter
from repro_torch.models.model import Model
from repro_torch.utils import resolve_device

# per arch size: (max_seq_len, max_new_tokens); the smoke size is the JAX
# launcher's
SIZES = {"smoke": (96, 48), "full": (2048, 64)}


def _mk_predictor(kind: str, seed: int = 0):
    if kind == "oracle":
        return OraclePredictor()
    return RetrievalPredictor(seed=seed)


def build_model(arch: str = "granite-3-8b", arch_size: str = "smoke",
                device=None, chunk_attn: Optional[str] = None,
                seed: int = 0):
    """(model, params) with random weights drawn on ``device`` from
    ``seed``.  ``chunk_attn`` defaults to ``flash`` on a GPU, ``masked``
    elsewhere."""
    dev = resolve_device(device)
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
          iter_token_budget: Optional[int] = None,
          paged_attn_impl: Optional[str] = None,
          chunk_attn: Optional[str] = None, page_size: int = 16,
          device=None, model_and_params=None, warmup: bool = False,
          verbose: bool = True):
    """Build (or take) the model, serve ``n_requests`` through
    ``ServingEngine.serve`` and print a summary.  Returns ``(requests,
    engine)``."""
    dev = resolve_device(device)
    model, params = model_and_params or build_model(
        arch, arch_size, dev, chunk_attn, seed)
    impl = paged_attn_impl or ("kernel" if dev.type == "cuda" else "gather")
    max_seq, max_new = SIZES[arch_size]
    eng = ServingEngine(model, params, EngineConfig(
        max_slots=max_slots, max_seq_len=max_seq, max_new_tokens=max_new,
        strategy=strategy, quantize_offload=quantize, kv_backend="paged",
        page_size=page_size, paged_attn_impl=impl,
        prefill_chunk=prefill_chunk, iter_token_budget=iter_token_budget,
        warmup_compile=warmup, seed=seed),
        predictor=_mk_predictor(predictor_kind, seed))
    reqs = build_requests(model.cfg, n_requests, seed, arch_size)
    eng.serve(reqs)
    if verbose:
        lat = [r.e2e_latency for r in reqs if r.e2e_latency is not None]
        norm = [r.normalized_latency for r in reqs if r.normalized_latency]
        print(f"[serve] {strategy} on {eng.device} ({model.cfg.name} "
              f"{arch_size}, attn {impl}/{model.chunk_attn_impl}): "
              f"{len(lat)}/{len(reqs)} finished; "
              f"mean latency {np.mean(lat) if lat else float('nan'):.3f}s; "
              f"normalized {np.mean(norm) * 1e3 if norm else float('nan'):.1f}"
              f" ms/token; preemptions {sum(r.preempt_count for r in reqs)}")
        lm = eng.fit_latency_model()
        print(f"[serve] fitted latency model: t0={lm.t0:.2e}s/tok "
              f"alpha={lm.alpha:.2e} beta={lm.beta:.2e}")
    return reqs, eng


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
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
                    choices=["oracle", "retrieval"])
    ap.add_argument("--no-quantize", action="store_true",
                    help="swap KV to the host in the working dtype instead "
                         "of INT8")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="max prompt tokens per prefill chunk")
    ap.add_argument("--iter-token-budget", type=int, default=None)
    ap.add_argument("--paged-attn-impl", default=None,
                    choices=["gather", "kernel"],
                    help="decode attention: page gather + masked softmax "
                         "(reference) or the CUDA paged-attention kernel "
                         "(default on a GPU)")
    ap.add_argument("--chunk-attn", default=None,
                    choices=["masked", "flash"],
                    help="chunk attention: dense masked (reference) or the "
                         "CUDA prefix flash kernel (default on a GPU)")
    ap.add_argument("--warmup", action="store_true",
                    help="time every prefill bucket before serving")
    args = ap.parse_args()
    serve(args.arch, args.arch_size, args.strategy, args.n_requests,
          args.max_slots, seed=args.seed, predictor_kind=args.predictor,
          quantize=not args.no_quantize, prefill_chunk=args.prefill_chunk,
          iter_token_budget=args.iter_token_budget,
          paged_attn_impl=args.paged_attn_impl, chunk_attn=args.chunk_attn,
          device=args.device, warmup=args.warmup)


if __name__ == "__main__":
    main()
