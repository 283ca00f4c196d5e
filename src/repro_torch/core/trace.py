"""Synthetic workload traces (paper §4.1).

The paper synthesizes request traces from the Alpaca / ShareGPT length
histograms (Fig. 7) with Poisson arrival times; no real trace exists.  We do
the same from the published distribution shapes:

  * alpaca:   short instructions (input lognormal ~20 tok), short outputs
              (median ~60, capped 512), low variance.
  * sharegpt: long chat turns (input median ~170), long heavy-tailed outputs
              (median ~250, tail to 2k), high variance.

Prompts are token sequences drawn from latent *topic clusters*; a cluster
biases the output-length distribution, so a retrieval predictor that has seen
similar prompts can predict length well — mirroring the real-world signal the
paper's vector DB exploits — while per-request noise keeps prediction
imperfect.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.core.request import Request

VOCAB = 8192          # toy vocabulary for synthetic prompts
TOPIC_TOKENS = 64     # tokens per topic signature


@dataclass
class TraceConfig:
    dataset: str = "sharegpt"            # alpaca | sharegpt
    rate: float = 2.0                    # requests / second (Poisson)
    duration: float = 1800.0             # seconds (paper: 30-minute traces)
    max_requests: Optional[int] = None
    n_clusters: int = 64
    length_noise: float = 0.25           # per-request lognormal sigma around cluster mean
    seed: int = 0


_DATASETS = {
    #             in_mu, in_sig, out_med_lo, out_med_hi, out_sig, out_cap
    "alpaca":   (3.0, 0.6, 24, 160, 0.45, 512),
    "sharegpt": (5.1, 0.9, 60, 640, 0.85, 2048),
}


@dataclass
class SyntheticTrace:
    requests: List[Request]
    cfg: TraceConfig

    @property
    def duration(self) -> float:
        if not self.requests:
            return 0.0
        return max(r.arrival_time for r in self.requests)


def _cluster_prompt(rng, cluster_id: int, length: int) -> np.ndarray:
    """Prompt tokens = cluster signature tokens + shared noise tokens.

    Signature tokens are Zipf-distributed within the cluster's vocabulary
    slice — instruction datasets repeat template phrases, which is what makes
    short prompts retrievable in practice.
    """
    sig_base = (cluster_id * TOPIC_TOKENS) % (VOCAB // 2)
    n_sig = max((length * 3) // 5, 1)
    ranks = np.minimum(rng.zipf(1.6, n_sig) - 1, TOPIC_TOKENS - 1)
    sig = sig_base + ranks
    noise = (VOCAB // 2) + rng.integers(0, VOCAB // 2, length - n_sig)
    toks = np.concatenate([sig, noise])
    rng.shuffle(toks)
    return toks.astype(np.int32)


def generate_trace(cfg: TraceConfig) -> SyntheticTrace:
    rng = np.random.default_rng(cfg.seed)
    in_mu, in_sig, med_lo, med_hi, out_sig, out_cap = _DATASETS[cfg.dataset]

    # per-cluster output-length medians (lognormal-spaced between lo..hi).
    # Clusters are a *dataset* property (fixed rng), so history traces and
    # evaluation traces share topic semantics — the transfer the paper's
    # OpenChat-built DB relies on.
    rng_ds = np.random.default_rng(
        zlib.crc32(f"{cfg.dataset}/{cfg.n_clusters}".encode()))
    cluster_median = np.exp(rng_ds.uniform(np.log(med_lo), np.log(med_hi),
                                           cfg.n_clusters))

    t, requests = 0.0, []
    while t < cfg.duration:
        t += rng.exponential(1.0 / cfg.rate)
        if t >= cfg.duration:
            break
        c = int(rng.integers(cfg.n_clusters))
        prompt_len = int(np.clip(rng.lognormal(in_mu, in_sig), 4, 4096))
        out_len = int(np.clip(
            rng.lognormal(np.log(cluster_median[c]), cfg.length_noise * out_sig),
            1, out_cap))
        req = Request(prompt_len=prompt_len, arrival_time=t,
                      true_out_len=out_len,
                      prompt_tokens=_cluster_prompt(rng, c, prompt_len).tolist())
        requests.append(req)
        if cfg.max_requests and len(requests) >= cfg.max_requests:
            break
    return SyntheticTrace(requests=requests, cfg=cfg)


def clamp_requests(requests: List[Request], vocab: Optional[int] = None,
                   max_prompt: Optional[int] = None,
                   max_new: Optional[int] = None) -> List[Request]:
    """Adapt trace requests to a (small) real engine in place: trim prompts,
    cap output lengths, and remap tokens into [2, vocab) (0 = pad, 1 = eos).
    Keeps the arrival process and relative length mix intact."""
    for r in requests:
        if max_prompt is not None and r.prompt_len > max_prompt:
            r.prompt_len = max_prompt
            if r.prompt_tokens is not None:
                r.prompt_tokens = r.prompt_tokens[:max_prompt]
        if max_new is not None:
            r.true_out_len = max(min(r.true_out_len, max_new), 1)
        if vocab is not None and r.prompt_tokens is not None:
            r.prompt_tokens = [2 + (int(t) % (vocab - 2))
                               for t in r.prompt_tokens]
    return requests


def trace_stats(trace: SyntheticTrace) -> dict:
    ins = np.array([r.prompt_len for r in trace.requests])
    outs = np.array([r.true_out_len for r in trace.requests])
    return {
        "n": len(trace.requests),
        "input_mean": float(ins.mean()), "input_p50": float(np.median(ins)),
        "input_p99": float(np.percentile(ins, 99)),
        "output_mean": float(outs.mean()), "output_p50": float(np.median(outs)),
        "output_p99": float(np.percentile(outs, 99)),
        "output_cv": float(outs.std() / outs.mean()),
    }
