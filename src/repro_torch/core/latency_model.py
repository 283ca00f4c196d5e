"""Analytical execution-time model (paper §3.1, Eq. 3-5).

    T_gen(s, n) = T_pre(s) + T_dec(s, n)
    T_pre(s)   ~= s * T0
    T_dec(s,n) ~= n * (alpha * s + beta)

Coefficients are fit from profiled samples (least squares), exactly as the
paper fits them from OPT-13B benchmarks (Fig. 5).  ``calibrated()`` returns
per-model constants derived from published V100 OPT numbers so the simulator
reproduces the paper's regime; engine mode re-fits them from real step
timings on this host.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Tuple

import numpy as np


@dataclass
class LatencyModel:
    t0: float       # prefill seconds per prompt token
    alpha: float    # decode seconds per context token (KV read)
    beta: float     # decode fixed seconds per iteration (weights read / launch)
    bucket_costs: Optional[Dict[int, float]] = field(default=None,
                                                     repr=False)
    # measured per-dispatch seconds for each warmed prefill-shape bucket
    # (engine warmup fills this); when present, a bucketed chunk is priced
    # at its *dispatch* cost — the whole padded shape — instead of its raw
    # span, so EWT sees the same iteration times the engine will produce.
    verify_cost: Optional[float] = None
    # measured seconds of one fused verify-k decode dispatch (engine warmup
    # fills this when speculative decoding is on); remaining-time estimates
    # with ``tokens_per_iter > 1`` price each iteration at no less than
    # this, so a lane that verifies k+1 positions per dispatch is not
    # priced as if a wide dispatch were free.

    def prefill_time(self, s: int) -> float:
        return s * self.t0

    def bucket_time(self, bucket: int) -> Optional[float]:
        """Measured dispatch seconds for a warmed shape bucket (None when
        the bucket was never warmed / no table exists)."""
        if self.bucket_costs:
            return self.bucket_costs.get(bucket)
        return None

    def prefill_chunk_time(self, start: int, size: int,
                           bucket: int = 0) -> float:
        """Cost of prefilling tokens [start, start+size) of a prompt.

        The first chunk (start=0) costs exactly ``prefill_time(size)``; a
        resumed chunk additionally re-reads the ``start`` tokens of prefix
        KV its queries attend over — the same per-context-token ``alpha``
        the decode model charges (Eq. 5 applied per chunk token).

        With a ``bucket`` and a warmed cost table, the base cost is the
        bucket's measured dispatch time (padding burns real compute);
        without a table the bucket still prices ``bucket * t0`` so the
        analytical estimate matches the dispatched shape."""
        base = size * self.t0
        if bucket:
            measured = self.bucket_time(bucket)
            base = measured if measured is not None else bucket * self.t0
        return base + self.alpha * size * start

    def prefill_pack_time(self, sizes, starts, bucket: int) -> float:
        """One packed dispatch covering ``len(sizes)`` equal-bucket chunks.

        The pack's base cost is a *single* bucket dispatch (that is the
        point of packing) — segment rows ride the same kernel launch —
        while each member still pays its own prefix cross-read
        ``alpha * size * start`` term."""
        base = self.bucket_time(bucket)
        if base is None:
            base = bucket * self.t0
        cross = sum(self.alpha * sz * st for sz, st in zip(sizes, starts))
        return base + cross

    def prefill_time_remaining(self, total: int, prefilled: int,
                               chunk: Optional[int] = None) -> float:
        """Remaining prefill cost for a (possibly partially) prefilled
        prompt of ``total`` tokens, executed in ``chunk``-token pieces
        (None/0 = one monolithic chunk).  Sums ``prefill_chunk_time`` over
        the chunks still to run."""
        prefilled = min(max(prefilled, 0), total)
        if prefilled >= total:
            return 0.0
        if not chunk:
            return self.prefill_chunk_time(prefilled, total - prefilled)
        t, start = 0.0, prefilled
        while start < total:
            size = min(chunk, total - start)
            t += self.prefill_chunk_time(start, size)
            start += size
        return t

    def first_chunk_time(self, s: int, chunk: Optional[int] = None) -> float:
        """Prefill latency until a prompt first occupies the accelerator:
        the whole prompt when monolithic, one chunk when chunked (later
        chunks interleave with resident decode work)."""
        return self.prefill_time(min(s, chunk) if chunk else s)

    def decode_iter_time(self, s: int) -> float:
        """One decode iteration for a job with context length s."""
        return self.alpha * s + self.beta

    def decode_time(self, s: int, n: int) -> float:
        return n * self.decode_iter_time(s)

    def total_time(self, s: int, n: int) -> float:
        return self.prefill_time(s) + self.decode_time(s, n)

    def remaining_time(self, s: int, generated: int, predicted: int,
                       prefilled, chunk: Optional[int] = None,
                       tokens_per_iter: float = 1.0) -> float:
        """Estimated remaining execution time (SRTF key).

        ``prefilled`` is the count of prompt tokens whose KV is already
        materialized (partially-prefilled jobs owe only their remaining
        chunks); legacy bool callers still work — True means fully
        prefilled, False means cold.  ``tokens_per_iter`` is the request's
        measured speculative emit rate (accepted drafts + 1 per verify-k
        dispatch): remaining tokens divide into that many fewer
        iterations, each priced at no less than the measured
        ``verify_cost`` dispatch time."""
        if isinstance(prefilled, bool):
            prefilled = s if prefilled else 0
        rem_tokens = max(predicted - generated, 1)
        per_iter = self.decode_iter_time(s + generated)
        if tokens_per_iter > 1.0 and self.verify_cost:
            per_iter = max(per_iter, self.verify_cost)
        t = (rem_tokens / max(tokens_per_iter, 1.0)) * per_iter
        t += self.prefill_time_remaining(s, prefilled, chunk)
        return t

    def budget_for_tpot(self, target_tpot: float, lanes: int,
                        ctx: float) -> Optional[int]:
        """Iteration token budget whose *predicted* mixed-iteration time
        matches a target TPOT (auto-tuning ``--iter-token-budget``).

        A budget-``T`` iteration serves ``lanes`` decode lanes (1 token
        each) plus ``T - lanes`` prefill-chunk tokens; its time is

            t(T) = decode_iter_time(ctx)                 (decode batch)
                 + (T - lanes) * (t0 + alpha * ctx)      (chunk tokens,
                                                          incl. the prefix
                                                          cross-read)

        ``ctx`` must be in the model's own decode-sample units: the
        engine fits ``alpha``/``beta`` against per-lane context with the
        whole batched iteration as ``y`` (``fit_latency_model`` feeds
        ``ctx/batch``), so the batch factor is already inside ``alpha``
        — do NOT multiply by ``lanes`` again.  Solving
        ``t(T) = target_tpot`` caps how much prefill one iteration may
        carry before resident lanes' TPOT degrades past the target.
        Returns None (unbounded) when the model has no fitted prefill
        cost; always leaves room for at least one prefill token so long
        prompts cannot livelock."""
        per_tok = self.t0 + self.alpha * max(ctx, 0.0)
        if per_tok <= 0.0:
            return None
        decode_t = self.decode_iter_time(max(ctx, 0.0))
        extra = max(target_tpot - decode_t, 0.0)
        return max(int(lanes + extra / per_tok), lanes + 1)

    # ------------------------------------------------------------------ fit
    @classmethod
    def fit(cls, prefill_samples: Iterable[Tuple[int, float]],
            decode_samples: Iterable[Tuple[int, float]]) -> "LatencyModel":
        """prefill_samples: (s, seconds); decode_samples: (context_len,
        seconds-per-iteration)."""
        ps = np.asarray(list(prefill_samples), np.float64)
        t0 = float((ps[:, 0] @ ps[:, 1]) / (ps[:, 0] @ ps[:, 0])) if len(ps) else 0.0
        ds = np.asarray(list(decode_samples), np.float64)
        if len(ds):
            A = np.stack([ds[:, 0], np.ones(len(ds))], axis=1)
            (alpha, beta), *_ = np.linalg.lstsq(A, ds[:, 1], rcond=None)
        else:
            alpha, beta = 0.0, 0.0
        return cls(t0=t0, alpha=float(max(alpha, 0.0)), beta=float(max(beta, 0.0)))

    def fit_error(self, prefill_samples, decode_samples) -> float:
        errs = []
        for s, t in prefill_samples:
            errs.append(abs(self.prefill_time(s) - t) / max(t, 1e-9))
        for s, t in decode_samples:
            errs.append(abs(self.decode_iter_time(s) - t) / max(t, 1e-9))
        return float(np.mean(errs)) if errs else 0.0


# Published-scale V100 constants (per GPU, FP16).  Derived from the paper's
# Fig. 5 regime for OPT-13B (prefill ~linear, ~55ms @ 512 tokens; decode
# ~45ms/iter at 1k context) and scaled by parameter count for siblings.
_CALIBRATION = {
    #            t0 (s/tok)  alpha (s/ctx-tok)  beta (s/iter)
    "opt-2.7b": (2.4e-5, 1.6e-6, 0.011),
    "opt-6.7b": (5.5e-5, 3.4e-6, 0.022),
    "opt-13b": (1.05e-4, 6.5e-6, 0.040),
    "llama-7b": (5.8e-5, 3.5e-6, 0.023),
    "llama-13b": (1.05e-4, 6.5e-6, 0.040),
    "pythia-12b": (1.0e-4, 6.2e-6, 0.038),
}


def calibrated(model_name: str) -> LatencyModel:
    if model_name in _CALIBRATION:
        t0, a, b = _CALIBRATION[model_name]
        return LatencyModel(t0=t0, alpha=a, beta=b)
    # fall back: scale from opt-13b by parameter count if available
    try:
        from repro_torch.configs import get_config
        n = get_config(model_name).param_count()
        ratio = n / 13e9
        t0, a, b = _CALIBRATION["opt-13b"]
        return LatencyModel(t0=t0 * ratio, alpha=a * ratio, beta=b * ratio)
    except Exception:
        return LatencyModel(*_CALIBRATION["opt-13b"])
