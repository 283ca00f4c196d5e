"""Retrieval-based output-length prediction (paper §3.1, Algorithm 1).

Pipeline:  prompt --encoder--> embedding --vector-DB top-k--> if max
similarity >= s0: similarity-weighted average of neighbor lengths (case II);
else: all-MLP regression decoder on the embedding (case I).  After each
request finishes, the DB is updated with (embedding, true length).

Encoder: the paper uses a frozen pre-trained BERT.  Offline here, so the
frozen encoder is a hashed n-gram featurizer (deterministic, training-free) —
mechanism-identical (fixed text -> vector map); see DESIGN.md §4.

Baselines: ProxyPredictor (SSJF/S3-style regression model only, no DB) and
OraclePredictor (perfect lengths).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.vector_db import VectorDB

EMBED_DIM = 256


# ------------------------------------------------------------------ encoder

class HashedNgramEncoder:
    """Frozen text encoder: *signed* hashed unigram+bigram counts, L2-normed.

    Signed feature hashing (Weinberger et al.) gives collisions zero mean, so
    the shared background vocabulary cancels out and topical tokens dominate
    the cosine — the property the paper gets from a pre-trained BERT.
    """

    def __init__(self, dim: int = EMBED_DIM, seed: int = 0):
        self.dim = dim
        rng = np.random.default_rng(seed)
        self._salt1 = int(rng.integers(1, 2**31 - 1)) | 1
        self._salt2 = int(rng.integers(1, 2**31 - 1)) | 1
        self._salt3 = int(rng.integers(1, 2**31 - 1)) | 1

    def _feat(self, key: int) -> tuple[int, float]:
        h = (key * self._salt1) % 2_147_483_647
        sign = 1.0 if ((key * self._salt3) >> 3) & 1 else -1.0
        return h % self.dim, sign

    def encode(self, tokens: Sequence[int]) -> np.ndarray:
        v = np.zeros((self.dim,), np.float32)
        prev = -1
        for t in tokens:
            i, s = self._feat(t + 1)
            v[i] += s
            if prev >= 0:
                i2, s2 = self._feat((prev + 1) * 65_537 + t * self._salt2)
                v[i2] += 0.5 * s2
            prev = t
        n = np.linalg.norm(v)
        return v / max(n, 1e-9)


# -------------------------------------------------------------- MLP decoder

class MLPDecoder:
    """All-MLP regression head: embedding -> log(output length).  Numpy SGD
    (Adam) training; inference is two matmuls, so prediction latency is the
    ~µs the paper's Table 2 reports for the fallback path."""

    def __init__(self, dim: int = EMBED_DIM, hidden: int = 256, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.w1 = rng.standard_normal((dim, hidden)).astype(np.float32) / np.sqrt(dim)
        self.b1 = np.zeros((hidden,), np.float32)
        self.w2 = rng.standard_normal((hidden, 1)).astype(np.float32) / np.sqrt(hidden)
        self.b2 = np.zeros((1,), np.float32)
        self._adam = [np.zeros_like(p) for p in (self.w1, self.b1, self.w2, self.b2)
                      for _ in (0, 1)]
        self._t = 0

    def forward(self, x: np.ndarray) -> np.ndarray:
        h = np.maximum(x @ self.w1 + self.b1, 0.0)
        return (h @ self.w2 + self.b2)[..., 0]

    def predict(self, emb: np.ndarray) -> float:
        return float(np.exp(np.clip(self.forward(emb[None]), 0.0, 9.0))[0])

    def train(self, X: np.ndarray, y_len: np.ndarray, *, epochs: int = 60,
              batch: int = 256, lr: float = 3e-3, seed: int = 0) -> float:
        """Fit log-length regression; returns final RMSE in log space."""
        y = np.log(np.maximum(y_len.astype(np.float32), 1.0))
        rng = np.random.default_rng(seed)
        n = X.shape[0]
        b1, b2, eps = 0.9, 0.999, 1e-8
        for _ in range(epochs):
            order = rng.permutation(n)
            for i in range(0, n, batch):
                idx = order[i:i + batch]
                xb, yb = X[idx], y[idx]
                h_pre = xb @ self.w1 + self.b1
                h = np.maximum(h_pre, 0.0)
                pred = (h @ self.w2 + self.b2)[..., 0]
                g_out = (pred - yb)[:, None] * (2.0 / len(idx))
                gw2 = h.T @ g_out
                gb2 = g_out.sum(0)
                gh = (g_out @ self.w2.T) * (h_pre > 0)
                gw1 = xb.T @ gh
                gb1 = gh.sum(0)
                self._t += 1
                params = [self.w1, self.b1, self.w2, self.b2]
                grads = [gw1, gb1, gw2, gb2]
                for j, (p, g) in enumerate(zip(params, grads)):
                    m, v = self._adam[2 * j], self._adam[2 * j + 1]
                    m[...] = b1 * m + (1 - b1) * g
                    v[...] = b2 * v + (1 - b2) * g * g
                    mh = m / (1 - b1 ** self._t)
                    vh = v / (1 - b2 ** self._t)
                    p -= lr * mh / (np.sqrt(vh) + eps)
        pred = self.forward(X)
        return float(np.sqrt(np.mean((pred - y) ** 2)))


# ----------------------------------------------------------- predictor APIs

@dataclass
class Prediction:
    length: int
    source: str           # "retrieval" | "mlp" | "oracle" | "default" | ...
    latency_s: float      # wall time spent predicting
    # quantile surface (None/0 for point predictors): p90 is the calibrated
    # upper length quantile; spread = p90/p50 - 1 is the scale-free
    # uncertainty the scheduler's skip-join robustness gates on
    p90: Optional[int] = None
    spread: float = 0.0


@dataclass
class Feedback:
    """One completed- or in-flight-request observation, snapshotted off the
    request so the bounded queue never pins live scheduler state.  A
    ``censored`` item only asserts the true length *exceeds* ``length``
    (the request is still generating) — quantile learners use the
    under-prediction side of the pinball gradient; point learners skip it."""
    length: int                                  # generated so far / total
    prompt_len: int
    tokens: Optional[Sequence[int]] = None       # None = length-only request
    features: Optional[object] = None            # predict-time feature vector
    censored: bool = False
    cached_prefix_hint: int = 0
    slo_class: str = "batch"


def _len_bucket(prompt_len: int) -> int:
    """Log2 prompt-length bucket for the dedicated length-feature path."""
    return max(prompt_len, 1).bit_length()


class LengthPredictor:
    """Interface used by the scheduler.

    Prediction is synchronous (it prices the request being submitted);
    *learning* is not: finish/overrun feedback lands in a bounded queue via
    :meth:`observe` and is applied by :meth:`drain_feedback`, which the
    engine/simulator call between iterations — a slow or throwing
    ``update()`` can no longer stall the dispatch path.  Update latency is
    tracked separately from prediction latency so ``mean_latency_s`` (the
    TTFT admission term) stays an honest measure of on-path cost."""

    name = "base"
    _lat_sum = 0.0
    _lat_n = 0
    feedback_capacity = 4096        # bounded queue: oldest feedback dropped

    def predict(self, tokens: Sequence[int], true_len: Optional[int] = None) -> Prediction:
        raise NotImplementedError

    def update(self, tokens: Sequence[int], true_len: int) -> None:
        pass

    # ------------------------------------------------- request-level entry
    def predict_for(self, req) -> Prediction:
        """Predict from a :class:`~repro_torch.core.request.Request`: the token
        path when prompt ids exist, else the dedicated length-feature path
        (length-only simulator/replay traces are **not** encoded as a fake
        single-token prompt)."""
        if req.prompt_tokens:
            return self.predict(req.prompt_tokens, true_len=req.true_out_len)
        return self.predict_length_only(req.prompt_len,
                                        true_len=req.true_out_len)

    def predict_length_only(self, prompt_len: int,
                            true_len: Optional[int] = None) -> Prediction:
        """Length-feature path: per-log2-prompt-length-bucket running mean
        of observed output lengths, falling back to a constant prior while
        a bucket is cold.  Subclasses with a real length conditioner
        (oracle truth, learned features) override."""
        t0 = time.perf_counter()
        stats = self.__dict__.setdefault("_len_stats", {})
        n, s = stats.get(_len_bucket(prompt_len), (0, 0.0))
        est = (s / n) if n >= 4 else 128.0
        lat = time.perf_counter() - t0
        self._note_latency(lat)
        return Prediction(length=max(int(round(est)), 1),
                          source="len_bucket" if n >= 4 else "default",
                          latency_s=lat)

    def update_length_only(self, prompt_len: int, true_len: int) -> None:
        stats = self.__dict__.setdefault("_len_stats", {})
        b = _len_bucket(prompt_len)
        n, s = stats.get(b, (0, 0.0))
        stats[b] = (n + 1, s + float(true_len))

    def repredict(self, req) -> Optional[int]:
        """Mid-flight re-estimate once generation crosses the current
        prediction.  None = no better information; the scheduler falls back
        to its legacy doubling."""
        return None

    # ---------------------------------------------- bounded feedback queue
    def _fb_state(self):
        d = self.__dict__
        if "_feedback" not in d:
            d["_feedback"] = deque(maxlen=self.feedback_capacity)
            d["_feedback_lock"] = threading.Lock()
            d["_upd_lat_sum"] = 0.0
            d["_upd_n"] = 0
            d["_upd_errors"] = 0
        return d["_feedback"], d["_feedback_lock"]

    def observe(self, req, done: bool = True) -> None:
        """Enqueue feedback from a finished (``done``) or still-running
        (censored) request.  O(1), allocation-bounded, never calls
        ``update()`` — safe on the dispatch hot path."""
        fb, lock = self._fb_state()
        item = Feedback(
            length=req.generated, prompt_len=req.prompt_len,
            tokens=req.prompt_tokens, features=req.features,
            censored=not done, cached_prefix_hint=req.cached_prefix_hint,
            slo_class=getattr(req.slo_class, "value", str(req.slo_class)))
        with lock:
            fb.append(item)

    def drain_feedback(self, max_items: int = 64) -> int:
        """Apply at most ``max_items`` queued observations (called between
        iterations, off the dispatch path).  Exceptions are swallowed into
        a counter — learning must never kill a serve."""
        fb, lock = self._fb_state()
        applied = 0
        while applied < max_items:
            with lock:
                item = fb.popleft() if fb else None
            if item is None:
                break
            t0 = time.perf_counter()
            try:
                self._apply_feedback(item)
            except Exception:
                self.__dict__["_upd_errors"] = \
                    self.__dict__.get("_upd_errors", 0) + 1
            self.__dict__["_upd_lat_sum"] = \
                self.__dict__.get("_upd_lat_sum", 0.0) \
                + (time.perf_counter() - t0)
            self.__dict__["_upd_n"] = self.__dict__.get("_upd_n", 0) + 1
            applied += 1
        return applied

    def _apply_feedback(self, item: Feedback) -> None:
        """Default application: legacy point predictors learn only from
        completed requests (a censored length would bias their mean)."""
        if item.censored:
            return
        if item.tokens:
            self.update(item.tokens, item.length)
        else:
            self.update_length_only(item.prompt_len, item.length)

    def feedback_depth(self) -> int:
        fb, lock = self._fb_state()
        with lock:
            return len(fb)

    def mean_update_latency_s(self) -> float:
        n = self.__dict__.get("_upd_n", 0)
        return self.__dict__.get("_upd_lat_sum", 0.0) / n if n else 0.0

    def gauges(self) -> Dict[str, float]:
        """Telemetry snapshot merged into the replica gauge stream."""
        return {
            "predictor_feedback_depth": float(self.feedback_depth()),
            "predictor_update_lat_ms": self.mean_update_latency_s() * 1e3,
            "predictor_update_errors":
                float(self.__dict__.get("_upd_errors", 0)),
        }

    # ------------------------------------------------------------- latency
    def _note_latency(self, latency_s: float) -> None:
        self._lat_sum += latency_s
        self._lat_n += 1

    def mean_latency_s(self) -> float:
        """Running mean of observed prediction latency.  The gateway's
        TTFT-attainment admission adds this to its expected-TTFT estimate
        (the paper's Table 2 counts prediction time against TTFT).  Only
        on-path ``predict*`` time counts — queued-update application time
        is tracked separately in :meth:`mean_update_latency_s`."""
        return self._lat_sum / self._lat_n if self._lat_n else 0.0


class RetrievalPredictor(LengthPredictor):
    """The paper's predictor: vector DB + MLP fallback (Algorithm 1)."""

    name = "retrieval"

    def __init__(self, threshold: float = 0.22, k: int = 8,
                 dim: int = EMBED_DIM, use_lsh: bool = False,
                 db_capacity: int = 65536, seed: int = 0):
        self.encoder = HashedNgramEncoder(dim, seed)
        self.db = VectorDB(dim, capacity=db_capacity, use_lsh=use_lsh, seed=seed)
        self.mlp = MLPDecoder(dim, seed=seed)
        self.threshold = threshold
        self.k = k
        self.stats = {"retrieval": 0, "mlp": 0}

    def predict(self, tokens, true_len=None) -> Prediction:
        t0 = time.perf_counter()
        emb = self.encoder.encode(tokens)
        sims, lengths = self.db.search(emb, self.k)
        est = self.db.predict_from_neighbors(sims, lengths, self.threshold)
        if est is None:
            est = self.mlp.predict(emb)
            src = "mlp"
        else:
            src = "retrieval"
        self.stats[src] += 1
        lat = time.perf_counter() - t0
        self._note_latency(lat)
        return Prediction(length=max(int(round(est)), 1), source=src,
                          latency_s=lat)

    def update(self, tokens, true_len: int) -> None:
        emb = self.encoder.encode(tokens)
        self.db.add(emb, float(true_len))

    def pretrain(self, token_lists: List[Sequence[int]], lengths: np.ndarray,
                 warm_db_fraction: float = 0.5, epochs: int = 60) -> float:
        """Fit the MLP on a history corpus and warm the DB with part of it
        (the paper builds its DB from OpenChat and fine-tunes the decoder)."""
        X = np.stack([self.encoder.encode(t) for t in token_lists])
        rmse = self.mlp.train(X, np.asarray(lengths, np.float32), epochs=epochs)
        n_db = int(len(token_lists) * warm_db_fraction)
        for i in range(n_db):
            self.db.add(X[i], float(lengths[i]))
        return rmse


class ProxyPredictor(LengthPredictor):
    """Proxy-model baseline (SSJF / S^3): regression model only, no DB.

    ``extra_latency_s`` models the heavier DistilBERT-class proxy forward pass
    (paper Table 2 reports ~12ms vs ~4ms); we add it to the measured time when
    simulating and spin for it in engine mode.
    """

    name = "proxy"

    def __init__(self, dim: int = EMBED_DIM, extra_latency_s: float = 0.008,
                 noise: float = 0.35, seed: int = 0):
        self.encoder = HashedNgramEncoder(dim, seed)
        self.mlp = MLPDecoder(dim, seed=seed)
        self.extra_latency_s = extra_latency_s
        self.noise = noise
        self._rng = np.random.default_rng(seed + 1)

    def predict(self, tokens, true_len=None) -> Prediction:
        t0 = time.perf_counter()
        emb = self.encoder.encode(tokens)
        est = self.mlp.predict(emb)
        # proxy models are coarser (bucket classifiers); extra multiplicative noise
        est *= float(np.exp(self._rng.normal(0.0, self.noise)))
        lat = time.perf_counter() - t0 + self.extra_latency_s
        self._note_latency(lat)
        return Prediction(length=max(int(round(est)), 1), source="mlp",
                          latency_s=lat)

    def pretrain(self, token_lists, lengths, epochs: int = 60) -> float:
        X = np.stack([self.encoder.encode(t) for t in token_lists])
        return self.mlp.train(X, np.asarray(lengths, np.float32), epochs=epochs)


class OraclePredictor(LengthPredictor):
    name = "oracle"

    def predict(self, tokens, true_len=None) -> Prediction:
        assert true_len is not None, "oracle needs ground truth"
        return Prediction(length=int(true_len), source="oracle", latency_s=0.0,
                          p90=int(true_len))

    def predict_length_only(self, prompt_len, true_len=None) -> Prediction:
        return self.predict(None, true_len)


class DefaultPredictor(LengthPredictor):
    """FCFS systems don't predict; constant guess for bookkeeping only."""

    name = "default"

    def __init__(self, const: int = 128):
        self.const = const

    def predict(self, tokens, true_len=None) -> Prediction:
        return Prediction(length=self.const, source="default", latency_s=0.0)

    def predict_length_only(self, prompt_len, true_len=None) -> Prediction:
        return self.predict(None, true_len)
