"""Online, hit-aware quantile length predictor.

Replaces the static per-request point prior on the serve path with a
hashed-feature quantile regressor (:class:`QuantileHeads`, p50/p90):

* **Hit-aware**: features condition on the prefix-cache/tier hit watermark
  and the SLO class (:mod:`.features`), so a multi-turn resend whose
  prefix is cached is priced as the short continuation it really is.
* **Online**: learns from completed-request feedback *and* censored
  in-flight feedback (overrun = "true length exceeds what we predicted"),
  applied off the dispatch hot path through the base class's bounded
  feedback queue (``observe``/``drain_feedback``).
* **Mid-flight re-prediction**: when generation crosses the current p50,
  :meth:`repredict` re-estimates the total from the class-conditional
  residual length distribution at a *decaying quantile level* (each
  successive overrun asks a more conservative quantile: 0.5, 0.75,
  0.875, ...), replacing blind doubling when enough history exists.
* **Calibrated uncertainty**: the p90 head carries an online
  conformal-style additive correction per SLO class — the adjustment
  integrates the coverage error (miss ⇒ widen, cover ⇒ shrink at 1/9 the
  rate) so empirical P90 coverage tracks nominal even when the regressor
  is conditionally misspecified.  Rolling pinball losses, coverage, and
  per-class MAE are exported as gauges.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.predictor import Feedback, LengthPredictor, Prediction
from repro_torch.core.vector_db import VectorDB
from repro_torch.serving.prediction.features import (TOKEN_DIM,
                                                     LengthFeaturizer,
                                                     knn_log_of)
from repro_torch.serving.prediction.quantile import QuantileHeads, pinball_loss

_LOG_CAP = 9.2            # exp(9.2) ~ 9900 tokens: sane prediction ceiling


@dataclass
class OnlineConfig:
    quantiles: tuple = (0.5, 0.9)
    lr: float = 0.08
    init_len: float = 96.0              # cold-start prior (log-space bias)
    conformal_eta: float = 0.03         # coverage-correction integrator step
    coverage_window: int = 512          # rolling telemetry window
    residual_window: int = 512          # per-class observed-length ring
    min_residual_n: int = 8             # tail samples needed to repredict
    feedback_capacity: int = 4096
    drain_max: int = 64                 # feedback items applied per drain
    # retrieval prior (Algorithm 1's DB, repurposed as a *feature*): the
    # similarity-weighted KNN log-length estimate rides the context block
    # so the heads calibrate around it instead of re-deriving topic
    # structure from hashed n-grams alone
    knn_k: int = 8
    knn_threshold: float = 0.22
    db_capacity: int = 65536
    pretrain_epochs: int = 2
    seed: int = 0


class OnlineQuantilePredictor(LengthPredictor):
    name = "online"

    def __init__(self, cfg: Optional[OnlineConfig] = None, seed: int = 0):
        self.cfg = cfg or OnlineConfig(seed=seed)
        self.feedback_capacity = self.cfg.feedback_capacity
        self.feat = LengthFeaturizer(seed=self.cfg.seed)
        # the heads regress *residual* log-length quantiles around the
        # base prior (KNN estimate when the DB hits, cold-start constant
        # otherwise) — zero-initialized, so before any learning the p50
        # IS the retrieval estimate and quantiles calibrate around it
        self.heads = QuantileHeads(self.feat.dim, self.cfg.quantiles,
                                   lr=self.cfg.lr, init_log_len=0.0)
        self.db = VectorDB(self.feat.token_dim,
                           capacity=self.cfg.db_capacity, seed=self.cfg.seed)
        self._adj: Dict[str, float] = {}            # class -> log-space p90 adj
        self._cov: Dict[str, deque] = {}            # class -> 0/1 window
        self._mae: Dict[str, deque] = {}            # class -> |err| window
        self._pinball: Dict[float, deque] = {
            q: deque(maxlen=self.cfg.coverage_window)
            for q in self.cfg.quantiles}
        self._resid: Dict[str, deque] = {}          # class -> observed lengths
        self.last_latency = 0.0
        self.stats = {"predicts": 0, "repredicts": 0, "updates": 0,
                      "censored": 0}

    # ---------------------------------------------------------- prediction
    def _cls_of(self, slo_class) -> str:
        return getattr(slo_class, "value", str(slo_class or "batch"))

    def _featurize(self, tokens, prompt_len: int,
                   cached_prefix_hint: int = 0,
                   slo_class=None) -> np.ndarray:
        """Encode once, query the retrieval DB for the prior, build the
        full feature vector.  Token-less requests skip both (length-only
        path)."""
        if not tokens:
            return self.feat.features(None, prompt_len, cached_prefix_hint,
                                      slo_class)
        emb = self.feat.encoder.encode(tokens)
        knn_log = knn_conf = 0.0
        sims, lengths = self.db.search(emb, self.cfg.knn_k)
        est = self.db.predict_from_neighbors(sims, lengths,
                                             self.cfg.knn_threshold)
        if est is not None and est > 0:
            knn_log = float(np.log(max(est, 1.0)))
            knn_conf = float(np.max(sims))
        return self.feat.features(None, len(tokens), cached_prefix_hint,
                                  slo_class, token_emb=emb,
                                  knn_log=knn_log, knn_conf=knn_conf)

    def _base_log(self, x: np.ndarray) -> float:
        """Prior the residual heads calibrate around: the KNN estimate
        carried in the feature snapshot, or the cold-start constant."""
        b = knn_log_of(x)
        return b if b > 0.0 else float(np.log(self.cfg.init_len))

    def _quantiles_from(self, x: np.ndarray, cls: str):
        base = self._base_log(x)
        logs = base + self.heads.predict_log(x)
        p50 = int(round(float(np.exp(np.clip(logs[0], 0.0, _LOG_CAP)))))
        l90 = logs[-1] + self._adj.get(cls, 0.0)
        p90 = int(round(float(np.exp(np.clip(l90, 0.0, _LOG_CAP)))))
        p50 = max(p50, 1)
        return p50, max(p90, p50)

    def _predict_x(self, x: np.ndarray, cls: str, t0: float) -> Prediction:
        p50, p90 = self._quantiles_from(x, cls)
        lat = time.perf_counter() - t0
        self._note_latency(lat)
        self.last_latency = lat
        self.stats["predicts"] += 1
        return Prediction(length=p50, source="online", latency_s=lat,
                          p90=p90, spread=p90 / p50 - 1.0)

    def predict_for(self, req) -> Prediction:
        t0 = time.perf_counter()
        x = self._featurize(req.prompt_tokens, req.prompt_len,
                            req.cached_prefix_hint, req.slo_class)
        req.features = x        # snapshotted by observe(); reused on drain
        return self._predict_x(x, self._cls_of(req.slo_class), t0)

    def predict(self, tokens: Sequence[int],
                true_len: Optional[int] = None) -> Prediction:
        t0 = time.perf_counter()
        x = self._featurize(tokens, len(tokens) if tokens else 1)
        return self._predict_x(x, "batch", t0)

    def predict_length_only(self, prompt_len: int,
                            true_len: Optional[int] = None) -> Prediction:
        t0 = time.perf_counter()
        x = self._featurize(None, prompt_len)
        return self._predict_x(x, "batch", t0)

    # ----------------------------------------------- mid-flight re-predict
    def repredict(self, req) -> Optional[int]:
        """Decaying residual-quantile estimate once ``req`` crosses its
        current prediction: condition the class's observed-length
        distribution on survival past ``generated`` and read it at
        ``q_k = 1 - 0.5^(k+1)`` for the k-th overrun.  Falls back to None
        (caller doubles) until the residual ring holds enough tail mass."""
        cls = self._cls_of(req.slo_class)
        ring = self._resid.get(cls)
        g = req.generated
        if ring is None:
            return None
        tail = [v for v in ring if v > g]
        if len(tail) < self.cfg.min_residual_n:
            return None
        k = getattr(req, "repredictions", 0)
        q = 1.0 - 0.5 ** (k + 1)
        new_p50 = int(round(float(np.quantile(tail, q))))
        new_p90 = int(round(float(np.quantile(tail, max(q, 0.9)))))
        req.predicted_p90 = max(new_p90, new_p50)
        self.stats["repredicts"] += 1
        return max(new_p50, g + 1)

    # ------------------------------------------------------------ learning
    def _apply_feedback(self, item: Feedback) -> None:
        x = item.features
        if x is None:
            x = self._featurize(item.tokens, item.prompt_len,
                                item.cached_prefix_hint)
        cls = item.slo_class
        y = max(int(item.length), 1)
        y_log = float(np.log(y))
        if item.censored:
            self.stats["censored"] += 1
            # the conformal correction also sees censored misses: if the
            # current p90 already lies below the survived length, coverage
            # is definitionally violated regardless of the final total
            _, p90 = self._quantiles_from(x, cls)
            if y > p90:
                self._adj[cls] = self._adj.get(cls, 0.0) \
                    + self.cfg.conformal_eta * 0.9
            self.heads.update(x, y_log - self._base_log(x), censored=True)
            return
        p50, p90 = self._quantiles_from(x, cls)
        covered = y <= p90
        # integrate the coverage error toward the 0.9 target: a miss widens
        # by eta*0.9, a cover shrinks by eta*0.1 — zero drift at 90% hits
        self._adj[cls] = self._adj.get(cls, 0.0) + self.cfg.conformal_eta \
            * ((0.0 if covered else 1.0) - 0.1)
        win = self.cfg.coverage_window
        self._cov.setdefault(cls, deque(maxlen=win)).append(int(covered))
        self._mae.setdefault(cls, deque(maxlen=win)).append(abs(y - p50))
        for q, d in self._pinball.items():
            pred = p50 if q == 0.5 else p90
            d.append(pinball_loss(float(y), float(pred), q))
        self._resid.setdefault(
            cls, deque(maxlen=self.cfg.residual_window)).append(y)
        self.heads.update(x, y_log - self._base_log(x))
        emb = x[:TOKEN_DIM]
        if float(np.abs(emb).sum()) > 0.0:      # token block = the embedding
            self.db.add(np.array(emb, np.float32), float(y))
        self.stats["updates"] += 1

    def update(self, tokens: Sequence[int], true_len: int) -> None:
        """Synchronous interface-compat update (benchmarks/offline eval);
        the serve path goes through observe()/drain_feedback instead."""
        self._apply_feedback(Feedback(
            length=int(true_len),
            prompt_len=len(tokens) if tokens else 1,
            tokens=list(tokens) if tokens else None))

    def update_length_only(self, prompt_len: int, true_len: int) -> None:
        self._apply_feedback(Feedback(length=int(true_len),
                                      prompt_len=prompt_len))

    def drain_feedback(self, max_items: Optional[int] = None) -> int:
        return super().drain_feedback(max_items or self.cfg.drain_max)

    def pretrain(self, token_lists: List[Sequence[int]], lengths,
                 epochs: Optional[int] = None) -> None:
        """Warm start from a history corpus (same role as the retrieval
        predictor's DB warmup), **prequentially**: samples are shuffled and
        each one is featurized against the DB state its predecessors built
        before it is applied as feedback.  The residual targets the heads
        train on therefore come from the same base-prior dynamics serving
        produces — seeding the DB from a block prefix instead (e.g. one
        dataset of a mixed corpus) biases the pretrain-time base low/high
        and the heads bake the compensation in as pure serve-time bias.
        Extra epochs refine the heads on the snapshotted features."""
        lens = np.asarray(lengths, np.float32)
        if not len(lens):
            return
        idx = np.random.default_rng(self.cfg.seed).permutation(len(lens))
        feats: List[np.ndarray] = []
        order: List[int] = []
        for i in idx:
            t = token_lists[i]
            plen = len(t) if t else 1
            x = self._featurize(t, plen)
            self._apply_feedback(Feedback(length=int(lens[i]),
                                          prompt_len=plen, features=x))
            feats.append(x)
            order.append(int(i))
        extra = (epochs or self.cfg.pretrain_epochs) - 1
        if extra > 0:
            X = np.stack(feats)
            self.heads.fit(X, lens[order], epochs=extra,
                           seed=self.cfg.seed,
                           base_log=[self._base_log(x) for x in X])

    # ----------------------------------------------------------- telemetry
    def coverage(self, slo_class: str = "batch") -> Optional[float]:
        d = self._cov.get(slo_class)
        return (sum(d) / len(d)) if d else None

    def pinball(self, q: float) -> Optional[float]:
        d = self._pinball.get(q)
        return (float(np.mean(d)) if d else None)

    def mae(self, slo_class: str = "batch") -> Optional[float]:
        d = self._mae.get(slo_class)
        return (float(np.mean(d)) if d else None)

    def gauges(self) -> Dict[str, float]:
        g = super().gauges()
        for q in self.cfg.quantiles:
            v = self.pinball(q)
            if v is not None:
                g[f"predictor_pinball{int(q * 100)}"] = v
        for cls, d in self._cov.items():
            if d:
                g[f"predictor_cov90_{cls}"] = sum(d) / len(d)
        for cls, d in self._mae.items():
            if d:
                g[f"predictor_mae_{cls}"] = float(np.mean(d))
        g["predictor_repredicts"] = float(self.stats["repredicts"])
        g["predictor_updates"] = float(self.stats["updates"])
        return g
