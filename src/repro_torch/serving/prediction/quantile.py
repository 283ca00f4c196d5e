"""Online linear quantile regression in log-length space.

Two heads (p50/p90 by default) share one feature vector; each head is
trained with the pinball-loss subgradient — for quantile ``q`` the
gradient w.r.t. the prediction is ``-q`` when the target lies above it and
``1 - q`` below — under a per-coordinate AdaGrad step for stability on the
sparse hashed features.  A **censored** observation (an in-flight request
that has generated ``y`` tokens so far only asserts ``true >= y``) applies
just the under-prediction side: valid for the exceedance indicator the
pinball gradient is built from, and exactly the in-flight feedback signal
the scheduler's overrun path produces.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def pinball_loss(y: float, pred: float, q: float) -> float:
    d = y - pred
    return q * d if d >= 0 else (q - 1.0) * d


class QuantileHeads:
    def __init__(self, dim: int, quantiles: Tuple[float, ...] = (0.5, 0.9),
                 lr: float = 0.35, init_log_len: float = np.log(96.0)):
        self.dim = dim
        self.quantiles = tuple(quantiles)
        self.lr = lr
        nq = len(self.quantiles)
        self.w = np.zeros((nq, dim), np.float32)
        self.b = np.full((nq,), init_log_len, np.float32)
        # AdaGrad accumulators floored at 1.0: with a near-zero floor the
        # first touch of every coordinate is a full ±lr jump (g/sqrt(g^2)),
        # which wrecks a residual head that should start near zero
        self._gw = np.full((nq, dim), 1.0, np.float32)
        self._gb = np.full((nq,), 1.0, np.float32)
        self.n_updates = 0

    def predict_log(self, x: np.ndarray) -> np.ndarray:
        """Per-quantile log-length predictions, monotone-enforced via a
        running max (crossing heads are a known quantile-SGD artifact)."""
        out = self.w @ x + self.b
        return np.maximum.accumulate(out)

    def update(self, x: np.ndarray, y_log: float,
               censored: bool = False) -> None:
        for i, q in enumerate(self.quantiles):
            pred = float(self.w[i] @ x + self.b[i])
            if y_log > pred:
                g = -q
            elif censored:
                continue       # only the exceedance side is known
            else:
                g = 1.0 - q
            gx = g * x
            self._gw[i] += gx * gx
            self._gb[i] += g * g
            self.w[i] -= self.lr * gx / np.sqrt(self._gw[i])
            self.b[i] -= self.lr * g / np.sqrt(self._gb[i])
        self.n_updates += 1

    def fit(self, X: np.ndarray, y_len: Sequence[float],
            epochs: int = 4, seed: int = 0,
            base_log: Sequence[float] = None) -> None:
        """Multi-epoch warm start over a history corpus (online SGD passes
        in shuffled order — the same updates serving would have applied).
        ``base_log`` shifts targets into residual space (heads that
        calibrate around a per-sample prior)."""
        y = np.log(np.maximum(np.asarray(y_len, np.float32), 1.0))
        if base_log is not None:
            y = y - np.asarray(base_log, np.float32)
        rng = np.random.default_rng(seed)
        for _ in range(epochs):
            for i in rng.permutation(len(y)):
                self.update(X[i], float(y[i]))
