"""Hit-aware feature extraction for online length prediction.

The feature vector has two blocks:

* a **hashed token block** (signed n-gram hashing, the same frozen-encoder
  construction as :class:`~repro_torch.core.predictor.HashedNgramEncoder`) for
  requests that arrive with prompt token ids, and
* a small **context block** carrying everything the static predictors
  ignore: prompt length (continuous + log2 one-hot), the prefix-cache/tier
  hit watermark (``cached_prefix_hint`` — a hit changes both the effective
  prompt the model conditions on and the observed TPOT), the SLO class,
  a length-only flag, and (when the predictor supplies one) a
  **retrieval prior** — the similarity-weighted KNN log-length estimate
  plus its confidence, so the linear quantile heads calibrate *around* a
  strong nonparametric point estimate instead of re-deriving topic
  structure from hashed n-grams alone.

Length-only requests (simulator/replay traces without token ids) get a
zero token block and carry their signal entirely in the context block —
the dedicated length-feature path, never a fake single-token prompt.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.predictor import HashedNgramEncoder
from repro_torch.core.request import SLOClass

TOKEN_DIM = 192
CTX_DIM = 18
FEATURE_DIM = TOKEN_DIM + CTX_DIM

# log-length normalizer for the retrieval-prior slot (matches the
# predictor's _LOG_CAP prediction ceiling)
KNN_LOG_SCALE = 9.2

# context-block slots
_BIAS = 0
_LOG_LEN = 1
_LEN_BUCKET0 = 2          # 10 one-hot log2 buckets: [2, 11]
_N_LEN_BUCKETS = 10
_HIT_FRAC = 12
_HIT_FLAG = 13
_INTERACTIVE = 14
_LENGTH_ONLY = 15
_KNN_LOG = 16             # retrieval prior: knn log-length / KNN_LOG_SCALE
_KNN_CONF = 17            # its confidence (max neighbor similarity)


def knn_log_of(v: np.ndarray) -> float:
    """Recover the retrieval-prior log-length from a feature vector
    (0.0 = no prior was available).  Deterministic in the snapshot, so
    predict-time and drain-time reads of the same vector agree."""
    return float(v[v.shape[0] - CTX_DIM + _KNN_LOG]) * KNN_LOG_SCALE


class LengthFeaturizer:
    """Request -> fixed-width float32 feature vector."""

    def __init__(self, token_dim: int = TOKEN_DIM, seed: int = 0):
        self.token_dim = token_dim
        self.dim = token_dim + CTX_DIM
        self.encoder = HashedNgramEncoder(token_dim, seed)

    def features(self, prompt_tokens: Optional[Sequence[int]],
                 prompt_len: int, cached_prefix_hint: int = 0,
                 slo_class: Optional[SLOClass] = None,
                 token_emb: Optional[np.ndarray] = None,
                 knn_log: float = 0.0,
                 knn_conf: float = 0.0) -> np.ndarray:
        """``token_emb`` reuses a precomputed encoder output (the predictor
        encodes once for both the KNN lookup and the token block);
        ``knn_log``/``knn_conf`` carry the retrieval prior (0 = no DB or a
        cold one — the slots stay silent and the heads fall back to the
        token/context signal)."""
        v = np.zeros((self.dim,), np.float32)
        if token_emb is not None:
            v[:self.token_dim] = token_emb
            prompt_len = max(int(prompt_len), 1)
        elif prompt_tokens:
            v[:self.token_dim] = self.encoder.encode(prompt_tokens)
            prompt_len = len(prompt_tokens)
        c = self.token_dim
        v[c + _BIAS] = 1.0
        plen = max(int(prompt_len), 1)
        v[c + _LOG_LEN] = np.log1p(plen) / 8.0
        b = min(max(plen.bit_length() - 2, 0), _N_LEN_BUCKETS - 1)
        v[c + _LEN_BUCKET0 + b] = 1.0
        hit = max(int(cached_prefix_hint), 0)
        if hit > 0:
            v[c + _HIT_FRAC] = min(hit / plen, 1.0)
            v[c + _HIT_FLAG] = 1.0
        if slo_class == SLOClass.INTERACTIVE:
            v[c + _INTERACTIVE] = 1.0
        if token_emb is None and not prompt_tokens:
            v[c + _LENGTH_ONLY] = 1.0
        if knn_log > 0.0:
            v[c + _KNN_LOG] = min(knn_log / KNN_LOG_SCALE, 1.0)
            v[c + _KNN_CONF] = float(np.clip(knn_conf, 0.0, 1.0))
        return v
