"""Vector database for the retrieval-based length predictor (paper §3.1).

Exact cosine top-k over normalized embeddings, plus an optional LSH
(random-hyperplane) index for sub-linear candidate generation at scale —
the paper's "query database"; entries are (embedding, observed output length).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class VectorDB:
    def __init__(self, dim: int, capacity: int = 65536,
                 use_lsh: bool = False, lsh_bits: int = 12, seed: int = 0):
        self.dim = dim
        self.capacity = capacity
        self.vectors = np.zeros((capacity, dim), np.float32)
        self.lengths = np.zeros((capacity,), np.float32)
        self.n = 0
        self._write = 0                      # ring-buffer eviction when full
        self.use_lsh = use_lsh
        if use_lsh:
            rng = np.random.default_rng(seed)
            self._planes = rng.standard_normal((dim, lsh_bits)).astype(np.float32)
            self._buckets: dict[int, list[int]] = {}
            self._slot_hash = np.full((capacity,), -1, np.int64)

    # ------------------------------------------------------------------
    @staticmethod
    def _normalize(v: np.ndarray) -> np.ndarray:
        v = np.asarray(v, np.float32)
        return v / max(np.linalg.norm(v), 1e-9)

    def _hash(self, v: np.ndarray) -> int:
        bits = (v @ self._planes) > 0
        return int(sum(int(b) << i for i, b in enumerate(bits)))

    def add(self, vec: np.ndarray, length: float) -> None:
        v = self._normalize(vec)
        slot = self._write
        if self.use_lsh:
            old = self._slot_hash[slot]
            if old >= 0 and slot in self._buckets.get(old, ()):  # evict old entry
                self._buckets[old].remove(slot)
            h = self._hash(v)
            self._buckets.setdefault(h, []).append(slot)
            self._slot_hash[slot] = h
        self.vectors[slot] = v
        self.lengths[slot] = float(length)
        self._write = (self._write + 1) % self.capacity
        self.n = min(self.n + 1, self.capacity)

    def search(self, vec: np.ndarray, k: int = 8) -> Tuple[np.ndarray, np.ndarray]:
        """Return (similarities, lengths) of the top-k nearest stored queries."""
        if self.n == 0:
            return np.zeros((0,), np.float32), np.zeros((0,), np.float32)
        v = self._normalize(vec)
        if self.use_lsh:
            h = self._hash(v)
            cand = self._buckets.get(h, [])
            # probe neighboring buckets (1-bit flips) if the bucket is thin
            if len(cand) < k:
                for i in range(self._planes.shape[1]):
                    cand = cand + self._buckets.get(h ^ (1 << i), [])
                    if len(cand) >= 4 * k:
                        break
            if not cand:
                return np.zeros((0,), np.float32), np.zeros((0,), np.float32)
            idx = np.asarray(sorted(set(cand)), np.int64)
        else:
            idx = np.arange(self.n, dtype=np.int64)
        sims = self.vectors[idx] @ v
        top = np.argsort(-sims)[:k]
        return sims[top], self.lengths[idx[top]]

    def predict_from_neighbors(self, sims: np.ndarray, lengths: np.ndarray,
                               threshold: float, temp: float = 0.05) -> Optional[float]:
        """Similarity-weighted average over neighbors above threshold (Alg. 1
        case II); None if no neighbor clears the threshold (-> MLP fallback).
        Softmax weighting (temperature ``temp``) sharpens toward the closest
        neighbors; lengths are averaged in log space (they are lognormal)."""
        keep = sims >= threshold
        if not keep.any():
            return None
        s = sims[keep]
        w = np.exp((s - s.max()) / temp)
        w /= w.sum()
        return float(np.exp((w * np.log(np.maximum(lengths[keep], 1.0))).sum()))
