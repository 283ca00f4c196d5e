"""Synthetic LM data pipeline: deterministic and restart-safe, the torch
twin of ``repro.training.data`` (own copy; no mesh).

Batches are a pure function of (seed, step), made with numpy exactly as the
reference makes them, so a restarted job resumes the exact data order from
its checkpoint step and both frameworks see the same tokens.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.utils import resolve_device


@dataclass
class DataConfig:
    batch_size: int = 8
    seq_len: int = 128
    seed: int = 0
    # synthetic structure: orderless-markov bigram-ish stream so loss falls
    n_patterns: int = 97


class SyntheticLM:
    """Learnable synthetic stream: next token = f(prev token) + noise."""

    def __init__(self, cfg: ArchConfig, data_cfg: DataConfig):
        self.cfg = cfg
        self.dc = data_cfg
        rng = np.random.default_rng(data_cfg.seed)
        v = cfg.vocab_size
        self.succ = rng.integers(0, v, size=(v,), dtype=np.int64)

    def batch_at(self, step: int) -> dict:
        """``{"tokens", "targets"}``: (B, S) int32 numpy arrays."""
        dc = self.dc
        rng = np.random.default_rng((dc.seed, step))
        B, S = dc.batch_size, dc.seq_len
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = rng.integers(0, self.cfg.vocab_size, B)
        noise = rng.random((B, S)) < 0.1
        rand = rng.integers(0, self.cfg.vocab_size, (B, S))
        for t in range(S):
            nxt = self.succ[toks[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}

    def iterate(self, start_step: int = 0,
                device=None) -> Iterator[dict]:
        """Batches from ``start_step`` on, as int32 tensors on ``device``
        (the card unless the caller asks for another)."""
        dev = resolve_device(device)
        step = start_step
        while True:
            yield {k: torch.from_numpy(v).to(dev)
                   for k, v in self.batch_at(step).items()}
            step += 1
