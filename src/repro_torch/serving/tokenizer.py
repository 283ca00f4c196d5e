"""Toy byte-level tokenizer for the runnable examples (no external vocab)."""
from __future__ import annotations

from typing import List

BOS, EOS, PAD = 256, 257, 258
VOCAB_SIZE = 259


def encode(text: str, add_bos: bool = True) -> List[int]:
    toks = list(text.encode("utf-8"))
    return ([BOS] if add_bos else []) + toks


def decode(tokens) -> str:
    body = bytes(t for t in tokens if 0 <= int(t) < 256)
    return body.decode("utf-8", errors="replace")
