"""Model-free draft-token sources for speculative (verify-k) decoding.

The fused verify-k step (``Model.decode_verify_sampled`` /
``paged_decode_verify_sampled``) scores k draft tokens plus the fed token
in one call and accepts the longest prefix that exact-matches what
sequential sampling would have produced — so *any* draft source is safe:
a bad draft costs nothing but the wasted lane width, never a changed
output.  What a source needs to be is cheap (it runs on the host inside
the engine step loop) and right often enough on the repetitive traffic
that dominates serving (multi-turn resends, RAG quoting, code/JSON
boilerplate).

Two sources ship:

  * :class:`NGramDraftSource` — prompt-lookup decoding: the request's own
    prompt + generated tokens are the draft corpus.  An incremental
    n-gram index maps the sequence's current suffix to its most recent
    earlier occurrence and proposes the continuation that followed it.
  * :class:`RadixDraftSource` — the shared-prefix radix index
    (``serving/prefix_cache.py``) as a cross-request draft store: when
    the current sequence is a strict prefix of a previously *published*
    sequence (a multi-turn resend mid-generation, a shared template),
    the cached pages' token keys spell out the likely continuation.
    Touch-free lookups, so draft probes never perturb cache LRU order.

:class:`ChainDraftSource` composes sources first-hit-wins.  The interface
is deliberately tiny so a tiny proxy *model* drafter can slot in later
without touching the engine.

A copy of ``repro.serving.draft`` (pure Python, no JAX): the port keeps
its own, reading the port's ``RadixPageIndex``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


class DraftSource:
    """Interface: propose up to ``k`` draft tokens for a request."""

    def propose(self, rid: int, tokens: Sequence[int], k: int) -> List[int]:
        """Up to ``k`` predicted continuations of ``tokens`` (the request's
        prompt + generated stream).  May return fewer (or none) — the
        engine pads the verify dispatch and the padding is never matched.
        """
        raise NotImplementedError

    def release(self, rid: int) -> None:
        """Drop any per-request state (request finished or was dropped)."""


class NGramDraftSource(DraftSource):
    """Suffix-lookup drafts from the request's own token stream.

    Maintains, per request, an index from every n-gram (``min_n <= n <=
    max_n``) to the position right after its most recent occurrence; a
    propose matches the longest indexed suffix of the current stream and
    returns the tokens that followed it last time.  The index is extended
    incrementally (O(max_n) per new token), so repeated proposes over a
    growing stream stay cheap.
    """

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not 1 <= min_n <= max_n:
            raise ValueError(f"need 1 <= min_n <= max_n, got "
                             f"[{min_n}, {max_n}]")
        self.max_n = max_n
        self.min_n = min_n
        # rid -> (gram index, tokens-already-indexed watermark)
        self._state: Dict[int, Tuple[Dict[tuple, int], int]] = {}

    def _index_of(self, rid: int, tokens: Sequence[int]) -> Dict[tuple, int]:
        idx, done = self._state.get(rid, ({}, 0))
        if done > len(tokens):      # stream restarted (request id reuse)
            idx, done = {}, 0
        # index grams *ending* at positions [done, len-2]: a gram ending at
        # the final token has no continuation yet; it gets indexed on the
        # next propose, when the stream has grown past it
        for p in range(done, len(tokens) - 1):
            for n in range(self.min_n, self.max_n + 1):
                if p + 1 < n:
                    break
                idx[tuple(tokens[p + 1 - n:p + 1])] = p + 1
        self._state[rid] = (idx, max(done, len(tokens) - 1))
        return idx

    def propose(self, rid: int, tokens: Sequence[int], k: int) -> List[int]:
        if k <= 0 or len(tokens) < self.min_n + 1:
            return []
        idx = self._index_of(rid, tokens)
        for n in range(min(self.max_n, len(tokens)), self.min_n - 1, -1):
            pos = idx.get(tuple(tokens[len(tokens) - n:]))
            if pos is not None and pos < len(tokens):
                return list(tokens[pos:pos + k])
        return []

    def release(self, rid: int) -> None:
        self._state.pop(rid, None)


class RadixDraftSource(DraftSource):
    """Drafts from the shared-prefix cache's :class:`RadixPageIndex`.

    Useful exactly when the radix tree already holds a longer published
    sequence of which the current stream is a prefix — the indexed token
    keys past the match point *are* the draft.  All lookups are
    ``touch=False`` so speculative probes cannot pin cache entries ahead
    of real prefill hits.
    """

    def __init__(self, index):
        self.index = index          # RadixPageIndex (shared, not owned)

    def propose(self, rid: int, tokens: Sequence[int], k: int) -> List[int]:
        if self.index is None or k <= 0 or not tokens:
            return []
        try:
            full, partial = self.index.match(tokens, touch=False)
        except RuntimeError:        # racing a structural mutation: no draft
            return []
        pg = self.index.page_size
        matched = len(full) * pg
        if partial is not None:
            node, m = partial
            # only a *complete* consumption of the unmatched tail predicts
            # the continuation; a mid-tail divergence predicts nothing
            if matched + m == len(tokens) and m < len(node.key):
                return list(node.key[m:m + k])
            return []
        if matched != len(tokens):
            return []
        # page-aligned full match: any child continues the sequence — take
        # the most recently used branch
        children = full[-1].children if full else self.index.root
        if not children:
            return []
        node = max(children.values(), key=lambda n: n.last_used)
        return list(node.key[:k])

    def release(self, rid: int) -> None:
        pass                        # stateless per request


class ChainDraftSource(DraftSource):
    """First-hit-wins composition: try each source in order, return the
    first non-empty proposal."""

    def __init__(self, *sources: DraftSource):
        self.sources = [s for s in sources if s is not None]

    def propose(self, rid: int, tokens: Sequence[int], k: int) -> List[int]:
        for src in self.sources:
            drafts = src.propose(rid, tokens, k)
            if drafts:
                return drafts[:k]
        return []

    def release(self, rid: int) -> None:
        for src in self.sources:
            src.release(rid)


def make_draft_source(prefix_index=None, max_n: int = 3) -> DraftSource:
    """Default serving stack: radix-index drafts (when the shared-prefix
    cache is on) backed by prompt-lookup n-grams."""
    ngram = NGramDraftSource(max_n=max_n)
    if prefix_index is not None:
        return ChainDraftSource(RadixDraftSource(prefix_index), ngram)
    return ngram
