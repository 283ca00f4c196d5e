"""The host's plan of the paged decode kernel's split-KV (pure Python).

``csrc/paged_attention.cu`` runs one block per (b, kv-head, split); split
``s`` of a sequence owns pages ``[s * pps, (s + 1) * pps)`` with ``pps =
ceil(max_pages / nsplit)``.  The split count is chosen here from the shapes
alone (never from ``lengths``, which live on the device), so the wrapper
can size the scratch without a sync: about :data:`SPLIT_TOKENS` tokens a
split, halved while the grid would leave SMs without a block.  At run
time a split that starts past its sequence's length does nothing, a lane
with one live split writes its output from the body, and the merge pass
combines the others.  :func:`split_ranges` states that rule for given
lengths; everything here is deterministic.
"""
from __future__ import annotations

from typing import List, Tuple

SPLIT_TOKENS = 256   # tokens a split walks (vLLM's v2 partitions 512)
NUM_SMS = 132        # streaming multiprocessors of an H100 SXM


def num_splits(B: int, KVH: int, page: int, max_pages: int) -> int:
    """Splits of each sequence's page range: pages of about
    ``SPLIT_TOKENS`` tokens a split, fewer pages a split while ``B * KVH *
    nsplit`` blocks would not reach one per SM."""
    pps = max(1, min(max_pages, SPLIT_TOKENS // page))
    while pps > 1 and B * KVH * -(-max_pages // pps) < NUM_SMS:
        pps //= 2
    return -(-max_pages // pps)


def pages_per_split(max_pages: int, nsplit: int) -> int:
    """The pages one split owns (the kernel's ``pps``)."""
    return -(-max_pages // nsplit)


def scratch_floats(B: int, KVH: int, G: int, d: int, nsplit: int) -> int:
    """float32 scratch of the split: each split's partial accumulator (G x
    d) and (m, l) per head, for every (b, kv-head); 0 for one split."""
    if nsplit <= 1:
        return 0
    return B * KVH * nsplit * G * (d + 2)


def split_ranges(lengths, page: int, max_pages: int,
                 nsplit: int) -> List[List[Tuple[int, int]]]:
    """For each sequence, the page ranges ``[p0, p1)`` of its live splits,
    in split order, as the kernel walks them: the live pages ``[0,
    min(ceil(len / page), max_pages))`` cut every ``pps`` pages."""
    pps = pages_per_split(max_pages, nsplit)
    out = []
    for n in lengths:
        live = min(-(-int(n) // page), max_pages)
        out.append([(p0, min(live, p0 + pps)) for p0 in range(0, live, pps)])
    return out
