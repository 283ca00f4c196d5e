"""The host's plan of the bf16 flash body's blocks (pure Python).

``csrc/flash_prefill_wgmma.cuh`` packs the G = H / KVH query heads of one
kv-head into a block's 64 rows (P = 64 // G positions of each head), so a
call runs ``B * KVH * q_tiles`` blocks.  When those are too few to fill
the card, the key range of each block is split across ``nsplit`` blocks
and a merge pass combines their partials.  The split count is chosen here
from the shapes alone, so the wrapper can size the scratch without
reading ``start`` back from the device; the kernel's ``block_span`` then
cuts each block's visible keys into ``min(nsplit, its key tiles)`` ranges
of whole tiles, from its own ``start[b]``.  Everything here is
deterministic: the same call gives the same plan, and with it the same
bits.
"""
from __future__ import annotations

BLOCK_ROWS = 64      # packed query rows per block (wgmma's M)
BLOCK_KEYS = 64      # keys per tile
NUM_SMS = 132        # streaming multiprocessors of an H100 SXM


def rows_per_head(G: int) -> int:
    """P: the positions of each of the G heads in one block's rows (0 when
    G > 64, which the bf16 body does not take)."""
    return BLOCK_ROWS // G


def q_tiles(C: int, G: int) -> int:
    """Blocks along the chunk (or sequence) for one (b, kv-head)."""
    P = rows_per_head(G)
    return -(-C // P) if P else 0


def num_splits(B: int, KVH: int, G: int, C: int, Smax: int) -> int:
    """How many blocks share one block's key range: 1 when the unsplit grid
    has at least one block per SM, else as many as keep the grid within
    one wave (never more than the key tiles of the longest range)."""
    base = B * KVH * q_tiles(C, G)
    if base == 0 or base >= NUM_SMS:
        return 1
    return max(1, min(NUM_SMS // base, -(-Smax // BLOCK_KEYS)))


def scratch_floats(B: int, KVH: int, G: int, C: int, d: int,
                   nsplit: int) -> int:
    """float32 scratch the split needs: each split's partial accumulator
    (64 rows x d) and (m, l) per row for every (b, kv-head, q tile)."""
    if nsplit <= 1:
        return 0
    return nsplit * B * KVH * q_tiles(C, G) * BLOCK_ROWS * (d + 2)
