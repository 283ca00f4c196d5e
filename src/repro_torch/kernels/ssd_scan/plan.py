"""The host's plan of the SSD chunk kernel's bodies and blocks (pure Python).

``csrc/ssd_chunk.cu`` has two bodies.  The tensor-core body
(``csrc/ssd_chunk_tf32x3.cuh``) takes chunks of up to :data:`MAX_Q` rows
with head dim :data:`TC_P` and state size :data:`TC_N` (mamba2-2.7b's) in
tensors whose addresses are multiples of 16 bytes; every other shape takes
the FMA body.  The choice is made here, from the shapes and addresses,
before the launch: :func:`body`.  A head of ``2 * TC_P`` columns
(jamba's 128) takes the tensor-core body too, as two heads of
:data:`TC_P` with the same decay (:func:`head_split`): the columns of a
head never mix, since ``y[q, p]`` reads only ``xbar[:, p]`` (through the
scores ``C . B^T``, which the body shares across heads) and
``states[p, :]`` only column ``p``.

The tensor-core body's second kernel runs one block per (b, c, 64-row q
tile, group of heads).  A block of q tile ``i`` reads ``i + 1`` tiles of
xbar for each of its heads, so its work is about ``(i + 1) x heads``;
:func:`heads_per_block` sizes the groups so that every block gets about
the same work and the grid makes about :data:`WAVES` waves of
:data:`BLOCKS_PER_SM` blocks on each of the card's SMs (enough blocks that
the last wave's tail is short).  :func:`y_blocks` lists the blocks in the
kernel's order: the last q tiles first, then the groups, the (b, c) index
fastest.  Everything here is deterministic.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

Q_TILE = 64          # query rows of a y block (and of a score tile)
MAX_Q = 256          # chunk rows the tensor-core body takes
TC_P, TC_N = 64, 128  # the head dim and state size it takes
MAX_GROUP = 16       # heads of a y block (their cumsums in shared memory)
NUM_SMS = 132        # streaming multiprocessors of an H100 SXM
BLOCKS_PER_SM = 2    # y blocks resident on an SM (registers: ~200 a thread)
WAVES = 1            # waves the y grid aims at
# one (b, c, q tile)'s scores: 4 warps x 32 n-tiles x 32 lanes x 4 floats
SCORE_FLOATS = 4 * (MAX_Q // 8) * 32 * 4

BODIES = ("fma", "tf32x3_states", "tf32x3_y")


def head_split(P: int) -> int:
    """Heads of :data:`TC_P` columns that one head of ``P`` columns runs as
    on the tensor-core body: 2 for P 128, else 1."""
    return 2 if P == 2 * TC_P else 1


def body(Q: int, P: int, N: int, addresses: Sequence[int] = ()) -> str:
    """``"tf32x3"`` (the tensor-core body) for Q <= 256, P 64 or 128 (as
    :func:`head_split` heads of 64), N 128 and addresses that are
    multiples of 16 bytes, else ``"fma"``."""
    ok = (1 <= Q <= MAX_Q and P in (TC_P, 2 * TC_P) and N == TC_N
          and all(a % 16 == 0 for a in addresses))
    return "tf32x3" if ok else "fma"


def q_tiles(Q: int) -> int:
    return -(-Q // Q_TILE)


def heads_per_block(n_bc: int, Q: int, H: int) -> List[int]:
    """Heads of a y block for each q tile: about ``target / (i + 1)`` for q
    tile ``i``, ``target`` the work units (q tile + 1 a head) that spread
    the grid over :data:`WAVES` waves; within [1, min(H, MAX_GROUP)]."""
    n = q_tiles(Q)
    units = n_bc * H * n * (n + 1) // 2
    target = max(1, -(-units // (NUM_SMS * BLOCKS_PER_SM * WAVES)))
    top = min(H, MAX_GROUP)
    return [max(1, min(top, (2 * target + i + 1) // (2 * (i + 1))))
            for i in range(n)]


def y_blocks(n_bc: int, Q: int, H: int,
             heads: Sequence[int] = None) -> List[Tuple[int, int, int, int]]:
    """The y kernel's blocks in its order: ``(bc, q tile, h0, h1)``, heads
    ``[h0, h1)``: each q tile's H heads cut into ``ceil(H / heads)`` groups
    whose sizes differ by at most one."""
    heads = heads_per_block(n_bc, Q, H) if heads is None else heads
    out = []
    for qt in range(q_tiles(Q) - 1, -1, -1):
        n_g = -(-H // heads[qt])       # groups of near-equal size
        for grp in range(n_g):
            for bc in range(n_bc):
                out.append((bc, qt, grp * H // n_g, (grp + 1) * H // n_g))
    return out


def score_floats(n_bc: int, Q: int) -> int:
    """float32 scratch of the scores: one tile per (b, c, q tile)."""
    return n_bc * q_tiles(Q) * SCORE_FLOATS
