"""Operations and bytes of the prefix flash-attention kernel
(``src/repro_torch/csrc/flash_prefill_prefix.cu``) in one prefill chunk,
as ``chip_smoke.py``'s ``check_flash_prefix`` counts them: the chunk's
queries read and its output written once (bf16), the K and V of every
position up to the chunk's end read once, 4 operations per visible
(query, key) pair, head and head dim.  Only the chunk's real tokens count,
not the rows its bucket pads.  Kernel names: the bodies and the
split-key merge (``flash_attn_*``)."""
from __future__ import annotations

from portbench.arch import Arch
from portbench.roofline.peaks import bound_s

KERNELS = ("flash_attn",)


def chunk_bound_s(a: Arch, start: int, end: int) -> float:
    """The bound of the kernel's launches for a chunk of positions
    ``[start, end)`` (each layer one launch)."""
    C = end - start
    visible = C * start + C * (C + 1) // 2
    qo = 2 * C * a.heads * a.head_dim * 2
    kv = 2 * end * a.kv_heads * a.head_dim * 2
    return a.layers * bound_s(qo + kv, 4.0 * visible * a.heads * a.head_dim)
