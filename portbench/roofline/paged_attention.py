"""Operations and bytes of the paged decode-attention kernel
(``src/repro_torch/csrc/paged_attention.cu``) in one decode step, as
``chip_smoke.py``'s ``check_paged_attention`` counts them: each active
lane's query read and output written once (bf16), the K and V of every
position it attends read once, 4 operations per attended position, head
and head dim (QK and PV).  Kernel names: the split-KV body and its
merge."""
from __future__ import annotations

from portbench.arch import Arch
from portbench.roofline.peaks import bound_s

KERNELS = ("paged_attention_kernel", "paged_attention_merge_kernel")


def step_bound_s(a: Arch, lanes: int, ctx_tokens: int) -> float:
    """The bound of the kernel's launches in one decode step of ``lanes``
    active lanes attending ``ctx_tokens`` positions in all (each layer one
    launch)."""
    qo = 2 * lanes * a.heads * a.head_dim * 2
    kv = 2 * ctx_tokens * a.kv_heads * a.head_dim * 2
    flops = 4.0 * ctx_tokens * a.heads * a.head_dim
    return a.layers * bound_s(qo + kv, flops)
