"""Published peaks of one NVIDIA H100 SXM (data sheet; dense rates): a
copy of the constants in ``src/repro_torch/launch/roofline.py`` (lines
34-35) and ``chip_smoke.py``.  They assume the card's full 700 W; the run
records the card's name beside every share of them."""
from __future__ import annotations

BF16_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12    # device memory bandwidth, B/s


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the bandwidth and the operations over the bf16 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)
