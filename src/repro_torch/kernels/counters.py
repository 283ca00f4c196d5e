"""The kernels' launch counters, read and advanced together.

Each wrapper counts its launches in its ``launches`` attribute, bumped on
the host when it launches, and four libraries count their device bodies in
the launch entry (``body_launches()`` of the flash, paged-attention, SSD
and kv_quant wrappers).  A replayed CUDA graph launches its captured
kernels without running either, so the step-graph runner
(``serving/step_graphs.py``) reads every counter around a capture
(:func:`snapshot`), takes back what the capture counted (a capture
launches nothing) and adds that difference again on every replay
(:func:`advance`).  The counts then read the same under replay as under
eager runs.  Reads and advances hold ``_build.COUNT_LOCK``, which every
wrapper holds across its launch and its count, so threads that launch
and replay at once (replicas under the gateway's concurrent pump) lose no
count.
"""
from __future__ import annotations

from typing import Dict, Hashable

from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill import ops as _flash
from repro_torch.kernels.fused_rmsnorm import ops as _rmsnorm
from repro_torch.kernels.kv_quant import ops as _kv_quant
from repro_torch.kernels.paged_attention import ops as _paged
from repro_torch.kernels.ssd_scan import ops as _ssd

WRAPPERS = {
    "paged_attention": _paged.paged_attention,
    "flash_prefill_prefix": _flash.flash_prefill_prefix,
    "flash_prefill": _flash.flash_prefill,
    "kv_quantize": _kv_quant.kv_quantize,
    "kv_quantize_store": _kv_quant.kv_quantize_store,
    "kv_dequantize": _kv_quant.kv_dequantize,
    "paged_attention_q8": _kv_quant.paged_attention_q8,
    "fused_rmsnorm": _rmsnorm.fused_rmsnorm,
    # row 7's split-row entries (a row's columns over the ``model`` ranks)
    "rmsnorm_sumsq": _rmsnorm.rmsnorm_sumsq,
    "rmsnorm_apply": _rmsnorm.rmsnorm_apply,
    "ssd_chunk": _ssd.ssd_chunk,
}
# library (csrc/<name>.cu) -> the wrapper module whose body_launches()
# reads its body counters
BODIES = {"flash_prefill_prefix": _flash, "paged_attention": _paged,
          "ssd_chunk": _ssd, "kv_quant": _kv_quant}


def snapshot() -> Dict[Hashable, int]:
    """Every wrapper's launches (keyed by name) and the body counters of
    every library already loaded (keyed by ``(library, body)``); a library
    not loaded yet is not loaded to read it."""
    with _build.COUNT_LOCK:
        out: Dict[Hashable, int] = {n: f.launches
                                    for n, f in WRAPPERS.items()}
        for lib, mod in BODIES.items():
            if _build.loaded(lib):
                out.update({(lib, k): n
                            for k, n in mod.body_launches().items()})
    return out


def delta(before: Dict[Hashable, int],
          after: Dict[Hashable, int]) -> Dict[Hashable, int]:
    """The counters that moved from ``before`` to ``after``, by how much."""
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


def advance(moved: Dict[Hashable, int], times: int = 1) -> None:
    """Add ``times`` x ``moved`` (a :func:`delta`) to the counters."""
    with _build.COUNT_LOCK:
        for key, n in moved.items():
            if isinstance(key, tuple):
                lib, body = key
                BODIES[lib].REPLAYED[body] += n * times
            else:
                WRAPPERS[key].launches += n * times
