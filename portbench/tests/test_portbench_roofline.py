"""The kernels' operations and bytes at the shapes of PERF.md's kernel
table (rows 1 and 2: granite's decode and chunk shapes), the peaks, and
the model step's operations."""
import dataclasses

import numpy as np
import pytest

from portbench import spec
from portbench.arch import from_config
from portbench.roofline import (flash_prefill_prefix, model_step,
                                paged_attention, peaks)


def granite(layers=1):
    a = from_config(spec.cell("granite-3-8b.sharegpt.r80").config)
    return dataclasses.replace(a, layers=layers)


def test_peaks_are_the_data_sheets():
    assert peaks.BF16_FLOPS == 989e12 and peaks.HBM_BYTES_PER_S == 3.35e12
    assert peaks.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 989e12) == pytest.approx(1.0)


def test_paged_attention_at_the_kernel_tables_shape():
    # row 1: B 8, H 32, KVH 8, d 128, lengths 1..2048: bound 0.0101 ms
    # (bytes), chip_smoke.check_paged_attention's count less the block
    # table's few kilobytes
    toks = int(np.linspace(1, 2048, 8).astype(np.int32).sum())
    ms = paged_attention.step_bound_s(granite(), 8, toks) * 1e3
    assert ms == pytest.approx(0.0101, rel=0.02)
    # bytes bind: K/V of every attended position read once
    kv = 2 * toks * 8 * 128 * 2
    assert ms * 1e-3 >= kv / peaks.HBM_BYTES_PER_S


def test_flash_prefix_at_the_kernel_tables_shape():
    # row 2: C 256 at position 1000, H 32, KVH 8, d 128: 0.0048 ms
    # (operations)
    ms = flash_prefill_prefix.chunk_bound_s(granite(), 1000, 1256) * 1e3
    assert ms == pytest.approx(0.0048, rel=0.01)
    visible = 256 * 1000 + 256 * 257 // 2
    assert ms * 1e-3 == pytest.approx(4.0 * visible * 32 * 128
                                      / peaks.BF16_FLOPS)


def test_bounds_scale_with_layers():
    one, forty = granite(1), granite(40)
    assert paged_attention.step_bound_s(forty, 32, 16000) == pytest.approx(
        40 * paged_attention.step_bound_s(one, 32, 16000))
    assert flash_prefill_prefix.chunk_bound_s(forty, 0, 256) == \
        pytest.approx(40 * flash_prefill_prefix.chunk_bound_s(one, 0, 256))


def test_model_step_operations():
    a = granite(40)
    # granite-3.0-8b: about 8.2 B parameters, tied
    assert 8.0e9 < a.active_params() < 8.4e9
    f = model_step.decode_flops(a, 32, 16000)
    assert f == pytest.approx(2 * a.active_params() * 32
                              + 4 * 40 * 16000 * 32 * 128)
    moe = from_config(spec.cell("granite-moe-3b-a800m.sharegpt.r80").config)
    # 8 of 40 experts a token: about 0.8 B active of 3.3 B
    assert 0.75e9 < moe.active_params() < 0.95e9
