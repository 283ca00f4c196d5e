"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels are built for
``sm_90a`` at first use) and skip without one.  They import nothing of JAX,
so they run where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Shapes sweep beyond the serving path's own (which ``chip_smoke.py``
checks): GQA group sizes 1 to 8, head dims 64 and 128, pages of 8 to 32
tokens, chunk lengths that are not multiples of the query tile, and rows
that see a single key.  Tolerances are those of ``tests/test_kernels.py``:
float32 2e-5, bfloat16 5e-2, INT8 codes within 1.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _tol(dtype):
    return 5e-2 if dtype == torch.bfloat16 else 2e-5


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(device=dev, dtype=dtype)


@pytest.mark.parametrize("B,H,KVH,d,page,npages,maxp", [
    (2, 4, 2, 64, 16, 16, 4), (4, 8, 8, 128, 32, 64, 4),
    (1, 8, 1, 64, 8, 8, 8), (3, 6, 2, 128, 16, 32, 6),
    (8, 32, 8, 128, 16, 129, 16),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel(dev, B, H, KVH, d, page, npages, maxp, dtype):
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_ref)
    rng = np.random.default_rng(B + H + page)
    q = _randn(rng, (B, H, d), dtype, dev)
    kc = _randn(rng, (npages, page, KVH, d), dtype, dev)
    vc = _randn(rng, (npages, page, KVH, d), dtype, dev)
    tables = torch.from_numpy(rng.integers(0, npages, (B, maxp))
                              .astype(np.int32)).to(dev)
    lengths = rng.integers(1, maxp * page + 1, (B,)).astype(np.int32)
    lengths[0] = 1                  # an inactive lane: one key, slot 0
    lengths = torch.from_numpy(lengths).to(dev)
    n0 = paged_attention.launches
    out = paged_attention(q, kc, vc, tables, lengths)
    torch.cuda.synchronize()
    assert paged_attention.launches == n0 + 1
    ref = paged_attention_ref(q, kc, vc, tables, lengths)
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.parametrize("B,H,KVH,Smax,d,C", [
    (1, 4, 4, 64, 64, 16), (2, 8, 2, 128, 64, 24), (1, 8, 1, 256, 128, 8),
    (2, 4, 4, 96, 128, 24), (1, 32, 8, 2048, 128, 200),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_prefill_prefix_kernel(dev, B, H, KVH, Smax, d, C, dtype):
    from repro_torch.kernels.flash_prefill import (flash_prefill_prefix,
                                                   flash_prefill_prefix_ref)
    rng = np.random.default_rng(Smax + C)
    q = _randn(rng, (B, H, C, d), dtype, dev)
    # strided k/v, as the model passes them
    k = _randn(rng, (B, Smax, KVH, d), dtype, dev).transpose(1, 2)
    v = _randn(rng, (B, Smax, KVH, d), dtype, dev).transpose(1, 2)
    start = rng.integers(0, Smax - C + 1, (B,)).astype(np.int32)
    start[0] = 0
    start = torch.from_numpy(start).to(dev)
    out = flash_prefill_prefix(q, k, v, start)
    torch.cuda.synchronize()
    ref = flash_prefill_prefix_ref(q, k, v, start)
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.parametrize("T,d", [(128, 64), (256, 128), (1000, 128),
                                 (40 * 16 * 8, 128)])
def test_kv_quant_kernels(dev, T, d):
    from repro_torch.kernels.kv_quant import (kv_dequantize,
                                              kv_dequantize_ref, kv_quantize,
                                              kv_quantize_ref)
    rng = np.random.default_rng(T)
    x = _randn(rng, (T, d), torch.float32, dev) * 4.0
    q, lam, z = kv_quantize(x)
    qr, lamr, zr = kv_quantize_ref(x)
    torch.cuda.synchronize()
    assert (q.int() - qr.int()).abs().max().item() <= 1
    torch.testing.assert_close(lam, lamr, atol=0, rtol=1e-6)
    assert (z - zr).abs().max().item() <= 1
    for dtype in (torch.float32, torch.bfloat16):
        xh = kv_dequantize(q, lam, z, dtype=dtype)
        torch.testing.assert_close(xh, kv_dequantize_ref(q, lam, z, dtype),
                                   atol=_tol(dtype), rtol=_tol(dtype))
    rel = ((kv_dequantize(q, lam, z) - x).abs().max() / x.abs().max()).item()
    assert rel < 0.02


def test_kernels_reject_what_they_do_not_take(dev):
    from repro_torch.kernels.kv_quant import kv_quantize
    from repro_torch.kernels.paged_attention import paged_attention
    with pytest.raises(ValueError):
        kv_quantize(torch.zeros((4, 8), device=dev).t())     # not contiguous
    with pytest.raises(TypeError):
        paged_attention(torch.zeros((1, 2, 8), device=dev),
                        torch.zeros((2, 4, 1, 8), device=dev),
                        torch.zeros((2, 4, 1, 8), device=dev),
                        torch.zeros((1, 2), dtype=torch.int64, device=dev),
                        torch.ones((1,), dtype=torch.int32, device=dev))
