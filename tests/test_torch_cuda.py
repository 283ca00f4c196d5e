"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels are built for
``sm_90a`` at first use) and skip without one.  They import nothing of JAX,
so they run where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Shapes sweep beyond the serving path's own (which ``chip_smoke.py``
checks): GQA group sizes 1 to 8, head dims 64 and 128, pages of 8 to 32
tokens, chunk lengths that are not multiples of the query tile, rows that
see a single key, RMSNorm widths that are not multiples of the block, and
SSD chunks whose length, head dim and state size are not multiples of the
kernel's tiles.  Tolerances are those of ``tests/test_kernels.py`` and
``tests/test_kernels_ssd.py``: float32 2e-5, bfloat16 5e-2, INT8 codes
within 1, the SSD chunk 1e-4 up to its test shapes (see ``_ssd_tol``).
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


@pytest.mark.parametrize("T,d", [(1, 64), (7, 2560), (300, 4096),
                                 (33, 5120), (5, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
def test_fused_rmsnorm_kernel(dev, T, d, dtype, scale_dtype):
    from repro_torch.kernels.fused_rmsnorm import fused_rmsnorm, rmsnorm_ref
    rng = np.random.default_rng(T + d)
    x = _randn(rng, (T, d), dtype, dev) * 3.0
    s = _randn(rng, (d,), scale_dtype, dev)
    n0 = fused_rmsnorm.launches
    out = fused_rmsnorm(x, s)
    torch.cuda.synchronize()
    assert fused_rmsnorm.launches == n0 + 1 and out.dtype == dtype
    torch.testing.assert_close(out.float(), rmsnorm_ref(x, s).float(),
                               atol=_tol(dtype), rtol=_tol(dtype))


def _ssd_tol(Q, N):
    """1e-4 (``tests/test_kernels_ssd.py``) up to its shapes (Q * N <= 64 *
    16); beyond them float32 accumulation error grows with the square root
    of the sums' lengths (N in C . B^T, Q in the sums over s), and so does
    the tolerance."""
    return 1e-4 * max(1.0, (Q * N / 1024) ** 0.5)


@pytest.mark.parametrize("B,C,Q,H,P,N", [
    (1, 2, 16, 2, 16, 16), (2, 4, 32, 4, 16, 16), (1, 2, 64, 2, 32, 8),
    (1, 3, 37, 3, 24, 40), (2, 1, 100, 2, 64, 128), (1, 4, 256, 80, 64, 128),
    (1, 1, 1024, 2, 128, 256),
])
def test_ssd_chunk_kernel(dev, B, C, Q, H, P, N):
    from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_ref
    rng = np.random.default_rng(Q + H + N)
    xbar = _randn(rng, (B, C, Q, H, P), torch.float32, dev)
    dA = -_randn(rng, (B, C, Q, H), torch.float32, dev).abs() * 0.1
    Bc = _randn(rng, (B, C, Q, N), torch.float32, dev)
    Cc = _randn(rng, (B, C, Q, N), torch.float32, dev)
    n0 = ssd_chunk.launches
    out = ssd_chunk(xbar, dA, Bc, Cc)
    torch.cuda.synchronize()
    assert ssd_chunk.launches == n0 + 1
    for o, r in zip(out, ssd_chunk_ref(xbar, dA, Bc, Cc)):
        assert torch.isfinite(o).all()
        tol = _ssd_tol(Q, N)
        torch.testing.assert_close(o, r, atol=tol, rtol=tol)


def test_ssd_chunked_kernel_path_matches_plain(dev):
    """The model's SSD scan at a ragged length (padded to whole chunks) with
    an initial state: the kernel path against the plain path."""
    from repro_torch.models.mamba2 import ssd_chunked
    rng = np.random.default_rng(11)
    B, S, H, P, N = 2, 300, 4, 64, 128
    x = _randn(rng, (B, S, H, P), torch.bfloat16, dev)
    dt = torch.nn.functional.softplus(_randn(rng, (B, S, H), torch.float32,
                                             dev))
    A = -torch.exp(_randn(rng, (H,), torch.float32, dev) * 0.2)
    Bm = _randn(rng, (B, S, N), torch.bfloat16, dev)
    Cm = _randn(rng, (B, S, N), torch.bfloat16, dev)
    s0 = _randn(rng, (B, H, P, N), torch.float32, dev)
    y, s = ssd_chunked(x, dt, A, Bm, Cm, chunk=256, initial_state=s0)
    yr, sr = ssd_chunked(x, dt, A, Bm, Cm, chunk=256, initial_state=s0,
                         use_kernel=False)
    torch.testing.assert_close(y.float(), yr.float(), atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(s, sr, atol=1e-3, rtol=1e-3)


def test_kernels_reject_what_they_do_not_take(dev):
    from repro_torch.kernels.kv_quant import kv_quantize
    from repro_torch.kernels.paged_attention import paged_attention
    with pytest.raises(ValueError):
        kv_quantize(torch.zeros((4, 8), device=dev).t())     # not contiguous
    from repro_torch.kernels.fused_rmsnorm import fused_rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_chunk
    with pytest.raises(ValueError):
        fused_rmsnorm(torch.zeros((8, 4), device=dev).t(),    # not contiguous
                      torch.ones((8,), device=dev))
    with pytest.raises(TypeError):
        z = torch.zeros((1, 1, 4, 1, 4), dtype=torch.bfloat16, device=dev)
        ssd_chunk(z, z[..., 0], z[:, :, :, 0], z[:, :, :, 0])
    with pytest.raises(ValueError):                         # Q > 1024
        z = torch.zeros((1, 1, 1025, 1, 4), device=dev)
        ssd_chunk(z, z[..., 0].contiguous(), z[:, :, :, 0].contiguous(),
                  z[:, :, :, 0].contiguous())
    with pytest.raises(TypeError):
        paged_attention(torch.zeros((1, 2, 8), device=dev),
                        torch.zeros((2, 4, 1, 8), device=dev),
                        torch.zeros((2, 4, 1, 8), device=dev),
                        torch.zeros((1, 2), dtype=torch.int64, device=dev),
                        torch.ones((1,), dtype=torch.int32, device=dev))
