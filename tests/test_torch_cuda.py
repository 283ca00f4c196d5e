"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels are built for
``sm_90a`` at first use) and skip without one.  They import nothing of JAX,
so they run where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Shapes sweep beyond the serving and training paths' own (which
``chip_smoke.py`` checks): GQA group sizes 1 to 8, head dims 64 and 128,
pages of 8 to 32 tokens, chunk and sequence lengths that are not multiples
of the query tile, rows that see a single key, causal and bidirectional
full-sequence attention, RMSNorm widths that are not multiples of the
block, and SSD chunks whose length, head dim and state size are not
multiples of the kernel's tiles.  The two autograd Functions' gradients
are held against autograd through the plain versions, and the smoke
config's loss and gradients on the card with kernels against those
without.  Tolerances are those of ``tests/test_kernels.py`` and
``tests/test_kernels_ssd.py``: float32 2e-5, bfloat16 5e-2, INT8 codes
within 1, the SSD chunk 1e-4 up to its test shapes (see ``_ssd_tol``);
the others are stated in each test.
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


@pytest.mark.parametrize("B,H,KVH,S,d", [
    (1, 4, 4, 64, 64), (2, 8, 2, 128, 64), (1, 8, 1, 256, 128),
    (2, 4, 4, 96, 128), (1, 4, 2, 1, 64), (2, 8, 2, 1000, 128),
    (1, 8, 2, 37, 64), (4, 32, 8, 1024, 128),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_prefill_kernel(dev, B, H, KVH, S, d, dtype, causal):
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_ref)
    rng = np.random.default_rng(S + d + causal)
    # strided q/k/v, as chunked_attention passes them: (B, S, H, d)
    # tensors viewed as (B, H, S, d)
    q = _randn(rng, (B, S, H, d), dtype, dev).transpose(1, 2)
    k = _randn(rng, (B, S, KVH, d), dtype, dev).transpose(1, 2)
    v = _randn(rng, (B, S, KVH, d), dtype, dev).transpose(1, 2)
    n0 = flash_prefill.launches
    out = flash_prefill(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_prefill.launches == n0 + 1
    ref = flash_prefill_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_gradients_match_plain(dev, causal):
    """FlashPrefill's forward (the kernel) within 2e-5 of the plain
    version; its backward (the plain version, recomputed) against autograd
    through the plain version, f32, at a ragged S."""
    from repro_torch.kernels.flash_prefill import (FlashPrefill,
                                                   flash_prefill_ref)
    rng = np.random.default_rng(11)
    shapes = ((2, 8, 200, 128), (2, 2, 200, 128), (2, 2, 200, 128))
    base = [_randn(rng, s, torch.float32, dev) for s in shapes]
    go = _randn(rng, shapes[0], torch.float32, dev)
    ins_a = [t.clone().requires_grad_(True) for t in base]
    ins_b = [t.clone().requires_grad_(True) for t in base]
    out_a = FlashPrefill.apply(*ins_a, causal)
    out_b = flash_prefill_ref(*ins_b, causal=causal)
    torch.testing.assert_close(out_a, out_b, atol=2e-5, rtol=2e-5)
    for ga, gb in zip(torch.autograd.grad(out_a, ins_a, go),
                      torch.autograd.grad(out_b, ins_b, go)):
        torch.testing.assert_close(ga, gb, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_function_gradients_match_plain(dev, dtype):
    from repro_torch.kernels.fused_rmsnorm import FusedRMSNorm, rmsnorm_ref
    rng = np.random.default_rng(12)
    x = _randn(rng, (300, 4096), dtype, dev) * 3
    s = (1 + 0.1 * _randn(rng, (4096,), torch.float32, dev)).to(dtype)
    go = _randn(rng, (300, 4096), dtype, dev)
    ins_a = [t.clone().requires_grad_(True) for t in (x, s)]
    ins_b = [t.clone().requires_grad_(True) for t in (x, s)]
    out_a = FusedRMSNorm.apply(*ins_a, 1e-5)
    out_b = rmsnorm_ref(*ins_b, 1e-5)
    torch.testing.assert_close(out_a.float(), out_b.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))
    for ga, gb in zip(torch.autograd.grad(out_a, ins_a, go),
                      torch.autograd.grad(out_b, ins_b, go)):
        torch.testing.assert_close(ga.float(), gb.float(), atol=_tol(dtype),
                                   rtol=_tol(dtype))


def test_train_step_of_the_smoke_config(dev):
    """The smoke granite config in float32, with heads of 64 (the flash
    kernel takes head dims 64 and 128), on the card: its
    loss and gradients through the flash and RMSNorm kernels against
    ``use_kernels=False`` on the same params and batch (loss within 1e-5
    relative, each gradient leaf nonzero and within a relative L2 of
    1e-4), then one AdamW step on the kernel path with a finite loss."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.fused_rmsnorm import fused_rmsnorm
    from repro_torch.models.model import Model
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    from repro_torch.utils import tree_leaves
    cfg = get_smoke_config("granite-3-8b").scaled(param_dtype="float32",
                                                  head_dim=64)
    batch = next(SyntheticLM(cfg, DataConfig(batch_size=4, seq_len=64))
                 .iterate(device=dev))
    model = Model(cfg, attn_chunk=32, device=dev)
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(0))
    leaves = [p for _, p in tree_leaves(state["params"])]
    out = {}
    for use in (True, False):
        model.use_kernels = use
        n0 = (flash_prefill.launches, fused_rmsnorm.launches)
        loss, _ = model.loss(state["params"], batch)
        grads = torch.autograd.grad(loss, leaves)
        n1 = (flash_prefill.launches, fused_rmsnorm.launches)
        assert (n1[0] > n0[0] and n1[1] > n0[1]) == use
        out[use] = (float(loss), grads)
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-5)
    for a, b in zip(out[True][1], out[False][1]):
        assert float(a.abs().max()) > 0
        assert float((a - b).norm() / b.norm()) <= 1e-4
    model.use_kernels = True
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=1))
    state, m = step(state, batch)
    assert np.isfinite(float(m["loss"]))
    assert all(torch.isfinite(p).all() for p in leaves)
