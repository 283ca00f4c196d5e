"""The port's kernels on the CPU against the JAX package's Pallas kernels
(interpret mode, as ``tests/test_kernels.py`` runs them) and its ``ref.py``
oracles, on the same inputs made with numpy from a seed.

On a CPU tensor each wrapper takes its plain PyTorch version, so these tests
pin the arithmetic the CUDA kernels are held to on the card (by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``).  Tolerances are those
of ``tests/test_kernels.py``: float32 2e-5, bfloat16 5e-2, INT8 codes
within 1.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_prefill.flash_prefill import \
    flash_prefill_prefix as jax_flash_prefix  # noqa: E402
from repro.kernels.flash_prefill.ref import \
    flash_prefill_prefix_ref as jax_flash_prefix_ref  # noqa: E402
from repro.kernels.kv_quant import (kv_dequantize_op, kv_quantize_op,  # noqa: E402
                                    kv_quantize_ref as jax_quantize_ref)
from repro.kernels.paged_attention import (  # noqa: E402
    paged_attention_ref as jax_paged_ref, paged_decode_attention)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_prefill import flash_prefill_prefix  # noqa: E402
from repro_torch.kernels.kv_quant import (kv_dequantize, kv_dequantize_ref,  # noqa: E402
                                          kv_quantize, kv_quantize_ref)
from repro_torch.kernels.paged_attention import (gather_pages,  # noqa: E402
                                                 paged_attention)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return 5e-2 if name == "bfloat16" else 2e-5


def _both(a, name):
    """The same float32 numpy values as a jnp and a torch tensor of the
    dtype ``name`` (float32 -> bfloat16 rounds to nearest even in both)."""
    jdt, tdt = DTYPES[name]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------- paged attention

# the shape sweep of tests/test_kernels.py::test_paged_attention_sweep
@pytest.mark.parametrize("B,H,KVH,d,page,npages,maxp", [
    (2, 4, 2, 64, 16, 16, 4), (4, 8, 8, 128, 32, 64, 4),
    (1, 8, 1, 64, 8, 8, 8), (3, 6, 2, 128, 16, 32, 6),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_matches_jax(B, H, KVH, d, page, npages, maxp, dtype):
    rng = np.random.default_rng(B * 1000 + H * 10 + page)
    qj, qt = _both(rng.standard_normal((B, H, d)).astype(np.float32), dtype)
    kj, kt = _both(rng.standard_normal((npages, page, KVH, d))
                   .astype(np.float32), dtype)
    vj, vt = _both(rng.standard_normal((npages, page, KVH, d))
                   .astype(np.float32), dtype)
    tables = rng.integers(0, npages, (B, maxp)).astype(np.int32)
    lengths = rng.integers(1, maxp * page + 1, (B,)).astype(np.int32)
    out = paged_attention(qt, kt, vt, torch.from_numpy(tables),
                          torch.from_numpy(lengths))
    assert out.dtype == qt.dtype and tuple(out.shape) == (B, H, d)
    pallas = paged_decode_attention(qj, kj, vj, jnp.asarray(tables),
                                    jnp.asarray(lengths), interpret=True)
    oracle = jax_paged_ref(qj, kj, vj, jnp.asarray(tables),
                           jnp.asarray(lengths))
    tol = _tol(dtype)
    np.testing.assert_allclose(_np(out), _np(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(out), _np(oracle), atol=tol, rtol=tol)


def test_paged_attention_respects_lengths():
    """Tokens past ``lengths`` (and the pages holding them) never reach the
    output, as in the JAX test of the same name."""
    rng = np.random.default_rng(5)
    B, H, KVH, d, page, npg, maxp = 1, 2, 2, 64, 8, 8, 4
    q = torch.from_numpy(rng.standard_normal((B, H, d)).astype(np.float32))
    kc = torch.from_numpy(rng.standard_normal((npg, page, KVH, d))
                          .astype(np.float32))
    vc = torch.from_numpy(rng.standard_normal((npg, page, KVH, d))
                          .astype(np.float32))
    tables = torch.arange(maxp, dtype=torch.int32)[None]
    lengths = torch.tensor([11], dtype=torch.int32)
    out1 = paged_attention(q, kc, vc, tables, lengths)
    kc2, vc2 = kc.clone(), vc.clone()
    kc2[1, 3:] = 999.0              # token 11 onwards, then whole pages
    vc2[1, 3:] = 999.0
    kc2[2:] = 999.0
    vc2[2:] = 999.0
    out2 = paged_attention(q, kc2, vc2, tables, lengths)
    torch.testing.assert_close(out1, out2, atol=1e-6, rtol=0)


def test_gather_pages_matches_jax():
    rng = np.random.default_rng(6)
    cache = rng.standard_normal((6, 4, 2, 8)).astype(np.float32)
    tables = rng.integers(0, 6, (3, 5)).astype(np.int32)
    from repro.kernels.paged_attention.ref import gather_pages as jax_gather
    np.testing.assert_array_equal(
        gather_pages(torch.from_numpy(cache), torch.from_numpy(tables)).numpy(),
        np.asarray(jax_gather(jnp.asarray(cache), jnp.asarray(tables))))


# ------------------------------------------------------ prefix flash prefill

# the (B, H, KVH, S, d) sweep of tests/test_kernels.py::
# test_flash_prefill_sweep with S as the stripe length Smax, each with a
# chunk length C (24 is no power of two: the CUDA kernel masks the ragged
# edge of its 64-row query tile)
@pytest.mark.parametrize("B,H,KVH,Smax,d,C", [
    (1, 4, 4, 64, 64, 16), (2, 8, 2, 128, 64, 24), (1, 8, 1, 256, 128, 16),
    (2, 4, 4, 96, 128, 24),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_prefill_prefix_matches_jax(B, H, KVH, Smax, d, C, dtype):
    rng = np.random.default_rng(Smax + C + d)
    qj, qt = _both(rng.standard_normal((B, H, C, d)).astype(np.float32), dtype)
    kj, kt = _both(rng.standard_normal((B, KVH, Smax, d)).astype(np.float32),
                   dtype)
    vj, vt = _both(rng.standard_normal((B, KVH, Smax, d)).astype(np.float32),
                   dtype)
    start = rng.integers(0, Smax - C + 1, (B,)).astype(np.int32)
    start[0] = 0                    # a chunk at the head of the stripe
    out = flash_prefill_prefix(qt, kt, vt, torch.from_numpy(start))
    assert out.dtype == qt.dtype and tuple(out.shape) == (B, H, C, d)
    pallas = jax_flash_prefix(qj, kj, vj, jnp.asarray(start), q_blk=8,
                              kv_blk=32, interpret=True)
    oracle = jax_flash_prefix_ref(qj, kj, vj, jnp.asarray(start))
    tol = _tol(dtype)
    np.testing.assert_allclose(_np(out), _np(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(out), _np(oracle), atol=tol, rtol=tol)


def test_flash_prefill_prefix_takes_strided_views():
    """The model passes transposed views of the page-gathered stripe; the
    result must not depend on the layout."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((1, 4, 8, 16))
                         .astype(np.float32))
    kg = torch.from_numpy(rng.standard_normal((1, 32, 2, 16))
                          .astype(np.float32))
    vg = torch.from_numpy(rng.standard_normal((1, 32, 2, 16))
                          .astype(np.float32))
    start = torch.tensor([9], dtype=torch.int32)
    strided = flash_prefill_prefix(q, kg.transpose(1, 2), vg.transpose(1, 2),
                                   start)
    dense = flash_prefill_prefix(q, kg.transpose(1, 2).contiguous(),
                                 vg.transpose(1, 2).contiguous(), start)
    torch.testing.assert_close(strided, dense, atol=0, rtol=0)


# ----------------------------------------------------------------- kv quant

# the sweep of tests/test_kernels.py::test_kv_quant_roundtrip_sweep
@pytest.mark.parametrize("T,d", [(128, 64), (256, 128), (512, 64)])
def test_kv_quant_matches_jax(T, d):
    x = (np.random.default_rng(T + d).standard_normal((T, d)) * 4.0
         ).astype(np.float32)
    q, lam, z = kv_quantize(torch.from_numpy(x))
    assert (q.dtype, tuple(q.shape)) == (torch.int8, (T, d))
    assert tuple(lam.shape) == tuple(z.shape) == (T, 1)
    for jq, jlam, jz in (kv_quantize_op(jnp.asarray(x), interpret=True),
                         jax_quantize_ref(jnp.asarray(x))):
        assert np.abs(q.numpy().astype(np.int32)
                      - np.asarray(jq, np.int32)).max() <= 1
        np.testing.assert_allclose(lam.numpy(), np.asarray(jlam), rtol=1e-6)
        assert np.abs(z.numpy() - np.asarray(jz)).max() <= 1
    xh = kv_dequantize(q, lam, z, dtype=torch.float32)
    jxh = kv_dequantize_op(jnp.asarray(q.numpy()), jnp.asarray(lam.numpy()),
                           jnp.asarray(z.numpy()), dtype=jnp.float32,
                           interpret=True)
    np.testing.assert_allclose(xh.numpy(), np.asarray(jxh), atol=2e-5,
                               rtol=2e-5)
    rel = np.abs(xh.numpy() - x).max() / np.abs(x).max()
    assert rel < 0.02


def test_kv_quant_rounds_half_to_even():
    """``jnp.round`` rounds half to even; the port (and the CUDA kernel's
    ``rintf``) must too.  The row [-1, 254] gives lam = 1 and z = 1, so
    x/lam + z lands exactly on .5 for x = 0.5 and 1.5."""
    x = torch.tensor([[-1.0, 254.0, 0.5, 1.5, 2.5]], dtype=torch.float32)
    q, lam, z = kv_quantize(x)
    assert float(lam) == 1.0 and float(z) == 1.0
    jq, _, _ = jax_quantize_ref(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q[0, 2:].tolist() == [2 - 128, 2 - 128, 4 - 128]


def test_kv_dequantize_casts_to_bfloat16():
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((16, 8))
                         .astype(np.float32))
    q, lam, z = kv_quantize(x)
    out = kv_dequantize(q, lam, z, dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(
        out, kv_dequantize_ref(q, lam, z, torch.float32).to(torch.bfloat16))


def test_quant_ref_is_the_cpu_path():
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((32, 16))
                         .astype(np.float32))
    for a, b in zip(kv_quantize(x), kv_quantize_ref(x)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# ------------------------------------------------------------ the wrappers

def test_cpu_path_launches_nothing():
    """A CPU tensor takes the plain version: no kernel is built or
    launched, so no launch is counted."""
    before = (paged_attention.launches, flash_prefill_prefix.launches,
              kv_quantize.launches, kv_dequantize.launches)
    x = torch.zeros((4, 8))
    q, lam, z = kv_quantize(x)
    kv_dequantize(q, lam, z)
    paged_attention(torch.zeros((1, 2, 8)), torch.zeros((2, 4, 1, 8)),
                    torch.zeros((2, 4, 1, 8)),
                    torch.zeros((1, 2), dtype=torch.int32),
                    torch.ones((1,), dtype=torch.int32))
    flash_prefill_prefix(torch.zeros((1, 2, 4, 8)), torch.zeros((1, 1, 8, 8)),
                         torch.zeros((1, 1, 8, 8)),
                         torch.zeros((1,), dtype=torch.int32))
    assert before == (paged_attention.launches, flash_prefill_prefix.launches,
                      kv_quantize.launches, kv_dequantize.launches)
    assert not _build._libs


def test_kernel_sources_and_build_flags():
    """Every kernel is CUDA C++ for sm_90a in csrc/, and each source names
    the TPU kernel it replaces."""
    assert _build.sources() == ["flash_prefill_prefix", "kv_quant",
                                "paged_attention"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for name, fn in (("paged_attention", "`paged_attention`"),
                     ("flash_prefill_prefix", "`flash_prefill_prefix`"),
                     ("kv_quant", "`kv_quantize`")):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert "Replaces:" in src and fn in src
