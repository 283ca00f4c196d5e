"""The INT8 swap's device half on the CPU: the quantize kernel's store
entry (``kernels/kv_quant/ops.kv_quantize_store``), which reads K and V
where they lie (a request's pages of a paged pool, a dense lane's stripe
span, a contiguous tensor) in their own dtype, masks the positions past a
length and lays the blob out in one staging buffer.

On a CPU tensor the wrapper takes its plain version, so these tests pin
what the CUDA kernel is held to on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 3): the blob equals, bit for bit, the composition
the offloads ran before the store entry (gather, mask, float32 copy,
``kv_quantize_ref``), and the rows agree with the JAX package's
``kv_quantize_op`` in interpret mode within the tolerance of
``tests/test_kernels.py``: codes within 1, scales within 1e-6 relative,
zeros within 1.  Inputs are made with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.kv_quant import kv_quantize_op  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.kv_quant import (kv_quantize_ref,  # noqa: E402
                                          kv_quantize_store,
                                          kv_quantize_store_ref)
from repro_torch.kernels.kv_quant import ops  # noqa: E402
from repro_torch.serving.kv_cache import (quantize_kv_device,  # noqa: E402
                                          quantize_kv_store)

PAGE = 4


def _pool(rng, L, num_pages, H, d, dtype):
    """K and V of a paged pool (L, num_pages, PAGE, H, d) in ``dtype``."""
    return tuple(torch.from_numpy(
        (rng.standard_normal((L, num_pages, PAGE, H, d)) * 4.0)
        .astype(np.float32)).to(dtype) for _ in range(2))


def _store(kind, rng, L, H, d, dtype, n_pages):
    """``(xs, pages)`` of one swap: ``paged``, K and V of a pool of
    2 n_pages + 1 pages and a request's ``n_pages`` of them drawn at
    random; ``dense``, lane 1's first n_pages * PAGE positions of two
    (L, 3, S, H, d) caches (S = 4 n_pages * PAGE), strided views."""
    if kind == "paged":
        k, v = _pool(rng, L, 2 * n_pages + 1, H, d, dtype)
        pages = torch.from_numpy(rng.permutation(2 * n_pages + 1)[:n_pages]
                                 .astype(np.int64))
        return (k, v), pages
    S = 4 * n_pages * PAGE
    k, v = (torch.from_numpy((rng.standard_normal((L, 3, S, H, d)) * 4.0)
                             .astype(np.float32)).to(dtype)
            for _ in range(2))
    span = n_pages * PAGE
    return (k.select(1, 1)[:, :span], v.select(1, 1)[:, :span]), None


def _masked_rows(x, pages, length):
    """The rows the offloads quantized before the store entry: the pages
    gathered (``pool[:, idx]``) or the span taken, the positions at or
    past the length zeroed, flattened to (rows, d) in float32."""
    if pages is not None:
        arr = x[:, pages]
        P = arr.shape[1]
        pos = torch.arange(P * PAGE).reshape(P, PAGE)[None, :, :, None, None]
    else:
        arr = x
        pos = torch.arange(arr.shape[1])[None, :, None, None]
    arr = torch.where(pos < length, arr, torch.zeros_like(arr))
    return arr.reshape(-1, arr.shape[-1]).float().contiguous()


def _before(x, pages, length):
    """The offloads' composition before the store entry."""
    return kv_quantize_ref(_masked_rows(x, pages, length))


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


CASES = [
    # kind, dtype, d, pages, length
    ("paged", torch.bfloat16, 128, 3, 7),       # a length mid-page
    ("paged", torch.float32, 64, 3, 9),
    ("paged", torch.bfloat16, 80, 2, 8),        # a length on a page edge
    ("paged", torch.float32, 128, 1, 3),        # one page
    ("paged", torch.bfloat16, 64, 2, 1),        # length 1
    ("dense", torch.bfloat16, 128, 4, 11),
    ("dense", torch.float32, 80, 2, 1),
    ("dense", torch.bfloat16, 64, 1, 4),
]


@pytest.mark.parametrize("kind,dtype,d,n_pages,length", CASES)
def test_store_entry_is_the_old_composition_bit_for_bit(kind, dtype, d,
                                                        n_pages, length):
    """The store entry's blob (its CPU path, the plain version) equals the
    old gather + mask + float32 + quantize bit for bit (scales and zeros
    compared as bits, so -0.0 counts), K and V each; a masked row is a
    zero row's: lam 1e-8, z -0.0, codes -128."""
    rng = np.random.default_rng([d, n_pages, length, kind == "paged"])
    L, H = 2, 2
    xs, pages = _store(kind, rng, L, H, d, dtype, n_pages)
    triples, staging = kv_quantize_store(xs, pages=pages, length=length)
    assert staging is None                      # nothing to pin on the CPU
    for x, got in zip(xs, triples):
        want = _before(x, pages, length)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(_bits(g), _bits(w))
        q, lam, z = (t.view(L, n_pages * PAGE, H, -1) for t in got)
        if length < n_pages * PAGE:
            assert bool((q[:, length:] == -128).all())
            assert bool((lam[:, length:] == torch.tensor(1e-8)).all())
            assert bool((z[:, length:] == 0).all())
            assert bool(torch.signbit(z[:, length:]).all())
        assert not bool(torch.signbit(lam).any())


@pytest.mark.parametrize("kind,dtype,d,n_pages,length", [
    ("paged", torch.bfloat16, 128, 3, 7), ("dense", torch.float32, 80, 4, 13)])
def test_store_entry_matches_jax(kind, dtype, d, n_pages, length):
    """The rows agree with the JAX package's Pallas kernel (interpret mode)
    on the same gathered, masked rows in float32, within the tolerance of
    ``tests/test_kernels.py``."""
    rng = np.random.default_rng(7 + d)
    xs, pages = _store(kind, rng, 2, 2, d, dtype, n_pages)
    triples, _ = kv_quantize_store(xs, pages=pages, length=length)
    for x, (q, lam, z) in zip(xs, triples):
        rows = _masked_rows(x, pages, length).numpy()
        jq, jlam, jz = kv_quantize_op(jnp.asarray(rows), interpret=True)
        assert np.abs(q.numpy().astype(np.int32)
                      - np.asarray(jq, np.int32)).max() <= 1
        np.testing.assert_allclose(lam.numpy(), np.asarray(jlam), rtol=1e-6)
        assert np.abs(z.numpy() - np.asarray(jz)).max() <= 1


def test_blob_format_and_degenerate_stores():
    """``quantize_kv_store`` keeps the blob format ``(q (rows, d) int8,
    lam, z (rows, 1) float32, shape)`` of CPU tensors; a contiguous
    (T, d) tensor and one page view are the store's degenerate cases and
    equal ``kv_quantize_ref`` of their rows; ``quantize_kv_device`` is the
    one-source call."""
    rng = np.random.default_rng(3)
    k, v = _pool(rng, 3, 5, 2, 16, torch.bfloat16)
    pages = torch.tensor([4, 0], dtype=torch.long)
    kb, vb = quantize_kv_store((k, v), (3, 2, PAGE, 2, 16), pages=pages,
                               length=6)
    for blob, x in ((kb, k), (vb, v)):
        q, lam, z, shape = blob
        assert shape == (3, 2, PAGE, 2, 16)
        assert (q.dtype, tuple(q.shape)) == (torch.int8, (3 * 2 * PAGE * 2,
                                                          16))
        assert tuple(lam.shape) == tuple(z.shape) == (q.shape[0], 1)
        assert all(t.device.type == "cpu" for t in (q, lam, z))
        for g, w in zip((q, lam, z), _before(x, pages, 6)):
            assert torch.equal(_bits(g), _bits(w))
    page = k[:, 3]                               # a tier page: strided
    assert not page.is_contiguous()
    q, lam, z, shape = quantize_kv_device(page)
    assert shape == tuple(page.shape)
    for g, w in zip((q, lam, z), kv_quantize_ref(page.reshape(-1, 16))):
        assert torch.equal(_bits(g), _bits(w))
    flat = torch.from_numpy(rng.standard_normal((9, 24)).astype(np.float32))
    (got,), _ = kv_quantize_store((flat,))
    for g, w in zip(got, kv_quantize_ref(flat)):
        assert torch.equal(_bits(g), _bits(w))


def test_staging_layout():
    """Each source's codes, scales and zeros start on 16 bytes, K's before
    V's, and the views of a buffer read back what was written there."""
    offs, size = ops.store_layout(5, 12, 2)
    flat = [o for part in offs for o in part]
    assert flat == sorted(flat) and all(o % 16 == 0 for o in flat)
    assert offs[0] == (0, 64, 96) and offs[1] == (128, 192, 224)
    assert size == 256
    buf = torch.zeros(size, dtype=torch.uint8)
    views = ops.store_views(buf, 5, 12, 2)
    for i, (q, lam, z) in enumerate(views):
        q.fill_(i + 1)
        lam.fill_(0.5 + i)
        z.fill_(-3.0 - i)
    again = ops.store_views(buf, 5, 12, 2)
    for i, (q, lam, z) in enumerate(again):
        assert bool((q == i + 1).all()) and bool((lam == 0.5 + i).all())
        assert bool((z == -3.0 - i).all())
        assert q.data_ptr() == views[i][0].data_ptr()


@pytest.mark.parametrize("d,dtype,aligned,want", [
    (128, torch.float32, True, "vec16"), (64, torch.float32, True, "vec16"),
    (80, torch.float32, True, "vec16"), (80, torch.bfloat16, True, "vec16"),
    (40, torch.bfloat16, True, "vec16"), (512, torch.float32, True, "vec16"),
    (1024, torch.bfloat16, True, "vec16"),
    (6, torch.float32, True, "scalar"), (12, torch.bfloat16, True, "scalar"),
    (4, torch.float32, True, "scalar"), (8, torch.bfloat16, True, "scalar"),
    (2048, torch.float32, True, "scalar"),
    (128, torch.bfloat16, False, "scalar")])
def test_quantize_body_choice(d, dtype, aligned, want):
    """The body the kernel takes (``ops.quantize_body``): 16-byte loads for
    d a multiple of a load's elements (4 float32, 8 bfloat16), 2 to 128
    loads a row, at aligned addresses, else one warp a row."""
    assert ops.quantize_body(d, dtype, aligned) == want


def test_store_entry_cpu_path_launches_nothing():
    """A CPU store takes the plain version: no library is built or loaded
    and no launch is counted."""
    before = kv_quantize_store.launches
    k, v = _pool(np.random.default_rng(5), 1, 2, 1, 8, torch.float32)
    kv_quantize_store((k, v), pages=torch.tensor([1]), length=3)
    quantize_kv_device(k)
    assert kv_quantize_store.launches == before
    assert "kv_quant" not in _build._libs
