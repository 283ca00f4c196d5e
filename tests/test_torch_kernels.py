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
    flash_prefill as jax_flash_prefill  # noqa: E402
from repro.kernels.flash_prefill.flash_prefill import \
    flash_prefill_prefix as jax_flash_prefix  # noqa: E402
from repro.kernels.flash_prefill.ref import \
    flash_prefill_prefix_ref as jax_flash_prefix_ref  # noqa: E402
from repro.kernels.kv_quant import (kv_dequantize_op, kv_quantize_op,  # noqa: E402
                                    kv_quantize_ref as jax_quantize_ref)
from repro.kernels.paged_attention import (  # noqa: E402
    paged_attention_ref as jax_paged_ref, paged_decode_attention)
from repro.kernels.ssd_scan import ssd_chunk as jax_ssd_chunk  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_prefill import (  # noqa: E402
    flash_prefill_prefix, flash_prefill_prefix_partial_ref,
    flash_prefill_prefix_ref, flash_prefill_ref, merge_partials, plan)
from repro_torch.kernels.kv_quant import (kv_dequantize, kv_dequantize_ref,  # noqa: E402
                                          kv_quantize, kv_quantize_ref,
                                          paged_attention_q8)
from repro_torch.kernels.paged_attention import (gather_pages,  # noqa: E402
                                                 paged_attention,
                                                 paged_attention_ref)
from repro_torch.kernels.paged_attention import \
    plan as paged_plan  # noqa: E402
from repro_torch.kernels.ssd_scan import plan as ssd_plan  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunk_ref  # noqa: E402

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


# ------------------------------------------- paged attention's split-KV

# Shapes of the paged kernel's plan: (B, KVH, page, max_pages), among them
# the serve and bench shapes and ones small enough to shrink the split.
PLAN_SHAPES = [(8, 8, 16, 128), (5, 8, 16, 128), (1, 8, 16, 128),
               (8, 8, 64, 64), (2, 2, 4, 12), (3, 1, 64, 5), (1, 1, 8, 1)]


@pytest.mark.parametrize("B,KVH,page,max_pages", PLAN_SHAPES)
def test_paged_split_plan_covers_live_pages_once(B, KVH, page, max_pages):
    """The plan is a function of the shapes; its splits cover every live
    page of every lane exactly once, in order, and name no page at or past
    ``ceil(lengths[b] / page)``; the scratch holds every split's partial."""
    nsplit = paged_plan.num_splits(B, KVH, page, max_pages)
    assert nsplit == paged_plan.num_splits(B, KVH, page, max_pages)
    assert 1 <= nsplit <= max_pages
    pps = paged_plan.pages_per_split(max_pages, nsplit)
    assert -(-max_pages // pps) == nsplit       # no split is empty of pages
    full = max_pages * page
    lengths = [n for n in (1, page, page + 1, pps * page, pps * page + 1,
                           full - 1, full) if n <= full]
    for n, ranges in zip(lengths, paged_plan.split_ranges(
            lengths, page, max_pages, nsplit)):
        live = -(-n // page)
        pages = [p for p0, p1 in ranges for p in range(p0, p1)]
        assert pages == list(range(live))
        assert all(p1 > p0 and p0 % pps == 0 for p0, p1 in ranges)
        assert len(ranges) <= nsplit
    G, d = 4, 64
    want = 0 if nsplit == 1 else B * KVH * nsplit * G * (d + 2)
    assert paged_plan.scratch_floats(B, KVH, G, d, nsplit) == want


def test_paged_split_plan_sizes_to_the_card():
    """About 256 tokens a split at the serve shape; more, shorter splits
    when B * KVH blocks would leave SMs idle."""
    assert paged_plan.num_splits(8, 8, 16, 128) == 8      # 16 pages each
    assert paged_plan.num_splits(8, 8, 64, 64) == 16      # 4 pages each
    assert paged_plan.num_splits(1, 8, 16, 128) == 32     # 64 blocks -> 256
    assert paged_plan.num_splits(1, 1, 16, 4) == 4


def _split_merge_ref(q, kc, vc, tables, lengths, nsplit):
    """The kernel's split-KV arithmetic in float32: each live split's
    partial (m, l, acc) over its pages, m starting at -1e30 and tokens past
    the length taking no weight, then the merge in split order; a lane with
    one live split is that split's acc / max(l, 1e-30)."""
    B, H, d = q.shape
    _, page, KVH, _ = kc.shape
    G = H // KVH
    qg = q.float().reshape(B, KVH, G, d) / d ** 0.5
    out = torch.empty((B, KVH, G, d))
    ranges = paged_plan.split_ranges(lengths.tolist(), page,
                                     tables.shape[1], nsplit)
    for b in range(B):
        parts = []
        for p0, p1 in ranges[b]:
            pages = tables[b, p0:p1].long()
            k = kc[pages].float().reshape(-1, KVH, d)      # (T, KVH, d)
            v = vc[pages].float().reshape(-1, KVH, d)
            pos = p0 * page + torch.arange(k.shape[0])
            live = pos < int(lengths[b])
            s = torch.einsum("kgd,tkd->kgt", qg[b], k[live])
            m = torch.maximum(s.amax(-1), torch.tensor(-1e30))
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("kgt,tkd->kgd", p,
                                                     v[live])))
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        lsum, acc = torch.zeros_like(M), torch.zeros((KVH, G, d))
        for m, den, a in parts:
            w = torch.exp(m - M)
            lsum = lsum + w * den
            acc = acc + w[..., None] * a
        out[b] = acc / torch.clamp(lsum, min=1e-30)[..., None]
    return out.reshape(B, H, d)


@pytest.mark.parametrize("nsplit", [None, 1, 3, 4, 12])
def test_paged_split_and_merge_match_jax(nsplit):
    """Partials per split merged in split order, at float32, within 2e-5 of
    ``paged_attention_ref`` and of the Pallas kernel (interpret mode), at
    lengths of 1, a page boundary, a split boundary, a split boundary plus
    one and the full table (``None``: the plan's own split count)."""
    rng = np.random.default_rng(40 + (nsplit or 0))
    B, H, KVH, d, page, maxp = 5, 8, 2, 64, 4, 12
    npg = B * maxp
    nsplit = nsplit or paged_plan.num_splits(B, KVH, page, maxp)
    pps = paged_plan.pages_per_split(maxp, nsplit)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    kc = rng.standard_normal((npg, page, KVH, d)).astype(np.float32)
    vc = rng.standard_normal((npg, page, KVH, d)).astype(np.float32)
    tables = rng.permutation(npg)[:B * maxp].reshape(B, maxp).astype(np.int32)
    lengths = np.array([1, page, pps * page, pps * page + 1, maxp * page],
                       np.int32)
    got = _split_merge_ref(*(torch.from_numpy(a) for a in (q, kc, vc, tables,
                                                           lengths)), nsplit)
    ref = paged_attention_ref(*(torch.from_numpy(a) for a in (q, kc, vc,
                                                              tables,
                                                              lengths)))
    pallas = paged_decode_attention(
        *(jnp.asarray(a) for a in (q, kc, vc, tables, lengths)),
        interpret=True)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), _np(pallas), atol=2e-5, rtol=0)


# ----------------------------------------- the f32 flash body's 3xTF32 split

def _tf32(x):
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, to
    nearest with ties away from zero (on the sign-magnitude bit pattern)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_cut(x):
    """float32 cut to TF32 toward zero (the 13 low bits cleared): how the
    tensor cores read a .tf32 operand, and so the kernel's low part."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, split=True):
    """a @ b as the tensor cores take it: with ``split``, each operand as
    hi = tf32(x) (to nearest, ties away), lo = x - hi cut to TF32 (toward
    zero), as ``split()`` in csrc/flash_prefill_tf32x3.cuh makes them and
    the tensor cores read them, and the product
    lo hi' + hi lo' + hi hi' (each TF32 product exact in float32, sums in
    float32); without it one TF32 product (the 1xTF32 control)."""
    ah, bh = _tf32(a), _tf32(b)
    if not split:
        return ah @ bh
    al, bl = _tf32_cut(a - ah), _tf32_cut(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _flash_tf32(q, k, v, causal, split=True):
    """Flash attention with every product taken as :func:`_mm_tf32`: S = Q
    K^T, softmax in float32 with P kept in float32, O = P V."""
    B, H, S, d = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = _mm_tf32(q, k.transpose(-1, -2), split) / d ** 0.5
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return _mm_tf32(p, v, split) / p.sum(-1, keepdim=True)


@pytest.mark.parametrize("B,H,KVH,S,d,causal", [
    (1, 4, 2, 128, 64, True), (2, 4, 1, 64, 128, False),
    (1, 8, 2, 256, 128, True)])
def test_flash_3xtf32_matches_jax(B, H, KVH, S, d, causal):
    """Flash attention with 3xTF32 products is within 2e-5 of
    ``flash_prefill_ref`` and of the JAX ``flash_prefill`` (interpret mode);
    the 1xTF32 control is not, so the split is what keeps f32 accuracy."""
    rng = np.random.default_rng(S + d + H)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in (
        (B, H, S, d), (B, KVH, S, d), (B, KVH, S, d)))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    got = _flash_tf32(qt, kt, vt, causal)
    ref = flash_prefill_ref(qt, kt, vt, causal=causal)
    pallas = jax_flash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, interpret=True)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), _np(pallas), atol=2e-5, rtol=0)
    one = _flash_tf32(qt, kt, vt, causal, split=False)
    assert (one - ref).abs().max().item() > 2e-5


def _ssd_tf32(xbar, dA, Bc, Cc, split=True):
    """The SSD chunk step with every product taken as :func:`_mm_tf32`, in
    the decomposition of the tensor-core body (csrc/ssd_chunk_tf32x3.cuh):
    the scores C . B^T once per chunk for all heads; per head the decay
    exp(cum[q] - cum[s]) masked before the exp and applied to the scores
    element by element, then (L o S) xbar; the state from xbar's rows
    scaled by exp(cum[Q-1] - cum[s]), times B."""
    Q = xbar.shape[2]
    cum = torch.cumsum(dA, dim=2).permute(0, 1, 3, 2)       # (B,C,H,Q)
    scores = _mm_tf32(Cc, Bc.transpose(-1, -2), split)      # (B,C,Q,Q)
    seg = cum[..., :, None] - cum[..., None, :]
    below = torch.ones((Q, Q), dtype=torch.bool).tril()
    L = torch.exp(torch.where(below, seg, torch.full_like(seg, -np.inf)))
    xh = xbar.permute(0, 1, 3, 2, 4)                        # (B,C,H,Q,P)
    y = _mm_tf32(scores[:, :, None] * L, xh, split).permute(0, 1, 3, 2, 4)
    xd = xh * torch.exp(cum[..., -1:] - cum)[..., None]
    states = _mm_tf32(xd.transpose(-1, -2), Bc[:, :, None], split)
    return y, states, torch.exp(cum[..., -1])


@pytest.mark.parametrize("B,C,Q,H,P,N,decay", [
    (1, 2, 64, 3, 32, 64, "small"), (2, 1, 40, 2, 64, 128, "model"),
    (1, 1, 128, 2, 16, 32, "model")])
def test_ssd_chunk_3xtf32_matches_jax(B, C, Q, H, P, N, decay):
    """The SSD chunk step with 3xTF32 products in the tensor-core body's
    decomposition is within 1e-4 of ``ssd_chunk_ref`` and of the JAX
    ``ssd_chunk`` (interpret mode), at small decay and at the model's
    (dA = -softplus(randn)); the 1xTF32 control is not."""
    rng = np.random.default_rng(Q + H + N)
    xbar = rng.standard_normal((B, C, Q, H, P)).astype(np.float32)
    dA = rng.standard_normal((B, C, Q, H)).astype(np.float32)
    dA = (-np.log1p(np.exp(dA)) if decay == "model"
          else -np.abs(dA) * 0.1).astype(np.float32)
    Bc, Cc = (rng.standard_normal((B, C, Q, N)).astype(np.float32)
              for _ in range(2))
    ts = [torch.from_numpy(a) for a in (xbar, dA, Bc, Cc)]
    got = _ssd_tf32(*ts)
    pallas = jax_ssd_chunk(*map(jnp.asarray, (xbar, dA, Bc, Cc)),
                           interpret=True)
    for g, r, j in zip(got, ssd_chunk_ref(*ts), pallas):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(g.numpy(), _np(j), atol=1e-4, rtol=1e-4)
    one = _ssd_tf32(*ts, split=False)
    ref = ssd_chunk_ref(*ts)
    assert not all(np.allclose(o.numpy(), r.numpy(), atol=1e-4, rtol=1e-4)
                   for o, r in zip(one[:2], ref[:2]))


@pytest.mark.parametrize("n_bc,Q,H", [
    (4, 256, 80), (1, 200, 80), (1, 1, 3), (2, 16, 3), (3, 256, 3),
    (64, 256, 80), (1, 130, 7), (5, 64, 17)])
def test_ssd_plan_covers_every_head_of_every_q_tile_once(n_bc, Q, H):
    """The y kernel's blocks (``plan.y_blocks``, in the kernel's order)
    cover every (b, c, q tile, head) exactly once, in groups of at most
    the planned heads (never more than a block's cumsum rows hold), the
    last q tiles first."""
    heads = ssd_plan.heads_per_block(n_bc, Q, H)
    assert len(heads) == ssd_plan.q_tiles(Q)
    assert all(1 <= h <= min(H, ssd_plan.MAX_GROUP) for h in heads)
    seen = {}
    blocks = ssd_plan.y_blocks(n_bc, Q, H)
    for bc, qt, h0, h1 in blocks:
        assert 0 < h1 - h0 <= heads[qt]
        for h in range(h0, h1):
            seen[(bc, qt, h)] = seen.get((bc, qt, h), 0) + 1
    assert seen == {(bc, qt, h): 1 for bc in range(n_bc)
                    for qt in range(ssd_plan.q_tiles(Q)) for h in range(H)}
    order = [qt for _, qt, _, _ in blocks]
    assert order == sorted(order, reverse=True)


def test_ssd_plan_balances_the_main_shape():
    """At one mamba2-2.7b prefill layer of 1024 tokens (4 chunks of 256,
    80 heads) every y block gets about the same work, (q tile + 1) x its
    heads, and the grid is one wave of the planned blocks a SM."""
    heads = ssd_plan.heads_per_block(4, 256, 80)
    work = [(qt + 1) * (h1 - h0)
            for _, qt, h0, h1 in ssd_plan.y_blocks(4, 256, 80)]
    assert max(work) <= 2 * min(work)
    assert len(work) <= (ssd_plan.NUM_SMS * ssd_plan.BLOCKS_PER_SM
                         * ssd_plan.WAVES)
    assert heads == sorted(heads, reverse=True)


def test_ssd_body_choice():
    """The body the SSD plan names from shapes and addresses, and the
    score scratch it sizes (4 warps x 32 n-tiles x 32 lanes x 4 floats a
    (b, c, q tile))."""
    assert ssd_plan.body(256, 64, 128) == "tf32x3"
    assert ssd_plan.body(1, 64, 128, [0, 16, 4096]) == "tf32x3"
    for args in ((257, 64, 128), (256, 32, 128), (256, 64, 256),
                 (256, 64, 128, [0, 4])):
        assert ssd_plan.body(*args) == "fma"
    assert ssd_plan.score_floats(4, 256) == 4 * 4 * 4 * 32 * 32 * 4


def test_tf32_roundings():
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11,
                      1 + 2 ** -12, 3.0])
    assert _tf32(x).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10),
                                 1 + 2 * 2 ** -10, 1.0, 3.0]
    assert _tf32_cut(x).tolist() == [1.0, -1.0, 1 + 2 ** -10, 1.0, 3.0]


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


# split-KV: the plain partials over key ranges, merged, against the unsplit
# plain output (float32, 1e-6).  Stripe of 200 keys, chunk of 24 at starts
# 0 and 37: ranges past a row's position show it nothing (m = -inf), and
# the later ranges show the start-0 element's rows nothing at all.
@pytest.mark.parametrize("n_ranges", [1, 2, 3, 7])
def test_merge_partials_equals_unsplit(n_ranges):
    rng = np.random.default_rng(100 + n_ranges)
    B, H, KVH, C, Smax, d = 2, 8, 2, 24, 200, 64
    q = torch.from_numpy(rng.standard_normal((B, H, C, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, KVH, Smax, d))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, KVH, Smax, d))
                         .astype(np.float32))
    start = torch.tensor([0, 37], dtype=torch.int32)
    cuts = np.linspace(0, Smax, n_ranges + 1).astype(int)
    parts = [flash_prefill_prefix_partial_ref(q, k, v, start, lo, hi)
             for lo, hi in zip(cuts[:-1], cuts[1:])]
    if n_ranges > 1:
        m_last = parts[-1][0]
        assert bool((m_last[0] == float("-inf")).all())   # fully masked
        assert bool(torch.isfinite(parts[0][0]).all())
    out = merge_partials(parts)
    ref = flash_prefill_prefix_ref(q, k, v, start)
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=0)


# How ``block_span`` in csrc/flash_prefill_wgmma.cuh cuts one block's keys,
# transcribed for the tests below (the library keeps no copy: the wrapper
# needs only ``plan.num_splits`` and ``plan.scratch_floats``, and the card
# sweeps in tests/test_torch_cuda.py run the kernel's own cut).
def _visible_keys(mode, G, C, Smax, start, mt):
    if mode == "full":
        return Smax
    P = plan.rows_per_head(G)
    q_last = min(C, mt * P + P) - 1
    return min(Smax, (start if mode == "prefix" else 0) + q_last + 1)


def _split_tiles(n_tiles, nsplit):
    n_tiles = max(1, n_tiles)
    ns = min(nsplit, n_tiles)
    return [(s * n_tiles // ns, (s + 1) * n_tiles // ns) for s in range(ns)]


def _key_ranges(mode, B, KVH, G, C, Smax, starts):
    """``{(b, kvh, q tile): [(lo, hi), ...]}`` under the host's nsplit."""
    nsplit = plan.num_splits(B, KVH, G, C, Smax)
    ranges = {}
    for b in range(B):
        for kvh in range(KVH):
            for mt in range(plan.q_tiles(C, G)):
                n_kv = _visible_keys(mode, G, C, Smax, int(starts[b]), mt)
                tiles = -(-n_kv // plan.BLOCK_KEYS)
                ranges[(b, kvh, mt)] = [
                    (lo * plan.BLOCK_KEYS, min(hi * plan.BLOCK_KEYS, n_kv))
                    for lo, hi in _split_tiles(tiles, nsplit)]
    return ranges


def test_merge_partials_of_the_kernels_ranges():
    """The kernel's ranges for a short chunk under the host's split count
    (the split case), merged per block, give the unsplit plain output."""
    rng = np.random.default_rng(9)
    B, H, KVH, C, Smax, d = 1, 8, 2, 16, 700, 64
    q = torch.from_numpy(rng.standard_normal((B, H, C, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, KVH, Smax, d))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, KVH, Smax, d))
                         .astype(np.float32))
    start = torch.tensor([650], dtype=torch.int32)
    ranges = _key_ranges("prefix", B, KVH, H // KVH, C, Smax, [650])
    assert plan.num_splits(B, KVH, H // KVH, C, Smax) > 1
    spans = ranges[(0, 0, 0)]
    assert len(spans) > 1
    out = merge_partials([flash_prefill_prefix_partial_ref(q, k, v, start,
                                                           lo, hi)
                          for lo, hi in spans])
    torch.testing.assert_close(out, flash_prefill_prefix_ref(q, k, v, start),
                               atol=1e-6, rtol=0)


# the host's split plan: (mode, B, KVH, G, C, Smax, starts); C 1 and 16 at
# long prefixes split, C 256 and full sequences do not
@pytest.mark.parametrize("case", [
    ("prefix", 1, 8, 4, 16, 2048, [1000]), ("prefix", 1, 8, 4, 1, 2048, [0]),
    ("prefix", 2, 8, 4, 16, 2048, [0, 2031]),
    ("prefix", 1, 8, 4, 256, 2048, [1000]), ("prefix", 1, 1, 8, 3, 4096, [7]),
    ("prefix", 2, 2, 3, 200, 300, [0, 99]), ("causal", 1, 8, 4, 37, 37, [0]),
    ("full", 1, 2, 1, 100, 100, [0]), ("causal", 4, 8, 4, 1024, 1024, [0] * 4),
])
def test_split_plan_covers_every_visible_key_once(case):
    mode, B, KVH, G, C, Smax, starts = case
    nsplit = plan.num_splits(B, KVH, G, C, Smax)
    assert nsplit == plan.num_splits(B, KVH, G, C, Smax)   # deterministic
    a = _key_ranges(mode, B, KVH, G, C, Smax, starts)
    assert 1 <= nsplit <= max(1, plan.NUM_SMS)
    assert len(a) == B * KVH * plan.q_tiles(C, G)
    P = plan.rows_per_head(G)
    for (b, _, mt), spans in a.items():
        n_kv = _visible_keys(mode, G, C, Smax, starts[b], mt)
        if mode != "full":
            base = starts[b] if mode == "prefix" else 0
            assert n_kv == min(Smax, base + min(C, (mt + 1) * P))
        assert 1 <= len(spans) <= nsplit
        assert all(lo < hi for lo, hi in spans)          # none empty
        assert all(lo % plan.BLOCK_KEYS == 0 for lo, _ in spans)
        keys = [j for lo, hi in spans for j in range(lo, hi)]
        assert keys == list(range(n_kv))                 # each once, in order
    if C <= 16 and Smax >= 1024:
        assert nsplit > 1
    if B * KVH * plan.q_tiles(C, G) >= plan.NUM_SMS:
        assert nsplit == 1


@pytest.mark.parametrize("n_tiles,nsplit", [(1, 16), (16, 16), (17, 4),
                                            (5, 3), (32, 33)])
def test_split_tiles_are_contiguous_and_nonempty(n_tiles, nsplit):
    spans = _split_tiles(n_tiles, nsplit)
    assert len(spans) == min(n_tiles, nsplit)
    assert spans[0][0] == 0 and spans[-1][1] == n_tiles
    assert all(lo < hi for lo, hi in spans)
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    sizes = [hi - lo for lo, hi in spans]
    assert max(sizes) - min(sizes) <= 1


def test_split_scratch_matches_the_kernels_layout():
    """nsplit x (b, kv-head, q tile) partials of 64 rows x d accumulators,
    then (m, l) per row: the layout ``flash_attn_merge_kernel`` reads."""
    B, KVH, G, C, d = 1, 8, 4, 16, 128
    n = plan.num_splits(B, KVH, G, C, 2048)
    assert plan.scratch_floats(B, KVH, G, C, d, 1) == 0
    assert plan.scratch_floats(B, KVH, G, C, d, n) == n * 8 * 1 * 64 * 130
    assert plan.rows_per_head(3) == 21 and plan.q_tiles(200, 3) == 10
    assert plan.q_tiles(5, 65) == 0 and plan.num_splits(1, 1, 65, 5, 64) == 1


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
    wrappers = (paged_attention, flash_prefill_prefix, kv_quantize,
                kv_dequantize, paged_attention_q8)
    before = [w.launches for w in wrappers]
    x = torch.zeros((4, 8))
    q, lam, z = kv_quantize(x)
    kv_dequantize(q, lam, z)
    tables = torch.zeros((1, 2), dtype=torch.int32)
    paged_attention(torch.zeros((1, 2, 8)), torch.zeros((2, 4, 1, 8)),
                    torch.zeros((2, 4, 1, 8)), tables,
                    torch.ones((1,), dtype=torch.int32))
    codes = torch.zeros((2, 4, 1, 8), dtype=torch.int8)
    scale = torch.ones((2, 4, 1, 1))
    paged_attention_q8(torch.zeros((1, 2, 8)), codes, scale, scale, codes,
                       scale, scale, tables, torch.ones((1,), dtype=torch.int32))
    flash_prefill_prefix(torch.zeros((1, 2, 4, 8)), torch.zeros((1, 1, 8, 8)),
                         torch.zeros((1, 1, 8, 8)),
                         torch.zeros((1,), dtype=torch.int32))
    assert before == [w.launches for w in wrappers]
    assert not _build._libs


def test_build_key_covers_included_headers(tmp_path, monkeypatch):
    """An edited header (``#include "..."``, also through another header)
    changes the library's key, so a stale build is never loaded."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint f() { return 1; }\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// v1\n")
    (tmp_path / "unused.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build.includes("k")] == ["a.cuh", "b.cuh"]
    key = _build._target("k")
    (tmp_path / "unused.cuh").write_text("// v2\n")
    assert _build._target("k") == key
    (tmp_path / "b.cuh").write_text("// v2\n")
    assert _build._target("k") != key


def test_kernel_sources_and_build_flags():
    """Every kernel is CUDA C++ for sm_90a in csrc/, and each source names
    the TPU kernel it replaces."""
    assert _build.sources() == ["flash_prefill_prefix", "fused_rmsnorm",
                                "kv_quant", "paged_attention", "ssd_chunk"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for name, fn in (("paged_attention", "`paged_attention`"),
                     ("paged_attention", "`paged_attention_q8`"),
                     ("flash_prefill_prefix", "`flash_prefill_prefix`"),
                     ("kv_quant", "`kv_quantize`"),
                     ("fused_rmsnorm", "`fused_rmsnorm`"),
                     ("ssd_chunk", "`ssd_chunk`")):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert "Replaces:" in src and fn in src
    # the bf16 and f32 flash bodies and the SSD tensor-core body are
    # headers of their sources, with the 3xTF32 primitives they share, in
    # their build keys
    assert [p.name for p in _build.includes("flash_prefill_prefix")] == [
        "flash_prefill_tf32x3.cuh", "flash_prefill_wgmma.cuh", "tf32x3.cuh"]
    assert [p.name for p in _build.includes("ssd_chunk")] == [
        "ssd_chunk_tf32x3.cuh", "tf32x3.cuh"]
