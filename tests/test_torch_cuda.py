"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels are built for
``sm_90a`` at first use) and skip without one.  They import nothing of JAX,
so they run where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Shapes sweep beyond the serving and training paths' own (which
``chip_smoke.py`` checks): GQA group sizes 1 to 8, head dims 64 and 128
(and 80, stablelm-3b's, in the flash kernels),
the bf16 flash body at chunks of 1 to 2048 tokens at both ends of a
ragged stripe (held against the float32 truth beside SDPA's error),
pages of 8 to 32 tokens, chunk and sequence lengths that are not multiples
of the query tile, rows that see a single key, causal and bidirectional
full-sequence attention, INT8 pages at lengths around a page boundary with
random table entries past each length, RMSNorm widths that are not
multiples of the block or of the 16-byte vector and rows at misaligned
addresses, INT8 dequantize bit for bit through both of its bodies, and SSD
chunks whose length, head dim and state size are not multiples of the
kernel's tiles, at small and at the model's decay, each through the body
its plan names, and the prefix flash kernel at a pack's shape (four
rows, mixed starts, a padding row).  Packs replayed as CUDA graphs are
held to eager packs bit for bit.  The two autograd Functions' gradients
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


@pytest.mark.parametrize("G", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("page", [16, 32, 64])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_split_sweep(dev, G, page, d, dtype):
    """The split-KV body at lengths of 1, a page boundary, a split's end,
    one past it, one short of the full table and the full table, with
    table entries past each length holding -1 or an index past the pool
    (never read).  Each call launches the body once and the merge once
    when the plan splits (it does at these shapes)."""
    from repro_torch.kernels.paged_attention import (ops, paged_attention,
                                                     paged_attention_ref,
                                                     plan)
    KVH, maxp = 2, 1024 // page
    lens = [1, page, 0, 0, maxp * page - 1, maxp * page]
    B = len(lens)
    nsplit = plan.num_splits(B, KVH, page, maxp)
    pps = plan.pages_per_split(maxp, nsplit)
    assert nsplit > 1
    lens[2], lens[3] = pps * page, pps * page + 1
    npages = B * maxp
    rng = np.random.default_rng(G * 100 + page + d)
    q = _randn(rng, (B, G * KVH, d), dtype, dev)
    kc = _randn(rng, (npages, page, KVH, d), dtype, dev)
    vc = _randn(rng, (npages, page, KVH, d), dtype, dev)
    tables = rng.permutation(npages).reshape(B, maxp).astype(np.int32)
    for b, n in enumerate(lens):
        tables[b, -(-n // page):] = -1 if b % 2 else npages + 7
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    tables_d = torch.from_numpy(tables).to(dev)
    before = ops.body_launches()
    out = paged_attention(q, kc, vc, tables_d, lengths)
    torch.cuda.synchronize()
    after = ops.body_launches()
    assert {k: after[k] - before[k] for k in after} == {"body": 1,
                                                        "merge": 1}
    ref = paged_attention_ref(q, kc, vc, tables_d.clamp(0, npages - 1),
                              lengths)
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


def test_paged_attention_one_split_needs_no_merge(dev):
    """When B * KVH blocks fill the card the plan keeps one split: the body
    writes every output and no merge runs."""
    from repro_torch.kernels.paged_attention import (ops, paged_attention,
                                                     paged_attention_ref,
                                                     plan)
    B, H, KVH, d, page, maxp = 20, 32, 8, 128, 16, 4
    assert plan.num_splits(B, KVH, page, maxp) == 1
    rng = np.random.default_rng(31)
    q = _randn(rng, (B, H, d), torch.bfloat16, dev)
    kc = _randn(rng, (B * maxp, page, KVH, d), torch.bfloat16, dev)
    vc = _randn(rng, (B * maxp, page, KVH, d), torch.bfloat16, dev)
    tables = torch.arange(B * maxp, dtype=torch.int32,
                          device=dev).reshape(B, maxp)
    lengths = torch.from_numpy(rng.integers(1, maxp * page + 1, (B,))
                               .astype(np.int32)).to(dev)
    before = ops.body_launches()
    out = paged_attention(q, kc, vc, tables, lengths)
    torch.cuda.synchronize()
    after = ops.body_launches()
    assert {k: after[k] - before[k] for k in after} == {"body": 1,
                                                        "merge": 0}
    torch.testing.assert_close(
        out.float(), paged_attention_ref(q, kc, vc, tables, lengths).float(),
        atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_q8_kernel(dev, G, d, page, dtype):
    """INT8 pages: five lanes at lengths 1, page - 1, page, page + 1 and
    the full table, whose entries past each length name random pages
    (never read), codes from ``kv_quantize_ref``.  float32 within 2e-5;
    bf16 element by element within one bf16 rounding step of the plain
    output plus 2e-5 (both sides accumulate in f32 and round once)."""
    from repro_torch.kernels.kv_quant import (kv_quantize_ref,
                                              paged_attention_q8,
                                              paged_attention_q8_ref)
    KVH, maxp, npages = 2, 4, 24
    rng = np.random.default_rng(G * 1000 + d + page)
    q = _randn(rng, (5, G * KVH, d), dtype, dev)
    kq, klam, kz = kv_quantize_ref(_randn(rng, (npages, page, KVH, d),
                                          torch.float32, dev))
    vq, vlam, vz = kv_quantize_ref(_randn(rng, (npages, page, KVH, d),
                                          torch.float32, dev))
    tables = torch.from_numpy(rng.integers(0, npages, (5, maxp))
                              .astype(np.int32)).to(dev)
    lengths = torch.tensor([1, page - 1, page, page + 1, maxp * page],
                           dtype=torch.int32, device=dev)
    args = (q, kq, klam, kz, vq, vlam, vz, tables, lengths)
    n0 = paged_attention_q8.launches
    out = paged_attention_q8(*args)
    torch.cuda.synchronize()
    assert paged_attention_q8.launches == n0 + 1 and out.dtype == dtype
    ref = paged_attention_q8_ref(*args).float()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
    else:
        diff = (out.float() - ref).abs()
        assert bool((diff <= 2.0 ** -7 * ref.abs() + 2e-5).all()), \
            diff.max().item()


@pytest.mark.parametrize("B,H,KVH,Smax,d,C", [
    (1, 4, 4, 64, 64, 16), (2, 8, 2, 128, 64, 24), (1, 8, 1, 256, 128, 8),
    (2, 4, 4, 96, 128, 24), (1, 32, 8, 2048, 128, 200),
    (2, 8, 2, 128, 80, 24), (1, 32, 32, 2048, 80, 256),
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
    out, bodies = _bodies(lambda: flash_prefill_prefix(q, k, v, start))
    if dtype == torch.float32:                  # aligned: the 3xTF32 body
        assert bodies == {"fma": 0, "wgmma": 0, "merge": 0, "tf32x3": 1}, \
            bodies
    ref = flash_prefill_prefix_ref(q, k, v, start)
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


# phase 28's configs at their own heads (d 128): qwen1.5-32b's 40 = 40
# (G 1, 40 KV heads), dbrx-132b's 48/8 (G 6: 10 positions of each head in
# the bf16 body's 64 rows, 4 idle) and command-r-35b's 64/8 (G 8)
@pytest.mark.parametrize("H,KVH", [(40, 40), (48, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_at_the_big_configs_heads(dev, H, KVH, dtype):
    """The decode shape of phase 28 (B 8, pages of 16, lengths 1..2048 over
    a shuffled pool): the split-KV body and its merge once each, against
    the plain version."""
    from repro_torch.kernels.paged_attention import (ops, paged_attention,
                                                     paged_attention_ref)
    B, d, page, maxp = 8, 128, 16, 128
    npages = B * maxp + 1
    rng = np.random.default_rng(H * 10 + KVH)
    q = _randn(rng, (B, H, d), dtype, dev)
    kc = _randn(rng, (npages, page, KVH, d), dtype, dev)
    vc = _randn(rng, (npages, page, KVH, d), dtype, dev)
    tables = torch.from_numpy(rng.permutation(npages - 1)[:B * maxp]
                              .reshape(B, maxp).astype(np.int32)).to(dev)
    lengths = torch.from_numpy(np.linspace(1, maxp * page, B)
                               .astype(np.int32)).to(dev)
    before = ops.body_launches()
    out = paged_attention(q, kc, vc, tables, lengths)
    torch.cuda.synchronize()
    after = ops.body_launches()
    assert {k: after[k] - before[k] for k in after} == {"body": 1,
                                                        "merge": 1}
    ref = paged_attention_ref(q, kc, vc, tables, lengths)
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.parametrize("H,KVH", [(40, 40), (48, 8), (64, 8)])
def test_flash_prefill_prefix_at_the_big_configs_heads(dev, H, KVH):
    """A 256-token bf16 chunk at positions 0 and 1000 of a 2048-position
    stripe (strided k/v, as the model passes them) through the wgmma
    body: against the plain version and the float32 truth beside SDPA's
    error (``_check_bf16_attention``)."""
    from repro_torch.kernels.flash_prefill import (flash_prefill_prefix,
                                                   flash_prefill_prefix_ref,
                                                   plan)
    B, C, Smax, d = 2, 256, 2048, 128
    rng = np.random.default_rng(H + KVH)
    q = _randn(rng, (B, H, C, d), torch.bfloat16, dev)
    k = _randn(rng, (B, Smax, KVH, d), torch.bfloat16, dev).transpose(1, 2)
    v = _randn(rng, (B, Smax, KVH, d), torch.bfloat16, dev).transpose(1, 2)
    start = torch.tensor([0, 1000], dtype=torch.int32, device=dev)
    out, bodies = _bodies(lambda: flash_prefill_prefix(q, k, v, start))
    split = plan.num_splits(B, KVH, H // KVH, C, Smax) > 1
    assert bodies == {"fma": 0, "wgmma": 1, "merge": int(split),
                      "tf32x3": 0}, bodies
    plain = flash_prefill_prefix_ref(q, k, v, start)
    qf, kf, vf = q.float(), k.float(), v.float()
    pos = start.long()[:, None] + torch.arange(C, device=dev)[None]
    mask = (torch.arange(Smax, device=dev)[None, None]
            <= pos[:, :, None])[:, None]
    _check_bf16_attention(out, plain,
                          flash_prefill_prefix_ref(qf, kf, vf, start),
                          flash_prefill_prefix_ref(qf, kf, vf.abs(), start),
                          _sdpa_bf16(q, k, v, mask=mask))


def _sdpa_bf16(q, k, v, mask=None, causal=False):
    """SDPA on the same bf16 inputs, GQA heads expanded, on the first
    backend that takes the call (flash unless there is a mask, then the
    memory-efficient and cuDNN ones), else the math backend."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    G = q.shape[1] // k.shape[1]
    ke, ve = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    order = ([] if mask is not None else [SDPBackend.FLASH_ATTENTION]) + [
        SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION,
        SDPBackend.MATH]
    for backend in order:
        try:
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(
                    q, ke, ve, attn_mask=mask, is_causal=causal)
        except RuntimeError:
            continue
    raise RuntimeError("no SDPA backend took the call")


def _bodies(fn):
    """(fn's result, the launches of each flash body it made): which body
    a call took (``ops.body_launches``: ``fma``, ``wgmma``, ``merge``,
    ``tf32x3``)."""
    from repro_torch.kernels.flash_prefill import ops
    before = ops.body_launches()
    out = fn()
    torch.cuda.synchronize()
    after = ops.body_launches()
    return out, {k: after[k] - before[k] for k in after}


def _check_bf16_attention(out, plain, truth, absv, sdpa):
    """The bf16 flash body against its plain version and the float32 truth.

    ``plain`` is the plain version's bf16 output, ``truth`` its float32
    output on the same bf16 inputs, ``absv`` the plain version applied to
    |v| in float32 (a = sum_j w_j |v_j|, w the softmax weights), ``sdpa``
    SDPA's bf16 output.  The kernel rounds P to bf16 (unit roundoff 2^-8)
    before P V and sums l over the unrounded P, so before its output
    rounding it is within 2^-8 a of the truth; the two outputs' roundings
    add at most 2^-8 (|out| + |truth|) <= 2^-7 |plain| + 2^-14 a.  So
    element by element |out - plain| <= 2^-7 |plain| + 2^-7 a + 2e-5 (the
    float32 sums' slack).  And the kernel's largest error from the truth
    is at most twice SDPA's, plus 2e-5."""
    diff = (out.float() - plain.float()).abs()
    bound = 2.0 ** -7 * plain.float().abs() + 2.0 ** -7 * absv + 2e-5
    assert bool((diff <= bound).all()), (diff - bound).max().item()
    err = (out.float() - truth).abs().max().item()
    lib = (sdpa.float() - truth).abs().max().item()
    assert err <= 2 * lib + 2e-5, (err, lib)


# the bf16 Hopper body: chunks of 1, 16, 256 and 2048 at start 0 and ending
# at Smax (2100, not a multiple of the 64-key tile), and a batch of two at
# both starts; GQA groups 1-8 packed into the 64-row tile (the configs'
# 1, 2, 3, 4, 6, 8: 64 // G positions a head, 64 % G rows idle); d 64, 80
# (two panels, the second zero past column 80), 128
@pytest.mark.parametrize("C", [1, 16, 256, 2048])
@pytest.mark.parametrize("where", ["start0", "at_smax", "mixed"])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("d", [64, 80, 128])
def test_flash_prefill_prefix_bf16_sweep(dev, C, where, G, d):
    from repro_torch.kernels.flash_prefill import (flash_prefill_prefix,
                                                   flash_prefill_prefix_ref,
                                                   plan)
    Smax, KVH = 2100, 2
    B = 2 if where == "mixed" else 1
    rng = np.random.default_rng(C * 7 + G * 3 + d)
    q = _randn(rng, (B, G * KVH, C, d), torch.bfloat16, dev)
    k = _randn(rng, (B, Smax, KVH, d), torch.bfloat16, dev).transpose(1, 2)
    v = _randn(rng, (B, Smax, KVH, d), torch.bfloat16, dev).transpose(1, 2)
    starts = {"start0": [0], "at_smax": [Smax - C],
              "mixed": [0, Smax - C]}[where]
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    n0 = flash_prefill_prefix.launches
    out, bodies = _bodies(lambda: flash_prefill_prefix(q, k, v, start))
    assert flash_prefill_prefix.launches == n0 + 1
    # aligned bf16 views take the Hopper body, with its merge when split
    split = plan.num_splits(B, KVH, G, C, Smax) > 1
    assert bodies == {"fma": 0, "wgmma": 1, "merge": int(split),
                      "tf32x3": 0}, bodies
    plain = flash_prefill_prefix_ref(q, k, v, start)
    qf, kf, vf = q.float(), k.float(), v.float()
    truth = flash_prefill_prefix_ref(qf, kf, vf, start)
    absv = flash_prefill_prefix_ref(qf, kf, vf.abs(), start)
    pos = start.long()[:, None] + torch.arange(C, device=dev)[None]
    mask = (torch.arange(Smax, device=dev)[None, None]
            <= pos[:, :, None])[:, None]                  # (B, 1, C, Smax)
    _check_bf16_attention(out, plain, truth, absv,
                          _sdpa_bf16(q, k, v, mask=mask))


def test_flash_prefill_prefix_bf16_unaligned_views(dev):
    """bf16 views that TMA cannot take (q and k one element past a 16-byte
    boundary) take the FMA body: the same function, held to one bf16 step
    of the plain output plus 2e-5 element by element (that body keeps P in
    float32)."""
    from repro_torch.kernels.flash_prefill import (flash_prefill_prefix,
                                                   flash_prefill_prefix_ref)
    rng = np.random.default_rng(21)
    B, H, KVH, C, Smax, d = 2, 8, 2, 40, 300, 64

    def shifted(shape):
        flat = _randn(rng, (int(np.prod(shape)) + 1,), torch.bfloat16, dev)
        return flat[1:].view(shape)
    q = shifted((B, H, C, d))
    k = shifted((B, Smax, KVH, d)).transpose(1, 2)
    v = _randn(rng, (B, Smax, KVH, d), torch.bfloat16, dev).transpose(1, 2)
    assert q.data_ptr() % 16 and k.data_ptr() % 16
    start = torch.tensor([0, 200], dtype=torch.int32, device=dev)
    out, bodies = _bodies(lambda: flash_prefill_prefix(q, k, v, start))
    assert bodies == {"fma": 1, "wgmma": 0, "merge": 0, "tf32x3": 0}, bodies
    ref = flash_prefill_prefix_ref(q, k, v, start).float()
    diff = (out.float() - ref).abs()
    assert bool((diff <= 2.0 ** -7 * ref.abs() + 2e-5).all()), \
        diff.max().item()


@pytest.mark.parametrize("mode", ["prefix", "causal", "full"])
def test_flash_f32_unaligned_views_take_the_fma_body(dev, mode):
    """float32 views that cp.async cannot take (q and k one element past a
    16-byte boundary) take the FMA body, within 2e-5 of the plain
    version; the same call on aligned copies takes the 3xTF32 body."""
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_prefix,
                                                   flash_prefill_prefix_ref,
                                                   flash_prefill_ref)
    rng = np.random.default_rng(22)
    B, H, KVH, C, S, d = 2, 8, 2, 40, 300, 64

    def shifted(shape):
        flat = _randn(rng, (int(np.prod(shape)) + 1,), torch.float32, dev)
        return flat[1:].view(shape)
    k = shifted((B, S, KVH, d)).transpose(1, 2)
    v = _randn(rng, (B, S, KVH, d), torch.float32, dev).transpose(1, 2)
    if mode == "prefix":
        q = shifted((B, H, C, d))
        start = torch.tensor([0, 200], dtype=torch.int32, device=dev)

        def call(q, k, v):
            return flash_prefill_prefix(q, k, v, start)
        ref = flash_prefill_prefix_ref(q, k, v, start)
    else:
        q = shifted((B, S, H, d)).transpose(1, 2)

        def call(q, k, v):
            return flash_prefill(q, k, v, causal=mode == "causal")
        ref = flash_prefill_ref(q, k, v, causal=mode == "causal")
    assert q.data_ptr() % 16 and k.data_ptr() % 16
    out, bodies = _bodies(lambda: call(q, k, v))
    assert bodies == {"fma": 1, "wgmma": 0, "merge": 0, "tf32x3": 0}, bodies
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
    out2, bodies = _bodies(lambda: call(q.clone(), k.clone(), v))
    assert bodies == {"fma": 0, "wgmma": 0, "merge": 0, "tf32x3": 1}, bodies
    torch.testing.assert_close(out2, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_head_dim_80_unaligned_views_take_the_fma_body(dev, dtype):
    """Head dim 80 in the FMA body: views one element past a 16-byte
    boundary, prefix and full-sequence causal, within the dtype's
    tolerance of the plain version (bf16: one bf16 step of it, as that
    body keeps P in float32).  A head dim the kernels are not built for
    raises."""
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_prefix,
                                                   flash_prefill_prefix_ref,
                                                   flash_prefill_ref)
    rng = np.random.default_rng(24)
    B, H, KVH, C, S, d = 2, 8, 2, 40, 300, 80

    def shifted(shape):
        flat = _randn(rng, (int(np.prod(shape)) + 1,), dtype, dev)
        return flat[1:].view(shape)
    k = shifted((B, S, KVH, d)).transpose(1, 2)
    v = _randn(rng, (B, S, KVH, d), dtype, dev).transpose(1, 2)
    start = torch.tensor([0, 200], dtype=torch.int32, device=dev)
    qc = shifted((B, H, C, d))
    qs = shifted((B, S, H, d)).transpose(1, 2)
    for call, ref in (
            (lambda: flash_prefill_prefix(qc, k, v, start),
             flash_prefill_prefix_ref(qc, k, v, start)),
            (lambda: flash_prefill(qs, k, v, causal=True),
             flash_prefill_ref(qs, k, v, causal=True))):
        out, bodies = _bodies(call)
        assert bodies == {"fma": 1, "wgmma": 0, "merge": 0, "tf32x3": 0}, \
            bodies
        diff = (out.float() - ref.float()).abs()
        assert bool((diff <= (2.0 ** -7 if dtype == torch.bfloat16 else 0)
                     * ref.float().abs() + 2e-5).all()), diff.max().item()
    z = torch.zeros((1, 2, 4, 96), dtype=dtype, device=dev)
    with pytest.raises(ValueError, match="takes d in"):
        flash_prefill(z, z, z, causal=True)


def test_flash_split_without_scratch_is_an_error(dev):
    """A split asked for without its scratch is refused with an error
    (cudaErrorInvalidValue), not run on the FMA body instead."""
    import ctypes

    from repro_torch.kernels.flash_prefill import ops
    rng = np.random.default_rng(23)
    B, H, KVH, C, Smax, d = 1, 8, 2, 16, 1024, 128
    q = _randn(rng, (B, H, C, d), torch.bfloat16, dev)
    k = _randn(rng, (B, KVH, Smax, d), torch.bfloat16, dev)
    v = _randn(rng, (B, KVH, Smax, d), torch.bfloat16, dev)
    out = torch.zeros_like(q)
    start = torch.tensor([900], dtype=torch.int32, device=dev)
    qs, ks, vs, os_ = (ops._strides(t) for t in (q, k, v, out))
    err = ops._fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    start.data_ptr(), out.data_ptr(), None, 4,
                    ctypes.addressof(qs), ctypes.addressof(ks),
                    ctypes.addressof(vs), ctypes.addressof(os_), B, H, KVH,
                    C, Smax, d, 1, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 1                                  # cudaErrorInvalidValue
    assert not bool(out.any())                       # nothing ran


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


# the 16-byte body at row widths of 1 to 64 lane groups, with row counts
# that leave a block's last rows empty; the scalar body for d = 40 (no
# multiple of 16), d = 2048 (rows past the 16-byte body's) and codes at an
# odd address (a contiguous view 3 bytes into a buffer)
@pytest.mark.parametrize("T,d,offset", [
    (1000, 128, 0), (13, 16, 0), (9, 32, 0), (7, 48, 0), (33, 1024, 0),
    (40 * 16 * 8, 128, 0), (100, 40, 0), (5, 2048, 0), (100, 128, 3)])
def test_kv_dequantize_bodies(dev, T, d, offset):
    """float32 bit for bit the plain version (the same operations in the
    same order), bfloat16 bit for bit its round to nearest even; the
    16-byte body for d a multiple of 16 up to 1024 at aligned addresses,
    else the scalar one, by the counters."""
    from repro_torch.kernels.kv_quant import kv_dequantize, kv_dequantize_ref
    from repro_torch.kernels.kv_quant import ops
    rng = np.random.default_rng(T + d + offset)
    buf = torch.from_numpy(rng.integers(-128, 128, T * d + offset).astype(
        np.int8)).to(dev)
    q = buf[offset:].view(T, d)
    assert q.is_contiguous()
    lam = _randn(rng, (T, 1), torch.float32, dev).abs() * 0.05 + 1e-3
    z = torch.from_numpy(rng.integers(-40, 300, (T, 1)).astype(
        np.float32)).to(dev)
    want = ("vec16" if d % 16 == 0 and d <= 1024 and q.data_ptr() % 16 == 0
            else "scalar")
    ref = kv_dequantize_ref(q, lam, z, torch.float32)
    for dtype, bits in ((torch.float32, torch.int32),
                        (torch.bfloat16, torch.int16)):
        before = ops.body_launches()
        out = kv_dequantize(q, lam, z, dtype=dtype)
        torch.cuda.synchronize()
        took = {k: n - before[k] for k, n in ops.body_launches().items()}
        assert took == {"vec16": int(want == "vec16"),
                        "scalar": int(want == "scalar")}
        assert out.dtype == dtype
        assert torch.equal(out.view(bits), ref.to(dtype).view(bits))


def _quant_close(got, want):
    """INT8 codes within 1, scales within 1e-6 relative, zeros within 1,
    source by source (``tests/test_kernels.py``'s tolerance)."""
    for (q, lam, z), (qr, lamr, zr) in zip(got, want):
        assert (q.int() - qr.int()).abs().max().item() <= 1
        torch.testing.assert_close(lam, lamr, atol=0, rtol=1e-6)
        assert (z - zr).abs().max().item() <= 1


def _quantize_bodies(ops, before):
    return {k: n - before[k]
            for k, n in ops.body_launches("quantize").items()}


# the (T, d) float32 entry through both bodies: 16-byte loads at widths of
# one to four loads a lane (d 512) and half-warp rows (d 64, 80), one warp
# a row for d 6 and for rows one element off 16 bytes
@pytest.mark.parametrize("T,d,offset", [
    (1000, 128, 0), (1344, 64, 0), (7, 80, 0), (33, 512, 0), (100, 6, 0),
    (100, 128, 1)])
def test_kv_quantize_bodies(dev, T, d, offset):
    from repro_torch.kernels.kv_quant import kv_quantize, kv_quantize_ref
    from repro_torch.kernels.kv_quant import ops
    rng = np.random.default_rng(T + d + offset)
    buf = _randn(rng, (T * d + offset,), torch.float32, dev) * 4.0
    x = buf[offset:].view(T, d)
    want = ops.quantize_body(d, torch.float32, x.data_ptr() % 16 == 0)
    before = ops.body_launches("quantize")
    got = kv_quantize(x)
    torch.cuda.synchronize()
    assert _quantize_bodies(ops, before) == {
        "vec16": int(want == "vec16"), "scalar": int(want == "scalar")}
    _quant_close([got], [kv_quantize_ref(x)])


def _kv_stores(kind, rng, dtype, d, dev):
    """``(xs, pages, length)``: ``paged``, K and V of a (3, 9, 16, 2, d)
    pool through 3 pages, 37 tokens; ``dense``, lane 1's first 32
    positions of two (3, 3, 64, 2, d) caches, 21 tokens; ``page``, one
    page view of K; ``flat``, a contiguous (50, d) tensor; ``offset``, a
    (50, d) view one element into its buffer."""
    if kind == "paged":
        xs = tuple(_randn(rng, (3, 9, 16, 2, d), dtype, dev) * 4.0
                   for _ in range(2))
        return xs, torch.tensor([7, 2, 5], device=dev), 37
    if kind == "dense":
        xs = tuple((_randn(rng, (3, 3, 64, 2, d), dtype, dev) * 4.0)
                   .select(1, 1)[:, :32] for _ in range(2))
        return xs, None, 21
    if kind == "page":
        return (_randn(rng, (3, 9, 16, 2, d), dtype, dev)[:, 4],), None, None
    if kind == "flat":
        return (_randn(rng, (50, d), dtype, dev),), None, None
    buf = _randn(rng, (50 * d + 1,), dtype, dev)
    return (buf[1:].view(50, d),), None, None


@pytest.mark.parametrize("kind", ["paged", "dense", "page", "flat",
                                  "offset"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 80, 128, 6])
def test_kv_quantize_store(dev, kind, dtype, d):
    """The store entry against its plain version (gather, mask, float32,
    ``kv_quantize_ref``) wherever the rows lie, one launch for K and V,
    through the body ``ops.quantize_body`` names; masked rows exactly a
    zero row's; every output a view of the one staging buffer."""
    from repro_torch.kernels.kv_quant import (kv_quantize_store,
                                              kv_quantize_store_ref)
    from repro_torch.kernels.kv_quant import ops
    rng = np.random.default_rng(d + len(kind))
    xs, pages, length = _kv_stores(kind, rng, dtype, d, dev)
    want_body = ops.quantize_body(d, dtype, xs[0].data_ptr() % 16 == 0)
    before = ops.body_launches("quantize")
    n0 = kv_quantize_store.launches
    got, staging = kv_quantize_store(xs, pages=pages, length=length)
    torch.cuda.synchronize()
    assert kv_quantize_store.launches == n0 + 1
    assert _quantize_bodies(ops, before) == {
        "vec16": int(want_body == "vec16"),
        "scalar": int(want_body == "scalar")}
    _quant_close(got, kv_quantize_store_ref(xs, pages, length))
    lo = staging.data_ptr()
    for trip in got:
        assert all(lo <= t.data_ptr() < lo + staging.numel() for t in trip)
        if length is not None:
            q, lam, z = (t.view(3, -1, 2, t.shape[-1]) for t in trip)
            assert bool((q[:, length:] == -128).all())
            assert bool((lam[:, length:] == 1e-8).all())
            assert bool(torch.signbit(z[:, length:]).all())
            assert bool((z[:, length:] == 0).all())


def test_kv_quantize_store_rejects_what_it_does_not_take(dev):
    from repro_torch.kernels.kv_quant import kv_quantize_store
    k = torch.zeros((2, 3, 4, 1, 8), device=dev)
    with pytest.raises(ValueError):
        kv_quantize_store((k, k[:, :2]))                 # shapes differ
    with pytest.raises(ValueError):
        kv_quantize_store((k, k.bfloat16()))             # dtypes differ
    with pytest.raises(ValueError):
        kv_quantize_store((k, k, k))                     # three sources
    with pytest.raises(TypeError):
        kv_quantize_store((k.half(),))                   # float16
    with pytest.raises(ValueError):
        kv_quantize_store((k.transpose(3, 4),))          # d not contiguous
    with pytest.raises(ValueError):
        kv_quantize_store((k[None],))                    # rank 6
    with pytest.raises(ValueError):
        kv_quantize_store((k,), pages=torch.tensor([0]))  # pages on the CPU
    with pytest.raises(ValueError):
        kv_quantize_store((k,), pages=torch.tensor(
            [0], dtype=torch.int32, device=dev))         # int32 pages


def test_offload_blob_is_pinned_views_of_one_buffer(dev):
    """``quantize_kv_store`` on the card: the K and V blobs are CPU
    tensors in pinned memory, views of one host buffer, with the blob's
    shapes, and hold the kernel's values."""
    from repro_torch.kernels.kv_quant import kv_quantize_store_ref
    from repro_torch.serving.kv_cache import quantize_kv_store
    rng = np.random.default_rng(32)
    xs, pages, length = _kv_stores("paged", rng, torch.bfloat16, 128, dev)
    shape = (3, 3, 16, 2, 128)
    kb, vb = quantize_kv_store(xs, shape, pages=pages, length=length)
    parts = [*kb[:3], *vb[:3]]
    assert all(t.device.type == "cpu" and t.is_pinned() for t in parts)
    assert len({t.untyped_storage().data_ptr() for t in parts}) == 1
    assert kb[3] == vb[3] == shape and kb[0].shape == (3 * 3 * 16 * 2, 128)
    want = kv_quantize_store_ref(xs, pages, length)
    _quant_close([b[:3] for b in (kb, vb)],
                 [tuple(t.cpu() for t in w) for w in want])


def test_reserve_swap_memory_covers_a_full_lane(dev):
    """With INT8 swaps on the card each backend pins one host block of
    every power-of-two size from 4 KiB up to the first at or above a full
    lane's blob (``max_seq_len`` tokens); raw swaps and a model without
    K/V pin nothing."""
    from repro_torch.kernels.kv_quant.ops import store_layout
    from repro_torch.serving.kv_cache import (DenseKVBackend,
                                              KVBackendConfig,
                                              PagedKVBackend)
    model, _ = _graph_model(dev, "dense")
    for make in (lambda c: DenseKVBackend(model, c),
                 lambda c: PagedKVBackend(model, c, 16)):
        kv = make(KVBackendConfig(max_slots=2, max_seq_len=64,
                                  quantize_offload=True))
        k = kv._k_store()
        blob = store_layout(k.shape[0] * 64 * k.shape[-2], k.shape[-1], 2)[1]
        top = 4096
        while top < blob:
            top *= 2
        assert kv.reserve_swap_memory() == 2 * top - 4096
        kv.cfg.quantize_offload = False
        assert kv.reserve_swap_memory() == 0
    ssm, _ = _graph_model(dev, "ssm")
    assert DenseKVBackend(ssm, KVBackendConfig(
        max_slots=2, max_seq_len=64)).reserve_swap_memory() == 0


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


# 16-byte and scalar instances: the serving widths at a decode batch of 8
# and a 1024-row prefill (granite-moe's 1536 at a 256-row chunk), widths
# that are no multiple of the vector (1000 is one for bf16, 100 only for
# f32), a row too long to stay in registers (40000), and contiguous (T, d) views at an odd row offset of a larger
# buffer (d 1001: misaligned rows in both dtypes; d 100: aligned in f32)
@pytest.mark.parametrize("T,d,offset", [
    (8, 4096, 0), (8, 2560, 0), (8, 5120, 0), (1024, 5120, 0),
    (8, 1536, 0), (256, 1536, 0),
    (256, 4096, 0), (9, 1000, 0), (3, 100, 0), (2, 40000, 0), (5, 1001, 1),
    (8, 100, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
def test_fused_rmsnorm_widths_and_views(dev, T, d, offset, dtype,
                                        scale_dtype):
    """float32 within 2e-5 (relative beyond 1); bf16 element by element
    within one bf16 rounding step of the plain output (both sum in f32)."""
    from repro_torch.kernels.fused_rmsnorm import fused_rmsnorm, rmsnorm_ref
    rng = np.random.default_rng(T * 3 + d + offset)
    x = (_randn(rng, (T + 2 * offset, d), dtype, dev) * 3)[offset:offset + T]
    assert x.is_contiguous()
    s = _randn(rng, (d,), scale_dtype, dev)
    n0 = fused_rmsnorm.launches
    out = fused_rmsnorm(x, s)
    torch.cuda.synchronize()
    assert fused_rmsnorm.launches == n0 + 1 and out.dtype == dtype
    ref = rmsnorm_ref(x, s).float()
    diff = (out.float() - ref).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 2e-5 * max(1.0, ref.abs().max().item())
    else:
        assert bool((diff <= 2.0 ** -7 * ref.abs()).all()), diff.max().item()


# row 7's split-row entries: a (T, 2 d) row's halves on two "ranks" (the
# sum of squares of each half added, then each half scaled), widths 64 to
# 16384 a half, aligned and misaligned rows (an odd row offset of a larger
# buffer; d 1001 misaligned in both dtypes), a half too long for the
# registers (16384 in f32, 40000); against the plain twins and, the
# halves side by side, against the whole-row kernel on the whole row
@pytest.mark.parametrize("T,d,offset", [
    (1, 64, 0), (8, 2560, 0), (2048, 2560, 0), (1024, 8192, 0),
    (4, 16384, 0), (33, 1000, 0), (5, 1001, 1), (8, 100, 3),
    (2, 40000, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
def test_split_rmsnorm_entries(dev, T, d, offset, dtype, scale_dtype):
    from repro_torch.kernels.fused_rmsnorm import (fused_rmsnorm,
                                                   rmsnorm_apply,
                                                   rmsnorm_apply_ref,
                                                   rmsnorm_sumsq,
                                                   rmsnorm_sumsq_ref)
    rng = np.random.default_rng(T * 5 + d + offset)
    x = (_randn(rng, (T + 2 * offset, 2 * d), dtype, dev)
         * 3)[offset:offset + T]
    s = _randn(rng, (2 * d,), scale_dtype, dev)
    halves = [x[:, :d].contiguous(), x[:, d:].contiguous()]
    if offset:                       # each half at an odd row offset too
        halves = [(torch.cat([h[:1], h, h[:1]]))[1:T + 1] for h in halves]
        assert all(h.is_contiguous() for h in halves)
    scales = [s[:d].contiguous(), s[d:].contiguous()]
    n0 = (rmsnorm_sumsq.launches, rmsnorm_apply.launches)
    sums = [rmsnorm_sumsq(h) for h in halves]
    for got, h in zip(sums, halves):
        assert got.dtype == torch.float32 and got.shape == (T,)
        want = rmsnorm_sumsq_ref(h)
        assert bool(((got - want).abs() <= 1e-5 * want.abs()).all())
    total = sums[0] + sums[1]
    outs = [rmsnorm_apply(h, total, sc, 2 * d)
            for h, sc in zip(halves, scales)]
    torch.cuda.synchronize()
    assert (rmsnorm_sumsq.launches, rmsnorm_apply.launches) == \
        (n0[0] + 2, n0[1] + 2)
    plains = torch.cat([rmsnorm_apply_ref(h, total, sc, 2 * d)
                        for h, sc in zip(halves, scales)], -1).float()
    whole = fused_rmsnorm(x.contiguous(), s).float()
    got = torch.cat(outs, -1).float()
    assert got.shape == (T, 2 * d) and outs[0].dtype == dtype
    for want in (plains, whole):
        diff = (got - want).abs()
        if dtype == torch.float32:
            assert diff.max().item() <= 2e-5 * max(1.0,
                                                   want.abs().max().item())
        else:
            assert bool((diff <= 2.0 ** -7 * want.abs()).all()), \
                diff.max().item()


def test_split_rmsnorm_entries_refuse_bad_layouts(dev):
    """A CUDA tensor never goes to the plain twin: a bad layout raises."""
    from repro_torch.kernels.fused_rmsnorm import rmsnorm_apply, rmsnorm_sumsq
    x = torch.randn((4, 64), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm_sumsq(x.t())
    with pytest.raises(ValueError, match="sumsq must be"):
        rmsnorm_apply(x, torch.ones(4, device=dev, dtype=torch.float64),
                      torch.ones(64, device=dev), 128)
    with pytest.raises(ValueError, match="d_full"):
        rmsnorm_apply(x, torch.ones(4, device=dev), torch.ones(64, device=dev),
                      32)
    with pytest.raises(ValueError, match="scale must be"):
        rmsnorm_apply(x, torch.ones(4, device=dev), torch.ones(32, device=dev),
                      128)


def _ssd_tol(Q, N):
    """1e-4 (``tests/test_kernels_ssd.py``) up to its shapes (Q * N <= 64 *
    16); beyond them float32 accumulation error grows with the square root
    of the sums' lengths (N in C . B^T, Q in the sums over s), and so does
    the tolerance."""
    return 1e-4 * max(1.0, (Q * N / 1024) ** 0.5)


def _ssd_inputs(rng, B, C, Q, H, P, N, decay, dev):
    """xbar, dA, B and C of one SSD chunk call.  ``decay`` "small": dA =
    -0.1 |randn| (cum to about -0.08 Q); "model": dA = -softplus(randn), as
    the model's A = -1 and dt = softplus(.) make it (cum to about -0.8 Q,
    -180 over a chunk of 256, where exp(cum[q]) . exp(-cum[s]) would
    overflow float32)."""
    xbar = _randn(rng, (B, C, Q, H, P), torch.float32, dev)
    dA = _randn(rng, (B, C, Q, H), torch.float32, dev)
    dA = (-torch.nn.functional.softplus(dA) if decay == "model"
          else -dA.abs() * 0.1)
    Bc = _randn(rng, (B, C, Q, N), torch.float32, dev)
    Cc = _randn(rng, (B, C, Q, N), torch.float32, dev)
    return xbar, dA, Bc, Cc


def _ssd_bodies(fn):
    """(fn's result, the launches of each SSD body it made)."""
    from repro_torch.kernels.ssd_scan import ops
    before = ops.body_launches()
    out = fn()
    torch.cuda.synchronize()
    after = ops.body_launches()
    return out, {k: after[k] - before[k] for k in after}


def _ssd_took(body):
    """The body counters' reading of one call that took ``body``."""
    if body == "fma":
        return {"fma": 1, "tf32x3_states": 0, "tf32x3_y": 0}
    return {"fma": 0, "tf32x3_states": 1, "tf32x3_y": 1}


# The FMA body's shapes (head dim or state size other than 64 / 128, or Q
# past 256), then the tensor-core body's: Q from 1 to a full chunk of 256
# with 3 and 80 heads (no multiple of the planned head groups), and heads
# of 128 columns (jamba's), which it runs as two heads of 64.  Every
# shape at small decay; at the model's decay every shape within the
# model's chunk (Q <= 256, cum down to about -180).  At Q 1024 the model's
# decay takes cum to about -800, where two float32 cumsums of the same
# values differ by more than this tolerance allows; the model never makes
# a chunk that long, and test_ssd_chunk_long_chunk_against_float64 holds
# the kernel there to the float64 truth instead.
_SSD_SHAPES = [
    (1, 2, 16, 2, 16, 16), (2, 4, 32, 4, 16, 16), (1, 2, 64, 2, 32, 8),
    (1, 3, 37, 3, 24, 40), (2, 1, 100, 2, 64, 128), (1, 4, 256, 80, 64, 128),
    (1, 1, 1024, 2, 128, 256), (1, 1, 1, 3, 64, 128), (2, 2, 16, 3, 64, 128),
    (1, 1, 200, 3, 64, 128), (1, 2, 256, 3, 64, 128), (1, 1, 1, 80, 64, 128),
    (1, 2, 16, 80, 64, 128), (1, 1, 200, 80, 64, 128),
    (1, 1, 1, 3, 128, 128), (2, 2, 16, 3, 128, 128),
    (1, 1, 200, 5, 128, 128), (1, 4, 256, 128, 128, 128),
]


@pytest.mark.parametrize("B,C,Q,H,P,N,decay", [
    (*shape, decay) for decay in ("small", "model") for shape in _SSD_SHAPES
    if decay == "small" or shape[2] <= 256])
def test_ssd_chunk_kernel(dev, B, C, Q, H, P, N, decay):
    from repro_torch.kernels.ssd_scan import plan, ssd_chunk, ssd_chunk_ref
    rng = np.random.default_rng(Q + H + N)
    xbar, dA, Bc, Cc = _ssd_inputs(rng, B, C, Q, H, P, N, decay, dev)
    n0 = ssd_chunk.launches
    out, took = _ssd_bodies(lambda: ssd_chunk(xbar, dA, Bc, Cc))
    assert ssd_chunk.launches == n0 + 1
    assert took == _ssd_took(plan.body(Q, P, N))
    for o, r in zip(out, ssd_chunk_ref(xbar, dA, Bc, Cc)):
        assert torch.isfinite(o).all()
        tol = _ssd_tol(Q, N)
        torch.testing.assert_close(o, r, atol=tol, rtol=tol)


@pytest.mark.parametrize("Q,P,N", [(1024, 128, 256), (256, 64, 128),
                                   (256, 128, 128)])
def test_ssd_chunk_long_chunk_against_float64(dev, Q, P, N):
    """At the model's decay over a chunk of 1024 (cum to about -800) and of
    256, the kernel is no further from the float64 truth (the plain version
    on float64 inputs) than twice the float32 plain version is, in every
    output: what error there is comes from float32 cumsums of large
    magnitude, which both share."""
    from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_ref
    rng = np.random.default_rng(Q + 7)
    args = _ssd_inputs(rng, 1, 1, Q, 2, P, N, "model", dev)
    assert torch.cumsum(args[1], dim=2).min().item() < -0.5 * Q
    out = ssd_chunk(*args)
    plain = ssd_chunk_ref(*args)
    truth = ssd_chunk_ref(*(a.double() for a in args))
    for o, r, t in zip(out, plain, truth):
        assert torch.isfinite(o).all()
        err = (o.double() - t).abs().max().item()
        ref_err = (r.double() - t).abs().max().item()
        assert err <= 2 * ref_err + 1e-6, (err, ref_err)


@pytest.mark.parametrize("Q,P,N,offset", [
    (256, 64, 128, 0), (200, 64, 128, 0), (1, 64, 128, 0),
    (257, 64, 128, 0), (256, 32, 128, 0), (256, 64, 64, 0),
    (256, 64, 128, 1), (64, 64, 128, 2), (256, 128, 128, 0),
    (100, 128, 128, 0), (256, 128, 128, 1), (256, 96, 128, 0)])
def test_ssd_chunk_takes_the_planned_body(dev, Q, P, N, offset):
    """Each call takes the body ``plan.body`` names from the shapes and
    addresses: the tensor-core body for Q <= 256, P 64 or 128 (two heads
    of 64 a head), N 128 in 16-byte aligned tensors, the FMA body for
    other shapes and for contiguous views ``offset`` floats into a
    buffer."""
    from repro_torch.kernels.ssd_scan import plan, ssd_chunk, ssd_chunk_ref
    B, C, H = 1, 2, 5
    rng = np.random.default_rng(Q + P + N + offset)

    def view(shape):
        n = int(np.prod(shape))
        buf = _randn(rng, (n + offset,), torch.float32, dev)
        return buf[offset:].view(shape)
    xbar = view((B, C, Q, H, P))
    dA = -view((B, C, Q, H)).abs() * 0.1
    Bc, Cc = view((B, C, Q, N)), view((B, C, Q, N))
    out, took = _ssd_bodies(lambda: ssd_chunk(xbar, dA, Bc, Cc))
    want = plan.body(Q, P, N, [t.data_ptr() for t in (xbar, Bc, Cc)])
    assert want == ("tf32x3" if (Q <= 256 and P in (64, 128) and N == 128
                                 and offset == 0) else "fma")
    assert took == _ssd_took(want)
    for o, r in zip(out, ssd_chunk_ref(xbar, dA, Bc, Cc)):
        tol = _ssd_tol(Q, N)
        torch.testing.assert_close(o, r, atol=tol, rtol=tol)



@pytest.mark.parametrize("P", [64, 128])
def test_ssd_chunk_function_backward_on_the_card(dev, P):
    """``SsdChunk`` on the card (the kernel forward through the body its
    plan names, the plain recomputed backward) at the model's decay: its
    outputs within the chunk's tolerance of the plain version, and its
    gradients against autograd through ``ssd_chunk_ref`` on the same
    inputs and upstream gradients (the same plain backward, from the
    saved inputs: 1e-5)."""
    from repro_torch.kernels.ssd_scan import SsdChunk, ssd_chunk_ref
    rng = np.random.default_rng(40 + P)
    B, C, Q, H, N = 1, 2, 256, 4, 128
    ins = _ssd_inputs(rng, B, C, Q, H, P, N, "model", dev)
    ups = [_randn(rng, s, torch.float32, dev)
           for s in ((B, C, Q, H, P), (B, C, H, P, N), (B, C, H))]
    grads, outs = [], []
    for fn in (SsdChunk.apply, ssd_chunk_ref):
        leaves = [t.clone().requires_grad_(True) for t in ins]
        out = fn(*leaves)
        outs.append(out)
        total = sum((o * u).sum() for o, u in zip(out, ups))
        grads.append(torch.autograd.grad(total, leaves))
    tol = _ssd_tol(Q, N)
    for o, r in zip(*outs):
        torch.testing.assert_close(o.detach(), r.detach(), atol=tol,
                                   rtol=tol)
    for g, w in zip(*grads):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


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
    from repro_torch.kernels.kv_quant import paged_attention_q8
    codes = torch.zeros((2, 4, 1, 64), dtype=torch.int8, device=dev)
    scale = torch.ones((2, 4, 1, 1), device=dev)
    tables = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    lengths = torch.ones((1,), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):                          # float codes
        paged_attention_q8(torch.zeros((1, 2, 64), device=dev),
                           codes.float(), scale, scale, codes.float(), scale,
                           scale, tables, lengths)
    with pytest.raises(ValueError):                         # d = 40
        paged_attention_q8(torch.zeros((1, 2, 40), device=dev),
                           codes[..., :40].contiguous(), scale, scale,
                           codes[..., :40].contiguous(), scale, scale,
                           tables, lengths)
    with pytest.raises(ValueError):                         # d = 36
        paged_attention(torch.zeros((1, 2, 36), device=dev),
                        torch.zeros((2, 4, 1, 36), device=dev),
                        torch.zeros((2, 4, 1, 36), device=dev), tables,
                        lengths)
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
    (1, 4, 4, 37, 80), (2, 8, 2, 200, 80), (4, 32, 32, 1024, 80),
    (1, 16, 16, 4096, 64),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_prefill_kernel(dev, B, H, KVH, S, d, dtype, causal):
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_ref, plan)
    rng = np.random.default_rng(S + d + causal)
    # strided q/k/v, as chunked_attention passes them: (B, S, H, d)
    # tensors viewed as (B, H, S, d)
    q = _randn(rng, (B, S, H, d), dtype, dev).transpose(1, 2)
    k = _randn(rng, (B, S, KVH, d), dtype, dev).transpose(1, 2)
    v = _randn(rng, (B, S, KVH, d), dtype, dev).transpose(1, 2)
    n0 = flash_prefill.launches
    out, bodies = _bodies(lambda: flash_prefill(q, k, v, causal=causal))
    assert flash_prefill.launches == n0 + 1
    # aligned views take the tensor-core bodies: wgmma for bf16, 3xTF32
    # for float32
    if dtype == torch.bfloat16:
        split = plan.num_splits(B, KVH, H // KVH, S, S) > 1
        assert bodies == {"fma": 0, "wgmma": 1, "merge": int(split),
                      "tf32x3": 0}, bodies
    else:
        assert bodies == {"fma": 0, "wgmma": 0, "merge": 0, "tf32x3": 1}, \
            bodies
    ref = flash_prefill_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))
    if dtype == torch.bfloat16:          # the Hopper body
        qf, kf, vf = q.float(), k.float(), v.float()
        _check_bf16_attention(
            out, ref, flash_prefill_ref(qf, kf, vf, causal=causal),
            flash_prefill_ref(qf, kf, vf.abs(), causal=causal),
            _sdpa_bf16(q, k, v, causal=causal))


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
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_prefix)
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


def test_dense_granite_kernel_path_matches_plain(dev):
    """The smoke granite config in float32 with heads of 64 on the dense
    backend's model path: one monolithic prefill of a right-padded prompt
    (the flash and RMSNorm kernels), one dense decode step (RMSNorm
    kernel, plain decode attention) and a prompt written into a lane's
    stripe as one ``prefill_chunk`` (the engine's route: the prefix flash
    kernel, against the masked route), each kernel path against
    ``use_kernels=False`` on the same cache: logits within 1e-4, the
    written K/V within 1e-5 (float32 sums in another order)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_prefix)
    from repro_torch.kernels.fused_rmsnorm import fused_rmsnorm
    from repro_torch.models.model import Model
    cfg = get_smoke_config("granite-3-8b").scaled(param_dtype="float32",
                                                  head_dim=64)
    model = Model(cfg, kv_dtype="float32", device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(2, cfg.vocab_size, (2, 32))).to(dev)
    toks[0, 21:] = 0
    last = torch.tensor([20, 31], dtype=torch.int32, device=dev)
    feed = torch.tensor([[5], [9]], device=dev)
    out = {}
    for use in (True, False):
        model.use_kernels = use
        n0 = (flash_prefill.launches, fused_rmsnorm.launches)
        logits, pc = model.prefill(params, {"tokens": toks,
                                            "last_index": last})
        cache = model.init_cache(2, 64)
        for key in ("k", "v"):
            cache[key][:, :, :32] = pc[key]
        cache["lengths"] = last.clone() + 1
        step = model.decode_step(params, cache, feed)
        n1 = (flash_prefill.launches, fused_rmsnorm.launches)
        assert (n1[0] > n0[0] and n1[1] > n0[1]) == use
        model.chunk_attn_impl = "flash" if use else "masked"
        n0 = flash_prefill_prefix.launches
        lane = model.init_cache(1, 64)
        chunk = model.prefill_chunk(params, lane["k"][:, 0], lane["v"][:, 0],
                                    toks[:1], 0, 21)
        assert (flash_prefill_prefix.launches > n0) == use
        out[use] = (logits, step, cache, chunk, lane)
    a, b = out[True], out[False]
    for i in (0, 1, 3):
        torch.testing.assert_close(a[i], b[i], atol=1e-4, rtol=0)
    for i in (2, 4):
        for key in ("k", "v"):
            torch.testing.assert_close(a[i][key], b[i][key], atol=1e-5,
                                       rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stablelm_head_dim_80_kernel_path_matches_plain(dev, dtype):
    """stablelm-3b at full width (d_model 2560, 32 heads of 80) and 2
    layers: a prompt of 300 tokens through ``Model.prefill`` (the
    full-sequence flash kernel, causal) and into a lane's stripe as two
    chunks of 256 and 44 (the prefix flash kernel), each kernel path
    against the plain path (``use_kernels=False``, masked chunk
    attention): logits within a relative L2 of 1e-4 in float32 and 0.05
    in bfloat16 (the repo's bf16 tolerance), the bf16 chunks through the
    wgmma body."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_prefix)
    from repro_torch.models.model import Model
    cfg = get_config("stablelm-3b").scaled(num_layers=2, param_dtype=dtype)
    assert cfg.hd == 80
    model = Model(cfg, kv_dtype=dtype, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(25).integers(
        2, cfg.vocab_size, (1, 300))).to(dev)
    out = {}
    for use in (True, False):
        model.use_kernels = use
        model.chunk_attn_impl = "flash" if use else "masked"
        n0 = (flash_prefill.launches, flash_prefill_prefix.launches)
        whole, _ = model.prefill(params, {"tokens": toks})
        lane = model.init_cache(1, 512)
        chunks, bodies = [], {}
        for s0, e0 in ((0, 256), (256, 300)):
            got, b = _bodies(lambda: model.prefill_chunk(
                params, lane["k"][:, 0], lane["v"][:, 0], toks[:, s0:e0], s0,
                e0 - s0))
            chunks.append(got)
            bodies = {k: bodies.get(k, 0) + n for k, n in b.items()}
        n1 = (flash_prefill.launches, flash_prefill_prefix.launches)
        assert (n1[0] > n0[0] and n1[1] > n0[1]) == use
        if use and dtype == "bfloat16":
            assert bodies["wgmma"] == 2 * cfg.num_layers and not bodies["fma"]
        out[use] = [whole] + chunks
    tol = 1e-4 if dtype == "float32" else 5e-2
    for a, b in zip(out[True], out[False]):
        rel = ((a - b).norm() / b.norm()).item()
        assert rel <= tol, rel


def test_seamless_decode_graphed_equals_eager(dev):
    """seamless's smoke config in bf16 (heads of 64) on the dense backend:
    three requests of 32 encoder frames each prefilled by ``Model.prefill``
    (the flash kernel, bidirectional in the encoder and causal in the
    decoder) and placed by ``write_prefill``, then 6 fused decode steps
    with an INT8 swap of one lane after the second: the step graph's
    tokens, reasons and every cache key (the cross cache included) equal
    the eager steps' bit for bit, and each graphed step is a replay."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.models.model import Model
    from repro_torch.serving.kv_cache import DenseKVBackend, KVBackendConfig
    cfg = get_smoke_config("seamless-m4t-large-v2").scaled(head_dim=64)
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(3))
    rng = np.random.default_rng(26)
    frames = [_randn(rng, (1, cfg.cross_kv_len, cfg.d_model), torch.bfloat16,
                     dev) for _ in range(3)]

    def run(graphs):
        kv = DenseKVBackend(model, KVBackendConfig(
            max_slots=4, max_seq_len=16, quantize_offload=True,
            cuda_graphs=graphs, eos_token=-1))
        B = 4
        toks = np.zeros((B, 1), np.int32)
        active = np.zeros((B,), bool)
        n0 = flash_prefill.launches
        for rid, f in enumerate(frames):
            logits, pc = model.prefill(params, {
                "enc_embeds": f, "tokens": torch.tensor([[rid + 2]],
                                                        device=dev)})
            kv.write_prefill(rid, pc, 1)
            toks[rid, 0], active[rid] = int(logits[0].argmax()), True
        assert flash_prefill.launches - n0 == 3 * (cfg.num_encoder_layers
                                                   + cfg.num_layers)
        outs = []
        for i in range(6):
            if i == 2:
                kv.upload(0, kv.offload(0))
            gen = np.full((B,), i + 2, np.int32)
            got = kv.decode(params, toks, active, gen, gen,
                            np.full((B,), 2 ** 31 - 1, np.int32),
                            np.arange(B, dtype=np.int32))
            outs.append(got)
            toks[:, 0] = got[0]
        torch.cuda.synchronize()
        return outs, kv
    (og, kg), (oe, ke) = run(True), run(False)
    for (ta, ra), (tb, rb) in zip(og, oe):
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(ra, rb)
    for key in kg.cache:
        assert torch.equal(kg.cache[key], ke.cache[key]), key
    assert kg.graphs.replays["decode"] == 6 and kg.graphs.captures == 1
    assert ke.graphs.captures == 0


def test_hybrid_decode_graphed_equals_eager(dev):
    """jamba's smoke config in bf16 (attention heads of 64, one Mamba head
    of 128 with state 128: the SSD chunk's tensor-core body through the
    head split) on the dense backend: three unpadded prompts prefilled by
    ``Model.prefill`` and placed by ``write_prefill``, then 6 fused decode
    steps with an INT8 swap of one lane after the second: the step
    graph's tokens, reasons and every cache key equal the eager steps'
    bit for bit, each graphed step is a replay, and every prefill's SSD
    calls took the tensor-core body."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models.model import Model
    from repro_torch.serving.kv_cache import DenseKVBackend, KVBackendConfig
    cfg = get_smoke_config("jamba-1.5-large-398b").scaled(
        head_dim=64, ssm_headdim=128, ssm_state=128)
    model = Model(cfg, chunk_attn_impl="flash", device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(3))
    rng = np.random.default_rng(27)
    prompts = [torch.from_numpy(rng.integers(2, cfg.vocab_size, (1, n))
                                ).to(dev) for n in (5, 37, 300)]

    def run(graphs):
        kv = DenseKVBackend(model, KVBackendConfig(
            max_slots=4, max_seq_len=320, quantize_offload=True,
            cuda_graphs=graphs, eos_token=-1))
        B = 4
        toks = np.zeros((B, 1), np.int32)
        active = np.zeros((B,), bool)
        before = ssd_ops.body_launches()
        for rid, prompt in enumerate(prompts):
            logits, pc = model.prefill(params, {"tokens": prompt})
            kv.write_prefill(rid, pc, prompt.shape[1])
            toks[rid, 0], active[rid] = int(logits[0].argmax()), True
        torch.cuda.synchronize()
        body = {k: n - before[k] for k, n in ssd_ops.body_launches().items()}
        assert body == {"fma": 0, "tf32x3_states": 3 * 7, "tf32x3_y": 3 * 7}
        outs = []
        for i in range(6):
            if i == 2:
                kv.upload(2, kv.offload(2))
            gen = np.full((B,), i + 2, np.int32)
            got = kv.decode(params, toks, active, gen, gen,
                            np.full((B,), 2 ** 31 - 1, np.int32),
                            np.arange(B, dtype=np.int32))
            outs.append(got)
            toks[:, 0] = got[0]
        torch.cuda.synchronize()
        return outs, kv
    (og, kg), (oe, ke) = run(True), run(False)
    for (ta, ra), (tb, rb) in zip(og, oe):
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(ra, rb)
    for key in kg.cache:
        assert torch.equal(kg.cache[key], ke.cache[key]), key
    assert kg.graphs.replays["decode"] == 6 and kg.graphs.captures == 1
    assert ke.graphs.captures == 0


# ------------------------------------------ CUDA graphs of the serving steps

def _graph_model(dev, family):
    """The smoke config of a family in bf16, the serving dtype; granite's
    and granite-moe's with heads of 64 (the flash kernel's head dims)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import Model
    if family == "ssm":
        cfg = get_smoke_config("mamba2-2.7b")
    elif family == "moe":
        cfg = get_smoke_config("granite-moe-3b-a800m").scaled(head_dim=64)
    else:
        cfg = get_smoke_config("granite-3-8b").scaled(head_dim=64)
    model = Model(cfg, kv_dtype="bfloat16", chunk_attn_impl="flash",
                  device=dev)
    return model, model.init(torch.Generator(device=dev).manual_seed(3))


def _graph_backend(model, backend, cuda_graphs):
    from repro_torch.serving.kv_cache import (DenseKVBackend,
                                              KVBackendConfig, PagedKVBackend)
    bcfg = KVBackendConfig(max_slots=4, max_seq_len=64, page_size=16,
                           attn_impl="kernel", graph_buckets=(8, 16, 32),
                           cuda_graphs=cuda_graphs, eos_token=-1)
    if backend == "paged":
        return PagedKVBackend(model, bcfg, num_pages=32)
    return DenseKVBackend(model, bcfg)


def _counters():
    from repro_torch.kernels import counters
    return counters.snapshot()


def _serve_steps(kv, model, params):
    """Warm every key (a throwaway chunk per bucket in every lane, an idle
    decode step), then three prompts in chunks of buckets 8, 16 and 32
    (mamba: monolithic prefills) and 6 fused decode steps.  Returns the
    chunk logits, the decode outputs, the counters' movement over the
    prompts and steps (not the warm runs), and the backend."""
    from repro_torch.kernels import counters
    B = kv.cfg.max_slots
    idle = (np.zeros((B, 1), np.int32), np.zeros((B,), bool),
            np.zeros((B,), np.int32), np.zeros((B,), np.int32),
            np.full((B,), 2 ** 31 - 1, np.int32), np.zeros((B,), np.int32))
    ssm = model.cfg.family == "ssm"
    if not ssm:
        for lane in range(B):
            for b in (8, 16, 32):
                kv.prefill_chunk(params, -1, [1] * b, 0, slot=lane)
                kv.clear(-1)
    kv.decode(params, *idle)
    torch.cuda.synchronize()
    before = counters.snapshot()
    rng = np.random.default_rng(9)
    prompts = {1: rng.integers(2, 512, 13).tolist(),
               2: rng.integers(2, 512, 20).tolist(),
               3: rng.integers(2, 512, 30).tolist()}
    logits = []
    for rid, p in prompts.items():
        if ssm:
            out, cache = model.prefill(params, {"tokens": torch.tensor(
                [p], device=model.device)})
            kv.write_prefill(rid, cache, len(p))
            logits.append(out)
            continue
        cuts = {1: (0, 8, 13), 2: (0, 16, 20), 3: (0, 30)}[rid]
        for s, e in zip(cuts, cuts[1:]):
            logits.append(kv.prefill_chunk(params, rid, p[s:e], s))
    toks = np.zeros((B, 1), np.int32)
    active = np.zeros((B,), bool)
    ctx = np.zeros((B,), np.int32)
    rids = np.zeros((B,), np.int32)
    for rid, p in prompts.items():
        slot = kv.slot_of(rid)
        toks[slot, 0], active[slot], ctx[slot], rids[slot] = (
            int(logits[-1][0].argmax()), True, len(p), rid)
    outs = []
    for i in range(6):
        got = kv.decode(params, toks, active, np.full((B,), i + 1, np.int32),
                        ctx + i + 1, idle[4], rids)
        outs.append(got)
        toks[:, 0] = got[0]
    torch.cuda.synchronize()
    return logits, outs, counters.delta(before, counters.snapshot()), kv


@pytest.mark.parametrize("backend,family", [
    ("paged", "dense"), ("dense", "dense"), ("dense", "ssm")])
def test_step_graph_replay_equals_eager(dev, backend, family):
    """Every key kind (paged and dense decode, paged chunks, dense chunks
    per lane, mamba's decode) replayed as a CUDA graph gives the eager
    step's logits, tokens, reasons and KV or state bit for bit, and moves
    every wrapper's launch count and every library's body counters as the
    eager steps do."""
    model, params = _graph_model(dev, family)
    runs = {g: _serve_steps(_graph_backend(model, backend, g), model, params)
            for g in (True, False)}
    (lg, og, cg, kg), (le, oe, ce, ke) = runs[True], runs[False]
    for a, b in zip(lg, le):
        assert torch.equal(a, b)
    for (ta, ra), (tb, rb) in zip(og, oe):
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(ra, rb)
    if backend == "paged":
        # every page but the scratch page, the target of inactive lanes'
        # and padded rows' writes (duplicate indices: no order is kept)
        live = [p for p in range(kg.pool.k.shape[1])
                if p != kg.scratch_page]
        state = {"k": (kg.pool.k[:, live], ke.pool.k[:, live]),
                 "v": (kg.pool.v[:, live], ke.pool.v[:, live])}
    else:
        state = {k: (kg.cache[k], ke.cache[k]) for k in kg.cache}
    for key, (a, b) in state.items():
        assert torch.equal(a, b), key
    assert cg == ce and cg.get("fused_rmsnorm", 0) > 0
    if backend == "paged":
        assert cg["paged_attention"] == 6 * model.cfg.num_layers
    if family != "ssm":
        assert cg["flash_prefill_prefix"] > 0
    chunks = 0 if family == "ssm" else (4 if backend == "dense" else 1) * 3
    assert kg.graphs.captures == len(kg.graphs) == 1 + chunks
    assert kg.graphs.replays["decode"] == 7
    assert ke.graphs.captures == 0 and ke.graphs.replays["decode"] == 0


@pytest.mark.parametrize("backend", ["paged", "dense"])
def test_zero_captures_after_warmup_on_the_card(dev, backend):
    """A warmed engine on the card serves a staged trace (chunks of two
    buckets, INT8 swaps forced by two lanes) with no capture and no
    library build or load, and every decode step is a replay."""
    from repro_torch.core.engine import EngineConfig, ServingEngine
    from repro_torch.core.predictor import OraclePredictor
    from repro_torch.core.quantization import kv_bytes_per_token
    from repro_torch.core.request import Request, reset_request_counter
    from repro_torch.utils.compile_counter import CompileCounter
    model, params = _graph_model(dev, "dense")
    cfg = model.cfg
    bpt = kv_bytes_per_token(cfg.num_layers, cfg.num_kv_heads, cfg.hd)
    eng = ServingEngine(model, params, EngineConfig(
        max_slots=2, max_seq_len=64, max_new_tokens=24, strategy="alise",
        quantize_offload=True, hbm_bytes=2 * 40 * bpt, kv_backend=backend,
        page_size=16, paged_attn_impl="kernel", prefill_chunk=16,
        iter_token_budget=24, eos_token=-1, warmup_compile=True),
        predictor=OraclePredictor())
    w = eng.warm_stats
    assert w["captures"] == w["keys"] == len(eng.kv.graphs) >= 3
    assert w["pool_bytes"] > 0
    reset_request_counter()
    rng = np.random.default_rng(5)
    reqs = [Request(prompt_len=p, arrival_time=0.0, true_out_len=o,
                    prompt_tokens=rng.integers(2, 512, p).tolist())
            for p, o in zip((7, 30, 9, 17, 3, 12), (20, 20, 4, 6, 3, 5))]
    counter = CompileCounter()
    t = 0.0
    with counter.expect_no_compiles(f"serve[{backend}]"):
        for r in reqs[:2]:
            eng.submit(r, t)
        for _ in range(5):
            eng.step(t)
            t += 0.1
        for r in reqs[2:]:
            eng.submit(r, t)
        for _ in range(1000):
            if not eng.sched.live:
                break
            eng.step(t)
            t += 0.1
    counter.detach()
    assert all(r.done for r in reqs)
    assert sum(r.preempt_count for r in reqs) > 0
    assert (eng.kv.graphs.replays["decode"] - w["replays"]["decode"]
            == len(eng.iter_times))


@pytest.mark.parametrize("backend", ["paged", "dense"])
def test_moe_engine_graphed_equals_eager(dev, backend):
    """A warmed engine of the smoke MoE config (capacity factor 1.25: an
    inactive lane's routed token competes with the active ones, and the
    paged backend's inactive lanes share the scratch page) serves a staged
    trace with swaps on a virtual clock, graphed and eagerly, on the same
    plan (the graphed engine's measured chunk costs given to the eager
    one): greedy tokens equal bit for bit, no capture or library load
    while the graphed engine serves, every decode step a replay."""
    from repro_torch.core.engine import EngineConfig, ServingEngine
    from repro_torch.core.predictor import OraclePredictor
    from repro_torch.core.quantization import kv_bytes_per_token
    from repro_torch.core.request import Request, reset_request_counter
    from repro_torch.utils.compile_counter import CompileCounter
    model, params = _graph_model(dev, "moe")
    cfg = model.cfg
    bpt = kv_bytes_per_token(cfg.num_layers, cfg.num_kv_heads, cfg.hd)

    def run(graphs, costs=None):
        eng = ServingEngine(model, params, EngineConfig(
            max_slots=4, max_seq_len=64, max_new_tokens=24,
            strategy="alise", quantize_offload=False,
            hbm_bytes=2 * 40 * bpt, kv_backend=backend, page_size=16,
            paged_attn_impl="kernel", prefill_chunk=16,
            iter_token_budget=24, eos_token=-1, warmup_compile=True,
            cuda_graphs=graphs), predictor=OraclePredictor())
        if costs is not None:
            eng.latency.bucket_costs = dict(costs)
        w = eng.warm_stats
        reset_request_counter()
        rng = np.random.default_rng(5)
        reqs = [Request(prompt_len=p, arrival_time=0.0, true_out_len=o,
                        prompt_tokens=rng.integers(2, 512, p).tolist())
                for p, o in zip((7, 30, 9, 17, 3, 12), (20, 20, 4, 6, 3, 5))]
        counter = CompileCounter()
        t = 0.0
        with counter.expect_no_compiles(f"moe serve[{backend}]"):
            for r in reqs[:2]:
                eng.submit(r, t)
            for _ in range(5):
                eng.step(t)
                t += 0.1
            for r in reqs[2:]:
                eng.submit(r, t)
            while eng.sched.live:
                eng.step(t)
                t += 0.1
        counter.detach()
        assert all(r.done for r in reqs)
        if graphs:
            assert (eng.kv.graphs.replays["decode"] - w["replays"]["decode"]
                    == len(eng.iter_times))
        return [list(r.output_tokens) for r in reqs], eng

    graphed, eng = run(True)
    eager, _ = run(False, eng.latency.bucket_costs)
    assert graphed == eager
    assert eng.warm_stats["captures"] > 0


# ------------------------------------------------- packed prefill on the card

# per bucket C, each pack row's chunk length (the last row is padding)
PACK_LENS = {256: [256, 200, 17, 0], 32: [32, 25, 17, 0], 16: [16, 9, 1, 0]}


@pytest.mark.parametrize("C", sorted(PACK_LENS))
@pytest.mark.parametrize("G", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_prefill_prefix_pack_rows(dev, G, dtype, C):
    """The prefix flash kernel at a pack's shape: B = 4 rows at mixed
    starts, whose chunks (ragged, e.g. 256, 200, 17 and 0 tokens at bucket
    256, the last a padding row) fill each stripe only up to their ends,
    past which the stripe holds stale values; KVH 8 as granite's.  The
    kernel computes every row's C queries (the model keeps each row's
    first chunk-length ones), against its plain version (f32 2e-5, bf16
    5e-2), through the body and merge the plan names: in bf16 bucket 16
    splits the keys (body and merge) at every G, 32 at G 1 and 4, 256
    never."""
    from repro_torch.kernels.flash_prefill import (flash_prefill_prefix,
                                                   flash_prefill_prefix_ref)
    from repro_torch.kernels.flash_prefill.plan import num_splits
    B, KVH, Smax, d = 4, 8, 2048, 128
    starts, lens = [0, 256, 512, 1000], PACK_LENS[C]
    rng = np.random.default_rng(G * 1000 + C)
    q = _randn(rng, (B, C, G * KVH, d), dtype, dev).transpose(1, 2)
    k = _randn(rng, (B, Smax, KVH, d), dtype, dev)
    v = _randn(rng, (B, Smax, KVH, d), dtype, dev)
    for b, (s, n) in enumerate(zip(starts, lens)):   # stale past each end
        k[b, s + n:] = _randn(rng, (Smax - s - n, KVH, d), dtype, dev)
        v[b, s + n:] = _randn(rng, (Smax - s - n, KVH, d), dtype, dev)
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    n0 = flash_prefill_prefix.launches
    out, bodies = _bodies(lambda: flash_prefill_prefix(q, kt, vt, start))
    assert flash_prefill_prefix.launches == n0 + 1
    assert bodies["fma"] == 0 and sum(bodies.values()) >= 1, bodies
    if dtype == torch.bfloat16:
        split = num_splits(B, KVH, G, C, Smax) > 1
        assert bodies["wgmma"] == 1 and bool(bodies["merge"]) == split, \
            bodies
    ref = flash_prefill_prefix_ref(q, kt, vt, start)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


def _pack_backend(model, backend, cuda_graphs):
    from repro_torch.serving.kv_cache import (DenseKVBackend,
                                              KVBackendConfig, PagedKVBackend)
    bcfg = KVBackendConfig(max_slots=6, max_seq_len=64, page_size=16,
                           attn_impl="kernel", graph_buckets=(8, 16),
                           prefill_pack_width=4, cuda_graphs=cuda_graphs,
                           eos_token=-1)
    if backend == "paged":
        return PagedKVBackend(model, bcfg, num_pages=40)
    return DenseKVBackend(model, bcfg)


@pytest.mark.parametrize("backend", ["paged", "dense"])
def test_graphed_pack_equals_eager_pack(dev, backend):
    """Packs of buckets 8 and 16 (members with earlier chunks, fresh ones,
    padding rows) replayed as CUDA graphs give the eager packs' logits and
    K/V bit for bit, and move the launch counters alike (each key's first
    use, a capture on one side, is made before the counted window)."""
    from repro_torch.kernels import counters
    model, params = _graph_model(dev, "dense")
    rng = np.random.default_rng(11)
    prompts = {rid: rng.integers(2, 512, 40).tolist() for rid in range(5)}

    def run(graphs):
        kv = _pack_backend(model, backend, graphs)
        for rid in (1, 2, 3):               # earlier chunks
            kv.prefill_chunk(params, rid, prompts[rid][:16], 0)
        for bucket in (8, 16):              # each pack key's first use
            kv.prefill_pack(params, [(-1, [1], 0)], bucket)
            kv.clear(-1)
        torch.cuda.synchronize()
        before = counters.snapshot()
        outs = [kv.prefill_pack(params, [(0, prompts[0][:5], 0),
                                         (1, prompts[1][16:29], 16),
                                         (2, prompts[2][16:24], 16)], 16),
                kv.prefill_pack(params, [(3, prompts[3][16:20], 16),
                                         (4, prompts[4][:8], 0)], 8),
                kv.prefill_pack(params, [(0, prompts[0][5:13], 5),
                                         (1, prompts[1][29:33], 29),
                                         (2, prompts[2][24:32], 24),
                                         (3, prompts[3][20:28], 20)], 8)]
        torch.cuda.synchronize()
        return outs, counters.delta(before, counters.snapshot()), kv

    (og, cg, kg), (oe, ce, ke) = run(True), run(False)
    for a, b in zip(og, oe):
        assert torch.equal(a, b)
    if backend == "paged":
        live = [p for p in range(kg.pool.k.shape[1])
                if p != kg.scratch_page]
        pairs = [(kg.pool.k[:, live], ke.pool.k[:, live]),
                 (kg.pool.v[:, live], ke.pool.v[:, live])]
    else:
        pairs = [(kg.cache[k], ke.cache[k]) for k in ("k", "v")]
    for a, b in pairs:
        assert torch.equal(a, b)
    assert cg == ce and cg["flash_prefill_prefix"] == 3 * model.cfg.num_layers
    assert kg.graphs.replays["pack"] == 5 and ke.graphs.replays["pack"] == 0


# ------------------------------------------ speculative verify on the card

@pytest.mark.parametrize("C", [2, 4, 8])
@pytest.mark.parametrize("Smax", [2048, 2064])
@pytest.mark.parametrize("G,d", [(4, 128), (2, 128), (3, 64), (6, 128)])
def test_flash_prefill_prefix_verify_shape(dev, C, Smax, G, d):
    """The prefix flash kernel at the verify step's shape on granite: B 8
    lanes of C = spec_k + 1 queries, H 32, KVH 8, d 128, bf16, ragged
    starts up to Smax - C (2064 = 129 pages of 16, the paged verify's
    gathered stripe: its last key tile is partial), q, k and v as the
    transposed views the model passes.  Held against the plain version by
    the derived bf16 bound, through the wgmma body (and its merge when the
    plan splits the keys).  Also at the other configs' groups and head
    dims: internvl2's G 2, granite-moe's G 3 with d 64, dbrx's G 6."""
    from repro_torch.kernels.flash_prefill import (flash_prefill_prefix,
                                                   flash_prefill_prefix_ref,
                                                   plan)
    B, KVH = 8, 8
    H = G * KVH
    rng = np.random.default_rng(C * 10 + Smax + G)
    q = _randn(rng, (B, C, H, d), torch.bfloat16, dev).transpose(1, 2)
    k = _randn(rng, (B, Smax, KVH, d), torch.bfloat16, dev).transpose(1, 2)
    v = _randn(rng, (B, Smax, KVH, d), torch.bfloat16, dev).transpose(1, 2)
    starts = [0, 60, 700, 1500, 2040 - C, Smax - C - 1, Smax - C - 16,
              Smax - C]
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    n0 = flash_prefill_prefix.launches
    out, bodies = _bodies(lambda: flash_prefill_prefix(q, k, v, start))
    assert flash_prefill_prefix.launches == n0 + 1
    split = plan.num_splits(B, KVH, H // KVH, C, Smax) > 1
    assert bodies == {"fma": 0, "wgmma": 1, "merge": int(split),
                      "tf32x3": 0}, bodies
    plain = flash_prefill_prefix_ref(q, k, v, start)
    qf, kf, vf = q.float(), k.float(), v.float()
    truth = flash_prefill_prefix_ref(qf, kf, vf, start)
    absv = flash_prefill_prefix_ref(qf, kf, vf.abs(), start)
    pos = start.long()[:, None] + torch.arange(C, device=dev)[None]
    mask = (torch.arange(Smax, device=dev)[None, None]
            <= pos[:, :, None])[:, None]                  # (B, 1, C, Smax)
    assert torch.isfinite(out.float()).all()
    _check_bf16_attention(out, plain, truth, absv,
                          _sdpa_bf16(q, k, v, mask=mask))


def _verify_model(dev):
    """The smoke granite config in float32 with heads of 64 (the flash
    kernel's f32 3xTF32 body), kernels on."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import Model
    cfg = get_smoke_config("granite-3-8b").scaled(param_dtype="float32",
                                                  head_dim=64)
    model = Model(cfg, kv_dtype="float32", chunk_attn_impl="flash",
                  device=dev)
    return model, model.init(torch.Generator(device=dev).manual_seed(4))


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_verify_step_equals_sequential_decode_on_the_card(dev, backend):
    """One verify step of K1 = 4 positions per lane (the prefix flash
    kernel over the stripe, or over the lane's pages gathered with its
    scratch page appended) against K1 sequential decode steps fed the same
    tokens (dense: plain decode attention; paged: the paged-attention
    kernel), in float32: logits within 1e-4, and the K/V rows the steps
    write within 1e-5.  A paged lane's span crosses into its scratch
    page; a dense lane sits two tokens from Smax (its two last positions
    are dropped, and the sequential steps drop them too)."""
    from repro_torch.kernels.flash_prefill import flash_prefill_prefix
    model, params = _verify_model(dev)
    cfg = model.cfg
    B, K1, page, Smax = 3, 4, 16, 64
    rng = np.random.default_rng(12)
    tokens = torch.from_numpy(rng.integers(2, 512, (B, K1)).astype(
        np.int32)).to(dev)
    L, KVH, hd = cfg.num_layers, cfg.num_kv_heads, cfg.hd
    n0 = flash_prefill_prefix.launches
    if backend == "dense":
        lengths = torch.tensor([5, 40, Smax - 2], dtype=torch.int32,
                               device=dev)
        k0 = _randn(rng, (L, B, Smax, KVH, hd), torch.float32, dev)
        v0 = _randn(rng, (L, B, Smax, KVH, hd), torch.float32, dev)
        caches = [{"k": k0.clone(), "v": v0.clone(),
                   "lengths": lengths.clone()} for _ in "ab"]
        ver = model.decode_verify(params, caches[0], tokens)
        seq = torch.stack([model.decode_step(params, caches[1],
                                             tokens[:, i:i + 1].long())
                           for i in range(K1)], dim=1)
        pairs = [(caches[0][k], caches[1][k]) for k in ("k", "v")]
    else:
        maxp, n_pages = Smax // page, 16
        shared, lane_scratch = 15, [12, 13, 14]
        pts = [[0, 1], [2, 3, 4], [5]]
        lengths = torch.tensor([2 * page - 2, 40, 3], dtype=torch.int32,
                               device=dev)
        kv0 = {k: _randn(rng, (L, n_pages, page, KVH, hd), torch.float32,
                         dev) for k in ("k", "v")}
        tables = np.full((B, maxp + 1), shared, np.int32)
        wp = np.zeros((B, K1), np.int32)
        wo = np.zeros((B, K1), np.int32)
        for b, pt in enumerate(pts):
            tables[b, :len(pt)] = pt
            tables[b, len(pt)] = lane_scratch[b]
            for i in range(K1):
                p = int(lengths[b]) + i
                wp[b, i] = tables[b, p // page]
                wo[b, i] = p % page
        assert wp[0].tolist() == [1, 1, 12, 12]

        def t(a):
            return torch.from_numpy(a).to(dev)
        kv = {k: x.clone() for k, x in kv0.items()}
        ver = model.paged_decode_verify(params, kv, tokens, t(tables),
                                        lengths, t(wp), t(wo))
        kv_seq = {k: x.clone() for k, x in kv0.items()}
        seq = torch.stack([model.paged_decode_step(
            params, kv_seq, tokens[:, i:i + 1].long(), t(tables),
            lengths + i, t(wp[:, i]), t(wo[:, i]), attn_impl="kernel")
            for i in range(K1)], dim=1)
        pairs = [(kv[k], kv_seq[k]) for k in ("k", "v")]
    torch.cuda.synchronize()
    assert flash_prefill_prefix.launches == n0 + cfg.num_layers
    torch.testing.assert_close(ver, seq, atol=1e-4, rtol=0)
    for a, b in pairs:
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("backend", ["paged", "dense"])
def test_graphed_verify_equals_eager_verify(dev, backend):
    """The verify step replayed as a CUDA graph gives the eager verify
    step's samples, emit counts, reasons and K/V bit for bit, over three
    steps of three lanes with n-gram-free drafts (the first step's own
    samples fed back), and moves the launch counters alike."""
    from repro_torch.kernels import counters
    from repro_torch.serving.kv_cache import (DenseKVBackend,
                                              KVBackendConfig, PagedKVBackend)
    model, params = _graph_model(dev, "dense")
    rng = np.random.default_rng(13)
    prompts = {rid: rng.integers(2, 512, n).tolist()
               for rid, n in ((1, 13), (2, 30), (3, 7))}

    def run(graphs):
        bcfg = KVBackendConfig(max_slots=4, max_seq_len=64, page_size=16,
                               attn_impl="kernel", cuda_graphs=graphs,
                               eos_token=-1, spec_k=3)
        kv = (PagedKVBackend(model, bcfg, num_pages=32)
              if backend == "paged" else DenseKVBackend(model, bcfg))
        B, K1 = 4, 4
        z = np.zeros((B,), np.int32)
        tl = np.full((B,), 2 ** 31 - 1, np.int32)
        kv.decode_verify(params, np.zeros((B, K1), np.int32), z,
                         np.zeros((B,), bool), z, z, tl, z)
        toks = np.zeros((B, K1), np.int32)
        active = np.zeros((B,), bool)
        ctx = np.zeros((B,), np.int32)
        rids = np.zeros((B,), np.int32)
        for rid, p in prompts.items():
            logits = kv.prefill_chunk(params, rid, p, 0)
            slot = kv.slot_of(rid)
            toks[slot, 0] = int(logits[0].argmax())
            active[slot], ctx[slot], rids[slot] = True, len(p), rid
        torch.cuda.synchronize()
        before = counters.snapshot()
        outs, gen = [], np.ones((B,), np.int32)
        nd = np.where(active, 3, 0).astype(np.int32)
        for _ in range(3):
            s, n, r = kv.decode_verify(params, toks, nd, active, gen, ctx,
                                       tl, rids)
            outs.append((s, n, r))
            last = s[np.arange(B), np.maximum(n - 1, 0)]
            toks[:, 0] = np.where(active, last, 0)
            toks[:, 1:] = s[:, :3]            # drafts: last step's samples
            gen, ctx = gen + n, ctx + n
        torch.cuda.synchronize()
        return outs, counters.delta(before, counters.snapshot()), kv

    (og, cg, kg), (oe, ce, ke) = run(True), run(False)
    for a, b in zip(og, oe):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    if backend == "paged":
        live = [p for p in range(kg.pool.k.shape[1])
                if p != kg.scratch_page]
        pairs = [(kg.pool.k[:, live], ke.pool.k[:, live]),
                 (kg.pool.v[:, live], ke.pool.v[:, live])]
        assert kg.pool.page_table == ke.pool.page_table
        assert kg.lane_scratch == ke.lane_scratch
    else:
        pairs = [(kg.cache[k], ke.cache[k]) for k in kg.cache]
    for a, b in pairs:
        assert torch.equal(a, b)
    assert cg == ce and cg["flash_prefill_prefix"] == 3 * model.cfg.num_layers
    # the idle step before the prompts was the key's first use: its
    # capture and one replay
    assert kg.graphs.captures == 1 and kg.graphs.replays["verify"] == 4
    assert ke.graphs.captures == 0 and ke.graphs.replays["verify"] == 0


# --------------------------------------------------- the cluster KV tier

def test_kv_quant_at_the_tier_page_shape(dev):
    """One granite page of K as the quantized tier stores it (40 layers x
    16 tokens x 8 KV heads = 5120 rows of 128): float32 in, codes within
    1 of the plain version, scales within 1e-6 relative, zeros within 1;
    dequantized to the pool's bfloat16 bit for bit the plain version; and
    through ``quantize_kv_device`` / ``dequantize_kv_device`` from a bf16
    page of that shape, the blob on the host and the page back on the
    card within the INT8 round trip's 2%."""
    from repro_torch.kernels.kv_quant import (kv_dequantize,
                                              kv_dequantize_ref, kv_quantize,
                                              kv_quantize_ref)
    from repro_torch.serving.kv_cache import (dequantize_kv_device,
                                              quantize_kv_device)
    rng = np.random.default_rng(22)
    x = _randn(rng, (40 * 16 * 8, 128), torch.float32, dev) * 4.0
    q, lam, z = kv_quantize(x)
    qr, lamr, zr = kv_quantize_ref(x)
    torch.cuda.synchronize()
    assert (q.int() - qr.int()).abs().max().item() <= 1
    torch.testing.assert_close(lam, lamr, atol=0, rtol=1e-6)
    assert (z - zr).abs().max().item() <= 1
    out = kv_dequantize(q, lam, z, dtype=torch.bfloat16)
    assert torch.equal(out.view(torch.int16), kv_dequantize_ref(
        q, lam, z, torch.bfloat16).view(torch.int16))
    page = x.reshape(40, 16, 8, 128).to(torch.bfloat16)
    blob = quantize_kv_device(page)
    assert all(t.device.type == "cpu" for t in blob[:3])
    assert blob[0].shape == (5120, 128) and blob[3] == (40, 16, 8, 128)
    back = dequantize_kv_device(blob, torch.bfloat16, dev)
    assert back.device == dev and back.dtype == torch.bfloat16
    rel = ((back.float() - page.float()).abs().max()
           / page.float().abs().max()).item()
    assert rel < 0.02


def _tier_engines(dev, backend, tier):
    from repro_torch.core.engine import EngineConfig, ServingEngine
    from repro_torch.core.predictor import OraclePredictor
    model, params = _graph_model(dev, "dense")
    engs = []
    for warm in (False, True):
        eng = ServingEngine(model, params, EngineConfig(
            max_slots=2, max_seq_len=64, max_new_tokens=8, strategy="alise",
            quantize_offload=False, kv_backend=backend, page_size=16,
            paged_attn_impl="kernel", prefill_chunk=16, prefix_cache=True,
            eos_token=-1, warmup_compile=warm), predictor=OraclePredictor())
        eng.attach_tier(tier)
        engs.append(eng)
    return model, engs


@pytest.mark.parametrize("backend", ["paged", "dense"])
def test_tier_fill_on_a_warmed_engine(dev, backend):
    """A warmed engine imports a peer's prefix: ``tier_fill`` writes the
    existing device storage in place (the pool, or the dense store and
    then the lane's stripe: the captured graphs hold their addresses),
    the imported pages equal the peer's bit for bit, and the requests's
    decode steps, replays of the warmed graph, read them: its greedy
    tokens equal the peer's for the same request from its local hit, with
    no capture or library load."""
    from repro_torch.core.request import Request, reset_request_counter
    from repro_torch.serving.kv_tier import HostKVTier
    from repro_torch.utils.compile_counter import CompileCounter
    tier = HostKVTier(1e9, 16)
    model, (a, b) = _tier_engines(dev, backend, tier)
    rng = np.random.default_rng(23)
    system = rng.integers(2, 512, 32).tolist()
    prompt = system + rng.integers(2, 512, 5).tolist()
    reset_request_counter()
    a.serve([Request(prompt_len=37, arrival_time=0.0, true_out_len=2,
                     prompt_tokens=system + [7, 8, 9])])
    store = b.kv.pool if backend == "paged" else b.kv.prefix
    ptrs = (store.k.data_ptr(), store.v.data_ptr())
    lanes = (None if backend == "paged"
             else (b.kv.cache["k"].data_ptr(), b.kv.cache["v"].data_ptr()))
    replays = b.kv.graphs.replays["decode"]
    counter = CompileCounter()
    with counter.expect_no_compiles(f"tier import [{backend}]"):
        got_b = Request(prompt_len=37, arrival_time=0.0, true_out_len=6,
                        prompt_tokens=list(prompt))
        b.serve([got_b])
    counter.detach()
    assert tier.stats.imports == 1 and tier.pinned_pages() == 0
    assert (store.k.data_ptr(), store.v.data_ptr()) == ptrs
    if lanes is not None:
        assert (b.kv.cache["k"].data_ptr(),
                b.kv.cache["v"].data_ptr()) == lanes
    assert b.kv.graphs.replays["decode"] - replays == len(b.iter_times) > 0
    src = a.kv.pool if backend == "paged" else a.kv.prefix
    pa = [n.page for n in a.kv.prefix.index.match(system, 32,
                                                  touch=False)[0]]
    pb = [n.page for n in b.kv.prefix.index.match(system, 32,
                                                  touch=False)[0]]
    assert len(pa) == len(pb) == 2
    for x, y in ((src.k, store.k), (src.v, store.v)):
        assert torch.equal(x[:, pa], y[:, pb])
    want = Request(prompt_len=37, arrival_time=0.0, true_out_len=6,
                   prompt_tokens=list(prompt))
    a.serve([want])
    assert a.kv.prefix_stats().hit_tokens >= 32
    assert list(got_b.output_tokens) == list(want.output_tokens)


def test_place_params_on_the_card_keeps_the_storages(dev):
    """Placing a replica on the device its weights already live on moves
    nothing: the same tensors, the same storages."""
    from repro_torch.distributed.placement import (available_devices,
                                                   device_label, place_params)
    model, params = _graph_model(dev, "dense")
    for where in (dev, "cuda", "cuda:0"):
        placed = place_params(params, where)
        assert placed["embed"] is params["embed"]
        for a, b in zip(params["layers"], placed["layers"]):
            for sub in a:
                for k in a[sub]:
                    assert b[sub][k] is a[sub][k]
                    assert b[sub][k].data_ptr() == a[sub][k].data_ptr()
    assert device_label(torch.device("cuda")) == "cuda:0"
    assert available_devices("auto")[0] == dev
    assert available_devices("cuda:0") == [dev]


# ------------------------------------------- the gateway's concurrent pump

def _gateway_engine(model, params, warm):
    from repro_torch.core.engine import EngineConfig, ServingEngine
    from repro_torch.core.predictor import OraclePredictor
    return ServingEngine(model, params, EngineConfig(
        max_slots=2, max_seq_len=64, max_new_tokens=16, strategy="alise",
        quantize_offload=False, kv_backend="paged", page_size=16,
        paged_attn_impl="kernel", prefill_chunk=16, warmup_compile=warm),
        predictor=OraclePredictor())


def _gateway_trace(cfg):
    """12 Poisson arrivals (alpaca, 40/s), prompts of at most 30 tokens,
    outputs of 3 or 16."""
    from repro_torch.core.request import SLOClass, reset_request_counter
    from repro_torch.core.trace import (TraceConfig, clamp_requests,
                                        generate_trace)
    reset_request_counter()
    trace = generate_trace(TraceConfig(dataset="alpaca", rate=40.0,
                                       duration=1e9, max_requests=12,
                                       seed=0))
    reqs = clamp_requests(trace.requests, vocab=cfg.vocab_size,
                          max_prompt=30, max_new=16)
    for i, r in enumerate(reqs):
        r.slo_class = SLOClass.INTERACTIVE if i % 4 == 0 else SLOClass.BATCH
        r.true_out_len = 3 if i % 4 == 0 else 16
    return reqs


def _serve_concurrent(engines, reqs):
    """A wall-clock replay under the concurrent pump; returns the streams
    and the counters' movement over it."""
    import asyncio

    from repro_torch.kernels import counters
    from repro_torch.serving.gateway import Gateway, GatewayConfig
    gw = Gateway(engines, GatewayConfig(virtual_dt=None, max_wall_s=300.0,
                                        concurrent_pump=True))
    torch.cuda.synchronize()
    before = counters.snapshot()
    streams = asyncio.run(gw.replay(reqs))
    torch.cuda.synchronize()
    assert all(s.events_log[-1].kind == "finish" for s in streams)
    assert all(s.token_values == list(s.request.output_tokens)
               for s in streams)
    assert not gw._pump_tasks and not gw._executors
    return streams, counters.delta(before, counters.snapshot())


def _batch_serve(eng, reqs):
    from repro_torch.core.request import Request
    copies = [Request(prompt_len=r.prompt_len, arrival_time=0.0,
                      true_out_len=r.true_out_len,
                      prompt_tokens=list(r.prompt_tokens)) for r in reqs]
    eng.serve(copies)
    return [list(r.output_tokens) for r in copies]


def test_gateway_concurrent_pump_streams_the_batch_tokens(dev):
    """Two warmed smoke-size replicas on the card under the concurrent
    pump (one step thread each) stream the batch serve's tokens bit for
    bit, capture and load nothing while serving, and every launch the
    serve counted is one of their graphs' replays."""
    from repro_torch.utils.compile_counter import CompileCounter
    model, params = _graph_model(dev, "dense")
    a, b = (_gateway_engine(model, params, True) for _ in range(2))
    before = {e: e.kv.graphs.replayed() for e in (a, b)}
    reqs = _gateway_trace(model.cfg)
    counter = CompileCounter()
    with counter.expect_no_compiles("gateway serve"):
        streams, moved = _serve_concurrent([a, b], reqs)
    counter.detach()
    assert all(e.sched.finished for e in (a, b))
    want = {}
    for e in (a, b):
        for key, (n, per) in e.kv.graphs.replayed().items():
            for c, k in per.items():
                want[c] = want.get(c, 0) + (n - before[e][key][0]) * k
    assert moved == {c: n for c, n in want.items() if n}
    assert moved["paged_attention"] > 0 and moved["fused_rmsnorm"] > 0
    assert [s.token_values for s in streams] == _batch_serve(a, reqs)


def test_gateway_unwarmed_replica_captures_beside_a_warmed_one(dev):
    """An unwarmed replica captures its step graphs at first use in its
    pump thread while a warmed replica serves in the other: the captures
    succeed, the served tokens equal the batch serve's, each key's
    per-replay launches equal the warmed replica's for the same key, and
    the counters moved by exactly the replays plus the two eager runs
    before each capture."""
    model, params = _graph_model(dev, "dense")
    warm = _gateway_engine(model, params, True)
    cold = _gateway_engine(model, params, False)
    assert len(cold.kv.graphs) == 0
    before = warm.kv.graphs.replayed()
    reqs = _gateway_trace(model.cfg)
    streams, moved = _serve_concurrent([warm, cold], reqs)
    assert cold.kv.graphs.captures > 0 and cold.sched.finished
    got = cold.kv.graphs.replayed()
    ref = warm.kv.graphs.replayed()
    for key, (_, per) in got.items():
        if key in ref:
            assert per == ref[key][1], key
    want = {}
    for key, (n, per) in ref.items():
        for c, k in per.items():
            want[c] = want.get(c, 0) + (n - before[key][0]) * k
    for key, (n, per) in got.items():
        for c, k in per.items():
            want[c] = want.get(c, 0) + (n + 2) * k
    assert moved == {c: n for c, n in want.items() if n}
    assert [s.token_values for s in streams] == _batch_serve(warm, reqs)


def test_no_collection_inside_a_capture(dev):
    """The cyclic collector is off while a step is captured (it would
    destroy an unreachable engine's graphs mid-capture, which invalidates
    the capture) and on again after it, around the two eager runs."""
    import gc

    from repro_torch.serving.step_graphs import StepGraphs
    graphs = StepGraphs(dev)
    seen = []

    def step(x):
        seen.append(gc.isenabled())
        return x * 2

    staged = np.arange(4, dtype=np.int32)
    out = graphs.run(("decode",), staged, step,
                     lambda: np.zeros(4, np.int32))
    torch.cuda.synchronize()
    assert seen == [True, True, False]
    assert gc.isenabled() and graphs.captures == 1
    assert out.cpu().tolist() == [0, 2, 4, 6]


def test_sharded_prefill_two_ranks_share_the_card(dev, tmp_path):
    """Two ranks over a gloo group on the one card (NCCL refuses two ranks
    on one device; every collective is staged through a host copy), on a
    (data 1, model 2) mesh: smoke granite's (head dim 64) sharded
    ``prefill`` and three ``decode_step`` calls in float32 against one
    rank's on the whole weights (the flash kernel at half the heads on
    each rank)."""
    from test_torch_distributed import CHUNK, launch_ranks

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import Model
    from repro_torch.utils import tree_map
    over = {"head_dim": 64}             # a head dim the flash kernel takes
    cfg = get_smoke_config("granite-3-8b").scaled(param_dtype="float32",
                                                  **over)
    one = Model(cfg, attn_chunk=CHUNK, kv_dtype="float32", device=dev)
    whole = one.init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
    decode = [rng.integers(0, cfg.vocab_size, (4, 1)).astype(np.int32)
              for _ in range(3)]
    task = {"kind": "serve", "arch": "granite-3-8b", "overrides": over,
            "layout": "port", "tokens": tokens, "decode": decode,
            "params": tree_map(lambda t: t.cpu().numpy(), whole)}
    outs = launch_ranks({"mesh": (1, 2), "device": "cuda",
                         "tasks": {"g": task}}, tmp_path, world=2)
    logits, cache = one.prefill(whole, {"tokens": torch.from_numpy(
        tokens).to(dev)})
    full = one.init_cache(4, 64 + 3)
    for k in ("k", "v"):
        full[k][:, :, :64] = cache[k]
    full["lengths"][:] = 64
    want = [logits.cpu().numpy()] + [
        one.decode_step(whole, full, torch.from_numpy(s).to(dev)
                        ).cpu().numpy() for s in decode]
    for o in outs:
        got = [o["g"]["prefill"]] + o["g"]["decode"]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
