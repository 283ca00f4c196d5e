"""INT8 KV quantize / dequantize and decode attention over INT8 pages: the
CUDA kernels' wrappers.

``kv_quantize`` / ``kv_quantize_store`` / ``kv_dequantize`` launch
``csrc/kv_quant.cu`` and ``paged_attention_q8`` launches the int8 entry of
``csrc/paged_attention.cu`` (the split-KV body of ``paged_attention``, its
plan and its scratch) for CUDA tensors; each takes its plain version
(:mod:`.ref`) for CPU tensors; there is no fallback from one to the other.
Each wrapper's ``launches`` attribute counts its kernel launches;
:func:`body_launches` counts the bodies of ``kv_dequantize`` and of the
quantize kernel (the kernel chooses from d, the dtype and the addresses:
:func:`quantize_body`, csrc/kv_quant.cu).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ops import check_shape, split
from repro_torch.kernels.kv_quant.ref import (kv_dequantize_ref,
                                              kv_quantize_ref,
                                              kv_quantize_store_ref,
                                              paged_attention_q8_ref,
                                              store_view)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib():
    lib = _build.load("kv_quant")
    lib.kv_quantize_launch.argtypes = [_P] * 4 + [_L, _I, _P]
    lib.kv_quantize_launch.restype = _I
    lib.kv_quantize_rows_launch.argtypes = ([_P] * 9 + [_L] * 4 + [_I]
                                            + [_L] * 5 + [_I, _P])
    lib.kv_quantize_rows_launch.restype = _I
    lib.kv_dequantize_launch.argtypes = [_P] * 4 + [_L, _I, _I, _P]
    lib.kv_dequantize_launch.restype = _I
    lib.kv_quant_body_launches.argtypes = [_P]
    lib.kv_quant_body_launches.restype = _I
    return lib


DEQUANTIZE_BODIES = ("vec16", "scalar")
QUANTIZE_BODIES = ("vec16", "scalar")
# launches of each dequantize body by replayed CUDA graphs
# (kernels/counters.py); quantize runs in no graph (swaps are eager)
REPLAYED = dict.fromkeys(DEQUANTIZE_BODIES, 0)


def body_launches(kernel: str = "dequantize"):
    """Launches of a kernel's bodies since the library was loaded:
    ``{"vec16": n, "scalar": n}``.  ``kv_dequantize``'s (the default):
    16 codes a thread with 16-byte loads and stores, for d a multiple of 16
    up to 1024 and 16-byte aligned codes and output; one element a thread
    otherwise; a replayed CUDA graph's launches are in it too
    (``REPLAYED``, which ``kernels/counters.py`` advances).
    ``kernel="quantize"``: the quantize kernel's, both entries
    (:func:`quantize_body` names the choice)."""
    if kernel not in ("dequantize", "quantize"):
        raise ValueError(f"kernel {kernel!r}: dequantize or quantize")
    got = (ctypes.c_longlong * 4)()
    with _build.COUNT_LOCK:
        _lib().kv_quant_body_launches(ctypes.addressof(got))
        if kernel == "quantize":
            return dict(zip(QUANTIZE_BODIES, got[2:]))
        return {k: n + REPLAYED[k] for k, n in zip(DEQUANTIZE_BODIES, got)}


def quantize_body(d: int, dtype, aligned: bool = True) -> str:
    """The body the quantize kernel takes for rows of width ``d`` in
    ``dtype``: ``"vec16"`` when d is a multiple of the elements a 16-byte
    load holds (4 float32, 8 bfloat16), 2 to 128 such loads a row, and
    the addresses are ``aligned`` (every row start on 16 bytes, the codes
    on a 16-byte load's element count); ``"scalar"`` otherwise."""
    e = 16 // torch.empty((), dtype=dtype).element_size()
    return ("vec16" if aligned and d % e == 0 and 2 <= d // e <= 128
            else "scalar")


def _launch(err_of, what: str, wrapper) -> None:
    """Launch (``err_of`` returns the entry's error code), raise on an
    error, count the launch on ``wrapper``, under the counters' lock."""
    with _build.COUNT_LOCK:
        _build.check(err_of(), what)
        wrapper.launches += 1


def kv_quantize(x):
    """x: (T, d) float32 -> (q int8 (T, d), lam (T, 1), z (T, 1)) float32;
    rows are (token, head) vectors (flatten any leading dims first)."""
    _build.refuse_grad("kv_quantize", x)
    if not x.is_cuda:
        return kv_quantize_ref(x)
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"kv_quantize takes a contiguous float32 (T, d) "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    T, d = x.shape
    q = torch.empty((T, d), dtype=torch.int8, device=x.device)
    lam = torch.empty((T, 1), dtype=torch.float32, device=x.device)
    z = torch.empty((T, 1), dtype=torch.float32, device=x.device)
    fn = _lib().kv_quantize_launch
    _launch(lambda: fn(x.data_ptr(), q.data_ptr(), lam.data_ptr(),
                       z.data_ptr(), T, d,
                       torch.cuda.current_stream(x.device).cuda_stream),
            "kv_quantize", kv_quantize)
    return q, lam, z


def store_layout(rows: int, d: int, n: int):
    """Byte offsets ``(codes, scales, zeros)`` of each of ``n`` sources in
    the store entry's staging buffer, and the buffer's size: source 0's
    int8 codes (rows, d), float32 scales and zeros (rows, 1), then source
    1's, each part starting on 16 bytes."""
    offs, at = [], 0
    for _ in range(n):
        part = []
        for size in (rows * d, 4 * rows, 4 * rows):
            part.append(at)
            at += -(-size // 16) * 16
        offs.append(tuple(part))
    return offs, at


def store_views(buf, rows: int, d: int, n: int):
    """The ``(q, lam, z)`` views of each source in a staging buffer
    ``buf`` (uint8, laid out by :func:`store_layout`) on any device."""
    offs, _ = store_layout(rows, d, n)
    return [(buf[a:a + rows * d].view(torch.int8).view(rows, d),
             buf[b:b + 4 * rows].view(torch.float32).view(rows, 1),
             buf[c:c + 4 * rows].view(torch.float32).view(rows, 1))
            for a, b, c in offs]


def kv_quantize_store(xs, pages=None, length=None):
    """INT8-quantize one or two KV stores (K and V) where they lie, in one
    launch: the swap's device half.

    ``xs``: tensors of one shape, strides, dtype (float32 or bfloat16) and
    device, rank 1 to 5 with the last axis (d) contiguous, read as the
    (L, N, O, H, d) view :func:`~.ref.store_view` gives; rows are taken
    in (l, i, o, h) order for i over ``pages`` (a 1-D int64 tensor of
    indices into N on the same device: a request's pages of a paged pool)
    or over all of N, as ``x[:, pages]`` flattens.  Row (l, i, o, h) holds
    position ``i * O + o``; a row at or past ``length`` is not read and
    quantizes as a zero row (lam 1e-8, z -0.0, codes -128).

    Returns ``(triples, staging)``: a ``(q int8 (R, d), lam (R, 1),
    z (R, 1))`` triple a source, in float32.  On the card they are views
    of ``staging``, one uint8 device buffer laid out by
    :func:`store_layout` (K's codes, scales, zeros, then V's), which one
    copy can move to the host (:func:`store_views` lays a copy out again).
    On the CPU they are the plain version's tensors and ``staging`` is
    None."""
    xs = tuple(xs)
    _build.refuse_grad("kv_quantize_store", *xs)
    if not xs[0].is_cuda:
        return kv_quantize_store_ref(xs, pages, length), None
    x0 = xs[0]
    if not 1 <= len(xs) <= 2 or any(
            x.device != x0.device or x.dtype != x0.dtype
            or x.shape != x0.shape or x.stride() != x0.stride()
            for x in xs):
        raise ValueError("kv_quantize_store takes one or two tensors of one "
                         "shape, strides, dtype and device")
    if not 1 <= x0.dim() <= 5 or x0.stride(-1) != 1:
        raise ValueError(f"kv_quantize_store: a store of rank 1 to 5 with "
                         f"its last axis contiguous, got shape "
                         f"{tuple(x0.shape)} strides {x0.stride()}")
    code = _build.dtype_code(x0.dtype)
    view = store_view(x0)
    L, N, O, H, d = view.shape
    if pages is not None:
        if (pages.device != x0.device or pages.dtype != torch.int64
                or pages.dim() != 1 or not pages.is_contiguous()):
            raise ValueError("kv_quantize_store: pages must be a contiguous "
                             f"1-D int64 tensor on {x0.device}")
    P = N if pages is None else pages.numel()
    rows = L * P * O * H
    _, size = store_layout(rows, d, len(xs))
    staging = torch.empty(size, dtype=torch.uint8, device=x0.device)
    triples = store_views(staging, rows, d, len(xs))
    if rows == 0:
        return triples, staging
    # a size-1 axis is never stepped: its stride is no alignment concern
    sL, sN, sO, sH = (0 if n == 1 else s
                      for n, s in zip(view.shape[:4], view.stride()[:4]))
    out = [t.data_ptr() for trip in triples for t in trip]
    out += [None] * (6 - len(out))
    fn = _lib().kv_quantize_rows_launch
    _launch(lambda: fn(
        x0.data_ptr(), xs[1].data_ptr() if len(xs) == 2 else None, *out,
        None if pages is None else pages.data_ptr(), L, P, O, H, d,
        sL, sN, sO, sH, P * O if length is None else max(int(length), 0),
        code, torch.cuda.current_stream(x0.device).cuda_stream),
        "kv_quantize_store", kv_quantize_store)
    return triples, staging


def kv_dequantize(q, lam, z, dtype=torch.float32):
    """Inverse of :func:`kv_quantize`: ``lam * (q + 128 - z)`` as dtype
    (float32 or bfloat16)."""
    _build.refuse_grad("kv_dequantize", lam, z)
    if not q.is_cuda:
        return kv_dequantize_ref(q, lam, z, dtype)
    if q.dim() != 2 or q.dtype != torch.int8 or not q.is_contiguous():
        raise ValueError(f"kv_dequantize takes contiguous int8 (T, d) codes, "
                         f"got {q.dtype} {tuple(q.shape)}")
    T, d = q.shape
    for name, t in (("lam", lam), ("z", z)):
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != (T, 1) or not t.is_contiguous()):
            raise ValueError(f"kv_dequantize: {name} must be contiguous "
                             f"float32 (T, 1) on {q.device}")
    code = _build.dtype_code(dtype)
    x = torch.empty((T, d), dtype=dtype, device=q.device)
    fn = _lib().kv_dequantize_launch
    with _build.COUNT_LOCK:
        err = fn(
            q.data_ptr(), lam.data_ptr(), z.data_ptr(), x.data_ptr(), T, d,
            code, torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(err, "kv_dequantize")
        kv_dequantize.launches += 1
    return x


def _q8_fn():
    f = _build.load("paged_attention").paged_attention_q8_launch
    f.argtypes = [_P] * 11 + [_I] * 9 + [_P]
    f.restype = _I
    return f


def paged_attention_q8(q, kq, k_lam, k_z, vq, v_lam, v_z, block_tables,
                       lengths):
    """Decode attention over an INT8 page pool, dequantized in the kernel.

    q: (B, H, d) float32 or bfloat16; kq/vq: (num_pages, page, KVH, d)
    int8; k_lam/k_z/v_lam/v_z: (num_pages, page, KVH, 1) float32, one
    (scale, zero) pair per (token, head) row; block_tables: (B, max_pages)
    int32; lengths: (B,) int32 >= 1, valid tokens per row -> (B, H, d) in
    q's dtype.  Table entries past a row's length are never read."""
    _build.refuse_grad("paged_attention_q8", q, k_lam, k_z, v_lam, v_z)
    if not q.is_cuda:
        return paged_attention_q8_ref(q, kq, k_lam, k_z, vq, v_lam, v_z,
                                      block_tables, lengths)
    B, H, d = q.shape
    num_pages, page, KVH, dk = kq.shape
    max_pages = block_tables.shape[1]
    named = (("q", q), ("kq", kq), ("k_lam", k_lam), ("k_z", k_z),
             ("vq", vq), ("v_lam", v_lam), ("v_z", v_z),
             ("block_tables", block_tables), ("lengths", lengths))
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"paged_attention_q8: {name} on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention_q8: {name} must be "
                             "contiguous")
    rows = (num_pages, page, KVH, 1)
    if (vq.shape != kq.shape or dk != d or H % KVH
            or any(tuple(t.shape) != rows for t in (k_lam, k_z, v_lam, v_z))
            or block_tables.shape[0] != B or tuple(lengths.shape) != (B,)):
        raise ValueError(
            f"paged_attention_q8: shapes q {tuple(q.shape)}, codes "
            f"{tuple(kq.shape)}/{tuple(vq.shape)}, scales "
            f"{[tuple(t.shape) for t in (k_lam, k_z, v_lam, v_z)]}, tables "
            f"{tuple(block_tables.shape)}, lengths {tuple(lengths.shape)}")
    check_shape("paged_attention_q8", H // KVH, d, page, 16)
    if kq.dtype != torch.int8 or vq.dtype != torch.int8:
        raise TypeError("paged_attention_q8: codes must be int8")
    if any(t.dtype != torch.float32 for t in (k_lam, k_z, v_lam, v_z)):
        raise TypeError("paged_attention_q8: scales and zeros must be "
                        "float32")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attention_q8: block_tables and lengths must "
                        "be int32")
    if any(t.data_ptr() % 16 for t in (kq, vq)):
        raise ValueError("paged_attention_q8: the codes must start on a "
                         "16-byte boundary")
    out = torch.empty_like(q)
    scratch, nsplit = split(q, B, KVH, d, page, max_pages)
    fn = _q8_fn()
    with _build.COUNT_LOCK:
        err = fn(q.data_ptr(), kq.data_ptr(), k_lam.data_ptr(),
                 k_z.data_ptr(), vq.data_ptr(), v_lam.data_ptr(),
                 v_z.data_ptr(), block_tables.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), nsplit,
                 B, H, KVH, d, page,
                 num_pages, max_pages, _build.dtype_code(q.dtype),
                 torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(err, "paged_attention_q8")
        paged_attention_q8.launches += 1
    return out


kv_quantize.launches = 0
kv_quantize_store.launches = 0
kv_dequantize.launches = 0
paged_attention_q8.launches = 0
