"""Plain reference of the attention-family decoder with a dense SwiGLU FFN
(granite-3.0): the model as the configuration file runs it, in float32
with TF32 off, for the benchmark's check of what the program served.

The embedding's rows times ``embedding_multiplier``; per layer: RMSNorm,
grouped-query attention with split-halves RoPE at each token's absolute
position, causal softmax of the scores times ``attention_multiplier``,
the output projection, times ``residual_multiplier`` into the residual;
RMSNorm, SwiGLU FFN (silu(x wg) * (x wi)) wo, times
``residual_multiplier`` into the residual; then the final RMSNorm and
the tied head, the logits divided by ``logits_scaling`` (Granite's
published model).  The weights are the seed's draw with the program
layout's folds taken out (``weights.unfold``).

A request whose K/V went through the program's INT8 swap has its keys and
values rounded as the swap rounds them (``kvq.roundtrip``), from the
position where each swap happened on: queries at or past a swap's length
attend the positions before it as the swap left them.

It runs layer by layer over all sequences at once, drawing each layer's
weights again from the seed (``portbench.weights.draw``), so only one
layer's weights are ever held.  ``precision="fp8"`` is the control, the
step below the bfloat16 the configuration states: every matrix product's
inputs rounded to float8 e4m3 (weights per output column, activations per
row) and the K/V cache too (per token and head), as an fp8 serving path
would hold it.  Imports nothing of the program."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List

import torch

from portbench import weights
from portbench.arch import Arch
from portbench.reference import kvq

FP8_MAX = 448.0          # float8 e4m3's largest finite value
QUERY_BLOCK = 512        # query rows a score block holds


@dataclass
class Seq:
    """One served request as the reference reads it: ``tokens`` = prompt +
    served tokens but the last; the logits of positions ``from_pos`` on
    are returned (each predicts the next served token); ``swaps`` are the
    K/V lengths at the request's INT8 swaps, in the order they happened."""
    tokens: List[int]
    from_pos: int
    swaps: List[int]


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (its absolute maximum at 448), back in float32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Products:
    """The matrix products, in float32 or through the fp8 control."""

    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.fp8 = precision == "fp8"

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A weight (..., in, out) as the products read it."""
        w = w.float()
        return fp8_round(w, -2) if self.fp8 else w

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (fp8_round(x, -1) if self.fp8 else x) @ w

    def cached(self, kv: torch.Tensor) -> torch.Tensor:
        """K or V (S, heads, hd) as the cache holds them."""
        return fp8_round(kv, -1) if self.fp8 else kv


def rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x, theta: float):
    """x (S, heads, hd) at positions 0..S-1, split halves rotated."""
    S, _, hd = x.shape
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                          device=x.device) / hd))
    ang = (torch.arange(S, dtype=torch.float64, device=x.device)[:, None]
           * freqs)[:, None, :]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _causal(q, k, v, q0: int, scale: float):
    """Queries q (n, H, hd) at positions q0.. over keys k, v (T, KVH, hd)
    at 0..T-1, T = q0 + n, the scores times ``scale``."""
    n, H, hd = q.shape
    KVH = k.shape[1]
    qg = q.reshape(n, KVH, H // KVH, hd)
    s = torch.einsum("nkgd,tkd->kgnt", qg, k) * scale
    qpos = q0 + torch.arange(n, device=q.device)
    mask = torch.arange(k.shape[0], device=q.device)[None, :] <= qpos[:, None]
    s = torch.where(mask, s, torch.full_like(s, float("-inf")))
    o = torch.einsum("kgnt,tkd->nkgd", torch.softmax(s, dim=-1), v)
    return o.reshape(n, H * hd)


def attention(q, k, v, swaps: List[int], scale: float = None):
    """Causal attention of one sequence, each query over the keys and
    values as they stood when the program computed it: before a swap of
    length L, queries past L see rows [0, L) rounded by the swap.  The
    scores are times ``scale`` (default 1/sqrt(head dim))."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    S = q.shape[0]
    out = q.new_empty((S, q.shape[1] * q.shape[2]))
    kc, vc = k, v
    a = 0
    for L in list(swaps) + [S]:
        b = min(L, S)
        for s in range(a, b, QUERY_BLOCK):
            e = min(s + QUERY_BLOCK, b)
            out[s:e] = _causal(q[s:e], kc[:e], vc[:e], s, scale)
        a = max(a, b)
        if L < S:
            kc = torch.cat([kvq.roundtrip(kc[:L]), kc[L:]])
            vc = torch.cat([kvq.roundtrip(vc[:L]), vc[L:]])
    return out


def dense_ffn(a: Arch, p: dict, x, mm: Products):
    """SwiGLU over ``p``'s weights as :meth:`Products.weight` gave them."""
    h = mm(x, p["wi"])
    g = mm(x, p["wg"])
    return mm(torch.nn.functional.silu(g) * h, p["wo"])


def run(a: Arch, seed: int, device, seqs: List[Seq], precision: str = "f32",
        ffn: Callable = dense_ffn) -> List[torch.Tensor]:
    """The float32 logits (n_i, V) of each sequence's positions from
    ``from_pos`` on, on ``device``."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _run(a, seed, device, seqs, Products(precision), ffn)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _run(a: Arch, seed, device, seqs, mm: Products, ffn):
    draws = weights.draw(a, seed, device)
    _, embed = next(draws)
    embed = weights.unfold(a, "embed", embed)
    xs = [a.emb_mult * embed[torch.as_tensor(s.tokens, device=device)]
          for s in seqs]
    H, KVH, hd = a.heads, a.kv_heads, a.head_dim
    for _ in range(a.layers):
        _, p = next(draws)
        at = {k: mm.weight(weights.unfold(a, f"attn.{k}", w))
              for k, w in p["attn"].items()}
        fw = {k: (w.float() if k == "router"
                  else mm.weight(weights.unfold(a, f"ffn.{k}", w)))
              for k, w in p["ffn"].items()}
        for i, s in enumerate(seqs):
            x = xs[i]
            S = x.shape[0]
            h = rmsnorm(x, p["ln1"]["scale"], a.rms_eps)
            q = rope(mm(h, at["wq"]).reshape(S, H, hd), a.rope_theta)
            k = mm.cached(rope(mm(h, at["wk"]).reshape(S, KVH, hd),
                               a.rope_theta))
            v = mm.cached(mm(h, at["wv"]).reshape(S, KVH, hd))
            att = attention(q, k, v, s.swaps, a.attn_scale)
            x = x + a.res_mult * mm(att, at["wo"])
            h = rmsnorm(x, p["ln2"]["scale"], a.rms_eps)
            xs[i] = x + a.res_mult * ffn(a, fw, h, mm)
        del p, at, fw
    _, fin = next(draws)
    final = weights.unfold(a, "final_norm", fin["scale"])
    head = mm.weight(embed.T)
    return [mm(rmsnorm(x[s.from_pos:], final, a.rms_eps), head)
            / a.logits_scale for x, s in zip(xs, seqs)]
