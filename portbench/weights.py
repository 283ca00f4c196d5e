"""Weights from the seed, made on the device by the benchmark: the program
under test gets them in its parameter layout, and the plain reference
draws them again, layer by layer, from the same seed.

One ``torch.Generator`` on the device, seeded with the run's seed, draws
the embedding in one call and then each layer's random leaves in one call,
in a fixed order; each leaf is its slice of the draw times its scale,
cast to the type it is served in (the router stays float32).

The draw is the program's layout, which folds Granite's four published
multipliers into the weights, since the port's model has no key for
them (``fold``): the query projection carries ``attention_multiplier``
over the port's 1/sqrt(head dim), each block's output projection
(attention and FFN, every expert's) ``residual_multiplier``, and the
final norm's scale 1 / (``embedding_multiplier`` x ``logits_scaling``),
so that the tied head's logits come out as the published model divides
them; the embedding table is the published one times
``embedding_multiplier``.  The model the program runs is then the
published one over the unfolded weights, which the reference works out
by dividing each folded leaf by its factor (``unfold``) and to which it
applies the multipliers where the published model does.  Scales of the
unfolded weights: normal x 1/sqrt(fan-in), the router x 0.02, norm scales
ones; the served embedding table is normal x 0.02 (a table larger than
that makes the tied head pick the current token again, a degenerate
random model).  The same calls on the same device give the same numbers,
so the reference's redraw equals what the program was handed, and the
reference never reads the program's copy."""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch

from portbench.arch import Arch


def fold(a: Arch) -> Dict[str, float]:
    """The factor each folded leaf carries in the program's layout, by
    ``group.name`` (``embed``, ``final_norm``)."""
    return {"attn.wq": a.attn_scale * a.head_dim ** 0.5,
            "attn.wo": a.res_mult, "ffn.wo": a.res_mult,
            "embed": a.emb_mult,
            "final_norm": 1.0 / (a.emb_mult * a.logits_scale)}


def unfold(a: Arch, key: str, w: torch.Tensor) -> torch.Tensor:
    """A leaf of the draw in float32 with its fold taken out: the
    published model's weight."""
    return w.float() / fold(a).get(key, 1.0)


def layer_leaves(a: Arch) -> List[Tuple[str, str, tuple, float]]:
    """(group, name, shape, scale) of one layer's random leaves, in draw
    order, each scale with its fold."""
    D, H, KVH, hd, F = a.d_model, a.heads, a.kv_heads, a.head_dim, a.d_ff
    out = [("attn", "wq", (D, H * hd), D ** -0.5),
           ("attn", "wk", (D, KVH * hd), D ** -0.5),
           ("attn", "wv", (D, KVH * hd), D ** -0.5),
           ("attn", "wo", (H * hd, D), (H * hd) ** -0.5)]
    if a.experts:
        E = a.experts
        out += [("ffn", "router", (D, E), 0.02),
                ("ffn", "wi", (E, D, F), D ** -0.5),
                ("ffn", "wg", (E, D, F), D ** -0.5),
                ("ffn", "wo", (E, F, D), F ** -0.5)]
    else:
        out += [("ffn", "wi", (D, F), D ** -0.5),
                ("ffn", "wg", (D, F), D ** -0.5),
                ("ffn", "wo", (F, D), F ** -0.5)]
    f = fold(a)
    return [(g, n, shape, scale * f.get(f"{g}.{n}", 1.0))
            for g, n, shape, scale in out]


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def draw(a: Arch, seed: int, device) -> Iterator[Tuple[str, object]]:
    """Yields ``("embed", (V, D))``, then ``("layer", {ln1, attn, ln2,
    ffn})`` for each layer in order, then ``("final_norm", {scale})``:
    the tensors on ``device``, in the served type (routers float32)."""
    dtype = a.torch_dtype
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    raw = torch.randn((a.vocab, a.d_model), generator=gen,
                      dtype=torch.float32, device=device)
    yield "embed", (raw * 0.02).to(dtype)
    del raw
    leaves = layer_leaves(a)
    total = sum(_numel(s) for _, _, s, _ in leaves)
    ones = torch.ones((a.d_model,), dtype=dtype, device=device)
    final = torch.full((a.d_model,), fold(a)["final_norm"], dtype=dtype,
                       device=device)
    for _ in range(a.layers):
        raw = torch.randn((total,), generator=gen, dtype=torch.float32,
                          device=device)
        layer: Dict[str, dict] = {"ln1": {"scale": ones.clone()},
                                  "attn": {}, "ln2": {"scale": ones.clone()},
                                  "ffn": {}}
        at = 0
        for group, name, shape, scale in leaves:
            n = _numel(shape)
            leaf = raw[at:at + n].view(shape) * scale
            layer[group][name] = (leaf if name == "router"
                                  else leaf.to(dtype))
            at += n
        del raw
        yield "layer", layer
    yield "final_norm", {"scale": final}


def program_params(a: Arch, seed: int, device) -> dict:
    """The parameters in the port's layout (``embed``, ``final_norm``,
    ``layers``; tied embeddings, so no ``lm_head``)."""
    params: dict = {"layers": []}
    for kind, val in draw(a, seed, device):
        if kind == "layer":
            params["layers"].append(val)
        else:
            params[kind] = val
    return params
