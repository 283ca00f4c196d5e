"""A configuration file's sizes, as the benchmark's own code reads them.

The file holds the published ``config.json`` keys as they are run (those
changed are listed in ``reduced`` in ``BENCHMARK.json``); this reads the
ones the weights, the reference and the roofline arithmetic need,
Granite's four scalar multipliers among them.  It
imports nothing of the program."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Arch:
    name: str
    family: str
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    experts: int
    top_k: int
    rope_theta: float
    rms_eps: float
    dtype: str             # the type the weights are served in
    # Granite's published scalars (Hugging Face ``GraniteConfig``): the
    # embedding's output is multiplied by ``emb_mult``, attention scores
    # by ``attn_mult`` (in place of 1/sqrt(head dim)), each block's
    # output by ``res_mult`` before the residual add, and the logits
    # divided by ``logits_scale``
    emb_mult: float = 1.0
    attn_mult: float = 0.0           # 0: 1/sqrt(head dim)
    res_mult: float = 1.0
    logits_scale: float = 1.0

    @property
    def attn_scale(self) -> float:
        return self.attn_mult or self.head_dim ** -0.5

    @property
    def torch_dtype(self):
        import torch
        return getattr(torch, self.dtype)

    def active_params(self) -> int:
        """Parameters one token's forward multiplies by: the tied
        embedding once (as the head), each layer's attention and its FFN
        (an MoE's router and ``top_k`` of its experts)."""
        D, F = self.d_model, self.d_ff
        attn = D * self.heads * self.head_dim * 2 \
            + D * self.kv_heads * self.head_dim * 2
        ffn = 3 * D * F * (self.top_k if self.experts else 1)
        router = D * self.experts
        return self.vocab * D + self.layers * (attn + ffn + router)


def from_config(conf: dict) -> Arch:
    """The sizes of a configuration file (Hugging Face key names)."""
    if conf.get("hidden_act", "silu") != "silu":
        raise ValueError(f"{conf['name']}: only the SwiGLU FFN is modelled")
    if not conf.get("tie_word_embeddings", False):
        raise ValueError(f"{conf['name']}: only tied embeddings are modelled")
    heads = conf["num_attention_heads"]
    D = conf["hidden_size"]
    experts = conf.get("num_local_experts", 0)
    return Arch(
        name=conf["name"], family="moe" if experts else "dense",
        layers=conf["num_hidden_layers"], d_model=D, heads=heads,
        kv_heads=conf["num_key_value_heads"],
        head_dim=conf.get("head_dim") or D // heads,
        d_ff=conf["intermediate_size"], vocab=conf["vocab_size"],
        experts=experts, top_k=conf.get("num_experts_per_tok", 0),
        rope_theta=float(conf["rope_theta"]),
        rms_eps=float(conf["rms_norm_eps"]),
        dtype=conf["torch_dtype"],
        emb_mult=float(conf.get("embedding_multiplier", 1.0)),
        attn_mult=float(conf.get("attention_multiplier", 0.0)),
        res_mult=float(conf.get("residual_multiplier", 1.0)),
        logits_scale=float(conf.get("logits_scaling", 1.0)))
