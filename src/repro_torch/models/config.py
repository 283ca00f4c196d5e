"""Architecture + shape configuration for the repro framework.

Every assigned architecture is expressed as an :class:`ArchConfig`; the four
assigned input shapes are :class:`ShapeSpec` entries in :data:`SHAPES`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ArchConfig:
    """Static description of one architecture (full-size, from public configs)."""

    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None    # default: d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    moe_every: int = 1                # MoE FFN on layers where i % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25

    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0                # N (d_state); 0 => no ssm layers
    ssm_headdim: int = 64             # P
    ssm_expand: int = 2
    conv_width: int = 4

    # --- hybrid interleave (Jamba): attention on layers i % attn_every == attn_offset
    attn_every: int = 0               # 0 => all layers are attention (or all-ssm if ssm-only)
    attn_offset: int = 3

    # --- encoder-decoder ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    cross_kv_len: int = 4096          # stubbed encoder-output length for decode cells

    # --- frontend stubs ---
    input_mode: str = "tokens"        # tokens | embeds (vlm/audio backbones take embeds)

    # --- flavor details ---
    norm_type: str = "rmsnorm"        # rmsnorm | layernorm
    act: str = "swiglu"               # swiglu | gelu | relu
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0

    # dtype policy
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # ------------------------------------------------------------------ derived
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0

    @property
    def has_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid archs)."""
        return self.family in ("ssm", "hybrid")

    def layer_kind(self, i: int) -> str:
        """'attn' or 'ssm' mixer for decoder layer i."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            return "attn" if (i % self.attn_every) == self.attn_offset else "ssm"
        return "attn"

    def ffn_kind(self, i: int) -> str:
        """'dense', 'moe' or 'none' FFN for decoder layer i."""
        if self.d_ff == 0:
            return "none"
        if self.has_moe and (i % self.moe_every) == self.moe_offset:
            return "moe"
        return "dense"

    @property
    def attn_layer_ids(self):
        return [i for i in range(self.num_layers) if self.layer_kind(i) == "attn"]

    @property
    def ssm_layer_ids(self):
        return [i for i in range(self.num_layers) if self.layer_kind(i) == "ssm"]

    # ------------------------------------------------------------- param count
    def param_count(self) -> int:
        """Approximate total parameter count (embedding + blocks + head)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        n = V * D                                   # token embedding
        if not self.tie_embeddings:
            n += V * D                              # lm head
        ffn_dense = 3 * D * F if self.act == "swiglu" else 2 * D * F
        for i in range(self.num_layers):
            if self.layer_kind(i) == "attn":
                qkv = D * (self.num_heads * self.hd) + 2 * D * (self.num_kv_heads * self.hd)
                n += qkv + (self.num_heads * self.hd) * D
            else:  # ssm
                di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
                # in_proj: z, x, B, C, dt; out_proj
                n += D * (2 * di + 2 * N + H) + di * D
                n += self.conv_width * (di + 2 * N) + 2 * H  # conv + A,D params
            fk = self.ffn_kind(i)
            if fk == "dense":
                n += ffn_dense
            elif fk == "moe":
                n += D * self.num_experts + self.num_experts * ffn_dense
        if self.is_encoder_decoder:
            enc_ffn = ffn_dense
            per = (D * self.num_heads * self.hd * 2
                   + 2 * D * self.num_kv_heads * self.hd) + enc_ffn
            n += self.num_encoder_layers * per
            # decoder cross attention
            n += self.num_layers * (D * self.num_heads * self.hd * 2
                                    + 2 * D * self.num_kv_heads * self.hd)
        return n

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: only top_k experts count)."""
        if not self.has_moe:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        ffn_dense = 3 * D * F if self.act == "swiglu" else 2 * D * F
        n_moe_layers = sum(1 for i in range(self.num_layers) if self.ffn_kind(i) == "moe")
        inactive = n_moe_layers * (self.num_experts - self.top_k) * ffn_dense
        return self.param_count() - inactive

    def scaled(self, **overrides) -> "ArchConfig":
        """Return a reduced copy (for smoke tests)."""
        return dataclasses.replace(self, **overrides)


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_is_supported(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable dry-run cell, else a skip reason."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("long_500k requires sub-quadratic attention; "
                       f"{cfg.name} is pure full-attention (skip per spec)")
    return True, ""
