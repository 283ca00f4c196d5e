"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf]
72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Layer i is attention iff i % 8 == 3 (1 attention : 7 mamba, Jamba block
layout); the FFN is MoE on every other layer (odd i).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    num_experts=16,
    top_k=2,
    moe_every=2,
    moe_offset=1,
    attn_every=8,
    attn_offset=3,
    ssm_state=128,
    ssm_headdim=128,
    ssm_expand=2,
    conv_width=4,
    norm_type="rmsnorm",
    act="swiglu",
)


def smoke_config() -> ArchConfig:
    return CONFIG.scaled(num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
                         d_ff=128, vocab_size=512, num_experts=4, top_k=2,
                         ssm_state=16, ssm_headdim=16)
