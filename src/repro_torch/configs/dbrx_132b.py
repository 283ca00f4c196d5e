"""dbrx-132b — fine-grained MoE decoder, 16 experts top-4.

[hf:databricks/dbrx-base; unverified]
40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    top_k=4,
    norm_type="layernorm",
    act="swiglu",
    rope_theta=500_000.0,
)


def smoke_config() -> ArchConfig:
    return CONFIG.scaled(num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
                         d_ff=128, vocab_size=512, num_experts=4, top_k=2)
