"""granite-moe-3b-a800m — fine-grained MoE, 40 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base family; hf]
32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40e top-8
(config line of record; the hf card's 32e/top-8 variant noted in DESIGN.md).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    num_experts=40,
    top_k=8,
    norm_type="rmsnorm",
    act="swiglu",
    tie_embeddings=True,
)


def smoke_config() -> ArchConfig:
    return CONFIG.scaled(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                         d_ff=64, vocab_size=512, num_experts=4, top_k=2)
