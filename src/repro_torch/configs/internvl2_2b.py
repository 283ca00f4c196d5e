"""internvl2-2b — InternViT frontend (stubbed) + InternLM2 LM backbone.

[arXiv:2404.16821; hf]  24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
The vision frontend is a STUB per the assignment: ``input_specs()`` feeds
precomputed patch embeddings of width d_model.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    input_mode="embeds",
    norm_type="rmsnorm",
    act="swiglu",
    rope_theta=1_000_000.0,
)


def smoke_config() -> ArchConfig:
    return CONFIG.scaled(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                         d_ff=128, vocab_size=512)
