"""stablelm-3b — dense decoder (wide GQA: kv == heads).

[hf:stabilityai/stablelm-2-1_6b family; unverified]
32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    norm_type="layernorm",
    act="swiglu",
)


def smoke_config() -> ArchConfig:
    return CONFIG.scaled(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                         d_ff=128, vocab_size=512)
