"""qwen1.5-32b — dense decoder with QKV bias.

[hf:Qwen/Qwen1.5-0.5B family; hf]
64L d_model=5120 40H (GQA kv=40) d_ff=27392 vocab=152064, QKV bias.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    norm_type="rmsnorm",
    act="swiglu",
    qkv_bias=True,
)


def smoke_config() -> ArchConfig:
    return CONFIG.scaled(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                         d_ff=128, vocab_size=512)
