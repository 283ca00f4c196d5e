"""granite-3-8b — dense GQA decoder.

[hf:ibm-granite/granite-3.0-2b-base family; hf]
40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    norm_type="rmsnorm",
    act="swiglu",
    tie_embeddings=True,
)


def smoke_config() -> ArchConfig:
    return CONFIG.scaled(num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
                         d_ff=128, vocab_size=512)
