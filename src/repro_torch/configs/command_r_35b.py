"""command-r-35b — dense GQA decoder, no biases.

[hf:CohereForAI/c4ai-command-r-v01; unverified]
40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    norm_type="layernorm",
    act="swiglu",
    qkv_bias=False,
    tie_embeddings=True,
    rope_theta=8_000_000.0,
)


def smoke_config() -> ArchConfig:
    return CONFIG.scaled(num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
                         d_ff=192, vocab_size=512)
