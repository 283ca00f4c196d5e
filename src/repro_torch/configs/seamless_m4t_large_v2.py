"""seamless-m4t-large-v2 — encoder-decoder, multimodal (audio frontend stubbed).

[arXiv:2308.11596; hf]  24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206.
Encoder consumes precomputed speech-frame embeddings (frontend STUB per the
assignment); 24 encoder + 24 decoder layers.  For ``decode_*`` cells the
decoder self-KV is seq_len long and the cross-KV is a fixed 4096-frame stub
(documented in DESIGN.md §5).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,
    num_encoder_layers=24,
    is_encoder_decoder=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    input_mode="embeds",
    norm_type="layernorm",
    act="gelu",
    cross_kv_len=4096,
)


def smoke_config() -> ArchConfig:
    return CONFIG.scaled(num_layers=2, num_encoder_layers=2, d_model=64,
                         num_heads=4, num_kv_heads=4, d_ff=128,
                         vocab_size=512, cross_kv_len=32)
