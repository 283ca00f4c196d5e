"""mamba2-2.7b — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified]  64L d_model=2560 (attn-free) d_ff=0
vocab=50280, ssm_state=128.  d_inner = 2*d_model = 5120, headdim 64 -> 80 heads.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=1,           # unused (attn-free)
    num_kv_heads=1,
    d_ff=0,                # mamba block subsumes the FFN
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    conv_width=4,
    norm_type="rmsnorm",
    tie_embeddings=True,
)


def smoke_config() -> ArchConfig:
    return CONFIG.scaled(num_layers=2, d_model=64, vocab_size=512,
                         ssm_state=16, ssm_headdim=16)
