"""The paper's own evaluation models (OPT / LLaMA / Pythia families).

Used by the ALISE serving simulator + benchmarks (Figs. 2/6/8/9, Tables 2/3)
and by the real-engine examples at reduced scale.  Public configs:
OPT [arXiv:2205.01068], LLaMA [arXiv:2302.13971], Pythia [arXiv:2304.01373].
"""
from repro_torch.models.config import ArchConfig

CONFIGS = {
    # ALISE Table 1
    "opt-2.7b": ArchConfig("opt-2.7b", "dense", 32, 2560, 32, 32, 10240, 50272,
                           norm_type="layernorm", act="relu", qkv_bias=True,
                           tie_embeddings=True),
    "opt-6.7b": ArchConfig("opt-6.7b", "dense", 32, 4096, 32, 32, 16384, 50272,
                           norm_type="layernorm", act="relu", qkv_bias=True,
                           tie_embeddings=True),
    "opt-13b": ArchConfig("opt-13b", "dense", 40, 5120, 40, 40, 20480, 50272,
                          norm_type="layernorm", act="relu", qkv_bias=True,
                          tie_embeddings=True),
    # ALISE Table 3
    "llama-7b": ArchConfig("llama-7b", "dense", 32, 4096, 32, 32, 11008, 32000,
                           norm_type="rmsnorm", act="swiglu"),
    "llama-13b": ArchConfig("llama-13b", "dense", 40, 5120, 40, 40, 13824, 32000,
                            norm_type="rmsnorm", act="swiglu"),
    "pythia-12b": ArchConfig("pythia-12b", "dense", 36, 5120, 40, 40, 20480, 50688,
                             norm_type="layernorm", act="gelu", qkv_bias=True),
}
