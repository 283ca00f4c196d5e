"""A cell shrunk to a size a CPU test holds: the configuration's smoke
sizes (as the port's ``smoke_config()``), 4 lanes of 96 positions,
chunks of 8, short prompts and outputs, the plain attention paths."""
SMOKE = {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
         "num_key_value_heads": 2, "intermediate_size": 128,
         "vocab_size": 512}


def overrides(moe: bool = False, dtype: str = "float32", rate: float = 3.0,
              **kw) -> dict:
    conf = dict(SMOKE, torch_dtype=dtype)
    if moe:
        conf.update(num_local_experts=4, num_experts_per_tok=2,
                    port={"capacity_factor": 2.0})
    o = {"config": conf, "lanes": 4, "rate": rate,
         "model": {"chunk_attn_impl": "masked"},
         "engine": {"paged_attn_impl": "gather", "max_seq_len": 96,
                    "hbm_bytes": None,
                    "prefill_chunk": 8, "iter_token_budget": 12},
         "traffic": {"prompt_lognormal": [2.5, 0.5], "prompt_max": 24,
                     "out_median_range": [6.0, 30.0], "context_cap": 94,
                     "history_requests": 64}}
    o.update(kw)
    return o
