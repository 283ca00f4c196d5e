"""Roofline cost model + table builder, a copy of ``repro.launch.roofline``
with the H100's constants in place of the TPU's.

WHY ANALYTIC: ``compiled.cost_analysis()`` on the CPU backend counts each
while-loop body ONCE regardless of trip count (verified empirically — see
EXPERIMENTS.md §Dry-run "cost-analysis calibration"), so scanned-layer models
are undercounted by ~num_layers and chunked attention by the chunk-loop trips.
We therefore compute FLOPs/bytes analytically from exact formulas for *our*
implementation (validated against a per-layer HLO delta probe), and keep the
HLO-derived, trip-scaled collective bytes plus memory_analysis from the real
compile.

Conventions (documented in EXPERIMENTS.md §Roofline):
  * train backward = 2x forward matmul FLOPs; full remat adds 1x forward.
  * chunked jnp attention computes all S^2 blocks (causal via mask) — counted
    in full; the Pallas flash kernel (skips upper-triangle) would halve it.
  * attention K/V are re-read once per query block (flash streaming).
  * optimizer traffic: fp32 p/m/v read+write (24 B/param) + bf16 grad.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

from repro_torch.models.config import ArchConfig, SHAPES, ShapeSpec

# NVIDIA H100 SXM (80GB HBM3), per card, from its data sheet: the port's
# device.  The reference's constants are a TPU v5e's; the formulas are
# unchanged.  COLL_BW is NVLink's rate per direction (the collective term
# divides each rank's collective bytes by it).
DEVICE = "NVIDIA H100 80GB HBM3 (SXM)"
PEAK_FLOPS = 989e12      # bf16 dense tensor-core FLOP/s / card
HBM_BW = 3.35e12         # B/s / card
COLL_BW = 450e9          # NVLink B/s / direction
ICI_BW = COLL_BW         # the reference's name for the collective rate

BF16 = 2
FP32 = 4


@dataclass
class CellCost:
    flops: float          # global FLOPs for one step
    hbm_bytes: float      # global HBM traffic for one step


def _attn_layer_flops(B, S, H, hd, ctx=None):
    """QK^T + PV for one layer, forward."""
    ctx = ctx if ctx is not None else S
    return 4.0 * B * S * ctx * H * hd


def _ssd_layer_flops(cfg: ArchConfig, B, S, chunk):
    Q = min(chunk, S)
    N, H, P = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    intra = 2.0 * B * S * Q * N + 2.0 * B * S * Q * H * P
    states = 4.0 * B * S * H * P * N            # states + y_off
    conv = 2.0 * B * S * cfg.conv_width * (cfg.d_inner + 2 * N)
    return intra + states + conv


def _linear_flops(cfg: ArchConfig, tokens):
    """All projection/FFN/MoE(active) matmuls + logits head, forward."""
    n_matmul = cfg.active_param_count() - cfg.vocab_size * cfg.d_model  # embed gather
    if not cfg.tie_embeddings:
        n_matmul -= cfg.vocab_size * cfg.d_model      # lm_head counted below
    logits = 2.0 * tokens * cfg.d_model * cfg.vocab_size
    return 2.0 * tokens * n_matmul + logits


def cell_cost(cfg: ArchConfig, shape: ShapeSpec, *, attn_chunk=1024,
              ssd_chunk=256, kv_bytes=BF16, ssm_state_bytes=FP32) -> CellCost:
    B, S = shape.global_batch, shape.seq_len
    n_attn = len(cfg.attn_layer_ids)
    n_ssm = len(cfg.ssm_layer_ids)
    D, H, KVH, hd, V = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.hd, cfg.vocab_size)
    N_act, N_tot = cfg.active_param_count(), cfg.param_count()

    if shape.kind == "decode":
        tokens = B
        f = _linear_flops(cfg, tokens)
        f += n_attn * _attn_layer_flops(B, 1, H, hd, ctx=S)
        if cfg.has_ssm:
            f += n_ssm * 2.0 * B * cfg.ssm_heads * cfg.ssm_headdim \
                * cfg.ssm_state * 2
        if cfg.is_encoder_decoder:
            f += cfg.num_layers * _attn_layer_flops(B, 1, H, hd,
                                                    ctx=cfg.cross_kv_len)
        by = N_act * BF16                                   # weights
        by += n_attn * 2 * B * S * KVH * hd * kv_bytes      # KV stream read
        by += n_attn * 2 * B * KVH * hd * kv_bytes          # token write
        if cfg.has_ssm:
            by += n_ssm * 2 * B * cfg.ssm_heads * cfg.ssm_headdim \
                * cfg.ssm_state * ssm_state_bytes           # state r+w
        by += B * V * FP32                                  # logits
        return CellCost(f, by)

    tokens = B * S
    fwd = _linear_flops(cfg, tokens)
    fwd += n_attn * _attn_layer_flops(B, S, H, hd)
    if cfg.has_ssm:
        fwd += n_ssm * _ssd_layer_flops(cfg, B, S, ssd_chunk)
    if cfg.is_encoder_decoder:
        enc_tokens = tokens
        fwd += cfg.num_encoder_layers * (
            2.0 * enc_tokens * (2 * D * H * hd + 2 * D * KVH * hd
                                + (3 if cfg.act == "swiglu" else 2) * D * cfg.d_ff)
            + _attn_layer_flops(B, S, H, hd))
        fwd += cfg.num_layers * _attn_layer_flops(B, S, H, hd)   # cross attn

    nq = max(S // attn_chunk, 1)
    kv_reread = n_attn * nq * 2 * B * S * KVH * hd * BF16   # flash streaming
    acts_layer = cfg.num_layers * B * S * D * BF16

    if shape.kind == "prefill":
        f = fwd
        by = N_act * BF16 + kv_reread + 2 * acts_layer
        by += n_attn * 2 * B * S * KVH * hd * kv_bytes      # cache write
        by += B * V * FP32
        return CellCost(f, by)

    # train: fwd + bwd(2x) + remat fwd(1x)
    f = 4.0 * fwd
    by = 3 * N_act * BF16                   # fwd/remat/bwd weight reads
    by += N_tot * (6 * FP32)                # adam p/m/v read+write fp32
    by += N_tot * BF16                      # grads
    by += 3 * kv_reread + 6 * acts_layer    # fwd+remat+bwd activations
    by += tokens * V * FP32 * 2             # logits + dlogits
    return CellCost(f, by)


def roofline_terms(cfg: ArchConfig, shape: ShapeSpec, chips: int,
                   coll_bytes_per_device: float, *, kv_bytes=BF16,
                   attn_chunk=1024, flops_scale: float = 1.0,
                   ssm_state_bytes=FP32) -> Dict:
    c = cell_cost(cfg, shape, kv_bytes=kv_bytes, attn_chunk=attn_chunk,
                  ssm_state_bytes=ssm_state_bytes)
    t_compute = (c.flops * flops_scale) / (chips * PEAK_FLOPS)
    t_memory = c.hbm_bytes / (chips * HBM_BW)
    t_coll = coll_bytes_per_device / ICI_BW
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    if shape.kind == "train":
        model_flops = 6.0 * cfg.active_param_count() * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        model_flops = 2.0 * cfg.active_param_count() * shape.global_batch * shape.seq_len
    else:
        model_flops = 2.0 * cfg.active_param_count() * shape.global_batch
    bound = max(t_compute, t_memory, t_coll)
    return {
        "compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll,
        "dominant": dominant, "bound_s": bound,
        "model_flops": model_flops,
        "hlo_flops": c.flops * flops_scale,
        "useful_flops_ratio": model_flops / (c.flops * flops_scale),
        "hbm_bytes": c.hbm_bytes,
        # roofline fraction: useful-FLOPs time at peak / bound time
        "roofline_fraction": (model_flops / (chips * PEAK_FLOPS)) / bound,
    }


def rebuild_table(dryrun_path: Path, out_path: Path) -> list:
    """Post-process dry-run records: attach analytic roofline terms."""
    from repro_torch.configs import get_config
    rows = []
    seen = {}
    for line in Path(dryrun_path).read_text().splitlines():
        try:
            r = json.loads(line)
        except json.JSONDecodeError:
            continue
        key = (r.get("arch"), r.get("shape"), r.get("mesh"),
               json.dumps(r.get("opt") or {}, sort_keys=True))
        seen[key] = r
    for r in seen.values():
        if r.get("skipped") or "error" in r:
            rows.append(r)
            continue
        cfg = get_config(r["arch"])
        shape = SHAPES[r["shape"]]
        opt = r.get("opt") or {}
        kv_map = {"int8": 1, "int4": 0.5}
        kvb = kv_map.get(opt.get("kv_dtype"), BF16)
        ssb = {"bfloat16": 2, "float16": 2}.get(
            opt.get("ssm_state_dtype"), FP32)
        coll = r.get("collectives")      # None: the port did not run it
        r["roofline_analytic"] = roofline_terms(
            cfg, shape, r["chips"],
            coll["per_device_bytes"] if coll else 0.0, kv_bytes=kvb,
            attn_chunk=opt.get("attn_chunk", 1024), ssm_state_bytes=ssb)
        rows.append(r)
    with Path(out_path).open("w") as fh:
        for r in rows:
            fh.write(json.dumps(r) + "\n")
    return rows


if __name__ == "__main__":
    import sys
    src = sys.argv[1] if len(sys.argv) > 1 else "runs/dryrun.jsonl"
    dst = sys.argv[2] if len(sys.argv) > 2 else "runs/roofline.jsonl"
    rows = rebuild_table(Path(src), Path(dst))
    ok = [r for r in rows if "roofline_analytic" in r]
    print(f"{len(ok)} cells -> {dst}")
