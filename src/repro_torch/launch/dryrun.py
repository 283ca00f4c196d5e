"""Multi-pod dry run of the port: every (architecture x input-shape) cell on
the production meshes, with no device and no process group, recording
per-rank memory, the H100 roofline and per-rank collectives.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh single|multi|both] [--out runs/dryrun.jsonl] [--force]

The reference (``repro.launch.dryrun``) compiles each cell through XLA's
SPMD partitioner and parses the collectives out of the HLO.  The port has
no partitioner: a rank runs its own block of the computation.  So for each
cell it

- sums each rank's bytes of parameters, AdamW state, cache and batch from
  the sanitized specs (:mod:`repro_torch.distributed.sharding`);
- takes FLOPs and HBM bytes from ``roofline.cell_cost``, the reference's
  own analytic route, against the H100's peak rates;
- runs one rank's step (``Model.prefill``, ``Model.decode_step`` or the
  train step) on meta tensors under a *dry* mesh, whose collectives
  (:mod:`repro_torch.distributed.ctx`, the same helpers a real run calls)
  record their kind and operand bytes without communicating: it counts the
  code that runs, as the reference parses the HLO it compiled.  Its model
  rematerialises each layer as the reference's (``Model(remat=True)``),
  so a train cell's backward re-issues each layer's FSDP gathers and
  ``model`` collectives as the reference's lowered step does.

A train cell's ``memory`` also records ``saved_activation_bytes``: the
bytes autograd holds for the backward when that rank's loss is reached
(:class:`repro_torch.training.saved.SavedBytes`, the parameters and the
batch not counted; the attention through the flash kernel's Function, as
on the card).  It is the port's counterpart of the reference's
``temp_bytes``, and smaller: XLA's figure is the peak of every temporary
buffer of the compiled step (the backward's and the optimizer's
transients, the gradients, the rebuilt layer included), where this tally
is what the forward leaves for the backward to start from, with each
remat unit's input alone.

Per-rank bytes follow the blocks the port holds (``Model.layouts``):
where a Mamba layer's rank holds B and C whole and its heads of the SSM
constants, or a rank holds its attention head slots, its part of an
unevenly split ``d_ff``, SSM head count or expert count
(``distributed/sharding.py``), the record gives the largest rank's bytes,
each ``model`` rank's total (``rank_bytes``) and the spec's figure beside
them (``spec_param_bytes``, ``spec_opt_state_bytes``,
``spec_cache_bytes``).  The ``long_500k`` cell, whose KV sequence the
spec splits over ``data``, runs its rank's step with ``seq_split``.  A
cell whose rank ``Model`` refuses to construct (an option that does not
fit the mesh) records its memory and roofline with ``"collectives":
null`` and the reason.  Results append to a JSONL file, so the sweep is
resumable.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.distributed.ctx import Mesh, _as_tuple
from repro_torch.distributed.sharding import (batch_specs, cache_layouts,
                                              cache_specs, local_shape,
                                              param_layouts, ref_leaf,
                                              sanitize_specs,
                                              sanitized_param_specs,
                                              spec_at, zip_map)
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import (SHAPES, ShapeSpec,
                                       cell_is_supported)
from repro_torch.models.model import Model
from repro_torch.utils import dtype_of, tree_leaves

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


def _model_for(cfg, opt: dict, mesh=None) -> Model:
    # 1024-wide attention chunks and layer rematerialisation, as the
    # reference's dry run
    return Model(cfg, attn_chunk=opt.get("attn_chunk", 1024), ssd_chunk=256,
                 remat=True, kv_dtype=opt.get("kv_dtype", "bfloat16"),
                 moe_groups=opt.get("moe_groups", 1),
                 pad_experts_to=opt.get("pad_experts_to", 0),
                 ssm_state_dtype=opt.get("ssm_state_dtype", "float32"),
                 mesh=mesh, device="meta")


def input_shapes(cfg, shape, model: Model) -> dict:
    """``{name: (shape, dtype)}`` of every input of the cell, as the
    reference's ``Model.input_specs`` (the decode cell's ``cache`` a dict
    of its own)."""
    B, S = shape.global_batch, shape.seq_len
    D, dt, i32 = cfg.d_model, model.dtype, torch.int32
    if shape.kind == "train":
        batch = {"targets": ((B, S), i32)}
        if cfg.input_mode == "embeds" and not cfg.is_encoder_decoder:
            batch["embeds"] = ((B, S, D), dt)
        else:
            batch["tokens"] = ((B, S), i32)
        if cfg.is_encoder_decoder:
            batch["enc_embeds"] = ((B, S, D), dt)
        return batch
    if shape.kind == "prefill":
        if cfg.is_encoder_decoder:
            return {"enc_embeds": ((B, S, D), dt), "tokens": ((B, 1), i32)}
        if cfg.input_mode == "embeds":
            return {"embeds": ((B, S, D), dt)}
        return {"tokens": ((B, S), i32)}
    return {"tokens": ((B, 1), i32), "cache": model.cache_shapes(B, S)}


def _bytes(shapes: dict, specs: dict, mesh: Mesh) -> int:
    return sum(math.prod(local_shape(s, specs[k], mesh))
               * torch.empty((), dtype=dt).element_size()
               for k, (s, dt) in shapes.items())


def model_ranks(mesh: Mesh) -> list:
    """``mesh`` at each coordinate of its ``model`` axis, the other
    coordinates ``mesh.coords``'s."""
    if "model" not in mesh.axis_names:
        return [mesh]
    axis = mesh.axis_names.index("model")
    out = []
    for c in range(mesh.shape[axis]):
        coords = list(mesh.coords)
        coords[axis] = c
        out.append(Mesh(mesh.axis_names, mesh.shape, coords=coords))
    return out


def param_bytes(cfg, whole, mode: str, mesh: Mesh, spec: bool = False,
                ranks: bool = False):
    """Bytes of the params (and, in ``train`` mode, of the f32 AdamW
    moments ``m`` and ``v``) of the rank at ``mesh.coords``, summed over
    the reference's stacked leaves by the blocks the port holds
    (``sharding.param_layouts``), or with ``spec`` by the reference's
    sanitized specs; with ``ranks``, a list of them, one for each rank of
    the ``model`` axis (:func:`model_ranks`: they hold unequal blocks
    where the axis does not split heads, ``d_ff`` or experts evenly)."""
    specs = (sanitized_param_specs if spec else param_layouts)(
        cfg, whole, mode, mesh)
    stacked = {}
    for path, t in tree_leaves(whole):
        ref, shape = ref_leaf(cfg, path, t.shape)
        stacked[ref] = (shape, spec_at(specs, path), t.element_size())
    out = []
    for at in (model_ranks(mesh) if ranks else [mesh]):
        p = sum(math.prod(local_shape(s, sp, at)) * item
                for s, sp, item in stacked.values())
        m = sum(math.prod(local_shape(s, sp, at)) * 4
                for s, sp, _ in stacked.values())
        out.append((p, 2 * m + 4 if mode == "train" else 0))
    return out if ranks else out[0]


def _refusal(cfg, shape, mesh, opt) -> str:
    """Why the port cannot run this cell sharded ('' when it can): what
    the rank's ``Model`` refuses to construct with ``opt`` on ``mesh``."""
    try:
        _model_for(cfg, opt, mesh)
    except ValueError as e:
        return f"{shape.name}: {e}"
    return ""


def _seq_split(cspec) -> bool:
    """Whether the cache specs split the KV sequence over ``data``."""
    return any("data" in _as_tuple(cspec[k][2]) for k in ("k", "v")
               if k in cspec)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def run_rank_step(cfg, shape, mesh: Mesh, opt: dict, whole):
    """One rank's step of the cell on meta tensors under the dry ``mesh``:
    its collectives' kinds, counts and operand bytes (per rank), and for a
    train cell the bytes autograd holds at the loss (else None)."""
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.saved import saved_at_loss
    from repro_torch.training.train_step import make_train_step
    mesh.records.clear()
    model = _model_for(cfg, opt, mesh)
    mode = "train" if shape.kind == "train" else "serving"
    model._check_layout(mode)
    specs = model.layouts(mode)
    params = zip_map(lambda t, s: _meta(local_shape(t.shape, s, mesh),
                                        t.dtype), whole, specs)
    one = _model_for(cfg, opt)
    ins = input_shapes(cfg, shape, one)
    shapes_b = {k: v for k, v in ins.items() if k != "cache"}
    bspec = sanitize_specs({k: s for k, (s, _) in shapes_b.items()},
                           batch_specs(cfg, shape, mesh), mesh)
    batch = {k: _meta(local_shape(s, bspec[k], mesh), dt)
             for k, (s, dt) in shapes_b.items()}
    saved = None
    if shape.kind == "train":
        for _, p in tree_leaves(params):
            p.requires_grad_(True)
        state = {"params": params, **init_opt_state(params)}
        tallies, loss = [], model.loss

        def tallied(params, batch):         # the tally at the loss
            out, n = saved_at_loss(loss, params, batch)
            tallies.append(n)
            return out
        model.loss = tallied
        make_train_step(model)(state, batch)
        saved, = tallies
    elif shape.kind == "prefill":
        model.prefill(params, batch)
    else:
        cache_sh = ins["cache"]
        cspec = cache_layouts(cfg, {k: s for k, (s, _) in cache_sh.items()},
                              shape, mesh)
        cache = {k: _meta(local_shape(s, cspec[k], mesh), dt)
                 for k, (s, dt) in cache_sh.items()}
        model.decode_step(params, cache, batch["tokens"],
                          seq_split=_seq_split(cspec))
    per_kind = {k: 0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for r in mesh.records:
        per_kind[r["kind"]] += r["bytes"]
        counts[r["kind"]] += 1
    return {"per_kind_bytes": per_kind, "counts": counts,
            "per_device_bytes": sum(per_kind.values())}, saved


def saved_activation_bytes(cfg, batch: int, seq: int, *,
                           remat: bool) -> int:
    """The bytes autograd holds for the backward when the loss of ``cfg``
    on one device, on a batch of ``batch`` x ``seq`` tokens, is reached
    (the dry run's tally, on meta tensors; the parameters and the batch
    not counted), with or without ``remat``."""
    from repro_torch.training.saved import saved_at_loss
    model = Model(cfg, remat=remat, device="meta")
    params = model.init(torch.Generator())
    for _, p in tree_leaves(params):
        p.requires_grad_(True)
    ins = {k: _meta(s, dt) for k, (s, dt) in input_shapes(
        cfg, ShapeSpec("train", seq, batch, "train"), model).items()}
    return saved_at_loss(model.loss, params, ins)[1]


def dry_cell(arch: str, shape_name: str, mesh: Mesh, *, opt: dict = None,
             cfg=None) -> dict:
    """The record of one cell on the dry ``mesh``: rank 0's step and
    collectives, the largest rank's bytes."""
    opt = opt or {}
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    chips = mesh.size
    t0 = time.time()
    one = _model_for(cfg, opt)
    whole = one.init(torch.Generator())
    mode = "train" if shape.kind == "train" else "serving"
    per_rank = param_bytes(cfg, whole, mode, mesh, ranks=True)
    spec_bytes = dict(zip(("spec_param_bytes", "spec_opt_state_bytes"),
                          param_bytes(cfg, whole, mode, mesh, spec=True)))
    ins = input_shapes(cfg, shape, one)
    bspec = batch_specs(cfg, shape, mesh)
    shapes_b = {k: v for k, v in ins.items() if k != "cache"}
    b_bytes = _bytes(shapes_b, sanitize_specs(
        {k: s for k, (s, _) in shapes_b.items()}, bspec, mesh), mesh)
    c_per = [0] * len(per_rank)
    if "cache" in ins:
        cs = ins["cache"]
        shapes_c = {k: s for k, (s, _) in cs.items()}
        cspec = sanitize_specs(shapes_c, cache_specs(cfg, shape, mesh), mesh)
        clay = cache_layouts(cfg, shapes_c, shape, mesh)
        c_per = [_bytes(cs, clay, at) for at in model_ranks(mesh)]
        spec_bytes["spec_cache_bytes"] = _bytes(cs, cspec, mesh)
    # each rank of the ``model`` axis: params, moments, cache and batch
    rank_bytes = [p + o + c + b_bytes for (p, o), c in zip(per_rank, c_per)]
    p_bytes, opt_bytes = max(per_rank)
    c_bytes = max(c_per)
    own = {"spec_param_bytes": p_bytes, "spec_opt_state_bytes": opt_bytes,
           "spec_cache_bytes": c_bytes}
    spec_bytes = {k: n for k, n in spec_bytes.items() if n != own[k]}
    kv_bytes = dtype_of(opt.get("kv_dtype", "bfloat16")).itemsize
    cost = roofline.cell_cost(cfg, shape, attn_chunk=opt.get(
        "attn_chunk", 1024), kv_bytes=kv_bytes)
    reason = _refusal(cfg, shape, mesh, opt)
    coll, saved = (None, None) if reason else run_rank_step(
        cfg, shape, mesh, opt, whole)
    flops_dev, bytes_dev = cost.flops / chips, cost.hbm_bytes / chips
    coll_dev = coll["per_device_bytes"] if coll else 0
    terms = roofline.roofline_terms(cfg, shape, chips, coll_dev,
                                    kv_bytes=kv_bytes,
                                    attn_chunk=opt.get("attn_chunk", 1024))
    if coll is None:
        terms["collective_s"] = None
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.shape), "chips": chips,
        "device": roofline.DEVICE, "opt": opt,
        "memory": {"param_bytes": p_bytes, "opt_state_bytes": opt_bytes,
                   "cache_bytes": c_bytes, "batch_bytes": b_bytes,
                   "total_bytes": max(rank_bytes),
                   "rank_bytes": rank_bytes,
                   **spec_bytes,
                   **({} if saved is None else
                      {"saved_activation_bytes": saved})},
        "cost": {"flops_per_device": flops_dev,
                 "bytes_per_device": bytes_dev},
        "collectives": coll,
        "collectives_reason": reason or None,
        "roofline": terms,
        "step_s": round(time.time() - t0, 2),
    }


def run_cells(archs, shapes, meshes, out_path: Path, force: bool = False,
              opt: dict = None):
    opt = opt or {}
    opt_key = json.dumps(opt, sort_keys=True)
    done = set()
    if out_path.exists() and not force:
        for line in out_path.read_text().splitlines():
            try:
                r = json.loads(line)
                done.add((r["arch"], r["shape"], r["mesh"],
                          json.dumps(r.get("opt") or {}, sort_keys=True)))
            except Exception:
                pass
    out_path.parent.mkdir(parents=True, exist_ok=True)
    mesh_objs = {}
    if "single" in meshes:
        mesh_objs["16x16"] = make_production_mesh(multi_pod=False)
    if "multi" in meshes:
        mesh_objs["2x16x16"] = make_production_mesh(multi_pod=True)

    with out_path.open("a") as fh:
        for arch in archs:
            cfg = get_config(arch)
            for shape_name in shapes:
                ok, reason = cell_is_supported(cfg, SHAPES[shape_name])
                for mesh_name, mesh in mesh_objs.items():
                    key = (arch, shape_name, mesh_name, opt_key)
                    if key in done:
                        print(f"[skip-cached] {key}")
                        continue
                    if not ok:
                        rec = {"arch": arch, "shape": shape_name,
                               "mesh": mesh_name, "skipped": True,
                               "reason": reason, "opt": opt}
                        fh.write(json.dumps(rec) + "\n")
                        fh.flush()
                        print(f"[skip] {arch} {shape_name}: {reason}")
                        continue
                    print(f"[dry] {arch} {shape_name} {mesh_name} opt={opt} "
                          "...", flush=True)
                    t0 = time.time()
                    try:
                        rec = dry_cell(arch, shape_name, mesh, opt=opt)
                        rec["wall_s"] = round(time.time() - t0, 1)
                        coll = rec["collectives"]
                        print(f"  ok in {rec['wall_s']}s "
                              f"dominant={rec['roofline']['dominant']} "
                              f"collectives="
                              f"{coll['per_device_bytes'] if coll else None}",
                              flush=True)
                    except Exception as e:
                        rec = {"arch": arch, "shape": shape_name,
                               "mesh": mesh_name, "error": str(e)[:2000],
                               "traceback": traceback.format_exc()[-4000:],
                               "opt": opt, "wall_s": round(time.time() - t0, 1)}
                        print(f"  FAILED: {e}", flush=True)
                    fh.write(json.dumps(rec) + "\n")
                    fh.flush()


def _parse_opt(s: str) -> dict:
    out = {}
    if not s:
        return out
    for kv in s.split(","):
        k, v = kv.split("=")
        try:
            out[k] = int(v)
        except ValueError:
            out[k] = v if v not in ("true", "false") else (v == "true")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="runs/dryrun.jsonl")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--opt", default="", help="k=v,... perf-variant options "
                    "(kv_dtype, moe_groups, pad_experts_to, attn_chunk)")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else list(ASSIGNED_ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    run_cells(archs, shapes, meshes, Path(args.out), force=args.force,
              opt=_parse_opt(args.opt))


if __name__ == "__main__":
    main()
