"""Model assembly for the PyTorch port: the serving entry points of the
attention-family decoder, with a dense or a capacity-based MoE FFN
(chunked paged prefill and fused paged decode; monolithic prefill, chunked
prefill over a dense per-lane stripe and fused dense decode; fused
verify-k speculative decode over either), of the encoder-decoder family
(monolithic prefill of encoder frames and a decoder start, fused dense
decode against a static cross cache), of the Mamba-2 (``ssm``) family
and of the hybrid family (Jamba: Mamba-2 and attention layers, dense and
MoE FFNs; monolithic prefill, fused dense decode over a cache of K/V and
recurrent state), and the training loss of every family.  A decoder
whose ``input_mode`` is ``embeds`` (a VLM's patch embeddings) takes
``embeds`` in place of ``tokens`` in :meth:`Model.prefill` and
:meth:`Model.loss`.

Parameters are a plain dict: ``embed``, ``final_norm.scale`` and a list
``layers`` with one dict per layer (``ln1`` and ``attn.{wq,wk,wv,wo}`` or
``ssm.*`` as ``cfg.layer_kind(i)`` says, then ``ln2`` and ``ffn.*`` as
``cfg.ffn_kind(i)`` says: the dense FFN's ``wi``/``wg``/``wo``, or the
MoE's float32 ``router`` and its experts' ``wi``/``wg``/``wo`` stacked on
a leading expert axis).  An encoder-decoder also has ``encoder`` (a list
of attention + dense-FFN layers), ``cross`` (per decoder layer ``lnx`` and
``xattn.{wq,wk,wv,wo}``) and ``enc_final_norm``.  Where the JAX reference
runs ``lax.scan`` over layers stacked on axis 0 (the hybrid family: over
8-layer groups of three stacks, :data:`HYBRID_ORDER`), the port loops
over the list in Python.  Where the reference rebuilt the page pool or the
decode cache functionally and returned it, the port writes it **in place**
and returns only the logits.

``Model(remat=True)`` (the reference's default) rematerialises the
whole-sequence stacks under differentiation as the reference's
``jax.checkpoint`` does: one ``torch.utils.checkpoint`` unit per decoder
layer (an encoder-decoder's cross sublayer inside it), per encoder layer
and per 8-layer group of the hybrid family.  Autograd keeps each unit's
input only, and the backward runs the unit again (:meth:`Model._remat`).
"""
from __future__ import annotations

import contextvars
import functools
from typing import Any, Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import ctx as C
from repro_torch.distributed.sharding import (even_blocks, head_layout,
                                              map_with_path,
                                              param_layouts,
                                              sanitized_param_specs,
                                              shard_params, spec_at)
from repro_torch.kernels.flash_prefill import flash_prefill_prefix
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.config import ArchConfig
from repro_torch.serving.sampler import sample_and_reason, verify_and_reason
from repro_torch.utils import (dtype_of, resolve_device, tree_leaves,
                               tree_map)

Params = Dict[str, Any]

MOE_AUX_COEF = 0.01
ZLOSS_COEF = 1e-4

# The reference's Jamba group (``models/model.py``): 8 layers, layer j of
# a group taken from stack ``HYBRID_ORDER[j]`` of the group's parameters
# ("sd" Mamba + dense FFN, "sm" Mamba + MoE, "am" attention + MoE), the
# same kinds ``cfg.layer_kind`` and ``cfg.ffn_kind`` name; the cache holds
# one K/V per group and the conv and SSM state of its 7 Mamba layers, in
# the order of ``HYBRID_SSM_J``.
HYBRID_GROUP = 8
HYBRID_ORDER = [("sd", 0), ("sm", 0), ("sd", 1), ("am", 0),
                ("sd", 2), ("sm", 1), ("sd", 3), ("sm", 2)]
HYBRID_SSM_J = [0, 1, 2, 4, 5, 6, 7]


def hybrid_groups(cfg: ArchConfig) -> int:
    """The hybrid stack's 8-layer groups (the reference's assertion)."""
    gs = cfg.attn_every
    assert gs == HYBRID_GROUP and cfg.num_layers % gs == 0, \
        "hybrid assumes Jamba 8-layer groups"
    return cfg.num_layers // gs


def expert_range(cfg: ArchConfig, expert_shard=(0, 1)):
    """Experts ``[lo, hi)`` that share ``(index, count)`` of an MoE holds:
    the ``index``-th of ``count`` equal parts of the expert axis, as the
    reference's expert parallelism shards it (``distributed/sharding.py``:
    ``wi``/``wg``/``wo`` over the ``model`` mesh axis).  None for the
    whole layer (count 1)."""
    index, count = expert_shard
    if count == 1:
        return None
    E = cfg.num_experts
    if not cfg.has_moe or E % count or not 0 <= index < count:
        raise ValueError(f"expert_shard={expert_shard} does not split "
                         f"{E} experts into equal shares")
    return index * E // count, (index + 1) * E // count


@functools.lru_cache(maxsize=8)
def _meta_whole(cfg: ArchConfig, pad_experts_to: int):
    """The whole model's parameters as meta tensors (shapes only), one
    tree for every ``Model`` of ``cfg`` (read, never written)."""
    return Model(cfg, pad_experts_to=pad_experts_to, device="meta").init(
        torch.Generator())


# where the roadmap keeps the engine calls that no mesh runs
SHARDING_ITEM = "ROADMAP.md Queue 1, \"Not queued: sharded engine calls\""


def _sharded(method):
    """An entry point that runs over the model's mesh: its collectives
    resolve against ``self.mesh`` (identity without one).  Called with
    ``seq_split=True`` (the long-context cell, global batch 1) it runs
    with the batch replicated over the batch axes
    (:func:`ctx.replicated_batch`)."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with C.mesh_context(self.mesh), \
                C.replicated_batch(kwargs.get("seq_split", False)):
            return method(self, *args, **kwargs)
    return run


def _one_rank(method):
    """An entry point that runs on one rank only: the reference never
    shards the engine's calls (paged and chunk entries, packs, verify)."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        if self.mesh is not None and self.mesh.size > 1:
            raise ValueError(
                f"{method.__name__} does not run sharded "
                f"({self.mesh.describe()}), as the reference's; see "
                f"{SHARDING_ITEM}")
        return method(self, *args, **kwargs)
    return run


class _Gathered:
    """A layer list whose layers (or a part of one, :func:`_part`) pass
    through ``fn(path, tree)`` as they are reached, ``path`` the layer's
    index and the part's keys (the FSDP gather of a layer just before its
    use)."""

    def __init__(self, layers, fn):
        self.layers, self.fn = layers, fn

    def __len__(self):
        return len(self.layers)

    def __getitem__(self, i):
        return self.fn((i,), self.layers[i])


def _raw(layers, i):
    """Layer ``i`` as the list holds it (a rank's blocks, not gathered)."""
    return (layers.layers if isinstance(layers, _Gathered) else layers)[i]


def _part(layers, i, *keys):
    """Layer ``i``'s part at ``keys`` of a layer list, gathered as it is
    reached where the list is a :class:`_Gathered`."""
    tree = _raw(layers, i)
    for k in keys:
        tree = tree[k]
    if isinstance(layers, _Gathered):
        return layers.fn((i, *keys), tree)
    return tree


def _scalar(v, device) -> torch.Tensor:
    """(1,) int32 tensor on ``device`` of an int or a one-element integer
    tensor (a tensor already there is returned as it is)."""
    if isinstance(v, torch.Tensor):
        return v.reshape(1).to(device=device, dtype=torch.int32)
    return torch.full((1,), int(v), dtype=torch.int32, device=device)


def _to_tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":     # numpy has no bf16: go via f32
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)   # own, writable copy


def params_from_numpy(cfg: ArchConfig, np_params, device=None) -> Params:
    """Turn the JAX ``Model.init`` pytree (or a gradient of that shape),
    already converted to numpy by the caller
    (``jax.tree_util.tree_map(np.asarray, params)``), into the port's
    parameters: the same names, with ``layers`` and ``cross`` (stacked on
    axis 0 over the decoder's layers) and ``encoder`` (over the encoder's)
    split into one dict per layer.  A hybrid's ``layers`` (per 8-layer
    group ``g`` the stacks ``sd`` (g, 4, ...), ``sm`` (g, 3, ...) and
    ``am`` (g, ...)) become one dict per absolute layer ``8 g + j``, from
    stack ``HYBRID_ORDER[j]``."""
    device = resolve_device(device)
    stacks = {"layers": cfg.num_layers, "cross": cfg.num_layers,
              "encoder": cfg.num_encoder_layers}
    out: Params = {k: tree_map(lambda a: _to_tensor(a, device), v)
                   for k, v in np_params.items() if k not in stacks}

    def layer(tree, *idx):
        return tree_map(lambda a: _to_tensor(np.asarray(a)[idx], device),
                        tree)
    for key, n in stacks.items():
        if key not in np_params:
            continue
        if key == "layers" and cfg.family == "hybrid":
            out[key] = [
                layer(np_params[key][stack], g, *(() if stack == "am"
                                                  else (idx,)))
                for g in range(hybrid_groups(cfg))
                for stack, idx in HYBRID_ORDER]
        else:
            out[key] = [layer(np_params[key], i) for i in range(n)]
    return out


def _last_writer(write_page, write_off) -> torch.Tensor:
    """For each of the N flat destinations ``(write_page, write_off)``, the
    flat index of the last row that writes the same slot.  A scatter that
    writes each row the value of that row writes equal values to a shared
    slot, so the slot ends as a sequential scatter leaves it (the last
    duplicate wins) on any device, where a CUDA scatter of differing
    duplicates keeps no order.  (N,) int64; no value is read back."""
    dest = torch.stack([write_page.reshape(-1).long(),
                        write_off.reshape(-1).long()])
    same = (dest[:, :, None] == dest[:, None, :]).all(0)          # (N, N)
    idx = torch.arange(same.shape[0], device=same.device)
    return torch.where(same, idx[None, :], torch.full_like(same, -1,
                                                           dtype=idx.dtype)
                       ).amax(1)


class Model:
    """Attention-family decoder (dense or MoE FFN), encoder-decoder,
    Mamba-2 or hybrid stack: pure functions over explicit params, on one
    device or as one rank of a mesh (``mesh``).

    ``use_kernels`` (default True) sends every RMSNorm, the SSD chunk step
    and the training loss's full-sequence attention to their kernels (CUDA
    kernels for CUDA tensors, plain versions for CPU tensors); False runs
    their plain versions on any device, the reference path the kernels are
    held against on the card.  The serving attention kernels have their own
    switches (``chunk_attn_impl``, the decode step's ``attn_impl``).
    ``attn_chunk`` sizes the query and key chunks of the plain
    ``chunked_attention``.  ``moe_groups`` and ``pad_experts_to`` are the
    reference's MoE options: the dispatch groups of every MoE call except
    the single-token decode steps (which use one group, as the
    reference's), and padding experts the router never picks.
    ``moe_tap`` (None) is passed to every MoE call as ``apply_moe``'s
    measurement hook.  ``expert_shard=(index, count)`` (default: every
    expert; on a mesh the mesh sets it) holds the ``index``-th of
    ``count`` equal shares
    of every MoE layer's experts (:func:`expert_range`), the device-local
    half of the reference's expert parallelism: routing, capacity and
    the aux loss stay the whole layer's, and an assignment to an expert
    held elsewhere adds 0 (no exchange with the other shares is made).

    ``mesh`` (a :class:`repro_torch.distributed.ctx.Mesh`, default None:
    one device) makes this the model of one rank of the reference's
    sharded execution (``distributed/sharding.py``): Megatron tensor
    parallelism over the ``model`` axis (H/m query heads, KVH/m KV heads
    and d_ff/m of the FFN a rank; each ``wo`` product followed by the
    ``model`` all-reduce; a Mamba-2 layer's H/m SSM heads, its gated norm
    split over the ranks and ``out_proj`` followed by the all-reduce; an
    encoder's and a cross-attention's heads likewise), expert parallelism
    (the rank's ``model`` coordinate sets its part of the experts, and the
    parts' outputs are summed over ``model``: the exchange; an explicit
    ``expert_shard`` is split further over ``model``), the batch over
    (``pod``, ``data``).  Where ``model`` does not split the heads evenly,
    every rank holds the same query and KV head slots
    (``sharding.head_layout``: a KV head replicated on several ranks, or
    padded with zero heads), so the attention sees an ordinary GQA shape
    (``self.heads``); a padding head is built by the forward, never a
    parameter, and adds exactly 0.  ``d_ff``, experts and SSM heads that
    ``model`` does not split evenly spread over the ranks as evenly as
    they go (padding units are layout only: a rank computes its real
    ones, :attr:`ssm_heads` of a Mamba layer; a rank past the last expert
    holds none and adds 0 to the exchange).
    Every family runs sharded: :meth:`prefill` and :meth:`decode_step`
    take the rank's block of the serving-mode params (:meth:`shard`, by
    :meth:`layouts`), its rows of the batch and its heads of the cache
    (:meth:`decode_step` with ``seq_split``, the long-context cell: the
    batch whole on every rank and the cache's positions split over
    ``data``); :meth:`loss`
    takes the train-mode (FSDP x TP) blocks and gathers each layer's
    ``data`` shards just before its use.  :meth:`init` draws the whole
    model (or, given a ``mode``, keeps the rank's blocks layer by layer).
    The engine's entry points (paged, chunk, pack and verify calls) raise
    on a mesh of more than one rank; every mesh whose specs the
    reference's ``sanitize_spec`` accepts constructs and runs.

    ``remat`` (default True, the reference's) rematerialises the
    whole-sequence stacks where grad is enabled and an input requires it
    (:meth:`_remat`); no serving path is differentiated, so it changes
    training only.  ``ssm_state_dtype`` (default ``float32``) is the
    reference's: the dtype of the ``ssm`` leaf of :meth:`cache_shapes`
    and :meth:`init_cache`, nothing more (a prefill returns the state in
    float32, and :meth:`decode_step` on a narrower state returns it in
    float32, as the reference's does).  The serving backends refuse a
    narrower state, so the engine's steps never meet one.
    """

    def __init__(self, cfg: ArchConfig, *, kv_dtype: str = "bfloat16",
                 chunk_attn_impl: str = "masked", attn_chunk: int = 1024,
                 ssd_chunk: int = 256, use_kernels: bool = True,
                 moe_groups: int = 1, pad_experts_to: int = 0,
                 remat: bool = True, ssm_state_dtype: str = "float32",
                 expert_shard=None, mesh=None, device=None):
        if chunk_attn_impl not in ("masked", "flash"):
            raise ValueError(f"chunk_attn_impl={chunk_attn_impl!r} "
                             "(want 'masked' or 'flash')")
        if cfg.family == "hybrid":
            hybrid_groups(cfg)
        self.mesh = mesh
        self._layouts = {}
        # the experts every rank's draw holds (None: all of them)
        self.share = expert_range(cfg, expert_shard or (0, 1))
        if self.share is not None and pad_experts_to:
            raise ValueError("expert_shard and pad_experts_to do not combine")
        self.experts = self.share
        # (query slots, KV slots, ranks a KV head is on) where ``model``
        # does not split the heads evenly
        self.heads = None
        # the SSM heads a rank's Mamba layers hold (``sharding.even_blocks``)
        self.ssm_heads = cfg.ssm_heads if cfg.has_ssm else 0
        if mesh is not None:
            m, c = mesh.sizes.get("model", 1), mesh.coord("model")
            if cfg.family != "ssm" and cfg.num_kv_heads % m:
                self.heads = head_layout(cfg, m)[:3]
            if cfg.has_ssm:
                self.ssm_heads = len(even_blocks(cfg.ssm_heads, m)[c])
            if cfg.has_moe and m > 1:
                # the share (default every expert) split over ``model``:
                # evenly where a share is given (its layouts follow the
                # whole layer's), else as evenly as the experts go (a
                # rank past the last expert holds none and adds 0)
                lo, hi = self.share or (0, max(cfg.num_experts,
                                               pad_experts_to))
                n = hi - lo
                if self.share and n % m:
                    raise ValueError(
                        f"the share of {n} experts does not split evenly "
                        f"over the 'model' axis of {m}")
                self.experts = (lo + c * n // m, lo + (c + 1) * n // m)
        self.cfg = cfg
        self.chunk_attn_impl = chunk_attn_impl
        self.attn_chunk = attn_chunk
        self.ssd_chunk = ssd_chunk
        self.use_kernels = use_kernels
        self.moe_groups = moe_groups
        self.pad_experts_to = pad_experts_to
        self.moe_tap = None
        self.remat = remat
        self.ssm_state_dtype = ssm_state_dtype
        self.kv_dtype = kv_dtype
        self.dtype = dtype_of(cfg.param_dtype)
        self.device = resolve_device(device)

    def _norm(self, p, x):
        return L.apply_norm(self.cfg, p, x, use_kernel=self.use_kernels)

    # ---------------------------------------------------------------- mesh
    def _whole_shapes(self):
        """The whole model's parameters as meta tensors (shapes only)."""
        return _meta_whole(self.cfg, self.pad_experts_to)

    def specs(self, mode: str = "serving"):
        """The sanitized spec of every parameter leaf on the model's mesh
        in ``mode`` (``serving`` or ``train``), a tree of the params'
        structure (each spec the reference's, on the stacked shape)."""
        if mode not in self._layouts:
            self._layouts[mode] = sanitized_param_specs(
                self.cfg, self._whole_shapes(), mode, self.mesh)
        return self._layouts[mode]

    def layouts(self, mode: str = "serving"):
        """The specs by which a rank holds its blocks in ``mode``: the
        :meth:`specs`, with each Mamba leaf's port layout (its heads' z, x
        and dt, B and C whole: ``sharding.param_layouts``)."""
        key = ("layouts", mode)
        if key not in self._layouts:
            self._layouts[key] = param_layouts(
                self.cfg, self._whole_shapes(), mode, self.mesh,
                self.specs(mode))
        return self._layouts[key]

    def shard(self, params, mode: str = "serving"):
        """This rank's blocks of the whole ``params`` (as :meth:`init` or
        ``params_from_numpy`` give them) by the ``mode`` layouts, checking
        that each leaf's ``model`` split is one the entry points execute
        (:meth:`_check_layout`)."""
        self._check_layout(mode)
        return shard_params(params, self.layouts(mode), self.mesh)

    # the dim of a leaf's own shape that a rank's block splits over
    # ``model``, as the products expect it (MoE experts: dim 0)
    _MODEL_DIM = {"wq": 1, "wk": 1, "wv": 1, "bq": 0, "bk": 0, "bv": 0,
                  "wi": 1, "wg": 1, "wo": 0, "in_proj": 1, "conv_w": 1,
                  "conv_b": 0, "out_proj": 0, "A_log": 0, "D_skip": 0,
                  "dt_bias": 0}

    def _check_layout(self, mode: str) -> None:
        """Every leaf's ``model`` split on the dim the port's products
        expect: columns of ``wq``/``wk``/``wv``/``wi``/``wg`` and of a
        Mamba ``in_proj``, rows of each ``wo`` and of ``out_proj``, the
        channels of the conv, the heads of the SSM constants, the gated
        norm's columns, the expert axis of an MoE, either dim of ``embed``
        and ``lm_head`` (vocab or d_model), nothing else split (once for
        each spec: the layers of a stack share theirs)."""
        if self.mesh is None or self.mesh.sizes.get("model", 1) == 1:
            return
        whole, specs = self._whole_shapes(), self.layouts(mode)
        seen = set()
        for path, leaf in tree_leaves(whole):
            spec = spec_at(specs, path)
            if (id(spec), path[-2:]) in seen:
                continue
            seen.add((id(spec), path[-2:]))
            own = C._entries(spec, leaf.dim())
            dims = [i for i, e in enumerate(own) if "model" in e]
            name = path[-1]
            if name in ("embed", "lm_head"):
                ok = len(dims) <= 1
            elif "router" in spec_at(whole, path[:-1]):     # an MoE FFN
                ok = dims == ([0] if name in ("wi", "wg", "wo") else [])
            elif path[-2:] == ("gate_norm", "scale"):
                ok = dims == [0]
            else:
                want = self._MODEL_DIM.get(name)
                ok = dims == ([] if want is None else [want])
            if isinstance(spec, C.HeadSplit):    # its blocks by ``model``
                ok = ok and own[spec.dim] == ("model",)
            if not ok:
                raise ValueError(
                    f"{self.cfg.name}: {'/'.join(map(str, path))} "
                    f"{tuple(leaf.shape)} would split over 'model' as "
                    f"{spec} on {self.mesh.describe()}, a layout the "
                    f"port does not execute")

    def _fsdp(self, path, tree):
        """``tree`` (a subtree of train-mode blocks at ``path``) with each
        leaf's ``data`` shards gathered (:func:`ctx.fsdp_gather`)."""
        whole = spec_at(self._whole_shapes(), path)
        specs = spec_at(self.layouts("train"), path)
        return map_with_path(lambda p, t: C.fsdp_gather(
            t, spec_at(specs, p), tuple(spec_at(whole, p).shape)),
            tree)

    # ------------------------------------------------------------- params
    def init(self, generator: torch.Generator, mode=None) -> Params:
        """Random parameters drawn on the model's device from
        ``generator`` (a ``torch.Generator`` on that device), with the
        scales of ``layers._dense_init``: normal x 1/sqrt(fan_in), the
        embedding x 0.02.  With ``mode`` (``serving`` or ``train``) on a
        mesh, the rank's blocks by :meth:`layouts` of the same draw
        (``shard(init(generator), mode)``), each kept as soon as its
        layer is drawn: a rank holds one whole layer at most."""
        cfg, dtype, dev = self.cfg, self.dtype, self.device
        if mode is not None:
            self._check_layout(mode)
            layouts = self.layouts(mode)

            def keep(path, tree):
                return shard_params(tree, spec_at(layouts, path), self.mesh)
        else:
            def keep(path, tree):
                return tree
        params: Params = {
            "embed": keep(("embed",), L._dense_init(
                generator, (cfg.vocab_size, cfg.d_model), scale=0.02,
                dtype=dtype, device=dev)),
            "final_norm": keep(("final_norm",),
                               L.init_norm(cfg, cfg.d_model, dtype, dev)),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = keep(("lm_head",), L._dense_init(
                generator, (cfg.d_model, cfg.vocab_size), dtype=dtype,
                device=dev))
        params["layers"] = [
            keep(("layers", i), self._init_layer(
                generator, cfg.layer_kind(i), cfg.ffn_kind(i)))
            for i in range(cfg.num_layers)]
        if cfg.is_encoder_decoder:
            params["encoder"] = [
                keep(("encoder", i),
                     self._init_layer(generator, "attn", "dense"))
                for i in range(cfg.num_encoder_layers)]
            params["cross"] = [
                keep(("cross", i),
                     {"lnx": L.init_norm(cfg, cfg.d_model, dtype, dev),
                      "xattn": L.init_attention(cfg, generator, dtype, dev)})
                for i in range(cfg.num_layers)]
            params["enc_final_norm"] = keep(
                ("enc_final_norm",), L.init_norm(cfg, cfg.d_model, dtype,
                                                 dev))
        return params

    def _init_layer(self, generator, kind: str, ffn_kind: str):
        """One layer in the reference's layout (``_init_sublayer``): ``ln1``
        and the ``kind`` mixer (``attn`` or ``ssm``), then ``ln2`` and the
        ``ffn_kind`` FFN (``dense``, ``moe``: the held experts only, or
        ``none``)."""
        cfg, dtype, dev = self.cfg, self.dtype, self.device
        p = {"ln1": L.init_norm(cfg, cfg.d_model, dtype, dev)}
        if kind == "ssm":
            p["ssm"] = M.init_mamba_block(cfg, generator, dtype, dev)
        else:
            p["attn"] = L.init_attention(cfg, generator, dtype, dev)
        if ffn_kind == "dense":
            p["ln2"] = L.init_norm(cfg, cfg.d_model, dtype, dev)
            p["ffn"] = L.init_ffn(cfg, generator, dtype, dev)
        elif ffn_kind == "moe":
            p["ln2"] = L.init_norm(cfg, cfg.d_model, dtype, dev)
            p["ffn"] = L.init_moe(cfg, generator, dtype, dev,
                                  self.pad_experts_to, self.share)
        return p

    # --------------------------------------------------------------- embed
    def _embed_in(self, params, tokens=None, embeds=None):
        """The decoder's input rows: ``embeds`` (B, S, D) cast to the
        model's dtype when given (a VLM's patch embeddings), else the
        embedding rows of ``tokens``."""
        if embeds is not None:
            return embeds.to(self.dtype)
        emb = params["embed"]
        V = self.cfg.vocab_size
        if emb.shape[0] != V:            # vocab split over ``model``
            lo = C.axis_index("model")[0] * emb.shape[0]
            ids = tokens.long() - lo
            inside = (ids >= 0) & (ids < emb.shape[0])
            rows = emb[ids.clamp(0, emb.shape[0] - 1)]
            rows = rows * inside[..., None].to(rows.dtype)
            return C.reduce_from(rows, "model")
        rows = emb[tokens.long()]
        if emb.shape[1] != self.cfg.d_model:     # d_model split
            rows = C.gather_from(rows, "model", dim=-1)
        return rows

    def _logits(self, params, h):
        """``h @ head``: the tied ``embed.T`` or ``lm_head`` (D, V).  A head
        split by columns (the vocab) takes the replicated ``h`` and
        all-gathers the logits; one split by rows (d_model, where the
        reference's spec re-homes an odd vocab's axis) takes this rank's
        columns of ``h`` and all-reduces the partial logits."""
        head = (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])
        if head.shape[1] != self.cfg.vocab_size:
            return C.gather_from(C.copy_to(h, "model") @ head, "model",
                                 dim=-1)
        if head.shape[0] != self.cfg.d_model:
            return C.reduce_from(C.split_to(h, "model", dim=-1) @ head,
                                 "model")
        return h @ head

    @staticmethod
    def _wo(attn_flat, wo):
        """The attention's output product: row-parallel over ``model``
        under a mesh (this rank's heads), then the all-reduce.  A rank
        whose head slots end in padding (:attr:`heads`) takes its real
        heads' columns: a padding head meets zero rows of ``wo``, so it
        would add exactly 0."""
        return C.reduce_from(attn_flat[..., :wo.shape[0]] @ wo, "model")

    def _ffn_block(self, p_l, h, groups=None):
        """``h`` plus the layer's FFN of ``ln2(h)`` (none where ``p_l`` has
        no ``ffn``, MoE where its ``ffn`` holds a ``router``, else dense),
        and the MoE aux loss (None without experts).  An MoE dispatches in
        ``groups`` groups (default ``moe_groups``; the decode steps pass
        1)."""
        if "ffn" not in p_l:
            return h, None
        x = self._norm(p_l["ln2"], h)
        if "router" in p_l["ffn"]:
            out, aux = L.apply_moe(self.cfg, p_l["ffn"], x,
                                   groups=groups or self.moe_groups,
                                   tap=self.moe_tap, experts=self.experts)
            return h + out, aux
        return h + L.apply_ffn(self.cfg, p_l["ffn"], x), None

    # ------------------------------------------------------------ training
    @_sharded
    def loss(self, params, batch):
        """Mean next-token cross-entropy plus the z-loss (and the MoE aux
        term, 0 without experts) of one batch, as the reference's
        ``Model.loss``.  ``batch``: ``targets`` (B, S) and ``tokens`` (B, S)
        or ``embeds`` (B, S, D), with ``enc_embeds`` (B, T, D) for an
        encoder-decoder, tensors on the model's device.  Returns ``(total,
        {"ce", "zloss", "moe_aux"})``, float32 scalars that carry the graph
        when the params require grad.

        On a mesh, ``params`` are the rank's train-mode blocks and
        ``batch`` its rows: each layer's ``data`` shards are gathered just
        before its use (their gradients reduce-scattered in the backward)
        and the means are over every rank's rows (the MoE's dispatch and
        aux term over every rank's tokens, :func:`layers.apply_moe`), so
        each rank returns the whole batch's loss."""
        params = self._train_view(params)
        x = self._embed_in(params, batch.get("tokens"), batch.get("embeds"))
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        x, aux, _ = self._run_stack_full(params, x, positions,
                                         enc_ctx=self._enc_ctx(params, batch))
        x = self._norm(params["final_norm"], x)
        logits = self._logits(params, x).float()
        logz = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1,
                           batch["targets"].long()[..., None])[..., 0]
        nb = C.axis_index("batch")[1]
        ce = C.reduce_from((logz - tgt).mean(), "batch") / nb
        zloss = ZLOSS_COEF * C.reduce_from((logz ** 2).mean(), "batch") / nb
        total = ce + zloss + MOE_AUX_COEF * aux
        return total, {"ce": ce, "zloss": zloss, "moe_aux": aux}

    def _train_view(self, params):
        """``params`` (train-mode blocks) as the loss uses them: with every
        ``data`` shard of a leaf gathered, the embedding, final norm and
        head at once and each layer of ``layers``, ``encoder`` and
        ``cross`` as it is reached, inside its remat unit (identity off a
        mesh or where the batch axes have one rank)."""
        if self.mesh is None or C.axis_index("batch")[1] == 1:
            return params
        return {k: (_Gathered(v, lambda path, t, k=k: self._fsdp(
                    (k, *path), t)) if k in ("layers", "encoder", "cross")
                    else self._fsdp((k,), v))
                for k, v in params.items()}

    def _remat(self, fn, x, *args, tree=()):
        """``fn(x, *args)`` as one unit of the reference's
        ``jax.checkpoint``, where ``remat`` is on, grad is enabled and
        ``x`` or a leaf of ``tree`` (the unit's params) requires grad:
        autograd keeps the unit's tensor inputs only, and the backward runs
        ``fn`` again to rebuild what it needs.  That run sees the mesh
        context of the first (the collectives, FSDP gathers and kernel
        launches of the unit run again, in the same order on every rank),
        and no ``moe_tap``: the tap sees each MoE call once, in the
        forward.  Elsewhere ``fn(x, *args)``."""
        if not (self.remat and torch.is_grad_enabled() and (
                x.requires_grad or any(t.requires_grad for _, t in
                                       tree_leaves(tree)))):
            return fn(x, *args)
        ctx, first = contextvars.copy_context(), [True]

        def run(*a):
            if first[0]:
                first[0] = False
                return ctx.run(fn, *a)
            tap, self.moe_tap = self.moe_tap, None
            try:
                return ctx.run(fn, *a)
            finally:
                self.moe_tap = tap
        return checkpoint(run, x, *args, use_reentrant=False,
                          preserve_rng_state=False)

    def _self_attn(self, p_l, x, positions, causal: bool):
        """``x`` plus the layer's self-attention over whole sequences
        (``ln1``, ``chunked_attention``: the flash kernel on the card,
        ``wo``), and the projected ``k``, ``v`` (B, S, KVH, hd)."""
        B, S = x.shape[:2]
        h = self._norm(p_l["ln1"], x)
        q, k, v = L._project_qkv(self.cfg, p_l["attn"], h, positions,
                                 heads=self.heads)
        attn = L.chunked_attention(
            self.cfg, q, k, v, causal=causal, q_chunk=self.attn_chunk,
            kv_chunk=self.attn_chunk, use_kernel=self.use_kernels)
        return x + self._wo(attn.reshape(B, S, -1), p_l["attn"]["wo"]), k, v

    # ------------------------------------------------------------- encoder
    def _encode(self, params, enc_embeds):
        """The encoder over ``enc_embeds`` (B, T, D): per layer
        bidirectional self-attention and the dense FFN, then
        ``enc_final_norm``.  Returns (B, T, D) in the model's dtype."""
        x = enc_embeds.to(self.dtype)
        B, T = x.shape[:2]
        positions = torch.arange(T, device=x.device)[None].expand(B, T)
        layers = params["encoder"]

        def unit(h, i):
            p_l = layers[i]
            h, _, _ = self._self_attn(p_l, h, positions, causal=False)
            return self._ffn_block(p_l, h)[0]
        for i in range(len(layers)):
            x = self._remat(functools.partial(unit, i=i), x,
                            tree=_raw(layers, i))
        return self._norm(params["enc_final_norm"], x)

    def _cross_kv(self, params, enc_out):
        """Every decoder layer's cross-attention keys and values of the
        encoder output ``enc_out`` (B, T, D): ``{"xk", "xv"}`` (L, B, T,
        KVH, hd) in ``kv_dtype``."""
        cfg = self.cfg
        B, T, _ = enc_out.shape
        kvd = dtype_of(self.kv_dtype)
        enc_out = C.copy_to(enc_out, "model")     # column-parallel wk, wv
        kv_slots, rep = (self.heads or (0, 0, 1))[1:]
        xk, xv = [], []
        for i in range(len(params["cross"])):
            for name, out in (("wk", xk), ("wv", xv)):
                w = _part(params["cross"], i, "xattn", name)
                t = enc_out @ C.copy_to_replicas(w, rep)
                out.append(L.pad_heads(t.reshape(
                    B, T, t.shape[-1] // cfg.hd, cfg.hd), kv_slots).to(kvd))
        return {"xk": torch.stack(xk), "xv": torch.stack(xv)}

    def _enc_ctx(self, params, batch):
        """The cross K/V of ``batch["enc_embeds"]`` for an encoder-decoder,
        else None."""
        if not self.cfg.is_encoder_decoder:
            return None
        return self._cross_kv(params, self._encode(params,
                                                   batch["enc_embeds"]))

    def _apply_cross(self, p_x, x, xk, xv):
        """``x`` (B, S, D) plus one decoder layer's cross-attention over
        ``xk``/``xv`` (B, T, KVH, hd): ``lnx``, a query projection without
        RoPE, non-causal attention (plain torch: the reference has no
        Pallas kernel here) and ``wo``."""
        cfg = self.cfg
        h = self._norm(p_x["lnx"], x)
        B, S, _ = h.shape
        q = C.copy_to(h, "model") @ p_x["xattn"]["wq"]
        q = L.pad_heads(q.reshape(B, S, q.shape[-1] // cfg.hd, cfg.hd),
                        (self.heads or (0,))[0])
        attn = L.full_attention(cfg, q, xk.to(self.dtype), xv.to(self.dtype),
                                causal=False)
        return x + self._wo(attn.reshape(B, S, -1), p_x["xattn"]["wo"])

    def _run_stack_full(self, params, x, positions, want_cache=False,
                        enc_ctx=None):
        """The decoder stack over whole sequences: per layer ``i`` its
        ``cfg.layer_kind(i)`` mixer (``ln1``, then causal
        ``chunked_attention`` and ``wo``, or the Mamba-2 block over the
        whole sequence), with ``enc_ctx`` (an encoder-decoder's ``{"xk",
        "xv"}``) the cross sublayer, then its ``cfg.ffn_kind(i)`` FFN
        block, one remat unit a layer (:meth:`_remat`; the hybrid family's
        unit is an 8-layer group, as the reference's scan body).  Returns
        ``(x, moe_aux, caches)``: aux is the layers' MoE aux losses summed
        in layer order (0 without experts); with ``want_cache``, caches
        holds the attention layers' projected ``k``/``v`` and the Mamba
        layers' final ``conv``/``ssm`` state in the reference's layout
        (:meth:`_stack_caches`), else None."""
        layers = params["layers"]
        step = HYBRID_GROUP if self.cfg.family == "hybrid" else 1
        kv, states = [], []
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        def unit(h, *xkv, lis):
            out = []
            for li in lis:
                h, part, aux_l = self._layer_full(params, li, h, positions,
                                                  xkv, want_cache)
                out.append((part, aux_l))
            return h, out
        for lo in range(0, len(layers), step):
            lis = range(lo, min(lo + step, len(layers)))
            xkv = (() if enc_ctx is None else
                   (enc_ctx["xk"][lo], enc_ctx["xv"][lo]))
            x, out = self._remat(functools.partial(unit, lis=lis), x, *xkv,
                                 tree=[_raw(layers, li) for li in lis])
            for li, (part, aux_l) in zip(lis, out):
                if want_cache:
                    (kv if self.cfg.layer_kind(li) == "attn"
                     else states).append(part)
                if aux_l is not None:
                    aux = aux + aux_l
        caches = self._stack_caches(kv, states) if want_cache else None
        return x, aux, caches

    def _layer_full(self, params, li, x, positions, xkv, want_cache):
        """Decoder layer ``li`` over whole sequences (its params gathered
        here under FSDP): ``(x, part, aux)``, ``part`` its cache part
        (``(k, v)`` or the Mamba state; None without ``want_cache``) and
        ``aux`` its MoE aux loss (None without experts); ``xkv`` is an
        encoder-decoder's cross ``(xk, xv)`` of the layer, else empty."""
        p_l = params["layers"][li]
        if self.cfg.layer_kind(li) == "attn":
            x, k, v = self._self_attn(p_l, x, positions, causal=True)
            part = (k, v)
        else:
            out, part = M.mamba_block(
                self.cfg, p_l["ssm"], self._norm(p_l["ln1"], x),
                chunk=self.ssd_chunk, return_state=True,
                use_kernel=self.use_kernels)
            x = x + out
        if xkv:
            # the parts of the cross sublayer it reads (its wk and wv made
            # the cross K/V already)
            p_x = {"lnx": _part(params["cross"], li, "lnx"),
                   "xattn": {w: _part(params["cross"], li, "xattn", w)
                             for w in ("wq", "wo")}}
            x = self._apply_cross(p_x, x, *xkv)
        x, aux_l = self._ffn_block(p_l, x)
        return x, (part if want_cache else None), aux_l

    def _stack_caches(self, kv, states):
        """The per-layer ``(k, v)`` (B, S, KVH, hd) and Mamba ``{"conv",
        "ssm"}`` states, in layer order, stacked as the reference's
        ``_pack_cache`` lays them out: ``k``/``v`` (L, B, S, KVH, hd) and
        ``conv``/``ssm`` (L, B, ...); for the hybrid family ``k``/``v``
        (g, B, S, KVH, hd), one attention layer a group, and ``conv``/
        ``ssm`` (g, 7, B, ...)."""
        out = {}
        if kv:
            out["k"] = torch.stack([k for k, _ in kv])
            out["v"] = torch.stack([v for _, v in kv])
        if states:
            for key in ("conv", "ssm"):
                t = torch.stack([st[key] for st in states])
                if self.cfg.family == "hybrid":
                    t = t.reshape(-1, len(HYBRID_SSM_J), *t.shape[1:])
                out[key] = t
        return out

    def _slot(self, li: int):
        """Layer ``li``'s index into the cache: into ``k``/``v`` for an
        attention layer, ``conv``/``ssm`` for a Mamba layer (the layer
        itself; for the hybrid family its group, and the group's Mamba
        layer ``HYBRID_SSM_J.index(j)`` for a Mamba layer)."""
        if self.cfg.family != "hybrid":
            return li
        g, j = divmod(li, HYBRID_GROUP)
        if self.cfg.layer_kind(li) == "attn":
            return g
        return g, HYBRID_SSM_J.index(j)

    # ------------------------------------------------------ chunked prefill
    def supports_chunked_prefill(self) -> bool:
        """Chunked (resumable) prefill covers the attention-family decoder;
        an SSM state (the ``ssm`` and hybrid families) would need a
        cross-chunk handoff and an encoder-decoder carries a static cross
        cache, so they prefill monolithically (:meth:`prefill`)."""
        return (self.cfg.family not in ("ssm", "hybrid")
                and not self.cfg.is_encoder_decoder)

    def supports_paged(self) -> bool:
        """Paged KV covers the attention-family decoder; SSM state is
        constant-size (paging buys nothing) and an encoder-decoder carries
        a static cross cache: they live in the dense backend."""
        return self.supports_chunked_prefill()

    def _unsupported(self, what: str) -> ValueError:
        """The reference's refusal of ``what`` for this model's family."""
        cfg = self.cfg
        return ValueError(f"{what} unsupported for family={cfg.family} "
                          f"enc_dec={cfg.is_encoder_decoder}")

    def _chunk_attn(self, q, k_all, v_all, q_pos, kv_pos, start):
        """Attention for one prefill chunk.

        ``q``: (B, C, H, hd); ``k_all``/``v_all``: (B, Smax, KVH, hd);
        ``q_pos``/``kv_pos``: (B, C)/(B, Smax); ``start``: (B,) int32.
        ``masked`` materializes the C x Smax score matrix with the causal
        position mask (the bit-identity reference); ``flash`` runs the
        prefix flash-attention kernel over transposed views (no copy).
        """
        if self.chunk_attn_impl == "flash":
            out = flash_prefill_prefix(
                q.transpose(1, 2),                       # (B, H, C, hd)
                k_all.to(q.dtype).transpose(1, 2),
                v_all.to(q.dtype).transpose(1, 2), start)
            return out.transpose(1, 2)                   # (B, C, H, hd)
        return L.full_attention(self.cfg, q, k_all, v_all, causal=True,
                                q_positions=q_pos, kv_positions=kv_pos)

    @_one_rank
    @torch.no_grad()
    def paged_prefill_chunk(self, params, kv, tokens, block_tables,
                            write_page, write_off, start, chunk_len):
        """One resumable prefill chunk whose KV lands in the page pool.

        ``kv``: {"k","v"} (L, num_pages, page, KVH, hd), written **in
        place**; ``tokens``: (1, C) right-padded past ``chunk_len``;
        ``block_tables``: (1, max_pages) int32, unused entries at the
        scratch page; ``write_page``/``write_off``: (C,) physical
        destination of each chunk token (scratch for padded rows).  The
        chunk's queries sit at absolute positions ``start + i`` and attend
        the request's pages gathered in logical order.  ``start`` and
        ``chunk_len`` are ints or (1,) integer tensors on the model's device
        (the engine's captured chunk passes tensors, so no host value is
        baked into its graph).  Returns the last-position logits (1, V)
        float32, taken at ``chunk_len - 1``.
        """
        if not self.supports_chunked_prefill():
            raise self._unsupported("chunked prefill")
        cfg = self.cfg
        dev = tokens.device
        C = tokens.shape[1]
        page = kv["k"].shape[2]
        n_pages = block_tables.shape[1]
        Smax = n_pages * page
        start_vec = _scalar(start, dev)
        x = self._embed_in(params, tokens)
        q_pos = start_vec.long()[:, None] + torch.arange(C, device=dev)[None]
        kv_pos = torch.arange(Smax, device=dev)[None, :]
        wp, wo = write_page.long(), write_off.long()
        tables = block_tables[0].long()
        for li, p_l in enumerate(params["layers"]):
            k_pool, v_pool = kv["k"][li], kv["v"][li]
            h1 = self._norm(p_l["ln1"], x)
            q, k, v = L._project_qkv(cfg, p_l["attn"], h1, q_pos)
            k_pool.index_put_((wp, wo), k[0].to(k_pool.dtype))
            v_pool.index_put_((wp, wo), v[0].to(v_pool.dtype))
            kg = k_pool[tables].reshape(1, Smax, *k_pool.shape[2:])
            vg = v_pool[tables].reshape(1, Smax, *v_pool.shape[2:])
            attn = self._chunk_attn(q, kg, vg, q_pos, kv_pos, start_vec)
            x = x + self._wo(attn.reshape(1, C, -1), p_l["attn"]["wo"])
            x, _ = self._ffn_block(p_l, x)
        return self._last_logits(params, x, chunk_len)

    def _last_logits(self, params, x, chunk_len):
        """The logits (N, V) float32 of each row's chunk position
        ``chunk_len - 1`` (clamped to the chunk), selected by a device
        index.  ``x``: (N, C, D); ``chunk_len``: an int (N = 1) or an (N,)
        integer tensor."""
        N, C, D = x.shape
        n = (chunk_len.reshape(N) if isinstance(chunk_len, torch.Tensor)
             else _scalar(chunk_len, x.device))
        last = (n.to(x.device).long() - 1).clamp(0, C - 1)
        x_last = x.gather(1, last.view(N, 1, 1).expand(N, 1, D))[:, 0]
        x_last = self._norm(params["final_norm"], x_last)
        return self._logits(params, x_last).float()

    # ------------------------------------------------------- paged decode
    @_one_rank
    @torch.no_grad()
    def paged_decode_step(self, params, kv, tokens, block_tables, lengths,
                          write_page, write_off, *,
                          attn_impl: str = "gather"):
        """One decode iteration over the paged KV pool.

        ``kv``: {"k","v"} (L, num_pages, page, KVH, hd), written **in
        place**; ``tokens`` (B, 1); ``block_tables`` (B, max_pages) int32
        with unused entries at a sacrificial page; ``lengths`` (B,) int32
        tokens already written, so the fed token's KV lands at logical
        position ``lengths`` = physical ``(write_page, write_off)``.

        ``attn_impl="gather"`` materializes the pages in logical order and
        runs :func:`layers.decode_attention` (the bit-exact reference);
        ``"kernel"`` runs the paged-attention kernel over the block table,
        called with ``lengths + 1`` (the count including the new token).
        Returns logits (B, V) float32.
        """
        if attn_impl not in ("gather", "kernel"):
            raise ValueError(f"attn_impl={attn_impl!r}")
        if not self.supports_paged():
            raise self._unsupported("paged decode")
        cfg = self.cfg
        B = tokens.shape[0]
        page = kv["k"].shape[2]
        x = self._embed_in(params, tokens)
        positions = lengths[:, None]
        wp, wo = write_page.long(), write_off.long()
        lens1 = (lengths + 1).to(torch.int32)
        tables_l = block_tables.long()
        n_pages = block_tables.shape[1]
        src = _last_writer(wp, wo)      # inactive lanes share the scratch
        for li, p_l in enumerate(params["layers"]):
            k_pool, v_pool = kv["k"][li], kv["v"][li]
            h1 = self._norm(p_l["ln1"], x)
            q, k, v = L._project_qkv(cfg, p_l["attn"], h1, positions)
            k, v = k[src, 0], v[src, 0]
            k_pool.index_put_((wp, wo), k.to(k_pool.dtype))
            v_pool.index_put_((wp, wo), v.to(v_pool.dtype))
            if attn_impl == "kernel":
                attn = paged_attention(q[:, 0].contiguous(), k_pool, v_pool,
                                       block_tables, lens1)
            else:
                kg = k_pool[tables_l].reshape(B, n_pages * page,
                                              *k_pool.shape[2:])
                vg = v_pool[tables_l].reshape(B, n_pages * page,
                                              *v_pool.shape[2:])
                attn = L.decode_attention(cfg, q[:, 0], kg, vg, lens1)
            x = x + self._wo(attn.reshape(B, -1), p_l["attn"]["wo"])[:, None, :]
            x, _ = self._ffn_block(p_l, x, groups=1)
        x = self._norm(params["final_norm"], x[:, -1, :])
        return self._logits(params, x).float()

    def paged_decode_step_sampled(self, params, kv, tokens, block_tables,
                                  lengths, write_page, write_off, active,
                                  new_gen, new_ctx, true_len, rids, *,
                                  attn_impl: str = "gather", seed: int = 0,
                                  greedy_sampling=True, temp: float = 1.0,
                                  top_k: int = 0, eos_token: int = 1,
                                  max_new_tokens: int = 128,
                                  max_seq_len: int = 256):
        """Fused paged decode: decode + sample + terminate on the device.
        Each lane's draw is named by ``(rids, new_gen - 1)``.  Inactive
        lanes get reason 0.  Returns ``(sampled (B,), reason (B,))`` int32
        tensors on the model's device."""
        logits = self.paged_decode_step(
            params, kv, tokens, block_tables, lengths, write_page, write_off,
            attn_impl=attn_impl)
        tok, reason = sample_and_reason(
            logits, rids, new_gen - 1, greedy_sampling=greedy_sampling,
            seed=seed, temp=temp, top_k=top_k, eos_token=eos_token,
            max_new_tokens=max_new_tokens, max_seq_len=max_seq_len,
            new_gen=new_gen, new_ctx=new_ctx, true_len=true_len)
        return tok, torch.where(active, reason, torch.zeros_like(reason))

    # -------------------------------------------------- speculative decode
    def supports_spec_decode(self) -> bool:
        """Verify-k decode shares chunked prefill's requirements: scoring
        k+1 positions against cached K/V is a (tiny) prefill chunk."""
        return self.supports_chunked_prefill()

    def _check_spec(self) -> None:
        if not self.supports_spec_decode():
            raise self._unsupported("verify-k decode")

    @_one_rank
    @torch.no_grad()
    def paged_decode_verify(self, params, kv, tokens, block_tables, lengths,
                            write_page, write_off):
        """Score K1 = k+1 decode positions per lane over the page pool.

        ``kv``: {"k","v"} (L, num_pages, page, KVH, hd), written **in
        place**; ``tokens``: (B, K1), column 0 each lane's fed token,
        columns 1..k its drafts; ``block_tables``: (B, max_pages + 1) with
        the lane's scratch page right after its real pages, so a
        scratch-resident position's gather index equals its logical
        position; ``lengths``: (B,) int32; ``write_page``/``write_off``:
        (B, K1) host-computed physical destination of each position (an
        inactive lane's at the backend's shared scratch page).  Position
        ``i`` sits at ``lengths + i`` and attends the lane's pages gathered
        in logical order through :meth:`_chunk_attn` (the prefix flash
        kernel on the card), as :meth:`paged_prefill_pack` does; stale
        scratch offsets lie past every query and are causally masked.
        Returns logits (B, K1, V) float32."""
        if not (self.supports_spec_decode() and self.supports_paged()):
            raise self._unsupported("paged verify-k")
        cfg = self.cfg
        B, K1 = tokens.shape
        page = kv["k"].shape[2]
        Smax = block_tables.shape[1] * page
        dev = tokens.device
        start = lengths.reshape(B).to(torch.int32)  # as the flash kernel takes
        x = self._embed_in(params, tokens)
        q_pos = start.long()[:, None] + torch.arange(K1, device=dev)[None]
        kv_pos = torch.arange(Smax, device=dev)[None, :]
        wp, wo = write_page.long(), write_off.long()
        tables = block_tables.long()
        src = _last_writer(wp, wo)      # inactive lanes share the scratch
        for li, p_l in enumerate(params["layers"]):
            k_pool, v_pool = kv["k"][li], kv["v"][li]
            h1 = self._norm(p_l["ln1"], x)
            q, k, v = L._project_qkv(cfg, p_l["attn"], h1, q_pos)
            k = k.reshape(B * K1, *k.shape[2:])[src].reshape(k.shape)
            v = v.reshape(B * K1, *v.shape[2:])[src].reshape(v.shape)
            k_pool.index_put_((wp, wo), k.to(k_pool.dtype))
            v_pool.index_put_((wp, wo), v.to(v_pool.dtype))
            kg = k_pool[tables].reshape(B, Smax, *k_pool.shape[2:])
            vg = v_pool[tables].reshape(B, Smax, *v_pool.shape[2:])
            attn = self._chunk_attn(q, kg, vg, q_pos, kv_pos, start)
            x = x + self._wo(attn.reshape(B, K1, -1), p_l["attn"]["wo"])
            x, _ = self._ffn_block(p_l, x)
        x = self._norm(params["final_norm"], x)
        return self._logits(params, x).float()

    def paged_decode_verify_sampled(self, params, kv, tokens, block_tables,
                                    lengths, write_page, write_off, n_drafts,
                                    active, base_gen, base_ctx, true_len,
                                    rids, *, seed: int = 0,
                                    greedy_sampling=True, temp: float = 1.0,
                                    top_k: int = 0, eos_token: int = 1,
                                    max_new_tokens: int = 128,
                                    max_seq_len: int = 256):
        """Fused paged verify-k: score + sample + accept + terminate on the
        device.  The paged backend keeps lengths on the host and commits
        page-table state after the sync.  Returns ``(samples (B, K1),
        n_emit (B,), reason (B,))`` int32."""
        logits = self.paged_decode_verify(params, kv, tokens, block_tables,
                                          lengths, write_page, write_off)
        return verify_and_reason(
            logits, tokens, n_drafts, rids, active, seed=seed,
            greedy_sampling=greedy_sampling, temp=temp, top_k=top_k,
            eos_token=eos_token, max_new_tokens=max_new_tokens,
            max_seq_len=max_seq_len, base_gen=base_gen, base_ctx=base_ctx,
            true_len=true_len)

    # ------------------------------------------------- monolithic prefill
    @_sharded
    @torch.no_grad()
    def prefill(self, params, batch):
        """Process whole prompts in one pass; return (last-token logits
        (B, V) float32, cache), the cache in the reference's
        ``_pack_cache`` layout with ``lengths`` (B,) int32 = S.

        Attention family: ``batch`` holds ``tokens`` (B, S) or, for an
        ``embeds`` model, ``embeds`` (B, S, D), right-padded where
        ``last_index`` (B,) names each row's true last position (its
        logits are returned); the stack's attention is
        ``layers.chunked_attention`` (the flash kernel on the card).  The
        cache holds every layer's ``k``/``v`` (L, B, S, KVH, hd) in
        ``kv_dtype``, padded positions included (the serving engine
        prefills attention prompts through :meth:`prefill_chunk` instead).
        An encoder-decoder takes ``enc_embeds`` (B, T, D) and the decoder's
        ``tokens`` (a 1-token start); its encoder runs bidirectional
        ``chunked_attention`` and the cache adds every decoder layer's
        cross ``xk``/``xv`` (L, B, T, KVH, hd) in ``kv_dtype``.

        ``ssm`` and hybrid: ``tokens`` unpadded (an SSM state depends on
        every step); the cache holds the Mamba layers' ``conv`` (L, B, W-1,
        Ch) in the working dtype and ``ssm`` (L, B, H, P, N) float32, for
        the hybrid family ``conv``/``ssm`` (g, 7, B, ...) and the
        attention layers' ``k``/``v`` (g, B, S, KVH, hd)."""
        x = self._embed_in(params, batch.get("tokens"), batch.get("embeds"))
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        enc_ctx = self._enc_ctx(params, batch)
        x, _, caches = self._run_stack_full(params, x, positions,
                                            want_cache=True, enc_ctx=enc_ctx)
        last = batch.get("last_index")
        if last is not None:
            x_last = x[torch.arange(B, device=x.device), last.long()]
        else:
            x_last = x[:, -1, :]
        x_last = self._norm(params["final_norm"], x_last)
        kvd = dtype_of(self.kv_dtype)
        cache = {"lengths": torch.full((B,), S, dtype=torch.int32,
                                       device=x.device),
                 **{k: t.to(kvd) if k in ("k", "v") else t
                    for k, t in caches.items()},
                 **(enc_ctx or {})}
        return self._logits(params, x_last).float(), cache

    @_one_rank
    @torch.no_grad()
    def prefill_chunk(self, params, k_stripe, v_stripe, tokens, start,
                      chunk_len):
        """One resumable prefill chunk over one lane's dense KV stripe.

        ``k_stripe``/``v_stripe``: (L, Smax, KVH, hd), the lane's stripes
        (views into the cache) with positions ``[0, start)`` written by
        earlier chunks; written **in place**.  ``tokens``: (1, C),
        right-padded past ``chunk_len``; ``start`` and ``chunk_len`` ints
        or (1,) integer tensors on the model's device.  The chunk's KV
        lands at ``[start, start + C)`` (rows past Smax are dropped, as the
        reference's scatter drops them) and each query at ``start + i``
        attends the stripe's keys ``j <= start + i`` through
        :meth:`_chunk_attn`, so stale positions never reach the output.

        The rows are written through a device index, so no host value is
        baked into a captured graph: row i goes to ``(start + i) mod
        Smax``, with its new value where ``start + i < Smax`` and otherwise
        the old value of that row (one below ``start``).  The first
        ``min(C, Smax)`` rows have distinct indices (rows past them lie
        past Smax), so the scatter is deterministic.  Returns the logits
        (1, V) float32 at ``chunk_len - 1``."""
        if not self.supports_chunked_prefill():
            raise self._unsupported("chunked prefill")
        cfg = self.cfg
        dev = tokens.device
        C = tokens.shape[1]
        Smax = k_stripe.shape[1]
        start_vec = _scalar(start, dev)
        x = self._embed_in(params, tokens)
        q_pos = start_vec.long()[:, None] + torch.arange(C, device=dev)[None]
        kv_pos = torch.arange(Smax, device=dev)[None, :]
        n = min(C, Smax)                     # rows that may land
        rows = q_pos[0, :n] % Smax
        inside = (q_pos[0, :n] < Smax)[:, None, None]
        for li, p_l in enumerate(params["layers"]):
            k_l, v_l = k_stripe[li], v_stripe[li]
            h1 = self._norm(p_l["ln1"], x)
            q, k, v = L._project_qkv(cfg, p_l["attn"], h1, q_pos)
            k_l.index_put_((rows,), torch.where(
                inside, k[0, :n].to(k_l.dtype), k_l[rows]))
            v_l.index_put_((rows,), torch.where(
                inside, v[0, :n].to(v_l.dtype), v_l[rows]))
            attn = self._chunk_attn(q, k_l[None], v_l[None], q_pos, kv_pos,
                                    start_vec)
            x = x + self._wo(attn.reshape(1, C, -1), p_l["attn"]["wo"])
            x, _ = self._ffn_block(p_l, x)
        return self._last_logits(params, x, chunk_len)

    # ------------------------------------------------------ packed prefill
    def supports_prefill_pack(self) -> bool:
        """Packed prefill runs several requests' chunks as the rows of one
        batch.  Attention, the norms and the dense FFN treat rows
        independently, so each row computes what its single chunk would;
        an MoE's expert capacity depends on the total token count, so
        packing covers the dense-FFN chunked-prefill family."""
        return self.supports_chunked_prefill() and not self.cfg.has_moe

    def _check_pack(self) -> None:
        if not self.supports_prefill_pack():
            cfg = self.cfg
            raise ValueError(
                f"packed prefill unsupported for family={cfg.family} "
                f"moe={cfg.has_moe} enc_dec={cfg.is_encoder_decoder}")

    @_one_rank
    @torch.no_grad()
    def prefill_pack(self, params, k_cache, v_cache, lanes, tokens, start,
                     chunk_len):
        """N prefill chunks of distinct requests in one call over the
        dense cache: the batched twin of :meth:`prefill_chunk`, row ``i``
        computing what its own chunk would over its lane's stripe.

        ``k_cache``/``v_cache``: (L, lanes, Smax, KVH, hd), written **in
        place**; ``lanes``, ``start`` and ``chunk_len``: (N,) integer
        tensors on the model's device (so no host value is baked into a
        captured graph); ``tokens``: (N, C) right-padded.  Per layer the N
        stripes are gathered into a scratch (N, Smax, KVH, hd) (one layer
        at a time: the reference gathers every layer's stripes up front),
        each row's chunk K/V written at ``(start + i) mod Smax`` (the old
        value where ``start + i >= Smax``, as :meth:`prefill_chunk`), the
        chunk attends its gathered stripe through :meth:`_chunk_attn`, and
        the written rows go back to the cache.

        A row with ``chunk_len`` 0 is pack padding: its outputs are
        garbage the caller discards, and its write-back is masked by
        writing row 0's rows again (the same indices and the same values,
        so the duplicate scatter is deterministic) in place of its own.
        Row 0 must be a member, or a row with ``start >= Smax``, which
        writes only old values (a pack that changes nothing).  Returns the
        last-position logits (N, V) float32."""
        self._check_pack()
        cfg = self.cfg
        dev = tokens.device
        N, C = tokens.shape
        Smax = k_cache.shape[2]
        start = start.reshape(N).to(torch.int32)   # as the flash kernel takes
        x = self._embed_in(params, tokens)
        q_pos = start.long()[:, None] + torch.arange(C, device=dev)[None]
        kv_pos = torch.arange(Smax, device=dev)[None, :]
        n = min(C, Smax)                     # rows that may land
        rows = q_pos[:, :n] % Smax                              # (N, n)
        inside = (q_pos[:, :n] < Smax)[..., None, None]
        ar = torch.arange(N, device=dev)
        src = torch.where(chunk_len.reshape(N) > 0, ar, torch.zeros_like(ar))
        lanes = lanes.reshape(N).long()
        dst = (lanes[src][:, None].expand(N, n), rows[src])
        for li, p_l in enumerate(params["layers"]):
            h1 = self._norm(p_l["ln1"], x)
            q, k, v = L._project_qkv(cfg, p_l["attn"], h1, q_pos)
            kg = k_cache[li].index_select(0, lanes)     # (N, Smax, KVH, hd)
            vg = v_cache[li].index_select(0, lanes)
            for g, new in ((kg, k), (vg, v)):
                g[ar[:, None], rows] = torch.where(
                    inside, new[:, :n].to(g.dtype), g[ar[:, None], rows])
            attn = self._chunk_attn(q, kg, vg, q_pos, kv_pos, start)
            k_cache[li].index_put_(dst, kg[src[:, None], rows[src]])
            v_cache[li].index_put_(dst, vg[src[:, None], rows[src]])
            x = x + self._wo(attn.reshape(N, C, -1), p_l["attn"]["wo"])
            x, _ = self._ffn_block(p_l, x)
        return self._last_logits(params, x, chunk_len)

    @_one_rank
    @torch.no_grad()
    def paged_prefill_pack(self, params, kv, tokens, block_tables,
                           write_page, write_off, start, chunk_len):
        """N prefill chunks of distinct requests in one call whose K/V
        lands in the page pool: the batched twin of
        :meth:`paged_prefill_chunk`.

        ``kv``: {"k","v"} (L, num_pages, page, KVH, hd), written **in
        place**; ``tokens``: (N, C); ``block_tables``: (N, max_pages) with
        unused entries at the scratch page; ``write_page``/``write_off``:
        (N, C) physical destination of each token (the scratch page for
        padded columns and for pack-padding rows, which carry
        ``chunk_len`` 0); ``start``/``chunk_len``: (N,) integer tensors on
        the model's device.  Returns the last-position logits (N, V)
        float32."""
        self._check_pack()
        cfg = self.cfg
        dev = tokens.device
        N, C = tokens.shape
        page = kv["k"].shape[2]
        Smax = block_tables.shape[1] * page
        start = start.reshape(N).to(torch.int32)   # as the flash kernel takes
        x = self._embed_in(params, tokens)
        q_pos = start.long()[:, None] + torch.arange(C, device=dev)[None]
        kv_pos = torch.arange(Smax, device=dev)[None, :]
        wp, wo = write_page.long(), write_off.long()
        tables = block_tables.long()
        for li, p_l in enumerate(params["layers"]):
            k_pool, v_pool = kv["k"][li], kv["v"][li]
            h1 = self._norm(p_l["ln1"], x)
            q, k, v = L._project_qkv(cfg, p_l["attn"], h1, q_pos)
            k_pool.index_put_((wp, wo), k.to(k_pool.dtype))
            v_pool.index_put_((wp, wo), v.to(v_pool.dtype))
            kg = k_pool[tables].reshape(N, Smax, *k_pool.shape[2:])
            vg = v_pool[tables].reshape(N, Smax, *v_pool.shape[2:])
            attn = self._chunk_attn(q, kg, vg, q_pos, kv_pos, start)
            x = x + self._wo(attn.reshape(N, C, -1), p_l["attn"]["wo"])
            x, _ = self._ffn_block(p_l, x)
        return self._last_logits(params, x, chunk_len)

    # ------------------------------------------------------- dense decode
    @_sharded
    @torch.no_grad()
    def decode_step(self, params, cache, tokens, active=None, *,
                    seq_split: bool = False):
        """One decode iteration over the dense cache, written **in place**.
        ``tokens`` (B, 1).  Returns logits (B, V) float32.

        ``seq_split`` (on a mesh; the long-context cell, global batch 1,
        whose cache spec splits the KV sequence over ``data``): every rank
        of the batch axes takes the whole batch, and rank d of ``data``
        holds positions ``[d Smax, (d+1) Smax)`` of each ``k``/``v``
        (``Smax`` its cache's).  The rank that holds position ``lengths``
        writes the new K/V; ``layers.decode_attention`` merges the ranks'
        partial softmaxes over their valid positions.
        The Mamba state is whole on every rank, as the reference's spec.

        Each layer's mixer is its ``cfg.layer_kind``'s.  Attention: each
        lane's new K/V is written at ``lengths`` and it attends ``lengths
        + 1`` positions through ``layers.decode_attention``.  That
        attention is plain torch, as in the reference (jnp there, no
        Pallas kernel); the norms take the RMSNorm kernel.  An
        encoder-decoder's layer then attends its lane's cross ``xk``/``xv``
        (read only, plain torch as in the reference) before the FFN.
        Mamba (the ``ssm`` and hybrid families): the conv window and SSM
        state advance one step (a state leaf narrower than float32, as
        ``ssm_state_dtype`` makes it, is replaced in ``cache`` by a float32
        one first: the one write here that is not in place, which no
        serving backend meets, since they refuse such a state).

        ``active`` (B,) bool, when given, limits the writes and the
        ``lengths`` advance to active lanes: an inactive lane's state or
        stripe (a request prefilled this iteration, or a free lane) is left
        as it was.  An inactive lane still attends its new K/V, written
        before attention as the reference's step writes every lane and put
        back after it: an MoE lane's expert choices, and with them the
        capacity its step's other tokens get, follow from that attention
        (an inactive lane's Mamba state is not stepped, where the
        reference steps it with the fed token).  Without ``active`` every
        lane advances, as the reference's ``decode_step`` (a lane at
        ``lengths == Smax`` writes nothing, as the reference's scatter
        drops it)."""
        cfg = self.cfg
        if "ssm" in cache and cache["ssm"].dtype != torch.float32:
            # the step computes the state in float32 and returns it so, as
            # the reference's: a narrower state leaf is replaced by its
            # float32 copy, which the layers then write
            cache["ssm"] = cache["ssm"].float()
        x = self._embed_in(params, tokens)                      # (B, 1, D)
        at = (self._decode_rows(cache["lengths"], cache["k"].shape[2], active,
                                seq_split) if "k" in cache else None)
        for li, p_l in enumerate(params["layers"]):
            slot = self._slot(li)
            if cfg.layer_kind(li) == "attn":
                x = self._attn_decode(p_l, cache["k"][slot], cache["v"][slot],
                                      x, at)
            else:
                x = self._ssm_decode(p_l, cache["conv"][slot],
                                     cache["ssm"][slot], x, active)
            if cfg.is_encoder_decoder:
                x = self._apply_cross(params["cross"][li], x,
                                      cache["xk"][li], cache["xv"][li])
            x, _ = self._ffn_block(p_l, x, groups=1)
        cache["lengths"] += (1 if active is None
                             else active.to(cache["lengths"].dtype))
        x = self._norm(params["final_norm"], x[:, -1, :])
        return self._logits(params, x).float()

    @staticmethod
    def _decode_rows(lengths, Smax: int, active, seq_split: bool = False):
        """What every attention layer of a decode step shares: ``(lengths,
        lanes, pos, inside, keep, valid, seq_split)``, each lane's write
        row ``pos`` of this rank's stripe, whether it lands (``inside``),
        whether it stays (``keep``: None without ``active``) and the
        stripe's positions it attends (``valid``).  With ``seq_split`` the
        stripe holds this rank's block of the positions (rank d of
        ``data``: from d Smax)."""
        B = lengths.shape[0]
        first = C.axis_index("seq")[0] * Smax if seq_split else 0
        local = lengths.long() - first
        inside = ((local >= 0) & (local < Smax)).view(B, 1, 1)
        keep = None if active is None else inside & active.view(B, 1, 1)
        return (lengths, torch.arange(B, device=lengths.device),
                local.clamp(0, Smax - 1), inside, keep,
                (local + 1).clamp(0, Smax), seq_split)

    def _attn_decode(self, p_l, kc, vc, x, rows):
        """``x`` (B, 1, D) plus one attention layer's decode over its
        stripes ``kc``/``vc`` (B, Smax, KVH, hd), written in place at
        :meth:`_decode_rows`' ``rows``."""
        lengths, lanes, pos, inside, keep, valid, seq_split = rows
        B = x.shape[0]
        h1 = self._norm(p_l["ln1"], x)
        q, k, v = L._project_qkv(self.cfg, p_l["attn"], h1,
                                 lengths[:, None], heads=self.heads)
        new = ((kc, k[:, 0]), (vc, v[:, 0]))
        old = [dst[lanes, pos] for dst, _ in new]
        for (dst, src), o in zip(new, old):
            dst[lanes, pos] = torch.where(inside, src.to(dst.dtype), o)
        attn = L.decode_attention(self.cfg, q[:, 0], kc, vc, valid,
                                  over="seq" if seq_split else None)
        if keep is not None:             # inactive lanes keep their K/V
            for (dst, src), o in zip(new, old):
                dst[lanes, pos] = torch.where(keep, src.to(dst.dtype), o)
        return x + self._wo(attn.reshape(B, -1),
                            p_l["attn"]["wo"])[:, None, :]

    def _ssm_decode(self, p_l, conv, ssm, x, active):
        """``x`` (B, 1, D) plus one Mamba layer's recurrent step from its
        state ``conv``/``ssm`` (B, ...), written in place (active lanes
        only, when ``active`` is given)."""
        h = self._norm(p_l["ln1"], x)
        out, new = M.mamba_decode_step(self.cfg, p_l["ssm"], h[:, 0, :],
                                       {"conv": conv, "ssm": ssm},
                                       use_kernel=self.use_kernels)
        for dst, src in ((conv, new["conv"]), (ssm, new["ssm"])):
            if active is None:
                dst.copy_(src)
            else:
                keep = active.view(-1, *([1] * (src.dim() - 1)))
                dst.copy_(torch.where(keep, src.to(dst.dtype), dst))
        return x + out[:, None, :]

    def decode_step_sampled(self, params, cache, tokens, active, new_gen,
                            new_ctx, true_len, rids, *, seed: int = 0,
                            greedy_sampling=True, temp: float = 1.0,
                            top_k: int = 0, eos_token: int = 1,
                            max_new_tokens: int = 128,
                            max_seq_len: int = 256):
        """Fused dense decode: decode + sample + terminate on the device.
        Each lane's draw is named by ``(rids, new_gen - 1)``.  Inactive
        lanes keep their state and get reason 0.  Returns ``(sampled (B,),
        reason (B,))`` int32 tensors on the model's device."""
        logits = self.decode_step(params, cache, tokens, active)
        tok, reason = sample_and_reason(
            logits, rids, new_gen - 1, greedy_sampling=greedy_sampling,
            seed=seed, temp=temp, top_k=top_k, eos_token=eos_token,
            max_new_tokens=max_new_tokens, max_seq_len=max_seq_len,
            new_gen=new_gen, new_ctx=new_ctx, true_len=true_len)
        return tok, torch.where(active, reason, torch.zeros_like(reason))

    @_one_rank
    @torch.no_grad()
    def decode_verify(self, params, cache, tokens, active=None):
        """Score K1 = k+1 decode positions per lane over the dense cache.

        ``tokens``: (B, K1), column 0 each lane's fed token, columns 1..k
        its drafts.  Position ``i``'s K/V is written **in place** at
        ``lengths + i`` and it attends the lane's stripe causally through
        :meth:`_chunk_attn` (the prefix flash kernel on the card), so it
        sees the context the sequential path would have.  ``lengths`` is
        left unchanged: the caller commits accepted positions; rejected
        positions' K/V lies past the watermark, where nothing attends.

        Two differences from the reference, whose scatter writes every
        lane and silently drops positions past Smax: a position at or past
        Smax is dropped explicitly, and with ``active`` given an inactive
        lane keeps its stripe (it attends its new K/V all the same, put back
        after attention, as :meth:`decode_step` does).  Row ``i`` goes to
        ``(lengths + i) mod Smax``
        with the new value where it lands and the old one otherwise, so
        the K1 indices of a lane are distinct (K1 <= Smax) and no host
        value is baked into a captured graph.  Returns logits (B, K1, V)
        float32."""
        self._check_spec()
        cfg = self.cfg
        B, K1 = tokens.shape
        Smax = cache["k"].shape[2]
        dev = tokens.device
        start = cache["lengths"]
        x = self._embed_in(params, tokens)
        q_pos = start.long()[:, None] + torch.arange(K1, device=dev)[None]
        kv_pos = torch.arange(Smax, device=dev)[None, :]
        lanes = torch.arange(B, device=dev)[:, None]
        rows = q_pos % Smax
        inside = (q_pos < Smax)[..., None, None]
        keep = (inside if active is None
                else inside & active[:, None, None, None])
        for li, p_l in enumerate(params["layers"]):
            kc, vc = cache["k"][li], cache["v"][li]
            h1 = self._norm(p_l["ln1"], x)
            q, k, v = L._project_qkv(cfg, p_l["attn"], h1, q_pos)
            new = ((kc, k), (vc, v))
            old = [dst[lanes, rows] for dst, _ in new]
            for (dst, src), o in zip(new, old):
                dst[lanes, rows] = torch.where(inside, src.to(dst.dtype), o)
            attn = self._chunk_attn(q, kc, vc, q_pos, kv_pos, start)
            if active is not None:       # inactive lanes keep their K/V
                for (dst, src), o in zip(new, old):
                    dst[lanes, rows] = torch.where(keep, src.to(dst.dtype),
                                                   o)
            x = x + self._wo(attn.reshape(B, K1, -1), p_l["attn"]["wo"])
            x, _ = self._ffn_block(p_l, x)
        x = self._norm(params["final_norm"], x)
        return self._logits(params, x).float()

    def decode_verify_sampled(self, params, cache, tokens, n_drafts, active,
                              base_gen, base_ctx, true_len, rids, *,
                              seed: int = 0, greedy_sampling=True,
                              temp: float = 1.0, top_k: int = 0,
                              eos_token: int = 1, max_new_tokens: int = 128,
                              max_seq_len: int = 256):
        """Fused dense verify-k: score k+1 positions, sample each with its
        own draw, accept the longest exact-match draft prefix and resolve
        termination on the device; each lane's ``lengths`` advances by its
        ``n_emit`` (the last emitted token's K/V stays unwritten: the next
        step feeds it, as in plain decode).  Inactive lanes keep their
        state.  Returns ``(samples (B, K1), n_emit (B,), reason (B,))``
        int32."""
        logits = self.decode_verify(params, cache, tokens, active)
        s, n_emit, reason = verify_and_reason(
            logits, tokens, n_drafts, rids, active, seed=seed,
            greedy_sampling=greedy_sampling, temp=temp, top_k=top_k,
            eos_token=eos_token, max_new_tokens=max_new_tokens,
            max_seq_len=max_seq_len, base_gen=base_gen, base_ctx=base_ctx,
            true_len=true_len)
        cache["lengths"] += n_emit
        return s, n_emit, reason

    # --------------------------------------------------------- cache specs
    def cache_shapes(self, batch: int, max_len: int) -> Dict[str, Any]:
        """``{key: (shape, dtype)}`` of a dense decode cache for ``batch``
        lanes of ``max_len`` positions: ``k``/``v`` (L, batch, max_len,
        KVH, hd) in ``kv_dtype`` for the attention family (KVH/m on a mesh
        whose ``model`` axis has m ranks), and for an
        encoder-decoder the cross ``xk``/``xv`` (L, batch, cross_kv_len,
        KVH, hd); for ``ssm`` the constant-size ``conv`` and ``ssm`` state
        (``max_len`` unused; ``ssm`` in ``ssm_state_dtype``); for the
        hybrid family, per 8-layer group
        ``g``, ``k``/``v`` (g, batch, max_len, KVH, hd) and ``conv``/
        ``ssm`` (g, 7, batch, ...), the reference's layout.  On a mesh
        whose ``model`` axis has m ranks a rank's cache holds its heads:
        KVH/m of ``k``/``v`` and ``xk``/``xv`` (its KV head slots where
        the axis does not split them evenly: :attr:`heads`), its
        :attr:`ssm_heads` of ``ssm`` and the conv channels of those heads
        with B and C (their P columns each, + 2 N)."""
        cfg = self.cfg
        kvd = dtype_of(self.kv_dtype)
        n = cfg.num_layers
        m = self.mesh.sizes.get("model", 1) if self.mesh is not None else 1
        kvh = self.heads[1] if self.heads else cfg.num_kv_heads // m
        out: Dict[str, Any] = {"lengths": ((batch,), torch.int32)}
        if cfg.family != "ssm":
            n_kv = hybrid_groups(cfg) if cfg.family == "hybrid" else n
            shape = (n_kv, batch, max_len, kvh, cfg.hd)
            out["k"] = (shape, kvd)
            out["v"] = (shape, kvd)
        if cfg.family in ("ssm", "hybrid"):
            lead = ((hybrid_groups(cfg), len(HYBRID_SSM_J))
                    if cfg.family == "hybrid" else (n,))
            h = self.ssm_heads
            out["conv"] = ((*lead, batch, cfg.conv_width - 1,
                            h * cfg.ssm_headdim + 2 * cfg.ssm_state),
                           self.dtype)
            out["ssm"] = ((*lead, batch, h, cfg.ssm_headdim,
                           cfg.ssm_state), dtype_of(self.ssm_state_dtype))
        if cfg.is_encoder_decoder:
            xshape = (n, batch, cfg.cross_kv_len, kvh, cfg.hd)
            out["xk"] = (xshape, kvd)
            out["xv"] = (xshape, kvd)
        return out

    def init_cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        return {k: torch.zeros(shape, dtype=dt, device=self.device)
                for k, (shape, dt) in self.cache_shapes(batch,
                                                        max_len).items()}

    def decode_cache(self, prefilled, max_len: int) -> Dict[str, Any]:
        """A decode cache of ``max_len`` positions holding ``prefilled``
        (:meth:`prefill`'s cache of its S positions): its K/V at the first
        S positions, its ``lengths``, the recurrent state and the cross
        K/V whole.  The long-context cell's rank block of it, positions
        split over ``data``, is ``sharding.shard_leaf`` of each leaf by
        ``sharding.cache_layouts``."""
        full = self.init_cache(prefilled["lengths"].shape[0], max_len)
        for k, t in prefilled.items():
            if k in ("k", "v"):
                full[k][:, :, :t.shape[2]] = t
            else:
                full[k].copy_(t)
        return full
