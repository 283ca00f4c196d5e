"""Model assembly for the PyTorch port: the serving entry points of the
attention-family decoder (chunked paged prefill, fused paged decode) and
of the Mamba-2 (``ssm``) family (monolithic prefill, fused recurrent
decode over a dense state cache), and the training loss of the attention
family (dense FFN).

Parameters are a plain dict: ``embed``, ``final_norm.scale`` and a list
``layers`` with one dict per layer (``ln1`` and ``attn.{wq,wk,wv,wo}`` or
``ssm.*``, then ``ln2`` and ``ffn.*`` where the family has an FFN).  Where
the JAX reference runs ``lax.scan`` over layers stacked on axis 0, the
port loops over the list in Python.  Where the reference rebuilt the page
pool or the decode cache functionally and returned it, the port writes it
**in place** and returns only the logits.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.kernels.flash_prefill import flash_prefill_prefix
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.config import ArchConfig
from repro_torch.serving.sampler import sample_and_reason
from repro_torch.utils import dtype_of, resolve_device, tree_map

Params = Dict[str, Any]

MOE_AUX_COEF = 0.01
ZLOSS_COEF = 1e-4


def _to_tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":     # numpy has no bf16: go via f32
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)   # own, writable copy


def params_from_numpy(cfg: ArchConfig, np_params, device=None) -> Params:
    """Turn the JAX ``Model.init`` pytree, already converted to numpy by the
    caller (``jax.tree_util.tree_map(np.asarray, params)``), into the
    port's parameters: the same names, with ``layers`` (stacked on axis 0)
    split into one dict per layer."""
    device = resolve_device(device)
    out: Params = {k: tree_map(lambda a: _to_tensor(a, device), v)
                   for k, v in np_params.items() if k != "layers"}
    out["layers"] = [
        tree_map(lambda a, i=i: _to_tensor(np.asarray(a)[i], device),
                  np_params["layers"])
        for i in range(cfg.num_layers)]
    return out


class Model:
    """Attention-family decoder (dense FFN) or Mamba-2 stack: pure functions
    over explicit params, on one device.

    ``use_kernels`` (default True) sends every RMSNorm, the SSD chunk step
    and the training loss's full-sequence attention to their kernels (CUDA
    kernels for CUDA tensors, plain versions for CPU tensors); False runs
    their plain versions on any device, the reference path the kernels are
    held against on the card.  The serving attention kernels have their own
    switches (``chunk_attn_impl``, the decode step's ``attn_impl``).
    ``attn_chunk`` sizes the query and key chunks of the plain
    ``chunked_attention``.
    """

    def __init__(self, cfg: ArchConfig, *, kv_dtype: str = "bfloat16",
                 chunk_attn_impl: str = "masked", attn_chunk: int = 1024,
                 ssd_chunk: int = 256, use_kernels: bool = True,
                 device=None):
        if chunk_attn_impl not in ("masked", "flash"):
            raise ValueError(f"chunk_attn_impl={chunk_attn_impl!r} "
                             "(want 'masked' or 'flash')")
        if not self.supports_family(cfg):
            raise NotImplementedError(
                f"family={cfg.family} (enc_dec={cfg.is_encoder_decoder}, "
                f"moe={cfg.has_moe}) is not ported yet: ROADMAP.md Queue 1 "
                "item 13 (MoE, hybrid, encoder-decoder)")
        self.cfg = cfg
        self.chunk_attn_impl = chunk_attn_impl
        self.attn_chunk = attn_chunk
        self.ssd_chunk = ssd_chunk
        self.use_kernels = use_kernels
        self.kv_dtype = kv_dtype
        self.dtype = dtype_of(cfg.param_dtype)
        self.device = resolve_device(device)

    @staticmethod
    def supports_family(cfg: ArchConfig) -> bool:
        return (cfg.family != "hybrid" and not cfg.is_encoder_decoder
                and not cfg.has_moe)

    def _norm(self, p, x):
        return L.apply_norm(self.cfg, p, x, use_kernel=self.use_kernels)

    # ------------------------------------------------------------- params
    def init(self, generator: torch.Generator) -> Params:
        """Random parameters drawn on the model's device from
        ``generator`` (a ``torch.Generator`` on that device), with the
        scales of ``layers._dense_init``: normal x 1/sqrt(fan_in), the
        embedding x 0.02."""
        cfg, dtype, dev = self.cfg, self.dtype, self.device
        params: Params = {
            "embed": L._dense_init(generator, (cfg.vocab_size, cfg.d_model),
                                   scale=0.02, dtype=dtype, device=dev),
            "final_norm": L.init_norm(cfg, cfg.d_model, dtype, dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L._dense_init(
                generator, (cfg.d_model, cfg.vocab_size), dtype=dtype,
                device=dev)
        params["layers"] = [self._init_layer(generator)
                            for _ in range(cfg.num_layers)]
        return params

    def _init_layer(self, generator):
        """One layer in the reference's layout (``_init_sublayer``): ``ln1``
        and the mixer, then ``ln2`` and ``ffn`` unless ``d_ff == 0``."""
        cfg, dtype, dev = self.cfg, self.dtype, self.device
        p = {"ln1": L.init_norm(cfg, cfg.d_model, dtype, dev)}
        if cfg.layer_kind(0) == "ssm":
            p["ssm"] = M.init_mamba_block(cfg, generator, dtype, dev)
        else:
            p["attn"] = L.init_attention(cfg, generator, dtype, dev)
        if cfg.ffn_kind(0) == "dense":
            p["ln2"] = L.init_norm(cfg, cfg.d_model, dtype, dev)
            p["ffn"] = L.init_ffn(cfg, generator, dtype, dev)
        return p

    # --------------------------------------------------------------- embed
    def _embed_in(self, params, tokens):
        return params["embed"][tokens.long()]

    def _logits(self, params, h):
        head = (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])
        return h @ head

    def _ffn_block(self, p_l, h):
        if "ffn" not in p_l:                # d_ff == 0: the mixer is all
            return h
        return h + L.apply_ffn(self.cfg, p_l["ffn"],
                               self._norm(p_l["ln2"], h))

    # ------------------------------------------------------------ training
    def loss(self, params, batch):
        """Mean next-token cross-entropy plus the z-loss (and the MoE aux
        term, 0 without experts) of one batch, as the reference's
        ``Model.loss``.  ``batch``: ``tokens`` and ``targets`` (B, S)
        integer tensors on the model's device.  Returns ``(total, {"ce",
        "zloss", "moe_aux"})``, float32 scalars that carry the graph when
        the params require grad."""
        if self.cfg.family == "ssm":
            raise NotImplementedError(
                "training the ssm family is not ported yet: ROADMAP.md "
                "Queue 1 item 14 (the SSD chunk kernel has no autograd "
                "Function)")
        x = self._embed_in(params, batch["tokens"])
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        x, aux = self._run_stack_full(params, x, positions)
        x = self._norm(params["final_norm"], x)
        logits = self._logits(params, x).float()
        logz = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1,
                           batch["targets"].long()[..., None])[..., 0]
        ce = (logz - tgt).mean()
        zloss = ZLOSS_COEF * (logz ** 2).mean()
        total = ce + zloss + MOE_AUX_COEF * aux
        return total, {"ce": ce, "zloss": zloss, "moe_aux": aux}

    def _run_stack_full(self, params, x, positions):
        """The attention-family decoder stack over whole sequences (the
        reference's non-hybrid, non-encoder-decoder branch): per layer
        ``ln1``, causal ``chunked_attention``, ``wo``, then the FFN block.
        Returns ``(x, moe_aux)``; aux is 0 (no experts in the port)."""
        cfg = self.cfg
        B, S = x.shape[:2]
        for p_l in params["layers"]:
            h = self._norm(p_l["ln1"], x)
            q, k, v = L._project_qkv(cfg, p_l["attn"], h, positions)
            attn = L.chunked_attention(
                cfg, q, k, v, causal=True, q_chunk=self.attn_chunk,
                kv_chunk=self.attn_chunk, use_kernel=self.use_kernels)
            x = x + attn.reshape(B, S, -1) @ p_l["attn"]["wo"]
            x = self._ffn_block(p_l, x)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    # ------------------------------------------------------ chunked prefill
    def supports_chunked_prefill(self) -> bool:
        """Chunked (resumable) prefill covers the attention family; an SSM
        state would need a cross-chunk handoff, so ``ssm`` prefills
        monolithically (:meth:`prefill`)."""
        return self.cfg.family != "ssm"

    def supports_paged(self) -> bool:
        """Paged KV covers the attention family; SSM state is constant-size
        (paging buys nothing) and lives in the dense backend."""
        return self.cfg.family != "ssm"

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

    @torch.no_grad()
    def paged_prefill_chunk(self, params, kv, tokens, block_tables,
                            write_page, write_off, start: int,
                            chunk_len: int):
        """One resumable prefill chunk whose KV lands in the page pool.

        ``kv``: {"k","v"} (L, num_pages, page, KVH, hd), written **in
        place**; ``tokens``: (1, C) right-padded past ``chunk_len``;
        ``block_tables``: (1, max_pages) int32, unused entries at the
        scratch page; ``write_page``/``write_off``: (C,) physical
        destination of each chunk token (scratch for padded rows).  The
        chunk's queries sit at absolute positions ``start + i`` and attend
        the request's pages gathered in logical order.  Returns the
        last-position logits (1, V) float32, taken at ``chunk_len - 1``.
        """
        cfg = self.cfg
        dev = tokens.device
        C = tokens.shape[1]
        page = kv["k"].shape[2]
        n_pages = block_tables.shape[1]
        Smax = n_pages * page
        x = self._embed_in(params, tokens)
        q_pos = (start + torch.arange(C, device=dev))[None, :]
        kv_pos = torch.arange(Smax, device=dev)[None, :]
        start_vec = torch.full((1,), start, dtype=torch.int32, device=dev)
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
            x = x + attn.reshape(1, C, -1) @ p_l["attn"]["wo"]
            x = self._ffn_block(p_l, x)
        last = min(max(chunk_len - 1, 0), C - 1)
        x_last = self._norm(params["final_norm"], x[:, last])
        return self._logits(params, x_last).float()

    # ------------------------------------------------------- paged decode
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
        cfg = self.cfg
        B = tokens.shape[0]
        page = kv["k"].shape[2]
        x = self._embed_in(params, tokens)
        positions = lengths[:, None]
        wp, wo = write_page.long(), write_off.long()
        lens1 = (lengths + 1).to(torch.int32)
        tables_l = block_tables.long()
        n_pages = block_tables.shape[1]
        for li, p_l in enumerate(params["layers"]):
            k_pool, v_pool = kv["k"][li], kv["v"][li]
            h1 = self._norm(p_l["ln1"], x)
            q, k, v = L._project_qkv(cfg, p_l["attn"], h1, positions)
            k_pool.index_put_((wp, wo), k[:, 0].to(k_pool.dtype))
            v_pool.index_put_((wp, wo), v[:, 0].to(v_pool.dtype))
            if attn_impl == "kernel":
                attn = paged_attention(q[:, 0].contiguous(), k_pool, v_pool,
                                       block_tables, lens1)
            else:
                kg = k_pool[tables_l].reshape(B, n_pages * page,
                                              *k_pool.shape[2:])
                vg = v_pool[tables_l].reshape(B, n_pages * page,
                                              *v_pool.shape[2:])
                attn = L.decode_attention(cfg, q[:, 0], kg, vg, lens1)
            x = x + (attn.reshape(B, -1) @ p_l["attn"]["wo"])[:, None, :]
            x = self._ffn_block(p_l, x)
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

    # ---------------------------------------------- monolithic prefill (ssm)
    def _require_ssm(self, what: str) -> None:
        if self.cfg.family != "ssm":
            raise NotImplementedError(
                f"{what} for family={self.cfg.family} is not ported yet: "
                "ROADMAP.md Queue 1 item 5 (the attention family's dense "
                "backend: Model.prefill_chunk and the dense decode_step)")

    @torch.no_grad()
    def prefill(self, params, batch):
        """Process whole prompts in one pass; return (last-token logits
        (B, V) float32, cache).

        ``batch``: ``tokens`` (B, S), unpadded (an SSM state depends on
        every step).  The cache is the reference's ``_pack_cache`` layout:
        ``lengths`` (B,) int32, ``conv`` (L, B, W-1, Ch) in the working
        dtype and ``ssm`` (L, B, H, P, N) float32."""
        self._require_ssm("monolithic prefill")
        cfg = self.cfg
        tokens = batch["tokens"]
        x = self._embed_in(params, tokens)
        B, S = x.shape[:2]
        convs, ssms = [], []
        for p_l in params["layers"]:
            h = self._norm(p_l["ln1"], x)
            out, state = M.mamba_block(cfg, p_l["ssm"], h,
                                       chunk=self.ssd_chunk, return_state=True,
                                       use_kernel=self.use_kernels)
            x = self._ffn_block(p_l, x + out)
            convs.append(state["conv"])
            ssms.append(state["ssm"])
        x_last = self._norm(params["final_norm"], x[:, -1, :])
        cache = {"lengths": torch.full((B,), S, dtype=torch.int32,
                                       device=x.device),
                 "conv": torch.stack(convs), "ssm": torch.stack(ssms)}
        return self._logits(params, x_last).float(), cache

    # ------------------------------------------------ recurrent decode (ssm)
    @torch.no_grad()
    def decode_step(self, params, cache, tokens, active=None):
        """One decode iteration over the dense state cache, written **in
        place**.  ``tokens`` (B, 1).  Returns logits (B, V) float32.

        ``active`` (B,) bool, when given, limits the state writes and the
        ``lengths`` advance to active lanes: an inactive lane's state (a
        request prefilled this iteration, or a free lane) is left as it
        was.  Without it every lane advances, as the reference's
        ``decode_step``."""
        self._require_ssm("the dense decode step")
        cfg = self.cfg
        x = self._embed_in(params, tokens)                      # (B, 1, D)

        def write(dst, src):
            if active is None:
                dst.copy_(src)
            else:
                keep = active.view(-1, *([1] * (src.dim() - 1)))
                dst.copy_(torch.where(keep, src.to(dst.dtype), dst))

        for li, p_l in enumerate(params["layers"]):
            h = self._norm(p_l["ln1"], x)
            state = {"conv": cache["conv"][li], "ssm": cache["ssm"][li]}
            out, new = M.mamba_decode_step(cfg, p_l["ssm"], h[:, 0, :], state,
                                           use_kernel=self.use_kernels)
            write(state["conv"], new["conv"])
            write(state["ssm"], new["ssm"])
            x = self._ffn_block(p_l, x + out[:, None, :])
        cache["lengths"] += (1 if active is None
                             else active.to(cache["lengths"].dtype))
        x = self._norm(params["final_norm"], x[:, -1, :])
        return self._logits(params, x).float()

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

    # --------------------------------------------------------- cache specs
    def cache_shapes(self, batch: int) -> Dict[str, Any]:
        """``{key: (shape, dtype)}`` of a dense decode cache for ``batch``
        lanes (an SSM state is constant-size)."""
        self._require_ssm("the dense decode cache")
        cfg = self.cfg
        n = cfg.num_layers
        return {"lengths": ((batch,), torch.int32),
                "conv": ((n, batch, cfg.conv_width - 1,
                          cfg.d_inner + 2 * cfg.ssm_state), self.dtype),
                "ssm": ((n, batch, cfg.ssm_heads, cfg.ssm_headdim,
                         cfg.ssm_state), torch.float32)}

    def init_cache(self, batch: int) -> Dict[str, Any]:
        return {k: torch.zeros(shape, dtype=dt, device=self.device)
                for k, (shape, dt) in self.cache_shapes(batch).items()}
