"""Model assembly for the PyTorch port: the attention-family decoder's
serving entry points (chunked paged prefill, fused paged decode).

Parameters are a plain dict: ``embed``, ``final_norm.scale`` and a list
``layers`` with one dict per layer (``ln1``, ``attn.{wq,wk,wv,wo}``,
``ln2``, ``ffn.*``).  Where the JAX reference runs ``lax.scan`` over
layers stacked on axis 0, the port loops over the list in Python.  Where
the reference rebuilt the page pool functionally and returned it, the
port writes the pool **in place** (``index_put_``) and returns only the
logits.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.kernels.flash_prefill import flash_prefill_prefix
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.serving.sampler import sample_and_reason
from repro_torch.utils import dtype_of, resolve_device

Params = Dict[str, Any]


def _to_tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":     # numpy has no bf16: go via f32
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)   # own, writable copy


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(cfg: ArchConfig, np_params, device=None) -> Params:
    """Turn the JAX ``Model.init`` pytree, already converted to numpy by the
    caller (``jax.tree_util.tree_map(np.asarray, params)``), into the
    port's parameters: the same names, with ``layers`` (stacked on axis 0)
    split into one dict per layer."""
    device = resolve_device(device)
    out: Params = {k: _tree_map(lambda a: _to_tensor(a, device), v)
                   for k, v in np_params.items() if k != "layers"}
    out["layers"] = [
        _tree_map(lambda a, i=i: _to_tensor(np.asarray(a)[i], device),
                  np_params["layers"])
        for i in range(cfg.num_layers)]
    return out


class Model:
    """Attention-family decoder (dense FFN): pure functions over explicit
    params, on one device."""

    def __init__(self, cfg: ArchConfig, *, kv_dtype: str = "bfloat16",
                 chunk_attn_impl: str = "masked", device=None):
        if chunk_attn_impl not in ("masked", "flash"):
            raise ValueError(f"chunk_attn_impl={chunk_attn_impl!r} "
                             "(want 'masked' or 'flash')")
        if not self.supports_family(cfg):
            raise NotImplementedError(
                f"family={cfg.family} (enc_dec={cfg.is_encoder_decoder}, "
                f"moe={cfg.has_moe}) is not ported yet: ROADMAP.md Queue 1 "
                "item 13 (other families)")
        self.cfg = cfg
        self.chunk_attn_impl = chunk_attn_impl
        self.kv_dtype = kv_dtype
        self.dtype = dtype_of(cfg.param_dtype)
        self.device = resolve_device(device)

    @staticmethod
    def supports_family(cfg: ArchConfig) -> bool:
        return (cfg.family not in ("ssm", "hybrid")
                and not cfg.is_encoder_decoder and not cfg.has_moe)

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
        params["layers"] = [
            {"ln1": L.init_norm(cfg, cfg.d_model, dtype, dev),
             "attn": L.init_attention(cfg, generator, dtype, dev),
             "ln2": L.init_norm(cfg, cfg.d_model, dtype, dev),
             "ffn": L.init_ffn(cfg, generator, dtype, dev)}
            for _ in range(cfg.num_layers)]
        return params

    # --------------------------------------------------------------- embed
    def _embed_in(self, params, tokens):
        return params["embed"][tokens.long()]

    def _logits(self, params, h):
        head = (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])
        return h @ head

    def _ffn_block(self, p_l, h):
        return h + L.apply_ffn(self.cfg, p_l["ffn"],
                               L.apply_norm(self.cfg, p_l["ln2"], h))

    # ------------------------------------------------------ chunked prefill
    def supports_chunked_prefill(self) -> bool:
        return True

    def supports_paged(self) -> bool:
        return True

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
            h1 = L.apply_norm(cfg, p_l["ln1"], x)
            q, k, v = L._project_qkv(cfg, p_l["attn"], h1, q_pos)
            k_pool.index_put_((wp, wo), k[0].to(k_pool.dtype))
            v_pool.index_put_((wp, wo), v[0].to(v_pool.dtype))
            kg = k_pool[tables].reshape(1, Smax, *k_pool.shape[2:])
            vg = v_pool[tables].reshape(1, Smax, *v_pool.shape[2:])
            attn = self._chunk_attn(q, kg, vg, q_pos, kv_pos, start_vec)
            x = x + attn.reshape(1, C, -1) @ p_l["attn"]["wo"]
            x = self._ffn_block(p_l, x)
        last = min(max(chunk_len - 1, 0), C - 1)
        x_last = L.apply_norm(cfg, params["final_norm"], x[:, last])
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
            h1 = L.apply_norm(cfg, p_l["ln1"], x)
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
        x = L.apply_norm(cfg, params["final_norm"], x[:, -1, :])
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
