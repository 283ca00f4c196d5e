"""Token samplers that run where the logits are, so the fused decode step
samples and decides termination on the device and the host syncs one
``(tokens, reasons)`` pair per iteration.

Greedy sampling matches the JAX package exactly (``argmax``, first index
on ties).  Temperature sampling cannot reproduce JAX's ``token_keys``
fold-in stream (``repro.serving.sampler.token_keys``): torch has no
threefry.  It draws instead from a counter-based hash of ``(seed, request
id, token index, vocabulary index)`` turned into Gumbel noise
(Gumbel-max), so a token's draw is a pure function of those values,
independent of batch composition, preemption history and device.  The
draws differ from JAX's bits; only their distribution agrees.
"""
from __future__ import annotations

import torch

# Termination reason codes returned by :func:`sample_and_reason` — index into
# REASONS to recover the engine's string reasons.  Priority order matches the
# engine's host-side chain (eos > length > ctx > true_len).
REASON_NONE = 0
REASON_EOS = 1
REASON_LENGTH = 2
REASON_CTX = 3
REASON_TRUE_LEN = 4
REASONS = ("", "eos", "length", "ctx", "true_len")

_MASK63 = (1 << 63) - 1


def greedy(logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _mix(h):
    """SplitMix64-style finaliser on non-negative int64 (kept below 2^63 so
    every shift is a logical shift; multiplication wraps)."""
    h = h ^ (h >> 31)
    h = (h * 0x5851F42D4C957F2D) & _MASK63
    h = h ^ (h >> 29)
    h = (h * 0x2545F4914F6CDD1D) & _MASK63
    return h ^ (h >> 32)


def uniform_noise(seed: int, rids, idx, vocab: int):
    """(B, vocab) float32 uniforms in (0, 1), a pure function of
    ``(seed, rids[b], idx[b], v)``."""
    dev = rids.device
    r = rids.to(torch.int64)[:, None] & 0xFFFFFFFF
    i = idx.to(torch.int64)[:, None] & 0xFFFFFFFF
    v = torch.arange(vocab, device=dev, dtype=torch.int64)[None, :]
    h = _mix(((int(seed) & 0xFFFFFFFF) * 0x1E3779B97F4A7C15) & _MASK63)
    h = _mix((h ^ (r * 0x632BE59BD9B4E019)) & _MASK63)
    h = _mix((h ^ (i * 0x05EBCA77C2B2AE63)) & _MASK63)
    h = _mix((h ^ (v * 0x27D4EB2F165667C5)) & _MASK63)
    bits = (h >> 39).to(torch.float32)                     # 24 bits
    return (bits + 0.5) / float(1 << 24)


def temperature(logits, noise_u, temp: float = 1.0, top_k: int = 0):
    """Gumbel-max categorical draw: logits (B, V), noise (B, V) uniforms."""
    logits = logits.float()
    if top_k > 0:
        cutoff = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits >= cutoff, logits,
                             torch.full_like(logits, float("-inf")))
    gumbel = -torch.log(-torch.log(noise_u))
    return torch.argmax(logits / max(temp, 1e-6) + gumbel,
                        dim=-1).to(torch.int32)


def sample_tokens(logits, rids, idx, *, greedy_sampling: bool, seed: int = 0,
                  temp: float = 1.0, top_k: int = 0):
    """Per-lane sampling: logits (B, V) -> (B,) int32.  ``rids``/``idx``
    (B,) name each lane's draw (request id, generation index)."""
    if greedy_sampling:
        return greedy(logits)
    u = uniform_noise(seed, rids, idx, logits.shape[-1])
    return temperature(logits, u, temp=temp, top_k=top_k)


def _reason_of(tok, new_gen, new_ctx, true_len, *, eos_token,
               max_new_tokens, max_seq_len):
    """Termination chain (eos > length > ctx > true_len), broadcastable."""
    none = torch.full_like(tok, REASON_NONE)
    r = torch.where(new_gen >= true_len, torch.full_like(tok, REASON_TRUE_LEN),
                    none)
    r = torch.where(new_ctx >= max_seq_len - 1,
                    torch.full_like(tok, REASON_CTX), r)
    r = torch.where(new_gen >= max_new_tokens,
                    torch.full_like(tok, REASON_LENGTH), r)
    return torch.where(tok == eos_token, torch.full_like(tok, REASON_EOS), r)


def sample_and_reason(logits, rids, idx, *, greedy_sampling: bool,
                      seed: int, temp: float, top_k: int, eos_token: int,
                      max_new_tokens: int, max_seq_len: int, new_gen,
                      new_ctx, true_len):
    """Fused sampling + termination on the logits' device.

    ``new_gen``/``new_ctx`` (B,) are each slot's generated count / context
    length *after* accepting this token; ``true_len`` is the per-slot trace
    stop (a huge value when ``respect_true_len`` is off).  Returns
    ``(tokens (B,) int32, reason (B,) int32)`` with REASON_* codes.
    """
    tok = sample_tokens(logits, rids, idx, greedy_sampling=greedy_sampling,
                        seed=seed, temp=temp, top_k=top_k)
    reason = _reason_of(tok, new_gen, new_ctx, true_len,
                        eos_token=eos_token, max_new_tokens=max_new_tokens,
                        max_seq_len=max_seq_len)
    return tok, reason.to(torch.int32)


def verify_and_reason(logits, drafts, n_drafts, rids, active, *,
                      greedy_sampling: bool, seed: int, temp: float,
                      top_k: int, eos_token: int, max_new_tokens: int,
                      max_seq_len: int, base_gen, base_ctx, true_len):
    """Verify-k acceptance + sampling + termination on the logits' device.

    Exact-match verification: position ``i`` of each lane is sampled with
    its own draw ``(rids[b], base_gen[b] + i)`` (the fused decode step
    names the same token's draw the same way); draft ``drafts[:, i]`` (i
    >= 1) is accepted iff it equals the sample at position ``i - 1`` and
    every earlier draft was accepted.  An accepted position's logits come
    from the context the sequential path would have seen, so the emitted
    stream is the non-speculative one for any sampling method.

    ``logits``: (B, K1, V); ``drafts``: (B, K1) with column 0 the fed
    previous token (never matched) and columns 1..k the drafts (padding
    past ``n_drafts`` never matches); ``base_gen``/``base_ctx``: (B,)
    generated count / context length *before* this step.  Emission stops
    at the first terminal token even when later drafts match.  Returns
    ``(samples (B, K1), n_emit (B,), reason (B,))`` int32: the caller
    emits ``samples[b, :n_emit[b]]`` and applies ``reason[b]`` to the last
    of them; inactive lanes get 0 and 0."""
    B, K1, V = logits.shape
    dev = logits.device
    pos = torch.arange(K1, device=dev)[None, :]                # (1, K1)
    idx = base_gen.long()[:, None] + pos
    s = sample_tokens(logits.reshape(B * K1, V),
                      rids.repeat_interleave(K1), idx.reshape(-1),
                      greedy_sampling=greedy_sampling, seed=seed, temp=temp,
                      top_k=top_k).reshape(B, K1)
    prev = torch.roll(s, 1, dims=1)                 # prev[:, i] = s[:, i-1]
    match = (pos == 0) | ((drafts == prev)
                          & (pos <= n_drafts.long()[:, None]))
    m_cand = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    reason = _reason_of(s, base_gen.long()[:, None] + 1 + pos,
                        base_ctx.long()[:, None] + 1 + pos,
                        true_len.long()[:, None], eos_token=eos_token,
                        max_new_tokens=max_new_tokens,
                        max_seq_len=max_seq_len)
    first_term = torch.where(reason > 0, pos,
                             torch.full_like(pos, K1)).amin(dim=1)
    m = torch.clamp(torch.minimum(m_cand, first_term + 1), 1, K1)
    last = reason.gather(1, (m - 1)[:, None])[:, 0]
    zero = torch.zeros_like(m)
    return (s, torch.where(active, m, zero).to(torch.int32),
            torch.where(active, last, zero).to(torch.int32))
