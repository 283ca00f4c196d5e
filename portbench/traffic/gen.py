"""The one generator of the benchmark's traffic: a mix's parameters
(``traffic/<mix>.json``) in, timed requests out.

Lengths: each request belongs to one of the mix's topic clusters; its
prompt length is lognormal, its output length lognormal around its
cluster's median (cluster medians log-uniform over the mix's range, a
property of the dataset, the same for every seed), so that a retrieval
predictor that has seen a cluster's prompts can learn its lengths, as
the paper's vector store does.  A request that vLLM's benchmark would
prune (prompt or output under ``prompt_min``/``out_min`` tokens, prompt
over ``prompt_max``, prompt and output over ``context_cap``) is drawn
again, as that filter leaves such requests out.  A mix's file names the
published statistic its parameters were fitted to (``fitted_to``), and a
test holds the generator's means to it.  The structure (clusters,
signature tokens, Poisson arrivals) is that of
``src/repro_torch/core/trace.py``; its length parameters are not.

Arrivals are an open loop, Poisson at the cell's rate, and every seed
gets the same arrival times and the same requests' sizes: both come from
the mix's fixed ``base_stream``.  The seed shuffles which size arrives in
which slot inside blocks of ``shuffle_block`` consecutive arrivals, and
draws every prompt's tokens.  So seeds differ in order and content, not in
the work offered, and runs of different seeds measure the same load.
Token ids are remapped into ``[2, vocab)`` (0 pads, 1 is the engine's
default end-of-sequence id).  The length predictor's pretraining history
takes its sizes from the base stream and its tokens from another stream
of the seed.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

# sub-streams of a run's --seed (numpy SeedSequence entropy [seed, k])
STREAM_ORDER, STREAM_TOKENS, STREAM_HISTORY = 1, 2, 3


@dataclass
class TimedRequest:
    due: float              # seconds after the window opens
    prompt: List[int]
    out_len: int            # true_out_len: the engine stops there
    cluster: int


def cluster_medians(mix: dict) -> np.ndarray:
    """Each topic cluster's output-length median, log-uniform over the
    mix's range: a property of the dataset, the same for every seed."""
    lo, hi = mix["out_median_range"]
    rng = np.random.default_rng(
        zlib.crc32(f"{mix['name']}/{mix['n_clusters']}".encode()))
    return np.exp(rng.uniform(np.log(lo), np.log(hi), mix["n_clusters"]))


def _size(mix: dict, rng, medians) -> Tuple[int, int, int]:
    """(cluster, prompt length, output length) of one request, drawn
    again until vLLM's benchmark filter would keep it."""
    mu, sigma = mix["prompt_lognormal"]
    while True:
        c = int(rng.integers(mix["n_clusters"]))
        plen = int(round(rng.lognormal(mu, sigma)))
        out = int(round(rng.lognormal(np.log(medians[c]),
                                      mix["out_noise_sigma"])))
        if (mix["prompt_min"] <= plen <= mix["prompt_max"]
                and out >= mix["out_min"]
                and plen + out <= mix["context_cap"]):
            return c, plen, out


def cluster_prompt(mix: dict, rng, cluster: int, length: int,
                   vocab: int) -> List[int]:
    """Prompt tokens: Zipf-distributed signature tokens of the cluster's
    slice of the synthetic vocabulary plus shared noise tokens, shuffled,
    then remapped into ``[2, vocab)``."""
    V, T = mix["synthetic_vocab"], mix["topic_tokens"]
    sig_base = (cluster * T) % (V // 2)
    n_sig = max((length * 3) // 5, 1)
    ranks = np.minimum(rng.zipf(1.6, n_sig) - 1, T - 1)
    toks = np.concatenate([sig_base + ranks,
                           (V // 2) + rng.integers(0, V // 2, length - n_sig)])
    rng.shuffle(toks)
    return [2 + int(t) % (vocab - 2) for t in toks]


def arrivals(mix: dict, rate: float, seconds: float) -> np.ndarray:
    """Due times in ``[0, seconds)``: unit exponential gaps from the base
    stream over ``rate``, the first request due as the window opens."""
    rng = np.random.default_rng([mix["base_stream"], 0])
    gaps = []
    t = 0.0
    while t < seconds:
        gaps.append(t)
        t += float(rng.exponential(1.0)) / rate
    return np.asarray(gaps)


def generate(mix: dict, rate: float, seconds: float, seed: int,
             vocab: int) -> List[TimedRequest]:
    """The requests due in a window of ``seconds`` at ``rate`` per second,
    in due order."""
    due = arrivals(mix, rate, seconds)
    medians = cluster_medians(mix)
    size_rng = np.random.default_rng([mix["base_stream"], 1])
    sizes = [_size(mix, size_rng, medians) for _ in range(len(due))]
    order_rng = np.random.default_rng([seed, STREAM_ORDER])
    tok_rng = np.random.default_rng([seed, STREAM_TOKENS])
    k = mix["shuffle_block"]
    out = []
    for b in range(0, len(due), k):
        block = sizes[b:b + k]
        for j, i in enumerate(order_rng.permutation(len(block))):
            c, plen, olen = block[i]
            out.append(TimedRequest(
                due=float(due[b + j]), out_len=olen, cluster=c,
                prompt=cluster_prompt(mix, tok_rng, c, plen, vocab)))
    return out


def history(mix: dict, seed: int, vocab: int) -> Tuple[List[List[int]],
                                                       np.ndarray]:
    """The predictor's pretraining corpus: ``history_requests`` prompts
    with their output lengths."""
    medians = cluster_medians(mix)
    size_rng = np.random.default_rng([mix["base_stream"], 2])
    tok_rng = np.random.default_rng([seed, STREAM_HISTORY])
    prompts, lengths = [], []
    for _ in range(mix["history_requests"]):
        c, plen, olen = _size(mix, size_rng, medians)
        prompts.append(cluster_prompt(mix, tok_rng, c, plen, vocab))
        lengths.append(olen)
    return prompts, np.asarray(lengths, np.float32)
