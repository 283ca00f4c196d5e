"""How ``correct`` is decided: what the timed path served, held to the
plain reference (``reference/<family>.py``) and to the scheduler's
accounting.

* ``logit_gap``: a sample of the requests finished in the window, drawn
  from the seed with the longest of them in it (and those whose K/V went
  through an INT8 swap before the rest), is run through the reference
  over each prompt and its served tokens.  At every served position the
  gap by which the served token's logit lies below the reference's best
  is read; the widest gap is held to the cell's limit.  Greedy decoding,
  so the served token is the program's argmax.
* ``over_true_len``: requests that got more tokens than their true output
  length (limit 0).
* ``bad_finish``: requests finished in the window with another count than
  their true output length, or for another reason (limit 0).
* ``stream_mismatch``: requests whose streamed tokens are not the tokens
  the engine recorded, in order (limit 0).

The control (``control_gap``, used when the limit is set, never in a
benchmark run) is the reference in fp8 put in the program's place: at
each of the same positions, the gap of the token the fp8 reference puts
first."""
from __future__ import annotations

import importlib
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.arch import Arch
from portbench.e2e import Record
from portbench.reference.dense import Seq


def faults(recs: Dict[int, Record], program_tokens: Dict[int, list],
           seconds: float) -> Dict[str, set]:
    """The requests that break each rule of the accounting, by rule."""
    out = {"over_true_len": set(), "bad_finish": set(),
           "stream_mismatch": set()}
    for rid, r in recs.items():
        if len(r.tokens) > r.out_len:
            out["over_true_len"].add(rid)
        if (r.finish_t is not None and r.finish_t <= seconds
                and (len(r.tokens) != r.out_len or r.reason != "true_len")):
            out["bad_finish"].add(rid)
        if (r.index != list(range(len(r.index)))
                or r.tokens != program_tokens.get(rid, [])):
            out["stream_mismatch"].add(rid)
    return out


def sample(recs: Dict[int, Record], swaps: Dict[int, List[int]],
           seconds: float, seed: int, plan: dict) -> List[int]:
    """Request ids to compare: the finished requests in an order drawn
    from the seed, the one with the most served tokens first, then those
    that were swapped; taken while the served tokens stay under
    ``plan["served_tokens"]``, at most ``plan["max_requests"]`` of them
    and ``plan["max_positions"]`` positions in all."""
    done = [i for i, r in recs.items() if r.finish_t is not None
            and r.finish_t <= seconds and r.tokens]
    if not done:
        return []
    rng = np.random.default_rng([seed, 4])
    order = [done[i] for i in rng.permutation(len(done))]
    longest = max(done, key=lambda i: (len(recs[i].tokens), -i))
    order.remove(longest)
    order.sort(key=lambda i: not swaps.get(i))      # stable: swapped first
    picked, served, positions = [], 0, 0
    for i in [longest] + order:
        n = len(recs[i].tokens)
        p = len(recs[i].prompt) + n
        if picked and (served >= plan["served_tokens"]
                       or len(picked) >= plan["max_requests"]
                       or positions + p > plan["max_positions"]):
            continue
        picked.append(i)
        served += n
        positions += p
    return picked


def seqs_of(recs, swaps, ids) -> List[Seq]:
    return [Seq(tokens=recs[i].prompt + recs[i].tokens[:-1],
                from_pos=len(recs[i].prompt) - 1,
                swaps=list(swaps.get(i, []))) for i in ids]


def _gaps(ref: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    return ref.max(-1).values - ref.gather(-1, toks[:, None])[:, 0]


def compare(a: Arch, seed: int, device, recs, swaps, ids,
            control: bool = False) -> Dict[str, Optional[float]]:
    """The widest gap of the served tokens (and, with ``control``, of the
    fp8 reference's first choices) under the reference's logits, with
    what was compared."""
    ref_mod = importlib.import_module(f"portbench.reference.{a.family}")
    seqs = seqs_of(recs, swaps, ids)
    out = {"logit_gap": None, "compared_tokens": 0, "compared_requests":
           len(ids), "compared_swapped": sum(1 for i in ids
                                             if swaps.get(i)),
           "argmax_agree": None}
    if not seqs:
        return out
    ref = ref_mod.run(a, seed, device, seqs, "f32")
    served = [torch.as_tensor(recs[i].tokens, device=device) for i in ids]
    gaps = torch.cat([_gaps(r, t) for r, t in zip(ref, served)])
    agree = torch.cat([(r.argmax(-1) == t) for r, t in zip(ref, served)])
    out.update(_stats("logit_gap", gaps), compared_tokens=int(gaps.numel()),
               argmax_agree=float(agree.float().mean()))
    if control:
        ctl = ref_mod.run(a, seed, device, seqs, "fp8")
        cg = torch.cat([_gaps(r, c.argmax(-1)) for r, c in zip(ref, ctl)])
        out.update(_stats("control_gap", cg))
    return out


def _stats(name: str, gaps: torch.Tensor) -> Dict[str, float]:
    """The widest gap under ``name``, and beside it the mean, the 99th
    percentile and the share of positions whose gap is above 0, where
    the token is not the reference's first choice (``name_mean``,
    ``name_p99``, ``name_miss``)."""
    g = gaps.double()
    return {name: float(g.max()), f"{name}_mean": float(g.mean()),
            f"{name}_p99": float(torch.quantile(g, 0.99)),
            f"{name}_miss": float((g > 0).double().mean())}
