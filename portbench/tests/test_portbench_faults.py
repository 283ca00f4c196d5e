"""A whole run of a cell at a size the CPU holds (``cpu_cell.py``), past
the harness's look for a card, with the timed path broken underneath:
``correct`` must come out false for each fault a one-card serving cell
can have, and true for the sound path.  In float32 at this size the
program equals the reference to rounding (the sound path reads 0), so
the limit here is 1e-5: Granite's logits are divided by its embedding
multiplier and logits scaling, so they lie within a few hundredths.
(No cell spans cards, so the fault of an exchange left out has no place
here.)"""
import numpy as np
import pytest
import torch

from portbench import bench

from cpu_cell import overrides

CELL = "granite-3-8b.sharegpt.r80"
LIMIT = {"logit_gap": 1e-5}


def run(hooks=None, cell=CELL, moe=False, rate=3.0, seed=2 ** 31 + 11):
    torch.set_num_threads(2)
    r = bench.run_cell(cell, seed, 6.0, False, device="cpu", hooks=hooks,
                       overrides=overrides(moe=moe, rate=rate,
                                           limits=LIMIT))
    return r, r.pop("_extra")


def wrap_decode(eng, after):
    """The backend's decode step with ``after(eng, tokens, active)``
    applied to what it returns."""
    decode = eng.kv.decode

    def broken(params, tokens, active, *rest):
        toks, reasons = decode(params, tokens, active, *rest)
        return after(eng, np.array(toks), np.asarray(active)), reasons
    eng.kv.decode = broken


def altered_token(eng):
    V = eng.model.cfg.vocab_size
    wrap_decode(eng, lambda e, t, act: np.where(act, (t + 1) % V, t))


def half_the_batch(eng):
    def after(e, t, act):
        h = len(t) // 2
        t[h:] = t[:h]
        return t
    wrap_decode(eng, after)


def state_unchanged(eng):
    decode = eng.kv.decode

    def broken(*args):
        saved = eng.kv.pool.k.clone(), eng.kv.pool.v.clone()
        out = decode(*args)
        eng.kv.pool.k.copy_(saved[0])
        eng.kv.pool.v.copy_(saved[1])
        return out
    eng.kv.decode = broken


@pytest.mark.parametrize("moe", [False, True])
def test_sound_path_is_correct(moe):
    cell = "granite-moe-3b-a800m.sharegpt.r80" if moe else CELL
    r, ex = run(cell=cell, moe=moe)
    assert r["correct"], r["checks"]
    assert ex["compare"]["compared_tokens"] >= 300
    assert r["failed"] == 0 and r["attempted"] > 10


@pytest.mark.parametrize("fault", [altered_token, half_the_batch,
                                   state_unchanged])
def test_a_broken_step_is_not_correct(fault):
    r, ex = run(hooks=fault)
    assert not r["correct"]
    assert r["checks"]["logit_gap"]["value"] > 10 * LIMIT["logit_gap"]


def test_swapped_requests_are_held_to_the_int8_round_trip(monkeypatch):
    """Over capacity the MLFQ swaps residents out in INT8: the sample
    holds swapped requests, the reference rounds their K/V as the swap did
    (its logits move), and what was served agrees with it."""
    from portbench.reference import dense
    real, seen = bench.check.compare, {}

    def spy(a, seed, device, recs, swaps, ids, control=False):
        got = [i for i in ids if swaps.get(i)]
        if got:
            plain = dense.run(a, seed, device,
                              bench.check.seqs_of(recs, {}, got))
            held = dense.run(a, seed, device,
                             bench.check.seqs_of(recs, swaps, got))
            seen["moved"] = max(float((p - h).abs().max())
                                for p, h in zip(plain, held))
        return real(a, seed, device, recs, swaps, ids, control)
    monkeypatch.setattr(bench.check, "compare", spy)
    r, ex = run(rate=12.0)
    assert ex["compare"]["compared_swapped"] > 0
    assert seen["moved"] > 1e-5
    assert r["correct"], r["checks"]
