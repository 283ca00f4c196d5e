"""The traffic generator: seeded, rates, the filter, the fitted means."""
import json

import numpy as np
import pytest

from portbench import spec
from portbench.traffic import gen

MIXES = ["sharegpt", "alpaca"]


def mix(name):
    return spec.traffic(name)


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    a = gen.generate(mix(name), 4.0, 20.0, 2 ** 33 + 5, 49155)
    b = gen.generate(mix(name), 4.0, 20.0, 2 ** 33 + 5, 49155)
    assert [(r.due, r.prompt, r.out_len) for r in a] == \
        [(r.due, r.prompt, r.out_len) for r in b]


@pytest.mark.parametrize("name", MIXES)
def test_seeds_share_arrivals_and_sizes_in_another_order(name):
    a = gen.generate(mix(name), 4.0, 30.0, 1, 49155)
    b = gen.generate(mix(name), 4.0, 30.0, 2, 49155)
    assert [r.due for r in a] == [r.due for r in b]
    assert sorted((len(r.prompt), r.out_len) for r in a) == \
        sorted((len(r.prompt), r.out_len) for r in b)
    assert [r.out_len for r in a] != [r.out_len for r in b]
    assert [r.prompt for r in a] != [r.prompt for r in b]


@pytest.mark.parametrize("name", MIXES)
def test_rate_scales_arrivals(name):
    slow = gen.arrivals(mix(name), 2.0, 60.0)
    fast = gen.arrivals(mix(name), 4.0, 60.0)
    assert slow[0] == fast[0] == 0.0
    n = len(slow)
    np.testing.assert_allclose(fast[:n], slow[:n] / 2.0)
    assert abs(len(fast) / 60.0 - 4.0) < 1.0 and fast.max() < 60.0


@pytest.mark.parametrize("name", MIXES)
def test_filter_and_vocabulary(name):
    m = mix(name)
    reqs = gen.generate(m, 20.0, 60.0, 7, 49155)
    for r in reqs:
        assert m["prompt_min"] <= len(r.prompt) <= m["prompt_max"]
        assert r.out_len >= m["out_min"]
        assert len(r.prompt) + r.out_len <= m["context_cap"]
        assert min(r.prompt) >= 2 and max(r.prompt) < 49155


@pytest.mark.parametrize("name", MIXES)
def test_lengths_match_the_published_means(name):
    """The filtered mix's mean prompt and output lengths lie within 3% of
    the statistic its file names (vLLM's Fig. 11)."""
    m = mix(name)
    reqs = gen.generate(m, 200.0, 100.0, 3, 49155)
    want = m["fitted_to"]
    assert abs(np.mean([len(r.prompt) for r in reqs]) / want["prompt_mean"]
               - 1) < 0.03
    assert abs(np.mean([r.out_len for r in reqs]) / want["output_mean"]
               - 1) < 0.03


def test_sharegpt_output_tail_reaches_the_context():
    """ShareGPT's outputs are heavy-tailed: some over 1000 tokens, the
    longest near the lane's 2046 positions."""
    outs = np.array([r.out_len for r in gen.generate(
        mix("sharegpt"), 200.0, 100.0, 3, 49155)])
    assert 0.03 < (outs > 1000).mean() < 0.10 and outs.max() > 1800


def test_cluster_medians_are_a_property_of_the_mix():
    """The cluster medians are log-uniform over the mix's range and the
    same for every seed (they depend on the mix alone)."""
    import zlib
    for name in MIXES:
        m = mix(name)
        lo, hi = m["out_median_range"]
        rng = np.random.default_rng(zlib.crc32(f"{name}/64".encode()))
        want = np.exp(rng.uniform(np.log(lo), np.log(hi), 64))
        np.testing.assert_allclose(gen.cluster_medians(m), want)


def test_history_from_the_seed():
    p1, l1 = gen.history(mix("sharegpt"), 5, 49155)
    p2, l2 = gen.history(mix("sharegpt"), 6, 49155)
    assert len(p1) == mix("sharegpt")["history_requests"]
    np.testing.assert_array_equal(l1, l2)
    assert p1 != p2


def test_an_extending_mix_draws_its_base_requests():
    """``sharegpt.over`` is ShareGPT's population at another load: its
    own keys lie on top of its base's, and it draws the same requests."""
    raw = json.load(open(spec.HERE / "traffic" / "sharegpt.over.json"))
    over, base = mix("sharegpt.over"), mix("sharegpt")
    assert raw["extends"] == "sharegpt" and "extends" not in over
    assert over == dict(base, about=raw["about"])
    a = gen.generate(over, 27.0, 30.0, 2 ** 31 + 9, 49155)
    b = gen.generate(base, 27.0, 30.0, 2 ** 31 + 9, 49155)
    assert [(r.due, r.prompt, r.out_len) for r in a] == \
        [(r.due, r.prompt, r.out_len) for r in b]


@pytest.mark.parametrize("name", sorted(
    p.name[:-len(".json")] for p in (spec.HERE / "traffic").glob("*.json")))
def test_every_mix_named_in_a_cell_loads(name):
    m = mix(name)
    assert "fitted_to" in m and m["arrivals"] == "poisson"
    names = {w["traffic"] for w in spec.benchmark()["workloads"]}
    assert name in names or name in MIXES
