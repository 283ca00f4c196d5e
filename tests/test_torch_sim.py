"""The port's analytic models against the JAX package's: the synthetic
trace generator, the iteration-level simulator (with its cluster-tier
path), the cluster router (failure replay, elastic scale-up, a shared
``SimKVTier``) and the simulator's prefix-index twin with a bus attached.

Both sides are the same numpy and pure-Python code (the port's modules are
copies with their imports rewritten), run on the same seeds, so every
result is compared exactly: no operation differs between the two, so no
float may differ either.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import cluster as ref_cluster  # noqa: E402
from repro.core import request as ref_request  # noqa: E402
from repro.core import simulator as ref_sim  # noqa: E402
from repro.core import trace as ref_trace  # noqa: E402
from repro.serving import observability as ref_obs  # noqa: E402
from repro.serving import prefix_cache as ref_pc  # noqa: E402
from repro_torch.core import cluster as port_cluster  # noqa: E402
from repro_torch.core import request as port_request  # noqa: E402
from repro_torch.core import simulator as port_sim  # noqa: E402
from repro_torch.core import trace as port_trace  # noqa: E402
from repro_torch.serving import observability as port_obs  # noqa: E402
from repro_torch.serving import prefix_cache as port_pc  # noqa: E402

SIDES = ((ref_trace, ref_sim, ref_cluster, ref_request),
         (port_trace, port_sim, port_cluster, port_request))


def _req_rows(reqs):
    """Every request's observable fields (not its id: each package counts
    ids from its own counter)."""
    return [(r.prompt_len, r.arrival_time, r.true_out_len,
             list(r.prompt_tokens or []), r.generated, r.first_token_time,
             r.finish_time, r.first_scheduled_time, r.preempt_count,
             r.swap_in_bytes, r.swap_out_bytes, r.recompute_tokens,
             r.predicted_len, r.cached_prefix_hint, r.spec_accepted)
            for r in reqs]


# ----------------------------------------------------------------- trace

@pytest.mark.parametrize("dataset,seed", [("alpaca", 0), ("sharegpt", 1),
                                          ("sharegpt", 7)])
def test_generate_trace_equals_the_reference(dataset, seed):
    got = []
    for tr, *_ in SIDES:
        cfg = tr.TraceConfig(dataset=dataset, rate=6.0, duration=60.0,
                             seed=seed)
        trace = tr.generate_trace(cfg)
        stats = tr.trace_stats(trace)
        clamped = tr.clamp_requests(tr.generate_trace(cfg).requests,
                                    vocab=300, max_prompt=64, max_new=32)
        got.append((_req_rows(trace.requests), trace.duration, stats,
                    _req_rows(clamped)))
    assert got[0] == got[1]
    assert len(got[0][0]) > 100


# ------------------------------------------------------------- simulator

def _run_sim(side, predictor_kind=None, **kw):
    """``run_sim`` on one side, its predictor pretrained on 64 history
    requests (``predictor_kind``: a ``SimConfig.predictor`` other than the
    retrieval default, through ``ServingSimulator``)."""
    tr, sim, _, req = side
    req.reset_request_counter()
    kw = {"pretrain_requests": 64, **kw}
    if predictor_kind is None:
        res = sim.run_sim(**kw)
    else:
        trace = tr.generate_trace(tr.TraceConfig(
            dataset=kw.pop("dataset"), rate=kw.pop("rate"),
            duration=kw.pop("duration"), seed=0))
        res = sim.ServingSimulator(sim.SimConfig(
            predictor=predictor_kind, **kw), trace).run()
    return res.row(), res.predictor_stats, _req_rows(res.requests)


def _same_sim(**kw):
    ref, port = (_run_sim(side, **kw) for side in SIDES)
    assert port == ref
    assert ref[0]["completed"] > 0
    return ref[0]


@pytest.mark.parametrize("tier", [False, True], ids=["no-tier", "tier"])
@pytest.mark.parametrize("strategy", ["alise", "orca", "vllm", "oracle",
                                      "alise-defer", "alise-recompute"])
def test_run_sim_equals_the_reference(strategy, tier):
    extra = dict(prefix_cache=True, kv_tier=True) if tier else {}
    _same_sim(strategy=strategy, dataset="alpaca", rate=4.0, duration=10.0,
              **extra)


@pytest.mark.parametrize("strategy", ["alise", "alise-recompute",
                                      "alise-defer"])
def test_run_sim_memory_ablations_equal_the_reference(strategy):
    """``tests/test_simulator.py``'s memory ablation: a tight HBM budget
    forces swaps, recomputes or deferrals."""
    row = _same_sim(strategy=strategy, dataset="sharegpt", rate=3.0,
                    duration=12.0, hbm_bytes=3e9)
    assert row["preemptions"] > 0 or strategy == "alise-defer"


@pytest.mark.parametrize("opts", [
    dict(prefill_chunk=64, iter_token_budget=256, prefill_buckets=(16, 32,
                                                                   64),
         prefill_pack=True),
    dict(spec_decode=True, prefix_cache=True, kv_tier=True,
         tier_bytes=2e8),
    dict(predictor_kind="online", prefix_cache=True),
], ids=["chunks-packs", "spec-tier", "online"])
def test_run_sim_features_equal_the_reference(opts):
    _same_sim(strategy="alise", dataset="sharegpt", rate=3.0,
              duration=12.0, hbm_bytes=4e9, **opts)


def test_sim_bus_events_equal_the_reference():
    """A virtual-clock bus on a simulator with the prefix cache and the
    tier: the same events, in the same order, with the same data (but a
    prediction's wall-clock latency)."""
    got = []
    for (tr, sim, _, req), obs in zip(SIDES, (ref_obs, port_obs)):
        req.reset_request_counter()
        bus = obs.EventBus(clock="virtual")
        sim.run_sim(dataset="alpaca", rate=4.0, duration=10.0, seed=2,
                    prefix_cache=True, prefix_cache_pages=8, kv_tier=True,
                    bus=bus)
        # a prediction's wall latency is measured, not simulated
        got.append([(e.kind, e.t, e.replica,
                     {k: v for k, v in e.data.items() if k != "latency_s"})
                    for e in bus.snapshot()])
    assert got[0] == got[1]
    kinds = {k for k, *_ in got[0]}
    assert {"prefix_evict", "finish"} <= kinds


# --------------------------------------------------------------- cluster

@pytest.fixture(scope="module")
def cluster_inputs():
    out = []
    for tr, sim, _, req in SIDES:
        req.reset_request_counter()
        tc = tr.TraceConfig(dataset="sharegpt", rate=8.0, duration=8.0,
                            seed=3)
        trace = tr.generate_trace(tc)
        # every third request resends the prompt of the one two before it,
        # so that the shared tier has prefixes to import
        reqs = trace.requests
        for i in range(2, len(reqs), 3):
            reqs[i].prompt_tokens = list(reqs[i - 2].prompt_tokens)
            reqs[i].prompt_len = len(reqs[i].prompt_tokens)
        out.append((tc, trace))
    return out


def _cluster_row(res):
    return dataclasses.asdict(res)


@pytest.mark.parametrize("case", [
    dict(router="round_robin"), dict(router="join_shortest_queue"),
    dict(router="ewt"),
    dict(router="ewt", fail_at=3.0, recover_at=6.0),
    dict(router="ewt", scale_up=2, n_replicas=2),
    dict(router="round_robin", kv_tier=True, prefix_cache=True,
         tier_bytes=5e8),
], ids=["round_robin", "jsq", "ewt", "failure-replay", "scale-up",
        "shared-tier"])
def test_cluster_router_equals_the_reference(cluster_inputs, case):
    case = dict(case)
    up = case.pop("scale_up", 0)
    got = []
    for (tr, sim, cl, req), (tc, trace) in zip(SIDES, cluster_inputs):
        req.reset_request_counter()
        pred = sim.build_predictor("retrieval", tc, 64)
        router = cl.ClusterRouter(cl.ClusterConfig(
            **{"n_replicas": 3, **case}), pred)
        if up:
            router.scale_up(up)
        res = router.run(trace)
        tier = router.tier
        got.append((_cluster_row(res), _req_rows(trace.requests),
                    None if tier is None else (tier.imports,
                                               tier.imported_tokens)))
    assert got[0] == got[1]
    res = got[0][0]
    assert res["completed"] == res["total"] > 0
    if "fail_at" in case:
        assert res["replayed"] > 0
    if case.get("kv_tier"):
        assert got[0][2][0] >= 1


def test_pick_replica_equals_the_reference():
    cands = list(range(5))
    for policy in ("round_robin", "join_shortest_queue", "ewt"):
        for rr in range(7):
            args = dict(rr_counter=rr, queue_len=lambda c: (c * 7) % 5,
                        backlog=lambda c: (c * 3) % 4 + c / 10)
            assert (port_cluster.pick_replica(policy, cands, **args)
                    == ref_cluster.pick_replica(policy, cands, **args))


# ------------------------------------------------- prefix index + bus

def _evict_events(pc, obs):
    """Inserts past a 3-page capacity on a bus-attached SimPrefixIndex:
    the evictions it emits, and its stats."""
    bus = obs.EventBus(clock="virtual")
    idx = pc.SimPrefixIndex(page_size=2, capacity_pages=3)
    idx.bus, idx.replica = bus, "sim0"
    rng = np.random.default_rng(11)
    for _ in range(20):
        t = rng.integers(0, 4, int(rng.integers(2, 12))).tolist()
        idx.insert(t, len(t))
        idx.hit(t, len(t) - 1)
    return ([(e.kind, e.replica, e.data) for e in bus.snapshot()],
            idx.stats.as_dict())


def test_sim_prefix_index_evict_events_equal_the_reference():
    ref = _evict_events(ref_pc, ref_obs)
    port = _evict_events(port_pc, port_obs)
    assert port == ref
    assert any(kind == "prefix_evict" for kind, *_ in ref[0])


# -------------------------------------------------------------- registry

def test_registry_falls_back_to_the_paper_models_for_pricing_only():
    """``get_config`` knows the paper's models, as the reference's does
    (the simulator prices ``opt-13b`` by default), with the reference's
    fields; ``get_smoke_config`` and both launchers still refuse an arch
    the port cannot run."""
    import torch

    from repro.configs import get_config as ref_get
    from repro.configs import paper_models as ref_paper
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import serve as port_serve
    from repro_torch.launch import train as port_train
    for name in ref_paper.CONFIGS:
        assert (dataclasses.asdict(get_config(name))
                == dataclasses.asdict(ref_get(name)))
    with pytest.raises(KeyError):
        get_config("no-such-model")
    with pytest.raises(KeyError):
        get_smoke_config("opt-13b")
    with pytest.raises(KeyError):
        port_serve.build_model("opt-13b", "full", torch.device("cpu"))
    with pytest.raises(KeyError):
        port_train.train(arch="opt-13b", smoke=False, steps=1, device="cpu")
