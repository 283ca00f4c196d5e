"""Cluster-scale ALISE on the PyTorch port: paper-scale end-to-end curves +
multi-replica speculative routing + failure injection.

    PYTHONPATH=src python examples/cluster_simulation_torch.py

The port's copies of the iteration-level simulator and the cluster models
(``repro_torch.core.simulator``, ``repro_torch.core.cluster``) are
analytic: they run on the host and put no work on a device, so this
example takes no ``--device``.  Part 1 reproduces the paper's Fig. 6 sweep
(OPT-13B, ShareGPT).  Part 2 runs a 4-replica cluster with the EWT router,
kills a replica mid-run, and shows journal-replay recovery.  Same traces
and seeds as ``examples/cluster_simulation.py``, so the same table.
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.cluster import ClusterConfig, ClusterRouter  # noqa: E402
from repro_torch.core.simulator import build_predictor, run_sim  # noqa: E402
from repro_torch.core.trace import TraceConfig, generate_trace  # noqa: E402


def main():
    print("=== Fig. 6 sweep: OPT-13B on ShareGPT ===")
    print(f"{'rate':>5s} | " + " | ".join(f"{s:>10s}" for s in
                                          ("orca", "vllm", "alise", "oracle")))
    for rate in (1.0, 2.0, 3.0, 4.0):
        row = []
        for system in ("orca", "vllm", "alise", "oracle"):
            r = run_sim(strategy=system, dataset="sharegpt", rate=rate,
                        duration=60.0)
            row.append(r.normalized_latency * 1e3)
        flag = f"   ALISE {row[1] / max(row[2], 1e-9):.2f}x better than vLLM"
        print(f"{rate:5.1f} | " + " | ".join(f"{v:8.1f}ms" for v in row) + flag)

    print("\n=== 4-replica cluster, EWT speculative routing ===")
    tc = TraceConfig(dataset="sharegpt", rate=14.0, duration=60.0, seed=3)
    trace = generate_trace(tc)
    pred = build_predictor("retrieval", tc, 512)
    for router in ("round_robin", "ewt"):
        res = ClusterRouter(ClusterConfig(n_replicas=4, router=router),
                            pred).run(trace)
        print(f"  {router:12s}: norm {res.normalized_latency*1e3:7.1f} ms/tok, "
              f"p99 {res.p99_latency:6.1f}s, load {res.replica_load}")

    print("\n=== failure injection: replica 0 dies at t=20s, back at t=40s ===")
    res = ClusterRouter(ClusterConfig(n_replicas=4, router="ewt",
                                      fail_at=20.0, recover_at=40.0),
                        pred).run(trace)
    print(f"  replayed {res.replayed} in-flight requests; "
          f"completed {res.completed}/{res.total} "
          f"(norm {res.normalized_latency*1e3:.1f} ms/tok) — nothing lost.")


if __name__ == "__main__":
    main()
