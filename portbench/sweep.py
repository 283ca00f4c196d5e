"""Find a cell's knee once, on the card: the highest Poisson rate at which
the backlog of requests due and not yet given their first token does not
grow from the window's first quarter to its last.

    python3 portbench/sweep.py --workload <cell> --rates 3,4,5,6 --seconds 30

One process builds the cell's engine once (its configuration, its mix,
its lanes or ``--lanes``; weights and predictor from ``--seed``), then
serves one window at each rate, in the order given, draining the engine
between them; it stops after the first rate whose backlog grows.  Each rate prints one JSON
line (and all go to ``chiprun_out/sweep_<cell>.json`` when ``--out`` names
it): offered and completed tokens per second, the TTFT p90, the backlog's
mean over the first and the last quarter of the window and whether it
grew.  The knee is written into the cell files by hand, with the readings
in ``PERF.md``."""
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import argparse  # noqa: E402
import json  # noqa: E402

# a backlog that rises by more than this many requests from the first
# quarter to the last grows
GROWTH_REQUESTS = 2.0


def backlog(recs, t: float) -> int:
    """Requests due by ``t`` with no first token received by then."""
    return sum(1 for r in recs.values() if r.due <= t
               and not (r.token_t and r.token_t[0] <= t))


def quarter_means(recs, seconds: float, step: float = 0.25):
    ts = [i * step for i in range(int(seconds / step))]
    q = len(ts) // 4
    first = sum(backlog(recs, t) for t in ts[:q]) / q
    last = sum(backlog(recs, t) for t in ts[-q:]) / q
    return first, last


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--lanes", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("[sweep] no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from portbench import bench, e2e, profiling, spec
    from portbench.arch import from_config
    from portbench.traffic import gen
    cell = spec.cell(args.workload)
    a = from_config(cell.config)
    dev = torch.device("cuda")
    ov = {"lanes": args.lanes} if args.lanes else None
    eng, mix = bench.build(cell, a, args.seed, dev, ov)
    print(f"[sweep] {args.workload}: {eng.cfg.max_slots} lanes, set-up "
          f"{time.perf_counter() - T_START:.1f} s on "
          f"{torch.cuda.get_device_name(0)}", file=sys.stderr)
    rows = []
    for rate in [float(x) for x in args.rates.split(",")]:
        timed = gen.generate(mix, rate, args.seconds, args.seed, a.vocab)
        reqs, recs = bench.requests(timed)
        bench.window(eng, reqs, recs, args.seconds, False,
                     cell.file["trace_window"], profiling.Spans())
        first, last = quarter_means(recs, args.seconds)
        offered = sum(t.out_len for t in timed) / args.seconds
        row = dict(workload=args.workload, rate=rate, seconds=args.seconds,
                   requests=len(timed), offered_tokens_per_s=offered,
                   tokens_per_s=e2e.tokens_per_s(recs, args.seconds),
                   ttft_p90_s=e2e.ttft_p90_s(recs, args.seconds),
                   itl_p99_ms=e2e.itl_p99_ms(recs, args.seconds),
                   backlog_first_quarter=first, backlog_last_quarter=last,
                   grows=last > first + GROWTH_REQUESTS,
                   decode_step_ms=(sum(d[3] for d in eng.iter_times)
                                   / max(len(eng.iter_times), 1) * 1e3),
                   lanes_busy_mean=(sum(d[2] for d in eng.iter_times)
                                    / max(len(eng.iter_times), 1)),
                   memory_peak_bytes=torch.cuda.max_memory_allocated())
        eng.iter_times.clear()
        eng.prefill_times.clear()
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rows, f, indent=1)
        if row["grows"]:
            break
        eng.drain()
    return 0


if __name__ == "__main__":
    sys.exit(main())
