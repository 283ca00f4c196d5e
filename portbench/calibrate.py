"""Readings that a cell's ``logit_gap`` limit is set from, on the card, in
one process: for each seed a whole run of the cell (set-up from the seed,
a window at the cell's load, the check), the program's widest gap, and
for the ``--control-seeds`` the fp8 control's widest gap on the same
sample of served tokens.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds 20 --out chiprun_out/cal.json

Each seed prints one JSON line.  The limit goes into
``workloads/<cell>.json`` by hand, above the largest program reading and
below the smallest control reading, with both in ``PERF.md``."""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("[calibrate] no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from portbench import bench
    control = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        r = bench.run_cell(args.workload, seed, args.seconds, False,
                           control=seed in control)
        ex = r.pop("_extra")
        row = dict(workload=args.workload, seed=seed, correct=r["correct"],
                   checks={k: c["value"] for k, c in r["checks"].items()},
                   **ex["compare"], finished=ex["finished"],
                   swapped=ex["swapped"], seconds=time.perf_counter() - t0,
                   metrics={k: m["value"] for k, m in r["metrics"].items()})
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
