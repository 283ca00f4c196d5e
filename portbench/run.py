"""Run one cell of the port's benchmark once, on the card of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON object as the last line of standard output (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit);
the same numbers are the last lines of standard error.  ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer ones.
Exits non-zero and prints no result without enough CUDA cards, when the
program cannot be imported, or when a module of JAX or of the JAX package
was loaded.  Kernels build into ``build/`` inside the checkout at the first
run and are loaded from there after."""
import time

T_START = time.perf_counter()          # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one process with few threads: the host's work is the engine's Python
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "4")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import spec
    chips = spec.cell(args.workload).entry["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"[portbench] {args.workload} needs {chips} CUDA card(s); "
              f"this machine has {n}: no result", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from portbench import bench
    result = bench.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), device="cuda",
                            t_start=T_START)
    extra = result.pop("_extra")
    bad = bench.forbidden_modules()
    if bad:
        print(f"[portbench] modules of JAX or of the JAX package loaded: "
              f"{bad}: no result", file=sys.stderr)
        return 3
    cmp = extra["compare"]
    print(f"[portbench] compared {cmp['compared_tokens']} served tokens of "
          f"{cmp['compared_requests']} requests ({cmp['compared_swapped']} "
          f"swapped), argmax agreement {cmp['argmax_agree']}, widest gap "
          f"{cmp.get('logit_gap')}, gap mean "
          f"{cmp.get('logit_gap_mean')} p99 {cmp.get('logit_gap_p99')} miss "
          f"{cmp.get('logit_gap_miss')}; "
          f"{extra['finished']} finished, {extra['swapped']} swapped in the "
          "window", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"[check] {k} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
