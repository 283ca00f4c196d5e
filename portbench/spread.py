"""The spread of a cell's runs, as a bound is set from it: for each metric,
each set's median and its spread (the distance between the first and the
third quartile of ``statistics.quantiles(values, n=4)``, over the median),
the wider of the sets' spreads, five times it (never under 1%), and how
far the second set's median lies from the first's.

    python3 portbench/spread.py set1.jsonl set2.jsonl

Each file holds result lines (the last stdout line of ``run.py``), one per
run; lines whose ``correct`` is false are counted and left out."""
import json
import statistics
import sys


def load(path):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{"):
                rows.append(json.loads(line))
    return rows


def spread(values):
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def report(sets):
    names = sorted({k for rows in sets for r in rows for k in r["metrics"]})
    out = {}
    for name in names:
        vals = [[r["metrics"][name]["value"] for r in rows
                 if r["correct"] and name in r["metrics"]] for rows in sets]
        if any(len(v) < 2 for v in vals):
            continue
        meds = [statistics.median(v) for v in vals]
        spreads = [spread(v) for v in vals]
        widest = max(spreads)
        out[name] = dict(medians=meds, spreads=spreads, widest=widest,
                         bound=max(0.01, 5 * widest),
                         second_vs_first=meds[-1] / meds[0] - 1,
                         values=vals)
    return out


def main(argv):
    sets = [load(p) for p in argv]
    for p, rows in zip(argv, sets):
        bad = sum(1 for r in rows if not r["correct"])
        print(f"{p}: {len(rows)} runs, {bad} not correct")
    for name, r in report(sets).items():
        print(f"{name}: medians {['%.6g' % m for m in r['medians']]} "
              f"spreads {['%.4f' % s for s in r['spreads']]} bound "
              f"{r['bound']:.4f} second/first {r['second_vs_first']:+.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
