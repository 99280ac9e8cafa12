"""Spreads of end-to-end metrics over sets of runs, as the bounds are set
from them.

    python3 perfbench/tools/spread.py A1.out A2.out ... -- B1.out B2.out ...

Each file holds a run's standard output (its last line the result).
For every metric of each set: the median, and the spread (the distance
between the first and third quartile, `statistics.quantiles(n=4)`, over
the median); then the wider of the two sets' spreads and five times it
(the bound the rule gives, at least 1%); and the second set's median
against the first's.
"""
from __future__ import annotations

import json
import statistics
import sys


def metrics(path):
    with open(path) as f:
        line = f.read().strip().splitlines()[-1]
    return {k: v["value"] for k, v in json.loads(line)["metrics"].items()}


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv):
    cut = argv.index("--")
    sets = [[metrics(p) for p in argv[:cut]], [metrics(p) for p in
                                                argv[cut + 1:]]]
    for name in sets[0][0]:
        vals = [[r[name] for r in s] for s in sets]
        sp = [spread(v) for v in vals]
        med = [statistics.median(v) for v in vals]
        print(json.dumps({"metric": name, "medians": med, "spreads": sp,
                          "widest": max(sp),
                          "bound_5x": max(0.01, 5 * max(sp)),
                          "second_vs_first": med[1] / med[0] - 1,
                          "values": vals}))


if __name__ == "__main__":
    main(sys.argv[1:])
