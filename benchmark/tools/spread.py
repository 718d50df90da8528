"""Spread of a cell's runs, as the bounds are set from it.

  python3 benchmark/tools/spread.py RESULTS.jsonl [RESULTS2.jsonl ...]

Each file holds result lines (the last line of run.py's output) of one set
of runs.  For every metric of every file: the median and the spread, the
distance between the first and third quartiles (Python's
statistics.quantiles(values, n=4)) as a share of the median; then, per
metric, the wider of the sets' spreads and five times it.
"""

import json
import statistics
import sys


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(paths):
    widest = {}
    for path in paths:
        rows = [json.loads(line) for line in open(path) if line.strip()]
        names = sorted({n for r in rows for n in r["metrics"]})
        for n in names:
            vals = [r["metrics"][n]["value"] for r in rows if n in r["metrics"]]
            if len(vals) < 2:
                continue
            s = spread(vals)
            widest[n] = max(widest.get(n, 0.0), s)
            print(json.dumps({"set": path, "metric": n, "runs": len(vals),
                              "median": statistics.median(vals),
                              "spread": s, "values": vals}))
        print(json.dumps({"set": path, "correct": [r["correct"] for r in rows]}))
    for n, s in widest.items():
        print(json.dumps({"metric": n, "widest_spread": s,
                          "five_times": 5 * s}))


if __name__ == "__main__":
    main(sys.argv[1:])
