"""Device time a step of a training cell, split by the program's spans.

  python3 benchmark/tools/span_split.py --workload <cell> --seeds 11 12 \\
      [--seconds 51]

Runs the cell as `run.py --trace 1` does (its driver: set-up, window,
traced slice; the driver reads its slice through the module name
`profile_slice`, which this tool replaces) and digests the one recorded
slice twice: as the benchmark does (`benchlib.profile.digest`, from which
the cell's per-layer metrics are read) and with the program's spans
(`benchlib.spans.digest`).  Prints one JSON line a seed:
- `metrics`: the cell's per-layer metrics from the benchmark's digest;
  `metrics_by_spans`: the same readers on the span digest (the two differ
  only where the session held user-annotation device records);
- `split_ms_per_step`: device ms a step of the records launched in the
  LSTM spans, the loss spans, the norms and update spans, all others, and
  `no_span` (launched in no span, a part of `other`), with `total`, every
  record's;
- `by_span_ms_per_step`: device ms a step by innermost span, and
  `glue_by_span_ms_per_step` the same of the records
  `glue_ms_per_step.train` counts (none of K4-K7, cuBLAS or NCCL);
- `step_ms`: a step's wall time in the window and in the traced slice;
- `spans`: each span's count in the slice; `idle_gaps`: the span digest's
  idle gaps, named by span.
A program without spans puts every record in `other` and `no_span`.
"""

import argparse
import collections
import dataclasses
import importlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
for p in (os.path.dirname(os.path.dirname(HERE)), os.path.dirname(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)
ROOT = os.path.dirname(os.path.dirname(HERE))
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(ROOT, ".bench_cache", "triton"))

from benchlib import device as devmod  # noqa: E402
from benchlib import kernels  # noqa: E402
from benchlib import profile, spans  # noqa: E402
from benchlib.result import read_metric  # noqa: E402
from benchlib.spec import find_cell  # noqa: E402


def traced_run(cell, seed: int, seconds: float):
    """(the driver's Run, the span digest of its traced slice)."""
    driver = importlib.import_module(f"drivers.{cell.driver}")
    taken = []

    def profile_slice(fn, attempts: int = 2):
        for _ in range(attempts):
            prof = profile.record(fn)
            out = profile.digest(prof)
            if out is not None:
                taken.append(spans.digest(prof))
                return out
        return None

    accepted = driver.profile_slice
    driver.profile_slice = profile_slice
    try:
        run = driver.run(cell, seed, seconds, True, time.perf_counter())
    finally:
        driver.profile_slice = accepted
    return run, (taken[0] if taken else None)


def by_span(d: dict, steps: int, glue: bool = False) -> dict:
    """Device ms a step by innermost span ("none": launched in none)."""
    out = collections.Counter()
    for (n, s, e), span in zip(d["device"], d["device_span"]):
        if not glue or not any(k in n for k in kernels.NAMED):
            out[span or "none"] += (e - s) / 1e3 / steps
    return dict(out.most_common())


def line(cell, seed: int, seconds: float) -> dict:
    run, by_spans = traced_run(cell, seed, seconds)
    if run.profile is None or by_spans is None:
        raise SystemExit("the traced slice recorded no markers")
    names = [m["name"] for m in cell.per_layer]
    steps = cell.traffic["profile_steps"]
    split = spans.group_ms_per_step(by_spans, steps)
    split["total"] = sum(by_span(by_spans, steps).values())
    span_run = dataclasses.replace(run, profile=by_spans)
    return {"workload": cell.name, "seed": seed, "correct": run.correct,
            "device": {**run.device, "card": devmod.power_line()},
            "metrics": {n: read_metric(n, run) for n in names},
            "metrics_by_spans": {n: read_metric(n, span_run) for n in names},
            "split_ms_per_step": split,
            "by_span_ms_per_step": by_span(by_spans, steps),
            "glue_by_span_ms_per_step": by_span(by_spans, steps, glue=True),
            "step_ms": {"window": 1e3 * run.window_s / run.steps,
                        "traced": 1e3 * run.profile["wall_s"] / steps},
            "spans": dict(collections.Counter(s[0]
                                              for s in by_spans["spans"])),
            "idle_gaps": by_spans["breakdown"]["idle_gaps"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    args = p.parse_args(argv)
    cell = find_cell(args.workload)
    devmod.require_cards(cell.chips)
    for seed in args.seeds:
        print(json.dumps(line(cell, seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
