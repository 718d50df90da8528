"""The benchmark of the PyTorch and CUDA port (`rnnt_tpu_torch`).

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
      --trace <0|1>

Runs one cell of BENCHMARK.json on the cards of this machine and prints,
as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), `device`, with --trace 1 `breakdown`, and
last `checks`, each compared number beside its limit (also the last lines
of standard error).  It exits non-zero and prints no result without the
cards the cell asks for, or if a JAX module was loaded.

The cell's configuration, traffic, driver and metric readers are files
under this directory, found by name (see benchlib/spec.py).  Kernel build
caches stay inside the checkout.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def metrics_of(run, entries) -> dict:
    from benchlib.result import read_metric

    out = {}
    for e in entries:
        v = read_metric(e["name"], run)
        if v is not None:
            out[e["name"]] = {"value": v, "unit": e["unit"]}
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    from benchlib import device as devmod
    from benchlib.result import emit
    from benchlib.spec import find_cell

    cell = find_cell(args.workload)
    devmod.require_cards(cell.chips)
    driver = importlib.import_module(f"drivers.{cell.driver}")
    run = driver.run(cell, args.seed, args.seconds, bool(args.trace), T0)
    device = dict(run.device)
    breakdown = None
    if args.trace:
        entries = cell.per_layer
        prof = run.profile
        if prof is None:
            sys.exit("the traced slice recorded no markers: no device trace")
        device["busy_s"] = prof.get("busy_s_mean") or prof["busy_s"]
        device["window_s"] = prof["wall_s"]
        breakdown = prof["breakdown"]
    else:
        entries = cell.end_to_end
    metrics = metrics_of(run, entries)
    bad = devmod.forbidden_loaded()
    if bad:
        sys.exit(f"forbidden modules loaded: {', '.join(bad)}")
    print(json.dumps({"notes": run.notes}, default=str), file=sys.stderr)
    emit(run, metrics, device, breakdown)
    return 0


if __name__ == "__main__":
    sys.exit(main())
