"""The controls of a cell's correctness limits, read on the card at the
cell's own size (not run by the benchmark's own runs).

  python3 benchmark/tools/control.py --workload <cell> --seeds 11 12 13 \\
      [--program [--seconds 2]]

Prints one JSON line a seed.

No window.  The plain reference's steps from the seed's weights and
batches in fp32, against the same reference (the program's place) computed
in fp8 (`control`), and with each fault a training step can have: half of
the batch left out with the mean over the rest (`half_batch`), and on more
than one rank the exchange left out, each rank stepping on its own rows
(`no_exchange`, rank 0's rows).  A state left unchanged reads 1 on
`change_gap` and `grad_gap` by their definition and needs no run.  Each
prints `loss_gap`, `grad_gap` and `change_gap` as the benchmark computes
them, and beside them the worst leaf's gaps against its own norm alone.

With --program, each seed is a whole run of the cell instead (a window of
--seconds), whose readings are the sound program's: the lower readings of
the limits, many seeds read in one process.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
for p in (os.path.dirname(os.path.dirname(HERE)), os.path.dirname(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from benchlib import traffic as trafmod  # noqa: E402
from benchlib.spec import find_cell  # noqa: E402
from benchlib.weights import make_weights  # noqa: E402
from reference import transducer as ref  # noqa: E402


def numbers(got, want):
    moved = ref.moved_leaves(want["grad_norms"])
    grad_gap, _ = ref.worst_leaf_gap(got["grad_norms"], want["grad_norms"])
    change_gap, _ = ref.worst_leaf_gap(got["change_norms"],
                                       want["change_norms"], moved)
    return {"loss_gap": ref.loss_gap(got["losses"], want["losses"]),
            "grad_gap": grad_gap, "change_gap": change_gap,
            **ref.own_norm_gaps(got["grad_norms"], got["change_norms"], want,
                                moved)}


def train_controls(cell, seed, dev):
    from drivers.train_step import dtype_of

    m, tr = cell.model_fields(), cell.traffic
    ref.exact_matmuls()
    w = make_weights(m, seed, dev, dtype_of(m))
    batches = trafmod.train_batches(m, tr["reference_steps"], tr["batch"],
                                    tr["frames"], tr["labels"], seed, dev,
                                    dtype_of(m))
    steps = tr["reference_steps"]
    want = ref.train_reference(w, batches, m, steps=steps)
    out = {"control": numbers(ref.train_reference(w, batches, m, steps=steps,
                                                  low=True), want),
           "half_batch": numbers(ref.train_reference(
               w, batches, m, steps=steps, rows=tr["batch"] // 2), want)}
    if tr.get("ranks", 1) > 1:
        out["no_exchange"] = numbers(ref.train_reference(
            w, batches, m, steps=steps, rows=tr["batch"] // tr["ranks"]),
            want)
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true",
                   help="read a whole run of the program at each seed")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args()
    cell = find_cell(args.workload)
    dev = torch.device("cuda")
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.program:
            from drivers import train_step

            r = train_step.run(cell, seed, args.seconds, False, t0)
            rec = {"program": dict(r.notes["readings"], correct=r.correct)}
        else:
            rec = train_controls(cell, seed, dev)
        rec.update(workload=args.workload, seed=seed,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
