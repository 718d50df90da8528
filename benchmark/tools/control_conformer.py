"""The controls of the Conformer cell's correctness limits, read on the
card at the cell's own size (not run by the benchmark's own runs): the
counterpart of `control.py` for `drivers/train_step_conformer.py`.

  python3 benchmark/tools/control_conformer.py \\
      --workload conformer-l.train-b64 --seeds 11 12 13 \\
      [--program [--seconds 2]]

Prints one JSON line a seed.

No window.  The plain reference's Adam steps from the seed's weights and
batches in fp32, against the same reference (the program's place)
computed in fp8 (`control`) and with half of the batch left out, the mean
over the rest (`half_batch`).  A state left unchanged reads 1 on
`change_gap` and `grad_gap` by their definition and needs no run.  With
--program, each seed is a whole run of the cell instead (a window of
--seconds), whose readings are the sound program's.
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
from benchlib.conformer_weights import make_weights  # noqa: E402
from benchlib.spec import find_cell  # noqa: E402
from reference import conformer_transducer as ref  # noqa: E402
from tools.control import numbers  # noqa: E402


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
    return {"control": numbers(ref.train_reference(w, batches, m, steps=steps,
                                                   low=True), want),
            "half_batch": numbers(ref.train_reference(
                w, batches, m, steps=steps, rows=tr["batch"] // 2), want)}


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
            from drivers import train_step_conformer

            r = train_step_conformer.run(cell, seed, args.seconds, False, t0)
            rec = {"program": dict(r.notes["readings"], correct=r.correct),
                   "memory_peak_bytes": r.device["memory_peak_bytes"]}
        else:
            rec = train_controls(cell, seed, dev)
        rec.update(workload=args.workload, seed=seed,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
