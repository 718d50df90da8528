"""A run's record, its metrics and the result line.

A driver returns a `Run`.  `run.py` reads the cell's metrics from it
through the readers in `metrics/`, each found by its name, and prints the
result: the compared numbers beside their limits as the last lines of
standard error, then one JSON line as the last line of standard output,
with the same numbers under `checks`, its last key.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
from typing import Dict, Optional

from benchlib.spec import BENCH_DIR


@dataclasses.dataclass
class Run:
    m: dict                       # the configuration's model fields
    traffic: dict
    device: dict                  # the result's "device" (less busy/window)
    setup_s: float
    attempted: int
    failed: int
    checks: Dict[str, list]       # name -> [value, limit]; value <= limit
    window_s: float = 0.0
    steps: int = 0
    audio_s: float = 0.0          # audio trained in the window, all ranks
    ranks: int = 1
    batch: tuple = ()             # (B per rank, T, U) of a training cell
    profile: Optional[dict] = None
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return all(v is not None and math.isfinite(v) and v <= lim
                   for v, lim in self.checks.values())


def read_metric(name: str, run: Run) -> Optional[float]:
    """The value of metric `name`, from `metrics/<name>.py`'s read(run);
    None when it finds nothing to read."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    value = mod.read(run)
    return None if value is None else float(value)


def emit(run: Run, metrics: Dict[str, dict], device: dict,
         breakdown=None) -> None:
    for name, (value, limit) in run.checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    line = {"correct": run.correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {n: {"value": v, "limit": lim}
                      for n, (v, lim) in run.checks.items()}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
