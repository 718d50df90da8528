"""Scalar metrics to JSONL: the port of `rnnt_tpu.train.observe` without its
optional TensorBoard writer.  One `metrics.jsonl` record per call
({"step", "time", name: value...}) and an `hparams.json` of the config,
under log_dir/run_name."""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Optional


class MetricsWriter:
    def __init__(self, log_dir: str, run_name: Optional[str] = None):
        run_name = run_name or time.strftime("%Y%m%d-%H%M%S")
        self.dir = os.path.join(log_dir, run_name)
        os.makedirs(self.dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def hparams(self, cfg) -> None:
        with open(os.path.join(self.dir, "hparams.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2, sort_keys=True)

    def close(self) -> None:
        self._jsonl.close()
