"""Find a cell's declarations by name.

`BENCHMARK.json` (at the checkout's root) lists the cells; each names a
configuration (`configs/<config>.json`), a traffic mix
(`traffic/<traffic>.json`, which names its driver in `drivers/`) and has a
cell file of its own (`workloads/<cell>.json`: the limits of its
correctness check and their readings).  A metric applies to a cell when its
entry lists the cell under `workloads`, or has no such list.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark_json() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict          # configs/<config>.json
    traffic_name: str
    traffic: dict         # traffic/<traffic>.json
    limits: Dict[str, float]   # workloads/<cell>.json "limits"
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def driver(self) -> str:
        return self.traffic["driver"]

    def model_fields(self) -> dict:
        """RNNTConfig keyword arguments of the configuration as run."""
        return dict(self.config["model"])


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, spec: dict = None) -> Cell:
    spec = spec if spec is not None else benchmark_json()
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    cell_file = load_json(os.path.join(BENCH_DIR, "workloads",
                                       name + ".json"))
    return Cell(
        name=name, chips=int(entry["chips"]), config_name=conf["name"],
        config=load_json(os.path.join(ROOT, conf["file"])),
        traffic_name=entry["traffic"],
        traffic=load_json(os.path.join(BENCH_DIR, "traffic",
                                       entry["traffic"] + ".json")),
        limits=dict(cell_file["limits"]),
        end_to_end=[m for m in spec["end_to_end"] if applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if applies(m, name)])
