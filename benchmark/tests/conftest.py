"""CPU tests of the benchmark (run with `python -m pytest benchmark/tests`).

Tiny cells: the model of the program's `tiny_config` in fp32, with traffic
shrunk to what a CPU test can hold.  Tests that need the card decide so
inside the test and skip on the CPU.
"""

import dataclasses
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

torch.set_num_threads(1)

from benchlib.spec import Cell  # noqa: E402


def tiny_model(**over) -> dict:
    from rnnt_tpu_torch.config import tiny_config

    return dataclasses.asdict(tiny_config(compute_dtype="float32", **over))


def tiny_cell(kind: str, limits=None, **traffic) -> Cell:
    tr = {"driver": "train_step", "batch": 4, "frames": 12, "labels": 5,
          "ranks": 1, "distinct_batches": 4, "loss_impl": "fused",
          "reference_steps": 3, "profile_steps": 2}
    tr.update(traffic)
    lim = limits or {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3,
                     "grad_gap_own_norm": 1e-3, "change_gap_own_norm": 1e-3}
    return Cell(name="tiny." + kind, chips=1, config_name="tiny",
                config={"model": tiny_model()}, traffic_name="tiny",
                traffic=tr, limits=lim, end_to_end=[], per_layer=[])


@pytest.fixture
def cells():
    return tiny_cell
