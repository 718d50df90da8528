"""The control: the reference in the program's place, one precision below
(fp8), must fail a cell's limits.  On the CPU at the tiny model it must
read far above a sound run; on the card (skipped here) at the cell's own
size, on three seeds, above the committed limits."""

import time

import pytest
import torch

from benchlib.spec import find_cell
from conftest import tiny_cell
from tools import control

CPU = torch.device("cpu")


def test_training_control_reads_far_above_a_sound_run():
    from drivers import train_step

    cell = tiny_cell("train")
    sound = train_step.run(cell, 5, 0.3, False, time.perf_counter(),
                           device="cpu")
    ctl = control.train_controls(cell, 5, CPU)
    for name in ("loss_gap", "grad_gap"):
        assert ctl["control"][name] > 30 * sound.checks[name][0], (ctl, name)
    gaps = ("loss_gap", "grad_gap", "change_gap")
    assert max(ctl["half_batch"][n] for n in gaps) > 30 * max(
        sound.checks[n][0] for n in gaps)


@pytest.mark.parametrize("workload", ["wp4096.train-b96",
                                      "char31.train-b96"])
def test_control_fails_the_committed_limits_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control runs at the cell's size")
    cell = find_cell(workload)
    for seed in (101, 202, 303):
        ctl = control.train_controls(cell, seed, torch.device("cuda"))
        assert any(ctl["control"][n] > cell.limits[n]
                   for n in cell.limits)
