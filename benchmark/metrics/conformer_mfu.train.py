"""Model operations of the window's Conformer-Transducer steps (3 x the
forward's products of the subsampling, the blocks, the prediction net and
the joint; `benchlib.conformer_flops`) over the window's wall time x 989
TFLOP/s (bf16 peak of one H100 at 700 W), in percent.  The loss
backward's recomputation is not counted."""

from benchlib.conformer_flops import train_step_flops
from benchlib.flops import PEAK_FLOPS


def read(run):
    if (run.m.get("encoder_type") != "conformer" or not run.steps
            or run.window_s <= 0):
        return None
    B, T, U = run.batch
    return (100.0 * run.steps * train_step_flops(run.m, B, T, U)
            / (run.window_s * PEAK_FLOPS))
