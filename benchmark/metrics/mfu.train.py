"""Model operations of the window's steps on one card (3 x the forward's
products of encoder, prediction net and joint at the rank's batch) over
the window's wall time x 989 TFLOP/s (bf16 peak of one H100 at 700 W), in
percent.  The loss backward's recomputation is not counted."""

from benchlib.flops import PEAK_FLOPS, train_step_flops


def read(run):
    if not run.steps or run.window_s <= 0:
        return None
    B, T, U = run.batch
    return (100.0 * run.steps * train_step_flops(run.m, B, T, U)
            / (run.window_s * PEAK_FLOPS))
