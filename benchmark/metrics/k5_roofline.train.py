"""K5 (the LSTM backward): the least time of a step's K5 calls from
their shapes (operations over 989 TFLOP/s or bytes over 3.35 TB/s, the
larger) over the profiler's K5 time a step, in percent."""

from benchlib import kernels
from benchlib.flops import lstm_least_s
from benchlib.profile import kernel_seconds


def read(run):
    p = run.profile
    if not p:
        return None
    t = kernel_seconds(p["device"], kernels.K5) / run.traffic["profile_steps"]
    B, T, U = run.batch
    return 100.0 * lstm_least_s(run.m, B, T, U + 1, True) / t if t else None
