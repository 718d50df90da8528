"""K6 (the joint planes, its weight pack included): the least time of a
step's K6 call from its shapes over the profiler's K6 time a step, in
percent."""

from benchlib import kernels
from benchlib.flops import planes_least_s
from benchlib.profile import kernel_seconds


def read(run):
    p = run.profile
    if not p:
        return None
    t = kernel_seconds(p["device"], kernels.K6) / run.traffic["profile_steps"]
    B, T, U = run.batch
    return 100.0 * planes_least_s(run.m, B, T, U + 1) / t if t else None
