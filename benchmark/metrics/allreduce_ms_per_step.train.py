"""Device milliseconds a step of NCCL's kernels on rank 0 (the gradient
bucket's all-reduce, the global BatchNorm sums, the loss denominator)."""

from benchlib import kernels
from benchlib.profile import kernel_seconds


def read(run):
    p = run.profile
    if not p or run.ranks < 2:
        return None
    return (kernel_seconds(p["device"], kernels.NCCL) * 1e3
            / run.traffic["profile_steps"])
