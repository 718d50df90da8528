"""Device milliseconds a step of every operation that is none of K4-K7, a
cuBLAS product or an NCCL collective: the train step's elementwise work,
reductions and copies."""

from benchlib import kernels


def read(run):
    p = run.profile
    if not p:
        return None
    glue = sum(e - s for n, s, e in p["device"]
               if not any(k in n for k in kernels.NAMED))
    return glue / 1e3 / run.traffic["profile_steps"]
