"""Share of the profiled slice of training steps in which no device
operation ran (profiler clock, between two marker spins), in percent."""


def read(run):
    p = run.profile
    if not p or p["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])
