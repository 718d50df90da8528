"""Audio-seconds trained (B x T x frame step x stacking a step, summed
over ranks) over the window's wall time, ended by a synchronise."""


def read(run):
    if not run.steps or run.window_s <= 0:
        return None
    return run.audio_s / run.window_s
