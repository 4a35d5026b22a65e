"""Milliseconds a training step: the window over its whole steps (host clock)."""


def read(run):
    if run.kind != "train" or run.units == 0:
        return None
    return run.window_s * 1e3 / run.units
