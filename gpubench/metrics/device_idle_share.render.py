"""The device's idle share over the profiled frames: 1 - (the union of its
activity intervals) / (the stretch's host wall time)."""


def read(run):
    p = run.profile
    if run.kind != "render" or p is None or p.window_s <= 0:
        return None
    return 1.0 - p.busy_s / p.window_s
