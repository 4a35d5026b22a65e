"""Kernel launches a step, from the profiler over the profiled steps."""


def read(run):
    p = run.profile
    if run.kind != "train" or p is None or p.units == 0:
        return None
    return p.launches / p.units
