"""Kernel launches a frame, from the profiler over the profiled frames."""


def read(run):
    p = run.profile
    if run.kind != "render" or p is None or p.units == 0:
        return None
    return p.launches / p.units
