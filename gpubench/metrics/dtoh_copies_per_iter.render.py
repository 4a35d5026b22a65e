"""Device-to-host copies a frame (each one drains the queue), from the
profiler."""


def read(run):
    p = run.profile
    if run.kind != "render" or p is None or p.units == 0:
        return None
    return p.dtoh / p.units
