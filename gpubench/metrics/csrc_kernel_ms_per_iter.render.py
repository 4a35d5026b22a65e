"""Device ms a frame of the port's own kernels (the ``__global__``
functions of its ``csrc/*.cu``), from the profiler. None where no such
kernel ran."""


def read(run):
    p = run.profile
    if run.kind != "render" or p is None or p.units == 0 or p.csrc_ms <= 0:
        return None
    return p.csrc_ms / p.units
