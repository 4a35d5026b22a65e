"""Device ms a step of the kernels that are not the port's own
(PyTorch's operators), from the profiler."""


def read(run):
    p = run.profile
    if run.kind != "train" or p is None or p.units == 0:
        return None
    return p.torch_ms / p.units
