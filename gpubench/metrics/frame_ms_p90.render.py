"""The 90th percentile of the window's frame times (ms, host clock, each
frame ended by a synchronise), in the traced run, whose window has no
profiler on. The sample count is logged on standard error."""

from gpubench.harness import quantile


def read(run):
    if run.kind != "render":
        return None
    return quantile(run.unit_ms, 0.9)
