"""Seconds from process start to the window's start: imports, CUDA
initialisation, the scene build, the step build and the warm-up (with the
kernels' build on a checkout's first run)."""


def read(run):
    return run.setup_s
