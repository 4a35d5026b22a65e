"""Rays per second: pixels x depth x whole frames of the window, over the
time from its start to the synchronised end of its last frame (host clock).
Nominal rays: the same whatever implements the intersector."""


def read(run):
    if run.kind != "render" or run.window_s <= 0:
        return None
    return run.pixels * run.depth * run.units / run.window_s
