"""Device ms a frame of the kernels launched inside the mesh intersector's
spans (``kdpt.intersect.<route>``), from the span stretch
(``spans.SpanProfile.metrics``). None without a span stretch."""


def read(run):
    sp = getattr(run, "spans", None)
    if run.kind != "render" or sp is None:
        return None
    return sp.metrics(run.kind, run.pixels, run.depth).get("intersect_device_ms_per_iter.render")
