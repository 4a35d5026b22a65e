"""The span stretch (``gpubench/spans.py``) on the CPU: its reduction of a
synthetic trace with known answers, its records of a real CPU profile, and
a shrunk cell run with the span stretch, whose result keeps what the plain
traced run gives.

    python -m pytest gpubench/tests -q
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from gpubench import harness, spans  # noqa: E402
from gpubench.spans import DeviceOp, HostSpan  # noqa: E402

MS = 1_000_000  # ns


def _span(name, a, b, thread=1):
    return HostSpan(name, int(a * MS), int(b * MS), thread)


def _op(kind, a, b, launch, name="k"):
    return DeviceOp(kind, int(a * MS), int(b * MS), None if launch is None else int(launch * MS),
                    name)


def synthetic():
    """A frame of one bounce and a training step, with a kernel launched
    from a second thread inside the backward pass, a device-side copy of a
    span, a kernel with no launch, a kernel outside every span and gaps
    opening before, inside, between and after the spans."""
    host = [
        _span("kdpt.frame", 0, 100), _span("kdpt.camera", 0, 10), _span("kdpt.bounce", 10, 60),
        _span("kdpt.intersect.pairs", 15, 39.5), _span("kdpt.pairs.pass1", 16, 30),
        _span("kdpt.shade", 45, 55), _span("kdpt.gather", 60, 70),
        _span("kdpt.train_step", 100, 200), _span("kdpt.forward", 100, 130),
        _span("kdpt.backward", 130, 180), _span("kdpt.optimizer", 180, 195),
        _span("kdpt.bounce", 140, 145, thread=2),  # not the frame's thread: ignored
    ]
    dev = [
        _op("kernel", 2, 8, 1),  # camera
        _op("kernel", 17, 25, 16.5),  # pass1
        _op("kernel", 35, 38, 33),  # the pair intersector's own
        _op("dtoh", 39, 40, 38.5),  # the pair intersector's host read
        _op("kernel", 47, 50, 46),  # shade
        _op("kernel", 62, 63, None),  # no launch linked: by its start, in the gather
        _op("kernel", 140, 150, 135, "bwd"),  # launched on the backward's thread
        _op("kernel", 150, 160, 136, "bwd"),
        _op("kernel", 206, 210, 205),  # outside every span
        _op("annotation", 0, 100, None),  # the frame's device-side copy: not busy
    ]
    return host, dev


def test_summarize_spans_known_answers():
    host, dev = synthetic()
    sp = spans.summarize_spans(host, dev, units=1, window_s=0.215, stretch=(-5 * MS, 210 * MS),
                               counters={"live_lanes": [100, 60]})
    st = sp.stages
    assert st["kdpt.bounce"]["count"] == 1
    # idle: the stretch's 215 ms less 46 busy, by the span that held each gap's opening
    assert sp.busy_s == pytest.approx(0.046) and sp.idle_s == pytest.approx(0.169)
    want_idle = {"kdpt.camera": 9, "kdpt.pairs.pass1": 10, "kdpt.intersect.pairs": 1,
                 "kdpt.bounce": 7, "kdpt.shade": 12, "kdpt.gather": 77, "kdpt.backward": 46}
    for name, r in st.items():
        assert r["self"]["idle_ms"] == pytest.approx(want_idle.get(name, 0)), name
    assert sp.outside["idle_ms"] == pytest.approx(7)
    assert sp.idle_attributed_ms() == pytest.approx(169)
    # kernels by launch, the second thread's by time
    assert st["kdpt.backward"]["self"]["device_ms"] == pytest.approx(20)
    assert st["kdpt.backward"]["self"]["launches"] == 2
    assert st["kdpt.gather"]["self"]["device_ms"] == pytest.approx(1)
    assert sp.outside["device_ms"] == pytest.approx(4) and sp.outside["launches"] == 1
    assert sp.device_ms() == pytest.approx(45)
    assert sp.kernels["kdpt.backward"] == {"bwd": [pytest.approx(20), 2]}
    assert sp.kernels["(outside spans)"] == {"k": [pytest.approx(4), 1]}
    assert st["kdpt.intersect.pairs"]["incl"] == pytest.approx(
        {"host_ms": 24.5, "device_ms": 11, "launches": 2, "dtoh": 1, "idle_ms": 11})
    assert st["kdpt.bounce"]["self"]["host_ms"] == pytest.approx(50 - 24.5 - 10)
    assert st["kdpt.frame"]["self"]["host_ms"] == pytest.approx(100 - 10 - 50 - 10)
    assert st["kdpt.frame"]["incl"]["idle_ms"] == pytest.approx(9 + 10 + 1 + 7 + 12 + 77)
    b, = sp.bounces
    assert b["incl"] == pytest.approx(
        {"host_ms": 50, "device_ms": 14, "launches": 3, "dtoh": 1, "idle_ms": 10 + 1 + 7 + 12})
    assert b["live_lanes"] == 100

    m = sp.metrics("render", pixels=100, depth=2)
    assert m == pytest.approx({
        "intersect_host_ms_per_iter.render": 24.5, "intersect_device_ms_per_iter.render": 11,
        "intersect_idle_ms_per_iter.render": 11,
        "wavefront_idle_ms_per_iter.render": 9 + 12 + 77 + 7,
        "live_lane_share.render": 0.8})
    assert sp.metrics("train", 100, 2) == pytest.approx({
        "backward_host_ms_per_step.train": 50, "backward_idle_ms_per_step.train": 46})
    c = sp.checks()
    assert c["outside_device_share"] == pytest.approx(4 / 45)
    assert c["idle_attributed_over_stretch"] == pytest.approx(1.0)


def test_summarize_spans_without_device_activity():
    host, dev = synthetic()
    assert spans.summarize_spans(host, [o for o in dev if o.kind == "annotation"], 1, 0.2,
                                 (0, 200 * MS)) is None
    assert spans.summarize_spans([h for h in host if h.name == "kdpt.bounce"], dev, 1, 0.2,
                                 (0, 200 * MS)) is None


def test_records_of_a_cpu_profile():
    """The port's spans and the stretch's range come out of a real CPU
    trace; with no device, the reduction finds nothing to read."""
    from kdtreepathtraceroptimization_tpu_torch.utils import trace

    def unit(k):
        with trace.span("kdpt.frame"):
            with trace.span("kdpt.bounce"):
                trace.add("live_lanes", torch.ones(5, dtype=torch.bool), 0)
                torch.ones(8).sum()

    sp, err = spans.profile_spans(unit, 2, lambda: None)
    assert sp is None and err and not trace.enabled() and trace.counters() == {}

    from torch.profiler import ProfilerActivity, profile, record_function

    trace.enable(True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(spans.STRETCH):
                unit(0)
    finally:
        trace.enable(False)
        trace.reset()
    host, dev, stretch, links = spans.records_from_profiler(prof)
    assert [h.name for h in sorted(host, key=lambda h: h.start)] == ["kdpt.frame", "kdpt.bounce"]
    assert stretch[0] <= host[0].start and dev == [] and links == {"runtime": 0, "none": 0}


class _Event:
    """A stand-in for one event of ``prof.profiler.kineto_results.events()``."""

    def __init__(self, name, device, a, b, corr=0, linked=0, annotation=False):
        self._v = (name, device, int(a * MS), int(b * MS), corr, linked, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._v[1] else DeviceType.CPU

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def start_thread_id(self):
        return 1

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def test_launch_links_of_a_device_trace():
    """A device activity's launch is its runtime call, found by correlation
    id; the spans' device-side copies are neither kernels nor busy time."""
    from types import SimpleNamespace

    events = [
        _Event(spans.STRETCH, 0, 0, 100, 1, annotation=True),
        _Event("kdpt.frame", 0, 1, 99, 2, annotation=True),
        _Event("kdpt.bounce", 0, 10, 50, 3, annotation=True),
        _Event("aten::where", 0, 12, 14, 4),
        _Event("cudaLaunchKernel", 0, 12.5, 13, 100, 4),
        _Event("cudaMemcpyAsync", 0, 45, 46, 105, 0),
        _Event("kdpt.frame", 1, 15, 70, 2, annotation=True),  # device-side copies
        _Event("kdpt.bounce", 1, 20, 40, 3, annotation=True),
        _Event("a", 1, 20, 21, 100, 4),  # launched in the bounce
        _Event("b", 1, 60, 61, 103, 0),  # its runtime call lost: by its own start
        _Event("Memcpy DtoH (Device -> Pageable)", 1, 47, 48, 105, 0),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    host, dev, stretch, links = spans.records_from_profiler(prof)
    assert stretch == (0, 100 * MS)
    assert [h.name for h in host] == ["kdpt.frame", "kdpt.bounce"]
    assert links == {"runtime": 2, "none": 1}
    assert {o.name: (o.kind, o.launch) for o in dev} == {
        "a": ("kernel", 12.5 * MS), "b": ("kernel", None),
        "Memcpy DtoH (Device -> Pageable)": ("dtoh", 45 * MS),
        "kdpt.frame": ("annotation", None), "kdpt.bounce": ("annotation", None)}
    sp = spans.summarize_spans(host, dev, 1, 0.1, stretch)
    assert sp.stages["kdpt.bounce"]["self"]["launches"] == 1
    assert sp.stages["kdpt.bounce"]["self"]["dtoh"] == 1
    assert sp.stages["kdpt.frame"]["self"]["launches"] == 1
    assert sp.busy_s == pytest.approx(0.003)  # the copies of the spans are not busy time


CELL = "ico82k.pairs.render"
SHRUNK = ({"film": [16, 16], "depth": 3},
          {"mesh": {"generator": "icosphere", "args": {"subdiv": 3, "radius": 2.5,
                                                       "center": [0.0, 3.0, 0.0]}}})


def test_shrunk_cell_with_the_span_stretch():
    """The cell's traced result keeps every key and reader it has without
    the span stretch; on the CPU the span stretch reads nothing."""
    from kdtreepathtraceroptimization_tpu_torch.utils import trace

    seed = 2**31 + 29  # a window of 0 s runs one frame on both sides
    plain = harness.run_cell(CELL, seed, 0, True, "cpu", *SHRUNK)
    report = spans.run_cell_with_spans(CELL, seed, 0, 1, "cpu", *SHRUNK)
    got = report["result"]
    assert set(got) == set(plain) and got["correct"] and plain["correct"]
    assert got["attempted"] == plain["attempted"] == 1
    assert set(got["metrics"]) == set(plain["metrics"])
    assert got["checks"] == plain["checks"]
    assert report["spans"] is None and report["spans_error"]
    assert {k: len(v) for k, v in report["tracing_cost_s"].items()} == {
        "off": 1, "on": 1, "profiled_off": 1, "profiled_on": 1}
    assert not trace.enabled() and harness.profile_units is spans.harness.profile_units
