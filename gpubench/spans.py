"""The port's stage spans over a profiled stretch: host, device and idle
time by stage and by bounce.

``profile_spans`` turns the port's tracing on (``utils/trace.py``: the
``kdpt.*`` spans and the ``live_lanes`` counter), runs a few more frames
or steps under ``torch.profiler`` and turns it off; ``summarize_spans``
reduces that trace to a ``SpanProfile`` by one rule. An instant belongs
to the innermost ``kdpt.*`` span, of the thread that entered
``kdpt.frame`` or ``kdpt.train_step``, whose interval holds it:

- a kernel or copy, to the span that holds its launch (the runtime call
  the trace links to it by correlation id; autograd's backward launches
  from its own thread while the caller sits in ``kdpt.backward``, so it
  goes there by time);
- a device idle gap, to the span that holds the instant it opens (the
  stretch's start, or the end of the activity before it).

Device-side copies of the spans (``gpu_user_annotation``) are neither
kernels nor busy time.

    python3 gpubench/spans.py --workload <cell> --seed <n> --seconds <s> [--rounds 3]

runs the cell as ``run.py --trace 1`` does, with the span stretch after
its profiled stretch (which runs with tracing off), and ``--rounds``
pairs of stretches with tracing off and on for the cost of tracing:
unprofiled before the first profiler starts, each under a profiler of its
own after the span stretch.
It logs the stage and bounce tables and the ten largest idle totals by
span to standard error, and prints one JSON line: the cell's result, the
span metrics, the tables and the attribution's checks.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gpubench import harness  # noqa: E402

PREFIX = "kdpt."
ROOTS = ("kdpt.frame", "kdpt.train_step")
STRETCH = "gpubench.stretch"  # the span stretch's own range, not a stage
# the wavefront's stages: a frame's spans other than the intersector's
WAVEFRONT = ("kdpt.camera", "kdpt.geoms", "kdpt.hit_expand", "kdpt.scatter", "kdpt.shade",
             "kdpt.reorder", "kdpt.gather", "kdpt.bounce")
FIELDS = ("host_ms", "device_ms", "launches", "dtoh", "idle_ms")


@dataclass
class HostSpan:
    name: str
    start: int  # ns, the profiler's clock
    end: int
    thread: int


@dataclass
class DeviceOp:
    kind: str  # "kernel", "dtoh", "copy", "memset" or "annotation"
    start: int
    end: int
    launch: Optional[int] = None  # the host instant of its launch, where the trace links one
    name: str = ""


def _zero():
    return dict.fromkeys(FIELDS, 0.0)


@dataclass
class SpanProfile:
    """What the span stretch saw over ``units`` frames or steps. Stage and
    bounce rows hold totals over the stretch: ``incl`` with the stage's
    inner spans, ``self`` without."""

    units: int
    window_s: float  # host clock around the stretch
    stretch_s: float  # the profiler's clock, the stretch's own range
    busy_s: float  # union of device activity in the stretch
    stages: Dict[str, dict]  # name -> count, self, incl
    bounces: List[dict]  # by order in the frame (or forward): count, incl, live_lanes
    outside: dict  # self fields of the instants in no span
    counters: Dict[str, list]
    launch_links: Dict[str, int]  # how each device op's launch was found
    kernels: Dict[str, Dict[str, list]]  # innermost span -> kernel name -> [device ms, launches]

    @property
    def idle_s(self) -> float:
        return self.stretch_s - self.busy_s

    def total(self, part: str, key: str, names) -> float:
        return sum(self.stages[n][part][key] for n in names if n in self.stages)

    def device_ms(self) -> float:
        return sum(s["self"]["device_ms"] for s in self.stages.values()) + \
            self.outside["device_ms"]

    def idle_attributed_ms(self) -> float:
        return sum(s["self"]["idle_ms"] for s in self.stages.values()) + self.outside["idle_ms"]

    def metrics(self, kind: str, pixels: int, depth: int) -> Dict[str, float]:
        """The per-layer metrics this stretch reads, by name."""
        u = max(1, self.units)
        isect = [n for n in self.stages if n.startswith("kdpt.intersect.")]
        if kind == "render":
            out = {
                "intersect_host_ms_per_iter.render": self.total("incl", "host_ms", isect) / u,
                "intersect_device_ms_per_iter.render": self.total("incl", "device_ms", isect) / u,
                "intersect_idle_ms_per_iter.render": self.total("incl", "idle_ms", isect) / u,
                "wavefront_idle_ms_per_iter.render": self.total("self", "idle_ms", WAVEFRONT) / u,
            }
            lanes = self.counters.get("live_lanes")
            if lanes and pixels and depth:
                out["live_lane_share.render"] = sum(lanes) / (pixels * depth * u)
            return out
        return {"backward_host_ms_per_step.train":
                self.total("incl", "host_ms", ["kdpt.backward"]) / u,
                "backward_idle_ms_per_step.train":
                self.total("incl", "idle_ms", ["kdpt.backward"]) / u}

    def checks(self) -> dict:
        """The attribution's completeness: device ms launched outside every
        span over all device ms; idle attributed over the stretch's idle
        (the profiler's clock) and over the host clock's window less busy."""
        dev = self.device_ms()
        idle = self.idle_s * 1e3
        host_idle = (self.window_s - self.busy_s) * 1e3
        return {"outside_device_share": self.outside["device_ms"] / dev if dev else None,
                "idle_attributed_over_stretch": self.idle_attributed_ms() / idle if idle else None,
                "idle_attributed_over_host_window": (self.idle_attributed_ms() / host_idle
                                                     if host_idle > 0 else None),
                "stretch_s": self.stretch_s, "window_s": self.window_s}


class _Tree:
    """The main thread's spans, nested by their intervals; ``at(t)`` is the
    innermost span holding instant t, or None."""

    def __init__(self, spans: List[HostSpan]):
        self.spans = sorted(spans, key=lambda s: (s.start, -s.end))
        self.starts = [s.start for s in self.spans]
        self.parent: List[Optional[int]] = []
        stack: List[int] = []
        for i, s in enumerate(self.spans):
            while stack and self.spans[stack[-1]].end < s.end:
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(i)

    def at(self, t: int) -> Optional[int]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i < 0:
            return None
        while i is not None and self.spans[i].end < t:
            i = self.parent[i]  # spans nest: the holder, if any, is an ancestor
        return i


def summarize_spans(spans: List[HostSpan], ops: List[DeviceOp], units: int, window_s: float,
                    stretch: Tuple[int, int], counters: Optional[dict] = None,
                    launch_links: Optional[dict] = None) -> Optional[SpanProfile]:
    """Reduce a span stretch's records to a ``SpanProfile``; None where
    the device recorded no activity or no span opened a frame or step."""
    ops = [o for o in ops if o.kind != "annotation"]
    roots = sorted((s for s in spans if s.name in ROOTS), key=lambda s: s.start)
    if not ops or not roots:
        return None
    main = roots[0].thread
    tree = _Tree([s for s in spans if s.thread == main and s.name.startswith(PREFIX)])
    n = len(tree.spans)
    own = [_zero() for _ in range(n)]
    outside = _zero()

    def put(t, key, value):
        i = tree.at(t)
        (outside if i is None else own[i])[key] += value
        return i

    t0, t1 = stretch
    kernels: Dict[str, Dict[str, list]] = {}
    for o in ops:
        t = o.start if o.launch is None else o.launch
        if o.kind == "kernel":
            ms = (o.end - o.start) / 1e6
            i = put(t, "device_ms", ms)
            put(t, "launches", 1)
            by = kernels.setdefault("(outside spans)" if i is None else tree.spans[i].name, {})
            row = by.setdefault(o.name, [0.0, 0])
            row[0] += ms
            row[1] += 1
        elif o.kind == "dtoh":
            put(t, "dtoh", 1)
    busy = [[max(s, t0), min(e, t1)] for s, e in harness._merge((o.start, o.end) for o in ops)
            if e > t0 and s < t1]
    opens = t0
    for s, e in busy:
        if s > opens:
            put(opens, "idle_ms", (s - opens) / 1e6)
        opens = e
    if t1 > opens:
        put(opens, "idle_ms", (t1 - opens) / 1e6)
    busy_ns = sum(e - s for s, e in busy)

    # host ms: a span's duration, less its children's for ``self``
    incl = [_zero() for _ in range(n)]
    for i, s in enumerate(tree.spans):
        own[i]["host_ms"] += (s.end - s.start) / 1e6
        incl[i]["host_ms"] = (s.end - s.start) / 1e6
    for i in range(n - 1, -1, -1):
        for k in FIELDS[1:]:
            incl[i][k] += own[i][k]
        p = tree.parent[i]
        if p is not None:
            own[p]["host_ms"] -= incl[i]["host_ms"]
            for k in FIELDS[1:]:
                incl[p][k] += incl[i][k]

    stages: Dict[str, dict] = {}
    bounces: List[dict] = []
    order: Dict[Optional[int], int] = {}
    for i, s in enumerate(tree.spans):
        row = stages.setdefault(s.name, {"count": 0, "self": _zero(), "incl": _zero()})
        row["count"] += 1
        for k in FIELDS:
            row["self"][k] += own[i][k]
            row["incl"][k] += incl[i][k]
        if s.name == "kdpt.bounce":
            b = order.get(tree.parent[i], 0)
            order[tree.parent[i]] = b + 1
            while len(bounces) <= b:
                bounces.append({"count": 0, "incl": _zero()})
            bounces[b]["count"] += 1
            for k in FIELDS:
                bounces[b]["incl"][k] += incl[i][k]
    counters = counters or {}
    for b, lanes in enumerate(counters.get("live_lanes", [])):
        if b < len(bounces):
            bounces[b]["live_lanes"] = lanes
    return SpanProfile(units, window_s, (t1 - t0) / 1e9, busy_ns / 1e9, stages, bounces,
                       outside, counters, dict(launch_links or {}), kernels)


def _is_runtime(name: str) -> bool:
    """A call into the CUDA runtime or its low-level API (``cudaLaunchKernel``,
    ``cuLaunchKernel``)."""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def records_from_profiler(prof):
    """(host spans, device ops, the stretch's (start, end), launch links)
    from a ``torch.profiler`` trace: the ``kdpt.*`` ranges and the
    stretch's own, and every device activity with its launch, the start of
    the runtime call with its correlation id (none where the trace lost
    that call: the activity's own start stands in)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    spans, ops, runtime = [], [], {}
    stretch = None
    for e in events:
        if e.device_type() != DeviceType.CPU:
            continue
        name = e.name()
        if name == STRETCH:
            stretch = (e.start_ns(), e.end_ns())
        elif name.startswith(PREFIX):
            spans.append(HostSpan(name, e.start_ns(), e.end_ns(), e.start_thread_id()))
        elif _is_runtime(name):
            runtime[e.correlation_id()] = e.start_ns()
    links = {"runtime": 0, "none": 0}
    for e in events:
        if e.device_type() == DeviceType.CPU:
            continue
        name = e.name()
        if e.is_user_annotation():
            kind = "annotation"
        elif name.startswith("Memcpy"):
            kind = "dtoh" if "DtoH" in name else "copy"
        elif name.startswith("Memset"):
            kind = "memset"
        else:
            kind = "kernel"
        launch = None
        if kind != "annotation":
            launch = runtime.get(e.correlation_id())
            links["none" if launch is None else "runtime"] += 1
        ops.append(DeviceOp(kind, e.start_ns(), e.end_ns(), launch, name))
    return spans, ops, stretch, links


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])


def profile_spans(run_unit, units: int, sync):
    """Run ``run_unit(k)`` for k < ``units`` under ``torch.profiler`` with
    the port's tracing on; (SpanProfile or None, the reason or None)."""
    from torch.profiler import profile, record_function

    try:
        from kdtreepathtraceroptimization_tpu_torch.utils import trace
    except ImportError:
        return None, "the port has no stage spans (utils/trace.py)"
    prof = profile(activities=_activities())
    try:
        prof.start()
    except RuntimeError as exc:
        return None, f"the profiler did not start: {exc}"
    trace.reset()
    trace.enable(True)
    try:
        sync()
        t0 = time.perf_counter()
        with record_function(STRETCH):
            for k in range(units):
                run_unit(k)
            sync()
        window_s = time.perf_counter() - t0
    finally:
        trace.enable(False)
        prof.stop()
    counters = trace.counters()
    trace.reset()
    spans, ops, stretch, links = records_from_profiler(prof)
    if stretch is None:
        return None, "the trace holds no stretch range"
    sp = summarize_spans(spans, ops, units, window_s, stretch, counters, links)
    return sp, None if sp is not None else "no device activity or no frame span recorded"


def tracing_cost(run_unit, units: int, sync, rounds: int, profiled: bool) -> Dict[str, list]:
    """Host seconds of ``units`` frames or steps with tracing off and on,
    ``rounds`` times in turn (off, on, on, off, ...), each stretch under a
    profiler of its own with ``profiled``."""
    from torch.profiler import profile

    from kdtreepathtraceroptimization_tpu_torch.utils import trace

    out: Dict[str, list] = {"off": [], "on": []}
    for r in range(rounds):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            prof = profile(activities=_activities()) if profiled else None
            if prof is not None:
                prof.start()
            trace.enable(on)
            try:
                sync()
                t0 = time.perf_counter()
                for k in range(units):
                    run_unit(k)
                sync()
                out["on" if on else "off"].append(time.perf_counter() - t0)
            finally:
                trace.enable(False)
                if prof is not None:
                    prof.stop()
    trace.reset()
    return out


def log_tables(sp: SpanProfile, name: str) -> None:
    u = max(1, sp.units)
    log = harness.log
    log(f"{name}: span stretch {sp.units} units, {sp.window_s:.3f} s host clock, "
        f"{sp.stretch_s:.3f} s profiler clock, busy {sp.busy_s:.3f} s, idle {sp.idle_s:.3f} s; "
        f"launch links {sp.launch_links}")
    log("stage (a unit): count, host ms incl, self; device ms incl, self; launches incl; "
        "dtoh incl; idle ms incl, self")
    rows = sorted(sp.stages.items(), key=lambda kv: -kv[1]["incl"]["host_ms"])
    for stage, r in rows:
        i, s = r["incl"], r["self"]
        log(f"  {stage:24s} {r['count'] / u:7.1f} {i['host_ms'] / u:10.3f} "
            f"{s['host_ms'] / u:10.3f} {i['device_ms'] / u:10.3f} {s['device_ms'] / u:10.3f} "
            f"{i['launches'] / u:9.1f} {i['dtoh'] / u:6.1f} {i['idle_ms'] / u:9.3f} "
            f"{s['idle_ms'] / u:9.3f}")
    o = sp.outside
    log(f"  (outside spans): device ms {o['device_ms'] / u:.3f}, launches {o['launches'] / u:.1f}, "
        f"dtoh {o['dtoh'] / u:.1f}, idle ms {o['idle_ms'] / u:.3f}")
    log("bounce (a unit): host ms, device ms, launches, dtoh, idle ms, live lanes")
    for b, r in enumerate(sp.bounces):
        i = r["incl"]
        log(f"  {b:2d} {i['host_ms'] / u:10.3f} {i['device_ms'] / u:10.3f} "
            f"{i['launches'] / u:9.1f} {i['dtoh'] / u:6.1f} {i['idle_ms'] / u:9.3f} "
            f"{r.get('live_lanes', 0) / u:12.1f}")
    idle = [(k, r["self"]["idle_ms"]) for k, r in sp.stages.items()]
    idle.append(("(outside spans)", o["idle_ms"]))
    top = sorted(idle, key=lambda kv: -kv[1])[:10]
    log("idle by span (ms, stretch total): " + ", ".join(f"{k} {v:.3f}" for k, v in top))
    for stage, by in sorted(sp.kernels.items()):
        top = sorted(by.items(), key=lambda kv: -kv[1][0])[:5]
        log(f"kernels in {stage} (device ms a unit): "
            + "; ".join(f"{k[:90]} {v[0] / u:.3f}" for k, v in top))


def run_cell_with_spans(name: str, seed: int, seconds: float, rounds: int = 3,
                        device: str = "cuda", traffic_overrides: Optional[dict] = None,
                        config_overrides: Optional[dict] = None) -> dict:
    """``harness.run_cell(..., trace=True)`` with the span stretch after
    the kind's profiled stretch, and the cost rounds: unprofiled before
    the first profiler starts, profiled after the span stretch."""
    got: dict = {"cost": {}}
    plain = harness.profile_units

    def both(run_unit, units, sync):
        if rounds:
            got["cost"].update(tracing_cost(run_unit, units, sync, rounds, False))
        out = plain(run_unit, units, sync)
        got["spans"], got["error"] = profile_spans(run_unit, units, sync)
        if rounds:
            got["cost"].update({"profiled_" + k: v for k, v in
                                tracing_cost(run_unit, units, sync, rounds, True).items()})
        got["units"] = units
        return out

    harness.profile_units = both
    try:
        result = harness.run_cell(name, seed, seconds, True, device, traffic_overrides,
                                  config_overrides)
    finally:
        harness.profile_units = plain
    cell = harness.load_cell(name)
    cell.traffic.update(traffic_overrides or {})
    w, h = cell.traffic["film"]
    sp: Optional[SpanProfile] = got.get("spans")
    report = {"workload": name, "result": result, "spans": None,
              "spans_error": got.get("error"), "tracing_cost_s": got.get("cost"),
              "units": got.get("units")}
    if sp is not None:
        log_tables(sp, name)
        plain_s = result["device"].get("window_s")
        harness.log(f"{name}: wall a unit of the profiled stretch (tracing off) "
                    f"{plain_s / sp.units if plain_s else float('nan'):.4f} s, of the span "
                    f"stretch {sp.window_s / sp.units:.4f} s; stretches of {sp.units} units, off "
                    f"and on in turns (s): {got.get('cost')}")
        u = max(1, sp.units)
        report["spans"] = {
            "metrics": sp.metrics(cell.traffic["kind"], w * h, int(cell.traffic["depth"])),
            "checks": sp.checks(),
            "stages": {k: {"count": r["count"] / u,
                           **{f: v / u for f, v in r["incl"].items()},
                           **{f"{f}_self": v / u for f, v in r["self"].items()}}
                       for k, r in sp.stages.items()},
            "outside": {k: v / u for k, v in sp.outside.items()},
            "bounces": [dict({k: v / u for k, v in r["incl"].items()},
                             live_lanes=r.get("live_lanes", 0) / u) for r in sp.bounces],
            "launch_links": sp.launch_links,
            "kernels": {k: {n[:160]: [v[0] / u, v[1] / u] for n, v in by.items()}
                        for k, by in sp.kernels.items()},
        }
    elif got.get("error"):
        harness.log(f"span stretch not measured: {got['error']}")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rounds", type=int, default=3,
                    help="off/on pairs, unprofiled and profiled, for the cost of tracing "
                         "(0: none)")
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        harness.log("the span stretch needs a CUDA device")
        return 2
    report = run_cell_with_spans(args.workload, args.seed, args.seconds, args.rounds)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
