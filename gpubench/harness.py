"""The benchmark's core: one run of one cell.

Everything that belongs to one configuration, traffic mix, metric or cell
is a file found by its name in ``BENCHMARK.json``:

- ``configs/<config>.json``: the scene text, the mesh generator and its
  arguments (``meshgen.py``), ``source``, ``reduced`` and ``assumed``;
- ``traffic/<mix>.json``: the film, the depth, the ``RenderConfig``
  overrides and the loop, read by the module its ``kind`` names
  (``kinds/<kind>.py``);
- ``metrics/<metric>.py``: a reader ``read(run)`` of one metric from the
  run's record (``Run``), which returns None where it finds nothing;
- ``limits/<cell>.json``: the limit of each number that decides
  ``correct`` in that cell.

The kind module builds the program's step in set-up, warms it up, runs the
measured window (``--seconds``), with ``--trace 1`` profiles a short
stretch after it, frees the program's state and then compares what the
window produced with the plain reference (``reference/``).
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import os
import re
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = Path(__file__).resolve().parent
WORK_DIR = ROOT / "build" / "gpubench"
PORT = "kdtreepathtraceroptimization_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "kdtreepathtraceroptimization_tpu")


def log(msg: str) -> None:
    print(f"[gpubench] {msg}", file=sys.stderr, flush=True)


def process_start_epoch() -> float:
    """When this process started (seconds since the epoch), from /proc;
    the import time of this module where /proc is not there."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        btime = next(int(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines()
                     if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _IMPORTED


_IMPORTED = time.time()


def set_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths.
    The port's nvcc libraries go to ``build/kernels`` and its native KD
    builder to ``build/native`` by its own code, both inside the checkout."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the file ``path`` as module ``name`` (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_cell(name: str) -> Cell:
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits = load_json(BENCH_DIR / "limits" / f"{name}.json")

    def applies(metric, reported):
        if "workloads" in metric:
            return name in metric["workloads"]
        return reported is None or metric["moves"] in reported

    e2e = [m for m in bench["end_to_end"] if applies(m, None)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if applies(m, e2e_names)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e, per_layer)


@dataclass
class Profile:
    """What the profiler saw over ``units`` frames or steps."""

    units: int
    window_s: float  # host wall time of the profiled stretch
    busy_s: float  # union of the device's activity intervals
    launches: int  # kernel launches
    dtoh: int  # device-to-host copies
    csrc_ms: float  # device ms of the port's own kernels (csrc/*.cu)
    torch_ms: float  # device ms of every other kernel
    device_ops: list  # [name, seconds], the ten longest by total
    idle_gaps: list  # [host op, seconds], the ten longest by total


@dataclass
class Run:
    """The record a kind module fills and the metric readers read."""

    kind: str
    pixels: int = 0
    depth: int = 0
    units: int = 0  # whole frames or steps in the window
    window_s: float = 0.0  # window start to the synchronised end of its last unit
    unit_ms: List[float] = field(default_factory=list)  # each unit's host time
    setup_s: float = 0.0
    scene_load_s: float = 0.0
    peak_bytes: Optional[int] = None
    profile: Optional[Profile] = None
    checks: Dict[str, dict] = field(default_factory=dict)  # name -> value, limit


def csrc_kernel_names() -> List[str]:
    """The ``__global__`` functions of the port's ``csrc/*.cu``."""
    spec = importlib.util.find_spec(PORT)
    csrc = Path(spec.origin).parent / "csrc"
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)")
    names = set()
    for src in csrc.glob("*.cu"):
        names.update(pat.findall(src.read_text()))
    return sorted(names)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize_profile(prof, units: int, window_s: float) -> Optional[Profile]:
    """Reduce a ``torch.profiler`` trace to a ``Profile``; None where it
    recorded no device activity."""
    from torch.autograd import DeviceType

    ours = re.compile(r"\b(" + "|".join(map(re.escape, csrc_kernel_names())) + r")\b")
    device, host = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            device.append(e)
        elif e.cpu_parent is None and not e.name.startswith(("cuda", "Activity Buffer")):
            host.append(e)
    if not device:
        return None
    intervals, launches, dtoh, csrc_us, torch_us = [], 0, 0, 0.0, 0.0
    by_name: Dict[str, float] = {}
    for e in device:
        s, t = e.time_range.start, e.time_range.end
        intervals.append((s, t))
        name = e.name
        if name.startswith("Memcpy"):
            dtoh += "DtoH" in name
        elif not name.startswith("Memset"):
            launches += 1
            if ours.search(name):
                csrc_us += t - s
            else:
                torch_us += t - s
        by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e6
    busy = _merge(intervals)
    busy_us = sum(e - s for s, e in busy)
    host.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    gaps: Dict[str, float] = {}
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        k = bisect.bisect_right(starts, end) - 1
        label = "(no operation)"
        if k >= 0 and host[k].time_range.end >= end:
            label = host[k].name
        gaps[label] = gaps.get(label, 0.0) + (nxt - end) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return Profile(units, window_s, busy_us / 1e6, launches, dtoh, csrc_us / 1e3, torch_us / 1e3,
                   [[k[:160], v] for k, v in top(by_name)], top(gaps))


def profile_units(run_unit, units: int, sync):
    """Run ``run_unit(k)`` for k < ``units`` under ``torch.profiler``;
    (Profile or None, the profiler's error or None)."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as exc:
        return None, f"the profiler did not start: {exc}"
    try:
        sync()
        t0 = time.perf_counter()
        for k in range(units):
            run_unit(k)
        sync()
        window_s = time.perf_counter() - t0
    finally:
        prof.stop()
    return summarize_profile(prof, units, window_s), None


def quantile(values, q: float) -> Optional[float]:
    """The ``q`` quantile (0 < q < 1) of ``values`` by
    ``statistics.quantiles``; None below two values."""
    if len(values) < 2:
        return None
    n = 100
    return statistics.quantiles(values, n=n)[int(round(q * n)) - 1]


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's (compared whole: the port's name
    begins with the JAX package's)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             traffic_overrides: Optional[dict] = None,
             config_overrides: Optional[dict] = None) -> dict:
    """One run of cell ``name``: its result as the JSON object the
    benchmark prints. ``*_overrides`` shrink a cell for the CPU tests."""
    start_epoch = process_start_epoch()
    cell = load_cell(name)
    cell.traffic.update(traffic_overrides or {})
    cell.config.update(config_overrides or {})
    loop = load_module(BENCH_DIR / "kinds" / f"{cell.traffic['kind']}.py",
                         f"gpubench_kind_{cell.traffic['kind']}")
    run = loop.run(cell, seed=seed, seconds=seconds, trace=trace, device=device,
                     start_epoch=start_epoch, work_dir=WORK_DIR / cell.config["name"])
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        reader = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py",
                             "gpubench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct = all(c["value"] <= c["limit"] for c in run.checks.values())
    dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if device != "cpu":
        import torch

        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
               "memory_peak_bytes": int(run.peak_bytes)}
    result = {"correct": bool(correct and run.checks), "attempted": run.units,
              "failed": 0 if correct else 1, "metrics": metrics, "device": dev}
    if trace and run.profile is not None:
        p = run.profile
        dev["busy_s"] = p.busy_s
        dev["window_s"] = p.window_s
        result["breakdown"] = {"device_ops": p.device_ops, "idle_gaps": p.idle_gaps}
    result["checks"] = run.checks
    return result
