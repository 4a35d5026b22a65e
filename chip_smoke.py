"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``kdtreepathtraceroptimization_tpu_torch/
csrc`` and drives the cluster-walk render path:

1. the card (nvidia-smi name and power limit), torch/CUDA versions, and
   the kernels' build (time, registers and shared memory per kernel);
2. each kernel against its plain PyTorch version, on the inputs the main
   path hands it (recorded from one 800x800 iteration at the second
   bounce): slab cull and gather-to-columns bit for bit, the walk's
   triangle ids on >= 99.99% of rays with t within 1e-5 relative where
   they differ; each kernel's time, its plain version's, one library
   call's where one computes the same function, and its bound;
3. golden parity: ``cornell_64`` and the ``mesh_pairs_48`` scene (walk
   config) against the JAX package's committed goldens;
4. the main path: Cornell + an 81,920-triangle icosphere, 800x800, depth
   8, antialiasing, walk config, through ``make_render_block_fn``; every
   kernel's launch count must rise, and the image must be finite and
   non-black. Prints ms/iteration, rays/s and peak device memory.

The second-to-last line is the kernels' JSON record, the last
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
those lines; so does a machine without CUDA, or a directory without the
port.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig
from kdtreepathtraceroptimization_tpu_torch.ops import mesh as tmesh
from kdtreepathtraceroptimization_tpu_torch.ops import walk as twalk
from kdtreepathtraceroptimization_tpu_torch.ops.rng import prng_key
from kdtreepathtraceroptimization_tpu_torch.render.integrator import (
    make_render_block_fn,
    render,
)
from kdtreepathtraceroptimization_tpu_torch.scene.parser import load_scene, with_resolution
from kdtreepathtraceroptimization_tpu_torch.utils import cuda_build
from kdtreepathtraceroptimization_tpu_torch.utils.procmesh import icosphere, write_obj

REPO = os.path.dirname(os.path.abspath(__file__))
CORNELL = os.path.join(REPO, "scenes", "cornell.txt")
GOLDENS = os.path.join(REPO, "tests", "goldens")
WORK = os.path.join(REPO, "build", "chip_smoke")
WALK = dict(cluster=True, cluster_walk=True, cluster_pairs=False)

# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM
# bandwidth and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# Float32 operations per (ray, block) pair of the slab cull: per axis 2
# multiplies, 2 subtracts, 4 min/max; then abs, multiply, 3 add/subtract
# for the slack, one max and 4 compares, one min into the tile bound.
SLAB_OPS_PER_PAIR = 3 * 8 + 10
# Float32 operations per (ray, triangle) test of the walk: 4 ten-term dot
# products (40 FMAs = 80) and the epilogue's 5 compares, 1 add, 1 divide
# and 1 compare against the running best.
WALK_OPS_PER_TEST = 80 + 8

KERNELS = (
    ("slab_cull", twalk.SLAB_CULL, "kdtreepathtraceroptimization_tpu_torch/csrc/slab_cull.cu",
     "kdtreepathtraceroptimization_tpu/ops/walk.py:109"),
    ("walk", twalk.WALK, "kdtreepathtraceroptimization_tpu_torch/csrc/walk.cu",
     "kdtreepathtraceroptimization_tpu/ops/walk.py:186"),
    ("gather_cols", tmesh.GATHER_COLS, "kdtreepathtraceroptimization_tpu_torch/csrc/gather_cols.cu",
     "kdtreepathtraceroptimization_tpu/ops/mesh.py:170"),
)


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, reps: int) -> float:
    """Median device time of ``fn()`` in ms over ``reps`` runs (CUDA events),
    after one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def mesh_scene(subdiv: int, radius: float, res: int, device):
    os.makedirs(WORK, exist_ok=True)
    verts, faces = icosphere(subdiv, radius=radius, center=(0.0, 3.0, 0.0))
    path = os.path.join(WORK, f"icosphere{subdiv}_r{radius}.obj")
    write_obj(path, verts, faces)
    return with_resolution(load_scene(CORNELL, obj_path=path, device=device),
                           res, res)


class Recorder:
    """Keeps a copy of the arguments one wrapper receives on its
    ``index``-th call while the render runs; restores it on exit."""

    def __init__(self, module, name: str, index: int):
        self.module, self.name, self.index = module, name, index
        self.calls = 0
        self.args = None

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def wrapped(*args):
            if self.calls == self.index:
                self.args = [a.clone() if isinstance(a, torch.Tensor) else a
                             for a in args]
            self.calls += 1
            return self.real(*args)

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def phase_kernels(scene, config, device) -> dict:
    """Kernel vs plain version on the main path's inputs at bounce 1."""
    n = int(scene.camera.resolution[0]) * int(scene.camera.resolution[1])
    step = make_render_block_fn(scene, config, 1, device=device)
    with Recorder(twalk, "slab_cull", 1) as rs, Recorder(twalk, "walk", 1) as rw, \
            Recorder(tmesh, "gather_cols", 1) as rg:
        step(torch.zeros((n, 3), device=device), prng_key(0), 1)
    sync(device)
    results = {}

    # -- slab cull: bit-equal ------------------------------------------
    x, slab, blk, tile = rs.args
    got = twalk.slab_cull(x, slab, blk, tile)
    want = twalk._slab_cull_ref(x, slab, blk, tile)
    sync(device)
    if not torch.equal(got, want):
        bad = (got != want).sum().item()
        raise AssertionError(f"slab_cull differs from its plain version in {bad} entries")
    k_real = int((blk[5] >= 0).sum())
    rays = x.shape[0]
    slab_bytes = (x.numel() + slab.numel() + blk.numel() + got.numel()) * 4
    slab_ops = rays * k_real * SLAB_OPS_PER_PAIR
    results["slab_cull"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: twalk.slab_cull(x, slab, blk, tile), 20),
        plain_ms=time_ms(lambda: twalk._slab_cull_ref(x, slab, blk, tile), 3),
        bound_ms=max(slab_bytes / HBM_BYTES_PER_S, slab_ops / F32_FLOP_PER_S) * 1e3,
        bound_by="operations" if slab_ops / F32_FLOP_PER_S > slab_bytes / HBM_BYTES_PER_S else "bytes",
        library_ms=None,
        shape=f"x [{rays},16], slab/blk [8,{blk.shape[1]}] ({k_real} real blocks), tile {tile}",
    )
    log(f"[kernels] slab_cull == plain bit for bit; {results['slab_cull']['shape']}")

    # -- walk: ids on >= 99.99% of rays, t within 1e-5 where they differ --
    sel, lb, nsel, r, t0, act, w, wtile, block = rw.args
    bt_k, btri_k = twalk.walk(sel, lb, nsel, r, t0, act, w, wtile, block)
    bt_p, btri_p = twalk._walk_ref(sel, lb, r, t0, act, w, wtile, block)
    sync(device)
    same = btri_k == btri_p
    frac = same.float().mean().item()
    rel = ((bt_k - bt_p).abs() / bt_p.abs().clamp_min(1e-30))
    hits = int((btri_p >= 0).sum())
    log(f"[kernels] walk: {hits} of {rays} rays hit; ids equal on {frac:.6%}; "
        f"max |dt|/t {rel.max().item():.3g} (where ids differ: "
        f"{rel[~same].max().item() if (~same).any() else 0.0:.3g})")
    if frac < 0.9999:
        raise AssertionError(f"walk ids equal on only {frac:.6%} of rays")
    if (~same).any() and rel[~same].max().item() > 1e-5:
        raise AssertionError("walk: t differs by more than 1e-5 where ids differ")
    if rel[same].max().item() > 1e-5:
        raise AssertionError("walk: t differs by more than 1e-5 relative")
    # The least work this data needs: a tile must test every listed block
    # whose entry bound lies below some live ray's final t.
    g = r.shape[0] // wtile
    live = act.reshape(g, wtile) > 0
    worst = torch.where(live, bt_p.reshape(g, wtile), torch.zeros_like(t0).reshape(g, wtile)).amax(dim=1)
    needed = ((lb < worst[:, None]) & (torch.arange(lb.shape[1], device=lb.device)[None] < nsel)).sum()
    walk_ops = int(needed) * wtile * block * WALK_OPS_PER_TEST
    walk_bytes = sum(a.numel() * 4 for a in (sel, lb, nsel, r, t0, act, w, bt_k, btri_k))
    results["walk"] = dict(
        max_abs_err=(bt_k - bt_p)[same].abs().max().item(),
        ms=time_ms(lambda: twalk.walk(sel, lb, nsel, r, t0, act, w, wtile, block), 10),
        plain_ms=time_ms(lambda: twalk._walk_ref(sel, lb, r, t0, act, w, wtile, block), 3),
        bound_ms=max(walk_bytes / HBM_BYTES_PER_S, walk_ops / F32_FLOP_PER_S) * 1e3,
        bound_by="operations" if walk_ops / F32_FLOP_PER_S > walk_bytes / HBM_BYTES_PER_S else "bytes",
        library_ms=None,
        shape=f"{g} tiles of {wtile} rays, {int(needed)} needed (tile, block) rounds "
              f"of {block} triangles, feasible lists of mean {nsel.float().mean().item():.1f}",
        ids_equal=frac,
    )
    log(f"[kernels] walk: {results['walk']['shape']}")

    # -- gather-to-columns: bit-equal ------------------------------------
    packed, tri = rg.args
    got = tmesh.gather_cols(packed, tri)
    want = tmesh._gather_cols_ref(packed, tri)
    sync(device)
    if not torch.equal(got, want):
        raise AssertionError("gather_cols differs from packed[tri].T")
    gbytes = (2 * got.numel() + tri.numel()) * 4
    results["gather_cols"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: tmesh.gather_cols(packed, tri), 20),
        plain_ms=time_ms(lambda: tmesh._gather_cols_ref(packed, tri), 10),
        bound_ms=gbytes / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
        # one PyTorch call for the same [C, n] result: index_select on the
        # table's transposed view
        library_ms=time_ms(lambda: torch.index_select(packed.T, 1, tri.long()), 20),
        shape=f"packed [{packed.shape[0]},{packed.shape[1]}], tri [{tri.shape[0]}]",
    )
    log(f"[kernels] gather_cols == packed[tri].T bit for bit; {results['gather_cols']['shape']}")
    for name, res in results.items():
        lib = "n/a" if res["library_ms"] is None else f"{res['library_ms']:.4f}"
        log(f"[kernels] {name}: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
            f"library {lib} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
    return results


def phase_goldens(device):
    """The JAX package's committed goldens, rendered by the port."""
    scene = with_resolution(load_scene(CORNELL, device=device), 64, 64)
    img = render(scene, RenderConfig(trace_depth=8, antialias=True), spp=8,
                 seed=0, device=device)
    d = np.abs(img.cpu().numpy() - np.load(os.path.join(GOLDENS, "cornell_64.npy")))
    log(f"[golden] cornell_64: max |d| {d.max():.3g}, mean |d| {d.mean():.3g} "
        f"(bound: per pixel 2e-3)")
    if d.max() > 2e-3:
        raise AssertionError("cornell_64 differs from its golden beyond atol 2e-3")

    scene = mesh_scene(4, 2.0, 48, device)
    img = render(scene, RenderConfig(trace_depth=4, cluster_tile=256, **WALK),
                 spp=8, seed=0, device=device)
    d = np.abs(img.cpu().numpy() - np.load(os.path.join(GOLDENS, "mesh_pairs_48.npy")))
    log(f"[golden] mesh_pairs_48 (walk config): max |d| {d.max():.3g}, "
        f"mean |d| {d.mean():.3g} (bound: mean 1e-2)")
    if d.mean() > 1e-2:
        raise AssertionError("mesh_pairs_48 (walk) differs from its golden beyond mean 1e-2")


def phase_main_path(scene, config, device, block: int = 2,
                    timed_calls: int = 3) -> dict:
    """The full-size render; counts are zeroed just before and read just
    after it."""
    res = int(scene.camera.resolution[0])
    n = res * res
    step = make_render_block_fn(scene, config, block, device=device)
    key = prng_key(0)
    for _, kernel, _, _ in KERNELS:
        kernel.launches = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    film = step(torch.zeros((n, 3), device=device), key, 1)  # warm-up
    sync(device)
    per_iter = []
    it = 1 + block
    for _ in range(timed_calls):
        t = time.perf_counter()
        film = step(film, key, it)
        sync(device)
        per_iter.append((time.perf_counter() - t) * 1e3 / block)
        it += block
    launches = {name: kernel.launches for name, kernel, _, _ in KERNELS}
    img = film / (it - 1)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    ms = statistics.median(per_iter)
    depth = config.effective_depth
    log(f"[main] {res}x{res}, depth {depth}, {int(scene.mesh.v0.shape[0])} triangles: "
        f"{ms:.2f} ms/iteration (median of {timed_calls} calls x {block} iterations: "
        f"{', '.join(f'{v:.2f}' for v in per_iter)}), "
        f"{n * depth / (ms / 1e3):.4g} rays/s, peak memory {peak / 2**20:.1f} MiB")
    log(f"[main] launches over {1 + timed_calls} calls x {block} iterations: {launches}")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel was not launched on the main path: {launches}")
    if not torch.isfinite(img).all():
        raise AssertionError("the main-path image has non-finite values")
    if not img.mean().item() > 0:
        raise AssertionError("the main-path image is black")
    log(f"[main] image mean {img.mean().item():.4f}")
    phase_profile(step, film, key, it, block, device)
    return launches


def phase_profile(step, film, key, it, block, device) -> None:
    """Where one main-path call's device time goes (torch.profiler), and
    the device's idle share over its wall time. A profiler that cannot
    start or sees no device time prints "not measured"; the render it
    wraps is checked like any other and fails the run if it fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as exc:
        log(f"[profile] not measured: the profiler did not start: {exc}")
        return
    try:
        t = time.perf_counter()
        out = step(film, key, it)
        sync(device)
        wall_ms = (time.perf_counter() - t) * 1e3
    finally:
        prof.stop()
    if not torch.isfinite(out).all():
        raise AssertionError("the profiled main-path call gave non-finite values")
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        log("[profile] not measured: the profiler recorded no device time")
        return
    groups = {"walk": 0.0, "slab_cull": 0.0, "gather_cols": 0.0, "other": 0.0}
    launches = 0
    for e in kernels:
        launches += e.count
        name = next((g for g in ("walk_kernel", "slab_cull_kernel", "gather_cols_kernel")
                     if g in e.key), None)
        groups[name[:-len("_kernel")] if name else "other"] += e.device_time_total / 1e3
    log(f"[profile] {block} iterations under the profiler: wall {wall_ms:.1f} ms, "
        f"device busy {busy_ms:.1f} ms (idle share {1 - busy_ms / wall_ms:.3f}), "
        f"{launches} kernel launches")
    log("[profile] device ms per iteration: " + ", ".join(
        f"{g} {v / block:.2f}" for g, v in groups.items()))
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:12]:
        log(f"[profile]   {e.device_time_total / 1e3 / block:9.3f} ms/iter "
            f"{e.count // block:6d} launches/iter  {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")
    t = time.perf_counter()
    logs = cuda_build.build_all()
    log(f"[build] {len(logs)} kernels built in {time.perf_counter() - t:.1f} s "
        f"(nvcc {' '.join(cuda_build.NVCC_FLAGS)})")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"[build] {name}: {line.strip()}")

    device = torch.device("cuda", torch.cuda.current_device())
    scene = mesh_scene(6, 2.5, 800, device)
    config = RenderConfig(trace_depth=8, antialias=True, **WALK)
    results = phase_kernels(scene, config, device)
    phase_goldens(device)
    launches = phase_main_path(scene, config, device)

    record = {"kernels": [
        dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=launches[name],
             **{k: results[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                              "bound_ms", "bound_by", "library_ms")})
        for name, _, source, replaces in KERNELS
    ]}
    log(f"[card] {card}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
