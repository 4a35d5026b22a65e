"""Render traffic: frames back to back into one film, one frame in flight.

Set-up loads the scene through the port (``load_scene``: the OBJ parse,
the KD and cluster builds, the move to the device), builds the film step
(``render.integrator.make_render_fn``) and renders one warm-up frame,
which builds and loads every kernel the route launches. The window then
adds frame after frame to a zeroed film, each ended by a synchronise,
until a frame would begin after ``--seconds``. With ``--trace 1`` a few
more frames run under the profiler after the window.

The check: one frame of the window, drawn from the seed among its first
``check_frames``, at ``check_pixels`` pixels drawn from the seed. What the
frame added to the film there is compared with the plain reference's
radiance of the same pixels, iteration and key.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from gpubench import checks, harness, meshgen
from gpubench.reference import render as ref_render
from gpubench.reference import scene as ref_scene
from gpubench.reference.rng import prng_key as ref_key


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_plan(tr, seed: int, dev):
    """(the sampled pixels, sorted, on ``dev``; the checked frame)."""
    w, h = tr["film"]
    rng = np.random.default_rng(seed)
    n_check = min(int(tr["check_pixels"]), w * h)
    idx = torch.as_tensor(np.sort(rng.choice(w * h, n_check, replace=False)), device=dev)
    return idx, int(rng.integers(0, int(tr["check_frames"])))


def reference_radiance(cell, seed: int, dev, work_dir, iteration: int, idx, quant="exact"):
    """The plain reference's radiance [n, 3] at pixels ``idx`` of one
    iteration, on the host."""
    tr = cell.traffic
    jitter = tr.get("render_config", {}).get("aa_jitter_scale", ref_render.AA_JITTER)
    scene_path, obj_path = meshgen.write_inputs(cell.config, work_dir)
    ref = ref_scene.load(scene_path, obj_path, tuple(tr["film"]))
    prep = ref_render.prepare(ref, dev)
    mats = {k: torch.as_tensor(v, device=dev) for k, v in ref.materials.items()}
    with torch.no_grad():
        return ref_render.trace(prep, mats, idx, ref_key(seed), iteration, int(tr["depth"]),
                                bool(tr["antialias"]), jitter, ref_render.QUANT[quant]).cpu()


def control(cell, seed: int, device: str, work_dir, faults=("tf32",)) -> dict:
    """{fault: the checks} with the reference in a lower precision ("tf32")
    put in the program's place, at the frame and pixels a run of ``seed``
    checks."""
    dev = torch.device(device)
    idx, j = check_plan(cell.traffic, seed, dev)
    want = reference_radiance(cell, seed, dev, work_dir, 1 + j, idx)
    return {fault: {"pixels_off_share": checks.pixels_off_share(
        reference_radiance(cell, seed, dev, work_dir, 1 + j, idx, fault), want)}
        for fault in faults}


def run(cell, seed: int, seconds: float, trace: bool, device: str, start_epoch: float,
        work_dir) -> harness.Run:
    tr = cell.traffic
    dev = torch.device(device)
    t_setup = time.perf_counter()
    before_loop = time.time() - start_epoch
    from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig
    from kdtreepathtraceroptimization_tpu_torch.ops.rng import prng_key
    from kdtreepathtraceroptimization_tpu_torch.render import integrator
    from kdtreepathtraceroptimization_tpu_torch.scene.parser import load_scene, with_resolution
    if dev.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=dev)
    stages = {"process start to the traffic loop (interpreter, torch import)": before_loop,
              "port import and CUDA init": time.perf_counter() - t_setup}

    w, h = tr["film"]
    depth = int(tr["depth"])
    config = RenderConfig(trace_depth=depth, antialias=bool(tr["antialias"]),
                          **tr.get("render_config", {}))
    t = time.perf_counter()
    scene_path, obj_path = meshgen.write_inputs(cell.config, work_dir)
    stages["inputs"] = time.perf_counter() - t
    t = time.perf_counter()
    scene = with_resolution(load_scene(str(scene_path), obj_path=obj_path and str(obj_path),
                                       device=dev), w, h)
    _sync(dev)
    scene_load_s = time.perf_counter() - t
    stages["scene load"] = scene_load_s
    route = integrator.mesh_route(scene.mesh, scene.cmesh, config, scene.kd)
    n_tris = 0 if scene.mesh is None else int(scene.mesh.v0.shape[0])
    harness.log(f"{cell.name}: route {route}, {n_tris} triangles, film {w}x{h}, depth {depth}")

    t = time.perf_counter()
    step = integrator.make_render_fn(scene, config, seed=seed, device=dev)
    key = prng_key(seed)
    film = torch.zeros((w * h, 3), dtype=torch.float32, device=dev)
    for k in range(int(tr.get("warmup_frames", 1))):
        step(film, key, -1 - k)
    _sync(dev)
    film.zero_()
    stages["step build and warm-up"] = time.perf_counter() - t

    idx, j = check_plan(tr, seed, dev)
    n_check = idx.shape[0]
    stages["loop set-up total"] = time.perf_counter() - t_setup

    # the window
    unit_ms = []
    before = after = None
    checked_it = None
    t_start = time.perf_counter()
    setup_s = time.time() - start_epoch
    deadline = t_start + seconds
    f = 0
    t_end = t_start
    while f == 0 or t_end < deadline:
        if f <= j:
            before = film.index_select(0, idx)
        t0 = time.perf_counter()
        step(film, key, 1 + f)
        _sync(dev)
        t_end = time.perf_counter()
        unit_ms.append((t_end - t0) * 1e3)
        if f == j:
            after, checked_it = film.index_select(0, idx), 1 + f
        f += 1
    window_s = t_end - t_start
    if after is None:  # the window ended before frame j: check its last frame
        after, checked_it = film.index_select(0, idx), f
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    harness.log("set-up stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
                + f"; set-up from process start {setup_s:.3f}")
    harness.log(f"window: {f} frames in {window_s:.3f} s; frame ms min {min(unit_ms):.3f}, "
                f"median {np.median(unit_ms):.3f}, max {max(unit_ms):.3f} ({len(unit_ms)} samples)")

    prof = None
    if trace:
        base = 1 + f

        def frame(k):
            step(film, key, base + k)

        prof, err = harness.profile_units(frame, int(tr["profile_frames"]), lambda: _sync(dev))
        if err or prof is None:
            harness.log(f"profile not measured: {err or 'no device activity recorded'}")
        else:
            harness.log(f"profiled {prof.units} frames: window {prof.window_s:.3f} s, device busy "
                        f"{prof.busy_s:.3f} s, {prof.launches} launches, {prof.dtoh} host reads")

    prog = (after - before).cpu()
    del step, scene, film, before, after
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    want = reference_radiance(cell, seed, dev, work_dir, checked_it, idx)
    off = checks.pixels_off_share(prog, want)
    harness.log(f"checked frame {checked_it - 1} (iteration {checked_it}) at {n_check} pixels: "
                f"mean |d| {float((prog - want).abs().mean()):.3g}, max |d| "
                f"{float((prog - want).abs().max()):.3g}, reference mean "
                f"{float(want.mean()):.4f}; reference {time.perf_counter() - t:.2f} s")
    run = harness.Run(kind="render", pixels=w * h, depth=depth, units=f, window_s=window_s,
                      unit_ms=unit_ms, setup_s=setup_s, scene_load_s=scene_load_s,
                      peak_bytes=peak, profile=prof)
    run.checks["pixels_off_share"] = {"value": off, "limit": cell.limits["pixels_off_share"]}
    return run
