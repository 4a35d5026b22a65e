"""Training traffic: the inverse-rendering step, one step in flight.

Set-up loads the scene through the port, draws the target film (uniform
in [0, ``target_high``) on the device from the seed) and the starting
colour of every non-emissive material (uniform in ``init_color`` from the
seed), builds the step (``models.inverse.make_train_step``) and drives
that one state through the ``checked_steps`` first steps, iterations 1,
2, ...: they build and load every kernel, and their losses, the first
gradient and the change they make are what the check compares. The
window continues the same state step after step, each ended by a
synchronise, until a step would begin after ``--seconds``. With ``--trace
1`` a few more steps run under the profiler after the window.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from gpubench import checks, harness, meshgen
from gpubench.reference import render as ref_render
from gpubench.reference import scene as ref_scene
from gpubench.reference import train as ref_train
from gpubench.reference.rng import prng_key as ref_key

B1 = 0.9  # Adam's first-moment decay in the program (optax's default)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def inputs(cell, seed: int, dev, scene_path, obj_path):
    """(the reference's scene, the starting colour table, the target film
    [N, 3] on ``dev``), all from the seed."""
    tr = cell.traffic
    w, h = tr["film"]
    ref = ref_scene.load(scene_path, obj_path, (w, h))
    rng = np.random.default_rng(seed)
    color0 = ref.materials["color"].copy()
    dark = ref.materials["emittance"] == 0
    lo, hi = tr["init_color"]
    color0[dark] = rng.uniform(lo, hi, size=color0[dark].shape).astype(np.float32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    target = torch.rand((w * h, 3), generator=gen, device=dev) * float(tr["target_high"])
    return ref, color0, target


def reference_steps(cell, seed: int, dev, ref, color0, target, quant="exact", fault=""):
    tr = cell.traffic
    jitter = tr.get("render_config", {}).get("aa_jitter_scale", ref_render.AA_JITTER)
    prep = ref_render.prepare(ref, dev, int(tr.get("reference_chunk", ref_render.CHUNK)))
    return ref_train.steps(prep, dict(ref.materials, color=color0),
                           target, ref_key(seed), range(1, int(tr["checked_steps"]) + 1),
                           int(tr["depth"]), bool(tr["antialias"]), jitter, float(tr["lr"]),
                           ref_render.QUANT[quant], block=int(tr.get("reference_block", 1 << 18)),
                           fault=fault)


def control(cell, seed: int, device: str, work_dir, faults=("tf32",)) -> dict:
    """{fault: the checks} with the reference put in the program's place:
    in TF32 ("tf32"), or with a planted fault of a step ("half_batch",
    "double_grad": ``reference.train.steps``)."""
    dev = torch.device(device)
    scene_path, obj_path = meshgen.write_inputs(cell.config, work_dir)
    ref, color0, target = inputs(cell, seed, dev, scene_path, obj_path)
    want = reference_steps(cell, seed, dev, ref, color0, target)
    return {fault: checks.train_gaps(reference_steps(
        cell, seed, dev, ref, color0, target,
        *(("tf32", "") if fault == "tf32" else ("exact", fault))), want) for fault in faults}


def run(cell, seed: int, seconds: float, trace: bool, device: str, start_epoch: float,
        work_dir) -> harness.Run:
    tr = cell.traffic
    dev = torch.device(device)
    t_setup = time.perf_counter()
    before_loop = time.time() - start_epoch
    from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig
    from kdtreepathtraceroptimization_tpu_torch.models.inverse import make_train_step
    from kdtreepathtraceroptimization_tpu_torch.ops.rng import prng_key
    from kdtreepathtraceroptimization_tpu_torch.render import integrator
    from kdtreepathtraceroptimization_tpu_torch.scene.parser import load_scene, with_resolution
    if dev.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=dev)
    stages = {"process start to the traffic loop (interpreter, torch import)": before_loop,
              "port import and CUDA init": time.perf_counter() - t_setup}

    w, h = tr["film"]
    n = w * h
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
    harness.log(f"{cell.name}: route {route}, film {w}x{h}, depth {depth}")

    ref, color0, target = inputs(cell, seed, dev, scene_path, obj_path)
    scene = scene._replace(materials=scene.materials._replace(color=color0))

    t = time.perf_counter()
    init_state, train_step = make_train_step(scene, config, target, learning_rate=float(tr["lr"]),
                                             device=dev)
    state = init_state()
    fields = type(state.materials)._fields
    key = prng_key(seed)
    n_checked = int(tr["checked_steps"])
    losses, grad, p0 = [], None, {}
    for k, name in enumerate(fields):
        p0[name] = state.materials[k].detach().cpu().numpy().copy()
    step_s = []
    for s in range(1, n_checked + 1):
        t1 = time.perf_counter()
        state, loss = train_step(state, key, s)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t1)
        if s == 1:
            opt = state.optimizer
            grad = {}
            for k, name in enumerate(fields):
                st = opt.state.get(state.materials[k], {})
                g = st["exp_avg"] / (1 - B1) if "exp_avg" in st else torch.zeros_like(
                    state.materials[k])
                grad[name] = g.detach().cpu().numpy()
            del opt
    change = {name: state.materials[k].detach().cpu().numpy() - p0[name]
              for k, name in enumerate(fields)}
    _sync(dev)
    stages["step build and checked steps"] = time.perf_counter() - t
    stages["loop set-up total"] = time.perf_counter() - t_setup

    unit_ms = []
    t_start = time.perf_counter()
    setup_s = time.time() - start_epoch
    deadline = t_start + seconds
    s = n_checked + 1
    t_end = t_start
    units = 0
    while units == 0 or t_end < deadline:
        t0 = time.perf_counter()
        state, _ = train_step(state, key, s)
        _sync(dev)
        t_end = time.perf_counter()
        unit_ms.append((t_end - t0) * 1e3)
        s += 1
        units += 1
    window_s = t_end - t_start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    harness.log("set-up stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
                + f"; set-up from process start {setup_s:.3f}; checked steps "
                + ", ".join(f"{v:.3f}" for v in step_s))
    harness.log(f"window: {units} steps in {window_s:.3f} s; step ms min {min(unit_ms):.3f}, "
                f"median {np.median(unit_ms):.3f}, max {max(unit_ms):.3f} ({len(unit_ms)} samples)")

    prof = None
    if trace:
        base = s
        holder = [state]

        def one(k):
            holder[0], _ = train_step(holder[0], key, base + k)

        prof, err = harness.profile_units(one, int(tr["profile_steps"]), lambda: _sync(dev))
        if err or prof is None:
            harness.log(f"profile not measured: {err or 'no device activity recorded'}")
        else:
            harness.log(f"profiled {prof.units} steps: window {prof.window_s:.3f} s, device busy "
                        f"{prof.busy_s:.3f} s, {prof.launches} launches, {prof.dtoh} host reads")
        del holder
    del state, train_step, init_state, scene
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    want = reference_steps(cell, seed, dev, ref, color0, target)
    gaps = checks.train_gaps({"losses": losses, "grad": grad, "change": change}, want)
    harness.log("losses, program: " + ", ".join(f"{v:.9g}" for v in losses)
                + "; reference: " + ", ".join(f"{v:.9g}" for v in want["losses"]))
    harness.log(f"compared changes of: {', '.join(checks.counted_fields(want['grad']))}; "
                f"reference {time.perf_counter() - t:.2f} s")
    run = harness.Run(kind="train", pixels=n, depth=depth, units=units, window_s=window_s,
                      unit_ms=unit_ms, setup_s=setup_s, scene_load_s=scene_load_s,
                      peak_bytes=peak, profile=prof)
    for name, value in gaps.items():
        run.checks[name] = {"value": value, "limit": cell.limits[name]}
    return run
