"""Command-line renderer.

    python -m kdtreepathtraceroptimization_tpu_torch.cli SCENE.txt [MESH.obj] [options]

The JAX package's ``cli.py``, flag for flag, with the same defaults and
output names (reference: src/main.cpp:735-1085 and the key bindings of
1187-1343, one flag per key):

  key A antialias       -> --aa
  key C ray cache       -> --ray-cache
  key X subsurface      -> --sss
  key F compaction      -> --compaction
  key M material sort   -> --material-sort
  key K KD on/off       -> --no-kd (brute force)
  key B bbox cull       -> --no-bbox
  key L short-stack     -> --short-stack
  key V KD visualization-> --viz-kd
  key T benchmark       -> --benchmark
  -/= DoF blur, [/] focal -> --dof / --focal
  1/2 softness          -> --softness

It renders on the CUDA device unless ``--device`` names another
(``--device cpu``); without CUDA it raises rather than falling back. It
writes the averaged PNG at the end, and with ``--save-every N`` a
checkpoint (``<FILE>.ckpt.npz`` in the working directory, the JAX
package's format) every N iterations, which ``--resume`` continues.
``--interactive`` (``render/interactive.py``) renders until ``q`` (or
``--spp`` iterations), reading keys from the terminal or a pipe.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kdtreepathtraceroptimization_tpu_torch",
        description="KD-tree path tracer in PyTorch and CUDA",
    )
    p.add_argument("scene", help="scene .txt file (reference format)")
    p.add_argument("obj", nargs="?", default=None, help="optional OBJ mesh")
    p.add_argument("--mtl-dir", default=None, help="MTL search dir (default: obj dir)")
    p.add_argument("--spp", type=int, default=None, help="iterations (default: scene ITERATIONS)")
    p.add_argument("--res", type=int, nargs=2, default=None, metavar=("W", "H"))
    p.add_argument("--depth", type=int, default=None, help="trace depth (default: scene DEPTH)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--aa", action="store_true", help="antialiasing jitter")
    p.add_argument("--dof", type=float, default=0.0, help="depth-of-field angle")
    p.add_argument("--focal", type=float, default=8.0, help="focal length")
    p.add_argument("--softness", type=float, default=0.0, help="soft reflection cone")
    p.add_argument("--sss", action="store_true", help="subsurface scattering")
    p.add_argument("--no-kd", action="store_true", help="brute-force triangle loop")
    p.add_argument("--no-bbox", action="store_true", help="disable per-shape AABB cull")
    p.add_argument("--short-stack", action="store_true",
                   help="short-stack traversal variant (key L analog; the "
                        "stackless skip-link walk is the default)")
    p.add_argument("--compaction", action="store_true")
    p.add_argument("--material-sort", action="store_true")
    p.add_argument("--ray-cache", action="store_true")
    p.add_argument("--cluster", action="store_true",
                   help="force the cluster-family intersectors (variant "
                        "picked by --cluster-mode). By default meshes of at "
                        "least cluster_min_tris triangles take the pair-list "
                        "intersector, smaller ones the KD walk")
    p.add_argument("--no-auto-intersector", action="store_true",
                   help="disable the size-based auto-select; use only the "
                        "explicitly flagged intersector (--cluster / KD)")
    p.add_argument("--cluster-mode", default="pairs",
                   choices=["pairs", "walk", "binned", "rounds"],
                   help="cluster intersector variant: 'pairs' (ops/pairs.py, "
                        "per-ray-optimal pair scheduling, default), 'walk' "
                        "(ops/walk.py exact entry-ordered walk), 'binned' / "
                        "'rounds' (ops/binned.py, ops/cluster.py round-budget "
                        "forms)")
    p.add_argument("--unroll-bounces", action="store_true",
                   help="accepted for the JAX package's command line; changes "
                        "nothing: the bounce loop is always unrolled here, and "
                        "the JAX package's two forms give the same image")
    p.add_argument("--viz-kd", action="store_true", help="render KD node AABBs")
    p.add_argument("--benchmark", action="store_true",
                   help="print per-iteration timing (key T analog)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the steady-state "
                        "iterations into DIR (trace.json, Chrome trace format), "
                        "with the port's stage spans (kdpt.*) on its host rows")
    p.add_argument("--print-kd-stats", action="store_true",
                   help="print KD tree stats and write the Houdini-format "
                        "bbox dump next to the output image")
    p.add_argument("--leaf-size", type=int, default=32,
                   help="KD leaf size (the reference uses 2, KDnode.cpp:164)")
    p.add_argument("--kd-depth", type=int, default=None)
    p.add_argument("--output", "-o", default=None, help="output path (.png or .hdr)")
    p.add_argument("--hdr", action="store_true", help="also write Radiance .hdr")
    p.add_argument("--live", type=int, default=0, metavar="N",
                   help="draw the converging film in the terminal every N "
                        "iterations (ANSI truecolor half-blocks)")
    p.add_argument("--live-cols", type=int, default=64,
                   help="terminal preview width in character cells")
    p.add_argument("--interactive", action="store_true",
                   help="terminal interactive mode: keyboard camera, toggles "
                        "and live preview (render/interactive.py)")
    p.add_argument("--save-every", type=int, default=0,
                   help="write progressive checkpoints every N iterations")
    p.add_argument("--resume", default=None, help="resume from a .npz checkpoint")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: cuda; 'cpu' runs "
                        "the kernels' plain versions)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig
    from kdtreepathtraceroptimization_tpu_torch.ops.rng import bounce_key, prng_key
    from kdtreepathtraceroptimization_tpu_torch.render.film import (
        Film,
        load_checkpoint,
        save_checkpoint,
        tonemap_srgb_u8,
    )
    from kdtreepathtraceroptimization_tpu_torch.render.integrator import make_render_fn
    from kdtreepathtraceroptimization_tpu_torch.scene.parser import load_scene, with_resolution
    from kdtreepathtraceroptimization_tpu_torch.utils.device import resolve_device
    from kdtreepathtraceroptimization_tpu_torch.utils.image import (
        render_filename,
        write_hdr,
        write_png,
    )
    from kdtreepathtraceroptimization_tpu_torch.utils import trace

    device = resolve_device(args.device)
    scene = load_scene(
        args.scene,
        obj_path=args.obj,
        mtl_dir=args.mtl_dir,
        build_kd=not args.no_kd or args.viz_kd,
        leaf_size=args.leaf_size,
        max_depth=args.kd_depth,
        device=device,
    )
    if args.res:
        scene = with_resolution(scene, args.res[0], args.res[1])
    res_x = int(scene.camera.resolution[0])
    res_y = int(scene.camera.resolution[1])
    n = res_x * res_y

    spp = args.spp if args.spp is not None else scene.state.iterations
    depth = args.depth if args.depth is not None else scene.state.trace_depth

    config = RenderConfig(
        trace_depth=depth,
        antialias=args.aa,
        dof_angle=args.dof,
        focal_length=args.focal,
        softness=args.softness,
        enable_sss=args.sss,
        enable_kd=not args.no_kd,
        short_stack=args.short_stack,
        use_bbox=not args.no_bbox,
        compaction=args.compaction,
        # Key-F parity: the reference's compaction toggle also switches
        # to partialGather, which drops paths still alive at depth
        # exhaustion (pathtrace.cu:2386-2399, see config.py).
        partial_gather=args.compaction,
        material_sort=args.material_sort,
        ray_cache=args.ray_cache,
        cluster=args.cluster,
        cluster_auto=not args.no_auto_intersector,
        cluster_pairs=args.cluster_mode == "pairs",
        cluster_walk=args.cluster_mode == "walk",
        cluster_binned=args.cluster_mode == "binned",
    )

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if args.viz_kd:
        if scene.kd is None:
            print("error: --viz-kd requires an OBJ mesh", file=sys.stderr)
            return 2
        from kdtreepathtraceroptimization_tpu_torch.ops.camera import generate_rays
        from kdtreepathtraceroptimization_tpu_torch.ops.kdviz import render_kd_boxes

        rays = generate_rays(scene.camera, config, bounce_key(prng_key(args.seed), 1, 0), 1,
                             device)
        img = render_kd_boxes(rays.origin, rays.direction, scene.kd)
        out = args.output or render_filename(scene.state.image_name + ".kdviz", 1)
        write_png(out, tonemap_srgb_u8(img.reshape(res_y, res_x, 3)))
        print(f"wrote {out}")
        return 0

    if args.print_kd_stats and scene.kd is not None:
        from kdtreepathtraceroptimization_tpu_torch.accel.kdtools import (
            tree_stats,
            write_kd_to_file,
        )

        print("kd:", json.dumps(tree_stats(scene.kd)))
        dump = scene.state.image_name + ".kdboxes.txt"
        write_kd_to_file(scene.kd, dump)
        print(f"wrote {dump} (Houdini bbox-dump format)")

    if args.interactive:
        from kdtreepathtraceroptimization_tpu_torch.render.interactive import run_interactive

        def save_fn(img_np, iteration):
            out = args.output or render_filename(scene.state.image_name, iteration)
            write_png(out, tonemap_srgb_u8(img_np.reshape(res_y, res_x, 3)))
            print(f"\nwrote {out}", flush=True)

        run_interactive(scene, config, args.seed, save_fn, cols=args.live_cols,
                        max_iters=args.spp if args.spp else 0, device=device)
        return 0

    step = make_render_fn(scene, config, seed=args.seed, device=device)
    key = prng_key(args.seed)

    if args.resume:
        film = load_checkpoint(args.resume, device=device)
        accum = film.accum
        start_iter = film.iteration
        print(f"resumed at iteration {start_iter}")
    else:
        accum = torch.zeros((n, 3), dtype=torch.float32, device=device)
        start_iter = 0

    t_compile = time.perf_counter()
    times = []
    prof = None
    for it in range(start_iter + 1, spp + 1):
        if args.profile and it == start_iter + 2:
            # after the first iteration, so the trace is steady-state
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
            trace.enable(True)  # the stage names on the trace's host rows
        t0 = time.perf_counter()
        accum = step(accum, key, it)
        if args.benchmark:
            sync()  # the iteration's device work ends inside the timing
            dt = time.perf_counter() - t0
            times.append(dt)
            print(f"iter {it}: {dt*1e3:.2f} ms")
        if args.live and (it % args.live == 0 or it == start_iter + 1):
            from kdtreepathtraceroptimization_tpu_torch.utils.termview import live_frame

            print(live_frame(accum.cpu().numpy(), it, res_y, res_x, cols=args.live_cols,
                             first=(it == start_iter + 1)),
                  end="", flush=True)
        if args.save_every and it % args.save_every == 0:
            save_checkpoint(f"{scene.state.image_name}.ckpt.npz",
                            Film(accum=accum, iteration=it, seed=args.seed))
    sync()
    if prof is not None:
        trace.enable(False)
        trace.reset()
        prof.stop()
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        print(f"wrote profiler trace to {args.profile}")
    wall = time.perf_counter() - t_compile

    if args.benchmark and len(times) > 1:
        steady = times[1:]
        print(json.dumps({
            "metric": "ms/iteration",
            "value": round(1e3 * sum(steady) / len(steady), 3),
            "unit": "ms",
            "iterations": len(times),
        }))

    img = accum.cpu().numpy().reshape(res_y, res_x, 3) / max(spp, 1)
    out = args.output or render_filename(scene.state.image_name, spp)
    png = out if out.endswith(".png") else out + ".png"
    write_png(png, tonemap_srgb_u8(img))
    print(f"wrote {png} ({spp} spp in {wall:.1f}s)")
    if args.hdr:
        hdr_path = out.rsplit(".", 1)[0] + ".hdr"
        write_hdr(hdr_path, img)
        print(f"wrote {hdr_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
