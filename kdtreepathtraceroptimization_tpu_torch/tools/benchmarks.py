"""Benchmark sweep in the shape of the reference's published table.

The reference hand-pasted cudaEvent timings into
presentation/benchmarks.py as matrices of 10 runs x 4 modes
{bruteforce, bounding box, kd-tree, short-stack kd} x 8 mesh
resolutions (reference: presentation/benchmarks.py:27-381, README
table). This tool measures the same sweep live, as the JAX package's
``tools/benchmarks.py`` does: a Cornell box + a procedural icosphere at
growing subdivision levels, rendered in each traversal mode, reporting
the best ms/iteration.

Usage:
    python -m kdtreepathtraceroptimization_tpu_torch.tools.benchmarks \\
        [--res 800] [--iters 10] [--depth 8] [--subdiv 2 3 4 5] \\
        [--modes brute bbox kd short] [--json out.json] [--device cuda]

It renders on the CUDA device unless ``--device`` names another; res and
subdiv default to 800 and 2-5 on the card, 200 and 1-2 on the CPU. Each
row prints as it completes (lower is better).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

MODES = {
    # name -> RenderConfig overrides. 'brute' is the determinant-form
    # brute force (kernel 8); 'bbox' takes the streaming brute force with
    # per-shape AABB culling (mxu_brute=False), which the determinant form
    # does not cull by, so the two rows measure different code. The four
    # reference modes turn cluster_auto off: with it, a mesh of
    # cluster_min_tris triangles or more takes the pair list in all four.
    "brute": dict(enable_kd=False, use_bbox=False, cluster_auto=False),
    "bbox": dict(enable_kd=False, use_bbox=True, mxu_brute=False, cluster_auto=False),
    "kd": dict(enable_kd=True, short_stack=False, cluster_auto=False),
    "short": dict(enable_kd=True, short_stack=True, cluster_auto=False),
    # the cluster intersectors: no reference counterpart; in the sweep to
    # show where each crosses the KD walks
    "cluster": dict(cluster=True, cluster_walk=False, cluster_pairs=False),
    "walk": dict(cluster=True, cluster_walk=True, cluster_pairs=False),
    "pairs": dict(cluster=True, cluster_pairs=True),
}

# The intersector (render/integrator.mesh_route) each mode must take.
ROUTES = {"brute": "mxu", "bbox": "brute", "kd": "kd", "short": "kd", "cluster": "cluster",
          "walk": "walk", "pairs": "pairs"}

# The dragon sweep needs a high-poly OBJ that is not in the repository;
# point KDPT_DRAGON_OBJ at one (e.g. a Stanford-dragon mesh).
DRAGON = os.environ.get("KDPT_DRAGON_OBJ", "")

_CORNELL = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "scenes", "cornell.txt")


def _scene(res: int, subdiv: int, device):
    from kdtreepathtraceroptimization_tpu_torch.scene.parser import load_scene, with_resolution
    from kdtreepathtraceroptimization_tpu_torch.utils.procmesh import icosphere, write_obj

    verts, faces = icosphere(subdiv, radius=2.5, center=(0.0, 3.0, 0.0))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"icosphere{subdiv}.obj")
        write_obj(path, verts, faces)
        scene = load_scene(_CORNELL, obj_path=path, device=device)
    return with_resolution(scene, res, res), len(faces), len(verts)


def _dragon_scene(res: int, n_faces: int, device):
    """Cornell + the dragon mesh subsampled to ~n_faces (every k-th face,
    all vertices kept: a crude decimation that keeps the
    ms-vs-triangle-count axis the sweep measures)."""
    from kdtreepathtraceroptimization_tpu_torch.scene.parser import load_scene, with_resolution

    if not DRAGON or not os.path.exists(DRAGON):
        raise SystemExit("dragon sweep: set KDPT_DRAGON_OBJ to a high-poly OBJ path "
                         f"(got {DRAGON!r})")
    faces, vlines = [], []
    with open(DRAGON) as f:
        for line in f:
            if line.startswith("v "):
                vlines.append(line)
            elif line.startswith("f "):
                faces.append(line)
    faces = faces[::max(1, len(faces) // n_faces)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dragon.obj")
        with open(path, "w") as f:
            f.writelines(vlines)
            f.writelines(faces)
        scene = load_scene(_CORNELL, obj_path=path, device=device)
    return with_resolution(scene, res, res), int(scene.mesh.v0.shape[0]), len(vlines)


def mode_config(mode: str, depth: int):
    from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig

    return RenderConfig(trace_depth=depth, antialias=True, **MODES[mode])


def mode_route(scene, mode: str) -> str:
    """The intersector ``mode`` takes on ``scene``'s mesh."""
    from kdtreepathtraceroptimization_tpu_torch.render.integrator import mesh_route

    return mesh_route(scene.mesh, scene.cmesh, mode_config(mode, 1), scene.kd)


def time_mode(scene, mode: str, res: int, iters: int, depth: int, repeats: int = 3,
              device=None) -> float:
    """Best ms/iteration of one traversal mode: ``repeats`` timed blocks
    of ``iters`` iterations (``make_render_block_fn``) after one warm-up
    block, the device synchronised before the clock is read."""
    import torch

    from kdtreepathtraceroptimization_tpu_torch.ops.rng import prng_key
    from kdtreepathtraceroptimization_tpu_torch.render.integrator import make_render_block_fn
    from kdtreepathtraceroptimization_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    block = make_render_block_fn(scene, mode_config(mode, depth), iters, device=device)
    key = prng_key(0)
    block(torch.zeros((res * res, 3), device=device), key, 1)  # warm-up
    sync()
    best = float("inf")
    it0 = 1 + iters
    for _ in range(repeats):
        film = torch.zeros((res * res, 3), device=device)
        sync()
        t0 = time.perf_counter()
        block(film, key, it0)
        sync()
        best = min(best, (time.perf_counter() - t0) / iters * 1e3)
        it0 += iters
    return best


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--res", type=int, default=None,
                   help="image resolution (default 800 on the card, 200 on the CPU)")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--subdiv", type=int, nargs="+", default=None,
                   help="icosphere subdivision levels (tris = 20*4^s)")
    p.add_argument("--modes", nargs="+", default=list(MODES), choices=list(MODES))
    p.add_argument("--dragon", type=int, nargs="*", default=None,
                   help="extra rows: the KDPT_DRAGON_OBJ mesh subsampled to these face "
                        "counts")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--json", default=None, help="also write results as JSON")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; 'cpu' runs the kernels' plain "
                        "versions)")
    args = p.parse_args(argv)

    from kdtreepathtraceroptimization_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    res = args.res or (800 if on_card else 200)
    subdivs = args.subdiv or ([2, 3, 4, 5] if on_card else [1, 2])

    cases = [("icosphere", s) for s in subdivs]
    if args.dragon is not None:
        cases += [("dragon", nf) for nf in (args.dragon or [100000])]

    rows = []
    print("  ".join(f"{h:>18}" for h in ["mesh (tris/verts)"] + list(args.modes)))
    for kind, s in cases:
        if kind == "dragon":
            scene, n_tris, n_verts = _dragon_scene(res, s, device)
            row = {"mesh": f"dragon_{s}", "tris": n_tris, "verts": n_verts,
                   "res": res, "depth": args.depth, "ms": {}, "routes": {}}
        else:
            scene, n_tris, n_verts = _scene(res, s, device)
            row = {"subdiv": s, "tris": n_tris, "verts": n_verts, "res": res,
                   "depth": args.depth, "ms": {}, "routes": {}}
        cells = [f"{n_tris}/{n_verts}"]
        for mode in args.modes:
            row["routes"][mode] = mode_route(scene, mode)
            # the brute forces past 100k triangles: the reference's crash
            # row (README.md:208-209); here they only get slow, so skip
            if mode in ("brute", "bbox") and n_tris > 100_000:
                row["ms"][mode] = None
                cells.append("skip")
                continue
            ms = time_mode(scene, mode, res, args.iters, args.depth, repeats=args.repeats,
                           device=device)
            row["ms"][mode] = round(ms, 2)
            cells.append(f"{ms:.1f}ms")
            print("  ".join(f"{c:>18}" for c in cells), end="\r", flush=True)
        rows.append(row)
        print("  ".join(f"{c:>18}" for c in cells))
        if args.json:  # written row by row: a cut run keeps the rows done
            with open(args.json, "w") as f:
                json.dump({"res": res, "iters": args.iters, "device": str(device),
                           "rows": rows}, f, indent=2)
    if args.json:
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
