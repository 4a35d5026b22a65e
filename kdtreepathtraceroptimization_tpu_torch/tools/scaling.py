"""Scaling of the ray-axis split over ranks (``parallel/sharding.py``).

The JAX package's ``tools/scaling.py`` for the port. For each world size
it can run (ranks of one card each with NCCL, up to
``torch.cuda.device_count()``; gloo ranks on the CPU), the pair-list
render split over the ranks' slabs:

- wall ms per iteration and rays/s (rank 0's clock between two barriers,
  the card synchronised);
- the collectives a forward step and a training step issue
  (``sharding.COLLECTIVES``): the forward pass must issue none, the
  training step one ``all_reduce`` of the loss and every gradient;

and, independent of the ranks, the measured work of one call of the pair
list at ``binned_shards`` = S = 1, 2, 4, 8 on the camera rays: the pair
rows one row of the [S, n / S] view runs (``pair_rows`` of
``intersect_mesh_pairs(..., collect_stats=True)``) and the rounds of its
three passes, with ``measured_work_efficiency`` = rows(S = 1) / (rows(S) x
S). The JAX tool also reports the compiled module's FLOPs per device; the
port compiles no module, so it has no such row.

Usage:
    python -m kdtreepathtraceroptimization_tpu_torch.tools.scaling \\
        [--res 256] [--subdiv 5] [--depth 4] [--json out.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile
import time

_CORNELL = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "scenes", "cornell.txt")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _scene(res: int, subdiv: int, device):
    from kdtreepathtraceroptimization_tpu_torch.scene.parser import load_scene, with_resolution
    from kdtreepathtraceroptimization_tpu_torch.utils.procmesh import icosphere, write_obj

    verts, faces = icosphere(subdiv, radius=2.5, center=(0.0, 3.0, 0.0))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"icosphere{subdiv}.obj")
        write_obj(path, verts, faces)
        scene = load_scene(_CORNELL, obj_path=path, build_kd=False, device=device)
    return with_resolution(scene, res, res), len(faces)


def _config(depth: int):
    from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig

    return RenderConfig(trace_depth=depth, antialias=True, cluster=True, cluster_pairs=True)


def _rank_row(rank: int, world: int, port: int, res: int, subdiv: int, depth: int,
              iters: int, device_type: str, out: str) -> None:
    """One rank of a world: join the group, time the sharded render, count
    a forward and a training step's collectives; rank 0 writes the row."""
    import torch
    import torch.distributed as dist

    from kdtreepathtraceroptimization_tpu_torch.ops.rng import prng_key
    from kdtreepathtraceroptimization_tpu_torch.parallel import multihost
    from kdtreepathtraceroptimization_tpu_torch.parallel import sharding as sh

    device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    own = not sh.grouped()  # a caller's group of one rank is used as it is
    multihost.initialize(f"localhost:{port}", world, rank, device=device, timeout_s=120.0)
    try:
        scene, _ = _scene(res, subdiv, device)
        config = _config(depth)
        n = res * res
        step = sh.make_sharded_render_fn(scene, config, device=device)
        key = prng_key(0)

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        film = step(sh.device_film(n, device=device), key, 1)  # warm-up
        sync()
        sh.reset_collectives()
        film = step(film, key, 2)
        forward = dict(sh.COLLECTIVES)
        film = sh.device_film(n, device=device)
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        for it in range(iters):
            film = step(film, key, 3 + it)
        sync()
        dist.barrier()
        sec = (time.perf_counter() - t0) / iters

        init_state, train_step = sh.make_sharded_train_step(
            scene, config, torch.zeros((n, 3)), device=device)
        sh.reset_collectives()
        train_step(init_state(), key, 1)
        train = dict(sh.COLLECTIVES)
        if rank == 0:
            with open(out, "w") as f:
                json.dump({"devices": world, "ms_per_iter": sec * 1e3,
                           "rays_per_sec": n * depth / sec,
                           "collectives": {"forward_step": forward, "train_step": train}}, f)
    finally:
        if own:
            dist.destroy_process_group()


def _world_row(world: int, res: int, subdiv: int, depth: int, iters: int,
               device_type: str) -> dict:
    """Run one world size: in this process for one rank, else ``world``
    spawned processes."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "row.json")
        args = (world, _free_port(), res, subdiv, depth, iters, device_type, out)
        if world == 1:
            _rank_row(0, *args)
        else:
            mp.start_processes(_rank_row, args=args, nprocs=world, join=True,
                               start_method="spawn")
        with open(out) as f:
            return json.load(f)


def measured_work(scene, depth: int, shards=(1, 2, 4, 8), device=None) -> list:
    """Pair rows and rounds of one pair-list call on the camera rays at
    each ``binned_shards`` = S (one row of the [S, n / S] view's work)."""
    from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig
    from kdtreepathtraceroptimization_tpu_torch.ops import intersect as isect
    from kdtreepathtraceroptimization_tpu_torch.ops.camera import generate_rays
    from kdtreepathtraceroptimization_tpu_torch.ops.pairs import intersect_mesh_pairs
    from kdtreepathtraceroptimization_tpu_torch.ops.rng import bounce_key, prng_key

    rays = generate_rays(scene.camera, RenderConfig(trace_depth=depth, antialias=True),
                         bounce_key(prng_key(0), 1, 0), depth, device)
    ghit = isect.intersect_geoms(rays.origin, rays.direction, scene.geoms)
    rows = []
    for s in shards:
        cfg = RenderConfig(trace_depth=depth, cluster=True, cluster_pairs=True,
                           binned_shards=s)
        _, st = intersect_mesh_pairs(rays.origin, rays.direction, scene.cmesh, cfg,
                                     t_init=ghit.t, collect_stats=True)
        rows.append({"devices": s, "per_device_pair_rows": st["pair_rows"],
                     "n1_rounds": st["n1_rounds"], "p2_rounds": st["p2_rounds"],
                     "p3_rounds": st["p3_rounds"], "m1": st["m1"], "m2": st["m2"],
                     "m3": st["m3"]})
        print(f"measured work S={s}: rows/dev={st['pair_rows']} rounds="
              f"({st['n1_rounds']},{st['p2_rounds']},{st['p3_rounds']})", flush=True)
    base = rows[0]["per_device_pair_rows"]
    for r in rows:
        r["measured_work_efficiency"] = base / (r["per_device_pair_rows"] * r["devices"])
    return rows


def run(res: int = 256, subdiv: int = 5, depth: int = 4, iters: int = 1, worlds=None,
        shards=(1, 2, 4, 8), device=None) -> dict:
    """The scaling record: one row per world size in ``worlds`` (default:
    1, 2, 4, ... up to the host's cards; 1 and 2 gloo ranks on the CPU)
    and the measured-work rows at each of ``shards``."""
    import torch

    from kdtreepathtraceroptimization_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    if worlds is None:
        most = torch.cuda.device_count() if device.type == "cuda" else 2
        worlds = [w for w in (1, 2, 4, 8) if w <= most]
    rows = []
    for w in worlds:
        row = _world_row(w, res, subdiv, depth, iters, device.type)
        rows.append(row)
        print(f"devices={w}: {row['ms_per_iter']:.3f} ms/iter "
              f"{row['rays_per_sec'] / 1e6:.3f} M rays/s collectives={row['collectives']}",
              flush=True)
    base = rows[0]["rays_per_sec"]
    for r in rows:
        r["wall_efficiency_vs_linear"] = r["rays_per_sec"] / (base * r["devices"])
    scene, n_tris = _scene(res, subdiv, device)
    return {
        "platform": device.type,
        "config": {"res": res, "tris": n_tris, "depth": depth, "intersector": "pairs"},
        "note": (
            "rows: wall ms per iteration of the ray-axis split, one process a rank "
            "(NCCL on cards, gloo on the CPU; gloo ranks share one host's cores, so "
            "their wall clock bounds only the split's overhead), with the collectives "
            "one forward step and one training step issue (forward: none). "
            "measured_work: executed pair rows and rounds of one row of the "
            "[S, n/S] view in one pair-list call on the camera rays, against the "
            "ideal 1/S of S=1's. The JAX tool's compiled-FLOPs rows have no "
            "counterpart: the port compiles no module."),
        "rows": rows,
        "measured_work": measured_work(scene, depth, shards, device),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--json", default=None, help="write the record here")
    p.add_argument("--res", type=int, default=256)
    p.add_argument("--subdiv", type=int, default=5)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--iters", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    out = run(res=args.res, subdiv=args.subdiv, depth=args.depth, iters=args.iters,
              device=args.device)
    text = json.dumps(out, indent=1)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
