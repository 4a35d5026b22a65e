"""Wavefront path-tracing integrator.

The JAX package's ``render/integrator.py`` in PyTorch (reference:
src/pathtrace.cu:2405-2635). One iteration generates camera rays (or
reuses the cached ones), then for every bounce intersects the analytic
geoms and the mesh, gathers materials, draws the bounce's uniforms,
scatters and shades; the bounce loop is a Python loop over a fixed-shape
wavefront (finished lanes are masked, never removed).

Meshes take, as the JAX dispatch picks them: a cluster intersector when
the scene has a cluster table and ``cluster`` is set or the mesh has at
least ``cluster_min_tris`` triangles (``cluster_auto``) — the pair list
(``ops/pairs.py``, the default), the exact cluster walk (``ops/walk.py``),
the binned intersector (``ops/binned.py``) or cluster rounds
(``ops/cluster.py``); else a KD walk (``ops/traverse.py``) when
``enable_kd`` is set and the scene has a KD table; else a brute force
(``ops/mxu_bf.py`` or ``ops/mesh.py``).

The wavefront reorderings run at the end of each bounce
(``ops/compaction.py``, the reference's pathtrace.cu:2591-2606): the
material sort (``material_sort``) or else compaction (``compaction``).
The random streams are keyed by pixel, so they do not change the image;
the final gather then scatters each path's colour to its ``pixel_index``.
The ray cache (``ray_cache``, the reference's key C) draws the camera rays
once, from the seed ``make_render_fn`` is given, and reuses them every
iteration; ``make_render_block_fn`` ignores it, as the JAX package's does.
Entry points run on the CUDA device unless the caller passes
``device="cpu"``.

``trace_iteration`` and ``trace_rays`` are differentiable (the JAX
package's inverse-rendering path, ``models/inverse.py``): with respect to
the material table and the camera when they are tensors, and to the mesh's
triangle tables through the hit expansion's [T, 19] record. The
intersectors run without a graph: the choice of triangle is discrete.
``make_render_fn`` and ``make_render_block_fn`` render without a graph.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig
from kdtreepathtraceroptimization_tpu_torch.convert import materials_to_torch, scene_from_numpy
from kdtreepathtraceroptimization_tpu_torch.ops import bsdf, mxu_bf, shade
from kdtreepathtraceroptimization_tpu_torch.ops import intersect as isect
from kdtreepathtraceroptimization_tpu_torch.ops import mesh as mesh_ops
from kdtreepathtraceroptimization_tpu_torch.ops import vecmath as vm
from kdtreepathtraceroptimization_tpu_torch.ops.binned import intersect_mesh_binned
from kdtreepathtraceroptimization_tpu_torch.ops.camera import RaySoA, generate_rays
from kdtreepathtraceroptimization_tpu_torch.ops.compaction import compact_rays, sort_rays_by_material
from kdtreepathtraceroptimization_tpu_torch.ops.cluster import intersect_mesh_cluster
from kdtreepathtraceroptimization_tpu_torch.ops.rng import Key, bounce_key, prng_key, uniform_cols
from kdtreepathtraceroptimization_tpu_torch.ops.pairs import intersect_mesh_pairs
from kdtreepathtraceroptimization_tpu_torch.ops.traverse import intersect_mesh_kd
from kdtreepathtraceroptimization_tpu_torch.ops.walk import intersect_mesh_walk
from kdtreepathtraceroptimization_tpu_torch.utils.device import resolve_device, use_full_f32
from kdtreepathtraceroptimization_tpu_torch.utils.trace import add, span

_INTERSECT_SPAN = {r: "kdpt.intersect." + r
                   for r in ("pairs", "walk", "binned", "cluster", "kd", "mxu", "brute")}


def mesh_route(mesh, cmesh, config: RenderConfig, kd=None) -> Optional[str]:
    """The mesh intersector ``config`` selects (the JAX dispatch): None
    without a mesh, else "pairs", "walk", "binned", "cluster", "kd", "mxu"
    or "brute"."""
    if mesh is None:
        return None
    use_cluster = cmesh is not None and (
        config.cluster
        or (config.cluster_auto
            and int(mesh.v0.shape[0]) >= config.cluster_min_tris)
    )
    if use_cluster:
        if config.cluster_pairs:
            return "pairs"
        if config.cluster_walk:
            return "walk"
        if config.cluster_binned:
            return "binned"
        return "cluster"
    if config.enable_kd and kd is not None:
        return "kd"
    return "mxu" if config.mxu_brute else "brute"


def intersect_scene(origin, direction, geoms, mesh, config: RenderConfig,
                    active=None, cmesh=None, mesh_packed=None, kd=None) -> isect.Hit:
    """Nearest hit against analytic geoms + (optional) triangle mesh.

    Analytic geoms go first so their nearest t bounds the mesh search, and
    ``active`` lets finished lanes skip it (reference dispatch:
    pathtrace.cu:2483-2559). The brute-force routes need ``mesh_packed``,
    the mesh's [T, 19] record (``ops.mesh.pack_tris``), built once by the
    caller; the cluster routes read ``cmesh.packed``, the KD route
    ``kd.packed`` (the record of its leaf-duplicated triangles, which its
    triangle ids index). The mesh
    intersectors run without a graph (the JAX package's ``stop_gradient``):
    gradients reach the mesh through ``packed``.
    """
    with span("kdpt.geoms"):
        hit = isect.intersect_geoms(origin, direction, geoms)
    route = mesh_route(mesh, cmesh, config, kd)
    if route is None:
        return hit
    origin = vm.as_rows(origin)
    direction = vm.as_rows(direction)
    if route in ("mxu", "brute") and mesh_packed is None:
        raise ValueError("the brute-force routes need mesh_packed, the "
                         "mesh's [T, 19] record (ops.mesh.pack_tris)")
    t_init = hit.t.detach()
    with torch.no_grad(), span(_INTERSECT_SPAN[route]):
        if route == "pairs":
            tri_hit = intersect_mesh_pairs(origin, direction, cmesh, config,
                                           t_init=t_init, active=active)
        elif route == "walk":
            tri_hit = intersect_mesh_walk(origin, direction, cmesh, config,
                                          t_init=t_init, active=active)
        elif route == "binned":
            tri_hit = intersect_mesh_binned(origin, direction, cmesh, config,
                                            t_init=t_init, active=active)
        elif route == "cluster":
            tri_hit = intersect_mesh_cluster(origin, direction, cmesh, config,
                                             t_init=t_init, active=active)
        elif route == "kd":
            tri_hit = intersect_mesh_kd(origin, direction, kd, config,
                                        t_init=t_init, active=active)
        elif route == "mxu":
            tri_hit = mxu_bf.intersect_mesh_mxu(origin, direction, mesh, t_max=t_init)
        else:
            tri_hit = mesh_ops.intersect_mesh_brute(origin, direction, mesh,
                                                    use_bbox=config.use_bbox)
    if route in ("mxu", "brute"):
        packed = mesh_packed
    else:
        packed = kd.packed if route == "kd" else cmesh.packed
    with span("kdpt.hit_expand"):
        mesh_hit = mesh_ops.tri_hit_to_hit(origin, direction, tri_hit, packed)
        return isect._min_hit(hit, mesh_hit)


def trace_iteration(geoms, materials, mesh, camera, config: RenderConfig,
                    base_key: Key, iteration: int, cmesh=None,
                    device=None, mesh_packed=None, kd=None,
                    cached_rays: Optional[RaySoA] = None,
                    pixels: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One path-trace iteration -> per-pixel radiance [N, 3].
    ``cached_rays`` replaces the camera rays (the ray cache, key C:
    pathtrace.cu:2448-2456). ``pixels`` = (lo, hi) traces pixels lo .. hi
    - 1 only and returns their [hi - lo, 3] rows, equal to the same rows of
    the full film (the streams are keyed by pixel, the intersectors exact
    per ray)."""
    rays = cached_rays
    if rays is None:
        with span("kdpt.camera"):
            rays = generate_rays(camera, config, bounce_key(base_key, iteration, 0),
                                 config.effective_depth, device, pixels=pixels)
    return trace_rays(rays, geoms, materials, mesh, config, base_key,
                      iteration, cmesh=cmesh, mesh_packed=mesh_packed, kd=kd,
                      first_pixel=0 if pixels is None else int(pixels[0]))


def trace_rays(rays: RaySoA, geoms, materials, mesh, config: RenderConfig,
               base_key: Key, iteration: int, cmesh=None,
               mesh_packed=None, kd=None, first_pixel: int = 0) -> torch.Tensor:
    """Trace a wavefront through the bounce loop -> radiance [N, 3], one
    row a pixel: row i is pixel ``first_pixel`` + i."""
    n = rays.origin.x.shape[0]
    for depth in range(config.effective_depth):
        with span("kdpt.bounce"):
            active = rays.remaining_bounces > 0
            add("live_lanes", active, depth)
            hit = intersect_scene(rays.origin, rays.direction, geoms, mesh,
                                  config, active=active, cmesh=cmesh,
                                  mesh_packed=mesh_packed, kd=kd)
            with span("kdpt.scatter"):
                mat = bsdf.gather_materials(materials, hit.material_id)
                # Streams are keyed by pixel, not lane (reference: pathtrace.cu:62-66),
                # so the reorderings below leave the image as it is.
                u = uniform_cols(bounce_key(base_key, iteration, depth + 1), n, 8,
                                 lane=rays.pixel_index)
                scattered = bsdf.scatter(rays.origin, rays.direction, rays.is_inside,
                                         hit.point, hit.normal, mat, u,
                                         config.softness)
            with span("kdpt.shade"):
                new_color, new_bounces = shade.shade(
                    rays.color, rays.remaining_bounces, hit.t, mat, rays.sdepth,
                    config.enable_sss)
                keep = active & (hit.t < isect.BIG)
                rays = RaySoA(
                    origin=vm.wherev(keep, scattered.origin, rays.origin),
                    direction=vm.wherev(keep, scattered.direction, rays.direction),
                    color=new_color,
                    is_inside=torch.where(keep, scattered.is_inside, rays.is_inside),
                    sdepth=torch.where(keep, scattered.sdepth, rays.sdepth),
                    pixel_index=rays.pixel_index,
                    remaining_bounces=new_bounces,
                )
            # the wavefront reorderings (reference: thrust remove_if / sort,
            # pathtrace.cu:2591-2606)
            if config.material_sort:
                with span("kdpt.reorder"):
                    rays, _ = sort_rays_by_material(rays, hit.material_id)
            elif config.compaction:
                with span("kdpt.reorder"):
                    rays, _ = compact_rays(rays)

    # finalGather (pathtrace.cu:2373-2383); ``partial_gather`` drops paths
    # still alive after the last bounce (pathtrace.cu:2386-2399). A
    # reordered wavefront scatters each path to its pixel.
    with span("kdpt.gather"):
        color = vm.v3_to_rows(rays.color)
        if config.partial_gather:
            color = torch.where((rays.remaining_bounces == 0)[:, None], color, 0.0)
        if config.material_sort or config.compaction:
            color = torch.zeros_like(color).index_copy(0, rays.pixel_index.long() - first_pixel,
                                                       color)
        return color


def _make_step(scene, config: RenderConfig, block: int, device, seed: Optional[int],
               pixels: Optional[Tuple[int, int]] = None):
    """The film step of ``make_render_fn`` (``seed`` given: the ray cache
    draws from it when configured) and ``make_render_block_fn`` (no seed:
    no cache); with ``pixels`` = (lo, hi), of the film's rows lo .. hi - 1
    only (``parallel/sharding.py``)."""
    device = resolve_device(device)
    use_full_f32()
    scene = scene_from_numpy(scene, device)
    materials = materials_to_torch(scene.materials, device)
    brute = mesh_route(scene.mesh, scene.cmesh, config, scene.kd) in ("mxu", "brute")
    mesh_packed = mesh_ops.pack_tris(scene.mesh) if brute else None
    cached = None
    if config.ray_cache and seed is not None:
        # first-bounce ray caching (key C, pathtrace.cu:2448-2456): the
        # camera rays of iteration 1 from the caller's seed, AA jitter and
        # all, reused every iteration
        cached = generate_rays(scene.camera, config, bounce_key(prng_key(seed), 1, 0),
                               config.effective_depth, device, pixels=pixels)

    @torch.no_grad()
    def step(film: torch.Tensor, base_key: Key, start_iter: int) -> torch.Tensor:
        for i in range(block):
            with span("kdpt.frame"):
                color = trace_iteration(scene.geoms, materials, scene.mesh,
                                        scene.camera, config, base_key,
                                        int(start_iter) + i, cmesh=scene.cmesh,
                                        device=device, mesh_packed=mesh_packed,
                                        kd=scene.kd, cached_rays=cached, pixels=pixels)
                with span("kdpt.gather"):
                    film += color
                del color  # not held through the next iteration
        return film

    return step


def make_render_fn(scene, config: RenderConfig, seed: int = 0, device=None,
                   pixels: Optional[Tuple[int, int]] = None) -> Callable:
    """A ``(film, base_key, iteration) -> film`` step adding one
    iteration's radiance to ``film`` ([N, 3] sum, updated in place).
    ``seed`` matters only with ``ray_cache``: the cached camera rays come
    from ``prng_key(seed)`` once, here, so pass the seed ``base_key``
    comes from. With ``pixels`` = (lo, hi) the film is rows lo .. hi - 1
    of the full film, [hi - lo, 3] (``parallel/sharding.py``)."""
    return _make_step(scene, config, 1, device, seed, pixels)


def make_render_block_fn(scene, config: RenderConfig, block: int,
                         device=None) -> Callable:
    """A ``(film, base_key, start_iter) -> film`` step that adds
    ``block`` iterations ``start_iter .. start_iter + block - 1`` to
    ``film`` in place. Scene tables (the material table as tensors) move
    to the device once, here, and the brute-force routes' [T, 19] triangle
    record is built once, here. The step builds no autograd graph. It
    ignores ``ray_cache``, as the JAX package's block function does."""
    return _make_step(scene, config, block, device, None)


def render(scene, config: RenderConfig, spp: int, seed: int = 0,
           device=None) -> torch.Tensor:
    """Render ``spp`` iterations and return the averaged image [H, W, 3]
    on ``device`` (the CUDA device by default)."""
    device = resolve_device(device)
    res_x = int(scene.camera.resolution[0])
    res_y = int(scene.camera.resolution[1])
    film = torch.zeros((res_x * res_y, 3), dtype=torch.float32, device=device)
    key = prng_key(seed)
    step = make_render_fn(scene, config, seed=seed, device=device)
    for it in range(1, spp + 1):
        film = step(film, key, it)
    return (film / spp).reshape(res_y, res_x, 3)
