"""Wavefront path-tracing integrator.

The JAX package's ``render/integrator.py`` in PyTorch (reference:
src/pathtrace.cu:2405-2635). One iteration generates camera rays, then
for every bounce intersects the analytic geoms and the mesh, gathers
materials, draws the bounce's uniforms, scatters and shades; the bounce
loop is a Python loop over a fixed-shape wavefront (finished lanes are
masked, never removed), so lane i is pixel i throughout.

Meshes take the pair-list intersector (``ops/pairs.py``, the default
for a mesh with a cluster table), the exact cluster walk (``ops/walk.py``)
or, with ``enable_kd=False``, a brute force (``ops/mxu_bf.py`` or
``ops/mesh.py``). The KD walk, the cluster-rounds and binned
intersectors, the wavefront reorderings (compaction, material sort) and
the ray cache raise ``NotImplementedError``. Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.

``trace_iteration`` and ``trace_rays`` are differentiable (the JAX
package's inverse-rendering path, ``models/inverse.py``): with respect to
the material table and the camera when they are tensors, and to the mesh's
triangle tables through the hit expansion's [T, 19] record. The
intersectors run without a graph: the choice of triangle is discrete.
``make_render_block_fn`` renders without a graph.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig
from kdtreepathtraceroptimization_tpu_torch.convert import materials_to_torch, scene_from_numpy
from kdtreepathtraceroptimization_tpu_torch.ops import bsdf, mxu_bf, shade
from kdtreepathtraceroptimization_tpu_torch.ops import intersect as isect
from kdtreepathtraceroptimization_tpu_torch.ops import mesh as mesh_ops
from kdtreepathtraceroptimization_tpu_torch.ops import vecmath as vm
from kdtreepathtraceroptimization_tpu_torch.ops.camera import RaySoA, generate_rays
from kdtreepathtraceroptimization_tpu_torch.ops.rng import Key, bounce_key, prng_key, uniform_cols
from kdtreepathtraceroptimization_tpu_torch.ops.pairs import intersect_mesh_pairs
from kdtreepathtraceroptimization_tpu_torch.ops.walk import intersect_mesh_walk
from kdtreepathtraceroptimization_tpu_torch.utils.device import resolve_device, use_full_f32


def mesh_route(mesh, cmesh, config: RenderConfig) -> Optional[str]:
    """The mesh intersector ``config`` selects (the JAX dispatch): None
    without a mesh, else "pairs", "walk", "mxu" or "brute"; raises for
    the intersectors not ported yet."""
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
            raise NotImplementedError("the binned cluster intersector is not ported yet")
        raise NotImplementedError("the cluster-rounds intersector is not ported yet")
    if config.enable_kd:
        raise NotImplementedError(
            "the KD-tree intersector is not ported yet; give the scene a "
            "cluster table and set cluster=True, or set enable_kd=False")
    return "mxu" if config.mxu_brute else "brute"


def _check_supported(scene, config: RenderConfig) -> None:
    """Raise for what this slice does not implement, before any work."""
    if config.ray_cache:
        raise NotImplementedError("ray_cache=True is not ported yet")
    mesh_route(scene.mesh, scene.cmesh, config)


def intersect_scene(origin, direction, geoms, mesh, config: RenderConfig,
                    active=None, cmesh=None, mesh_packed=None) -> isect.Hit:
    """Nearest hit against analytic geoms + (optional) triangle mesh.

    Analytic geoms go first so their nearest t bounds the mesh search, and
    ``active`` lets finished lanes skip it (reference dispatch:
    pathtrace.cu:2483-2559). The brute-force routes need ``mesh_packed``,
    the mesh's [T, 19] record (``ops.mesh.pack_tris``), built once by the
    caller; the cluster routes read ``cmesh.packed``. The mesh
    intersectors run without a graph (the JAX package's ``stop_gradient``):
    gradients reach the mesh through ``packed``.
    """
    hit = isect.intersect_geoms(origin, direction, geoms)
    route = mesh_route(mesh, cmesh, config)
    if route is None:
        return hit
    origin = vm.as_rows(origin)
    direction = vm.as_rows(direction)
    if route in ("mxu", "brute") and mesh_packed is None:
        raise ValueError("the brute-force routes need mesh_packed, the "
                         "mesh's [T, 19] record (ops.mesh.pack_tris)")
    t_init = hit.t.detach()
    with torch.no_grad():
        if route == "pairs":
            tri_hit = intersect_mesh_pairs(origin, direction, cmesh, config,
                                           t_init=t_init, active=active)
        elif route == "walk":
            tri_hit = intersect_mesh_walk(origin, direction, cmesh, config,
                                          t_init=t_init, active=active)
        elif route == "mxu":
            tri_hit = mxu_bf.intersect_mesh_mxu(origin, direction, mesh, t_max=t_init)
        else:
            tri_hit = mesh_ops.intersect_mesh_brute(origin, direction, mesh,
                                                    use_bbox=config.use_bbox)
    packed = cmesh.packed if route in ("pairs", "walk") else mesh_packed
    mesh_hit = mesh_ops.tri_hit_to_hit(origin, direction, tri_hit, packed)
    return isect._min_hit(hit, mesh_hit)


def trace_iteration(geoms, materials, mesh, camera, config: RenderConfig,
                    base_key: Key, iteration: int, cmesh=None,
                    device=None, mesh_packed=None) -> torch.Tensor:
    """One path-trace iteration -> per-pixel radiance [N, 3]."""
    rays = generate_rays(camera, config, bounce_key(base_key, iteration, 0),
                         config.effective_depth, device)
    return trace_rays(rays, geoms, materials, mesh, config, base_key,
                      iteration, cmesh=cmesh, mesh_packed=mesh_packed)


def trace_rays(rays: RaySoA, geoms, materials, mesh, config: RenderConfig,
               base_key: Key, iteration: int, cmesh=None,
               mesh_packed=None) -> torch.Tensor:
    """Trace a wavefront through the bounce loop -> radiance [N, 3]."""
    if config.compaction or config.material_sort:
        raise NotImplementedError("compaction and material_sort are not ported yet")
    n = rays.origin.x.shape[0]
    for depth in range(config.effective_depth):
        active = rays.remaining_bounces > 0
        hit = intersect_scene(rays.origin, rays.direction, geoms, mesh,
                              config, active=active, cmesh=cmesh,
                              mesh_packed=mesh_packed)
        mat = bsdf.gather_materials(materials, hit.material_id)
        # Streams are keyed by pixel (reference: pathtrace.cu:62-66).
        u = uniform_cols(bounce_key(base_key, iteration, depth + 1), n, 8,
                         lane=rays.pixel_index)
        scattered = bsdf.scatter(rays.origin, rays.direction, rays.is_inside,
                                 hit.point, hit.normal, mat, u,
                                 config.softness)
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

    # finalGather (pathtrace.cu:2373-2383); ``partial_gather`` drops paths
    # still alive after the last bounce (pathtrace.cu:2386-2399).
    color = vm.v3_to_rows(rays.color)
    if config.partial_gather:
        color = torch.where((rays.remaining_bounces == 0)[:, None], color, 0.0)
    return color


def make_render_fn(scene, config: RenderConfig, device=None) -> Callable:
    """A ``(film, base_key, iteration) -> film`` step adding one
    iteration's radiance to ``film`` ([N, 3] sum, updated in place)."""
    return make_render_block_fn(scene, config, 1, device=device)


def make_render_block_fn(scene, config: RenderConfig, block: int,
                         device=None) -> Callable:
    """A ``(film, base_key, start_iter) -> film`` step that adds
    ``block`` iterations ``start_iter .. start_iter + block - 1`` to
    ``film`` in place. Scene tables (the material table as tensors) move
    to the device once, here, and the brute-force routes' [T, 19] triangle
    record is built once, here. The step builds no autograd graph."""
    device = resolve_device(device)
    use_full_f32()
    _check_supported(scene, config)
    scene = scene_from_numpy(scene, device)
    materials = materials_to_torch(scene.materials, device)
    brute = mesh_route(scene.mesh, scene.cmesh, config) in ("mxu", "brute")
    mesh_packed = mesh_ops.pack_tris(scene.mesh) if brute else None

    @torch.no_grad()
    def step(film: torch.Tensor, base_key: Key, start_iter: int) -> torch.Tensor:
        for i in range(block):
            film += trace_iteration(scene.geoms, materials, scene.mesh,
                                    scene.camera, config, base_key,
                                    int(start_iter) + i, cmesh=scene.cmesh,
                                    device=device, mesh_packed=mesh_packed)
        return film

    return step


def render(scene, config: RenderConfig, spp: int, seed: int = 0,
           device=None) -> torch.Tensor:
    """Render ``spp`` iterations and return the averaged image [H, W, 3]
    on ``device`` (the CUDA device by default)."""
    device = resolve_device(device)
    res_x = int(scene.camera.resolution[0])
    res_y = int(scene.camera.resolution[1])
    film = torch.zeros((res_x * res_y, 3), dtype=torch.float32, device=device)
    key = prng_key(seed)
    step = make_render_fn(scene, config, device=device)
    for it in range(1, spp + 1):
        film = step(film, key, it)
    return (film / spp).reshape(res_y, res_x, 3)
