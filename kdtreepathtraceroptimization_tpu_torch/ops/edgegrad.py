"""Edge-sampled (boundary) visibility gradients.

The JAX package's ``ops/edgegrad.py`` in PyTorch. The interior gradients
the integrator gives (``trace_rays`` under autograd) are exact for what
varies smoothly with the geometry (hit distances, normals, subsurface
depth) but zero for visibility: a silhouette that sweeps across a pixel
changes the image discontinuously. The missing term is the boundary
integral of differentiable rendering (Li et al. 2018, edge sampling),

    dI_p/dtheta = interior + sum over silhouette edges of
                  INT_edge (L_minus - L_plus)(x) (d x_screen/dtheta . n_hat) dl,

estimated by Monte Carlo:

1. the mesh's unique edges and their faces (``build_edges``, host, once);
2. per camera, the silhouette edges (``silhouette_mask``: the two faces
   differ in facing, or a boundary edge's one face faces the camera);
3. stratified points on every edge, projected to the screen; points off
   screen or hidden from the camera drop out;
4. radiance probes on rays nudged +-delta pixels across the projected
   edge, with common random numbers (both keyed by the pixel);
5. per sample, (L_minus - L_plus) . cot[pixel] times the screen motion of
   the point along the edge normal, differentiated by autograd
   (``boundary_image_grad``).

``boundary_secondary_grad`` does the same for the mesh's silhouettes seen
from diffuse first hits (shadow and indirect-visibility edges).
``make_render_geo`` wraps the render in a ``torch.autograd.Function``
whose backward adds both terms to the interior gradient, with respect to
the vertex positions and the camera position. Analytic shapes' silhouettes
and boundaries seen through specular chains are not sampled, as in the
JAX package.

The probes and occlusion tests trace the KD table that ``retris`` rebuilds
from the vertices (its topology fixed), or the brute force when the
config turns the KD walk off. Everything runs on the vertices' device;
``make_render_geo`` runs on the CUDA device unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig
from kdtreepathtraceroptimization_tpu_torch.convert import materials_to_torch, scene_from_numpy
from kdtreepathtraceroptimization_tpu_torch.ops import bsdf
from kdtreepathtraceroptimization_tpu_torch.ops import vecmath as vm
from kdtreepathtraceroptimization_tpu_torch.ops.camera import RaySoA, generate_rays
from kdtreepathtraceroptimization_tpu_torch.ops.intersect import BIG
from kdtreepathtraceroptimization_tpu_torch.ops.mesh import pack_tris
from kdtreepathtraceroptimization_tpu_torch.ops.rng import bounce_key, fold_in, uniform_scalar
from kdtreepathtraceroptimization_tpu_torch.render.integrator import (
    intersect_scene,
    mesh_route,
    trace_rays,
)
from kdtreepathtraceroptimization_tpu_torch.utils.device import resolve_device, use_full_f32


class MeshEdges(NamedTuple):
    """Unique undirected edges of an indexed triangle mesh (host)."""

    va: np.ndarray  # [E] int32 vertex index
    vb: np.ndarray  # [E] int32
    fa: np.ndarray  # [E] int32 adjacent face
    fb: np.ndarray  # [E] int32 second face or -1 (boundary edge)


def build_edges(faces: np.ndarray) -> MeshEdges:
    """Extract unique edges + adjacency from [F, 3] vertex indices."""
    faces = np.asarray(faces, np.int64)
    f_ids = np.repeat(np.arange(faces.shape[0]), 3)
    ea = faces[:, [0, 1, 2]].ravel()
    eb = faces[:, [1, 2, 0]].ravel()
    lo, hi = np.minimum(ea, eb), np.maximum(ea, eb)
    key = lo << 32 | hi
    order = np.argsort(key, kind="stable")
    key_s, f_s = key[order], f_ids[order]
    uniq, start = np.unique(key_s, return_index=True)
    counts = np.diff(np.append(start, key_s.shape[0]))
    fa = f_s[start]
    fb = np.full(uniq.shape[0], -1, np.int64)
    two = counts >= 2
    fb[two] = f_s[start[two] + 1]
    return MeshEdges(
        va=(uniq >> 32).astype(np.int32),
        vb=(uniq & 0xFFFFFFFF).astype(np.int32),
        fa=fa.astype(np.int32),
        fb=fb.astype(np.int32),
    )


def _vec(a, device) -> torch.Tensor:
    """A camera field (numpy or tensor) as float32 on ``device``; a tensor
    keeps its graph."""
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def _index(a, device) -> torch.Tensor:
    """Integer indices (numpy or tensor) as int64 on ``device``."""
    return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a,
                           device=device).long()


def _safe_norm(a, eps: float = 1e-12):
    """|a| over the last axis with a defined gradient at 0."""
    return torch.sqrt(torch.sum(a * a, dim=-1) + eps)


def _normalize(a, eps: float = 1e-12):
    """a / |a| over the last axis, the norm floored."""
    return a / torch.sqrt(vm.maximum(torch.sum(a * a, dim=-1, keepdim=True), eps))


def _dot(a, b):
    """Dot product over the last axis."""
    return torch.sum(a * b, dim=-1)


def project_to_screen(camera, X):
    """World point(s) [.., 3] -> continuous screen coords (sx, sy) and the
    depth along the view: the exact inverse of ``generate_rays``' pixel ->
    direction map (a ray for integer pixel (x, y) projects back to sx == x,
    sy == y). Differentiable in ``X`` and in the camera's tensor fields."""
    device = X.device
    pos, view, right, up, pl = (_vec(a, device) for a in (
        camera.position, camera.view, camera.right, camera.up, camera.pixel_length))
    res_x = int(camera.resolution[0])
    res_y = int(camera.resolution[1])
    w = X - pos
    depth = _dot(w, view)
    safe = torch.where(depth > 1e-6, depth, 1.0)
    sx = _dot(w, right) / (safe * pl[0]) + res_x * 0.5
    sy = -_dot(w, up) / (safe * pl[1]) + res_y * 0.5
    return sx, sy, depth


def _face_normals(verts, faces):
    v0 = verts[faces[:, 0]]
    e1 = verts[faces[:, 1]] - v0
    e2 = verts[faces[:, 2]] - v0
    return vm.cross(e1, e2), v0  # un-normalized; MT's det sign matches


def silhouette_mask(verts, faces, edges: MeshEdges, cam_pos):
    """[E] bool: edge is a primary-visibility silhouette. With back-face
    culling (MT det > 0 only), a visibility boundary is any edge whose two
    faces differ in front-facing-ness, or a boundary edge whose one face
    is front-facing."""
    device = verts.device
    fn, v0 = _face_normals(verts, _index(faces, device))
    # front-facing iff the camera sees the CCW side: dot(n, cam - v0) > 0
    front = _dot(fn, _vec(cam_pos, device)[None, :] - v0) > 0
    fa, fb = _index(edges.fa, device), _index(edges.fb, device)
    fa_front = front[fa]
    has_b = fb >= 0
    fb_front = torch.where(has_b, front[fb.clamp_min(0)], False)
    return torch.where(has_b, fa_front != fb_front, fa_front)


def _tracers(scene_arrays, config: RenderConfig):
    """(intersect, trace) over ``scene_arrays`` = (geoms, materials, mesh,
    kd): the port's ``intersect_scene`` and ``trace_rays`` without a
    cluster table, so on the KD route, or on a brute-force route (with the
    mesh's [T, 19] record) when the config turns the KD walk off."""
    geoms, materials, mesh, kd = scene_arrays
    packed = None
    if mesh_route(mesh, None, config, kd) in ("mxu", "brute"):
        packed = pack_tris(mesh._replace(**{f: getattr(mesh, f).detach()
                                            for f in ("v0", "v1", "v2")}))

    def intersect(origin, direction, active=None):
        return intersect_scene(origin, direction, geoms, mesh, config, active=active,
                               mesh_packed=packed, kd=kd)

    def trace(rays, base_key, iteration):
        return trace_rays(rays, geoms, materials, mesh, config, base_key, iteration,
                          mesh_packed=packed, kd=kd)

    return intersect, trace


def _edge_points(verts, va, vb, s):
    """[E, K, 3] points at fractions ``s`` [1, K] along the edges."""
    A = verts[va]
    B = verts[vb]
    return A[:, None, :] * (1.0 - s)[..., None] + B[:, None, :] * s[..., None]


def _probe_rays(origin, direction, pixel, bounces) -> RaySoA:
    """Fresh unit-throughput rays keyed by ``pixel`` (common random
    numbers for both sides of an edge)."""
    n = direction.shape[0]
    one = torch.ones((n,), dtype=torch.float32, device=direction.device)
    return RaySoA(
        origin=vm.v3_from_rows(origin),
        direction=vm.v3_from_rows(direction),
        color=vm.V3(one, one, one),
        is_inside=torch.zeros((n,), dtype=torch.bool, device=direction.device),
        sdepth=torch.zeros((n,), dtype=torch.float32, device=direction.device),
        pixel_index=pixel.to(torch.int32),
        remaining_bounces=bounces.to(torch.int32),
    )


def boundary_image_grad(verts, faces, edges: MeshEdges, scene_arrays, camera,
                        config: RenderConfig, base_key, iteration, cot_image,
                        samples_per_edge: int = 4, delta: float = 0.3,
                        collect_stats: bool = False):
    """Monte-Carlo boundary term of the camera's silhouettes -> (d_verts
    [V, 3], d_cam_pos [3]); with ``collect_stats`` also a dict of the
    silhouette mask [E], the samples alive before and after the occlusion
    test [E, K] and the probe rays traced.

    ``scene_arrays`` = (geoms, materials, mesh, kd) with the KD table (or
    the mesh, on a brute-force route) built from ``verts``; ``cot_image``
    [N_pixels, 3] is the cotangent of the radiance image. Only the edge
    points' screen motion is differentiated (step 5 of the module
    docstring); radiances, the silhouette, pixel assignment and occlusion
    are detached, as the estimator prescribes."""
    intersect, trace = _tracers(scene_arrays, config)
    device = verts.device
    res_x = int(camera.resolution[0])
    res_y = int(camera.resolution[1])
    faces = _index(faces, device)
    va, vb = _index(edges.va, device), _index(edges.vb, device)
    E = va.shape[0]
    K = samples_per_edge
    cam_pos = _vec(camera.position, device).detach()
    camera = camera._replace(position=cam_pos)
    verts_d = verts.detach()
    s = ((torch.arange(K, dtype=torch.float32, device=device) + 0.5) / K)[None, :]

    with torch.no_grad():
        sil = silhouette_mask(verts_d, faces, edges, cam_pos)
        X = _edge_points(verts_d, va, vb, s)
        sx, sy, depth = project_to_screen(camera, X)
        # screen-space edge direction and normal
        ax, ay, _ = project_to_screen(camera, verts_d[va])
        bx, by, _ = project_to_screen(camera, verts_d[vb])
        ex, ey = bx - ax, by - ay
        elen = torch.sqrt(ex * ex + ey * ey) + 1e-12
        nx = (-ey / elen)[:, None]
        ny = (ex / elen)[:, None]
        in_frustum = ((depth > 1e-4) & (sx > 0.5) & (sx < res_x - 0.5)
                      & (sy > 0.5) & (sy < res_y - 0.5))
        alive = sil[:, None] & in_frustum  # [E, K]
        framed = alive

        # occlusion: a camera ray toward X must reach it
        Xr = X.reshape(-1, 3)
        to_x = Xr - cam_pos[None, :]
        dist = _safe_norm(to_x)
        occ = intersect(cam_pos.expand(Xr.shape), to_x / dist[:, None],
                        active=alive.reshape(-1))
        alive = alive & (occ.t >= dist * (1.0 - 1e-3)).reshape(E, K)

        # radiance probes straddling the edge (common random numbers)
        pix_x = torch.clamp(torch.round(sx).to(torch.int32), 0, res_x - 1)
        pix_y = torch.clamp(torch.round(sy).to(torch.int32), 0, res_y - 1)
        pixel = (pix_y * res_x + pix_x).reshape(-1)
        view, right, up, pl = (_vec(a, device) for a in (
            camera.view, camera.right, camera.up, camera.pixel_length))
        n = pixel.shape[0]
        origin = cam_pos[None, :].expand(n, 3)
        bounces = torch.full((n,), config.effective_depth, dtype=torch.int32, device=device)

        def radiance(sign):
            qx = sx + sign * delta * nx
            qy = sy + sign * delta * ny
            d = _normalize(view[None, :]
                           + right[None, :] * (pl[0] * (qx.reshape(-1) - res_x * 0.5))[:, None]
                           - up[None, :] * (pl[1] * (qy.reshape(-1) - res_y * 0.5))[:, None])
            return trace(_probe_rays(origin, d, pixel, bounces), base_key,
                         iteration).reshape(E, K, 3)

        L_plus = radiance(+1.0)
        L_minus = radiance(-1.0)
        cot = cot_image.detach()[pixel.long()].reshape(E, K, 3)
        # weight per sample: (L- - L+) . cot x screen length / K   [E, K]
        w = (torch.where(alive[..., None], (L_minus - L_plus) * cot, 0.0).sum(-1)
             * (elen / K)[:, None])

    # differentiate the screen motion along n_hat
    verts_in = verts_d.clone().requires_grad_(True)
    cam_in = cam_pos.clone().requires_grad_(True)
    with torch.enable_grad():
        sx_in, sy_in, _ = project_to_screen(camera._replace(position=cam_in),
                                            _edge_points(verts_in, va, vb, s))
        edge_screen_dot = torch.sum((sx_in * nx + sy_in * ny) * w)
        d_verts, d_cam = torch.autograd.grad(edge_screen_dot, (verts_in, cam_in))
    if collect_stats:
        return d_verts, d_cam, dict(silhouette=sil, framed=framed, alive=alive,
                                    probe_rays=2 * n)
    return d_verts, d_cam


def boundary_secondary_grad(verts, faces, edges: MeshEdges, scene_arrays, camera,
                            config: RenderConfig, base_key, iteration, cot_image,
                            n_view: int = 1024, samples_per_edge: int = 2,
                            delta: float = 0.02, collect_stats: bool = False):
    """Secondary-bounce boundary term -> d_verts [V, 3]; with
    ``collect_stats`` also a dict of the viewpoints [M] that are diffuse,
    the silhouette [M, E], the samples alive before and after the
    occlusion test [M, E, K] and the probe rays traced.

    For a pixel whose camera ray first hits a diffuse surface at y, moving
    a vertex sweeps the mesh's silhouette as seen from y across direction
    space: a visibility edge of the incident radiance (shadows, indirect
    visibility) that the interior gradient and the camera-edge estimator
    both report as zero. Per the JAX package:

    1. viewpoints: the first hits of M = min(n_view, pixels) central
       camera rays on a stratified pixel lattice (offset
       ``uniform(fold_in(base_key, 0x5EC0))``, as ``jax.random.uniform``
       draws it); only diffuse, non-emissive hits count;
    2. per (viewpoint, edge): silhouette where the faces straddle y;
    3. per edge sample X: w = dir(y -> X), dropped where X is hidden from
       y or below its horizon; the crossing direction n_hat =
       normalize(w x (B - A));
    4. probes L+- = trace from y along normalize(w +- delta n_hat), depth
       - 1 bounces, keyed by the viewpoint's pixel;
    5. weight (L- - L+) . (cot[pixel] * albedo) cos(w) / pi x the edge's
       projected arc length / K x pixels / M; the gradient is that of
       sum(weight x (w(X) . n_hat)), only the points' direction-space
       motion differentiated."""
    intersect, trace = _tracers(scene_arrays, config)
    materials = scene_arrays[1]
    device = verts.device
    res_x = int(camera.resolution[0])
    res_y = int(camera.resolution[1])
    n_pix = res_x * res_y
    faces = _index(faces, device)
    va, vb = _index(edges.va, device), _index(edges.vb, device)
    E = va.shape[0]
    K = samples_per_edge
    M = min(n_view, n_pix)
    cam_pos = _vec(camera.position, device).detach()
    view, right, up, pl = (_vec(a, device) for a in (
        camera.view, camera.right, camera.up, camera.pixel_length))
    verts_d = verts.detach()
    s = ((torch.arange(K, dtype=torch.float32, device=device) + 0.5) / K)[None, :]

    with torch.no_grad():
        # 1. viewpoints: a stratified pixel lattice, central rays
        off = torch.tensor(uniform_scalar(fold_in(base_key, 0x5EC0)), dtype=torch.float32,
                           device=device)
        stride = n_pix / M
        pixel = torch.clamp(((torch.arange(M, dtype=torch.float32, device=device) + off)
                             * stride).to(torch.int32), 0, n_pix - 1)
        px = (pixel % res_x).to(torch.float32)
        py = (pixel // res_x).to(torch.float32)
        vdir = _normalize(view[None, :]
                          + right[None, :] * (pl[0] * (px - res_x * 0.5))[:, None]
                          - up[None, :] * (pl[1] * (py - res_y * 0.5))[:, None])
        vhit = intersect(cam_pos[None, :].expand(M, 3), vdir)
        vmat = bsdf.gather_materials(materials, vhit.material_id)
        is_diffuse = ((vhit.t < BIG) & (vmat.emittance <= 0.0)
                      & (vmat.has_reflective <= 0.0) & (vmat.has_refractive <= 0.0))
        y = vm.v3_to_rows(vhit.point)  # [M, 3]
        nrm_y = vm.v3_to_rows(vhit.normal)
        albedo = vm.v3_to_rows(vmat.color).detach()

        # 2. silhouette per (viewpoint, edge)
        fn, v0f = _face_normals(verts_d, faces)
        front = _dot(fn[None, :, :], y[:, None, :] - v0f[None, :, :]) > 0  # [M, F]
        fa, fb = _index(edges.fa, device), _index(edges.fb, device)
        fa_front = front[:, fa]  # [M, E]
        has_b = (fb >= 0)[None, :]
        fb_front = torch.where(has_b, front[:, fb.clamp_min(0)], False)
        sil = torch.where(has_b, fa_front != fb_front, fa_front)

        # 3. edge samples and their geometry
        Xd = _edge_points(verts_d, va, vb, s)  # [E, K, 3]
        eAB = verts_d[vb] - verts_d[va]  # [E, 3]
        to_x = Xd[None, :, :, :] - y[:, None, None, :]  # [M, E, K, 3]
        dist = _safe_norm(to_x.reshape(-1, 3)).reshape(M, E, K)
        w_dir = to_x / dist[..., None]
        cosw = _dot(w_dir, nrm_y[:, None, None, :])
        # crossing direction (already unit-orthogonal to w)
        n_hat = vm.cross(w_dir, eAB[None, :, None, :].expand(w_dir.shape))
        n_len = _safe_norm(n_hat.reshape(-1, 3)).reshape(M, E, K)
        n_hat = n_hat / n_len[..., None]
        # projected arc length of the edge at this sample, per unit t:
        # |w x (B - A)| / dist
        arc = n_len / vm.maximum(dist, 1e-6)
        alive = sil[:, :, None] & (cosw > 1e-4) & is_diffuse[:, None, None]
        framed = alive

        # occlusion: the edge point must be visible from y
        origin_probe = y + nrm_y * 1e-4  # scatter's offset
        R = M * E * K
        origins = origin_probe[:, None, None, :].expand(M, E, K, 3).reshape(R, 3)
        occ = intersect(origins, w_dir.reshape(R, 3), active=alive.reshape(R))
        alive = alive & (occ.t.reshape(M, E, K) >= dist * (1.0 - 1e-3))

        # 4. radiance probes (common random numbers: pixel-keyed streams)
        pix_rep = pixel[:, None, None].expand(M, E, K).reshape(R)
        bounces = torch.where(alive.reshape(R), max(1, config.effective_depth - 1), 0)

        def radiance(sign):
            d = _normalize((w_dir + sign * delta * n_hat).reshape(R, 3))
            return trace(_probe_rays(origins, d, pix_rep, bounces), base_key,
                         iteration).reshape(M, E, K, 3)

        L_plus = radiance(+1.0)
        L_minus = radiance(-1.0)
        cot = cot_image.detach()[pixel.long()]  # [M, 3]
        wgt = torch.where(alive[..., None],
                          (L_minus - L_plus) * (cot * albedo)[:, None, None, :], 0.0).sum(-1)
        wgt = wgt * vm.maximum(cosw, 0.0) * (1.0 / math.pi) * arc / K
        wgt = wgt * (n_pix / M)  # [M, E, K]

    # 5. differentiate the direction-space motion
    verts_in = verts_d.clone().requires_grad_(True)
    with torch.enable_grad():
        to_x = _edge_points(verts_in, va, vb, s)[None, :, :, :] - y[:, None, None, :]
        w = to_x / _safe_norm(to_x.reshape(-1, 3)).reshape(M, E, K)[..., None]
        edge_dir_dot = torch.sum(_dot(w, n_hat) * wgt)
        (d_verts,) = torch.autograd.grad(edge_dir_dot, (verts_in,))
    if collect_stats:
        return d_verts, dict(diffuse=is_diffuse, silhouette=sil, framed=framed, alive=alive,
                             probe_rays=2 * R)
    return d_verts


def retris(kd, verts, faces):
    """The KD table ``kd`` (tensors) with its leaf triangles gathered from
    ``verts`` through ``faces[orig_index]``, so interior gradients reach
    the vertices while the tree's topology stays fixed (the detached
    sampling convention): pads stay zero, the normals are kept, and the
    [T', 19] record ``packed``, through which gradients enter the hit
    expansion, is rebuilt. The fat rows' inline slots follow the same
    vertices, detached (the walk carries no gradient); the octant layouts
    are dropped."""
    device = verts.device
    faces = _index(faces, device)
    orig = kd.tris.orig_index.long()
    ok = orig >= 0
    o = orig.clamp_min(0)

    def take(c):
        return torch.where(ok[:, None], verts[faces[o, c]], 0.0)

    tris = kd.tris._replace(v0=take(0), v1=take(1), v2=take(2))
    fat = None
    if kd.fat is not None:
        cap = kd.fat.inline_cap
        rows = kd.fat.rows
        with torch.no_grad():
            tri9 = torch.cat([tris.v0, tris.v1, tris.v2], dim=1)  # [T', 9]
            chunk = tri9.reshape(-1, cap, 9).transpose(1, 2).reshape(-1, 9 * cap)
            tri_base = rows[:, 10].to(torch.int64)
            block = chunk[torch.clamp(tri_base // cap, 0, chunk.shape[0] - 1)]
            inline = torch.where((tri_base >= 0)[:, None], block, rows[:, 12:])
            fat = kd.fat._replace(rows=torch.cat([rows[:, :12], inline], dim=1))
    return kd._replace(tris=tris, fat=fat, oct=None, packed=pack_tris(tris))


def make_render_geo(scene, verts0, faces, config: RenderConfig,
                    samples_per_edge: int = 4, delta: float = 0.3,
                    secondary_viewpoints: int = 0, secondary_delta: float = 0.02,
                    device=None):
    """Build ``render_geo(verts, cam_pos, key, iteration) -> image [N, 3]``
    whose backward is the interior gradient plus the edge-sampled
    boundary term, with respect to ``verts`` [V, 3] and ``cam_pos`` [3]
    (tensors on ``device``, the CUDA device by default; ``key`` and
    ``iteration`` get no gradient).

    ``secondary_viewpoints`` > 0 also samples the secondary visibility
    boundaries seen from that many diffuse first hits
    (``boundary_secondary_grad``); 0 keeps the primary term only. The
    forward renders one iteration on the KD table that ``retris`` builds
    from ``verts`` (its topology built once from ``verts0``, the scene's
    own vertices, and kept: a vertex motion large enough to invalidate it
    needs a rebuild), or on the brute force when the config turns the KD
    walk off. It keeps the interior's autograd graph until the backward,
    rather than rendering again there: one render instead of two, at the
    memory of one graph."""
    device = resolve_device(device)
    use_full_f32()
    scene = scene_from_numpy(scene, device)
    route = mesh_route(scene.mesh, None, config, scene.kd)
    edges = build_edges(np.asarray(faces))
    faces_t = _index(faces, device)
    geoms, camera = scene.geoms, scene.camera
    materials = materials_to_torch(scene.materials, device)

    def tables(verts):
        """(mesh, kd) with triangles from ``verts``."""
        mesh_t = scene.mesh._replace(v0=verts[faces_t[:, 0]], v1=verts[faces_t[:, 1]],
                                     v2=verts[faces_t[:, 2]])
        return mesh_t, (retris(scene.kd, verts, faces_t) if route == "kd" else None)

    def primal(verts, cam_pos, key, iteration):
        mesh_t, kd_t = tables(verts)
        packed = pack_tris(mesh_t) if route in ("mxu", "brute") else None
        rays = generate_rays(camera._replace(position=cam_pos), config,
                             bounce_key(key, iteration, 0), config.effective_depth, device)
        return trace_rays(rays, geoms, materials, mesh_t, config, key, iteration,
                          mesh_packed=packed, kd=kd_t)

    class RenderGeo(torch.autograd.Function):
        @staticmethod
        def forward(ctx, verts, cam_pos, key, iteration):
            v = verts.detach().requires_grad_(True)
            c = cam_pos.detach().requires_grad_(True)
            with torch.enable_grad():
                img = primal(v, c, key, iteration)
            ctx.graph = (img, v, c)
            ctx.key, ctx.iteration = key, iteration
            return img.detach()

        @staticmethod
        def backward(ctx, cot):
            img, v, c = ctx.graph
            ctx.graph = None  # frees the interior graph after this pass
            d_verts = d_cam = None
            if img.requires_grad:
                d_verts, d_cam = torch.autograd.grad(img, (v, c), cot, allow_unused=True)
            d_verts = torch.zeros_like(v) if d_verts is None else d_verts
            d_cam = torch.zeros_like(c) if d_cam is None else d_cam
            verts, cam_pos = v.detach(), c.detach()
            with torch.no_grad():
                mesh_t, kd_t = tables(verts)
            arrays = (geoms, materials, mesh_t, kd_t)
            cam = camera._replace(position=cam_pos)
            bv, bc = boundary_image_grad(verts, faces_t, edges, arrays, cam, config, ctx.key,
                                         ctx.iteration, cot, samples_per_edge=samples_per_edge,
                                         delta=delta)
            if secondary_viewpoints > 0:
                bv = bv + boundary_secondary_grad(
                    verts, faces_t, edges, arrays, cam, config, ctx.key, ctx.iteration, cot,
                    n_view=secondary_viewpoints, samples_per_edge=samples_per_edge,
                    delta=secondary_delta)
            return d_verts + bv, d_cam + bc, None, None

    def render_geo(verts, cam_pos, key, iteration):
        return RenderGeo.apply(verts, cam_pos, key, int(iteration))

    return render_geo
