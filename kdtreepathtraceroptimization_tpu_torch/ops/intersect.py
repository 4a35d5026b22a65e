"""Ray-primitive intersection tests, batched over rays.

The JAX package's ``ops/intersect.py`` in PyTorch (reference:
src/intersections.h): one fused block of [N] elementwise work per
analytic geom, merged with strict ``<`` so the first of equal hits wins,
as the reference's sequential ``t < t_min`` loop does
(pathtrace.cu:461-484). A miss is ``t = BIG``, not the reference's -1.

``intersect_geoms`` runs that work as one CUDA kernel
(``csrc/geoms_hit.cu``, bit for bit the plain version's results) when
the rays are CUDA tensors and no gradient is wanted through them, and
as plain PyTorch (``_intersect_geoms_plain``, which autograd
differentiates) otherwise.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple

import numpy as np
import torch

from kdtreepathtraceroptimization_tpu_torch.ops import vecmath as vm
from kdtreepathtraceroptimization_tpu_torch.scene.structs import GEOM_CUBE
from kdtreepathtraceroptimization_tpu_torch.utils import trace
from kdtreepathtraceroptimization_tpu_torch.utils.cuda_build import CudaKernel, check_tensor

BIG = 1e30
# Geoms one launch of the kernel takes (kMaxGeoms in csrc/geoms_hit.cu):
# its table travels in the launch's parameters, which hold 4 KB.
MAX_GEOMS = 16


class Hit(NamedTuple):
    """Nearest-hit record (reference: sceneStructs.h:80-85) plus the hit
    point; ``point``/``normal`` are V3 of [N] channels."""

    t: torch.Tensor  # [N] f32, BIG = miss
    point: vm.V3
    normal: vm.V3
    material_id: torch.Tensor  # [N] int32
    outside: torch.Tensor  # [N] bool


def _min_hit(a: Hit, b: Hit) -> Hit:
    """Elementwise nearest-of-two-hits merge (``a`` wins ties)."""
    take_a = a.t <= b.t
    return Hit(
        t=torch.where(take_a, a.t, b.t),
        point=vm.wherev(take_a, a.point, b.point),
        normal=vm.wherev(take_a, a.normal, b.normal),
        material_id=torch.where(take_a, a.material_id, b.material_id),
        outside=torch.where(take_a, a.outside, b.outside),
    )


def miss_hit(n: int, device) -> Hit:
    return Hit(
        t=torch.full((n,), BIG, dtype=torch.float32, device=device),
        point=vm.v3_zeros(n, device),
        normal=vm.v3_zeros(n, device),
        material_id=torch.full((n,), -1, dtype=torch.int32, device=device),
        outside=torch.ones((n,), dtype=torch.bool, device=device),
    )


def _xform_point(m, p: vm.V3) -> vm.V3:
    """Apply one 4x4 matrix (nested lists of floats) to points (w=1)."""
    return vm.V3(
        m[0][0] * p.x + m[0][1] * p.y + m[0][2] * p.z + m[0][3],
        m[1][0] * p.x + m[1][1] * p.y + m[1][2] * p.z + m[1][3],
        m[2][0] * p.x + m[2][1] * p.y + m[2][2] * p.z + m[2][3],
    )


def _xform_vector(m, v: vm.V3) -> vm.V3:
    """Apply one 4x4 matrix to directions (w=0)."""
    return vm.V3(
        m[0][0] * v.x + m[0][1] * v.y + m[0][2] * v.z,
        m[1][0] * v.x + m[1][1] * v.y + m[1][2] * v.z,
        m[2][0] * v.x + m[2][1] * v.y + m[2][2] * v.z,
    )


def _box_test_g(qo: vm.V3, qd: vm.V3, tr):
    """Slab test vs the centered unit cube, one geom (boxIntersectionTest,
    reference: intersections.h:107-149, quirks included: the entry slab
    needs ta > 0, an inside ray reports the exit face with
    outside=False, normals go through ``tr``). Axis-parallel rays are
    handled explicitly; argmax/argmin over the axes are first-true
    compare chains with the same tie-breaks.

    Returns (hit [N], p_world V3, n_world V3, outside [N]).
    """
    ta = []
    tb = []
    nsign = []
    for o_a, d_a in ((qo.x, qd.x), (qo.y, qd.y), (qo.z, qd.z)):
        par = torch.abs(d_a) < 1e-12
        inv_d = 1.0 / torch.where(par, 1.0, d_a)
        t1 = (-0.5 - o_a) * inv_d
        t2 = (0.5 - o_a) * inv_d
        inside_slab = (o_a >= -0.5) & (o_a <= 0.5)
        ta.append(torch.where(par, torch.where(inside_slab, -BIG, BIG),
                              torch.minimum(t1, t2)))
        tb.append(torch.where(par, torch.where(inside_slab, BIG, -BIG),
                              torch.maximum(t1, t2)))
        nsign.append(torch.where(t2 < t1, 1.0, -1.0))

    tav = [torch.where(t > 0, t, -BIG) for t in ta]
    tmin = torch.maximum(torch.maximum(tav[0], tav[1]), tav[2])
    en_x = (tav[0] >= tav[1]) & (tav[0] >= tav[2])
    en_y = ~en_x & (tav[1] >= tav[2])
    en_z = ~en_x & ~en_y
    tmax = torch.minimum(torch.minimum(tb[0], tb[1]), tb[2])
    ex_x = (tb[0] <= tb[1]) & (tb[0] <= tb[2])
    ex_y = ~ex_x & (tb[1] <= tb[2])
    ex_z = ~ex_x & ~ex_y

    hit = (tmax >= tmin) & (tmax > 0)
    inside = tmin <= 0
    t_obj = torch.where(hit, torch.where(inside, tmax, tmin), 0.0)
    oh_x = torch.where(inside, ex_x, en_x)
    oh_y = torch.where(inside, ex_y, en_y)
    oh_z = torch.where(inside, ex_z, en_z)
    outside = hit & ~inside

    sign = torch.where(oh_x, nsign[0], torch.where(oh_y, nsign[1], nsign[2]))
    n_obj = vm.V3(
        torch.where(oh_x, sign, 0.0),
        torch.where(oh_y, sign, 0.0),
        torch.where(oh_z, sign, 0.0),
    )

    p_obj = qo + qd * t_obj
    p_world = _xform_point(tr, p_obj)
    n_world = vm.normalizev(_xform_vector(tr, n_obj))
    return hit, p_world, n_world, outside


def _sphere_test_g(qo: vm.V3, qd: vm.V3, tr, inv_t):
    """Unit-sphere (radius 0.5) quadratic, one geom (sphereIntersectionTest,
    reference: intersections.h:161-203): normal via inverse-transpose,
    flipped when the ray starts inside."""
    radius = 0.5
    v_dot_d = vm.dotv(qo, qd)
    radicand = v_dot_d * v_dot_d - (vm.dotv(qo, qo) - radius * radius)
    has_root = radicand >= 0
    sq = torch.sqrt(torch.where(has_root, vm.maximum(radicand, 1e-12), 1.0))
    sq = torch.where(has_root, sq, 0.0)
    t1 = -v_dot_d + sq
    t2 = -v_dot_d - sq
    both_neg = (t1 < 0) & (t2 < 0)
    both_pos = (t1 > 0) & (t2 > 0)
    outside = both_pos
    hit = has_root & ~both_neg
    t_obj = torch.where(
        hit, torch.where(both_pos, torch.minimum(t1, t2), torch.maximum(t1, t2)),
        0.0)

    p_obj = qo + qd * t_obj
    p_world = _xform_point(tr, p_obj)
    n_world = vm.normalizev(_xform_vector(inv_t, p_obj))
    n_world = vm.wherev(outside, n_world, -n_world)
    return hit, p_world, n_world, outside


def _intersect_geoms_plain(origin: vm.V3, direction: vm.V3, geoms) -> Hit:
    """``intersect_geoms`` in plain PyTorch: one static test per geom,
    each about 250 [N] elementwise ops, merged with strict ``<``."""
    n = origin.x.shape[0]
    device = origin.x.device
    best = miss_hit(n, device)
    for gi in range(geoms.type.shape[0]):
        inv_g = geoms.inverse_transform[gi].tolist()
        tr_g = geoms.transform[gi].tolist()
        qo = _xform_point(inv_g, origin)
        qd = vm.normalizev(_xform_vector(inv_g, direction))
        if int(geoms.type[gi]) == GEOM_CUBE:
            hit, p, nrm, outs = _box_test_g(qo, qd, tr_g)
        else:
            hit, p, nrm, outs = _sphere_test_g(
                qo, qd, tr_g, geoms.inv_transpose[gi].tolist())

        t_g = torch.where(hit, vm.safe_normv(p - origin), BIG)
        # Miss lanes sanitize to zeros.
        hf = hit.to(t_g.dtype)
        upd = t_g < best.t
        best = Hit(
            t=torch.where(upd, t_g, best.t),
            point=vm.wherev(upd, p * hf, best.point),
            normal=vm.wherev(upd, nrm * hf, best.normal),
            material_id=torch.where(upd, int(geoms.material_id[gi]),
                                    best.material_id),
            outside=torch.where(upd, outs, best.outside),
        )
    return best


class _GeomTable(ctypes.Structure):
    """``GeomTable`` of ``csrc/geoms_hit.cu``: up to MAX_GEOMS geoms, rows
    0-2 of their matrices as float32."""

    _fields_ = [("count", ctypes.c_int),
                ("type", ctypes.c_int * MAX_GEOMS),
                ("material", ctypes.c_int * MAX_GEOMS),
                ("inv", ctypes.c_float * (MAX_GEOMS * 12)),
                ("fwd", ctypes.c_float * (MAX_GEOMS * 12)),
                ("inv_t", ctypes.c_float * (MAX_GEOMS * 9))]


class _Rays(ctypes.Structure):
    """``Rays`` of ``csrc/geoms_hit.cu``: ox oy oz dx dy dz and their
    strides (1, or 0 for one value broadcast to every lane)."""

    _fields_ = [("c", ctypes.c_void_p * 6), ("stride", ctypes.c_int * 6)]


_P = ctypes.c_void_p
GEOMS_HIT = CudaKernel("geoms_hit", "geoms_hit", [_P] * 7 + [ctypes.c_int] * 2)


def geom_tables(geoms) -> List[_GeomTable]:
    """The kernel's tables of ``geoms``, MAX_GEOMS geoms a table (at least
    one table). Matrix entries are rounded to float32, as PyTorch rounds
    the plain version's Python-float entries."""
    count = int(geoms.type.shape[0])
    rows = lambda m, r, c: np.asarray(m, np.float32)[:, :r, :c].reshape(count, r * c)
    inv, fwd = rows(geoms.inverse_transform, 3, 4), rows(geoms.transform, 3, 4)
    inv_t = rows(geoms.inv_transpose, 3, 3)
    tables = []
    for lo in range(0, max(count, 1), MAX_GEOMS):
        hi = min(lo + MAX_GEOMS, count)
        t = _GeomTable()
        t.count = hi - lo
        t.type[:hi - lo] = [int(v) for v in geoms.type[lo:hi]]
        t.material[:hi - lo] = [int(v) for v in geoms.material_id[lo:hi]]
        t.inv[:(hi - lo) * 12] = inv[lo:hi].ravel().tolist()
        t.fwd[:(hi - lo) * 12] = fwd[lo:hi].ravel().tolist()
        t.inv_t[:(hi - lo) * 9] = inv_t[lo:hi].ravel().tolist()
        tables.append(t)
    return tables


def geoms_hit(origin: vm.V3, direction: vm.V3, geoms) -> Hit:
    """``intersect_geoms`` with the CUDA kernel: one launch a MAX_GEOMS
    geoms, no host read. Each of the six channels is a float32 [N] tensor
    on one CUDA device, contiguous or one value expanded to N lanes."""
    channels = (*origin, *direction)
    device = origin.x.device
    if device.type != "cuda":
        raise ValueError(f"geoms_hit runs on CUDA tensors, not {device}")
    n = origin.x.shape[0]
    rays = _Rays()
    for k, (name, c) in enumerate(zip(("ox", "oy", "oz", "dx", "dy", "dz"), channels)):
        if c.dim() == 1 and c.stride(0) == 0:  # one value on every lane
            check_tensor(c[:1], name, torch.float32, c[:1].shape, device)
            if c.shape[0] != n:
                raise ValueError(f"{name} has shape {tuple(c.shape)}, expected {(n,)}")
        else:
            check_tensor(c, name, torch.float32, (n,), device)
        rays.c[k] = c.data_ptr()
        rays.stride[k] = 0 if c.stride(0) == 0 else 1
    t = torch.empty((n,), dtype=torch.float32, device=device)
    point = torch.empty((3, n), dtype=torch.float32, device=device)
    normal = torch.empty((3, n), dtype=torch.float32, device=device)
    material = torch.empty((n,), dtype=torch.int32, device=device)
    outside = torch.empty((n,), dtype=torch.bool, device=device)
    if n:
        for k, table in enumerate(geom_tables(geoms)):
            GEOMS_HIT.launch(device, ctypes.addressof(table), ctypes.addressof(rays),
                             t.data_ptr(), point.data_ptr(), normal.data_ptr(),
                             material.data_ptr(), outside.data_ptr(), n, int(k == 0))
    return Hit(t=t, point=vm.V3(*point), normal=vm.V3(*normal),
               material_id=material, outside=outside)


def _wants_grad(channels) -> bool:
    """Whether autograd is to differentiate through any of ``channels``."""
    return torch.is_grad_enabled() and any(
        isinstance(c, torch.Tensor) and c.requires_grad for c in channels)


def _kernel_takes(channels) -> bool:
    """Whether ``geoms_hit`` takes a call: CUDA rays with no gradient
    wanted through them (its argument checks refuse any other dtype or
    shape)."""
    return channels[0].is_cuda and not _wants_grad(channels)


def intersect_geoms(origin, direction, geoms) -> Hit:
    """Nearest hit of [N] rays against all analytic geoms.

    ``geoms`` holds host numpy tables: one static test per geom, merged
    with strict ``<``. ``t`` is the world-space distance |origin - point|,
    as in the reference. ``origin``/``direction``: V3 of [N] or [N, 3].
    The CUDA kernel runs where ``_kernel_takes`` the rays, the plain
    version elsewhere; while tracing is on, the counters
    ``geoms_kernel_lanes`` and ``geoms_plain_lanes`` sum the lanes each
    took.
    """
    if not isinstance(origin, vm.V3):
        origin = vm.v3_from_rows(origin)
    if not isinstance(direction, vm.V3):
        direction = vm.v3_from_rows(direction)
    if _kernel_takes((*origin, *direction)):
        flat = lambda v: vm.V3(*(c if c.stride(0) == 0 or c.is_contiguous() else c.contiguous()
                                 for c in v))
        hit, path = geoms_hit(flat(origin), flat(direction), geoms), "geoms_kernel_lanes"
    else:
        hit, path = _intersect_geoms_plain(origin, direction, geoms), "geoms_plain_lanes"
    if trace.enabled():
        trace.add(path, torch.tensor(hit.t.shape[0]))
    return hit


def moller_trumbore(origin, direction, v0, v1, v2, cull_backface: bool = True):
    """Moller-Trumbore over a [N rays] x [T triangles] broadcast, as the
    vendored glm::intersectRayTriangle (reference: external/include/glm/
    gtx/intersect.inl): back faces culled (det < eps misses), t >= 0
    accepted, u toward v1 and v toward v2.

    origin/direction: [N, 3]; v0/v1/v2: [T, 3].
    Returns (t [N, T] with BIG = miss, u [N, T], v [N, T]).
    """
    e1 = v1 - v0
    e2 = v2 - v0
    p = vm.cross(direction[:, None, :], e2[None, :, :])
    a = torch.sum(e1[None, :, :] * p, dim=-1)
    valid = a > 1.19e-7 if cull_backface else torch.abs(a) > 1.19e-7
    f = 1.0 / torch.where(valid, a, 1.0)
    s = origin[:, None, :] - v0[None, :, :]
    u = f * torch.sum(s * p, dim=-1)
    q = vm.cross(s, e1[None, :, :])
    v = f * torch.sum(direction[:, None, :] * q, dim=-1)
    t = f * torch.sum(e2[None, :, :] * q, dim=-1)
    ok = valid & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= 0)
    return torch.where(ok, t, BIG), u, v


def intersect_aabb(origin, direction, bb_min, bb_max):
    """Branchless slab test, broadcast over rays x boxes (intersectBbox,
    reference: interactions.h:136-165), with axis-parallel rays handled
    explicitly: inside the slab -> (-BIG, +BIG), outside -> miss.

    origin/direction: [..., 3]; bb_min/bb_max broadcastable to [..., 3].
    Returns (hit [...], dist [...]).
    """
    par = torch.abs(direction) < 1e-12
    inv_d = 1.0 / torch.where(par, 1.0, direction)
    t1 = (bb_min - origin) * inv_d
    t2 = (bb_max - origin) * inv_d
    inside_slab = (origin >= bb_min) & (origin <= bb_max)
    lo = torch.where(par, torch.where(inside_slab, -BIG, BIG), torch.minimum(t1, t2))
    hi = torch.where(par, torch.where(inside_slab, BIG, -BIG), torch.maximum(t1, t2))
    dmin = torch.amax(lo, dim=-1)
    dmax = torch.amin(hi, dim=-1)
    hit = (dmax >= 0) & (dmin <= dmax)
    return hit, torch.where(hit, dmin, dmax)
